"""Plain PyTorch versions of the kernels (the correctness contract).

Port of ``src/repro/kernels/ref.py`` for the kernels the port has so
far.  Each function computes what its kernel in
:mod:`repro_torch.kernels.fused_contraction`,
:mod:`repro_torch.kernels.flash_attention` or
:mod:`repro_torch.kernels.quantized` computes, with the same rounding
points: products accumulate in f32 and each result is rounded to the
operand type (the scaled kernels: to f32, with bf16 chain
intermediates).  The kernel wrappers run these for tensors on the CPU;
``chip_smoke.py`` holds each kernel against them on the card.

Two helpers serve that comparison: :func:`tie_probe` builds quantizer
inputs on which every rounding is a close call, and
:func:`chain_scaled_agreement` is the rule the scaled chain kernel is
held to.
"""

from __future__ import annotations

import math

import torch

from repro_torch.precision import quant
from repro_torch.precision.policy import QuantPolicy


def matmul(x: torch.Tensor, w: torch.Tensor, *, transpose_rhs: bool = False,
           out_dtype=None) -> torch.Tensor:
    """C = X @ W (or X @ W.T) with f32 accumulation."""
    if transpose_rhs:
        w = w.t()
    out = torch.matmul(x.float(), w.float())
    return out.to(out_dtype or x.dtype)


def chain_n(x: torch.Tensor, weights, *, out_dtype=None) -> torch.Tensor:
    """Y = (((X @ W1) -> regroup -> @ W2) ... @ Wn).

    Link ``i`` reads the previous result regrouped row-major to
    ``[-1, k_i]`` (``k_i = W_i.shape[0]``), accumulates in f32 and, before
    the next link, rounds to ``x.dtype`` — the reference kernel's
    intermediate semantics."""
    h = x
    for i, w in enumerate(weights):
        acc = torch.matmul(h.reshape(-1, w.shape[0]).float(), w.float())
        h = acc if i == len(weights) - 1 else acc.to(x.dtype)
    return h.to(out_dtype or x.dtype)


def matmul_scaled(xq: torch.Tensor, wq: torch.Tensor, sl: torch.Tensor,
                  sr: torch.Tensor, *, transpose_rhs: bool = False
                  ) -> torch.Tensor:
    """``C = (Xq @ Wq) * sl[M, 1] * sr[1, N]`` in f32, in that order: the
    fp8/int8 operands upcast exactly to f32, the dequantization scales
    applied to the f32 sum (``_matmul_scaled_kernel``'s epilogue)."""
    w = wq.t() if transpose_rhs else wq
    return torch.matmul(xq.float(), w.float()) * sl * sr


def chain_n_scaled(x: torch.Tensor, weights, scales) -> torch.Tensor:
    """The quantized chain: ``scales = (s_first [m0, 1], c_2 [1, 1], ...,
    s_last [1, n])``.  Link 0 multiplies the f32-upcast operands and
    scales per link-0 row; each later link reads the previous result
    rounded to bf16 and regrouped to ``[-1, k_i]``, multiplies it by the
    bf16-cast weight (exact from fp8/int8) with f32 accumulation, and
    scales by its factor.  The reference's own mirror of its kernel
    (``plan_compiler._run_quantized``'s unfused fallback); f32 out."""
    weights, scales = tuple(weights), tuple(scales)
    res = torch.matmul(x.float(), weights[0].float()) * scales[0]
    for w, s in zip(weights[1:], scales[1:]):
        lhs = res.to(torch.bfloat16).reshape(-1, w.shape[0])
        res = torch.matmul(lhs.float(), w.to(torch.bfloat16).float()) * s
    return res


def chain_scaled_agreement(got: torch.Tensor, want: torch.Tensor
                           ) -> tuple[bool, dict]:
    """Whether the scaled chain kernel's output ``got`` agrees with
    :func:`chain_n_scaled`'s ``want``, and the numbers that decide it.

    The kernel sums in another order than ``torch.matmul``, so now and
    then an intermediate lands one bf16 ulp from the plain version's, and
    the elements of its row move by up to that ulp times a weight.  So at
    most 0.5% of the elements may lie beyond 1e-5 of the output's scale,
    and none beyond two bf16 ulps of it.  A chain that skips the bf16
    rounding of its intermediates, or rounds them to fp16, puts 97-100%
    of the elements beyond 1e-5 of the scale (while staying within half a
    bf16 ulp of it)."""
    scale = float(want.abs().max())
    err = (got.float() - want.float()).abs()
    ulp = 2.0 ** (math.floor(math.log2(max(scale, 1e-30))) - 7)
    nums = {"scale": scale, "max_abs_err": float(err.max()),
            "share_beyond_1e-5": float((err > 1e-5 * scale).float().mean()),
            "tol_abs": 2 * ulp}
    return (nums["share_beyond_1e-5"] <= 0.005
            and nums["max_abs_err"] <= 2 * ulp), nums


def quantize(x: torch.Tensor, scale: torch.Tensor,
             policy: QuantPolicy) -> torch.Tensor:
    """``q[R, C] = cast(clip(x / scale[R, 1], ±qmax))``: a true divide,
    int8 rounded half to even, fp8 rounded by the cast (nearest even).
    The precision subsystem's own cast, on per-row scales."""
    return quant._cast(x, scale.reshape(-1), policy)


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               out_dtype=torch.float32) -> torch.Tensor:
    """``x[R, C] = q * scale[R, 1]``: one f32 multiply, then the cast."""
    return quant.dequantize(quant.QTensor(q=q, scale=scale.reshape(-1)),
                            out_dtype)

def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, q_chunk: int = 512,
                        kv_chunk: int = 512,
                        softmax_scale: float | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """GQA attention with an online softmax over kv chunks.

    Port of ``repro.models.blocks._blockwise_attention_fwd_only``, the
    jnp twin of the Pallas ``flash_attention_fwd``.  q: ``[B, Tq, H,
    D]``; k, v: ``[B, Tk, KV, D]`` with ``H = KV * G``.  Returns ``out
    [B, Tq, H, D]`` in q's dtype and ``lse [B, Tq, KV, G]`` in f32.
    Scores are f32; masked scores are -1e30; ``p`` is rounded to v's
    dtype for the PV product while the denominator sums the unrounded
    ``p``."""
    B, Tq, H, D = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = softmax_scale or 1.0 / math.sqrt(D)
    qc, kc = min(q_chunk, Tq), min(kv_chunk, Tk)
    if Tq % qc or Tk % kc:
        raise ValueError(f"sequence ({Tq},{Tk}) not divisible by chunks "
                         f"({qc},{kc})")
    f32 = torch.float32
    k_pos = torch.arange(Tk, device=q.device)
    outs, lses = [], []
    for i in range(Tq // qc):
        q_blk = q[:, i * qc:(i + 1) * qc].reshape(B, qc, KV, G, D).float()
        q_pos = torch.arange(i * qc, (i + 1) * qc, device=q.device)
        m = torch.full((B, KV, G, qc), -1e30, dtype=f32, device=q.device)
        l = torch.zeros((B, KV, G, qc), dtype=f32, device=q.device)
        acc = torch.zeros((B, KV, G, qc, D), dtype=f32, device=q.device)
        for j in range(Tk // kc):
            k_blk = k[:, j * kc:(j + 1) * kc].float()
            v_blk = v[:, j * kc:(j + 1) * kc]
            s = torch.einsum("bqkgd,btkd->bkgqt", q_blk, k_blk) * scale
            if causal:
                kp = k_pos[j * kc:(j + 1) * kc]
                s = torch.where(q_pos[:, None] >= kp[None, :], s,
                                torch.full((), -1e30, device=q.device))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqt,btkd->bkgqd", p.to(v.dtype).float(), v_blk.float())
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        lse = m + torch.log(torch.clamp_min(l, 1e-30))
        outs.append(out.permute(0, 3, 1, 2, 4))          # [B, qc, KV, G, D]
        lses.append(lse.permute(0, 3, 1, 2))             # [B, qc, KV, G]
    out = torch.cat(outs, dim=1).reshape(B, Tq, H, D)
    return out.to(q.dtype), torch.cat(lses, dim=1)


def tie_probe(policy: QuantPolicy, rows: int = 56, *, device=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 ``x [rows, C]`` and its scale ``[rows, 1]`` such that ``x /
    scale`` hits, in every row: each finite value of the policy's type,
    each midpoint of two neighbours (a rounding tie), the f32 neighbours
    of each midpoint, zeros, subnormals' halves, ±qmax and 1.5× / 2×
    beyond it.  Row scales are powers of two (2^-3 .. 2^3), so ``x =
    y * scale`` is exact and the quotient is ``y`` again.

    A quantizer whose rounding mode, subnormal handling or saturation
    differs from :func:`quantize`'s misses some of these.  Power-of-two
    scales cannot tell a divide from a multiply by the reciprocal;
    random rows with amax-derived scales cover that."""
    f32 = torch.float32
    if policy.dtype == "int8":
        grid = torch.arange(-127, 128, dtype=f32)
        tiny = torch.tensor([0.25, 0.5, 0.75], dtype=f32)
    else:
        bits = torch.arange(256, dtype=torch.int16).to(torch.uint8)
        grid = bits.view(policy.operand_dtype).float()
        grid = torch.unique(grid[torch.isfinite(grid)])
        pos = grid[grid > 0]
        tiny = pos[:1] * torch.tensor([0.25, 0.5, 0.75, 1.5], dtype=f32)
    mids = (grid[1:] + grid[:-1]) / 2
    inf = torch.full_like(mids, float("inf"))
    qmax = policy.qmax
    edge = torch.tensor([0.0, -0.0, qmax, -qmax, 1.5 * qmax, -1.5 * qmax,
                         2 * qmax, -2 * qmax], dtype=f32)
    y = torch.cat([grid, mids, torch.nextafter(mids, inf),
                   torch.nextafter(mids, -inf), tiny, -tiny, edge])
    scale = 2.0 ** ((torch.arange(rows, dtype=f32) % 7) - 3)
    x = y[None, :] * scale[:, None]
    return (x.to(device).contiguous(),
            scale[:, None].to(device).contiguous())
