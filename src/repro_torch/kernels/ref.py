"""Plain PyTorch versions of the kernels (the correctness contract).

Port of ``src/repro/kernels/ref.py``.  Each function computes what its
kernel in
:mod:`repro_torch.kernels.fused_contraction`,
:mod:`repro_torch.kernels.flash_attention`,
:mod:`repro_torch.kernels.quantized` or
:mod:`repro_torch.kernels.ssm_scan` computes, with the same rounding
points: products accumulate in f32 and each result is rounded to the
operand type (the scaled kernels: to f32, with bf16 chain
intermediates).  For the scan there are two: the sequential oracle
(:func:`linear_scan`, :func:`linear_scan_batched`) and
:func:`chunked_linear_scan`, the kernel's blocked twin, which is also
what autograd differentiates for the scan's backward.  The kernel
wrappers run these for tensors on the CPU; ``chip_smoke.py`` holds each
kernel against them on the card.

Two helpers serve that comparison: :func:`tie_probe` builds quantizer
inputs on which every rounding is a close call, and
:func:`chain_scaled_agreement` is the rule the scaled chain kernel is
held to.
"""

from __future__ import annotations

import math

import torch

from repro_torch.precision import policy as qpolicy
from repro_torch.precision import quant
from repro_torch.precision.policy import QuantPolicy


def matmul(x: torch.Tensor, w: torch.Tensor, *, transpose_rhs: bool = False,
           out_dtype=None) -> torch.Tensor:
    """C = X @ W (or X @ W.T) with f32 accumulation; batched, with a
    leading expert axis on both (``[E, M, K] @ [E, K, N]``), one product
    per entry (the batched GEMM's plain version)."""
    if transpose_rhs:
        w = w.transpose(-1, -2)
    out = torch.matmul(x.float(), w.float())
    return out.to(out_dtype or x.dtype)


def chain_n(x: torch.Tensor, weights, *, out_dtype=None) -> torch.Tensor:
    """Y = (((X @ W1) -> regroup -> @ W2) ... @ Wn).

    Link ``i`` reads the previous result regrouped row-major to
    ``[-1, k_i]`` (``k_i = W_i.shape[-2]``), accumulates in f32 and,
    before the next link, rounds to ``x.dtype`` — the reference kernel's
    intermediate semantics.  With a leading expert axis on X and every
    W_i (3-D), one chain per entry (the batched chain's plain version)."""
    lead = x.shape[:-2]
    h = x
    for i, w in enumerate(weights):
        acc = torch.matmul(h.reshape(*lead, -1, w.shape[-2]).float(),
                           w.float())
        h = acc if i == len(weights) - 1 else acc.to(x.dtype)
    return h.to(out_dtype or x.dtype)


def _instances(t: torch.Tensor, lead: tuple) -> list[torch.Tensor]:
    """``t`` broadcast to the instance axes ``lead`` (an expert's
    operand over its groups), one entry per instance in row-major
    order."""
    t = t.expand(tuple(lead) + tuple(t.shape[len(lead):]))
    return list(t.reshape((-1,) + tuple(t.shape[len(lead):])))


def matmul_scaled(xq: torch.Tensor, wq: torch.Tensor, sl: torch.Tensor,
                  sr: torch.Tensor, *, transpose_rhs: bool = False
                  ) -> torch.Tensor:
    """``C = (Xq @ Wq) * sl[M, 1] * sr[1, N]`` in f32, in that order: the
    fp8/int8 operands upcast exactly to f32, the dequantization scales
    applied to the f32 sum (``_matmul_scaled_kernel``'s epilogue).

    Batched (the instance batch of a MoE's quantized experts): ``xq[*I,
    M, K]``, ``wq[*I, K, N]`` (or ``[*I, N, K]``; an operand may be
    broadcast over trailing instance axes, an expert's cores over its
    groups) and per-instance scalar scales ``sl``, ``sr`` of shape ``I``
    give ``C[*I, M, N]``: the 2-D form run on each instance with its
    own scales, a loop, so bit for bit the unbatched result."""
    if xq.dim() > 2:
        lead = tuple(xq.shape[:-2])
        outs = [matmul_scaled(x, w, a.reshape(1, 1), b.reshape(1, 1),
                              transpose_rhs=transpose_rhs)
                for x, w, a, b in zip(_instances(xq, lead),
                                      _instances(wq, lead),
                                      _instances(sl, lead),
                                      _instances(sr, lead))]
        return torch.stack(outs).reshape(lead + tuple(outs[0].shape))
    w = wq.t() if transpose_rhs else wq
    return torch.matmul(xq.float(), w.float()) * sl * sr


def chain_n_scaled(x: torch.Tensor, weights, scales) -> torch.Tensor:
    """The quantized chain: ``scales = (s_first [m0, 1], c_2 [1, 1], ...,
    s_last [1, n])``.  Link 0 multiplies the f32-upcast operands and
    scales per link-0 row; each later link reads the previous result
    rounded to bf16 and regrouped to ``[-1, k_i]``, multiplies it by the
    bf16-cast weight (exact from fp8/int8) with f32 accumulation, and
    scales by its factor.  The reference's own mirror of its kernel
    (``plan_compiler._run_quantized``'s unfused fallback); f32 out.

    Batched: ``x[*I, m0, k]``, ``W_i[*I, k_i, n_i]`` (broadcast over
    trailing instance axes where an expert's) and every factor a
    per-instance scalar of shape ``I``: the 2-D chain on each instance,
    a loop, bit for bit the unbatched result."""
    weights, scales = tuple(weights), tuple(scales)
    if x.dim() > 2:
        lead = tuple(x.shape[:-2])
        per = [_instances(t, lead) for t in (x, *weights, *scales)]
        n = len(weights)
        outs = [chain_n_scaled(p[0], p[1:1 + n],
                               [s_.reshape(1, 1) for s_ in p[1 + n:]])
                for p in zip(*per)]
        return torch.stack(outs).reshape(lead + tuple(outs[0].shape))
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


def chain_readback_agreement(chain, x: torch.Tensor, ws, scales
                             ) -> tuple[bool, dict]:
    """Whether the batched scaled two-link chain ``chain`` (the kernel's
    wrapper, ``fused_contraction.chain_n_cuda``) agrees with
    :func:`chain_n_scaled` on ``x[*I, m0, k0]``, ``ws`` and per-instance
    ``scales``, and the numbers that decide it.

    :func:`chain_scaled_agreement` counts output elements, and where an
    instance's output has few rows one intermediate a bf16 ulp off moves
    a whole row (at 32 rows 3.1% of the elements, against its 0.5%),
    which the plain version's own f32 sums do about once in 16,000
    intermediates at a 2,048-long link 0.  So the kernel's link-0
    intermediates are read back (link 1 replaced by unit columns at
    scale 1: the same kernel, configuration and link 0, eight
    intermediates a launch) and held to that rule's reason itself: at
    most 0.5% of each instance's intermediates off the plain version's,
    none by more than one bf16 ulp of the instance's largest
    intermediate; and the kernel's output within 1e-5 of each instance's
    scale of link 1 run in f32 on the kernel's own intermediates."""
    _, w1 = ws
    lead = x.dim() - 2
    inst = tuple(x.shape[:lead])
    k1, n = w1.shape[-2], 8
    ones = torch.ones(inst, device=x.device)
    cols = []
    for j in range(k1 // n):
        sel = torch.zeros(k1, n, device=x.device)
        sel[j * n + torch.arange(n), torch.arange(n)] = 1.0
        sel = sel.to(x.dtype).expand(inst + (k1, n))
        cols.append(chain(x, [ws[0], sel],
                                    scales=(scales[0], ones)))
    got_h = torch.cat(cols, -1).flatten(0, lead - 1)     # [I, rows1, k1]
    xs, w0s = x.flatten(0, lead - 1), ws[0].flatten(0, lead - 1)
    s0 = scales[0].flatten()
    want_h = torch.stack([
        (torch.matmul(xi.float(), wi.float()) * si).to(torch.bfloat16)
        .float().reshape(got_h.shape[1:])
        for xi, wi, si in zip(xs, w0s, s0)])
    off = got_h != want_h
    # one bf16 ulp of each instance's largest intermediate: an
    # intermediate near zero (cancellation) takes the f32 sums' error as
    # many ulps of its own
    top = want_h.abs().flatten(1).amax(-1)
    ulp = torch.ldexp(torch.ones_like(top), torch.frexp(top)[1] - 8)
    gap = (got_h - want_h).abs().flatten(1).amax(-1)
    one_ulp = bool((gap <= ulp).all())
    share = off.flatten(1).float().mean(-1)
    out = chain(x, ws, scales=scales).flatten(0, lead - 1)
    link1 = torch.matmul(got_h, w1.flatten(0, lead - 1).float()) \
        * scales[1].flatten()[:, None, None]
    err = (out - link1).abs().flatten(1).amax(-1)
    scale = link1.abs().flatten(1).amax(-1)
    nums = {"intermediates_off_share_max": float(share.max()),
            "intermediates_off": int(off.sum()),
            "intermediates": off.numel(),
            "max_gap_in_scale_ulps": float((gap / ulp).max()),
            "link1_max_rel_err": float((err / scale).max())}
    return (float(share.max()) <= 0.005 and one_ulp
            and bool((err <= 1e-5 * scale).all())), nums


def quantize(x: torch.Tensor, scale: torch.Tensor,
             policy: QuantPolicy, lead: int = 0) -> torch.Tensor:
    """``q[R, C] = cast(clip(x / scale, ±qmax))``: a true divide, int8
    rounded half to even, fp8 rounded by the cast (nearest even).  The
    precision subsystem's own cast, on per-row scales ``[R, 1]`` or one
    scalar scale.  ``lead``: ``x[*I, ...]`` with one scale per instance,
    ``scale`` of shape ``I`` (the per-row form on ``[prod(I), -1]``)."""
    if lead:
        return quant._cast(x, scale, policy, lead)
    return quant._cast(x, scale.reshape(-1), policy)


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               out_dtype=torch.float32, lead: int = 0) -> torch.Tensor:
    """``x[R, C] = q * scale``: one f32 multiply, then the cast; ``scale``
    per row ``[R, 1]`` or one scalar, or with ``lead`` one per instance
    of ``q[*I, ...]``."""
    if lead:
        return quant.dequantize(quant.QTensor(q=q, scale=scale, lead=lead),
                                out_dtype)
    return quant.dequantize(quant.QTensor(q=q, scale=scale.reshape(-1)),
                            out_dtype)


def requantize(x: torch.Tensor, policy: QuantPolicy, lead: int = 0
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-tensor requantize: ``(q, scale)`` with ``scale =
    clamp(max |x|, min=1e-12) * margin / qmax`` in f32, in that order, and
    ``q`` :func:`quantize`'s cast by it; ``quant.quantize(x, policy)`` at
    ``granularity="tensor"``, bit for bit on the CPU.  ``lead``: one amax
    and scale per instance of ``x[*I, ...]`` (``scale`` of shape ``I``),
    each what the unbatched form gives that instance.

    The divide by ``qmax`` is by an f32 tensor on ``x``'s device, not by
    a Python number: on the card torch divides by a host scalar as a
    multiply by its reciprocal, which can move the scale's last bit
    against the true divide of the reference (and of the kernel)."""
    amax = qpolicy.lead_amax(x, lead)
    qmax = torch.full((), policy.qmax, dtype=torch.float32, device=x.device)
    scale = torch.clamp(amax, min=qpolicy._EPS) * policy.margin / qmax
    return quant._cast(x, scale, policy, lead), scale

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


def linear_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_decay: torch.Tensor, u: torch.Tensor | None = None, *,
                mode: str = "ssd", out_dtype=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential-oracle linear recurrence (single stream)::

        S_t = diag(d_t) S_{t-1} + k_t^T v_t
        o_t = q_t (diag(a_t) S_{t-1} + diag(g_t) k_t^T v_t)

    mode ``ssd``: a = d, g = 1 (Mamba-2: ``o_t = q_t S_t``); mode
    ``rwkv6``: a = 1, g = u (bonus on the current token).  Shapes: q, k,
    log_decay ``[T, dk]``; v ``[T, dv]``; u ``[dk]``.  Returns ``(o [T,
    dv], final state [dk, dv] f32)``."""
    o, state = linear_scan_batched(
        q[None], k[None], v[None], log_decay[None],
        None if u is None else u[None], mode=mode, out_dtype=out_dtype)
    return o[0], state[0]


def linear_scan_batched(q, k, v, log_decay, u=None, *, mode: str = "ssd",
                        out_dtype=None) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`linear_scan` over a leading ``[BH]`` axis, one token at a
    time.  Returns ``(o [BH, T, dv], final state [BH, dk, dv] f32)``."""
    _check_mode(mode)
    bh, t, dk = q.shape
    dv = v.shape[-1]
    f32 = torch.float32
    d = torch.exp(log_decay.float())
    u = (torch.zeros((bh, dk), dtype=f32, device=q.device) if u is None
         else u.float())
    qf, kf, vf = q.float(), k.float(), v.float()
    state = torch.zeros((bh, dk, dv), dtype=f32, device=q.device)
    outs = []
    for i in range(t):
        kv = kf[:, i, :, None] * vf[:, i, None, :]
        if mode == "ssd":
            seen = state * d[:, i, :, None] + kv
        else:
            seen = state + u[:, :, None] * kv
        outs.append(torch.einsum("bk,bkv->bv", qf[:, i], seen))
        state = state * d[:, i, :, None] + kv
    o = (torch.stack(outs, dim=1) if outs
         else torch.zeros((bh, 0, dv), dtype=f32, device=q.device))
    return o.to(out_dtype or v.dtype), state


def _check_mode(mode: str) -> None:
    if mode not in ("ssd", "rwkv6"):
        raise ValueError(f"scan mode {mode!r} is not 'ssd' or 'rwkv6'")


def scalar_decay(log_decay: torch.Tensor, mode: str) -> bool:
    """Whether a scan takes the overflow-free ``ssd`` form: ``ssd`` mode
    with a log-decay that is one scalar per (stream, token), broadcast
    over ``dk`` as an expanded view (last stride 0), as Mamba-2 passes
    it."""
    return (mode == "ssd" and log_decay.dim() == 3
            and log_decay.shape[-1] > 1 and log_decay.stride(-1) == 0)


def chunked_linear_scan(q, k, v, log_decay, u=None, *, mode: str = "ssd",
                        chunk: int = 128, out_dtype=None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the chunked scan kernel (the same blocked math).

    Port of the reference's ``chunked_linear_scan``.  Per chunk of
    ``chunk`` tokens: ``lc`` = in-chunk cumulative log-decay, ``ex = lc``
    (ssd) or ``lc - log_decay`` (rwkv6), ``q_t = q * exp(ex)``, ``k_t = k
    * exp(-lc)``, ``att = q_t k_t^T`` masked to the lower triangle (ssd:
    with the diagonal; rwkv6: strict, plus ``sum(q * u * k)`` on the
    diagonal), ``o = att v + q_t S``, then ``S = S * exp(lc[-1]) + (k *
    exp(lc[-1] - lc))^T v``.  All in f32.  This factorization overflows
    f32 where a chunk's ``lc`` falls below about -88.7, as the
    reference's does; ``rwkv6`` and a per-channel ``ssd`` decay keep it,
    so they agree with the reference.

    An ``ssd`` decay broadcast over ``dk`` (:func:`scalar_decay`) takes
    the form whose every exponent is ``<= 0``: with ``lc`` one scalar per
    token, ``att_ij = (q_i . k_j) * exp(lc_i - lc_j)`` for ``j <= i``,
    ``o = att v + exp(lc) * (q S)`` and ``S = S * exp(lc[-1]) + (k *
    exp(lc[-1] - lc))^T v``; it never overflows, and equals the
    sequential oracle wherever that is finite.  Differentiable; shapes as
    :func:`linear_scan_batched`; ``T`` must be a multiple of ``chunk``."""
    _check_mode(mode)
    bh, t, dk = q.shape
    dv = v.shape[-1]
    if chunk < 1 or t % chunk:
        raise ValueError(f"T={t} not a multiple of chunk={chunk}")
    nc, c = t // chunk, chunk
    f32 = torch.float32
    dev = q.device
    scalar = scalar_decay(log_decay, mode)
    if u is None:
        u = torch.zeros((bh, dk), dtype=f32, device=dev)

    def blocks(z, d):
        return z.float().reshape(bh, nc, c, d)

    qb, kb, vb = blocks(q, dk), blocks(k, dk), blocks(v, dv)
    # The scalar decay as [BH, nc, C, 1]: its cumsum runs over a dim that
    # is not the last, as the per-channel one does, so the sums are taken
    # in token order on either device (the kernel's order).
    ldb = blocks(log_decay[..., :1] if scalar else log_decay,
                 1 if scalar else dk)
    row = torch.arange(c, device=dev)[:, None]
    col = torch.arange(c, device=dev)[None, :]
    tri = (row >= col) if mode == "ssd" else (row > col)
    state = torch.zeros((bh, dk, dv), dtype=f32, device=dev)
    outs = []
    for n in range(nc):
        qc, kc, vc, ldc = qb[:, n], kb[:, n], vb[:, n], ldb[:, n]
        lc = torch.cumsum(ldc, dim=1)
        if scalar:
            seg = torch.where(tri, lc - lc.transpose(1, 2), -math.inf)
            att = (qc @ kc.transpose(1, 2)) * torch.exp(seg)
            outs.append(att @ vc + (qc @ state) * torch.exp(lc))
        else:
            ex = lc if mode == "ssd" else lc - ldc
            qt = qc * torch.exp(ex)
            kt = kc * torch.exp(-lc)
            att = torch.where(tri, qt @ kt.transpose(1, 2), 0.0)
            if mode == "rwkv6":
                diag = torch.sum(qc * u[:, None, :].float() * kc, dim=-1)
                att = att + torch.diag_embed(diag)
            outs.append(att @ vc + qt @ state)
        k_s = kc * torch.exp(lc[:, -1:, :] - lc)
        state = (state * torch.exp(lc[:, -1])[..., None]
                 + k_s.transpose(1, 2) @ vc)
    o = (torch.stack(outs, dim=1).reshape(bh, t, dv) if outs
         else torch.zeros((bh, 0, dv), dtype=f32, device=dev))
    return o.to(out_dtype or v.dtype), state
