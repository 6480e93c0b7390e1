"""Plain PyTorch versions of the kernels (the correctness contract).

Port of ``src/repro/kernels/ref.py`` for the kernels the port has so
far.  Each function computes what its kernel in
:mod:`repro_torch.kernels.fused_contraction` or
:mod:`repro_torch.kernels.flash_attention` computes, with the same
rounding points: products accumulate in f32 and each result is rounded
to the operand type.  The kernel wrappers run these for tensors on the
CPU; ``chip_smoke.py`` holds each kernel against them on the card.
"""

from __future__ import annotations

import math

import torch


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
