"""Plain PyTorch versions of the kernels (the correctness contract).

Port of ``src/repro/kernels/ref.py`` for the kernels of the serving
slice.  Each function computes what its kernel in
:mod:`repro_torch.kernels.fused_contraction` computes, with the same
rounding points: products accumulate in f32 and each result is rounded
to the operand type.  The kernel wrappers run these for tensors on the
CPU; ``chip_smoke.py`` holds each kernel against them on the card.
"""

from __future__ import annotations

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
