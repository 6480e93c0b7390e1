"""Differentiable entry points of the GEMM, chain and scan kernels.

Port of ``src/repro/kernels/ops.py::linear_scan`` and its custom VJP
(``_linear_scan``, ``_linear_scan_fwd``, ``_linear_scan_bwd``), and the
gradients of the GEMM (B1) and chain (B2) kernels that the FP plan needs
when autodiff runs through it (``phase_paths=False``, the reference's
``jax.grad`` through its einsum steps).  The reference's
``fused_matmul`` / ``fused_chain`` wrappers have their port in
:mod:`repro_torch.core.contraction`, which calls the kernel wrappers
directly when no gradient is wanted.

:func:`matmul` and :func:`chain_n` run their forward through
:func:`~repro_torch.kernels.fused_contraction.matmul_cuda` /
:func:`~repro_torch.kernels.fused_contraction.chain_n_cuda` and their
backward through B1 again: ``dX = dY·W`` (or ``dY·Wᵀ``, B1's rhs
transpose on chip) and ``dW`` from a layout copy of one operand, as the
reference's einsum transposes; the chain recomputes its link inputs
with B1 (rounded to the operand type, as the kernel rounds its
intermediates), and runs each link's two products through B1, the row
regroup between links being a reshape.  Backward launches count under
``LAUNCHES["matmul_bwd"]``.  CPU tensors take the plain versions (the
wrappers' own rule); a CUDA tensor launches or raises.

:func:`linear_scan` runs the forward through
:func:`repro_torch.kernels.ssm_scan.linear_scan_cuda` (kernel B8 on a CUDA
tensor, its plain twin on the CPU).  The backward is the reference's:
autodiff of the plain chunked twin
(:func:`repro_torch.kernels.ref.chunked_linear_scan`), rematerialised
from the saved ``(q, k, v, log_decay, u)``; the twin computes the
kernel's values, so its gradient is the kernel's.  Both directions run
inside a ``torch.profiler`` range ``ssm.scan``, which
``repro_torch.analysis.train_profile`` reads.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch.kernels import ref, ssm_scan
from repro_torch.kernels.fused_contraction import chain_n_cuda, matmul_cuda


def _bwd_mm(x, w, transpose_rhs=False):
    return matmul_cuda(x, w, transpose_rhs=transpose_rhs,
                       launch_key="matmul_bwd")


class _Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, transpose_rhs: bool, out_dtype):
        ctx.transpose_rhs = transpose_rhs
        ctx.save_for_backward(x, w)
        return matmul_cuda(x, w, transpose_rhs=transpose_rhs,
                           out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        trans = ctx.transpose_rhs
        dy = dy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # Y = X·Wᵀ (W [N, K]): dX = dY·W; Y = X·W: dX = dY·Wᵀ
            dx = _bwd_mm(dy, w, transpose_rhs=not trans)
        if ctx.needs_input_grad[1]:
            dw = (_bwd_mm(dy.t().contiguous(), x) if trans       # [N, K]
                  else _bwd_mm(x.t().contiguous(), dy))          # [K, N]
        return dx, dw, None, None


class _Chain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out_dtype, x, *weights):
        ctx.save_for_backward(x, *weights)
        return chain_n_cuda(x, weights, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, *ws = ctx.saved_tensors
        # Link i's lhs [rows_i, k_i]: x, then each earlier link's result
        # (rounded to x's type, as the kernel keeps it) regrouped.
        acts = [x]
        for w, w_next in zip(ws, ws[1:]):
            acts.append(_bwd_mm(acts[-1], w).reshape(-1, w_next.shape[0]))
        g = dy.to(x.dtype)
        dws = [None] * len(ws)
        for i in reversed(range(len(ws))):
            g = g.reshape(acts[i].shape[0], ws[i].shape[1]).contiguous()
            if ctx.needs_input_grad[2 + i]:
                dws[i] = _bwd_mm(acts[i].t().contiguous(), g)
            if i or ctx.needs_input_grad[1]:
                g = _bwd_mm(g, ws[i], transpose_rhs=True)
        return (None, g if ctx.needs_input_grad[1] else None, *dws)


def matmul(x: torch.Tensor, w: torch.Tensor, *, transpose_rhs: bool = False,
           out_dtype=None) -> torch.Tensor:
    """:func:`~repro_torch.kernels.fused_contraction.matmul_cuda` with a
    gradient in ``x`` and ``w``, both directions through B1."""
    return _Matmul.apply(x, w, transpose_rhs, out_dtype)


def chain_n(x: torch.Tensor, weights, *, out_dtype=None) -> torch.Tensor:
    """:func:`~repro_torch.kernels.fused_contraction.chain_n_cuda` with a
    gradient in ``x`` and every weight; the backward runs B1.  A chain
    the kernel refuses raises
    :class:`~repro_torch.kernels.fused_contraction.ChainLoweringError`
    before anything launches, as the wrapper does."""
    return _Chain.apply(out_dtype, x, *weights)


class _LinearScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, log_decay, u, mode: str, chunk: int):
        ctx.static = (mode, chunk)
        ctx.save_for_backward(q, k, v, log_decay, u)
        with record_function("ssm.scan"):
            return ssm_scan.linear_scan_cuda(q, k, v, log_decay, u,
                                             mode=mode, chunk=chunk)

    @staticmethod
    def backward(ctx, do, dstate):
        mode, chunk = ctx.static
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with record_function("ssm.scan"), torch.enable_grad():
            outs = ref.chunked_linear_scan(*inputs, mode=mode, chunk=chunk)
            grads = torch.autograd.grad(outs, inputs, (do, dstate),
                                        allow_unused=True)
        return (*grads, None, None)


def linear_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_decay: torch.Tensor, u: torch.Tensor | None = None, *,
                mode: str = "ssd", chunk: int = 128
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked linear recurrence over ``[BH, T, d]`` streams (ssd /
    rwkv6).

    Returns ``(o [BH, T, dv] in v.dtype, final_state [BH, dk, dv] f32)``.
    Differentiable in q, k, v, log_decay and u.  ``u=None`` becomes
    zeros, as in the reference.  log_decay and u enter the kernel as
    f32.  An ``ssd`` log-decay broadcast over ``dk`` (an expanded view,
    :func:`repro_torch.kernels.ref.scalar_decay`) stays a view, so the
    forward and the backward both take the overflow-free form."""
    if u is None:
        u = torch.zeros((q.shape[0], q.shape[-1]), dtype=torch.float32,
                        device=q.device)
    if ref.scalar_decay(log_decay, mode):
        ld = log_decay[..., :1].float().contiguous().expand(log_decay.shape)
    else:
        ld = log_decay.float().contiguous()
    return _LinearScan.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                             ld, u.float().contiguous(), mode, chunk)
