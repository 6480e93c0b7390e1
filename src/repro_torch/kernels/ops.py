"""Differentiable entry point of the scan kernel.

Port of ``src/repro/kernels/ops.py::linear_scan`` and its custom VJP
(``_linear_scan``, ``_linear_scan_fwd``, ``_linear_scan_bwd``).  The
reference's ``fused_matmul`` / ``fused_chain`` wrappers have their port
in :mod:`repro_torch.core.contraction`, which calls the kernel wrappers
directly.

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
