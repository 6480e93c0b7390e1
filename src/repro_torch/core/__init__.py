"""Tensor-network IR, plan search, plan compiler and the tensorized layer.

Port of ``src/repro/core/``.  The pure-Python planning stack (IR,
factorizations, perf model, CSSE) keeps the reference's semantics; the
executors (:mod:`~repro_torch.core.contraction`,
:mod:`~repro_torch.core.plan_compiler`) run on torch tensors and reach
the hand-written CUDA kernels of :mod:`repro_torch.kernels`.
"""
