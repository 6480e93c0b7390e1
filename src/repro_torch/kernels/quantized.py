"""Hand-written CUDA quantize / dequantize kernels: the wrappers.

Port of ``src/repro/kernels/quantized.py``.  CUDA C++ for ``sm_90a`` in
``csrc/quantized.cu`` (its header says what bounds them on the H100 and
how the design answers it):

* :func:`quantize_cuda` replaces ``quantize_pallas`` (``_quantize_kernel``):
  ``q[R, C] = cast(clip(x / scale, ±qmax))`` from f32/bf16 to the
  policy's fp8/int8 type, ``scale`` per row (``[R, 1]``) or one f32
  scalar for the tensor.  The plan compiler quantizes every >= 2-D plan
  input node through it.
* :func:`dequantize_cuda` replaces ``dequantize_pallas``
  (``_dequantize_kernel``): ``x[R, C] = q * scale`` to f32 or bf16, with
  the same two forms of ``scale``.  The plan compiler dequantizes every
  quantized plan's output through it.
* :func:`requantize_cuda` is B5's per-tensor form with the scale found on
  the card: ``amax = max |x|``, ``scale = clamp(amax, min=1e-12) * margin
  / qmax``, then B5's cast; the reference's ``quant.quantize(x, policy)``
  at ``granularity="tensor"``, which its plan compiler runs in jnp after
  every quantized op.  One launch up to :data:`REQUANT_ONE_LAUNCH_MAX`
  elements (one block holding the tensor in registers), two above it (a
  partial-amax kernel, then the cast).  The plan compiler requantizes
  every quantized op's result through it on the card.

All are bit-equal to their plain versions (:func:`ref.quantize`,
:func:`ref.dequantize`, :func:`ref.requantize`).  For tensors on the CPU
the wrappers run those; for CUDA tensors they launch the kernel or
raise.  Launches are counted in ``fused_contraction.LAUNCHES``:
``["quantize"]``, ``["dequantize"]``, ``["requantize"]`` (one per
requantize: the cast, with the amax in the same launch when it fits one
block) and ``["requantize_amax"]`` (the partial-amax launches of larger
tensors).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fused_contraction import (
    _DTYPE_CODES, _QUANT_CODES, LAUNCHES,
)
from repro_torch.precision.policy import _EPS as EPS
from repro_torch.precision.policy import QuantPolicy


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import build
    lib = build.load("quantized")
    if not getattr(lib, "_typed", False):
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        cf = ctypes.c_float
        lib.q_quantize.argtypes = [ci, ci, vp, vp, ci, vp, ll, ll, cf, vp]
        lib.q_quantize.restype = ci
        lib.q_dequantize.argtypes = [ci, ci, vp, vp, ci, vp, ll, ll, vp]
        lib.q_dequantize.restype = ci
        lib.q_requantize.argtypes = [ci, ci, vp, vp, vp, vp, ll, cf, cf, cf,
                                     vp]
        lib.q_requantize.restype = ci
        lib.q_requantize_one_launch_max.restype = ll
        lib.q_requantize_max_partials.restype = ll
        lib.q_error_string.argtypes = [ci]
        lib.q_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(op: str, a: torch.Tensor, scale: torch.Tensor, codes) -> bool:
    """Validate the operands; True for per-row scales, False for one."""
    if a.dim() != 2:
        raise ValueError(f"{op}: operand must be 2-D, got {tuple(a.shape)}")
    if scale.dim() != 0 and tuple(scale.shape) != (a.shape[0], 1):
        raise ValueError(f"{op}: scale must be [{a.shape[0]}, 1] or a "
                         f"scalar, got {tuple(scale.shape)}")
    if scale.dtype != torch.float32:
        raise ValueError(f"{op}: scale must be float32, not {scale.dtype}")
    if a.dtype not in codes:
        raise ValueError(f"{op}: dtype {a.dtype} not supported "
                         f"({sorted(str(d) for d in codes)})")
    return scale.dim() != 0


def _run(op: str, lib_fn, lib, *args) -> None:
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    rc = lib_fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{op} launch failed: CUDA error {rc} "
                           f"({lib.q_error_string(rc).decode()})")


def _on_card(op: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA operands, False for CPU ones; raises otherwise."""
    devs = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devs):
        return False
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{op}: no kernel for devices {sorted(map(str, devs))}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{op}: operands must be contiguous")
    return True


def quantize_cuda(x: torch.Tensor, scale: torch.Tensor,
                  policy: QuantPolicy) -> torch.Tensor:
    """``q[R, C] = saturate(x / scale)`` cast to ``policy.operand_dtype``;
    ``scale`` is f32 ``[R, 1]`` (any granularity expanded per row) or an
    f32 scalar (per tensor)."""
    per_row = _check("quantize_cuda", x, scale, _DTYPE_CODES)
    if not _on_card("quantize_cuda", x, scale):
        return ref.quantize(x, scale, policy)
    out = torch.empty(x.shape, dtype=policy.operand_dtype, device=x.device)
    if x.numel() == 0:
        return out
    lib = _lib()
    _run("quantize_cuda", lib.q_quantize, lib, _DTYPE_CODES[x.dtype],
         _QUANT_CODES[policy.operand_dtype], x.data_ptr(), scale.data_ptr(),
         int(per_row), out.data_ptr(), x.shape[0], x.shape[1], policy.qmax)
    LAUNCHES["quantize"] += 1
    return out


def dequantize_cuda(q: torch.Tensor, scale: torch.Tensor,
                    out_dtype=torch.float32) -> torch.Tensor:
    """``x[R, C] = q * scale`` to ``out_dtype`` (f32 or bf16); ``scale``
    as for :func:`quantize_cuda`."""
    per_row = _check("dequantize_cuda", q, scale, _QUANT_CODES)
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"dequantize_cuda: output dtype {out_dtype} not "
                         "supported (float32, bfloat16)")
    if not _on_card("dequantize_cuda", q, scale):
        return ref.dequantize(q, scale, out_dtype)
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    if q.numel() == 0:
        return out
    lib = _lib()
    _run("dequantize_cuda", lib.q_dequantize, lib, _QUANT_CODES[q.dtype],
         _DTYPE_CODES[out_dtype], q.data_ptr(), scale.data_ptr(),
         int(per_row), out.data_ptr(), q.shape[0], q.shape[1])
    LAUNCHES["dequantize"] += 1
    return out


#: elements the one-launch requantize holds in one block
#: (``kOneLaunchMax`` in ``csrc/quantized.cu``); larger tensors take two
REQUANT_ONE_LAUNCH_MAX = 32768
#: partial amaxes the two-launch requantize writes, at most
#: (``kMaxPartials``): the scratch it is given
REQUANT_MAX_PARTIALS = 512


def requantize_launches(numel: int) -> int:
    """Kernel launches :func:`requantize_cuda` makes for ``numel`` > 0
    elements."""
    return 1 if numel <= REQUANT_ONE_LAUNCH_MAX else 2


def _dense(x: torch.Tensor) -> bool:
    """Whether ``x`` covers its storage span exactly once in some order
    (a permutation of a contiguous tensor): then an elementwise kernel
    can walk its storage flat."""
    order = sorted(range(x.dim()), key=lambda d: -x.stride(d))
    return x.permute(order).is_contiguous()


def requantize_cuda(x: torch.Tensor, policy: QuantPolicy
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor quantize with the scale found from ``x`` itself:
    ``(q, scale)`` with ``scale = clamp(max |x|, min=1e-12) * margin /
    qmax`` (an f32 scalar on ``x``'s device) and ``q`` B5's cast of ``x``
    by it, in ``policy.operand_dtype``.  ``x`` (f32 or bf16, any shape)
    may be a permuted view of a dense tensor: the kernels walk its
    storage, and ``q`` gets ``x``'s strides (as a torch elementwise op
    gives it), so a permuted result needs no copy."""
    if not policy.quantized:
        raise ValueError("requantize_cuda: a bf16 (no-op) policy")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"requantize_cuda: dtype {x.dtype} not supported "
                         "(float32, bfloat16)")
    if x.device.type == "cpu":
        return ref.requantize(x, policy)
    if x.device.type != "cuda":
        raise ValueError(f"requantize_cuda: no kernel for device {x.device}")
    if not (x.is_contiguous() or _dense(x)):
        raise ValueError("requantize_cuda: operand must be dense (a "
                         "permutation of a contiguous tensor), got strides "
                         f"{x.stride()} for shape {tuple(x.shape)}")
    n = x.numel()
    if n == 0:
        raise ValueError("requantize_cuda: empty tensor has no amax")
    q = torch.empty_strided(x.shape, x.stride(), dtype=policy.operand_dtype,
                            device=x.device)
    scale = torch.empty((), dtype=torch.float32, device=x.device)
    two = requantize_launches(n) == 2
    partial = (torch.empty(REQUANT_MAX_PARTIALS, dtype=torch.int32,
                           device=x.device) if two else None)
    lib = _lib()
    _run("requantize_cuda", lib.q_requantize, lib, _DTYPE_CODES[x.dtype],
         _QUANT_CODES[policy.operand_dtype], x.data_ptr(), q.data_ptr(),
         scale.data_ptr(), None if partial is None else partial.data_ptr(),
         n, policy.qmax, policy.margin, EPS)
    LAUNCHES["requantize"] += 1
    if two:
        LAUNCHES["requantize_amax"] += 1
    return q, scale
