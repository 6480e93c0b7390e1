"""Hand-written CUDA quantize / dequantize kernels: the wrappers.

Port of ``src/repro/kernels/quantized.py``.  Two kernels, CUDA C++ for
``sm_90a`` in ``csrc/quantized.cu`` (its header says what bounds them on
the H100 and how the design answers it):

* :func:`quantize_cuda` replaces ``quantize_pallas`` (``_quantize_kernel``):
  ``q[R, C] = cast(clip(x / scale[R, 1], ±qmax))`` from f32/bf16 to the
  policy's fp8/int8 type.  The plan compiler quantizes every >= 2-D plan
  input node through it.
* :func:`dequantize_cuda` replaces ``dequantize_pallas``
  (``_dequantize_kernel``): ``x[R, C] = q * scale[R, 1]`` to f32 or bf16.
  The plan compiler dequantizes every quantized plan's output through it.

Both are bit-equal to their plain versions (:func:`ref.quantize`,
:func:`ref.dequantize`).  For tensors on the CPU the wrappers run those;
for CUDA tensors they launch the kernel or raise.  Launches are counted
in ``fused_contraction.LAUNCHES["quantize"]`` / ``["dequantize"]``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fused_contraction import (
    _DTYPE_CODES, _QUANT_CODES, LAUNCHES,
)
from repro_torch.precision.policy import QuantPolicy


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import build
    lib = build.load("quantized")
    if not getattr(lib, "_typed", False):
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.q_quantize.argtypes = [ci, ci, vp, vp, vp, ll, ll,
                                   ctypes.c_float, vp]
        lib.q_quantize.restype = ci
        lib.q_dequantize.argtypes = [ci, ci, vp, vp, vp, ll, ll, vp]
        lib.q_dequantize.restype = ci
        lib.q_error_string.argtypes = [ci]
        lib.q_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(op: str, a: torch.Tensor, scale: torch.Tensor, codes) -> None:
    if a.dim() != 2:
        raise ValueError(f"{op}: operand must be 2-D, got {tuple(a.shape)}")
    if tuple(scale.shape) != (a.shape[0], 1):
        raise ValueError(f"{op}: scale must be [{a.shape[0]}, 1], got "
                         f"{tuple(scale.shape)}")
    if scale.dtype != torch.float32:
        raise ValueError(f"{op}: scale must be float32, not {scale.dtype}")
    if a.dtype not in codes:
        raise ValueError(f"{op}: dtype {a.dtype} not supported "
                         f"({sorted(str(d) for d in codes)})")


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
    ``scale`` is f32 ``[R, 1]`` (any granularity expanded per row)."""
    _check("quantize_cuda", x, scale, _DTYPE_CODES)
    if not _on_card("quantize_cuda", x, scale):
        return ref.quantize(x, scale, policy)
    out = torch.empty(x.shape, dtype=policy.operand_dtype, device=x.device)
    if x.numel() == 0:
        return out
    lib = _lib()
    _run("quantize_cuda", lib.q_quantize, lib, _DTYPE_CODES[x.dtype],
         _QUANT_CODES[policy.operand_dtype], x.data_ptr(), scale.data_ptr(),
         out.data_ptr(), x.shape[0], x.shape[1], policy.qmax)
    LAUNCHES["quantize"] += 1
    return out


def dequantize_cuda(q: torch.Tensor, scale: torch.Tensor,
                    out_dtype=torch.float32) -> torch.Tensor:
    """``x[R, C] = q * scale`` to ``out_dtype`` (f32 or bf16)."""
    _check("dequantize_cuda", q, scale, _QUANT_CODES)
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
         out.data_ptr(), q.shape[0], q.shape[1])
    LAUNCHES["dequantize"] += 1
    return out

