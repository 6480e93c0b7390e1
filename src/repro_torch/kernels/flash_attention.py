"""Hand-written CUDA flash-attention forward: the wrapper.

Port of ``src/repro/kernels/flash_attention.py``.  CUDA C++ for
``sm_90a`` in ``csrc/flash_attention.cu`` (its header says what bounds it
on the H100 and how the design answers it):

* :func:`flash_attention_fwd` replaces the Pallas ``flash_attention_fwd``
  (``_flash_kernel``): GQA attention with an online softmax, returning
  ``out [B, Tq, H, D]`` in q's dtype and ``lse [B, Tq, KV, G]`` in f32.
  It launches one of two kernels (:func:`kernel_for`): bf16 with a head
  dim that is a multiple of 8 runs ``flash_fwd_tc_kernel`` on the tensor
  cores; f32, and any other head dim, ``flash_fwd_kernel`` (SIMT: TF32
  tensor cores would miss the f32 gate).

:func:`rounding_probe` builds bf16 inputs on which the reference's
rounding of ``p`` to v's dtype moves the outputs by many ulps, so a check
on them fails a kernel that skips the rounding.

For tensors on the CPU the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.flash_attention_fwd`); for CUDA tensors it
launches the kernel or raises, never falls back.  Both step the online
softmax over the caller's ``kv_chunk`` keys, as the reference does, so
``p`` is rounded to v's dtype against the same running max; ``q_chunk``
splits rows, which are independent.  Launches are counted in
``fused_contraction.LAUNCHES["flash_attention_fwd"]``.

Shapes the kernel cannot take (head dim above :data:`MAX_HEAD_DIM`, a kv
chunk above :data:`MAX_KV_CHUNK`, ``H`` not a multiple of ``KV``) raise
:class:`AttentionLoweringError` before anything launches, on either
device; sequences the chunks do not divide raise ``ValueError``, as the
plain version does.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fused_contraction import LAUNCHES

#: largest head dim the kernel takes (``kMaxD`` in the CUDA source)
MAX_HEAD_DIM = 128
#: largest kv chunk (keys per online-softmax step) the kernel takes
#: (``kMaxChunk``): its score rows for one chunk live in shared memory
MAX_KV_CHUNK = 1024

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KERNELS = {"simt": 0, "tensor_cores": 1}


class AttentionLoweringError(ValueError):
    """The attention kernel was asked for shapes it cannot take."""


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import build
    lib = build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fa_forward.argtypes = [ci, ci, vp, vp, vp, vp, vp, ci, ci, ci,
                                   ci, ci, ci, ci, ctypes.c_float, ci, vp]
        lib.fa_forward.restype = ci
        lib.fa_max_head_dim.restype = ci
        lib.fa_max_kv_chunk.restype = ci
        lib.fa_error_string.argtypes = [ci]
        lib.fa_error_string.restype = ctypes.c_char_p
        if (lib.fa_max_head_dim(), lib.fa_max_kv_chunk()) != (
                MAX_HEAD_DIM, MAX_KV_CHUNK):
            raise RuntimeError("flash_attention.cu disagrees on the head-dim "
                               "or kv-chunk limit")
        lib._typed = True
    return lib


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_chunk: int, kv_chunk: int) -> int:
    """Refuse what the kernel cannot take; returns the kv chunk
    ``min(kv_chunk, Tk)``."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise AttentionLoweringError(
            f"attention operands must be 4-D, got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise AttentionLoweringError(
            f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not fit q "
            f"{tuple(q.shape)}")
    KV = k.shape[2]
    if KV < 1 or H % KV:
        raise AttentionLoweringError(f"{H} query heads are not a multiple "
                                     f"of {KV} kv heads")
    if D > MAX_HEAD_DIM:
        raise AttentionLoweringError(
            f"head dim {D} exceeds the kernel's {MAX_HEAD_DIM}")
    Tq, Tk = q.shape[1], k.shape[1]
    qc, kc = min(q_chunk, Tq), min(kv_chunk, Tk)
    if kc > MAX_KV_CHUNK:
        raise AttentionLoweringError(
            f"kv chunk {kc} exceeds the kernel's {MAX_KV_CHUNK}")
    if (qc and Tq % qc) or (kc and Tk % kc):
        raise ValueError(f"sequence ({Tq},{Tk}) not divisible by chunks "
                         f"({qc},{kc})")
    return kc


def kernel_for(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """Which kernel a launch on these operands runs: ``"tensor_cores"``
    for bf16 with a head dim that is a multiple of 8 and 16-byte aligned
    operands, else ``"simt"``."""
    if q.dtype == torch.bfloat16 and q.shape[-1] % 8 == 0 and all(
            t.data_ptr() % 16 == 0 for t in (q, k, v)):
        return "tensor_cores"
    return "simt"


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, q_chunk: int = 512,
                        kv_chunk: int = 512,
                        softmax_scale: float | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """GQA flash-attention forward.

    q: ``[B, Tq, H, D]``; k, v: ``[B, Tk, KV, D]`` with ``H = KV * G``.
    Returns ``(out [B, Tq, H, D] in q.dtype, lse [B, Tq, KV, G] f32)``.
    The online softmax steps over ``min(kv_chunk, Tk)`` keys at a time."""
    kc = _check_shapes(q, k, v, q_chunk, kv_chunk)
    B, Tq, H, D = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    scale = softmax_scale or 1.0 / math.sqrt(D)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return ref.flash_attention_fwd(q, k, v, causal=causal,
                                       q_chunk=q_chunk, kv_chunk=kv_chunk,
                                       softmax_scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: no kernel for device "
                         f"{q.device}")
    for t in (k, v):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("flash_attention_fwd: q, k and v must share "
                             "device and dtype")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention_fwd: dtype {q.dtype} not "
                         "supported (float32, bfloat16)")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention_fwd: operands must be contiguous")
    out = torch.empty_like(q)
    lse = torch.empty((B, Tq, KV, H // KV), dtype=torch.float32,
                      device=q.device)
    if B == 0 or Tq == 0:
        return out, lse
    if Tk == 0:
        raise AttentionLoweringError("attention over zero keys")
    lib = _lib()
    rc = lib.fa_forward(_DTYPE_CODES[q.dtype], _KERNELS[kernel_for(q, k, v)],
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), lse.data_ptr(), B, Tq, Tk, H, KV, D,
                        kc, float(scale), int(causal),
                        ctypes.c_void_p(torch.cuda.current_stream()
                                        .cuda_stream))
    if rc != 0:
        msg = lib.fa_error_string(rc).decode()
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{rc} ({msg})")
    LAUNCHES["flash_attention_fwd"] += 1
    return out, lse


def rounding_probe(B: int, T: int, H: int, D: int, *, device=None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """bf16 ``q [B, T, H, D]``, ``k, v [B, T, H, D]`` (non-causal use, the
    default softmax scale) on which rounding ``p`` to bf16 before the PV
    product, against the kv chunk's running max, moves every output by
    many bf16 ulps.

    In row (b, h) one peak key scores 0 and every other key ``-delta`` (a
    multiple of 1/8 that varies with b and h), so ``p = exp(-delta)`` for
    ``T - 1`` keys; their values are 1 and the peak's value is ``-c =
    -bf16((T - 1) * bf16(p))``.  The output ``((T - 1) * p' - c) / (1 +
    (T - 1) * p)`` then cancels to a few hundredths of its terms when
    ``p' = bf16(p)``, and the rounding error ``(T - 1) * (bf16(p) - p)``
    stands out of it instead of hiding under one ulp of the output.  The
    peak is key 0 where ``b * H + h`` is even and key ``T - 1`` where it
    is odd: there a kernel that steps its softmax over fewer keys than the
    chunk scales unrounded ``p = 1`` by ``exp(-delta)`` and fails too."""
    f32 = torch.float32
    idx = torch.arange(B * H)
    delta = (0.125 * (1 + idx % 24)).to(f32).reshape(B, 1, H, 1)
    peak = torch.where(idx % 2 == 0, 0, T - 1).reshape(B, 1, H, 1)
    at_peak = torch.arange(T).reshape(1, T, 1, 1) == peak
    p = torch.exp(-delta).to(torch.bfloat16).float()
    c = ((T - 1) * p).to(torch.bfloat16).float()
    q = torch.ones((B, T, H, D), dtype=f32)
    k = torch.where(at_peak, 0.0, -delta / math.sqrt(D)).expand(B, T, H, D)
    v = torch.where(at_peak, -c, 1.0).expand(B, T, H, D)
    return tuple(t.to(device=device, dtype=torch.bfloat16).contiguous()
                 for t in (q, k, v))
