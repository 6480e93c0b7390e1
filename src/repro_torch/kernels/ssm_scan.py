"""Hand-written CUDA chunked linear-recurrence scan: the wrapper.

Port of ``src/repro/kernels/ssm_scan.py``.  One kernel, CUDA C++ for
``sm_90a`` in ``csrc/ssm_scan.cu`` (its header says what bounds it on the
H100 and how the design answers it):

* :func:`linear_scan_cuda` replaces ``linear_scan_pallas``
  (``_scan_kernel``): the RWKV-6 (``rwkv6``) / Mamba-2 (``ssd``) token
  mixing ``S_t = diag(d_t) S_{t-1} + k_t^T v_t`` over ``[BH, T, d]``
  streams in chunks, the ``[dk, dv]`` f32 state carried across chunks
  in shared memory, the four products of each chunk on the tensor cores
  in split TF32.  Returns ``o [BH, T, dv]`` in v's dtype and the final
  state ``[BH, dk, dv]`` in f32 (what prefill hands to decode).

``rwkv6`` and a per-channel ``ssd`` decay keep the reference's
factorization of the decay (``q * exp(lc)``, ``k * exp(-lc)``, ``lc``
the in-chunk cumulative log-decay), so kernel and plain version agree
with the reference wherever it is finite; that form overflows f32 once
``lc`` falls below about -88.7 inside a chunk.  An ``ssd`` decay
broadcast over ``dk`` (an expanded view, as Mamba-2 passes it;
:func:`repro_torch.kernels.ref.scalar_decay`) reaches the kernel as
``[BH, T]`` and takes the form whose exponents are all ``<= 0``
(``exp(lc_i - lc_j)``), which never overflows.

For tensors on the CPU the wrapper runs the plain twin
(:func:`repro_torch.kernels.ref.chunked_linear_scan`); for CUDA tensors
it launches the kernel or raises, never falls back.  Launches are
counted in ``fused_contraction.LAUNCHES["linear_scan"]``.  Shapes whose
shared-memory footprint (:func:`scan_smem_bytes`) exceeds the block
budget, or whose ``dk`` exceeds :data:`MAX_DK`, raise
:class:`ScanLoweringError` before anything launches, on either device;
``T`` not a multiple of the chunk raises ``ValueError``, as the
reference asserts.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fused_contraction import (
    _DTYPE_CODES, CHAIN_SMEM_BUDGET_BYTES, LAUNCHES,
)

#: the kernel's modes: ``ssd`` with a per-channel decay, ``rwkv6``, and
#: ``ssd`` with a decay broadcast over dk (handed over as ``[BH, T]``)
_MODES = {"ssd": 0, "rwkv6": 1, "ssd_scalar": 2}
#: largest key/state width the kernel takes (``kMaxDk``): its q fragments
#: live in registers
MAX_DK = 128


class ScanLoweringError(ValueError):
    """The scan kernel was asked for shapes it cannot take."""


def _up(a: int, b: int) -> int:
    return -(-a // b) * b


def scan_smem_bytes(chunk: int, dk: int, dv: int, itemsize: int) -> int:
    """Shared memory one scan block uses, with the chunk padded to 16
    rows, ``dk`` to 8 and ``dv`` to 16 (zeros), every array row-major with
    8 elements of row padding: the log-decay ``[C][dk]`` f32 (turned in
    place into ``lc``, then into the state update's ``k * exp(lc_last -
    lc)``); ``k_t = k * exp(-lc)`` ``[C][dk]`` f32; v ``[C][dv]`` in its
    own type; the state, transposed, ``[dv][dk]`` f32; the chunk's last
    ``lc``, u and the scalar ``lc``.  ``smem_bytes`` in the CUDA source is
    the same formula."""
    cp, dk8, dv16 = _up(chunk, 16), _up(dk, 8), _up(dv, 16)
    return (8 * cp * (dk8 + 8) + itemsize * cp * (dv16 + 8)
            + 4 * dv16 * (dk8 + 8) + 4 * (2 * dk8 + cp))


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import build
    lib = build.load("ssm_scan")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.ss_scan.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, vp, ci, ci,
                                ci, ci, ci, vp]
        lib.ss_scan.restype = ci
        lib.ss_smem_bytes.argtypes = [ci, ci, ci, ci]
        lib.ss_smem_bytes.restype = ctypes.c_longlong
        lib.ss_smem_budget.restype = ctypes.c_longlong
        lib.ss_max_dk.restype = ci
        lib.ss_blocks_per_sm.argtypes = [ci, ci, ci, ci, ci, ci]
        lib.ss_blocks_per_sm.restype = ci
        lib.ss_error_string.argtypes = [ci]
        lib.ss_error_string.restype = ctypes.c_char_p
        if (lib.ss_smem_budget(), lib.ss_max_dk()) != (
                CHAIN_SMEM_BUDGET_BYTES, MAX_DK):
            raise RuntimeError("ssm_scan.cu disagrees on the shared-memory "
                               "budget or the dk limit")
        lib._typed = True
    return lib


def blocks_per_sm(chunk: int, dk: int, dv: int, dtype: torch.dtype,
                  mode: str = "rwkv6") -> int:
    """Scan blocks one SM holds at once at this shape and kernel mode
    (``ssd``, ``rwkv6`` or ``ssd_scalar``): the CUDA occupancy calculator
    on the built kernel, registers and shared memory.  Needs the card."""
    lib = _lib()
    return lib.ss_blocks_per_sm(_DTYPE_CODES[dtype], _MODES[mode], chunk, dk,
                                dv, dtype.itemsize)


def _check_shapes(q, k, v, log_decay, u, mode: str, chunk: int) -> None:
    if mode not in ("ssd", "rwkv6"):
        raise ValueError(f"scan mode {mode!r} is not 'ssd' or 'rwkv6'")
    if q.dim() != 3 or k.shape != q.shape or log_decay.shape != q.shape:
        raise ScanLoweringError(
            f"q, k, log_decay must share one [BH, T, dk] shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(log_decay.shape)}")
    bh, t, dk = q.shape
    if v.dim() != 3 or v.shape[:2] != q.shape[:2]:
        raise ScanLoweringError(f"v {tuple(v.shape)} does not fit q "
                                f"{tuple(q.shape)}")
    if u is not None and tuple(u.shape) != (bh, dk):
        raise ScanLoweringError(f"u must be [{bh}, {dk}], got "
                                f"{tuple(u.shape)}")
    if u is None and mode == "rwkv6":
        raise ValueError("rwkv6 mode requires the u bonus vector")
    if chunk < 1 or t % chunk:
        raise ValueError(f"T={t} not a multiple of chunk={chunk}")
    need = scan_smem_bytes(chunk, dk, v.shape[-1], v.element_size())
    if need > CHAIN_SMEM_BUDGET_BYTES:
        raise ScanLoweringError(
            f"scan chunk {chunk} with dk {dk}, dv {v.shape[-1]} needs {need} "
            f"bytes of shared memory, over the {CHAIN_SMEM_BUDGET_BYTES}-byte "
            "block budget")
    if dk > MAX_DK:
        raise ScanLoweringError(f"scan dk {dk} exceeds the kernel's {MAX_DK}")


def linear_scan_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     log_decay: torch.Tensor, u: torch.Tensor | None = None,
                     *, mode: str = "ssd", chunk: int = 128
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched chunked scan.

    Shapes: q, k, log_decay ``[BH, T, dk]``; v ``[BH, T, dv]``; u ``[BH,
    dk]`` (required for ``rwkv6``).  ``T`` must be a multiple of
    ``chunk``.  On the card q, k and v share one dtype (f32 or bf16) and
    log_decay and u are f32.  Returns ``(o [BH, T, dv] in v.dtype,
    final_state [BH, dk, dv] f32)``.  An ``ssd`` log_decay broadcast over
    dk (an expanded view) takes the overflow-free form."""
    _check_shapes(q, k, v, log_decay, u, mode, chunk)
    tensors = (q, k, v, log_decay) + (() if u is None else (u,))
    if all(t.device.type == "cpu" for t in tensors):
        return ref.chunked_linear_scan(q, k, v, log_decay, u, mode=mode,
                                       chunk=chunk)
    if q.device.type != "cuda":
        raise ValueError(f"linear_scan_cuda: no kernel for device "
                         f"{q.device}")
    bh, t, dk = q.shape
    dv = v.shape[-1]
    if u is None:
        u = torch.zeros((bh, dk), dtype=torch.float32, device=q.device)
    for x in (k, v, log_decay, u):
        if x.device != q.device:
            raise ValueError("linear_scan_cuda: operands on "
                             f"{x.device} and {q.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"linear_scan_cuda: q, k, v must share one dtype "
                         f"of float32/bfloat16, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if log_decay.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError("linear_scan_cuda: log_decay and u must be "
                         "float32")
    kmode = mode
    if ref.scalar_decay(log_decay, mode):
        kmode, log_decay = "ssd_scalar", log_decay[..., 0].contiguous()
    if not all(x.is_contiguous() for x in (q, k, v, log_decay, u)):
        raise ValueError("linear_scan_cuda: operands must be contiguous")
    out = torch.empty_like(v)
    state = torch.empty((bh, dk, dv), dtype=torch.float32, device=q.device)
    if bh == 0 or t == 0:
        state.zero_()
        return out, state
    lib = _lib()
    rc = lib.ss_scan(_DTYPE_CODES[q.dtype], _MODES[kmode], q.data_ptr(),
                     k.data_ptr(), v.data_ptr(), log_decay.data_ptr(),
                     u.data_ptr(), out.data_ptr(), state.data_ptr(), bh, t,
                     dk, dv, chunk,
                     ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        msg = lib.ss_error_string(rc).decode()
        raise RuntimeError(f"linear_scan_cuda launch failed: CUDA error "
                           f"{rc} ({msg})")
    LAUNCHES["linear_scan"] += 1
    return out, state
