"""Hand-written CUDA kernels for tensor-contraction hot spots: wrappers.

Port of ``src/repro/kernels/fused_contraction.py``.  Two kernels, CUDA C++
for ``sm_90a`` in ``csrc/fused_contraction.cu``, each with a scaled form
for quantized operands (the source's header says what bounds each one on
the H100 and how the design answers it):

* :func:`matmul_cuda` replaces ``matmul_pallas`` (``_matmul_kernel``):
  ``C[M, N] = X[M, K] @ W`` with W stored ``[K, N]`` or ``[N, K]``; the
  layout is reordered between shared memory and registers, never in
  device memory.  With ``scales=(sl, sr)`` it replaces
  ``matmul_pallas(scales=...)`` (``_matmul_scaled_kernel``): fp8/int8
  operands, f32 ``C = (Xq @ Wq) * sl[M, 1] * sr[1, N]``, the scales
  applied in the epilogue.  Every main-path geometry is bound by bytes;
  bf16, fp8 (widened exactly to f16) and int8 run on the tensor cores
  (``mma.sync``) and f32 on the FMA units, all fed by a ring of
  ``cp.async`` copies, with K split across blocks where the output tiles
  cannot fill the card and the slices summed in a fixed order (so a
  call's bits never vary).  The fp8 tensor-core sums are promoted into
  f32 registers every 64 elements of K.  :func:`gemm_config` is the one
  rule for tile, split and copy width that the wrapper, the kernel's
  check and the tests share.
* :func:`chain_n_cuda` replaces ``chain_n_pallas`` (``_chain_n_kernel``):
  an N-link contraction chain whose intermediates stay in shared memory,
  with the row-major regroup ``[r, n_i] -> [r/g, g*n_i]`` between links
  done as the store address of each link's epilogue.  With
  ``scales=(s_first, *mids, s_last)`` it runs the quantized branch:
  fp8/int8 operands, one folded dequantization factor per link, bf16
  intermediates, f32 output.  bf16, fp8 and int8 chains run
  ``chain_tc_kernel`` on the tensor cores (link 0's long K split across
  the block's warps, summed in a fixed order); f32 chains keep the
  FMA-unit ``chain_kernel``.  :func:`chain_kernel_for` names the kernel
  and :func:`chain_config` is its launch rule, shared like
  :func:`gemm_config`.  Which chains fuse is :func:`chain_band_rows`,
  the same for both kernels.

Both take a batch axis: one launch for every expert of a MoE's
expert-stacked layer (3-D operands), and in their scaled forms one launch
for every (expert, group) instance of its quantized experts (4-D
operands ``[E, G, ...]`` whose expert-level ones broadcast over G with
stride 0, and one per-tensor scale per instance: the reference vmaps its
quantized layer over the groups and the experts).

Each wrapper checks device, dtype, shape and contiguity, launches on
``torch.cuda.current_stream()`` and raises if the launch reports an
error.  For a tensor on the CPU it runs the plain version
(:mod:`repro_torch.kernels.ref`) instead; for a CUDA tensor it launches
the kernel or raises, never falls back.  :data:`LAUNCHES` counts kernel
launches per wrapper.

Geometry and budget violations raise :class:`ChainLoweringError` before
anything launches, on either device, so the plan compiler degrades a
refused chain to per-link GEMMs the same way everywhere.  The budget is
the H100's 232,448 bytes of shared memory per block
(:data:`CHAIN_SMEM_BUDGET_BYTES`), where the reference budgets 100 MiB of
TPU VMEM.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import ref

#: dynamic shared memory one H100 thread block may use (227 KB of the
#: SM's 256 KB; NVIDIA's Hopper architecture white paper)
CHAIN_SMEM_BUDGET_BYTES = 232_448
#: links one chain launch carries (``kMaxLinks`` in the CUDA source)
MAX_CHAIN_LINKS = 8
#: largest band of final rows one chain block owns
MAX_BAND_ROWS = 128
#: SMs of one H100: the chain wrapper sizes bands to give each one a
#: block, the GEMM splits K until its blocks cover them
_NUM_SMS = 132
#: the GEMM's output tiles (BM, BN), indexed as ``kTileBM``/``kTileBN`` in
#: ``csrc/fused_contraction.cu``: 128x64 for large outputs, 64x64 where
#: 128x64 tiles would not cover the SMs, 128x16 for N <= 16, 128x8 for
#: N <= 8 (the ``m16n8`` atom's width)
GEMM_TILES = ((128, 64), (64, 64), (128, 16), (128, 8))
#: depth of the GEMM's cp.async ring and the bytes of K a stage holds
GEMM_STAGES, GEMM_STAGE_BYTES = 4, 64
#: stages of K a split walks at least (the ring's depth)
GEMM_MIN_SPLIT_STEPS = 4
_THREADS = 256
#: warps of one tensor-core chain block (``kChainWarps``): they split
#: link 0's K and take the later links' m16n8 tiles in turn
CHAIN_WARPS = 8
#: link-0 rows one pass of the tensor-core chain computes (4 m16 tiles)
CHAIN_ROW_TILE = 64
#: 32-byte k-steps of K0 a warp takes of one ring stage, at most
CHAIN_MAX_WARP_STEPS = 8
#: bytes the tensor-core chain's X ring may take before warp slices shrink
CHAIN_RING_BYTES = 64 * 1024

#: kernel launches per wrapper since the last :func:`reset_launches`
#: (``flash_attention_fwd`` is counted by :mod:`.flash_attention`,
#: ``quantize`` / ``dequantize`` / ``requantize`` by :mod:`.quantized`,
#: ``linear_scan`` by :mod:`.ssm_scan`).  A split-K GEMM call launches two
#: kernels: the tile kernel, counted under ``matmul`` / ``matmul_scaled``,
#: and ``gemm_splitk_reduce``, counted under ``matmul_reduce`` /
#: ``matmul_scaled_reduce``.  Likewise a requantize too large for one
#: block: its cast under ``requantize``, its partial-amax kernel under
#: ``requantize_amax``.  The GEMMs an autograd backward runs (:mod:`.ops`)
#: count apart, under ``matmul_bwd`` / ``matmul_bwd_reduce``, and so do
#: the expert-batched launches (3-D operands, every expert in one
#: launch): ``matmul_batched`` / ``matmul_batched_reduce`` and
#: ``chain_n_batched``; and the instance-batched scaled ones (the
#: quantized experts): ``matmul_scaled_batched`` /
#: ``matmul_scaled_batched_reduce``, ``chain_n_scaled_batched``, and the
#: batched requantize, ``requantize_batched`` /
#: ``requantize_batched_amax``.
LAUNCHES = {"matmul": 0, "chain_n": 0, "flash_attention_fwd": 0,
            "matmul_scaled": 0, "chain_n_scaled": 0, "quantize": 0,
            "dequantize": 0, "linear_scan": 0, "matmul_reduce": 0,
            "matmul_scaled_reduce": 0, "requantize": 0,
            "requantize_amax": 0, "matmul_bwd": 0, "matmul_bwd_reduce": 0,
            "matmul_batched": 0, "matmul_batched_reduce": 0,
            "chain_n_batched": 0, "matmul_scaled_batched": 0,
            "matmul_scaled_batched_reduce": 0, "chain_n_scaled_batched": 0,
            "requantize_batched": 0, "requantize_batched_amax": 0}

#: operand dtype codes of the CUDA sources (``csrc/*.cu``)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_QUANT_CODES = {torch.float8_e4m3fn: 2, torch.float8_e5m2: 3, torch.int8: 4}


class ChainLoweringError(ValueError):
    """A kernel launch was asked for shapes it cannot lower.

    Raised by the wrappers on contraction-dim mismatches, non-integral
    regroups and shared-memory budget violations, before any launch.  The
    plan compiler treats it as "do not fuse": ``compile_plan`` skips the
    chain and ``plan_compiler.run`` re-executes a refused chain as plain
    GEMMs.
    """


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ChainLoweringError(msg)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def chain_plan(m0: int, shapes) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Validate an N-link chain and derive its row geometry.

    ``shapes`` is the per-link weight shape ``(k_i, n_i)``; ``m0`` the
    first link's row count.  Link ``i+1`` consumes link ``i``'s
    ``[rows_i, n_i]`` output reshaped to ``[rows_i / g_i, g_i * n_i]``
    where ``g_i = k_{i+1} / n_i``.  Returns ``(rows, regroups)``; raises
    :class:`ChainLoweringError` on non-integral regroups.
    """
    shapes = tuple((int(k), int(n)) for k, n in shapes)
    _require(len(shapes) >= 2,
             f"chain needs >= 2 links, got {len(shapes)}")
    rows, regroups = [m0], []
    for i in range(len(shapes) - 1):
        n_i, k_next = shapes[i][1], shapes[i + 1][0]
        _require(k_next % n_i == 0,
                 f"chain link {i + 1}: K={k_next} does not regroup "
                 f"[rows, {n_i}] (not a multiple)")
        g = k_next // n_i
        _require(rows[-1] % g == 0,
                 f"chain link {i + 1}: rows {rows[-1]} not divisible by "
                 f"regroup factor {g}")
        regroups.append(g)
        rows.append(rows[-1] // g)
    return tuple(rows), tuple(regroups)


def chain_smem_bytes(m0: int, shapes, band_rows: int) -> int:
    """Shared memory one chain block uses: every weight resident as f32,
    plus the f32 intermediates of a band of ``band_rows`` final rows (one
    buffer for two links, two ping-pong buffers beyond).  Mirrors the
    offsets ``launch_chain`` computes in the CUDA source."""
    shapes = tuple(shapes)
    rows, _ = chain_plan(m0, shapes)
    mults = [r // rows[-1] for r in rows]
    max_mid = max(mults[i] * shapes[i][1] for i in range(len(shapes) - 1))
    nbuf = 1 if len(shapes) == 2 else 2
    weights = sum(k * n for k, n in shapes)
    return 4 * (weights + nbuf * band_rows * max_mid)


def chain_band_rows(m0: int, shapes) -> int:
    """Final rows per chain block: a power of two, small enough that the
    grid gives every SM a block where the chain has that many rows, and
    never more than :data:`CHAIN_SMEM_BUDGET_BYTES` allows.  Raises
    :class:`ChainLoweringError` when not even one row fits."""
    shapes = tuple(shapes)
    _require(len(shapes) <= MAX_CHAIN_LINKS,
             f"chain of {len(shapes)} links exceeds {MAX_CHAIN_LINKS}")
    rows, _ = chain_plan(m0, shapes)
    need = chain_smem_bytes(m0, shapes, 1)
    _require(need <= CHAIN_SMEM_BUDGET_BYTES,
             f"chain operands exceed the shared-memory budget: {need} > "
             f"{CHAIN_SMEM_BUDGET_BYTES} bytes")
    band = 1
    while (band * 2 <= MAX_BAND_ROWS
           and rows[-1] // (band * 2) >= _NUM_SMS
           and chain_smem_bytes(m0, shapes, band * 2)
           <= CHAIN_SMEM_BUDGET_BYTES):
        band *= 2
    return band


class ChainConfig(NamedTuple):
    """How a chain launch runs (:func:`chain_config`).  For ``"simt"``
    the warp and stage fields are the whole of K0 (each thread walks it
    serially) and ``copy_bytes`` the f32 element."""
    kernel: str        #: ``"tensor_cores"`` or ``"simt"``
    band: int          #: final rows per block
    warps: int
    warp_k: int        #: elements of K0 each warp takes of a ring stage
    stage_k: int       #: elements of K0 one ring stage holds
    stages: int        #: ring stages one pass of link 0 walks
    copy_bytes: int    #: bytes per X copy: 16, 8, 4 (cp.async), 2 or 1
    smem_bytes: int


def chain_kernel_for(x: torch.Tensor) -> str:
    """Which chain kernel a launch on X runs: ``"tensor_cores"``
    (``chain_tc_kernel``) for bf16, fp8 and int8, ``"simt"``
    (``chain_kernel``) for f32."""
    return "simt" if x.dtype == torch.float32 else "tensor_cores"


def _chain_a_pitch(k: int) -> int:
    """Row pitch in bytes of an interior link's bf16 A operand: K padded
    to whole k16 steps, an odd number of 16-byte units."""
    return _gemm_pitch(-(-k // 16) * 32)


def _align16(b: int) -> int:
    return -(-b // 16) * 16


def _chain_ring(k0: int, itemsize: int, warp_k: int) -> tuple[int, int]:
    """(bytes of K0 a stage holds, stages a pass walks)."""
    ksteps = -(-k0 * itemsize // 32)
    stage_steps = min(CHAIN_WARPS * warp_k * itemsize // 32, ksteps)
    return 32 * stage_steps, -(-ksteps // stage_steps)


def chain_tc_smem_bytes(m0: int, shapes, itemsize: int, band: int,
                        warp_k: int) -> int:
    """Shared memory of one tensor-core chain block: every weight in X's
    type; when X is 8-bit (the scaled chain) the block's scales; the
    interior A operands in bf16; the block's Y rows (f32 in the scaled
    chain); and link 0's X ring or, after it drains, the warps' partial
    tiles.  Mirrors ``chain_tc_layout`` in the CUDA source."""
    shapes = tuple(shapes)
    rows, _ = chain_plan(m0, shapes)
    mults = [r // rows[-1] for r in rows]
    k0, scaled = shapes[0][0], itemsize == 1
    out_size = 4 if scaled else 2
    stage_bytes, stages = _chain_ring(k0, itemsize, warp_k)
    off = sum(_align16(k * n * itemsize) for k, n in shapes)
    if scaled:
        off += (_align16(band * mults[0] * 4) + 16 * (len(shapes) - 2)
                + _align16(shapes[-1][1] * 4))
    off += sum(band * m * _chain_a_pitch(k)
               for m, (k, _) in zip(mults[1:], shapes[1:]))
    off += _align16(band * shapes[-1][1] * out_size)
    rv = min(CHAIN_ROW_TILE, band * mults[0])
    ring = min(GEMM_STAGES, stages) * rv * _gemm_pitch(stage_bytes)
    part = CHAIN_WARPS * -(-rv // 16) * 16 * 8 * 4
    return off + max(ring, part)


@functools.lru_cache(maxsize=4096)   # called on every launch
def chain_config(m0: int, shapes: tuple, dtype: torch.dtype,
                 alignment: int = 16) -> ChainConfig:
    """The chain kernel and its launch for ``[m0, k0]`` through ``shapes``.

    f32 runs ``chain_kernel`` at :func:`chain_band_rows`'s band.  The
    tensor-core kernel:

    * Band: the largest power of two up to :data:`MAX_BAND_ROWS` whose
      grid still gives each of the 132 SMs a block and whose link-0 rows
      fit one pass (:data:`CHAIN_ROW_TILE`), else 1: each block's X is
      small, so the card's bytes in flight come from its many blocks.
    * Warp slice: each stage gives every warp the same number of 32-byte
      k-steps of K0 (at most :data:`CHAIN_MAX_WARP_STEPS`, fewer where
      the ring would pass :data:`CHAIN_RING_BYTES`), spread evenly over
      the fewest stages.
    * Copy width: the widest of 16, 8, 4, 2, 1 bytes dividing
      ``alignment`` (X's base address) and X's row pitch.

    Raises :class:`ChainLoweringError` where the chain does not fuse
    (:func:`chain_band_rows`) or the tensor-core kernel's shared memory
    cannot hold it; the CUDA side refuses what breaks these rules."""
    shapes = tuple(tuple(s) for s in shapes)
    simt_band = chain_band_rows(m0, shapes)
    rows, _ = chain_plan(m0, shapes)
    mults = [r // rows[-1] for r in rows]
    if dtype == torch.float32:
        widest = max(simt_band * m * n for m, (_, n) in zip(mults, shapes))
        threads = min(_THREADS, max(32, -(-widest // 32) * 32))
        return ChainConfig("simt", simt_band, threads // 32, shapes[0][0],
                           shapes[0][0], 1, 4,
                           chain_smem_bytes(m0, shapes, simt_band))
    size = dtype.itemsize
    ksteps = -(-shapes[0][0] * size // 32)

    def warp_steps(band):
        rv = min(CHAIN_ROW_TILE, band * mults[0])
        cap = CHAIN_MAX_WARP_STEPS
        while cap > 1 and min(GEMM_STAGES, -(-ksteps // (CHAIN_WARPS * cap))
                              ) * rv * _gemm_pitch(
                                  32 * CHAIN_WARPS * cap) > CHAIN_RING_BYTES:
            cap -= 1
        stages = -(-ksteps // (CHAIN_WARPS * cap))
        return -(-ksteps // (CHAIN_WARPS * stages))

    def smem(band):
        return chain_tc_smem_bytes(m0, shapes, size, band,
                                   warp_steps(band) * 32 // size)

    band = 1
    while (band * 2 <= MAX_BAND_ROWS
           and -(-rows[-1] // (band * 2)) >= _NUM_SMS
           and band * 2 * mults[0] <= CHAIN_ROW_TILE
           and smem(band * 2) <= CHAIN_SMEM_BUDGET_BYTES):
        band *= 2
    _require(smem(band) <= CHAIN_SMEM_BUDGET_BYTES,
             f"chain exceeds the tensor-core kernel's shared memory: "
             f"{smem(band)} > {CHAIN_SMEM_BUDGET_BYTES} bytes")
    warp_k = warp_steps(band) * 32 // size
    stage_bytes, stages = _chain_ring(shapes[0][0], size, warp_k)
    copy = 16
    while copy > 1 and (alignment % copy or shapes[0][0] * size % copy):
        copy //= 2
    return ChainConfig("tensor_cores", band, CHAIN_WARPS, warp_k,
                       stage_bytes // size, stages, copy, smem(band))


def chain_config_for(x: torch.Tensor, weights) -> ChainConfig:
    """:func:`chain_config` for these operands (their shapes, dtype and
    X's base address): what :func:`chain_n_cuda` launches with; for
    batched (3-D) operands, one expert's."""
    shapes = tuple(tuple(w.shape[-2:]) for w in weights)
    return chain_config(x.shape[-2], shapes, x.dtype, _alignment(x))


class GemmConfig(NamedTuple):
    """How the GEMM kernel runs one call (:func:`gemm_config`)."""
    tile: int          #: index into :data:`GEMM_TILES`
    bm: int
    bn: int
    splits: int        #: K slices, one block each per output tile
    k_slice: int       #: elements of K a slice holds (whole stages)
    copy_bytes: int    #: bytes per copy: 16, 8, 4 (cp.async), 2 or 1
    tensor_cores: bool
    smem_bytes: int


def _gemm_pitch(row_bytes: int) -> int:
    """Shared-memory row pitch: an odd number of 16-byte units."""
    return 16 * (-(-row_bytes // 16) | 1)


def gemm_smem_bytes(itemsize: int, transpose_rhs: bool, tile: int) -> int:
    """Dynamic shared memory of one GEMM block: the ring's stages of the
    X tile ``[BM, stage]`` and the W tile (``[BN, stage]`` for ``[N, K]``,
    ``[stage / itemsize, BN]`` for ``[K, N]``).  Mirrors
    ``gemm_smem_bytes`` in the CUDA source."""
    bm, bn = GEMM_TILES[tile]
    x = bm * _gemm_pitch(GEMM_STAGE_BYTES)
    w = (bn * _gemm_pitch(GEMM_STAGE_BYTES) if transpose_rhs
         else GEMM_STAGE_BYTES // itemsize * _gemm_pitch(bn * itemsize))
    return GEMM_STAGES * (x + w)


@functools.lru_cache(maxsize=4096)   # called on every launch
def gemm_config(m: int, n: int, k: int, dtype: torch.dtype,
                transpose_rhs: bool, alignment: int = 16) -> GemmConfig:
    """The GEMM's tile, K split and copy width for ``[m, k] @ W``.

    * Splits: where the tiles do not cover the 132 SMs, K is cut into
      slices of whole stages (64 bytes of K each) so the blocks come to
      at most ``2 * 132``, each slice walking at least
      :data:`GEMM_MIN_SPLIT_STEPS` stages, and no slice is empty.
    * Tile: 128x8 for ``n <= 8``, 128x16 for ``n <= 16``, else 128x64
      where ``m > 64`` and its blocks, split, cover the SMs, and 64x64
      otherwise (twice the blocks for a short K or a small output).
    * Copy width: the widest of 16, 8, 4, 2, 1 bytes that divides
      ``alignment`` (the operands' base addresses), both operands' row
      pitches and, for a ``[K, N]`` W, its tile's row.

    The CUDA side refuses (``cudaErrorInvalidValue``) what breaks these
    rules; :func:`matmul_cuda` then raises."""
    size = dtype.itemsize

    steps = -(-k // (GEMM_STAGE_BYTES // size))

    def tiles(t):
        bm, bn = GEMM_TILES[t]
        return -(-m // bm) * -(-n // bn)

    def splits_for(t):
        if tiles(t) >= _NUM_SMS:
            return 1
        return max(1, min(2 * _NUM_SMS // tiles(t),
                          steps // GEMM_MIN_SPLIT_STEPS))

    if n <= 8:
        tile = 3
    elif n <= 16:
        tile = 2
    elif m > 64 and tiles(0) * splits_for(0) >= _NUM_SMS:
        tile = 0
    else:
        tile = 1
    bm, bn = GEMM_TILES[tile]
    splits = splits_for(tile)
    per = -(-steps // splits) if steps else 1
    if steps:
        splits = -(-steps // per)
    pitches = [k * size] if transpose_rhs else [k * size, n * size]
    copy = 16
    while copy > 1 and (alignment % copy or any(p % copy for p in pitches)
                        or (not transpose_rhs and copy > bn * size)):
        copy //= 2
    return GemmConfig(tile=tile, bm=bm, bn=bn, splits=splits,
                      k_slice=per * GEMM_STAGE_BYTES // size,
                      copy_bytes=copy, tensor_cores=dtype != torch.float32,
                      smem_bytes=gemm_smem_bytes(size, transpose_rhs, tile))


def _alignment(*tensors: torch.Tensor) -> int:
    """The largest power of two up to 16 dividing every base address and,
    for a batched (3-D or 4-D) operand, the bytes between its batch
    entries along each batch axis."""
    a = 16
    for t in tensors:
        while t.data_ptr() % a or any(
                t.stride(d) * t.element_size() % a
                for d in range(t.dim() - 2)):
            a //= 2
    return a


def _batch_strides(t: torch.Tensor) -> tuple[int, int]:
    """(outer, inner) element strides of a batched operand's batch axes:
    ``[B, ...]`` gives ``(stride 0, 0)``, ``[E, G, ...]`` its two
    strides (0 on G for an expert's operand broadcast over its
    groups)."""
    if t.dim() == 4:
        return t.stride(0), t.stride(1)
    return (t.stride(0), 0) if t.dim() == 3 else (0, 0)


def _scale_strides(t: torch.Tensor) -> tuple[int, int]:
    """(outer, inner) element strides of a per-instance scale ``[B]`` or
    ``[E, G]``."""
    if t.dim() == 1:
        return t.stride(0), 0
    return t.stride(0), t.stride(1)


def gemm_config_for(x: torch.Tensor, w: torch.Tensor,
                    transpose_rhs: bool = False) -> GemmConfig:
    """:func:`gemm_config` for these operands (their shapes, dtype and
    base addresses): what :func:`matmul_cuda` launches with.  Batched
    (3-D) operands get one expert's configuration: the launch runs it
    for every expert."""
    m, k = x.shape[-2:]
    n = w.shape[-2] if transpose_rhs else w.shape[-1]
    return gemm_config(m, n, k, x.dtype, transpose_rhs,
                       _alignment(x, w))


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import build
    lib = build.load("fused_contraction")
    if not getattr(lib, "_typed", False):
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fc_matmul.argtypes = [ci, ci, vp, vp, vp, vp, ci, cll, cll, ci,
                                  ci, ci, ci, ci, ci, vp]
        lib.fc_matmul.restype = ci
        lib.fc_chain.argtypes = [ci, vp, ctypes.POINTER(vp),
                                 ctypes.POINTER(ci), ctypes.POINTER(ci),
                                 ctypes.POINTER(ci), ci, ci, ci, ci, vp, ci,
                                 cll, ctypes.POINTER(cll), cll, vp]
        lib.fc_chain.restype = ci
        lib.fc_matmul_scaled.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, ci,
                                         ci, cll, cll, cll, cll, cll, cll,
                                         cll, cll, ci, ci, ci, ci, ci, ci,
                                         ci, vp]
        lib.fc_matmul_scaled.restype = ci
        lib.fc_gemm_smem_bytes.argtypes = [ci, ci, ci]
        lib.fc_gemm_smem_bytes.restype = ci
        lib.fc_gemm_k_slice.argtypes = [ci, ci, ci, ci, ci, vp, vp, ci, ci,
                                        ci]
        lib.fc_gemm_k_slice.restype = ci
        lib.fc_chain_tc.argtypes = [ci, vp, ctypes.POINTER(vp),
                                    ctypes.POINTER(vp), ctypes.POINTER(ci),
                                    ctypes.POINTER(ci), ctypes.POINTER(ci),
                                    ci, ci, ci, ci, ci, vp, ci, cll,
                                    ctypes.POINTER(cll), cll, ci, cll,
                                    ctypes.POINTER(cll), ci,
                                    ctypes.POINTER(cll),
                                    ctypes.POINTER(cll), vp]
        lib.fc_chain_tc.restype = ci
        lib.fc_chain_tc_smem_bytes.argtypes = [
            ci, ctypes.POINTER(ci), ctypes.POINTER(ci), ctypes.POINTER(ci),
            ci, ci, ci]
        lib.fc_chain_tc_smem_bytes.restype = ctypes.c_longlong
        lib.fc_max_links.restype = ci
        lib.fc_error_string.argtypes = [ci]
        lib.fc_error_string.restype = ctypes.c_char_p
        if lib.fc_max_links() != MAX_CHAIN_LINKS:
            raise RuntimeError("fused_contraction.cu disagrees on the "
                               "chain link limit")
        lib._typed = True
    return lib


def _check_rc(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.fc_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _check_cuda_operands(op: str, tensors, out_dtype, scales=(),
                         instances: bool = False) -> None:
    """Device, dtype and contiguity checks before a launch.  Plain
    kernels take f32/bf16 operands and write their type; the scaled ones
    take fp8/int8 operands with f32 scales and write f32.  ``instances``
    (the instance batch): each operand's matrices must be contiguous,
    its batch axes and the per-instance scales may take any strides."""
    dev = tensors[0].device
    dtype = tensors[0].dtype
    for t in (*tensors, *scales):
        if t.device != dev:
            raise ValueError(f"{op}: operands on {t.device} and {dev}")
    for t in (tensors if instances else (*tensors, *scales)):
        mat = t[(0,) * (t.dim() - 2)] if instances else t
        if not mat.is_contiguous():
            raise ValueError(f"{op}: operands must be contiguous")
    for t in tensors:
        if t.dtype != dtype:
            raise ValueError(f"{op}: operand dtypes {t.dtype} and {dtype}")
    if scales:
        if dtype not in _QUANT_CODES:
            raise ValueError(f"{op}: dtype {dtype} not supported "
                             "(float8_e4m3fn, float8_e5m2, int8)")
        if any(s.dtype != torch.float32 for s in scales):
            raise ValueError(f"{op}: scales must be float32")
        if out_dtype not in (None, torch.float32):
            raise ValueError(f"{op}: the kernel writes float32, not "
                             f"{out_dtype}")
        return
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"{op}: dtype {dtype} not supported (float32, "
                         "bfloat16)")
    if out_dtype not in (None, dtype):
        raise ValueError(f"{op}: the kernel writes {dtype}, not {out_dtype}")


def _check_gemm_scales(scales, m: int, n: int, k: int, lead=()):
    sl, sr = scales
    want = ((tuple(lead), tuple(lead)) if lead
            else ((m, 1), (1, n)))
    _require((tuple(sl.shape), tuple(sr.shape)) == want,
             f"bad GEMM scale shapes {tuple(sl.shape)}/{tuple(sr.shape)} "
             f"for [{m}x{k}] @ [{k}x{n}]"
             + (f" over instances {tuple(lead)}" if lead else ""))
    return sl, sr


def _check_chain_scales(scales, n_w: int, m0: int, n: int,
                        lead=()) -> tuple:
    scales = tuple(scales)
    _require(len(scales) == n_w,
             f"expected {n_w} chain scales, got {len(scales)}")
    if lead:
        for j, s_ in enumerate(scales):
            _require(tuple(s_.shape) == tuple(lead),
                     f"chain scale {j} must be one per instance "
                     f"{tuple(lead)}, got {tuple(s_.shape)}")
        return scales
    s_first, *mid, s_last = scales
    _require(tuple(s_first.shape) == (m0, 1),
             f"chain lhs scale must be [{m0}, 1], got "
             f"{tuple(s_first.shape)}")
    _require(tuple(s_last.shape) == (1, n),
             f"chain out scale must be [1, {n}], got {tuple(s_last.shape)}")
    for j, s_ in enumerate(mid):
        _require(tuple(s_.shape) == (1, 1),
                 f"chain interior scale {j + 1} must be [1, 1], got "
                 f"{tuple(s_.shape)}")
    return scales


def matmul_cuda(x: torch.Tensor, w: torch.Tensor, *,
                transpose_rhs: bool = False, out_dtype=None,
                scales=None, launch_key: str = "matmul") -> torch.Tensor:
    """``C[M, N] = X[M, K] @ W`` with W stored ``[K, N]`` or, with
    ``transpose_rhs``, ``[N, K]``; f32 accumulation, output in X's dtype.

    Batched: ``X[E, M, K]`` and ``W[E, K, N]`` (or ``[E, N, K]``) give
    ``C[E, M, N]``, every entry in one launch (the expert axis of the
    reference's vmapped ``matmul_pallas``), each with one entry's
    :func:`gemm_config`; counted under ``matmul_batched``.

    ``scales=(sl, sr)`` runs the scaled kernel: ``x``/``w`` hold
    fp8/int8 values, ``sl`` is the lhs scale per row (``[M, 1]`` f32),
    ``sr`` the rhs scale per column (``[1, N]`` f32), and the f32 output
    is ``(Xq @ Wq) * sl * sr``.  Batched (the instances of a MoE's
    quantized experts): ``X[*I, M, K]`` and ``W`` alike, ``I`` one batch
    axis or two (``[E, G]``; an expert's W broadcast over its groups,
    stride 0, is read without copies), and ``sl``, ``sr`` one scalar per
    instance (shape ``I``, any strides); ``C[*I, M, N]``, one launch,
    counted under ``matmul_scaled_batched``.

    ``launch_key`` names the :data:`LAUNCHES` entry a plain 2-D launch
    counts under (``matmul``, or ``matmul_bwd`` for an autograd
    backward's)."""
    if launch_key not in ("matmul", "matmul_bwd"):
        raise ValueError(f"matmul_cuda: unknown launch key {launch_key!r}")
    batched = x.dim() >= 3
    _require(x.dim() == w.dim() and x.dim() in (2, 3, 4),
             f"GEMM operands must be 2-D or both 3-D / 4-D, got "
             f"{tuple(x.shape)} and {tuple(w.shape)}")
    _require(x.shape[:-2] == w.shape[:-2],
             f"GEMM batch mismatch {tuple(x.shape[:-2])} vs "
             f"{tuple(w.shape[:-2])}")
    _require(x.dim() < 4 or scales is not None,
             "two batch axes take the scaled GEMM")
    lead = tuple(x.shape[:-2])
    m, k = x.shape[-2:]
    n, k2 = (w.shape[-2:] if transpose_rhs
             else (w.shape[-1], w.shape[-2]))
    _require(k == k2, f"contraction mismatch {k} vs {k2}")
    if scales is not None:
        scales = _check_gemm_scales(scales, m, n, k, lead)
    on_cpu = all(t.device.type == "cpu" for t in (x, w, *(scales or ())))
    if on_cpu and scales is None:
        return ref.matmul(x, w, transpose_rhs=transpose_rhs,
                          out_dtype=out_dtype)
    if on_cpu:
        if out_dtype not in (None, torch.float32):
            raise ValueError("matmul_cuda: the scaled GEMM writes float32")
        return ref.matmul_scaled(x, w, *scales, transpose_rhs=transpose_rhs)
    if x.device.type != "cuda":
        raise ValueError(f"matmul_cuda: no kernel for device {x.device}")
    instances = batched and scales is not None
    _check_cuda_operands("matmul_cuda", (x, w), out_dtype, scales or (),
                         instances=instances)
    batch = 1
    for d in lead:
        batch *= d
    out = torch.empty(lead + (m, n), device=x.device,
                      dtype=x.dtype if scales is None else torch.float32)
    if m == 0 or n == 0 or batch == 0:
        return out
    cfg = gemm_config_for(x, w, transpose_rhs)
    # split-K's partials [batch, splits, M, N], on the caller's stream (no
    # buffer outlives the call, so a CUDA graph can capture it)
    part = (torch.empty((batch * cfg.splits, m, n), device=x.device,
                        dtype=torch.float32) if cfg.splits > 1 else None)
    geo = (m, n, k, cfg.tile, cfg.splits, cfg.copy_bytes, _stream())
    lib = _lib()
    if scales is None:
        strides = ((batch, x.stride(0), w.stride(0)) if batched
                   else (1, 0, 0))
        rc = lib.fc_matmul(_DTYPE_CODES[x.dtype], int(transpose_rhs),
                           x.data_ptr(), w.data_ptr(), out.data_ptr(),
                           _ptr(part), *strides, *geo)
        key = "matmul_batched" if batched else launch_key
    else:
        if instances:
            inner = x.shape[1] if x.dim() == 4 else 1
            bstr = (batch, inner, *_batch_strides(x), *_batch_strides(w),
                    *_scale_strides(scales[0]), *_scale_strides(scales[1]),
                    0)
        else:
            bstr = (1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 1)
        rc = lib.fc_matmul_scaled(_QUANT_CODES[x.dtype], int(transpose_rhs),
                                  x.data_ptr(), w.data_ptr(),
                                  scales[0].data_ptr(), scales[1].data_ptr(),
                                  out.data_ptr(), _ptr(part), *bstr, *geo)
        key = "matmul_scaled_batched" if instances else "matmul_scaled"
    _check_rc(lib, rc, "matmul_cuda")
    LAUNCHES[key] += 1
    if part is not None:
        LAUNCHES[key + "_reduce"] += 1
    return out


def chain_n_cuda(x: torch.Tensor, weights, *, out_dtype=None,
                 scales=None) -> torch.Tensor:
    """N-link contraction chain with every intermediate in shared memory.

    ``weights`` is a sequence of >= 2 matrices ``W_i[k_i, n_i]`` with
    ``k_1 == x.shape[1]``; link ``i+1`` reads link ``i``'s result
    regrouped row-major (:func:`chain_plan`).  The output is
    ``[m0 / prod(g), n_last]`` in X's dtype.

    Batched: ``x[E, m0, k_1]`` and ``W_i[E, k_i, n_i]`` run one chain per
    entry in one launch (the expert axis of the reference's vmapped
    ``chain_n_pallas``), with one entry's :func:`chain_config`; the
    output is ``[E, m_final, n_last]``, counted under
    ``chain_n_batched``.

    ``scales`` runs the quantized chain: operands hold fp8/int8 values
    and ``scales`` is ``(s_first [m0, 1], c_2 [1, 1], ..., s_last [1,
    n_last])``: the lhs row scales times W1's scale, each interior
    weight's scale, W_n's scale per output column.  Each link multiplies
    its f32 sum by its factor; intermediates are rounded to bf16; the
    output is f32.  Batched (the quantized experts' instances):
    ``x[*I, m0, k_1]``, ``W_i[*I, k_i, n_i]`` (an expert's broadcast over
    its groups with stride 0) and every factor one scalar per instance
    (shape ``I``), counted under ``chain_n_scaled_batched``.
    """
    weights = tuple(weights)
    _require(len(weights) >= 2,
             f"chain needs >= 2 weights, got {len(weights)}")
    _require(x.dim() in (2, 3, 4),
             f"chain lhs must be 2-D, 3-D or 4-D, got {tuple(x.shape)}")
    batched = x.dim() >= 3
    for i, w in enumerate(weights):
        _require(w.dim() == x.dim() and w.shape[:-2] == x.shape[:-2],
                 f"chain weight {i} of shape {tuple(w.shape)} does not "
                 f"match the lhs {tuple(x.shape)}")
    _require(x.dim() < 4 or scales is not None,
             "two batch axes take the scaled chain")
    lead = tuple(x.shape[:-2])
    instances = batched and scales is not None
    m0 = x.shape[-2]
    shapes = tuple(tuple(w.shape[-2:]) for w in weights)
    _require(shapes[0][0] == x.shape[-1],
             f"chain link 0: contraction mismatch {shapes[0][0]} vs "
             f"{x.shape[-1]}")
    rows, _ = chain_plan(m0, shapes)
    cfg = chain_config_for(x, weights)
    m_final, n_last = rows[-1], shapes[-1][1]
    if scales is not None:
        scales = _check_chain_scales(scales, len(weights), m0, n_last,
                                     lead)
    if all(t.device.type == "cpu" for t in (x, *weights, *(scales or ()))):
        if scales is None:
            return ref.chain_n(x, weights, out_dtype=out_dtype)
        if out_dtype not in (None, torch.float32):
            raise ValueError("chain_n_cuda: the scaled chain writes float32")
        return ref.chain_n_scaled(x, weights, scales)
    if x.device.type != "cuda":
        raise ValueError(f"chain_n_cuda: no kernel for device {x.device}")
    _check_cuda_operands("chain_n_cuda", (x, *weights), out_dtype,
                         scales or (), instances=instances)
    batch = 1
    for d in lead:
        batch *= d
    out = torch.empty(lead + (m_final, n_last), device=x.device,
                      dtype=x.dtype if scales is None else torch.float32)
    if m_final == 0 or batch == 0:
        return out
    links = len(weights)
    geo = ((ctypes.c_void_p * links)(*(w.data_ptr() for w in weights)),
           (ctypes.c_int * links)(*(k for k, _ in shapes)),
           (ctypes.c_int * links)(*(n for _, n in shapes)),
           (ctypes.c_int * links)(*(r // m_final for r in rows)))
    w_str = [_batch_strides(w) for w in weights]
    strides = (batch, _batch_strides(x)[0],
               (ctypes.c_longlong * links)(*(o for o, _ in w_str)),
               m_final * n_last if batched else 0)
    s_str = [_scale_strides(s_) if instances else (0, 0)
             for s_ in (scales or ())] or [(0, 0)] * links
    inner = (x.shape[1] if x.dim() == 4 else 1,
             _batch_strides(x)[1],
             (ctypes.c_longlong * links)(*(i for _, i in w_str)),
             int(instances),
             (ctypes.c_longlong * links)(*(o for o, _ in s_str)),
             (ctypes.c_longlong * links)(*(i for _, i in s_str)))
    lib = _lib()
    if cfg.kernel == "simt":
        rc = lib.fc_chain(_DTYPE_CODES[x.dtype], x.data_ptr(), *geo, links,
                          m_final, cfg.band, cfg.warps * 32, out.data_ptr(),
                          *strides, _stream())
    else:
        code = (_DTYPE_CODES if scales is None else _QUANT_CODES)[x.dtype]
        sptrs = (None if scales is None else (ctypes.c_void_p * links)(
            *(s_.data_ptr() for s_ in scales)))
        rc = lib.fc_chain_tc(code, x.data_ptr(), geo[0], sptrs, *geo[1:],
                             links, m_final, cfg.band, cfg.warp_k,
                             cfg.copy_bytes, out.data_ptr(), *strides,
                             *inner, _stream())
    key = ("chain_n_scaled_batched" if instances
           else "chain_n_batched" if batched
           else "chain_n" if scales is None else "chain_n_scaled")
    _check_rc(lib, rc, "chain_n_cuda")
    LAUNCHES[key] += 1
    return out
