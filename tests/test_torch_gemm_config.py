"""The GEMM kernel's configuration rule (``fused_contraction.gemm_config``)
and the profiler's grouping of the GEMM's kernel names.

``gemm_config`` picks the tile, the K split and the copy width that
``matmul_cuda`` launches with and that the CUDA source checks; it is
plain Python, so these run on the CPU, at every GEMM geometry of the
port's main paths (``chip_smoke.py``'s enumeration of the serve, ATIS
train, fp8 train and rwkv6 train plans).  ``tests/test_torch_cuda.py``
holds the kernel's own check of the same rule on the card.
"""

import os
import re
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.train_profile import _group  # noqa: E402
from repro_torch.kernels import fused_contraction as fc  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMS = 132
SMEM_LIMIT = 232_448
FP8 = torch.float8_e4m3fn


def _tiles(m, n, cfg):
    return -(-m // cfg.bm) * -(-n // cfg.bn)


@pytest.fixture(scope="module")
def path_geometries():
    """``{path: [(m, n, k, transpose_rhs), ...]}`` of the main paths."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(ROOT)
    from repro_torch.configs import base as cfgbase
    from repro_torch.core import plan_compiler, tensorized
    from repro_torch.precision import QuantPolicy
    from repro_torch.serving import profiles

    atis = cfgbase.get(cs.ARCH).model()
    rwkv_arch = cfgbase.get(cs.RWKV_ARCH)
    rwkv = rwkv_arch.model(rwkv_arch.tnn_default)
    serve, _ = cs.main_path_geometries(atis, plan_compiler, profiles,
                                       tensorized)
    train = cs.train_path_geometries(atis, plan_compiler, profiles,
                                     tensorized)[0]
    fp8 = cs.fp8_train_geometries(atis, plan_compiler, profiles, tensorized,
                                  QuantPolicy)[0]["gemm"]
    r = cs.train_path_geometries(rwkv, plan_compiler, profiles,
                                 tensorized)[0]
    return {"serve": sorted(serve), "train": sorted(train),
            "train_fp8": sorted(fp8), "train_rwkv6": sorted(r)}


@pytest.mark.parametrize("path,dtype", [
    ("serve", torch.bfloat16), ("serve", torch.float32),
    ("train", torch.bfloat16), ("train", torch.float32),
    ("train_fp8", FP8), ("train_fp8", torch.int8),
    ("train_rwkv6", torch.bfloat16), ("train_rwkv6", torch.float32)])
def test_gemm_config_splits_k_where_the_tiles_cannot_fill_the_card(
        path_geometries, path, dtype):
    """K is split wherever the output tiles leave SMs idle and K is long;
    never into more than two blocks per SM, never into an empty slice,
    each slice whole k-steps (16 elements in bf16, 32 in fp8/int8)."""
    geos = path_geometries[path]
    assert geos
    step = {torch.bfloat16: 16, torch.float32: 16}.get(dtype, 32)
    split_somewhere = False
    for m, n, k, trans in geos:
        cfg = fc.gemm_config(m, n, k, dtype, trans)
        tiles = _tiles(m, n, cfg)
        what = (path, m, n, k, trans, cfg)
        assert (cfg.bm, cfg.bn) == fc.GEMM_TILES[cfg.tile], what
        if tiles < SMS and k >= 1024:
            assert cfg.splits > 1, what
        assert tiles * cfg.splits <= 2 * SMS or cfg.splits == 1, what
        assert cfg.k_slice % step == 0, what
        assert cfg.k_slice * dtype.itemsize % fc.GEMM_STAGE_BYTES == 0, what
        assert cfg.splits * cfg.k_slice >= k > (cfg.splits - 1) * cfg.k_slice
        assert cfg.smem_bytes <= SMEM_LIMIT, what
        assert cfg.tensor_cores == (dtype != torch.float32), what
        split_somewhere |= cfg.splits > 1
    assert split_somewhere or path == "serve"


def test_gemm_config_picks_the_narrow_tiles_for_narrow_outputs():
    for n, tile in ((8, (128, 8)), (5, (128, 8)), (12, (128, 16)),
                    (16, (128, 16))):
        cfg = fc.gemm_config(768, n, 3072, torch.bfloat16, True)
        assert (cfg.bm, cfg.bn) == tile
    # a large output gets 128x64 tiles in every operand type
    for dtype in (torch.bfloat16, torch.float32, FP8, torch.int8):
        assert fc.gemm_config(1024, 3072, 8, dtype, True).bm == 128
    # too few 128x64 tiles to cover the SMs: split K across them ...
    cfg = fc.gemm_config(1024, 64, 14336, torch.bfloat16, False)
    assert (cfg.bm, cfg.bn, cfg.splits) == (128, 64, 32)
    # ... unless even split they leave most SMs idle: 64x64, then split
    cfg = fc.gemm_config(112, 64, 8192, torch.bfloat16, False)
    assert (cfg.bm, cfg.bn, cfg.splits) == (64, 64, 64)
    # and 64x64 for a short output (m <= 64)
    assert fc.gemm_config(64, 1024, 14336, torch.bfloat16, True).bm == 64


@pytest.mark.parametrize("m,n,k,dtype,trans,alignment,copy", [
    (64, 8, 12, torch.bfloat16, False, 16, 8),   # X rows of 24 bytes
    (64, 8, 12, FP8, False, 16, 4),              # X rows of 12 bytes
    (128, 12, 8, torch.bfloat16, False, 16, 8),  # W [K, N] rows of 24 bytes
    (128, 12, 8, torch.int8, False, 16, 4),
    (128, 8, 8, FP8, False, 16, 8),              # W tile rows of 8 bytes
    (128, 8, 8, FP8, True, 16, 8),               # X rows of 8 bytes
    (768, 8, 3072, torch.bfloat16, True, 16, 16),
    (768, 8, 3072, torch.bfloat16, True, 2, 2),  # a view one element in
    (768, 8, 3072, FP8, True, 1, 1),
    (12, 64, 1, torch.bfloat16, False, 16, 2),   # K = 1: rows of 2 bytes
    (12, 64, 1, torch.float32, False, 16, 4),
])
def test_gemm_config_narrows_the_copy_for_misaligned_operands(
        m, n, k, dtype, trans, alignment, copy):
    cfg = fc.gemm_config(m, n, k, dtype, trans, alignment)
    assert cfg.copy_bytes == copy


def test_gemm_config_for_reads_the_base_address():
    base = torch.zeros(8 * 12 + 12, dtype=torch.bfloat16)
    w = torch.zeros(8, 12, dtype=torch.bfloat16)
    aligned = base[:96].view(8, 12)
    row_in = base[12:].view(8, 12)      # 24 bytes in: 8-byte aligned
    elem_in = base[1:97].view(8, 12)    # 2 bytes in
    assert fc.gemm_config_for(aligned, w, True).copy_bytes == 8
    assert row_in.data_ptr() % 8 == 0
    assert fc.gemm_config_for(row_in, w, True).copy_bytes == 8
    assert fc.gemm_config_for(elem_in, w, True).copy_bytes == 2
    x = torch.zeros(8, 64, dtype=torch.bfloat16)
    w = torch.zeros(64, 64, dtype=torch.bfloat16)
    assert fc.gemm_config_for(x, w).copy_bytes == 16
    # a row-offset view of W whose rows keep 16-byte alignment
    assert fc.gemm_config_for(x[:, 8:].contiguous(), w[8:]).copy_bytes == 16


@pytest.mark.parametrize("itemsize", [1, 2, 4])
@pytest.mark.parametrize("trans", [False, True])
def test_gemm_smem_footprint_fits_one_block(itemsize, trans):
    for tile, (bm, bn) in enumerate(fc.GEMM_TILES):
        got = fc.gemm_smem_bytes(itemsize, trans, tile)
        bk = fc.GEMM_STAGE_BYTES // itemsize
        w_rows, w_bytes = (bn, fc.GEMM_STAGE_BYTES) if trans else (
            bk, bn * itemsize)
        # rows padded to an odd number of 16-byte units
        pitch = [16 * (-(-b // 16) | 1) for b in (fc.GEMM_STAGE_BYTES,
                                                   w_bytes)]
        assert got == fc.GEMM_STAGES * (bm * pitch[0] + w_rows * pitch[1])
        assert all((p // 16) % 2 == 1 for p in pitch)
        assert got <= SMEM_LIMIT


#: operand types each GEMM-side kernel is instantiated with, as the
#: profiler prints them, and the group each must land in
KERNEL_GROUPS = {
    "gemm_tc_kernel": [("__nv_bfloat16, __nv_bfloat16, true, 64, 64, 2, 2",
                        "matmul"),
                       ("__nv_fp8_e4m3, float, false, 128, 8, 4, 1",
                        "matmul_scaled"),
                       ("__nv_fp8_e5m2, float, true, 64, 64, 2, 2",
                        "matmul_scaled"),
                       ("signed char, float, false, 128, 16, 4, 1",
                        "matmul_scaled")],
    "gemm_simt_kernel": [("true, 128, 64", "matmul"),
                         ("false, 128, 8", "matmul")],
    "gemm_splitk_reduce": [("float, float", "matmul"),
                           ("__nv_bfloat16, __nv_bfloat16", "matmul"),
                           ("__nv_fp8_e4m3, float", "matmul_scaled"),
                           ("__nv_fp8_e5m2, float", "matmul_scaled"),
                           ("signed char, float", "matmul_scaled")],
    "chain_kernel": [(None, "chain_n")],   # f32 only: no template
    "chain_tc_kernel": [("__nv_bfloat16, __nv_bfloat16, false", "chain_n"),
                        ("__nv_fp8_e4m3, float, true", "chain_n_scaled"),
                        ("__nv_fp8_e5m2, float, true", "chain_n_scaled"),
                        ("signed char, float, true", "chain_n_scaled")],
}


def test_every_contraction_kernel_groups_under_its_port_group():
    """Each ``__global__`` kernel of ``csrc/fused_contraction.cu``, named
    as the profiler shows it with each operand type it is instantiated
    with, is counted under its port group by ``train_profile``, never
    under PyTorch's ``torch_gemm`` or ``torch``."""
    src = open(os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                            "fused_contraction.cu")).read()
    names = set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
        src))
    assert names == set(KERNEL_GROUPS)
    for name, cases in KERNEL_GROUPS.items():
        for args, group in cases:
            shown = (f"void (anonymous namespace)::{name}<{args}>(int, int)"
                     if args else
                     f"void (anonymous namespace)::{name}(int, int)")
            assert _group(shown) == group, shown
    assert _group("sm90_xmma_gemm_bf16bf16_bf16f32") == "torch_gemm"


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z14gemm_tc_kernelIfEvv' for 'sm_90a'
ptxas info    : Function properties for _Z14gemm_tc_kernelIfEvv
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compile time = 56.783 ms
ptxas info    : Compiling entry function '_Z18gemm_splitk_reducev' for 'sm_90a'
ptxas info    : Function properties for _Z18gemm_splitk_reducev
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers
"""


def test_chip_smoke_reads_registers_and_spills_from_ptxas():
    """``chip_smoke.ptxas_report`` turns ``nvcc -Xptxas -v`` output (which
    the kernels' build keeps) into one record per kernel."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(ROOT)
    assert cs.ptxas_report(PTXAS_LOG) == [
        {"kernel": "_Z14gemm_tc_kernelIfEvv", "stack": 8, "spill_stores": 12,
         "spill_loads": 16, "registers": 168},
        {"kernel": "_Z18gemm_splitk_reducev", "stack": 0, "spill_stores": 0,
         "spill_loads": 0, "registers": 32}]
