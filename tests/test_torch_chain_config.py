"""The chain kernels' launch rule (``fused_contraction.chain_config``),
the plan compiler's chain admission and the profiler's grouping of the
chain kernels' names.

``chain_config`` picks the kernel (``chain_tc_kernel`` on the tensor cores
for bf16, fp8 and int8, ``chain_kernel`` for f32), the band, the warp
slice of K0 and the copy width that ``chain_n_cuda`` launches with and
that the CUDA source checks; it is plain Python, so these run on the CPU,
at every chain geometry of the port's main paths (``chip_smoke.py``'s
enumeration of the serve, ATIS train, fp8 train and rwkv6 train plans)
and at the CPU tests' geometries.  ``tests/test_torch_cuda.py`` holds the
kernel's own check of the same rule on the card.
"""

import itertools
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.train_profile import _group  # noqa: E402
from repro_torch.kernels import fused_contraction as fc  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMEM_LIMIT = 232_448
QUANT = (torch.float8_e4m3fn, torch.float8_e5m2, torch.int8)
#: chains the CPU parity tests run (tests/test_torch_kernels.py and
#: tests/test_torch_precision.py): ragged N, 3 links, n0 of 2 and 4, and
#: the WG link shapes cut in rows
CPU_CHAINS = [
    (24, ((16, 8), (8, 12))), (64, ((8, 8), (64, 8))),
    (96, ((64, 8), (96, 8))), (48, ((96, 8), (8, 16))),
    (12, ((4, 2), (4, 6), (12, 3))), (96, ((12, 4), (16, 6), (12, 5))),
    (64, ((768, 8), (64, 8))), (96, ((3072, 8), (96, 8))),
]
#: chains each path fuses today, and the candidates it refuses
FUSED = {"serve": 7, "train": 3, "train_fp8": 5, "train_rwkv6": 0}
REFUSED = {"serve": 0, "train": 0, "train_fp8": 0, "train_rwkv6": 3}
#: operand types each path's chains run in
PATH_DTYPES = {"serve": (torch.bfloat16, torch.float32),
               "train": (torch.bfloat16, torch.float32),
               "train_fp8": QUANT,
               "train_rwkv6": (torch.bfloat16, torch.float32)}


@pytest.fixture(scope="module")
def path_chains():
    """``{path: (fused chains, refused candidates)}``: every run of GEMMs
    the plan compiler asked ``_chain_fits`` about while compiling each
    main path's plans, split by its answer."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(ROOT)
    from repro_torch.configs import base as cfgbase
    from repro_torch.core import plan_compiler as pc
    from repro_torch.core import tensorized
    from repro_torch.precision import QuantPolicy
    from repro_torch.serving import profiles

    atis = cfgbase.get(cs.ARCH).model()
    rwkv_arch = cfgbase.get(cs.RWKV_ARCH)
    rwkv = rwkv_arch.model(rwkv_arch.tnn_default)
    asked = []
    fits, compiled = pc._chain_fits, pc._COMPILED

    def spy(run):
        ok = fits(run)
        asked.append(((run[0].mat.m, pc._chain_shapes(run)), ok))
        return ok

    runs = {"serve": lambda: cs.main_path_geometries(
                atis, pc, profiles, tensorized),
            "train": lambda: cs.train_path_geometries(
                atis, pc, profiles, tensorized),
            "train_fp8": lambda: cs.fp8_train_geometries(
                atis, pc, profiles, tensorized, QuantPolicy),
            "train_rwkv6": lambda: cs.train_path_geometries(
                rwkv, pc, profiles, tensorized)}
    out = {}
    pc._chain_fits = spy
    try:
        for path, run in runs.items():
            pc._COMPILED = {}         # compile afresh: every run is asked
            asked.clear()
            run()
            out[path] = (sorted({c for c, ok in asked if ok}),
                         sorted({c for c, ok in asked if not ok}))
    finally:
        pc._chain_fits, pc._COMPILED = fits, compiled
    return out


def _check_config(m0, shapes, dtype):
    """The rule's invariants for one chain in one dtype."""
    cfg = fc.chain_config(m0, shapes, dtype)
    rows, _ = fc.chain_plan(m0, shapes)
    k0 = shapes[0][0]
    what = (m0, shapes, dtype, cfg)
    assert cfg.smem_bytes <= SMEM_LIMIT, what
    assert cfg.band >= 1 and cfg.band & (cfg.band - 1) == 0, what
    if dtype == torch.float32:
        assert cfg.kernel == "simt", what
        assert cfg.band == fc.chain_band_rows(m0, shapes), what
        return cfg
    assert cfg.kernel == "tensor_cores" and cfg.warps == fc.CHAIN_WARPS, what
    size = dtype.itemsize
    step = 32 // size                           # elements of a k-step
    assert cfg.warp_k % step == 0, what
    assert 1 <= cfg.warp_k // step <= fc.CHAIN_MAX_WARP_STEPS, what
    # K0 covered: whole stages of whole k-steps, none empty
    assert cfg.stage_k % step == 0, what
    assert cfg.stages * cfg.stage_k >= k0 > (cfg.stages - 1) * cfg.stage_k
    # each k-step of a stage has exactly one warp: ls // (warp_k / step)
    owners = [ls // (cfg.warp_k // step) for ls in range(cfg.stage_k // step)]
    assert owners == sorted(owners) and max(owners) < cfg.warps, what
    # rows covered: every final row in one block, link-0 rows a pass holds
    assert -(-rows[-1] // cfg.band) * cfg.band >= rows[-1], what
    assert cfg.band == 1 or cfg.band * rows[0] // rows[-1] <= (
        fc.CHAIN_ROW_TILE), what
    assert k0 * size % cfg.copy_bytes == 0, what
    assert cfg.smem_bytes == fc.chain_tc_smem_bytes(
        m0, shapes, size, cfg.band, cfg.warp_k), what
    return cfg


@pytest.mark.parametrize("path", list(FUSED))
def test_chain_config_exists_for_every_fused_chain(path_chains, path):
    """Every chain a main path fuses has a configuration in every dtype
    the path runs it in, within one block's shared memory, its rows and
    K0 covered and each k-step owned by one warp (the warps' partials are
    then summed in warp order: a fixed reduce order)."""
    fused, _ = path_chains[path]
    for m0, shapes in fused:
        for dtype in PATH_DTYPES[path]:
            _check_config(m0, shapes, dtype)


@pytest.mark.parametrize("path", list(FUSED))
def test_plans_fuse_the_same_chains_as_before(path_chains, path):
    """The plan compiler's admission (``chain_band_rows``, the f32
    kernel's footprint) is untouched: ATIS serve fuses 7 chains, train 3,
    fp8 train 5, and rwkv6 none of its 3 rank-64 candidates."""
    fused, refused = path_chains[path]
    assert (len(fused), len(refused)) == (FUSED[path], REFUSED[path])
    for m0, shapes in refused:
        with pytest.raises(fc.ChainLoweringError):
            fc.chain_band_rows(m0, shapes)


@pytest.mark.parametrize("m0,shapes", CPU_CHAINS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, *QUANT],
                         ids=str)
def test_chain_config_at_the_cpu_test_geometries(m0, shapes, dtype):
    _check_config(m0, shapes, dtype)


def test_chain_config_exists_for_every_admitted_two_link_chain():
    """Over a grid of TT-like two-link chains (the plan compiler's
    default chain length), every chain ``chain_band_rows`` admits has a
    tensor-core configuration in bf16 and in 8-bit types: the new kernel
    needs less shared memory than the admission rule reserves."""
    dims = (1, 2, 3, 8, 12, 64, 96, 256, 768, 3072)
    seen = 0
    for k0, n0, g, n1, mf in itertools.product(
            dims, (1, 3, 8, 64, 128), (1, 2, 12, 128), (1, 8, 96),
            (1, 48, 1024)):
        shapes, m0 = ((k0, n0), (g * n0, n1)), mf * g
        try:
            fc.chain_band_rows(m0, shapes)
        except fc.ChainLoweringError:
            continue
        seen += 1
        for dtype in (torch.bfloat16, torch.int8):
            assert fc.chain_config(m0, shapes, dtype).smem_bytes <= SMEM_LIMIT
    assert seen > 500


def test_chain_config_picks_bands_that_fill_the_card():
    """Bands of final rows grow while the grid still gives every SM a
    block and link 0's rows fit one pass; the copy narrows to what X's
    row pitch and base address allow."""
    # 768 final rows of 16 link-0 rows each: 4 per block, 192 blocks
    assert fc.chain_config(12288, ((192, 8), (128, 8)),
                           torch.float8_e4m3fn).band == 4
    # 96 final rows: band 1, one block per final row
    assert fc.chain_config(768, ((3072, 8), (64, 8)),
                           torch.bfloat16).band == 1
    # K0 = 12 in bf16: 24-byte rows, 8-byte copies; a base 2 bytes in: 2
    assert fc.chain_config(1024, ((12, 8), (128, 8)),
                           torch.bfloat16).copy_bytes == 8
    assert fc.chain_config(1024, ((12, 8), (128, 8)), torch.bfloat16,
                           alignment=2).copy_bytes == 2
    # a long K0 gives each warp 8 k-steps a stage over 3 stages: the
    # whole of a block's X in flight at once
    cfg = fc.chain_config(768, ((3072, 8), (64, 8)), torch.bfloat16)
    assert (cfg.warp_k, cfg.stage_k, cfg.stages) == (128, 1024, 3)
    # ... and K0 = 768 6 k-steps each in one stage
    cfg = fc.chain_config(768, ((768, 8), (64, 8)), torch.bfloat16)
    assert (cfg.warp_k, cfg.stage_k, cfg.stages) == (96, 768, 1)


def test_chain_config_for_reads_the_base_address():
    base = torch.zeros(64 * 12 + 1, dtype=torch.bfloat16)
    ws = [torch.zeros(12, 8, dtype=torch.bfloat16),
          torch.zeros(64, 8, dtype=torch.bfloat16)]
    assert fc.chain_config_for(base[:768].view(64, 12), ws).copy_bytes == 8
    assert fc.chain_config_for(base[1:].view(64, 12), ws).copy_bytes == 2


def test_chain_kernel_for_picks_by_dtype():
    for dtype in (torch.bfloat16, *QUANT):
        assert fc.chain_kernel_for(torch.zeros(2, 2, dtype=dtype)) == (
            "tensor_cores")
    assert fc.chain_kernel_for(torch.zeros(2, 2)) == "simt"


def test_chain_refusals_are_device_independent():
    """A chain the admission rule refuses raises before anything runs,
    on the CPU as on the card, in every dtype."""
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.zeros(4, 256, dtype=dtype)
        ws = [torch.zeros(256, 256, dtype=dtype),
              torch.zeros(256, 8, dtype=dtype)]
        with pytest.raises(fc.ChainLoweringError, match="budget"):
            fc.chain_n_cuda(x, ws)


#: the chain kernels' instantiations as the profiler prints them, and the
#: group each must land in
CHAIN_NAMES = [
    ("void (anonymous namespace)::chain_tc_kernel<__nv_bfloat16, "
     "__nv_bfloat16, false>(__nv_bfloat16 const*, __nv_bfloat16*, "
     "(anonymous namespace)::ChainTcArgs)", "chain_n"),
    ("void (anonymous namespace)::chain_tc_kernel<__nv_fp8_e4m3, float, "
     "true>(__nv_fp8_e4m3 const*, float*, (anonymous namespace)::"
     "ChainTcArgs)", "chain_n_scaled"),
    ("void (anonymous namespace)::chain_tc_kernel<__nv_fp8_e5m2, float, "
     "true>(__nv_fp8_e5m2 const*, float*, (anonymous namespace)::"
     "ChainTcArgs)", "chain_n_scaled"),
    ("void (anonymous namespace)::chain_tc_kernel<signed char, float, "
     "true>(signed char const*, float*, (anonymous namespace)::"
     "ChainTcArgs)", "chain_n_scaled"),
    ("void (anonymous namespace)::chain_kernel(float const*, float*, "
     "(anonymous namespace)::ChainArgs)", "chain_n"),
]


@pytest.mark.parametrize("name,group", CHAIN_NAMES)
def test_train_profile_groups_the_chain_kernels(name, group):
    """``train_profile`` counts both chain kernels under ``chain_n`` and
    the scaled instantiations under ``chain_n_scaled``, never under
    ``torch`` (``chain_tc_kernel`` does not contain ``chain_kernel``)."""
    assert _group(name) == group


def test_chain_smem_rule_is_the_sum_of_its_parts():
    """``chain_tc_smem_bytes`` at the ATIS (3072, 8) WG link: W_0 48 KB
    and W_1 1 KB in bf16, link 1's one-row A operand, one bf16 Y row, and
    4 ring slots of 8 rows x 1,040 bytes (a 1,024-byte stage, padded to
    an odd number of 16-byte units)."""
    got = fc.chain_tc_smem_bytes(768, ((3072, 8), (64, 8)), 2, 1, 64)
    w = 3072 * 8 * 2 + 64 * 8 * 2
    a1 = 1 * 16 * (-(-64 * 2 // 16) | 1)
    y = 16
    ring = 4 * 8 * 1040
    assert got == w + a1 + y + ring
    # the scaled chain: 8-bit weights, its scales (8 link-0 rows, 8
    # columns), an f32 Y row, and 3 stages of K0's 3,072 bytes: 3 slots
    got8 = fc.chain_tc_smem_bytes(768, ((3072, 8), (64, 8)), 1, 1, 128)
    assert got8 == (3072 * 8 + 64 * 8 + 32 + 32 + a1 + 32
                    + 3 * 8 * 1040)


def test_chain_rule_draws_no_card(monkeypatch):
    """``chain_config`` is plain Python: it never asks for the CUDA
    library, so the CPU can hold it."""
    from repro_torch.kernels import build

    def refuse(*a, **k):
        raise AssertionError("the rule touched the CUDA build")

    monkeypatch.setattr(build, "load", refuse)
    fc.chain_config.cache_clear()
    rng = np.random.default_rng(0)
    for _ in range(20):
        k0 = int(rng.choice([8, 96, 768, 3072]))
        fc.chain_config(768, ((k0, 8), (64, 8)), torch.bfloat16)


def test_chain_probe_times_the_atis_training_chains(path_chains):
    """``analysis.chain_probe`` times exactly the chains the ATIS train
    (bf16) and fp8-train paths fuse."""
    from repro_torch.analysis import chain_probe

    got = {(dtype, m0, shapes) for dtype, m0, shapes in
           chain_probe.GEOMETRIES}
    want = ({(torch.bfloat16, m0, s) for m0, s in path_chains["train"][0]}
            | {(torch.float8_e4m3fn, m0, s)
               for m0, s in path_chains["train_fp8"][0]})
    assert got == want
