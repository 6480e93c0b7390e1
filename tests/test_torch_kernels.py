"""Port kernels (``repro_torch.kernels``) against the JAX reference.

On the CPU the wrappers run their plain PyTorch versions; those are held
here against the JAX Pallas kernels in interpret mode on the same numpy
inputs.  Tolerances: f32 1e-6 relative (sums in another order); bf16
compared after upcasting, 1e-2 relative (a bf16 rounding can land one
ulp apart).  The CUDA kernels themselves are held against the plain
versions on the card by ``tests/test_torch_cuda.py`` (``cuda``-marked,
skipped without a card) and by ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Tiny shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the CPU.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import fused_contraction as jfc  # noqa: E402
from repro_torch.kernels import fused_contraction as fc  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32, 1e-6),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 1e-2)}


def _pair(shape, dtype, rng):
    a = rng.standard_normal(shape).astype(np.float32)
    tdt, jdt, _ = DTYPES[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a).astype(jdt)


def _close(got: torch.Tensor, want, rel: float):
    g = got.float().numpy()
    w = np.asarray(want.astype(jnp.float32))
    assert g.shape == w.shape
    scale = max(float(np.abs(w).max()), 1e-6)
    np.testing.assert_allclose(g, w, rtol=rel, atol=rel * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,k,trans", [(12, 8, 8, False), (64, 24, 8, True),
                                         (40, 17, 9, True), (33, 70, 8, False)])
def test_matmul_matches_pallas(m, n, k, trans, dtype):
    rng = np.random.default_rng(m * 100 + n)
    x_t, x_j = _pair((m, k), dtype, rng)
    w_t, w_j = _pair((n, k) if trans else (k, n), dtype, rng)
    got = fc.matmul_cuda(x_t, w_t, transpose_rhs=trans)
    want = jfc.matmul_pallas(x_j, w_j, transpose_rhs=trans, interpret=True)
    assert got.dtype == DTYPES[dtype][0]
    _close(got, want, DTYPES[dtype][2])


# (m0, links): regroup factors g = 1, 8 and 12, the serving path's shapes
# cut down in rows, then the training path's WG links (K0 of 768 and
# 3,072, n = 8) cut to 8 final rows.
CHAINS = [
    (24, ((16, 8), (8, 12))),          # g = 1, the fixed-M chain
    (64, ((8, 8), (64, 8))),           # g = 8
    (96, ((64, 8), (96, 8))),          # g = 12
    (48, ((96, 8), (8, 16))),          # g = 1 after a wide K
    (64, ((768, 8), (64, 8))),         # WG, g = 8
    (96, ((3072, 8), (96, 8))),        # WG, g = 12
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m0,links", CHAINS)
def test_chain_n_matches_pallas(m0, links, dtype):
    rng = np.random.default_rng(m0)
    x_t, x_j = _pair((m0, links[0][0]), dtype, rng)
    ws = [_pair(s, dtype, rng) for s in links]
    got = fc.chain_n_cuda(x_t, [w for w, _ in ws])
    want = jfc.chain_n_pallas(x_j, [w for _, w in ws], interpret=True)
    _close(got, want, DTYPES[dtype][2])


GEOMETRIES = [
    (1536, ((64, 8), (96, 8))),
    (2048, ((192, 8), (128, 8))),
    (384, ((8, 8), (64, 8))),
    (4, ((96, 8), (8, 64))),
    (1024, ((12, 8), (128, 8))),
    (8, ((4, 3), (5, 4))),             # K=5 does not regroup n=3
    (3, ((4, 4), (8, 4))),             # g=2 does not divide 3 rows
    (12, ((4, 2), (4, 6), (12, 3))),   # 3 links
    (5, ((4, 4),)),                    # one link
]


@pytest.mark.parametrize("m0,links", GEOMETRIES)
def test_chain_plan_accepts_what_the_reference_accepts(m0, links):
    try:
        want = jfc.chain_plan(m0, links)
    except jfc.ChainLoweringError:
        with pytest.raises(fc.ChainLoweringError):
            fc.chain_plan(m0, links)
    else:
        assert fc.chain_plan(m0, links) == want


def test_chain_budget_refusal_is_typed_and_device_independent():
    # An interior weight of 256x256 f32 is 256 KiB: over one block's
    # shared memory, refused before any launch on the CPU as on the card.
    x = torch.zeros(4, 256)
    ws = [torch.zeros(256, 256), torch.zeros(256, 8)]
    with pytest.raises(fc.ChainLoweringError, match="shared-memory budget"):
        fc.chain_n_cuda(x, ws)
    assert fc.chain_smem_bytes(4, ((256, 256), (256, 8)), 1) > (
        fc.CHAIN_SMEM_BUDGET_BYTES)


def test_chain_band_rows_fits_budget_and_fills_the_card():
    for m0, links in GEOMETRIES[:5]:
        band = fc.chain_band_rows(m0, links)
        rows, _ = fc.chain_plan(m0, links)
        assert band & (band - 1) == 0 and 1 <= band <= fc.MAX_BAND_ROWS
        assert fc.chain_smem_bytes(m0, links, band) <= (
            fc.CHAIN_SMEM_BUDGET_BYTES)
        assert band == 1 or rows[-1] // band >= 132


def test_plain_versions_round_like_the_reference():
    # chain intermediates are rounded to the operand dtype between links
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    ws = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for s in ((8, 4), (8, 4))]
    xb, wb = x.bfloat16(), [w.bfloat16() for w in ws]
    h = (xb.float() @ wb[0].float()).bfloat16().reshape(-1, 8)
    want = (h.float() @ wb[1].float()).bfloat16()
    assert torch.equal(ref.chain_n(xb, wb), want)


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.zeros(4, 8, device="meta")
    w = torch.zeros(8, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fc.matmul_cuda(x, w)
    with pytest.raises(ValueError, match="no kernel"):
        fc.chain_n_cuda(torch.zeros(8, 8, device="meta"), [w, w])


def test_library_name_hashes_source_headers_and_flags(tmp_path, monkeypatch):
    """A library's name hashes its source, every shared header under
    ``csrc/`` and the flags: an edit to the shared header renames every
    library (no stale build is loaded), an edit to one source renames
    that library alone.  Every quoted include of a source is such a
    header."""
    import re
    import shutil

    from repro_torch.kernels import build
    for src in build.CSRC.iterdir():
        shutil.copy(src, tmp_path / src.name)
    for name in build.SOURCES:
        for inc in re.findall(r'#include "([^"]+)"',
                              (tmp_path / f"{name}.cu").read_text()):
            assert inc.endswith(".cuh") and (tmp_path / inc).is_file()
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {n: build.library_path(n) for n in build.SOURCES}
    assert len(set(before.values())) == len(build.SOURCES)
    header = tmp_path / "mma_sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build.library_path(n) for n in build.SOURCES}
    assert all(after[n] != before[n] for n in build.SOURCES)
    src = tmp_path / "quantized.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    again = {n: build.library_path(n) for n in build.SOURCES}
    assert [n for n in build.SOURCES if again[n] != after[n]] == ["quantized"]
