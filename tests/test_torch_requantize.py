"""The per-tensor requantize (B5's per-tensor form) and the scalar-scale
forms of B5 / B6, on the CPU, against the precision subsystem and the JAX
reference.

The same numpy inputs go through both packages; fp8 crosses between them
as ``uint8`` bit patterns.  Tolerance: none.  ``ref.requantize`` (the
requantize kernel's plain version) equals ``quant.quantize`` at
``granularity="tensor"`` bit for bit, payload, scale and strides; and
equals the reference's ``precision.quant.quantize`` bit for bit, except
that a NaN is compared as a NaN: ml_dtypes encodes an e5m2 NaN as 0x7E
where torch writes 0x7F.  On the CPU the plan compiler's quantized route
(scalar scales at its inputs and output, :func:`plan_compiler._requantize`
after every op) gives the same bits as per-row scale copies with
``quant.quantize`` after every op.  The kernels themselves
are held to the same plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import dataclasses
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro import precision as jprec  # noqa: E402
from repro_torch import precision as prec  # noqa: E402
from repro_torch.core import csse, plan_compiler, tensorized  # noqa: E402
from repro_torch.core import factorizations as F  # noqa: E402
from repro_torch.kernels import fused_contraction as fc  # noqa: E402
from repro_torch.kernels import quantized as qk  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.precision import quant  # noqa: E402

QUANT = ["fp8_e4m3", "fp8_e5m2", "int8"]


def _bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(t)).reshape(-1).view(np.uint8)


def _nan_mask(t) -> np.ndarray:
    """Where ``t`` (a torch tensor or reference array) holds a NaN."""
    if isinstance(t, torch.Tensor):
        return torch.isnan(t.float()).numpy()
    a = np.asarray(t)
    if a.dtype == np.int8:
        return np.zeros(a.shape, bool)
    return np.isnan(a.astype(np.float32))


def _assert_same(got, want) -> None:
    """Bit-equal, a NaN matching any NaN (the packages' fp8 NaN bytes
    differ); NaN in one where the other is finite fails."""
    g, w = _nan_mask(got).reshape(-1), _nan_mask(want).reshape(-1)
    np.testing.assert_array_equal(g, w)
    gb = _bits(got).reshape(g.size, -1)
    wb = _bits(want).reshape(w.size, -1)
    np.testing.assert_array_equal(gb[~g], wb[~w])


def _case(name: str, dtype: str) -> np.ndarray:
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name.startswith("random"):
        scale = float(name.split("_")[1])
        return (rng.standard_normal((24, 40)) * scale).astype(np.float32)
    if name == "zeros":
        return np.zeros((16, 12), np.float32)
    if name == "specials":
        a = (rng.standard_normal((8, 16)) * 2).astype(np.float32)
        a[0, :4] = [np.nan, np.inf, -np.inf, -0.0]
        return a
    if name == "infs":
        a = (rng.standard_normal((8, 16)) * 2).astype(np.float32)
        a[1, 3], a[5, 7], a[2, 2] = np.inf, -np.inf, -0.0
        return a
    if name == "negzero":
        a = np.zeros((4, 8), np.float32)
        a[::2] = -0.0
        a[3, 5] = -1.5
        return a
    if name == "tie_probe":
        x, _ = ref.tie_probe(prec.QuantPolicy.parse(dtype), rows=8)
        return x.numpy()
    raise KeyError(name)


CASES = ["random_1e-3", "random_1", "random_3e4", "zeros", "specials",
         "infs", "negzero", "tie_probe"]


@pytest.mark.parametrize("permuted", [False, True])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", QUANT)
def test_ref_requantize_matches_quant_and_reference(dtype, case, permuted):
    """``ref.requantize`` against ``quant.quantize`` (bit for bit, strides
    too) and the JAX ``quantize`` (bit for bit, NaN as NaN), on random
    f32 at three scales, all zeros (the 1e-12 floor), NaN / ±inf / -0.0,
    the tie probe's values and a permuted (non-contiguous) view."""
    p = prec.QuantPolicy.parse(dtype)
    jp = jprec.QuantPolicy.parse(dtype)
    a = _case(case, dtype).reshape(4, -1, 2)
    x = torch.from_numpy(a.copy())
    ja = a
    if permuted:
        x = x.permute(2, 0, 1)
        ja = np.ascontiguousarray(a.transpose(2, 0, 1))
        assert not x.is_contiguous()
    q, s = ref.requantize(x, p)
    want = quant.quantize(x, p)
    np.testing.assert_array_equal(_bits(q), _bits(want.q))
    np.testing.assert_array_equal(_bits(s), _bits(want.scale))
    assert q.stride() == want.q.stride() and q.dtype == p.operand_dtype
    assert s.dim() == 0 and s.dtype == torch.float32
    jq = jprec.quantize(jnp.asarray(ja), jp)
    _assert_same(q, jq.q)
    _assert_same(s, jq.scale)


def test_requantize_wrapper_runs_the_plain_version_on_the_cpu():
    """On CPU tensors ``requantize_cuda`` is ``ref.requantize`` and
    launches nothing; it refuses a bf16 policy, integer inputs and a
    device with no kernel."""
    p = prec.QuantPolicy.parse("fp8")
    x = torch.from_numpy(_case("random_1", "fp8_e4m3")).permute(1, 0)
    before = dict(fc.LAUNCHES)
    q, s = qk.requantize_cuda(x, p)
    wq, ws = ref.requantize(x, p)
    assert fc.LAUNCHES == before
    np.testing.assert_array_equal(_bits(q), _bits(wq))
    np.testing.assert_array_equal(_bits(s), _bits(ws))
    with pytest.raises(ValueError, match="bf16"):
        qk.requantize_cuda(x, prec.QuantPolicy.parse("bf16"))
    with pytest.raises(ValueError, match="not supported"):
        qk.requantize_cuda(x.to(torch.int32), p)
    with pytest.raises(ValueError, match="no kernel"):
        qk.requantize_cuda(torch.zeros(4, 4, device="meta"), p)


@pytest.mark.parametrize("numel,launches", [
    (1, 1), (qk.REQUANT_ONE_LAUNCH_MAX, 1),
    (qk.REQUANT_ONE_LAUNCH_MAX + 1, 2), (3_145_728, 2)])
def test_requantize_launch_rule(numel, launches):
    """One launch while the tensor fits one block, two above it."""
    assert qk.requantize_launches(numel) == launches


@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", QUANT)
def test_scalar_scale_forms_equal_row_forms(dtype, in_dtype):
    """A per-tensor scalar scale gives the bits of the same scale expanded
    to ``[R, 1]``, in B5 and in B6 (f32 and bf16 out)."""
    p = prec.QuantPolicy.parse(dtype)
    x = torch.from_numpy(_case("random_1", dtype)).to(in_dtype)
    t = quant.quantize(x, p)
    rows = x.shape[0]
    srow = quant.expand_row_scales(t.scale, rows)
    q_scalar = qk.quantize_cuda(x, t.scale, p)
    np.testing.assert_array_equal(_bits(q_scalar),
                                  _bits(qk.quantize_cuda(x, srow, p)))
    np.testing.assert_array_equal(_bits(q_scalar), _bits(t.q))
    for out in (torch.float32, torch.bfloat16):
        np.testing.assert_array_equal(
            _bits(qk.dequantize_cuda(q_scalar, t.scale, out)),
            _bits(qk.dequantize_cuda(q_scalar, srow, out)))
    with pytest.raises(ValueError, match="scale must be"):
        qk.quantize_cuda(x, torch.ones(rows), p)
    with pytest.raises(ValueError, match="scale must be"):
        qk.dequantize_cuda(q_scalar, torch.ones(1, 1, 1))


# ---------------------------------------------------------------------------
# The plan compiler's quantized route on the CPU
# ---------------------------------------------------------------------------


def _row_scale_quantize_input(x, scale, policy):
    """The input quantize with every scale copied out to ``[rows, 1]``:
    the per-row form the route's scalar scales must equal."""
    if x.dim() < 2:
        return quant.quantize(x, policy, scale=scale)
    if scale is None:
        if policy.granularity == "tile":
            amax = prec.tile_amax(x, policy.tile_rows)
        else:
            amax = prec.amax_of(x)
        scale = prec.compute_scale(amax, policy.qmax, policy.margin)
    else:
        scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    rows = x.shape[0]
    q2 = qk.quantize_cuda(x.reshape(rows, -1).contiguous(),
                          quant.expand_row_scales(scale, rows), policy)
    return quant.QTensor(q=q2.reshape(x.shape), scale=scale)


def _row_scale_dequantize_output(t):
    if t.q.dim() < 2:
        return quant.dequantize(t)
    rows = t.q.shape[0]
    out = qk.dequantize_cuda(t.q.reshape(rows, -1).contiguous(),
                             quant.expand_row_scales(t.scale, rows))
    return out.reshape(t.q.shape)


def _atis_plan(phase: str):
    fact = F.tt((12, 8, 8), (8, 8, 12), 8)
    tokens = 128
    net = {"fp": lambda: fact.forward_network(batch_axes=(("b", tokens),)),
           "bp": lambda: tensorized._bp_network(fact, tokens),
           "wg0": lambda: tensorized._wg_network(fact, tokens, 0)}[phase]()
    return net, csse.search(net, csse.SearchOptions(fused_chain=True)).plan


@pytest.mark.parametrize("scales", ["just_in_time", "delayed", "tile"])
@pytest.mark.parametrize("dtype", QUANT)
@pytest.mark.parametrize("phase", ["fp", "bp", "wg0"])
def test_cpu_quantized_route_is_bit_identical(phase, dtype, scales,
                                              monkeypatch):
    """``_run_quantized`` on the ATIS FP/BP/WG0 plans (numpy seed 1, the
    JAX parity test's inputs) gives the bits of the per-row-scale route
    with ``quant.quantize`` after every op, with just-in-time, delayed
    (per-tensor) and tile scales; every op's result is requantized by
    ``quant.quantize`` on the CPU, once."""
    net, plan = _atis_plan(phase)
    policy = prec.QuantPolicy.parse(dtype + (":tile" if scales == "tile"
                                             else ""))
    compiled = plan_compiler.compile_plan(plan, policy=policy)
    rng = np.random.default_rng(1)
    ts = [torch.from_numpy((rng.standard_normal(net.node_shape(i)) * 0.25)
                           .astype(np.float32))
          for i in range(net.num_nodes)]
    input_scales = None
    if scales == "delayed":
        input_scales = [prec.compute_scale(prec.amax_of(t) * 1.5, policy.qmax)
                        for t in ts]
    calls = []
    real_quantize = quant.quantize

    def spy(x, pol, scale=None):
        calls.append(scale is None)
        return real_quantize(x, pol, scale=scale)

    monkeypatch.setattr(quant, "quantize", spy)
    got = plan_compiler.run(compiled, ts, input_scales=input_scales)
    requantized = sum(calls)
    monkeypatch.setattr(quant, "quantize", real_quantize)
    inter = dataclasses.replace(policy, granularity="tensor")
    with monkeypatch.context() as m:
        m.setattr(plan_compiler, "_quantize_input", _row_scale_quantize_input)
        m.setattr(plan_compiler, "_dequantize_output",
                  _row_scale_dequantize_output)
        m.setattr(plan_compiler, "_requantize",
                  lambda res, pol: quant.quantize(res, inter))
        want = plan_compiler.run(compiled, ts, input_scales=input_scales)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert len(compiled.ops) > 0
    if scales == "tile":    # plus the tile -> tensor collapses
        assert requantized >= len(compiled.ops)
    else:
        assert requantized == len(compiled.ops)
    assert np.isfinite(got.numpy()).all()


def test_fp8_nan_bytes_differ_between_the_packages():
    """Why NaN compares as NaN above: ml_dtypes writes an e5m2 NaN as
    0x7E, torch as 0x7F; both are NaN."""
    jb = np.array([np.nan], np.float32).astype(ml_dtypes.float8_e5m2)
    tb = torch.tensor([float("nan")]).to(torch.float8_e5m2)
    assert _bits(jb)[0] == 0x7E and _bits(tb)[0] == 0x7F
    assert _nan_mask(jb)[0] and _nan_mask(tb)[0]


#: each kernel of ``csrc/quantized.cu`` as the profiler names one of its
#: instantiations, and the group ``train_profile`` must count it under
QUANT_KERNEL_GROUPS = {
    "quantize_kernel": ("float, 2, true", "quantize"),
    "dequantize_kernel": ("__nv_fp8_e4m3, float, true", "dequantize"),
    "requant_block_kernel": ("float, 2, true", "requantize"),
    "requant_amax_kernel": ("float, true", "requantize"),
    "requant_cast_kernel": ("__nv_bfloat16, 4, false", "requantize"),
}


@pytest.mark.parametrize("name", sorted(QUANT_KERNEL_GROUPS))
def test_train_profile_groups_the_quantize_kernels(name):
    """Every ``__global__`` kernel of ``csrc/quantized.cu`` lands in its
    own group, never in ``torch``: ``dequantize_kernel`` (which contains
    ``quantize_kernel``) and the ``requant_`` kernels are matched first."""
    import pathlib
    import re

    from repro_torch.analysis.train_profile import _group
    src = (pathlib.Path(qk.__file__).parent / "csrc" /
           "quantized.cu").read_text()
    names = set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
        src))
    assert names == set(QUANT_KERNEL_GROUPS)
    args, group = QUANT_KERNEL_GROUPS[name]
    assert _group(f"void (anonymous namespace)::{name}<{args}>(float const*, "
                  "unsigned char*, long)") == group
