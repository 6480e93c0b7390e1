"""Port precision path (``repro_torch.precision`` and the quantized
kernels, executors, layer and optimizer) against the JAX reference.

The same numpy inputs go through both packages.  On the CPU the kernel
wrappers run their plain versions; the reference's Pallas kernels run in
interpret mode, as ``tests/test_precision.py`` runs them.  fp8 crosses
between the packages as ``uint8`` bit patterns (``torch.from_numpy``
refuses ``ml_dtypes`` arrays).  Tolerances, with the reason for each:

* quantize / dequantize (B5 / B6 plain versions and ``quant`` ops):
  bit-equal payloads, scales and outputs, including on the tie probe.
* scaled GEMM (B3): exact f32 products summed in another order, 1e-6 of
  the output scale.
* scaled chain (B4): bf16 intermediates, so a sum in another order can
  move one bf16 rounding: 1e-2 of the scale, and >= 99.5% of the
  elements within 1e-5 of it.
* quantized ``execute`` on the ATIS FP/BP/WG0 plans: input payloads
  bit-equal; outputs at most 0.1% of elements beyond 1e-5 of the scale
  and none beyond one quantization step at its magnitude plus 1e-6 of
  the scale (an f32 sum in another order can flip one requantization
  rounding: measured 3e-5 of the elements, one e4m3 step, in fp8_e4m3
  FP; near zero such a flip moves fp8_e5m2 subnormals by several of
  their steps, 2e-9 of the scale).
* the fp8/int8 layer (output, core gradients, history delta): 1e-5 of
  the scale.
* three fp8 train steps of the smoke LM: see
  :func:`test_fp8_train_steps_track_the_reference` (fp8 training is
  chaotic at f32 roundoff, in the reference too).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Tiny shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the CPU.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro import precision as jprec  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.core import contraction as jcontraction  # noqa: E402
from repro.core import csse as jcsse  # noqa: E402
from repro.core import factorizations as jF  # noqa: E402
from repro.core import perf_model as jperf  # noqa: E402
from repro.core import tensorized as jtz  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.kernels import fused_contraction as jfc  # noqa: E402
from repro.kernels import quantized as jqk  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.memory import stash as jstash  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models.lm import LM as JLM  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW  # noqa: E402
from repro_torch import precision as prec  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import params_from_numpy, to_numpy_tree  # noqa: E402
from repro_torch.core import contraction, csse, perf_model  # noqa: E402
from repro_torch.core import factorizations as F  # noqa: E402
from repro_torch.core import plan_compiler, tensorized  # noqa: E402
from repro_torch.kernels import fused_contraction as fc  # noqa: E402
from repro_torch.kernels import quantized as qk  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.memory import stash as tstash  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402

QUANT = ["fp8_e4m3", "fp8_e5m2", "int8"]
_ML = {ml_dtypes.float8_e4m3fn: torch.float8_e4m3fn,
       ml_dtypes.float8_e5m2: torch.float8_e5m2}


def _t(a) -> torch.Tensor:
    """A reference array as a torch tensor; fp8 through its bit pattern."""
    a = np.asarray(a)
    if a.dtype.type in _ML:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            _ML[a.dtype.type])
    return torch.from_numpy(np.array(a))


def _bits(t) -> np.ndarray:
    """Bit pattern of a torch tensor or reference array, for equality."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(t)).view(np.uint8)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _jhw():
    return jperf.HardwareModel(**dataclasses.asdict(perf_model.H100_SXM))


# ---------------------------------------------------------------------------
# Policy, scale math, quantize / dequantize
# ---------------------------------------------------------------------------


def test_policy_and_scale_math_match_reference():
    for name in ("fp8", "e5m2", "int8:tile", "bf16", "fp8_e5m2:tile"):
        p, jp = prec.QuantPolicy.parse(name), jprec.QuantPolicy.parse(name)
        assert (p.tag, p.dtype_bytes, p.quantized) == (
            jp.tag, jp.dtype_bytes, jp.quantized)
        assert p.signature_payload() == jp.signature_payload()
        if p.quantized:
            assert p.qmax == jp.qmax
            assert prec.QuantPolicy.from_tag(p.tag) == dataclasses.replace(
                p, tile_rows=128)
    with pytest.raises(ValueError):
        prec.QuantPolicy.parse("fp4")
    x = _rand((256, 12), 0, 3.0)
    hist = np.abs(_rand((16,), 1))
    hist[5:] = 0
    zero = np.zeros(16, np.float32)
    pairs = [
        (prec.amax_of(torch.from_numpy(x)), jprec.amax_of(jnp.asarray(x))),
        (prec.tile_amax(torch.from_numpy(x), 128),
         jprec.tile_amax(jnp.asarray(x), 128)),
        (prec.tile_amax(torch.from_numpy(x[:100]), 128),
         jprec.tile_amax(jnp.asarray(x[:100]), 128)),
        (prec.compute_scale(torch.tensor(3.5), 448.0, 1.25),
         jprec.compute_scale(3.5, 448.0, 1.25)),
        (prec.update_history(torch.from_numpy(hist), 7.0),
         jprec.update_history(jnp.asarray(hist), 7.0)),
        (prec.scale_from_history(torch.from_numpy(hist), 9.0, 127.0),
         jprec.scale_from_history(jnp.asarray(hist), 9.0, 127.0)),
        (prec.scale_from_history(torch.from_numpy(zero), 9.0, 127.0),
         jprec.scale_from_history(jnp.asarray(zero), 9.0, 127.0)),
    ]
    for got, want in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", QUANT)
def test_quant_ops_match_reference(dtype):
    """Just-in-time per-tensor and per-tile scales, a delayed scale,
    dequantize and the per-tensor collapse: bit-equal to the reference."""
    x = _rand((256, 40), 2, 4.0)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for gran in ("tensor", "tile"):
        p = prec.QuantPolicy(dtype=dtype, granularity=gran)
        jp = jprec.QuantPolicy(dtype=dtype, granularity=gran)
        for scale in (None, 0.0123):
            got = prec.quantize(xt, p, None if scale is None
                                else torch.tensor(scale))
            want = jprec.quantize(xj, jp, scale)
            np.testing.assert_array_equal(_bits(got.q), _bits(want.q))
            np.testing.assert_array_equal(got.scale.numpy(),
                                          np.asarray(want.scale))
            np.testing.assert_array_equal(
                prec.dequantize(got).numpy(), np.asarray(jprec.dequantize(
                    want)))
            np.testing.assert_array_equal(got.row_scales().numpy(),
                                          np.asarray(want.row_scales()))
        col = prec.requantize_per_tensor(got, p)
        jcol = jprec.requantize_per_tensor(want, jp)
        assert col.per_tensor
        np.testing.assert_array_equal(_bits(col.q), _bits(jcol.q))


@pytest.mark.parametrize("dtype", QUANT)
def test_quantize_plain_matches_pallas_bit_for_bit(dtype):
    """B5's plain version against ``quantize_pallas`` on random rows and
    on the tie probe (every fp8 value, every rounding tie and its f32
    neighbours, subnormals, ±qmax and beyond), from f32 and bf16."""
    p, jp = prec.QuantPolicy.parse(dtype), jprec.QuantPolicy.parse(dtype)
    x, s = ref.tie_probe(p)
    r = torch.from_numpy(_rand((300, 96), 4, 2.0))
    rs = prec.quantize(r, p).row_scales()
    for xin, sc in ((x, s), (x.bfloat16(), s), (r, rs)):
        got = qk.quantize_cuda(xin, sc, p)       # the CPU runs the plain one
        assert got.dtype == p.operand_dtype
        xj = jnp.asarray(xin.float().numpy()).astype(
            jnp.bfloat16 if xin.dtype == torch.bfloat16 else jnp.float32)
        want = jqk.quantize_pallas(xj, jnp.asarray(sc.numpy()), jp,
                                   interpret=True)
        np.testing.assert_array_equal(_bits(got), _bits(want))
    # The probe has teeth: int8 ties rounded away from zero, or fp8
    # subnormals flushed to zero, change some of its payloads.
    y = (x / s).clamp(-p.qmax, p.qmax)
    if dtype == "int8":
        faulty = torch.floor(y + 0.5)
    else:
        tiny = torch.finfo(p.operand_dtype).smallest_normal
        faulty = torch.where(y.abs() < tiny, 0.0, y)
    assert not np.array_equal(_bits(faulty.to(p.operand_dtype)),
                              _bits(ref.quantize(x, s, p)))


@pytest.mark.parametrize("dtype", QUANT)
def test_dequantize_plain_matches_pallas_bit_for_bit(dtype):
    p, jp = prec.QuantPolicy.parse(dtype), jprec.QuantPolicy.parse(dtype)
    x, s = ref.tie_probe(p, rows=14)
    q = qk.quantize_cuda(x, s, p)
    jq_ = jqk.quantize_pallas(jnp.asarray(x.numpy()),
                              jnp.asarray(s.numpy()), jp, interpret=True)
    for out, jout in ((torch.float32, jnp.float32),
                      (torch.bfloat16, jnp.bfloat16)):
        got = qk.dequantize_cuda(q, s, out)
        want = jqk.dequantize_pallas(jq_, jnp.asarray(s.numpy()),
                                     out_dtype=jout, interpret=True)
        assert got.dtype == out
        np.testing.assert_array_equal(_bits(got), _bits(want))


# ---------------------------------------------------------------------------
# Scaled GEMM (B3) and scaled chain (B4)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", QUANT)
@pytest.mark.parametrize("trans", [False, True])
def test_matmul_scaled_matches_pallas(dtype, trans):
    jp = jprec.QuantPolicy.parse(dtype)
    x, w = _rand((70, 30), 5), _rand((50, 30) if trans else (30, 50), 6)
    qx, qw = jprec.quantize(jnp.asarray(x), jp), jprec.quantize(
        jnp.asarray(w), jp)
    sl = np.asarray(qx.row_scales()) * np.linspace(0.5, 2, 70,
                                                   dtype=np.float32)[:, None]
    sr = np.linspace(1, 3, 50, dtype=np.float32)[None, :] * float(qw.scale)
    want = jfc.matmul_pallas(qx.q, qw.q, transpose_rhs=trans,
                             scales=(jnp.asarray(sl), jnp.asarray(sr)),
                             block_m=32, block_n=32, block_k=16,
                             interpret=True)
    got = fc.matmul_cuda(_t(qx.q), _t(qw.q), transpose_rhs=trans,
                         scales=(torch.from_numpy(sl), torch.from_numpy(sr)))
    assert got.dtype == torch.float32
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("dtype", QUANT)
def test_chain_n_scaled_matches_pallas(dtype):
    """A 3-link chain regrouping by 4 then 2 (the TT sweep's shape)."""
    jp = jprec.QuantPolicy.parse(dtype)
    links = ((12, 4), (16, 6), (12, 5))
    x = jprec.quantize(jnp.asarray(_rand((96, 12), 7)), jp)
    ws = [jprec.quantize(jnp.asarray(_rand(s, 8 + i)), jp)
          for i, s in enumerate(links)]
    s_first = x.row_scales() * ws[0].scale
    scales = (s_first, jnp.full((1, 1), ws[1].scale),
              jnp.full((1, 5), ws[2].scale))
    want = np.asarray(jfc.chain_n_pallas(x.q, [w.q for w in ws],
                                         scales=scales, interpret=True))
    got = fc.chain_n_cuda(_t(x.q), [_t(w.q) for w in ws],
                          scales=[_t(s) for s in scales]).numpy()
    assert got.shape == want.shape == (12, 5)
    err = np.abs(got - want) / np.abs(want).max()
    assert err.max() <= 1e-2 and np.mean(err <= 1e-5) >= 0.995


@pytest.mark.parametrize("dtype", QUANT)
@pytest.mark.parametrize("m0,links", [
    (64, ((768, 8), (64, 8))),         # the WG links, g = 8
    (96, ((3072, 8), (96, 8))),        # g = 12, the longest K0
])
def test_chain_n_scaled_matches_pallas_at_wg_shapes(dtype, m0, links):
    """The WG links of the fp8 training path (K0 of 768 and 3,072, cut to
    8 final rows) against the Pallas kernel, at the 3-link test's
    tolerance: every element within 1e-2 of the scale, 99.5% within
    1e-5 (a bf16 intermediate may round one ulp apart)."""
    jp = jprec.QuantPolicy.parse(dtype)
    x = jprec.quantize(jnp.asarray(_rand((m0, links[0][0]), 17)), jp)
    ws = [jprec.quantize(jnp.asarray(_rand(s, 18 + i)), jp)
          for i, s in enumerate(links)]
    n = links[-1][1]
    scales = (x.row_scales() * ws[0].scale,
              jnp.full((1, n), ws[1].scale) * jnp.linspace(0.5, 2, n)[None])
    want = np.asarray(jfc.chain_n_pallas(x.q, [w.q for w in ws],
                                         scales=scales, interpret=True))
    got = fc.chain_n_cuda(_t(x.q), [_t(w.q) for w in ws],
                          scales=[_t(s) for s in scales]).numpy()
    assert got.shape == want.shape == (8, n)
    err = np.abs(got - want) / np.abs(want).max()
    assert err.max() <= 1e-2 and np.mean(err <= 1e-5) >= 0.995


@pytest.mark.parametrize("dtype", QUANT)
def test_chain_scaled_agreement_rejects_unrounded_intermediates(dtype):
    """The rule the scaled chain kernel is held to on the card passes the
    plain version against itself and fails a chain whose intermediates
    skip the bf16 rounding or round to fp16 (at the card test's shapes),
    which stay within half a bf16 ulp of the output's scale."""
    pol = prec.QuantPolicy.parse(dtype)

    def variant(x, ws, scales, inter):
        res = torch.matmul(x.float(), ws[0].float()) * scales[0]
        for w, sc in zip(ws[1:], scales[1:]):
            lhs = res.to(inter).float().reshape(-1, w.shape[0])
            res = torch.matmul(lhs, w.float()) * sc
        return res

    for m0, links in ((2048, ((192, 8), (128, 8))),
                      (1536, ((8, 8), (64, 8), (96, 8)))):
        gen = torch.Generator().manual_seed(m0)
        x = prec.quantize(torch.randn(m0, links[0][0], generator=gen), pol)
        ws = [prec.quantize(torch.randn(s_, generator=gen), pol)
              for s_ in links]
        scales = (x.row_scales() * ws[0].scale,
                  *[w.scale.reshape(1, 1) for w in ws[1:-1]],
                  torch.full((1, links[-1][1]), float(ws[-1].scale)))
        wq = [w.q for w in ws]
        want = ref.chain_n_scaled(x.q, wq, scales)
        assert torch.equal(variant(x.q, wq, scales, torch.bfloat16), want)
        assert ref.chain_scaled_agreement(want.clone(), want)[0]
        for inter in (torch.float32, torch.float16):
            good, nums = ref.chain_scaled_agreement(
                variant(x.q, wq, scales, inter), want)
            assert not good and nums["share_beyond_1e-5"] > 0.9, nums
            assert nums["max_abs_err"] <= nums["tol_abs"] / 4, nums


def test_scaled_kernel_refusals_are_typed():
    q8 = torch.zeros(4, 8, dtype=torch.int8)
    with pytest.raises(fc.ChainLoweringError, match="scale shapes"):
        fc.matmul_cuda(q8, q8.t().contiguous(),
                       scales=(torch.ones(4, 1), torch.ones(1, 3)))
    with pytest.raises(fc.ChainLoweringError, match="chain scales"):
        fc.chain_n_cuda(q8, [torch.zeros(8, 2, dtype=torch.int8)] * 2,
                        scales=(torch.ones(4, 1),))
    with pytest.raises(ValueError, match="no kernel"):
        fc.matmul_cuda(q8.to("meta"), q8.t().contiguous().to("meta"),
                       scales=(torch.ones(4, 1, device="meta"),
                               torch.ones(1, 4, device="meta")))


# ---------------------------------------------------------------------------
# Quantized plan execution
# ---------------------------------------------------------------------------


def _atis_nets(fact, mod, tokens=128):
    return {"fp": fact.forward_network(batch_axes=(("b", tokens),)),
            "bp": mod._bp_network(fact, tokens),
            "wg0": mod._wg_network(fact, tokens, 0)}


def _one_step(v, s, policy):
    """Spacing of the policy's grid at |v| (a tensor) under scale s."""
    y = np.abs(v) / s
    if policy.dtype == "int8":
        return np.full_like(y, s)
    mant = 3 if policy.dtype == "fp8_e4m3" else 2
    emin = -6 if policy.dtype == "fp8_e4m3" else -14
    e = np.floor(np.log2(np.maximum(y, 2.0 ** emin)))
    return 2.0 ** (e - mant) * s


@pytest.mark.parametrize("dtype", QUANT)
@pytest.mark.parametrize("phase", ["fp", "bp", "wg0"])
def test_quantized_execute_matches_reference(phase, dtype):
    """The ATIS layer's FP/BP/WG0 plans at 128 tokens, inputs ×0.25 from
    numpy seed 1: port einsum vs the reference's einsum, port cuda (the
    plain versions) vs the reference's pallas (interpret)."""
    p, jp = prec.QuantPolicy.parse(dtype), jprec.QuantPolicy.parse(dtype)
    net = _atis_nets(F.tt((12, 8, 8), (8, 8, 12), 8), tensorized)[phase]
    jnet = _atis_nets(jF.tt((12, 8, 8), (8, 8, 12), 8), jtz)[phase]
    plan = csse.search(net, csse.SearchOptions(fused_chain=True)).plan
    jplan = jcsse.search(jnet, jcsse.SearchOptions(fused_chain=True)).plan
    assert [(s.lhs, s.rhs) for s in plan.steps] == [
        (s.lhs, s.rhs) for s in jplan.steps]
    rng = np.random.default_rng(1)
    arrays = [(rng.standard_normal(net.node_shape(i)) * 0.25).astype(
        np.float32) for i in range(net.num_nodes)]
    ts, js = [torch.from_numpy(a) for a in arrays], [jnp.asarray(a)
                                                     for a in arrays]
    for got, want in zip(prec.quantize_nodes(ts, p),
                         jprec.quantize_nodes(js, jp)):
        np.testing.assert_array_equal(_bits(got.q), _bits(want.q))
    for backend, jbackend in (("einsum", "einsum"), ("cuda", "pallas")):
        got = contraction.execute(plan, ts, backend=backend,
                                  policy=p).numpy()
        want = np.asarray(jcontraction.execute(jplan, js, backend=jbackend,
                                               policy=jp))
        amax = np.abs(want).max()
        err = np.abs(got - want)
        assert np.mean(err > 1e-5 * amax) <= 1e-3, backend
        # One step of the output's grid at the element's magnitude, over
        # an f32 floor of 1e-6 of the scale: near zero (fp8_e5m2's
        # subnormals) a flip upstream moves an element by several of the
        # grid's tiny steps, ~1e-9 of the scale.
        mag = np.maximum(np.abs(got), np.abs(want))
        step = _one_step(mag, amax / p.qmax, p)
        assert np.all(err <= step * (1 + 1e-6) + 1e-6 * amax), backend


def test_quantized_compile_report_and_runtime_degrade(monkeypatch):
    """The report carries the policy tag; on CPU operands a chain the
    kernel refuses at run time degrades to the plain chain math, counted
    (on the card the refusal propagates:
    ``test_cuda_refused_quantized_chain_raises``)."""
    net = _atis_nets(F.tt((12, 8, 8), (8, 8, 12), 8), tensorized)["wg0"]
    plan = csse.search(net, csse.SearchOptions(fused_chain=True)).plan
    pol = prec.QuantPolicy.parse("fp8")
    compiled = plan_compiler.compile_plan(plan, policy=pol)
    assert compiled.report()["policy"] == "fp8_e4m3/tensor"
    assert plan_compiler.compile_plan(plan).report()["policy"] is None
    assert compiled.report()["num_chain"] >= 1
    assert plan_compiler.compile_cached(plan, policy=pol) is not (
        plan_compiler.compile_cached(plan))
    ts = [torch.from_numpy(_rand(net.node_shape(i), 30 + i, 0.25))
          for i in range(net.num_nodes)]
    want = plan_compiler.run(compiled, ts)

    def refuse(*a, **k):
        raise fc.ChainLoweringError("forced")

    plan_compiler.reset_degrade_counts()
    monkeypatch.setattr(plan_compiler, "chain_n_cuda", refuse)
    got = plan_compiler.run(compiled, ts)
    assert plan_compiler.DEGRADE_COUNTS["runtime_quantized"] == (
        compiled.report()["num_chain"])
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The quantized layer
# ---------------------------------------------------------------------------


def _layers(dtype, method="tt", out=(4, 4), inp=(4, 8), rank=3):
    jfact, fact = jF.make(method, out, inp, rank), F.make(method, out, inp,
                                                          rank)
    jl = jtz.TensorizedLinear(fact=jfact, compute_dtype=jnp.float32,
                              opts=jcsse.SearchOptions(fused_chain=True),
                              precision=jprec.QuantPolicy.parse(dtype))
    tl = tensorized.TensorizedLinear(
        fact, compute_dtype=torch.float32,
        opts=csse.SearchOptions(fused_chain=True),
        precision=prec.QuantPolicy.parse(dtype))
    return jl, tl


@pytest.mark.parametrize("dtype", QUANT)
def test_quantized_layer_matches_reference(dtype):
    """Output, core gradients and the history delta of the quantized
    layer (a history with one step in it) against ``jax.vjp`` through the
    reference's ``_tnn_apply_q``."""
    jl, tl = _layers(dtype)
    rng = np.random.default_rng(7)
    cores = [0.5 * rng.standard_normal(jl.fact.core_shape(i)).astype(
        np.float32) for i in range(jl.fact.num_cores)]
    hist = np.zeros((2 + len(cores), 16), np.float32)
    hist[:, 0] = 3 * np.abs(rng.standard_normal(len(hist)))
    x = rng.standard_normal((3, 5, jl.fact.N)).astype(np.float32)
    dy = rng.standard_normal((3, 5, jl.fact.M)).astype(np.float32)
    params = {"cores": tuple(map(jnp.asarray, cores)),
              "quant_amax": jnp.asarray(hist)}
    y, g = jax.jit(lambda p: (lambda yv: (yv[0], yv[1](jnp.asarray(dy))[0]))(
        jax.vjp(lambda p_: jl(p_, jnp.asarray(x)), p)))(params)
    assert tuple(tl.quant_amax.shape) == hist.shape
    with torch.no_grad():
        for c, a in zip(tl.cores, cores):
            c.copy_(torch.from_numpy(a))
        tl.quant_amax.copy_(torch.from_numpy(hist))
    yt = tl(torch.from_numpy(x))
    yt.backward(torch.from_numpy(dy))

    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())

    close(yt.detach().numpy(), y)
    for c, want in zip(tl.cores, g["cores"]):
        close(c.grad.numpy(), want)
    np.testing.assert_array_equal(tl.quant_amax.grad.numpy(),
                                  np.asarray(g["quant_amax"]))
    new_hist = hist - tl.quant_amax.grad.numpy()
    assert np.all(new_hist[:, 0] > 0) and np.all(new_hist[:, 1] == hist[:, 0])


def test_config_path_builds_a_quantized_layer():
    """``make_tensorized_linear`` from a quantized ``TNNConfig`` carries
    the history and computes the reference's fp8 layer, not its bf16
    one; without the history it runs with just-in-time scales."""
    pol = prec.QuantPolicy.parse("fp8")
    tnn = tensorized.TNNConfig(enabled=True, rank=4, num_factors=2,
                               precision=pol)
    jtnn = jtz.TNNConfig(enabled=True, rank=4, num_factors=2,
                         precision=jprec.QuantPolicy.parse("fp8"))
    layer = tensorized.make_tensorized_linear(64, 64, tnn, device="cpu",
                                              compute_dtype=torch.float32)
    jl = jtz.make_tensorized_linear(64, 64, jtnn, compute_dtype=jnp.float32)
    jl0 = jtz.make_tensorized_linear(64, 64, dataclasses.replace(
        jtnn, precision=jprec.QuantPolicy()), compute_dtype=jnp.float32)
    names = [n for n, _ in layer.named_parameters()]
    assert "quant_amax" in names and layer.precision == pol
    assert layer.quant_amax.dtype == torch.float32
    assert tuple(layer.quant_amax.shape) == (2 + layer.fact.num_cores, 16)
    x = _rand((8, 64), 9)
    cores = [c.detach().numpy() for c in layer.cores]
    jp = {"cores": tuple(map(jnp.asarray, cores)),
          "quant_amax": jnp.zeros(tuple(layer.quant_amax.shape))}
    want = np.asarray(jl(jp, jnp.asarray(x)))
    bf16 = np.asarray(jl0({"cores": jp["cores"]}, jnp.asarray(x)))
    got = layer(torch.from_numpy(x)).detach().numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    assert np.abs(got - bf16).max() > 1e-3 * scale
    del layer.quant_amax                    # no history: just in time
    y = layer(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=0,
                               atol=1e-5 * scale)
    (y ** 2).sum().backward()
    assert all(c.grad is not None for c in layer.cores)


@pytest.mark.parametrize("dtype", QUANT)
def test_quantized_stash_is_lossless_under_quantized_execution(dtype):
    """The reference's ``test_memory.py`` property: an fp8/int8 stash
    pinned to the delayed scale replays the WG quantization bits, so
    every gradient is bit-equal to the ``store`` stash's."""
    fact = F.tt((4, 4), (4, 4), 4)
    pol = prec.QuantPolicy.parse(dtype)
    x = torch.from_numpy(_rand((8, fact.N), 11))
    grads = []
    for remat in ("store", "quantized"):
        gen = torch.Generator().manual_seed(0)
        layer = tensorized.TensorizedLinear(
            fact, compute_dtype=torch.float32, precision=pol,
            remat=tstash.StashPolicy.parse(remat), generator=gen)
        (layer(x) ** 2).sum().backward()
        grads.append([p.grad for p in layer.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_stash_round_trip_matches_reference():
    x = _rand((8, 16), 12)
    pol = tstash.StashPolicy.parse("quantized:fp8")
    jpol = jstash.StashPolicy.parse("quantized:fp8")
    res = tstash.stash(torch.from_numpy(x), pol)
    jres = jstash.stash(jnp.asarray(x), jpol)
    np.testing.assert_array_equal(_bits(res[0]), _bits(jres[0]))
    np.testing.assert_array_equal(res[1].numpy(), np.asarray(jres[1]))
    np.testing.assert_array_equal(res[2].numpy(), np.asarray(jres[2]))
    x_hat = tstash.unstash(res, pol, torch.float32)
    np.testing.assert_array_equal(
        x_hat.numpy(), np.asarray(jstash.unstash(jres, jpol, jnp.float32)))
    assert tstash.stashed_amax(res, x_hat) is res[2]
    store = tstash.stash(torch.from_numpy(x), tstash.STORE)
    assert store[1] is None and tstash.unstash(store, tstash.STORE) is (
        store[0])


# ---------------------------------------------------------------------------
# Optimizer, microbatches, conversion
# ---------------------------------------------------------------------------


def test_adamw_amax_passthrough_and_loss_scale():
    """The reference's test, on both optimizers: the amax leaf becomes
    the new history exactly, and the grad norm, clipping, moments and
    decay see only the unscaled true gradient."""
    kw = dict(lr=1e-2, loss_scale=64.0, warmup_steps=0, total_steps=10,
              min_lr_ratio=1.0)
    hist0 = np.zeros((2, 3), np.float32)
    new_hist = np.asarray([[1.0, 0, 0], [2.0, 0, 0]], np.float32)
    w = np.ones((4, 4), np.float32)
    g = np.full((4, 4), 0.5 * 64.0, np.float32)
    jopt = JAdamW(**kw)
    jparams = {"w": jnp.asarray(w), "quant_amax": jnp.asarray(hist0)}
    jnew, _, jm = jopt.update({"w": jnp.asarray(g),
                               "quant_amax": jnp.asarray(hist0 - new_hist)},
                              jopt.init(jparams), jparams)
    opt = AdamW(**kw)
    params = {"w": torch.from_numpy(w.copy()),
              "layers.0.mlp.up.quant_amax": torch.from_numpy(hist0.copy())}
    assert opt.is_amax("layers.0.mlp.up.quant_amax")
    assert not opt.is_amax("layers.0.mlp.up.cores.0")
    new, state, m = opt.update(
        {"w": torch.from_numpy(g),
         "layers.0.mlp.up.quant_amax": torch.from_numpy(hist0 - new_hist)},
        opt.init(params), params)
    np.testing.assert_array_equal(
        new["layers.0.mlp.up.quant_amax"].numpy(), new_hist)
    np.testing.assert_array_equal(np.asarray(jnew["quant_amax"]), new_hist)
    assert float(m["grad_norm"]) == pytest.approx(2.0, rel=1e-7)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-7)
    np.testing.assert_allclose(new["w"].numpy(), np.asarray(jnew["w"]),
                               rtol=1e-6)
    assert not state.m["layers.0.mlp.up.quant_amax"].any()


def test_microbatch_amax_accumulation_takes_max():
    """Two microbatches, one tiny and one large: the history records the
    large one's amax (a sum or mean would record the wrong value)."""
    _, lq = _layers("fp8_e4m3")

    class Model:
        def loss(self, batch):
            return (lq(batch["inputs"]) ** 2).sum(), {}

    x = np.concatenate([_rand((8, 32), 70) * 0.01, _rand((8, 32), 71) * 8])
    params = dict(lq.named_parameters())
    opt = AdamW(lr=1e-3, warmup_steps=0, total_steps=10)
    step = steps.make_train_step(Model(), opt, microbatches=2)
    before = lq.cores[0].detach().clone()
    state, _ = step({"params": params, "opt": opt.init(params)},
                    {"inputs": torch.from_numpy(x)})
    hist = state["params"]["quant_amax"]
    assert float(hist[0, 0]) == pytest.approx(float(np.abs(x[8:]).max()),
                                              rel=1e-6)
    assert not torch.equal(before, lq.cores[0])


def test_convert_round_trips_the_amax_history():
    """The reference's stacked ``[L, 2 + nc, H]`` leaf becomes
    ``layers.<l>.<...>.quant_amax`` and comes back unchanged; the
    optimizer's passthrough catches it before the decay rule."""
    cfg = dataclasses.make_dataclass("Cfg", [("num_layers", int)])(2)
    tree = {"layers": {"mlp": {"up": {
        "cores": (_rand((2, 3, 4), 1), _rand((2, 4, 3), 2)),
        "quant_amax": np.abs(_rand((2, 4, 16), 3))}}}}
    sd = params_from_numpy(tree, cfg)
    assert tuple(sd["layers.1.mlp.up.quant_amax"].shape) == (4, 16)
    back = to_numpy_tree(sd, cfg)
    np.testing.assert_array_equal(back["layers"]["mlp"]["up"]["quant_amax"],
                                  tree["layers"]["mlp"]["up"]["quant_amax"])
    assert AdamW.is_amax("layers.1.mlp.up.quant_amax")


# ---------------------------------------------------------------------------
# fp8 training steps of the smoke LM
# ---------------------------------------------------------------------------


def _train(run_step, batches):
    out = []
    for b in batches:
        m = run_step(b)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return np.asarray(out)


def _rel(a, b):
    return np.abs(a - b) / np.abs(b)


_LM_TARGETS = ("mlp", "qkv", "out")


def _port_fp8_train(batches, backend, *, tree=None, **opt_kw):
    """fp8 training of the port's smoke LM (f32 compute, tensorized on
    mlp/qkv/out) for one step per batch: the metrics ``[steps, 2]``, the
    parameters as a reference-shaped numpy tree after each step, and the
    final parameters by name.  ``tree`` gives the initial weights."""
    arch = tbase.get("paper_atis_tt")
    tnn = dataclasses.replace(arch.smoke().tnn, targets=_LM_TARGETS,
                              precision=prec.QuantPolicy.parse("fp8"))
    model, cfg = steps.build_model(arch, tnn=tnn, smoke=True, device="cpu",
                                   backend=backend,
                                   compute_dtype=torch.float32)
    if tree is not None:
        model.load_state_dict(params_from_numpy(tree, cfg))
    opt = AdamW(**opt_kw)
    params = dict(model.named_parameters())
    state = {"params": params, "opt": opt.init(params)}
    step = steps.make_train_step(model, opt)
    trees = []

    def run(b):
        nonlocal state
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in b.items()})
        trees.append(to_numpy_tree(state["params"], cfg))
        return m

    return _train(run, batches), trees, state["params"]


def test_fp8_train_steps_track_the_reference(monkeypatch):
    """Three fp8 steps (loss scale 128) of the smoke LM, tensorized on
    mlp/qkv/out, from the same numpy weights: the port's einsum backend
    against the reference's jitted ``make_train_step`` on einsum, the
    port's cuda backend (fused chains with bf16 intermediates) against
    the reference's on pallas (interpret mode), plans searched with the
    same H100 model.

    Exact where nothing quantized comes before: after the first step the
    cores' amaxes, and the amax of the first layer's attention input, lie
    within 1e-6 of the reference's.

    Everything else is chaotic at f32 roundoff from the first step on:
    per-tensor requantization after every contraction turns a one-ulp
    difference into a flipped fp8 rounding (6% of one element), which the
    next contractions spread.  Started from weights scaled by ``1 ±
    2**-22`` or ``1 ± 2**-21``, the reference moves its first step's loss
    by up to 4.4e-3, its grad norm by up to 0.18 and an amax by up to 1.6
    of itself, and by 0.04 / 0.49 / 3.0 within three steps — so the
    fixed 1e-3 / 1e-2 / 1e-3 limits cannot hold even at the first step.  At
    each step the port is held to twice that envelope, measured here over
    both reference backends and the four nudges (measured: at most 1.1
    times it).  The exact loss-scale test below covers what this cannot
    (row 1 of the history)."""
    orig = jtz._plans
    hw = _jhw()
    monkeypatch.setattr(jtz, "_plans",
                        lambda fact, batch, opts, hw_=None:
                        orig(fact, batch, opts, hw))
    jarch = jbase.get("paper_atis_tt")
    rng = np.random.default_rng(0)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if "quant_amax" in name:
            return np.zeros(s.shape, np.float32)
        if "scale" in name:
            a = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif "cores" in name:
            a = 0.35 * rng.standard_normal(s.shape)
        else:
            a = rng.standard_normal(s.shape) / np.sqrt(s.shape[-2])
        return a.astype(np.float32)

    kw = dict(lr=3e-3, warmup_steps=2, total_steps=4, loss_scale=128.0)
    jopt = JAdamW(**kw)
    jsteps_by_backend, tree, batches = {}, None, None
    for be in ("einsum", "pallas"):
        jtnn = dataclasses.replace(jarch.smoke().tnn, targets=_LM_TARGETS,
                                   backend=be,
                                   precision=jprec.QuantPolicy.parse("fp8"))
        jcfg = dataclasses.replace(jarch.smoke(jtnn),
                                   compute_dtype=jnp.float32)
        jm = JLM(jcfg)
        if tree is None:
            tree = jax.tree_util.tree_map_with_path(
                fill, jax.eval_shape(jm.init, jax.random.key(0)))
            data = jpipeline.SyntheticLM(jpipeline.DataConfig(
                vocab=jcfg.vocab, seq_len=16, global_batch=4))
            batches = [data.batch(s_) for s_ in range(3)]
        jsteps_by_backend[be] = jax.jit(
            jsteps.make_train_step(jm, jopt, jblocks.no_shard))

    def hists(params):
        flat = jax.tree_util.tree_flatten_with_path(params)[0]
        return {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat
                if "quant_amax" in jax.tree_util.keystr(k)}

    def reference(be, nudge=0.0):
        p = jax.tree.map(lambda a: jnp.asarray(
            (a * np.float32(1 + nudge)).astype(np.float32)), tree)
        st = {"params": p, "opt": jopt.init(p)}
        hs = []

        def run(b):
            nonlocal st
            st, m = jsteps_by_backend[be](
                st, {k: jnp.asarray(v) for k, v in b.items()})
            hs.append(hists(st["params"]))
            return m
        return _train(run, batches), hs

    def per_step(a, b):
        """[steps, 3]: loss, grad norm and the largest relative
        difference of a written amax after each step."""
        (ma, ha), (mb, hb) = a, b
        out = []
        for s_ in range(len(batches)):
            h = max(float(_rel(ha[s_][k][:, :, :s_ + 1],
                               hb[s_][k][:, :, :s_ + 1]).max())
                    for k in hb[s_])
            out.append((_rel(ma[s_, 0], mb[s_, 0]),
                        _rel(ma[s_, 1], mb[s_, 1]), h))
        return np.asarray(out)

    refs = {be: reference(be) for be in jsteps_by_backend}
    envelope = np.max([per_step(reference(be, n), refs[be])
                       for be in refs
                       for n in (2.0 ** -22, -2.0 ** -22, 2.0 ** -21,
                                 -2.0 ** -21)], axis=0)
    for backend, ref_be in (("einsum", "einsum"), ("cuda", "pallas")):
        got_m, trees, _ = _port_fp8_train(batches, backend, tree=tree, **kw)
        assert np.all(np.isfinite(got_m))
        got_h = [hists(t) for t in trees]
        ref_h = refs[ref_be][1]
        assert got_h[-1].keys() == ref_h[-1].keys() and len(got_h[-1]) == 7
        for k, h in got_h[-1].items():
            # [L, 2 + cores, 16]: slots 0-2 written, the rest still zero
            assert np.all(h[:, :, :3] > 0) and not h[:, :, 3:].any(), k
            assert not got_h[0][k][:, :, 1:].any(), k
            np.testing.assert_allclose(got_h[0][k][:, 2:, 0],
                                       ref_h[0][k][:, 2:, 0], rtol=1e-6,
                                       err_msg=k)
            if "attn" in k and "['o']" not in k:
                np.testing.assert_allclose(got_h[0][k][0, 0, 0],
                                           ref_h[0][k][0, 0, 0], rtol=1e-6,
                                           err_msg=k)
        err = per_step((got_m, got_h), refs[ref_be])
        assert np.all(err <= 2 * envelope), (backend, err, envelope)


@pytest.mark.parametrize("backend", ["einsum", "cuda"])
def test_fp8_loss_scale_is_exact(backend):
    """A power-of-two loss scale multiplies dy, its amax and its delayed
    scale by the same power of two, so the fp8 payloads, the gradients
    after unscaling and every update are bit-identical to an unscaled run:
    after three fp8 steps of the smoke LM at loss scale 128 and at 1, the
    losses, grad norms and parameters are equal and only row 1 of each
    amax history (``amax(dy)``) differs, by exactly 128.  This holds the
    history's loss-scaled row, where fp8 chaos hides it from a comparison
    with the reference."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(
        vocab=tbase.get("paper_atis_tt").smoke().vocab, seq_len=16,
        global_batch=4))
    batches = [data.batch(s_) for s_ in range(3)]
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=4)
    m128, _, p128 = _port_fp8_train(batches, backend, loss_scale=128.0, **kw)
    m1, _, p1 = _port_fp8_train(batches, backend, loss_scale=1.0, **kw)
    np.testing.assert_array_equal(m128, m1)
    hists = [n for n in p1 if n.endswith("quant_amax")]
    assert len(hists) == 14
    for name, t in p1.items():
        got = p128[name].detach()
        if name in hists:
            assert torch.all(t[1, :3] > 0), name
            assert torch.equal(got[1], t[1].detach() * 128), name
            got = torch.cat([got[:1], got[2:]])
            t = torch.cat([t[:1], t[2:]])
        assert torch.equal(got, t.detach()), name
