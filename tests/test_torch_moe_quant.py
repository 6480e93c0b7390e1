"""Quantized MoE experts in the port against the JAX reference.

The reference vmaps its quantized ``TensorizedLinear`` over a MoE's
experts (cores and amax history on axis 0) and, outside that, over the
token groups (parameters broadcast), so each (expert, group) instance
runs the layer at batch C with its own per-tensor scales; the port runs
all ``E * G`` instances in one launch a plan op.  The same numpy inputs
go through both packages, at smoke size with ``G >= 2``; the reference's
plans are searched with the port's H100 model (as in
``tests/test_torch_precision.py``), the reference's Pallas kernels run in
interpret mode.  Tolerances, with the reason for each:

* the batched plain versions (``kernels/ref.py``) and the wrappers on the
  CPU: bit for bit a loop of the unbatched forms;
* the quantized expert layer (output, dX, core gradients): fp8 execution
  is chaotic at f32 roundoff (a flipped requantize rounding moves one
  instance's result by a quantization step, ~6% in e4m3; the reference's
  vmapped and unvmapped routes differ so on the same inputs), so each
  is held within three times the envelope the reference opens between
  its cores (or its input) scaled by ``1 ± 2**-22`` / ``1 ± 2**-21`` and
  unscaled, plus 1e-5 of the scale (``train_fp8_parity``'s rule);
* the amax history after AdamW's passthrough: bit for bit (the amaxes
  of x, dY and the cores precede every quantization), and equal to the
  sum over groups of each group's rolled window less ``G - 1`` times the
  old one;
* three fp8/int8 train steps of ``olmoe_1b_7b --smoke`` (loss scale
  128): every step's loss, grad norm and written amaxes within three
  times the envelope of ``1 ± 2**-22`` / ``1 ± 2**-21`` weight nudges on
  either reference backend, plus 1e-6; exact (1e-6) where nothing
  quantized comes before (the cores' amaxes at step 0);
* the bf16-precision quantized stash: logits 1e-5 and gradients 4e-5 of
  each leaf's scale (``tests/test_torch_moe.py``'s), since a stash pinned
  to the same per-instance scale reconstructs the same activation;
* convert, checkpoints and the planner: exact.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import memory as jmemory  # noqa: E402
from repro import precision as jprec  # noqa: E402
from repro.checkpoint import store as jstore  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.core import csse as jcsse  # noqa: E402
from repro.core import factorizations as jF  # noqa: E402
from repro.core import perf_model as jperf  # noqa: E402
from repro.core import tensorized as jtz  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models.lm import LM as JLM  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW  # noqa: E402
from repro_torch import memory  # noqa: E402
from repro_torch import precision as prec  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import params_from_numpy, to_numpy_tree  # noqa: E402
from repro_torch.core import contraction, csse, perf_model  # noqa: E402
from repro_torch.core import factorizations as F  # noqa: E402
from repro_torch.core import plan_compiler, tensorized  # noqa: E402
from repro_torch.kernels import fused_contraction as fc  # noqa: E402
from repro_torch.kernels import quantized as qk  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.optim.adamw import AdamW, OptState  # noqa: E402

QUANT = ["fp8_e4m3", "fp8_e5m2", "int8"]
#: experts, groups, slots per group: the layer tests' instance batch
E, G, C = 3, 2, 16
NUDGES = (2.0 ** -22, -2.0 ** -22, 2.0 ** -21, -2.0 ** -21)


def _bits(t) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


@pytest.fixture
def h100_plans(monkeypatch):
    """The reference's plans searched with the port's H100 model."""
    hw = jperf.HardwareModel(**dataclasses.asdict(perf_model.H100_SXM))
    orig = jtz._plans
    monkeypatch.setattr(jtz, "_plans",
                        lambda fact, batch, opts, hw_=None:
                        orig(fact, batch, opts, hw))


# ---------------------------------------------------------------------------
# The batched plain versions: a loop of the unbatched ones
# ---------------------------------------------------------------------------


def _instance_case(dtype, seed, m, k, n, trans=False):
    """fp8/int8 operands of the instance batch: x per (expert, group),
    W per expert (broadcast over the groups, stride 0), and one scale
    per instance (x's) or per expert (W's, broadcast)."""
    pol = prec.QuantPolicy.parse(dtype)
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(E, G, m, k, generator=gen) * 3
    w = torch.randn((E,) + ((n, k) if trans else (k, n)), generator=gen)
    qx = prec.quantize(x, pol, lead=2)
    qw = prec.quantize(w, pol, lead=1)
    wb = qw.q.unsqueeze(1).expand(E, G, *qw.q.shape[1:])
    return qx, qw, wb, qw.scale.unsqueeze(1).expand(E, G)


@pytest.mark.parametrize("dtype", QUANT)
@pytest.mark.parametrize("trans", [False, True])
def test_batched_plain_scaled_gemm_is_a_loop(dtype, trans):
    qx, qw, wb, sr = _instance_case(dtype, 1, 16, 24, 8, trans)
    got = ref.matmul_scaled(qx.q, wb, qx.scale, sr, transpose_rhs=trans)
    wrapped = fc.matmul_cuda(qx.q, wb, transpose_rhs=trans,
                             scales=(qx.scale, sr))
    assert tuple(got.shape) == (E, G, 16, 8)
    for e in range(E):
        for g in range(G):
            want = ref.matmul_scaled(
                qx.q[e, g], qw.q[e],
                qx.scale[e, g].reshape(1, 1).expand(16, 1),
                qw.scale[e].reshape(1, 1).expand(1, 8), transpose_rhs=trans)
            np.testing.assert_array_equal(got[e, g].numpy(), want.numpy())
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())


@pytest.mark.parametrize("dtype", QUANT)
def test_batched_plain_scaled_chain_is_a_loop(dtype):
    pol = prec.QuantPolicy.parse(dtype)
    qx, qw0, w0b, s0 = _instance_case(dtype, 2, 32, 24, 4)
    gen = torch.Generator().manual_seed(3)
    qw1 = prec.quantize(torch.randn(E, 8, 6, generator=gen), pol, lead=1)
    qw2 = prec.quantize(torch.randn(E, 12, 5, generator=gen), pol, lead=1)
    ws = [w0b] + [w.q.unsqueeze(1).expand(E, G, *w.q.shape[1:])
                  for w in (qw1, qw2)]
    scales = (qx.scale * s0, qw1.scale[:, None].expand(E, G),
              qw2.scale[:, None].expand(E, G))
    got = ref.chain_n_scaled(qx.q, ws, scales)
    wrapped = fc.chain_n_cuda(qx.q, ws, scales=scales)
    for e in range(E):
        for g in range(G):
            want = ref.chain_n_scaled(
                qx.q[e, g], [w[e, g] for w in ws],
                (scales[0][e, g].reshape(1, 1).expand(32, 1),
                 scales[1][e, g].reshape(1, 1),
                 scales[2][e, g].reshape(1, 1).expand(1, 5)))
            np.testing.assert_array_equal(got[e, g].numpy(), want.numpy())
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())


@pytest.mark.parametrize("dtype", QUANT)
def test_chain_readback_agreement_passes_the_plain_chain_only(dtype):
    """``ref.chain_readback_agreement``, the batched scaled chain's rule
    on the card, passes the plain version read back as it reads the
    kernel (the wrapper on the CPU), and fails a chain that keeps its
    intermediates in f32 (the bf16 rounding skipped)."""
    pol = prec.QuantPolicy.parse(dtype)
    qx, _, w0b, s0 = _instance_case(dtype, 5, 64, 48, 8)
    gen = torch.Generator().manual_seed(6)
    qw1 = prec.quantize(torch.randn(E, 16, 8, generator=gen), pol, lead=1)
    ws = [w0b, qw1.q.unsqueeze(1).expand(E, G, 16, 8)]
    scales = (qx.scale * s0, qw1.scale[:, None].expand(E, G))

    def f32_chain(x, links, scales):
        h = torch.matmul(x.float(), links[0].float()) \
            * scales[0][..., None, None]
        h = h.reshape(x.shape[:-2] + (-1, links[1].shape[-2]))
        return torch.matmul(h, links[1].float()) * scales[1][..., None, None]

    good, nums = ref.chain_readback_agreement(fc.chain_n_cuda, qx.q, ws,
                                              scales)
    assert good and nums["intermediates_off"] == 0, nums
    good, nums = ref.chain_readback_agreement(f32_chain, qx.q, ws, scales)
    assert not good and nums["intermediates_off_share_max"] > 0.5, nums


@pytest.mark.parametrize("dtype", QUANT)
def test_batched_quantize_dequantize_requantize_are_a_loop(dtype):
    """One amax and scale per instance, each what the per-tensor forms
    give that instance alone; the per-row form of B5/B6 on the
    ``[I, numel / I]`` view (the plan compiler's call) gives the same
    bits; a permuted result requantizes in place."""
    pol = prec.QuantPolicy.parse(dtype)
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(E, G, 6, 10, generator=gen) * torch.linspace(
        0.1, 8, E * G).reshape(E, G, 1, 1)
    q, s = ref.requantize(x, pol, lead=2)
    q2, s2 = qk.requantize_cuda(x, pol, 2)
    xp = x.permute(0, 1, 3, 2)
    qp, sp = qk.requantize_cuda(xp, pol, 2)
    inter = dataclasses.replace(pol, granularity="tensor")
    qt = prec.quantize(x, inter, lead=2)
    deq = ref.dequantize(q, s, lead=2)
    rows = qk.quantize_cuda(x.reshape(E * G, -1), s.reshape(-1, 1), pol)
    back = qk.dequantize_cuda(rows, s.reshape(-1, 1))
    for e in range(E):
        for g in range(G):
            wq, ws = ref.requantize(x[e, g], pol)
            for got_q, got_s in ((q, s), (q2, s2), (qt.q, qt.scale)):
                np.testing.assert_array_equal(_bits(got_q[e, g]), _bits(wq))
                assert got_s[e, g].item() == ws.item()
            np.testing.assert_array_equal(_bits(qp[e, g]),
                                          _bits(wq.transpose(0, 1)))
            assert sp[e, g].item() == ws.item()
            np.testing.assert_array_equal(
                _bits(ref.quantize(x[e, g], ws, pol)), _bits(wq))
            np.testing.assert_array_equal(
                deq[e, g].numpy(), ref.dequantize(wq, ws).numpy())
    np.testing.assert_array_equal(_bits(rows), _bits(q.reshape(E * G, -1)))
    np.testing.assert_array_equal(back.numpy(),
                                  deq.reshape(E * G, -1).numpy())


# ---------------------------------------------------------------------------
# The quantized expert layer against the reference's vmapped layer
# ---------------------------------------------------------------------------


def _expert_layers(dtype, backend):
    """The reference's quantized layer (vmapped over experts, then over
    groups) and the port's expert-stacked one, same factorization."""
    jfact, fact = jF.make("tt", (4, 16), (8, 8), 8), F.make(
        "tt", (4, 16), (8, 8), 8)
    jl = jtz.TensorizedLinear(
        fact=jfact, compute_dtype=jnp.float32,
        opts=jcsse.SearchOptions(fused_chain=True),
        precision=jprec.QuantPolicy.parse(dtype),
        backend="pallas" if backend == "cuda" else "einsum")
    tl = tensorized.TensorizedLinear(
        fact, compute_dtype=torch.float32,
        opts=csse.SearchOptions(fused_chain=True),
        precision=prec.QuantPolicy.parse(dtype), num_experts=E,
        backend=backend)
    return jl, tl


def _layer_inputs(jfact, seed=3):
    rng = np.random.default_rng(seed)
    cores = [0.5 * rng.standard_normal((E,) + tuple(jfact.core_shape(i)))
             .astype(np.float32) for i in range(jfact.num_cores)]
    # expert 1 carries one step of history, the others bootstrap
    hist = np.zeros((E, 2 + len(cores), 16), np.float32)
    hist[1, :, 0] = 3 * np.abs(rng.standard_normal(2 + len(cores)))
    x = rng.standard_normal((G, E, C, jfact.N)).astype(np.float32)
    dy = rng.standard_normal((G, E, C, jfact.M)).astype(np.float32)
    return cores, hist, x, dy


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("backend", ["einsum", "cuda"])
@pytest.mark.parametrize("dtype", QUANT)
def test_quantized_expert_layer_matches_reference(dtype, backend,
                                                  h100_plans):
    """Forward and one backward on ``[G, E, C, D]``: the port's einsum
    backend against the reference's einsum, its cuda backend (the plain
    versions, fused chains with bf16 intermediates) against the
    reference's pallas.  The history after AdamW's passthrough shows the
    sum-over-groups rule."""
    jl, tl = _expert_layers(dtype, backend)
    cores, hist, x, dy = _layer_inputs(jl.fact)
    layer = jax.vmap(jax.vmap(jl, in_axes=(0, 0)), in_axes=(None, 0))

    @jax.jit
    def ref_run(cs, h, xx):
        params = {"cores": cs, "quant_amax": h}
        y, vjp = jax.vjp(layer, params, xx)
        dp, dx = vjp(jnp.asarray(dy))
        return y, dx, dp["cores"], dp["quant_amax"]

    def run_ref(c_scale=1.0, x_scale=1.0):
        out = ref_run(tuple(jnp.asarray(c * np.float32(c_scale))
                            for c in cores), jnp.asarray(hist),
                      jnp.asarray(x * np.float32(x_scale)))
        return [np.asarray(out[0]), np.asarray(out[1]),
                *map(np.asarray, out[2]), np.asarray(out[3])]

    want = run_ref()
    env = np.max([[_rel(a, b) for a, b in zip(run, want)]
                  for n in NUDGES for run in (run_ref(1 + n),
                                              run_ref(1, 1 + n))], axis=0)
    with torch.no_grad():
        for c, a in zip(tl.cores, cores):
            c.copy_(torch.from_numpy(a))
        tl.quant_amax.copy_(torch.from_numpy(hist))
    xt = torch.from_numpy(x).transpose(0, 1).requires_grad_(True)
    y = tl(xt)
    y.backward(torch.from_numpy(dy).transpose(0, 1))
    got = [y.detach().transpose(0, 1).numpy(),
           xt.grad.transpose(0, 1).numpy(),
           *[c.grad.numpy() for c in tl.cores]]
    for i, (a, b) in enumerate(zip(got, want)):
        assert _rel(a, b) <= 3 * env[i] + 1e-5, (i, _rel(a, b), env[i])
    new = hist - tl.quant_amax.grad.numpy()
    np.testing.assert_array_equal(new, hist - want[-1])
    # sum over groups: slot 0 of x's row sums the groups' amaxes for the
    # experts bootstrapping; the older slots are G * hist[k - 1] - (G - 1)
    # * hist[k]
    amax_x = np.abs(x).max(axis=(2, 3))                    # [G, E]
    for e in (0, 2):
        assert new[e, 0, 0] == np.float32(amax_x[:, e].sum())
        assert not new[e, :, 1:].any()
    np.testing.assert_allclose(new[1, :, 1], G * hist[1, :, 0], rtol=1e-6)
    np.testing.assert_allclose(new[1, :, 2:], 0.0)


def test_expert_plans_launch_once_per_op_on_the_cpu(monkeypatch):
    """On the CPU the plain versions run, but the quantized expert layer
    calls each wrapper once per plan op for every (expert, group)
    instance: GEMMs and chains with batched operands, the quantize
    wrapper once per >= 2-D input node and the dequantize wrapper once
    per plan, never once per instance."""
    calls = {"gemm": [], "chain": [], "quantize": 0, "dequantize": 0}
    real = {n: getattr(plan_compiler, n) for n in (
        "matmul_cuda", "chain_n_cuda", "quantize_cuda", "dequantize_cuda")}

    def mm(x, w, **kw):
        calls["gemm"].append(x.dim())
        return real["matmul_cuda"](x, w, **kw)

    def chain(x, ws, **kw):
        calls["chain"].append(x.dim())
        return real["chain_n_cuda"](x, ws, **kw)

    def count(name):
        def f(*a, **k):
            calls[name.split("_")[0]] += 1
            return real[name](*a, **k)
        return f

    monkeypatch.setattr(plan_compiler, "matmul_cuda", mm)
    monkeypatch.setattr(plan_compiler, "chain_n_cuda", chain)
    monkeypatch.setattr(plan_compiler, "quantize_cuda",
                        count("quantize_cuda"))
    monkeypatch.setattr(plan_compiler, "dequantize_cuda",
                        count("dequantize_cuda"))
    _, tl = _expert_layers("fp8_e4m3", "cuda")
    x = torch.randn(E, G, C, tl.fact.N, requires_grad=True)
    tl(x).sum().backward()
    ops, inputs, plans = 0, 0, 0
    for results in tensorized.phase_plans(tl.fact, C, tl.opts).values():
        for r in results:
            compiled = plan_compiler.compile_cached(
                r.plan, fuse=tl.opts.fused_chain,
                max_chain_len=tl.opts.max_chain_len, policy=tl.precision)
            ops += sum(not isinstance(op, plan_compiler.EinsumOp)
                       for op in compiled.ops)
            inputs += r.plan.network.num_nodes
            plans += 1
    assert len(calls["gemm"]) + len(calls["chain"]) == ops
    assert calls["chain"] and all(d in (3, 4) for d in calls["gemm"]
                                  + calls["chain"])
    assert 4 in calls["gemm"] + calls["chain"]
    assert calls["quantize"] == inputs and calls["dequantize"] == plans


def test_tile_scales_on_experts_are_refused():
    arch = tbase.get("olmoe_1b_7b")
    with pytest.raises(NotImplementedError, match="item 15"):
        steps.build_model(arch, dataclasses.replace(
            arch.tnn_default,
            precision=prec.QuantPolicy.parse("fp8:tile")),
            smoke=True, device="cpu")


# ---------------------------------------------------------------------------
# The smoke LM: fp8 train steps, the quantized stash, microbatches
# ---------------------------------------------------------------------------


def _jtnn(backend, precision="fp8", remat="store"):
    jarch = jbase.get("olmoe_1b_7b")
    return dataclasses.replace(
        jarch.tnn_default, backend=backend, remat=remat,
        precision=jprec.QuantPolicy.parse(precision))


def _ttnn(backend, precision="fp8", remat="store"):
    arch = tbase.get("olmoe_1b_7b")
    return dataclasses.replace(
        arch.tnn_default, backend=backend, remat=remat,
        precision=prec.QuantPolicy.parse(precision))


def _hists(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat
            if "quant_amax" in jax.tree_util.keystr(k)}


def _port_train(tree, batches, backend, kw, precision="fp8"):
    arch = tbase.get("olmoe_1b_7b")
    model, cfg = steps.build_model(arch, tnn=_ttnn(backend, precision),
                                   smoke=True,
                                   device="cpu", backend=backend,
                                   compute_dtype=torch.float32)
    model.load_state_dict(params_from_numpy(tree, cfg))
    opt = AdamW(**kw)
    params = dict(model.named_parameters())
    state = {"params": params, "opt": opt.init(params)}
    step = steps.make_train_step(model, opt)
    out, hists = [], []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        out.append((float(m["loss"]), float(m["grad_norm"])))
        hists.append(_hists(to_numpy_tree(state["params"], cfg)))
    return np.asarray(out), hists


@pytest.mark.parametrize("dtype", QUANT)
def test_fp8_train_steps_track_the_reference(dtype, h100_plans):
    """Three fp8/int8 steps (loss scale 128) of ``olmoe_1b_7b --smoke`` from
    the same weights, batch 2 (G = 2 token groups): the port's einsum
    backend against the reference's jitted ``make_train_step`` on
    einsum, its cuda backend against the reference's on pallas, each
    within three times the envelope that weights scaled by ``1 ±
    2**-22`` or ``1 ± 2**-21`` open on either reference backend.
    The stacked ``[L, E, 2 + n, 16]`` histories: the cores' amaxes of
    step 0 within 1e-6, every written slot within the envelope rule,
    and slots not yet written zero.  With G = 2 a slot past 0 holds ``2
    * h[k - 1] - h[k]`` (the sum-over-groups rule), which may be zero or
    negative where consecutive amaxes are close."""
    jarch = jbase.get("olmoe_1b_7b")
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=4, loss_scale=128.0)
    jopt = JAdamW(**kw)
    rng = np.random.default_rng(0)
    tree, batches, jstep = None, None, {}
    for be in ("einsum", "pallas"):
        jcfg = dataclasses.replace(jarch.smoke(_jtnn(be, dtype)),
                                   compute_dtype=jnp.float32)
        jm = JLM(jcfg)
        if tree is None:
            tree = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
            tree = jax.tree_util.tree_map_with_path(
                lambda p, a: (a + 0.1 * rng.standard_normal(a.shape)).astype(
                    np.float32) if "scale" in jax.tree_util.keystr(p)
                else np.asarray(a, np.float32), tree)
            data = jpipeline.SyntheticLM(jpipeline.DataConfig(
                vocab=jcfg.vocab, seq_len=16, global_batch=2))
            batches = [data.batch(s_) for s_ in range(3)]
        jstep[be] = jax.jit(jsteps.make_train_step(jm, jopt,
                                                   jblocks.no_shard))

    def reference(be, nudge=0.0):
        p = jax.tree_util.tree_map_with_path(
            lambda k, a: jnp.asarray(a if "quant_amax" in
                                     jax.tree_util.keystr(k)
                                     else (a * np.float32(1 + nudge))
                                     .astype(np.float32)), tree)
        st = {"params": p, "opt": jopt.init(p)}
        out, hs = [], []
        for b in batches:
            st, m = jstep[be](st, {k: jnp.asarray(v) for k, v in b.items()})
            out.append((float(m["loss"]), float(m["grad_norm"])))
            hs.append(_hists(st["params"]))
        return np.asarray(out), hs

    def per_step(a, b):
        """[steps, 3]: relative loss and grad norm, and the largest
        difference of a written history slot relative to its leaf's
        written scale (a slot past 0 holds ``2 * h[k - 1] - h[k]``, a
        difference that can sit near zero)."""
        (ma, ha), (mb, hb) = a, b
        rows = []
        for s_ in range(len(batches)):
            h = max(_rel(ha[s_][k][..., :s_ + 1], hb[s_][k][..., :s_ + 1])
                    for k in hb[s_])
            rows.append((abs(ma[s_, 0] - mb[s_, 0]) / abs(mb[s_, 0]),
                         abs(ma[s_, 1] - mb[s_, 1]) / abs(mb[s_, 1]), h))
        return np.asarray(rows)

    refs = {be: reference(be) for be in jstep}
    env = np.max([per_step(reference(be, n), refs[be])
                  for be in refs for n in NUDGES], axis=0)
    for backend, ref_be in (("einsum", "einsum"), ("cuda", "pallas")):
        got = _port_train(tree, batches, backend, kw, dtype)
        assert np.all(np.isfinite(got[0]))
        want_h, got_h = refs[ref_be][1], got[1]
        assert got_h[0].keys() == want_h[0].keys() and len(got_h[0]) == 3
        for k, h in got_h[-1].items():
            assert h.ndim == 4 and h.shape[1] == 4, k       # [L, E, ., 16]
            assert np.all(h[..., 0] > 0) and not h[..., 3:].any(), k
            np.testing.assert_allclose(got_h[0][k][:, :, 2:, 0],
                                       want_h[0][k][:, :, 2:, 0],
                                       rtol=1e-6, err_msg=k)
        err = per_step(got, refs[ref_be])
        assert np.all(err <= 3 * env + 1e-6), (backend, err, env)


def test_microbatch_histories_take_the_min_rule():
    """Two microbatches of one group each, one tiny and one large: each
    expert's stacked history records the larger microbatch's window
    (the delta's minimum), never their sum."""
    arch = tbase.get("olmoe_1b_7b")
    cfg_kw = dict(smoke=True, device="cpu", backend="cuda",
                  compute_dtype=torch.float32)
    model, cfg = steps.build_model(arch, tnn=_ttnn("cuda"), **cfg_kw)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (2, 17)).astype(np.int64)
    batch = {"inputs": torch.from_numpy(toks[:, :-1]),
             "targets": torch.from_numpy(toks[:, 1:])}

    def run(b, microbatches):
        model.load_state_dict(sd)
        opt = AdamW(lr=1e-3, warmup_steps=0, total_steps=4)
        params = dict(model.named_parameters())
        state, _ = steps.make_train_step(model, opt, microbatches)(
            {"params": params, "opt": opt.init(params)}, b)
        return {n: p.detach().clone() for n, p in state["params"].items()
                if n.endswith("quant_amax")}

    both = run(batch, 2)
    alone = [run({k: v[i:i + 1] for k, v in batch.items()}, 1)
             for i in range(2)]
    assert len(both) == 6
    for n, h in both.items():
        assert tuple(h.shape) == (4, 6, 16), n
        np.testing.assert_array_equal(
            h.numpy(), torch.maximum(alone[0][n], alone[1][n]).numpy())


def test_quantized_stash_under_bf16_precision_matches_reference():
    """``remat="quantized"`` with bf16 precision: each (expert, group)
    instance stashes with its own amax and scale, as the reference's
    vmapped stash; logits, loss and gradients against the reference."""
    arch_id = "olmoe_1b_7b"
    jarch = jbase.get(arch_id)
    jtnn = dataclasses.replace(jarch.tnn_default, remat="quantized")
    jm = JLM(dataclasses.replace(jarch.smoke(jtnn),
                                 compute_dtype=jnp.float32))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(1)))
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jm.cfg.vocab, (2, 17)).astype(np.int32)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    jparams = jax.tree.map(jnp.asarray, tree)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jparams)
    arch = tbase.get(arch_id)
    model, cfg = steps.build_model(
        arch, tnn=dataclasses.replace(arch.tnn_default, remat="quantized"),
        smoke=True, device="cpu", backend="cuda",
        compute_dtype=torch.float32)
    model.load_state_dict(params_from_numpy(tree, cfg))
    assert model.layers[0].mlp.experts["gate"].remat.quantized
    loss, _ = model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    got = to_numpy_tree({n: p.grad for n, p in model.named_parameters()},
                        cfg)

    def close(path, g, w):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g, w, rtol=0, atol=4e-5 * max(float(np.abs(w).max()), 1e-30),
            err_msg=jax.tree_util.keystr(path))
    jax.tree_util.tree_map_with_path(close, got, jgrads)


# ---------------------------------------------------------------------------
# Convert, checkpoints and the planner with the stacked histories
# ---------------------------------------------------------------------------


def test_convert_and_checkpoints_carry_the_expert_histories(tmp_path):
    """The reference's ``[L, E, 2 + n, H]`` history leaves convert to
    ``layers.<l>.mlp.experts.<p>.quant_amax`` ``[E, 2 + n, H]`` and back
    unchanged, the optimizer passes them through, and a checkpoint
    written by either package restores in the other leaf for leaf."""
    jarch, arch = jbase.get("olmoe_1b_7b"), tbase.get("olmoe_1b_7b")
    jm = JLM(jarch.smoke(_jtnn("einsum")))
    cfg = arch.smoke(_ttnn("einsum"))
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    rng = np.random.default_rng(6)
    p = jax.tree.map(lambda s: np.abs(rng.standard_normal(s.shape))
                     .astype(np.float32), shapes)
    sd = params_from_numpy(p, cfg)
    names = [n for n in sd if n.endswith("quant_amax")]
    assert len(names) == 3 * cfg.num_layers
    assert tuple(sd["layers.1.mlp.experts.down.quant_amax"].shape) == (
        4, 6, 16)
    assert all(AdamW.is_amax(n) for n in names)
    jax.tree.map(np.testing.assert_array_equal, to_numpy_tree(sd, cfg), p)
    model = steps.build_model(arch, tnn=_ttnn("einsum"), smoke=True,
                              device="cpu")[0]
    model.load_state_dict(sd)
    for n in names:
        assert torch.equal(model.state_dict()[n], sd[n])
    zeros = {n: torch.zeros_like(t) for n, t in sd.items()}
    state = {"params": sd, "opt": OptState(
        m=zeros, v=zeros, step=torch.tensor(3, dtype=torch.int32),
        master=None)}
    store.save(str(tmp_path / "port"), 3, state)
    jtemplate = {"params": jax.tree.map(jnp.zeros_like, p),
                 "opt": JAdamW().init(jax.tree.map(jnp.zeros_like, p))}
    step, got = jstore.restore(str(tmp_path / "port"), jtemplate)
    assert step == 3
    jax.tree.map(np.testing.assert_array_equal,
                 jax.tree.map(np.asarray, got["params"]), p)
    jstore.save(str(tmp_path / "ref"), 4, {
        "params": jax.tree.map(jnp.asarray, p),
        "opt": JAdamW().init(jax.tree.map(jnp.asarray, p))})
    empty = {"params": {n: torch.zeros_like(t) for n, t in sd.items()},
             "opt": OptState(m=dict(zeros), v=dict(zeros),
                             step=torch.tensor(0, dtype=torch.int32),
                             master=None)}
    step, back = store.restore(str(tmp_path / "ref"), empty)
    assert step == 4
    for n in names:
        np.testing.assert_array_equal(back["params"][n].numpy(),
                                      sd[n].numpy())


@pytest.mark.parametrize("remat", ["store", "quantized", "quantized:int8"])
def test_planner_prices_the_expert_stash_as_the_reference(remat):
    jcfg = jbase.get("olmoe_1b_7b").smoke(_jtnn("einsum", remat=remat))
    cfg = tbase.get("olmoe_1b_7b").smoke(_ttnn("einsum", remat=remat))
    for mb in (1, 2):
        got = memory.stash_report(cfg, 8, 128, mb, cfg.tnn.stash_policy())
        want = jmemory.stash_report(jcfg, 8, 128, mb,
                                    jcfg.tnn.stash_policy())
        assert [(s.name, s.elems_per_token) for s in got.sites] == [
            (s.name, s.elems_per_token) for s in want.sites]
        assert got.peak_bytes == want.peak_bytes
        assert got.describe() == want.describe()


def test_contraction_execute_takes_the_group_axis_on_both_backends():
    """``contraction.execute(..., batch=E, groups=G)`` on every plan of
    a quantized expert layer equals, on either backend, one unbatched
    run per instance (its cores its expert's), bit for bit: the same
    per-tensor scales and the same ops, instance by instance."""
    _, tl = _expert_layers("fp8_e4m3", "cuda")
    pol = tl.precision
    gen = torch.Generator().manual_seed(9)
    for phase, results in tensorized.phase_plans(tl.fact, C,
                                                 tl.opts).items():
        for r in results:
            net = r.plan.network
            grouped = [net.node_names[i] in ("X", "dY", "dW")
                       for i in range(net.num_nodes)]
            ts = [torch.randn(((E, G) if gr else (E,)) + net.node_shape(i),
                              generator=gen)
                  for i, gr in enumerate(grouped)]
            for backend in ("einsum", "cuda"):
                want = torch.stack([torch.stack([contraction.execute(
                    r.plan, [t[e, g] if gr else t[e]
                             for t, gr in zip(ts, grouped)],
                    backend=backend, policy=pol) for g in range(G)])
                    for e in range(E)])
                got = contraction.execute(r.plan, ts, backend=backend,
                                          policy=pol, batch=E, groups=G)
                assert got.shape == want.shape, (phase, backend)
                np.testing.assert_array_equal(got.numpy(), want.numpy(),
                                              err_msg=f"{phase} {backend}")
