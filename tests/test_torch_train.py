"""Port training path vs the JAX reference on the same numpy inputs.

* ``TensorizedLinear``'s autograd Function: dx and every core gradient
  for TT/TTM/TR/HT/BT, on the einsum and cuda backends (the kernels' plain
  versions on the CPU), with each WG strategy forced, against ``jax.grad``
  through the reference's custom VJP, f32 within 1e-4 of each gradient's
  scale (the two packages may contract in other orders).
* The port's ``_plans`` picks the reference's FP/BP/WG trees and WG
  strategy under the same (H100) hardware model, up to the full ATIS
  widths.
* The smoke LM in f32 with ``targets = ("mlp", "qkv", "out")``: loss
  within 1e-5 and every gradient within 1e-4 of its scale; ``remat`` gives
  bit-identical gradients.
* Three steps of ``make_train_step`` + AdamW against the reference's
  jitted ``make_train_step``: loss within 1e-5, lr within 1e-6 and the
  grad norm within 1e-4 (gradients agree to ~4e-5 of their leaf's scale,
  the f32 roundoff of two contraction orders through two layers); the
  first moments within 1e-4 and the second (squares) within 2e-4 of their
  scale; updated parameters within 1e-5 of their scale, including the
  per-layer norm scales the reference decays.  In the embedding, the
  elements whose reference gradient is zero or above 1e-3 of the step's
  largest at every step are held to the same 1e-5; the rest sit at the
  f32 noise floor, where Adam's sign-like step may go either way, and
  are held to twice the summed learning rates.
* ``SyntheticLM`` batches are bit-equal; the train CLI runs on the CPU
  (with ``--tnn-precision``, a quantized ``--tnn-remat``,
  ``--tnn-memory-budget``, ``--ckpt-dir`` and ``--ckpt-every`` too) and
  refuses the flags it has not ported.
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

from repro.configs import base as jbase  # noqa: E402
from repro.distributed import fault_tolerance as jft  # noqa: E402
from repro.core import csse as jcsse  # noqa: E402
from repro.core import factorizations as jF  # noqa: E402
from repro.core import perf_model as jperf  # noqa: E402
from repro.core import tensorized as jtensorized  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models.lm import LM as JLM  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    params_from_numpy, reference_ndim, to_numpy_tree,
)
from repro_torch.core import contraction, csse, perf_model  # noqa: E402
from repro_torch.core import factorizations as F  # noqa: E402
from repro_torch.core import plan_compiler, tensorized  # noqa: E402
from repro_torch.core.tnetwork import TensorNetwork  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.distributed import fault_tolerance as ft  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402

SPECS = {
    "tt": ((4, 4, 4), (4, 4, 4), 6),
    "ttm": ((4, 4, 4), (4, 4, 4), 6),
    "tr": ((4, 4), (4, 4), 5),
    "ht": ((4, 4, 2), (4, 2, 4), 3),
    "bt": ((4, 4), (4, 4), 3),
}
TARGETS = ("mlp", "qkv", "out")


def _jax_hw():
    return jperf.HardwareModel(**dataclasses.asdict(perf_model.H100_SXM))


def _close(got, want, rel, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()),
                                              1e-30), err_msg=what)


# ---------------------------------------------------------------------------
# TensorizedLinear gradients
# ---------------------------------------------------------------------------


def _forced_plans(kind):
    """``tensorized._plans`` with the WG strategy forced to ``kind``."""
    orig = tensorized._plans

    def plans(fact, batch, opts, hw=perf_model.H100_SXM):
        fp, bp, _ = orig(fact, batch, opts, hw)
        if kind == "shared":
            dw = csse.search(tensorized._dw_network(fact, batch), opts, hw)
            wg = tuple(csse.search(tensorized._wg_from_dw_network(fact, i),
                                   opts, hw) for i in range(fact.num_cores))
            return fp, bp, ("shared", dw, wg)
        wg = tuple(csse.search(tensorized._wg_network(fact, batch, i), opts,
                               hw) for i in range(fact.num_cores))
        return fp, bp, ("indep", None, wg)

    return plans


_LAYER_INPUTS = {}


def _layer_reference(method):
    """Seeded cores, bias, x and dy, and the reference's gradients."""
    if method not in _LAYER_INPUTS:
        out, inp, rank = SPECS[method]
        jfact = jF.make(method, out, inp, rank)
        rng = np.random.default_rng(len(method))
        cores = [0.5 * rng.standard_normal(jfact.core_shape(i)).astype(
            np.float32) for i in range(jfact.num_cores)]
        bias = rng.standard_normal(jfact.M).astype(np.float32)
        x = rng.standard_normal((3, 5, jfact.N)).astype(np.float32)
        dy = rng.standard_normal((3, 5, jfact.M)).astype(np.float32)
        jlayer = jtensorized.TensorizedLinear(
            fact=jfact, use_bias=True,
            opts=jcsse.SearchOptions(fused_chain=True),
            compute_dtype=jnp.float32, backend="einsum")

        def loss(params, x):
            return jnp.sum(jlayer(params, x) * jnp.asarray(dy))

        params = {"cores": tuple(jnp.asarray(c) for c in cores),
                  "bias": jnp.asarray(bias)}
        gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
        _LAYER_INPUTS[method] = (cores, bias, x, dy, gp, gx)
    return _LAYER_INPUTS[method]


@pytest.mark.parametrize("wg", ["shared", "indep"])
@pytest.mark.parametrize("backend", ["einsum", "cuda"])
@pytest.mark.parametrize("method", sorted(SPECS))
def test_layer_grads_match_reference(method, backend, wg, monkeypatch):
    cores, bias, x, dy, gp, gx = _layer_reference(method)
    out, inp, rank = SPECS[method]
    layer = tensorized.TensorizedLinear(
        F.make(method, out, inp, rank), use_bias=True,
        opts=csse.SearchOptions(fused_chain=True),
        compute_dtype=torch.float32, backend=backend, device="cpu")
    with torch.no_grad():
        for p, c in zip(layer.cores, cores):
            p.copy_(torch.from_numpy(c))
        layer.bias.copy_(torch.from_numpy(bias))
    monkeypatch.setattr(tensorized, "_plans", _forced_plans(wg))
    tx = torch.from_numpy(x).requires_grad_()
    (layer(tx) * torch.from_numpy(dy)).sum().backward()
    _close(tx.grad.numpy(), gx, 1e-4, "dx")
    for i, (p, want) in enumerate(zip(layer.cores, gp["cores"])):
        _close(p.grad.numpy(), want, 1e-4, f"dcore{i}")
    _close(layer.bias.grad.numpy(), gp["bias"], 1e-5, "dbias")


def test_phase_paths_false_refuses_training_but_serves():
    """``phase_paths=False`` serves and now trains (autodiff through the
    FP plan); only its quantized form still refuses a gradient."""
    tnn = tensorized.TNNConfig(enabled=True, rank=3, num_factors=2,
                               phase_paths=False)
    layer = tensorized.make_tensorized_linear(16, 16, tnn,
                                              compute_dtype=torch.float32,
                                              device="cpu")
    x = torch.ones(2, 16)
    with torch.no_grad():
        assert layer(x).shape == (2, 16)
    layer(x).square().sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in layer.cores)
    qlayer = tensorized.make_tensorized_linear(
        16, 16, dataclasses.replace(tnn, precision=tensorized.QuantPolicy(
            dtype="int8")), compute_dtype=torch.float32, device="cpu")
    with torch.no_grad():
        assert qlayer(x).shape == (2, 16)
    with pytest.raises(NotImplementedError, match="item 12"):
        qlayer(x)


def test_outer_product_step_reaches_the_gemm():
    """A step with no contracted axis lowers to a K = 1 GEMM and gives
    the einsum's numbers."""
    net = TensorNetwork(sizes={"a": 3, "b": 4, "c": 5},
                        nodes=(("a", "b"), ("c",)), node_names=("A", "C"),
                        output=("a", "c", "b"))
    plan = csse.search(net).plan
    compiled = plan_compiler.compile_plan(plan)
    (op,) = compiled.ops
    assert isinstance(op, plan_compiler.GemmOp) and op.mat.k == 1
    rng = np.random.default_rng(0)
    ts = [torch.from_numpy(rng.standard_normal(net.node_shape(i)).astype(
        np.float32)) for i in range(2)]
    got = contraction.execute(plan, ts, backend="cuda")
    want = torch.einsum("ab,c->acb", *ts)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------


def _same_plans(ours, theirs):
    (fp, bp, (kind, dw, wg)), (jfp, jbp, (jkind, jdw, jwg)) = ours, theirs
    assert fp.tree == jfp.tree and bp.tree == jbp.tree
    assert kind == jkind
    if kind == "shared":
        assert dw.tree == jdw.tree
    assert [w.tree for w in wg] == [w.tree for w in jwg]


@pytest.mark.parametrize("method", sorted(SPECS))
def test_plans_match_reference(method):
    out, inp, rank = SPECS[method]
    opts = csse.SearchOptions(fused_chain=True)
    jopts = jcsse.SearchOptions(fused_chain=True)
    for batch in (4, 64):
        _same_plans(
            tensorized._plans(F.make(method, out, inp, rank), batch, opts),
            jtensorized._plans(jF.make(method, out, inp, rank), batch, jopts,
                               _jax_hw()))


def test_full_width_atis_plans_match_reference():
    """The train path's own layers (d 768, d_ff 3072, TT rank 8, 3
    factors) at its token batch (8 x 128) and at a decode-sized one."""
    tnn = tbase.get("paper_atis_tt").tnn_default
    jtnn = jbase.get("paper_atis_tt").tnn_default
    opts = tnn.search_options(torch.bfloat16)
    jopts = jtnn.search_options(jnp.bfloat16)
    kinds = set()
    for out, inp in (((12, 8, 8), (12, 8, 8)), ((16, 16, 12), (12, 8, 8)),
                     ((12, 8, 8), (16, 16, 12))):
        for batch in (1024, 4):
            ours = tensorized._plans(F.tt(out, inp, 8), batch, opts)
            _same_plans(ours, jtensorized._plans(
                jF.tt(out, inp, 8), batch, jopts, _jax_hw()))
            kinds.add(ours[2][0])
            cost = tensorized.layer_cost(F.tt(out, inp, 8), batch, opts)
            assert set(cost) == {"fp", "bp", "wg"}
            assert all(c.latency_s > 0 for c in cost.values())
    assert kinds


# ---------------------------------------------------------------------------
# The smoke LM
# ---------------------------------------------------------------------------


def _numpy_params(shapes, seed=0):
    """Seeded numpy weights in the reference's tree (its structure from
    ``eval_shape``); norm scales off 1 so weight decay shows."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            a = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif "cores" in name:
            a = 0.35 * rng.standard_normal(s.shape)
        else:
            a = rng.standard_normal(s.shape) / np.sqrt(s.shape[-2])
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def smoke():
    """Reference and port smoke LMs in f32, tensorized on mlp/qkv/out,
    from the same numpy weights, and two batches."""
    jarch, arch = jbase.get("paper_atis_tt"), tbase.get("paper_atis_tt")
    jtnn = dataclasses.replace(jarch.smoke().tnn, targets=TARGETS)
    jcfg = dataclasses.replace(jarch.smoke(jtnn), compute_dtype=jnp.float32)
    jm = JLM(jcfg)
    tree = _numpy_params(jax.eval_shape(jm.init, jax.random.key(0)))
    data = jpipeline.SyntheticLM(jpipeline.DataConfig(
        vocab=jcfg.vocab, seq_len=16, global_batch=4))
    batches = [data.batch(s) for s in range(3)]
    tnn = dataclasses.replace(arch.smoke().tnn, targets=TARGETS)
    return jm, tree, batches, arch, tnn


def _port_model(smoke, backend="einsum", remat=False):
    _, tree, _, arch, tnn = smoke
    model, cfg = steps.build_model(arch, tnn=tnn, smoke=True, device="cpu",
                                   backend=backend,
                                   compute_dtype=torch.float32)
    if remat:
        cfg = dataclasses.replace(cfg, remat=True)
        model.cfg = cfg
    model.load_state_dict(params_from_numpy(tree, cfg))
    return model, cfg


def _port_grads(model):
    return {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("backend", ["einsum", "cuda"])
def test_smoke_lm_loss_and_grads_match_reference(smoke, backend):
    jm, tree, batches, _, _ = smoke
    batch = batches[0]
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jax.tree.map(jnp.asarray, tree))
    model, cfg = _port_model(smoke, backend)
    assert sum(isinstance(m, tensorized.TensorizedLinear)
               for m in model.modules()) == 14
    loss, metrics = model.loss({k: torch.from_numpy(v)
                                for k, v in batch.items()})
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    got = to_numpy_tree(_port_grads(model), cfg)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(jgrads))
    jax.tree_util.tree_map_with_path(
        lambda path, g, w: _close(g, w, 1e-4, jax.tree_util.keystr(path)),
        got, jax.tree.map(np.asarray, jgrads))


def test_remat_gives_identical_grads(smoke):
    _, _, batches, _, _ = smoke
    batch = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    grads = []
    for remat in (False, True):
        model, _ = _port_model(smoke, "cuda", remat=remat)
        assert model.cfg.remat is remat
        model.loss(batch)[0].backward()
        grads.append(_port_grads(model))
    for name, g in grads[0].items():
        assert torch.equal(g, grads[1][name]), name


def test_weight_decay_follows_the_reference_leaf_rank(smoke):
    model, _ = _port_model(smoke)
    ranks = {n: reference_ndim(n, p) for n, p in model.named_parameters()}
    assert ranks["layers.0.ln1.scale"] == 2 and ranks["ln_f.scale"] == 1
    assert AdamW.decays("layers.1.ln2.scale",
                        model.layers[1].ln2.scale)
    assert not AdamW.decays("ln_f.scale", model.ln_f.scale)
    assert AdamW.decays("embed", model.embed)


@pytest.mark.parametrize("microbatches,loss_scale", [(1, 1.0), (2, 4.0)])
def test_train_steps_match_reference(smoke, microbatches, loss_scale):
    jm, tree, batches, _, _ = smoke
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=4, loss_scale=loss_scale)
    jopt = JAdamW(**kw)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = {"params": jparams, "opt": jopt.init(jparams)}
    jstep = jax.jit(jsteps.make_train_step(jm, jopt, jblocks.no_shard,
                                           microbatches=microbatches))
    model, cfg = _port_model(smoke, "cuda")
    opt = AdamW(**kw)
    params = dict(model.named_parameters())
    state = {"params": params, "opt": opt.init(params)}
    step = steps.make_train_step(model, opt, microbatches=microbatches)
    jgrad = jax.jit(jax.grad(lambda p, b: jm.loss(p, b)[0]))
    lr_sum, grad_rel = 0.0, []
    for batch in batches:
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        g = np.abs(np.asarray(jgrad(jstate["params"], jbatch)["embed"]))
        grad_rel.append(np.where(g == 0, np.inf, g / g.max()))
        jstate, jm_ = jstep(jstate, jbatch)
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        lr_sum += float(jm_["lr"])
        for key, rel in (("loss", 1e-5), ("grad_norm", 1e-4), ("lr", 1e-6)):
            assert float(m[key]) == pytest.approx(float(jm_[key]),
                                                  rel=rel), key
    assert int(state["opt"].step) == int(jstate["opt"].step) == 3
    embed = state["params"].pop("embed").detach().numpy()
    jembed = np.asarray(jstate["params"].pop("embed"))
    # Elements whose reference gradient was zero or above 1e-3 of that
    # step's largest at every step (96% of them) follow the reference at
    # 1e-5 of the scale; the rest sit at the f32 noise floor, where Adam
    # turns a few-per-cent gradient error into a step of up to lr.
    clean = np.min(grad_rel, axis=0) > 1e-3
    assert clean.mean() > 0.9
    np.testing.assert_allclose(
        embed[clean], jembed[clean], rtol=0,
        atol=1e-5 * float(np.abs(jembed).max()))
    np.testing.assert_allclose(embed[~clean], jembed[~clean], rtol=0,
                               atol=2 * lr_sum)
    for name, (got, want, rel) in {
            "params": (state["params"], jstate["params"], 1e-5),
            "m": (state["opt"].m, jstate["opt"].m, 1e-4),
            "v": (state["opt"].v, jstate["opt"].v, 2e-4)}.items():
        jax.tree_util.tree_map_with_path(
            lambda path, g, w: _close(g, w, rel,
                                      name + jax.tree_util.keystr(path)),
            to_numpy_tree(got, cfg), jax.tree.map(np.asarray, want))


@pytest.mark.parametrize("moment_dtype,master", [
    ("float32", False), ("bfloat16", True)])
def test_adamw_options_match_reference(moment_dtype, master):
    """Two updates of a small tree with bf16 moments / f32 master copies
    and loss scaling, against the reference optimizer: parameters,
    moments and masters within 1e-6 of their scale (1e-2 for bf16
    moments, one bf16 rounding)."""
    cfg = dataclasses.make_dataclass("Cfg", [("num_layers", int)])(2)
    rng = np.random.default_rng(5)
    tree = {"embed": rng.standard_normal((6, 4)).astype(np.float32),
            "ln_f": {"scale": 1 + rng.standard_normal(4).astype(np.float32)},
            "layers": {"ln1": {"scale": 1 + rng.standard_normal(
                (2, 4)).astype(np.float32)}}}
    grads = [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32) * 3.0, tree) for _ in range(2)]
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=3, loss_scale=2.0,
              master_weights=master)
    jopt = JAdamW(moment_dtype=getattr(jnp, moment_dtype), **kw)
    opt = AdamW(moment_dtype=getattr(torch, moment_dtype), **kw)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    params = {n: t.clone() for n, t in params_from_numpy(tree, cfg).items()}
    state = opt.init(params)
    for g in grads:
        jparams, jstate, jm = jopt.update(jax.tree.map(jnp.asarray, g),
                                          jstate, jparams)
        params, state, m = opt.update(params_from_numpy(g, cfg), state,
                                      params)
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-7)
    mrel = 1e-6 if moment_dtype == "float32" else 1e-2
    pairs = [(params, jparams, 1e-6), (state.m, jstate.m, mrel),
             (state.v, jstate.v, mrel)]
    if master:
        pairs.append((state.master, jstate.master, 1e-6))
    for got, want, rel in pairs:
        jax.tree.map(lambda g, w: _close(g, w, rel),
                     to_numpy_tree(got, cfg),
                     jax.tree.map(lambda a: np.asarray(a, np.float32), want))


def test_convert_round_trip(smoke):
    _, tree, _, _, _ = smoke
    _, cfg = _port_model(smoke)
    back = to_numpy_tree(params_from_numpy(tree, cfg), cfg)
    jax.tree.map(np.testing.assert_array_equal, back, tree)


# ---------------------------------------------------------------------------
# Data and CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["ngram", "uniform"])
def test_synthetic_batches_are_bit_equal(kind):
    kw = dict(vocab=97, seq_len=12, global_batch=4, seed=3, kind=kind)
    ours = pipeline.SyntheticLM(pipeline.DataConfig(**kw))
    theirs = jpipeline.SyntheticLM(jpipeline.DataConfig(**kw))
    for step in (0, 5):
        for host in ((0, 1), (1, 2)):
            a = ours.batch(step, host_index=host[0], host_count=host[1])
            b = theirs.batch(step, host_index=host[0], host_count=host[1])
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_train_cli_runs_on_the_cpu(capsys, tmp_path):
    trace = tmp_path / "train.jsonl"
    train_cli.main(["--arch", "paper_atis_tt", "--smoke", "--tnn",
                    "--tnn-backend", "cuda", "--device", "cpu", "--steps",
                    "2", "--batch", "2", "--seq", "16", "--tnn-remat",
                    "recompute", "--tnn-trace", str(trace)])
    out = capsys.readouterr().out
    assert "step     1 loss" in out and "done: final loss" in out
    names = {line.split('"name": "')[1].split('"')[0]
             for line in trace.read_text().splitlines() if '"name": "' in line}
    assert {"train.step", "train.data", "train.step_fn"} <= names


def test_watchdog_and_restarts_behave_like_the_reference():
    for mod in (ft, jft):
        wd = mod.StepWatchdog(straggler_factor=1.5, hang_factor=10.0,
                              warmup_steps=3)
        for step in range(6):
            wd.observe(step, 1.0)
        assert wd.observe(6, 2.0).straggler
        with pytest.raises(TimeoutError):
            wd.observe(7, 11.0)
        calls = []

        def run(start):
            calls.append(start)
            if len(calls) < 3:
                raise RuntimeError("transient")
            return 9

        assert mod.run_with_restarts(run, max_restarts=2) == 9
        assert calls == [0, -1, -1]

        def down(start):
            raise OSError("down")

        with pytest.raises(OSError):
            mod.run_with_restarts(down, max_restarts=1)


def test_train_losses_are_finite_and_backends_agree():
    kw = dict(smoke=True, tnn=True, steps=2, global_batch=2, seq_len=16,
              lr=3e-3, device="cpu", log_every=100)
    a = train_cli.train("paper_atis_tt", tnn_backend="cuda", **kw)
    b = train_cli.train("paper_atis_tt", tnn_backend="einsum", **kw)
    assert all(np.isfinite(a["losses"]))
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-3)


@pytest.mark.parametrize("flag", [
    ["--tnn-autotune"], ["--tnn-search", "joint"], ["--tnn-mesh", "data"],
    ["--tnn-pipeline", "2"], ["--production-mesh"]])
def test_unported_flags_are_refused(flag, capsys):
    with pytest.raises(SystemExit) as exc:
        train_cli.main(["--arch", "paper_atis_tt", "--smoke", "--tnn",
                        "--device", "cpu", "--steps", "1", *flag])
    assert exc.value.code == 2
    assert "ROADMAP.md" in capsys.readouterr().err


@pytest.mark.parametrize("flag", ["--tnn-memory-budget", "--ckpt-dir",
                                  "--ckpt-every"])
def test_ported_flags_run_on_the_cpu(flag, capsys, tmp_path):
    """The flags the memory and checkpoint slice ported: a budget below
    the stash splits the batch (2 samples, 2 microbatches); a checkpoint
    directory gets the final step (and, with ``--ckpt-every 1``, each
    step, the oldest pruned to the manager's three)."""
    ckpt = tmp_path / "ckpt"
    extra = {"--tnn-memory-budget": ["--tnn-memory-budget", "1KB"],
             "--ckpt-dir": ["--ckpt-dir", str(ckpt)],
             "--ckpt-every": ["--ckpt-dir", str(ckpt), "--ckpt-every",
                              "1"]}[flag]
    steps_run = 4 if flag == "--ckpt-every" else 2
    train_cli.main(["--arch", "paper_atis_tt", "--smoke", "--tnn",
                    "--tnn-backend", "cuda", "--device", "cpu", "--steps",
                    str(steps_run), "--batch", "2", "--seq", "16", *extra])
    out = capsys.readouterr().out
    assert "done: final loss" in out
    if flag == "--tnn-memory-budget":
        assert "-> 2 microbatches" in out and "(modeled)" in out
        return
    want = (["step_00000002", "step_00000003", "step_00000004"]
            if flag == "--ckpt-every" else ["step_00000002"])
    assert sorted(p.name for p in ckpt.iterdir()) == want
    assert all((ckpt / n / "COMMITTED").exists() for n in want)


@pytest.mark.parametrize("flags", [
    ["--tnn-precision", "fp8", "--loss-scale", "128"],
    ["--tnn-remat", "quantized"],
    ["--tnn-precision", "int8:tile", "--tnn-remat", "quantized:int8"]])
def test_precision_flags_run_on_the_cpu(flags, capsys):
    """``--tnn-precision`` and a quantized ``--tnn-remat`` train (the
    plain versions of the quantized kernels on the CPU)."""
    train_cli.main(["--arch", "paper_atis_tt", "--smoke", "--tnn",
                    "--tnn-backend", "cuda", "--device", "cpu", "--steps",
                    "1", "--batch", "2", "--seq", "16", *flags])
    assert "done: final loss" in capsys.readouterr().out


def test_precision_flag_needs_tnn(capsys):
    with pytest.raises(SystemExit) as exc:
        train_cli.main(["--arch", "paper_atis_tt", "--smoke", "--device",
                        "cpu", "--tnn-precision", "fp8"])
    assert exc.value.code == 2
    assert "--tnn-precision requires --tnn" in capsys.readouterr().err
