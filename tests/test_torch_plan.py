"""Port planning stack (IR, factorizations, CSSE, executors) vs the JAX
reference on the same inputs.

* factorizations build the same shapes and networks;
* with the same :class:`HardwareModel` field values both packages' CSSE
  pick the same tree and plan (the JAX side gets
  ``repro.core.perf_model.HardwareModel(**port_fields)``);
* ``contraction.execute`` on the port's ``einsum`` and ``cuda`` backends
  (the latter runs the kernels' plain versions on the CPU) matches the
  JAX executor in f32 within 1e-5 relative.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Tiny shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the CPU.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import contraction as jcontraction  # noqa: E402
from repro.core import csse as jcsse  # noqa: E402
from repro.core import factorizations as jF  # noqa: E402
from repro.core import perf_model as jperf  # noqa: E402
from repro_torch.core import contraction, csse, perf_model  # noqa: E402
from repro_torch.core import factorizations as F  # noqa: E402
from repro_torch.core import plan_compiler  # noqa: E402
from repro_torch.kernels import fused_contraction as fc  # noqa: E402

SPECS = {
    "tt": ((4, 4, 4), (4, 4, 4), 6),
    "ttm": ((4, 4, 4), (4, 4, 4), 6),
    "tr": ((4, 4), (4, 4), 5),
    "ht": ((4, 4, 2), (4, 2, 4), 3),
    "bt": ((4, 4), (4, 4), 3),
}


def _facts(method):
    out, inp, rank = SPECS[method]
    return F.make(method, out, inp, rank), jF.make(method, out, inp, rank)


def _jax_hw():
    return jperf.HardwareModel(**dataclasses.asdict(perf_model.H100_SXM))


@pytest.mark.parametrize("method", sorted(SPECS))
def test_factorizations_match(method):
    ours, theirs = _facts(method)
    assert ours.core_axes == theirs.core_axes
    assert ours.sizes == theirs.sizes
    assert [ours.core_shape(i) for i in range(ours.num_cores)] == [
        theirs.core_shape(i) for i in range(theirs.num_cores)]
    assert ours.init_std(0.1) == theirs.init_std(0.1)
    a = ours.forward_network(batch_axes=(("b", 16),))
    b = theirs.forward_network(batch_axes=(("b", 16),))
    assert (a.nodes, a.output, dict(a.sizes)) == (b.nodes, b.output,
                                                  dict(b.sizes))
    assert ours.fixed_tree(a) == theirs.fixed_tree(b)
    assert F.factorize_dim(3072, 3) == jF.factorize_dim(3072, 3)


def _plan_key(plan):
    return [(s.lhs, s.rhs, s.lhs_axes, s.rhs_axes, s.out_axes)
            for s in plan.steps]


@pytest.mark.parametrize("method", sorted(SPECS))
@pytest.mark.parametrize("objective,fused", [("edp", True),
                                             ("latency", False),
                                             ("flops", True)])
def test_csse_picks_the_same_plan(method, objective, fused):
    ours, theirs = _facts(method)
    opts = csse.SearchOptions(objective=objective, fused_chain=fused)
    jopts = jcsse.SearchOptions(objective=objective, fused_chain=fused)
    for batch in (4, 64):
        a = csse.search(ours.forward_network(batch_axes=(("b", batch),)),
                        opts, perf_model.H100_SXM)
        b = jcsse.search(theirs.forward_network(batch_axes=(("b", batch),)),
                         jopts, _jax_hw())
        assert a.tree == b.tree
        assert _plan_key(a.plan) == _plan_key(b.plan)
        assert a.cost.latency_s == pytest.approx(b.cost.latency_s, rel=1e-12)
    a = csse.search(ours.weight_network(), opts, perf_model.H100_SXM)
    b = jcsse.search(theirs.weight_network(), jopts, _jax_hw())
    assert a.tree == b.tree


def test_atis_full_width_plans_match():
    """The serving path's own networks: d 768 / d_ff 3072, TT rank 8."""
    for out, inp in (((12, 8, 8), (12, 8, 8)), ((16, 16, 12), (12, 8, 8)),
                     ((12, 8, 8), (16, 16, 12))):
        for batch in (4, 128):
            a = csse.search(F.tt(out, inp, 8).forward_network(
                batch_axes=(("b", batch),)), csse.SearchOptions(
                    fused_chain=True), perf_model.H100_SXM)
            b = jcsse.search(jF.tt(out, inp, 8).forward_network(
                batch_axes=(("b", batch),)), jcsse.SearchOptions(
                    fused_chain=True), _jax_hw())
            assert a.tree == b.tree


def test_h100_model_fields():
    hw = perf_model.H100_SXM
    assert (hw.peak_flops, hw.hbm_bw, hw.ici_bw, hw.vmem_bytes) == (
        989e12, 3.35e12, 450e9, 232_448)


def _inputs(net, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(net.node_shape(i)).astype(np.float32)
            for i in range(net.num_nodes)]


@pytest.mark.parametrize("method", sorted(SPECS))
@pytest.mark.parametrize("backend", ["einsum", "cuda"])
def test_execute_matches_reference(method, backend):
    ours, theirs = _facts(method)
    net = ours.forward_network(batch_axes=(("b", 16),))
    opts = csse.SearchOptions(fused_chain=True)
    plan = csse.search(net, opts).plan
    jnet = theirs.forward_network(batch_axes=(("b", 16),))
    jplan = jcsse.search(jnet, jcsse.SearchOptions(fused_chain=True),
                         _jax_hw()).plan
    arrays = _inputs(net, 5)
    got = contraction.execute(plan, [torch.from_numpy(a) for a in arrays],
                              backend=backend)
    want = np.asarray(jcontraction.execute(
        jplan, [jnp.asarray(a) for a in arrays]))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * scale)


def test_pallas_is_an_alias_of_cuda():
    fact = F.tt((4, 4), (4, 4), 3)
    net = fact.forward_network(batch_axes=(("b", 8),))
    plan = csse.search(net).plan
    ts = [torch.from_numpy(a) for a in _inputs(net, 1)]
    a = contraction.execute(plan, ts, backend="pallas")
    b = contraction.execute(plan, ts, backend="cuda")
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown backend"):
        contraction.execute(plan, ts, backend="xla")


def test_tt_forward_lowers_to_chain_and_gemms():
    fact = F.tt((12, 8, 8), (12, 8, 8), 8)
    plan = csse.search(fact.forward_network(batch_axes=(("b", 4),)),
                       csse.SearchOptions(fused_chain=True)).plan
    rep = plan_compiler.compile_plan(plan).report()
    assert rep["num_chain"] >= 1 and rep["num_einsum_fallback"] == 0
    unfused = plan_compiler.compile_plan(plan, fuse=False).report()
    assert unfused["num_chain"] == 0
    assert unfused["num_gemm"] == len(plan.steps)


def test_bt_hyperedge_falls_back_to_einsum():
    fact = F.bt((4, 4), (4, 4), 3)
    plan = csse.search(fact.forward_network(batch_axes=(("b", 8),))).plan
    rep = plan_compiler.compile_plan(plan).report()
    assert rep["num_einsum_fallback"] >= 1


def test_runtime_refusal_degrades_to_per_link_gemms(monkeypatch):
    fact = F.tt((12, 8, 8), (12, 8, 8), 8)
    net = fact.forward_network(batch_axes=(("b", 4),))
    plan = csse.search(net, csse.SearchOptions(fused_chain=True)).plan
    ts = [torch.from_numpy(a) for a in _inputs(net, 2)]
    want = contraction.execute(plan, ts, backend="einsum")
    compiled = plan_compiler.compile_plan(plan)
    assert compiled.report()["num_chain"] >= 1

    def refuse(*a, **k):
        raise fc.ChainLoweringError("refused for the test")

    monkeypatch.setattr(plan_compiler, "chain_n_cuda", refuse)
    plan_compiler.reset_degrade_counts()
    got = plan_compiler.run(compiled, ts)
    assert plan_compiler.DEGRADE_COUNTS["runtime"] == (
        compiled.report()["num_chain"])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    plan_compiler.reset_degrade_counts()


def test_launch_failure_is_not_a_degrade(monkeypatch):
    fact = F.tt((12, 8, 8), (12, 8, 8), 8)
    net = fact.forward_network(batch_axes=(("b", 4),))
    plan = csse.search(net, csse.SearchOptions(fused_chain=True)).plan
    ts = [torch.from_numpy(a) for a in _inputs(net, 2)]

    def broken(*a, **k):
        raise RuntimeError("chain_n_cuda launch failed")

    monkeypatch.setattr(plan_compiler, "chain_n_cuda", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        plan_compiler.run(plan_compiler.compile_plan(plan), ts)


def test_csse_cache_lives_under_its_own_directory(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CSSE_CACHE", str(tmp_path))
    csse.clear_memo()
    fact = F.tt((4, 2), (2, 4), 3)
    csse.search(fact.forward_network(batch_axes=(("b", 3),)))
    assert list((tmp_path / "torch").glob("*.json"))
    assert not list(tmp_path.glob("*.json"))


def test_measured_objective_is_refused():
    fact = F.tt((4, 2), (2, 4), 3)
    with pytest.raises(NotImplementedError, match="autotune"):
        csse.search(fact.forward_network(),
                    csse.SearchOptions(objective="measured"))
