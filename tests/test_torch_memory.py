"""The port's memory planner and probe against the reference's numbers.

``stash_report``, ``plan_microbatches``, ``probe_training`` (its modeled
CPU fallback), ``probe_plan`` and ``perf_model.peak_bytes`` are pure
arithmetic on a config or a plan, so they are held *equal* to the
reference's, byte for byte, across:

* ``paper_atis_tt`` at its full config (building an ``LMConfig`` draws
  no weight) and the smoke configs of ``rwkv6_7b``, ``zamba2_7b`` (with
  its ``mix`` projections tensorized, the one-card targets) and
  ``qwen2_7b``;
* the ``store``, ``recompute`` and ``quantized`` (fp8 and int8) stashes;
* no budget, a budget that forces a split, and one no split meets.

Then the train entry point on the CPU: ``tnn_memory_budget`` picks the
planner's split, and the result's peak is the modeled stash.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro import memory as jmemory  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.core import csse as jcsse  # noqa: E402
from repro.core import factorizations as jF  # noqa: E402
from repro.core import perf_model as jperf  # noqa: E402
from repro.precision import QuantPolicy as JQuantPolicy  # noqa: E402
from repro_torch import memory  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import csse, perf_model  # noqa: E402
from repro_torch.core import factorizations as F  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.precision import QuantPolicy  # noqa: E402

#: (arch, full config?, targets override)
CONFIGS = [("paper_atis_tt", True, None), ("rwkv6_7b", False, None),
           ("zamba2_7b", False, ("mlp", "mix", "out")),
           ("qwen2_7b", False, None)]
STASHES = ["store", "recompute", "quantized", "quantized:int8"]
BATCH, SEQ = 8, 128


def _configs(arch_id, full, targets):
    jarch, arch = jbase.get(arch_id), tbase.get(arch_id)
    jtnn, tnn = jarch.tnn_default, arch.tnn_default
    if targets is not None:
        jtnn = dataclasses.replace(jtnn, targets=targets)
        tnn = dataclasses.replace(tnn, targets=targets)
    if full:
        return jarch.model(jtnn), arch.model(tnn)
    return jarch.smoke(jtnn), arch.smoke(tnn)


def _same_report(got, want):
    assert got.peak_bytes == want.peak_bytes
    assert got.layer_bytes == want.layer_bytes
    assert got.microbatches == want.microbatches
    assert got.tokens_per_microbatch == want.tokens_per_microbatch
    assert got.num_layers == want.num_layers
    assert [(s.name, s.elems_per_token) for s in got.sites] == [
        (s.name, s.elems_per_token) for s in want.sites]
    assert got.site_bytes == want.site_bytes
    assert got.boundary_bytes == want.boundary_bytes
    assert got.detail == want.detail
    assert got.describe() == want.describe()


@pytest.mark.parametrize("stash", STASHES)
@pytest.mark.parametrize("arch_id,full,targets", CONFIGS)
def test_planner_and_probe_match_reference(arch_id, full, targets, stash):
    jcfg, cfg = _configs(arch_id, full, targets)
    sp, jsp = (memory.StashPolicy.parse(stash),
               jmemory.StashPolicy.parse(stash))
    assert memory.tnn_stash_sites(cfg)
    one = memory.stash_report(cfg, BATCH, SEQ, 1, sp)
    _same_report(one, jmemory.stash_report(jcfg, BATCH, SEQ, 1, jsp))
    for mb in (2, 8):
        _same_report(memory.stash_report(cfg, BATCH, SEQ, mb, sp),
                     jmemory.stash_report(jcfg, BATCH, SEQ, mb, jsp))
    # no budget, one that forces a split, one nothing meets
    for budget in (None, one.peak_bytes - 1, 1):
        m, rep = memory.plan_microbatches(cfg, BATCH, SEQ, budget, sp)
        jm, jrep = jmemory.plan_microbatches(jcfg, BATCH, SEQ, budget, jsp)
        assert m == jm
        _same_report(rep, jrep)
        if budget == one.peak_bytes - 1:
            assert m >= 2 or one.peak_bytes == 0
    got = memory.probe_training(cfg, BATCH, SEQ, 2, sp)
    want = jmemory.probe_training(jcfg, BATCH, SEQ, 2, jsp)
    assert (got.peak_bytes, got.source, got.detail) == (
        want.peak_bytes, want.source, want.detail)
    assert not got.measured


@pytest.mark.parametrize("mode", ["store", "recompute", "quantized",
                                  "quantized:int8", "quantized:fp8_e5m2"])
def test_stash_bytes_match_reference(mode):
    sp, jsp = memory.StashPolicy.parse(mode), jmemory.StashPolicy.parse(mode)
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        assert sp.stash_bytes(1000, dt) == jsp.stash_bytes(1000, jdt)
    assert sp.meta_bytes() == jsp.meta_bytes()


@pytest.mark.parametrize("policy", [None, "fp8", "int8"])
@pytest.mark.parametrize("spec", [((12, 8, 8), (12, 8, 8), 8),
                                  ((16, 16, 12), (12, 8, 8), 8)])
def test_plan_peak_bytes_match_reference(spec, policy):
    """ATIS's projections at its token batch: the same plan (the plan
    tests hold CSSE's trees equal), the same modeled peak, by default
    and under a mesh that splits the batch four ways."""
    out, inp, rank = spec
    plan = csse.search(F.tt(out, inp, rank).forward_network(
        batch_axes=(("b", 1024),))).plan
    jplan = jcsse.search(jF.tt(out, inp, rank).forward_network(
        batch_axes=(("b", 1024),))).plan
    qp = QuantPolicy.parse(policy) if policy else None
    jqp = JQuantPolicy.parse(policy) if policy else None
    assert perf_model.peak_bytes(plan, policy=qp) == jperf.peak_bytes(
        jplan, policy=jqp)
    mesh = perf_model.MeshSpec(axes=(("data", 4),),
                               axis_sharding=(("b", ("data",)),))
    jmesh = jperf.MeshSpec(axes=(("data", 4),),
                           axis_sharding=(("b", ("data",)),))
    assert perf_model.peak_bytes(plan, mesh=mesh, policy=qp) == (
        jperf.peak_bytes(jplan, mesh=jmesh, policy=jqp))
    got = memory.probe_plan(plan, policy=qp)
    want = jmemory.probe_plan(jplan, policy=jqp)
    assert (got.peak_bytes, got.source, got.detail) == (
        want.peak_bytes, want.source, want.detail)


def test_measure_on_the_cpu_is_none_and_runs_nothing():
    calls = []
    assert memory.measure(lambda: calls.append(1), device="cpu") is None
    assert memory.device_memory_stats("cpu") is None
    assert calls == []


def test_budget_splits_the_training_batch():
    """A budget below the one-microbatch stash: the train entry point
    trains with the planner's split, and reports the modeled stash of
    that split as its peak on the CPU."""
    arch = tbase.get("paper_atis_tt")
    cfg = arch.smoke(arch.tnn_default)
    one = memory.stash_report(cfg, 4, 16, 1)
    m, rep = memory.plan_microbatches(cfg, 4, 16, one.peak_bytes - 1)
    assert m == 2
    out = train_cli.train("paper_atis_tt", smoke=True, tnn=True, steps=2,
                          global_batch=4, seq_len=16, lr=3e-3, device="cpu",
                          tnn_backend="cuda", log_every=100,
                          tnn_memory_budget=one.peak_bytes - 1)
    assert out["microbatches"] == 2
    assert out["cfg"].tnn.memory_budget == one.peak_bytes - 1
    assert out["peak_source"] == "modeled"
    assert out["peak_activation_bytes"] == rep.peak_bytes
    assert out["modeled_activation_bytes"] == rep.peak_bytes
    assert rep.peak_bytes < one.peak_bytes
