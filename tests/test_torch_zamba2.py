"""Port Mamba-2 block and the zamba2 hybrid LM against the JAX reference.

Weights are the reference's init for the smoke configs (TT rank 64, 2
factors, targets ``("mlp", "mix", "out")``: the config ``zamba2_7b``
trains with on one card), with the block's per-head and per-channel
constants (``A_log``, ``dt_bias``, ``D_skip``, ``conv_b``, ``norm``, the
norm scales) moved off their init values by a numpy seed; the port gets
them through ``convert.params_from_numpy``.  The reference runs its
plain route (its chunked scan's jnp twin on the CPU).

* ``Mamba2Block``: forward, input and weight gradients at T = 32 within
  1e-5 of each output's scale in f32; forward within 5e-2 of its scale
  in bf16 (``tests/test_torch_ssm.py``'s bf16 scan tolerance);
  ``decode_step`` over 8 tokens, outputs and ``MambaState``, within
  1e-5.
* The overflow: at the reference's init (``A_log = dt_bias = 0``, a
  log-decay of ``-softplus(dt)``, about -0.7 a token) and T = 128, chunk
  128, the reference's full-sequence block is non-finite; the port's is
  finite, its scan receives the decay broadcast over dk
  (``ref.scalar_decay``), and it equals the reference's sequential
  ``decode_step`` over the same 128 tokens within 1e-4 of the scale.
* The smoke hybrid LM (4 layers, a shared block every 2) in f32: logits,
  loss and gradients at T = 32 (with and without remat), three steps of
  the reference's jitted ``make_train_step`` (``no_shard``) with
  ``tests/test_torch_train.py``'s tolerances, ``prefill`` +
  ``decode_step`` against ``forward`` and the reference, ``init_cache``
  shapes and the per-slot cache bytes against the reference's.
* ``ServeEngine`` on smoke ``rwkv6_7b`` and ``zamba2_7b`` (the sequential
  ``decode_step`` fallback): greedy tokens equal a hand-rolled
  ``decode_step`` loop of the port and of the reference.
* The full config's shapes and parameter counts, the serving profiles'
  projection list, the convert round trip, AdamW's decay rule and the
  train / serve CLIs on the CPU.
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
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models.lm import LM as JLM  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW  # noqa: E402
from repro.serving import kv_cache as jkv  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    params_from_numpy, reference_ndim, to_numpy_tree,
)
from repro_torch.core.tensorized import TensorizedLinear  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.lm import LM, MambaLayer, SharedBlock  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.serving import kv_cache, profiles  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402

TARGETS = ("mlp", "mix", "out")
PERTURBED = ("A_log", "dt_bias", "D_skip", "conv_b", "norm", "scale",
             "ln_x", "mix", "w0", "'u'")


def _close(got, want, rel, what=""):
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()),
                                              1e-30), err_msg=what)


def _reference(arch_id, compute_dtype=jnp.float32, perturb=True, seed=0,
               num_layers=None):
    """The reference smoke LM with ``TARGETS`` tensorized (rwkv6: its
    default), and its init as numpy, constants moved by a numpy seed;
    ``num_layers`` cuts (or grows) the depth."""
    jarch = jbase.get(arch_id)
    tnn = jarch.tnn_default
    if arch_id == "zamba2_7b":
        tnn = dataclasses.replace(tnn, targets=TARGETS)
    jcfg = jarch.smoke(tnn)
    jm = JLM(dataclasses.replace(jcfg, compute_dtype=compute_dtype,
                                 num_layers=num_layers or jcfg.num_layers))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    rng = np.random.default_rng(seed)

    def move(path, a):
        name = jax.tree_util.keystr(path)
        if perturb and any(k in name for k in PERTURBED):
            a = a + 0.1 * rng.standard_normal(a.shape)
        return np.asarray(a, np.float32)

    return jm, jax.tree_util.tree_map_with_path(move, tree)


def _tnn(arch):
    return arch.tnn_one_card or arch.tnn_default


def _port(arch_id, tree, backend="cuda", compute_dtype=torch.float32,
          remat=None, num_layers=None):
    arch = tbase.get(arch_id)
    model, cfg = steps.build_model(arch, tnn=_tnn(arch), smoke=True,
                                   device="cpu", backend=backend,
                                   compute_dtype=compute_dtype,
                                   num_layers=num_layers)
    if remat is not None:
        cfg = model.cfg = dataclasses.replace(cfg, remat=remat)
    model.load_state_dict(params_from_numpy(tree, cfg))
    return model, cfg


@pytest.fixture(scope="module")
def zamba():
    """Reference and port zamba2 smoke LMs (f32) and three batches."""
    jm, tree = _reference("zamba2_7b")
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(3):
        toks = rng.integers(0, jm.cfg.vocab, (2, 33)).astype(np.int32)
        batches.append({"inputs": toks[:, :-1], "targets": toks[:, 1:]})
    return jm, tree, batches


def _layer0(tree):
    return jax.tree.map(lambda a: jnp.asarray(a[0]),
                        tree["layers"]["mamba"])


def _block_tree(block):
    """A port block's parameters (or their gradients) as the reference's
    nested tree."""
    named = dict(block.named_parameters())
    sd = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
          for n, p in named.items()}
    return to_numpy_tree(sd, None)


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


def test_full_config_is_the_published_shape_and_fits_one_card():
    arch = tbase.get("zamba2_7b")
    jcfg = jbase.get("zamba2_7b").model()
    cfg = arch.model(arch.tnn_one_card)
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "hd",
              "d_ff", "vocab", "block", "ssm_state", "remat"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert (cfg.hybrid.shared_every, cfg.hybrid.d_ff_shared) == (
        jcfg.hybrid.shared_every, jcfg.hybrid.d_ff_shared) == (27, 14336)
    assert arch.tnn_one_card == dataclasses.replace(arch.tnn_default,
                                                    targets=TARGETS)
    # One layer and the shared block on the meta device, times the
    # depth, plus the embedding, lm_head and final norm: the reference's
    # count (``jax.eval_shape`` of its init).
    def count(tnn):
        c = arch.model(tnn)

        def n(m):
            return sum(p.numel() for p in m.parameters())

        return (c.num_layers * n(MambaLayer(c, device="meta"))
                + n(SharedBlock(c, device="meta"))
                + 2 * c.vocab * c.d_model + c.d_model)

    assert count(arch.tnn_default) == 6_585_274_176
    assert count(arch.tnn_one_card) == 374_829_056
    layer = MambaLayer(cfg, device="meta")
    blk = layer.mamba
    assert (blk.d_inner, blk.num_heads, blk.conv_dim) == (7168, 64, 7296)
    assert [tuple(c.shape) for c in getattr(blk, "in").cores] == [
        (227, 64), (64, 64, 64), (64, 64, 64), (64, 56)]
    assert [tuple(c.shape) for c in blk.out.cores] == [
        (64, 64), (64, 56, 64), (64, 112, 64), (64, 64)]


@pytest.mark.parametrize("smoke", [True, False])
def test_profiles_list_every_tensorized_projection(smoke):
    """``tensorized_projections`` (which the serving profiles and the
    card's kernel checks enumerate) names every tensorized layer shape
    the model builds."""
    arch = tbase.get("zamba2_7b")
    tnn = arch.tnn_one_card
    cfg = arch.smoke(tnn) if smoke else arch.model(tnn)
    mods = [MambaLayer(cfg, device="meta"), SharedBlock(cfg, device="meta")]
    built = {(m.fact.N, m.fact.M) for mod in mods for m in mod.modules()
             if isinstance(m, TensorizedLinear)}
    listed = {(d_in, d_out) for _, d_in, d_out
              in profiles.tensorized_projections(cfg)}
    # (at smoke width Mamba-2's out and the shared MLP's down coincide)
    assert built == listed and len(listed) == (4 if smoke else 5)


def test_hybrid_config_is_validated():
    arch = tbase.get("zamba2_7b")
    with pytest.raises(ValueError, match="not divisible"):
        LM(dataclasses.replace(arch.smoke(), num_layers=3), device="meta")
    with pytest.raises(ValueError, match="mamba2 backbone"):
        dataclasses.replace(arch.smoke(), block="rwkv6").validate()
    model, cfg = steps.build_model(arch, smoke=True, device="meta",
                                   num_layers=2, shared_every=1)
    assert (cfg.num_layers, cfg.hybrid.shared_every) == (2, 1)
    assert len(model.layers) == 2 and model._shared_after(0)


# ---------------------------------------------------------------------------
# The Mamba-2 block
# ---------------------------------------------------------------------------


def test_mamba_block_forward_and_grads_match_reference(zamba):
    jm, tree, _ = zamba
    model, _ = _port("zamba2_7b", tree)
    block = model.layers[0].mamba
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 32, 64)).astype(np.float32)
    dy = rng.standard_normal((2, 32, 64)).astype(np.float32)
    lp = _layer0(tree)
    want, vjp = jax.vjp(lambda p, x: jm.mamba(p, x), lp, jnp.asarray(x))
    want_dp, want_dx = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_()
    got = block(xt)
    got.backward(torch.from_numpy(dy))
    _close(got, want, 1e-5, "forward")
    _close(xt.grad, want_dx, 1e-5, "dx")
    got_dp = _block_tree(block)
    assert (jax.tree_util.tree_structure(got_dp)
            == jax.tree_util.tree_structure(want_dp))
    jax.tree_util.tree_map_with_path(
        lambda path, g, w: _close(g, w, 1e-5, jax.tree_util.keystr(path)),
        got_dp, jax.tree.map(np.asarray, want_dp))


def test_mamba_block_bf16_matches_reference():
    jm, tree = _reference("zamba2_7b", compute_dtype=jnp.bfloat16)
    model, _ = _port("zamba2_7b", tree, compute_dtype=torch.bfloat16)
    block = model.layers[0].mamba
    x = np.random.default_rng(9).standard_normal((2, 32, 64)).astype(
        np.float32)
    want = jm.mamba(_layer0(tree), jnp.asarray(x).astype(jnp.bfloat16))
    with torch.no_grad():
        got = block(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want.astype(jnp.float32)), 5e-2, "bf16 forward")


def test_mamba_decode_steps_match_reference(zamba):
    jm, tree, _ = zamba
    model, _ = _port("zamba2_7b", tree)
    block = model.layers[0].mamba
    lp = _layer0(tree)
    x = np.random.default_rng(10).standard_normal((2, 8, 64)).astype(
        np.float32)
    jstate = jm.mamba.init_state(2)
    state = block.init_state(2)
    step = jax.jit(jm.mamba.decode_step)
    with torch.no_grad():
        for t in range(8):
            want, jstate = step(lp, jnp.asarray(x[:, t:t + 1]), jstate)
            got, state = block.decode_step(torch.from_numpy(x[:, t:t + 1]),
                                           state)
            _close(got, want, 1e-5, f"out {t}")
            _close(state.ssm, jstate.ssm, 1e-5, f"ssm {t}")
            _close(state.conv, jstate.conv, 1e-5, f"conv {t}")


def test_mamba_forward_at_t128_is_finite_and_matches_sequential_decode(
        monkeypatch):
    """At the reference's init the log-decay is ``-softplus(dt)``: at T =
    128, chunk 128, the reference's factored scan overflows f32 and its
    block is non-finite.  The port's scan receives the decay broadcast
    over dk, takes the overflow-free form, and equals the reference's
    exact sequential recurrence (``decode_step`` token by token)."""
    jm, tree = _reference("zamba2_7b", perturb=False)
    model, _ = _port("zamba2_7b", tree)
    block = model.layers[0].mamba
    lp = _layer0(tree)
    x = np.random.default_rng(11).standard_normal((2, 128, 64)).astype(
        np.float32)
    seen = []
    scan = ssm.ops.linear_scan

    def spy(q, k, v, log_decay, *a, **kw):
        seen.append((log_decay, kw.get("mode"), kw.get("chunk")))
        return scan(q, k, v, log_decay, *a, **kw)

    monkeypatch.setattr(ssm.ops, "linear_scan", spy)
    with torch.no_grad():
        got = block(torch.from_numpy(x), chunk=128)
    (ld, mode, chunk), = seen
    assert mode == "ssd" and chunk == 128 and ref.scalar_decay(ld, mode)
    assert float(ld.min()) * 128 < -88.7   # deep enough to overflow
    assert bool(torch.isfinite(got).all())
    factored = jm.mamba(lp, jnp.asarray(x), chunk=128)
    assert not bool(jnp.isfinite(factored).all())
    step = jax.jit(jm.mamba.decode_step)
    state, outs = jm.mamba.init_state(2), []
    for t in range(128):
        y, state = step(lp, jnp.asarray(x[:, t:t + 1]), state)
        outs.append(np.asarray(y))
    _close(got, np.concatenate(outs, axis=1), 1e-4, "vs sequential")


# ---------------------------------------------------------------------------
# The hybrid LM
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def zamba_grads(zamba):
    jm, tree, batches = zamba
    batch = {k: jnp.asarray(v) for k, v in batches[0].items()}
    jparams = jax.tree.map(jnp.asarray, tree)
    jlogits, _ = jm(jparams, batch["inputs"])
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, batch), has_aux=True)(jparams)
    return jlogits, jloss, jgrads


@pytest.mark.parametrize("remat", [False, True])
def test_lm_logits_loss_and_grads_match_reference(zamba, zamba_grads,
                                                  remat):
    _, tree, batches = zamba
    jlogits, jloss, jgrads = zamba_grads
    model, cfg = _port("zamba2_7b", tree, remat=remat)
    batch = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    with torch.no_grad():
        _close(model(batch["inputs"]), jlogits, 1e-5, "logits")
    loss, _ = model.loss(batch)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    got = to_numpy_tree({n: p.grad for n, p in model.named_parameters()},
                        cfg)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(jgrads))
    jax.tree_util.tree_map_with_path(
        lambda path, g, w: _close(g, w, 1e-4, jax.tree_util.keystr(path)),
        got, jax.tree.map(np.asarray, jgrads))


def test_remat_checkpoints_the_mamba_layers_only(zamba, monkeypatch):
    _, tree, batches = zamba
    model, _ = _port("zamba2_7b", tree, remat=True)
    from repro_torch.models import lm as lm_mod
    calls = []
    real = lm_mod.checkpoint

    def counted(fn, *a, **kw):
        calls.append(fn.__name__)
        return real(fn, *a, **kw)

    monkeypatch.setattr(lm_mod, "checkpoint", counted)
    model.loss({k: torch.from_numpy(v)
                for k, v in batches[0].items()})[0].backward()
    assert calls == ["_mamba_layer"] * model.cfg.num_layers


def test_train_steps_match_reference(zamba):
    """Three AdamW steps against the reference's jitted train step, with
    ``tests/test_torch_train.py``'s tolerances: loss 1e-5, grad norm
    1e-4; parameters 1e-5, first moments 1e-4, second 2e-4 of each
    leaf's scale.  As that file finds for its embedding, Adam's step
    ``lr m / sqrt(v)`` turns f32 roundoff in a gradient into a step
    error of up to lr where ``m`` nearly cancels, and the next steps'
    gradients, taken at those parameters, carry it on; in the hybrid
    that holds for a few elements of most leaves, not one leaf, so each
    tolerance holds for 99.9% of all elements, and every parameter is
    within twice the summed learning rate."""
    jm, tree, batches = zamba
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=4)
    jopt = JAdamW(**kw)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = {"params": jparams, "opt": jopt.init(jparams)}
    jstep = jax.jit(jsteps.make_train_step(jm, jopt, jblocks.no_shard))
    model, cfg = _port("zamba2_7b", tree)
    opt = AdamW(**kw)
    params = dict(model.named_parameters())
    state = {"params": params, "opt": opt.init(params)}
    step = steps.make_train_step(model, opt)
    lr_sum = 0.0
    for batch in batches:
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        jstate, jm_ = jstep(jstate, jbatch)
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        lr_sum += float(jm_["lr"])
        for key, rel in (("loss", 1e-5), ("grad_norm", 1e-4), ("lr", 1e-6)):
            assert float(m[key]) == pytest.approx(float(jm_[key]),
                                                  rel=rel), key
    assert int(state["opt"].step) == int(jstate["opt"].step) == 3
    got_params = to_numpy_tree(state["params"], cfg)
    want_params = jax.tree.map(np.asarray, jstate["params"])
    jax.tree_util.tree_map_with_path(
        lambda path, g, w: np.testing.assert_allclose(
            g, w, rtol=0, atol=2 * lr_sum,
            err_msg=jax.tree_util.keystr(path)), got_params, want_params)
    for name, (got, want, rel) in {
            "params": (got_params, want_params, 1e-5),
            "m": (to_numpy_tree(state["opt"].m, cfg), jstate["opt"].m, 1e-4),
            "v": (to_numpy_tree(state["opt"].v, cfg), jstate["opt"].v,
                  2e-4)}.items():
        far = [(np.abs(g - np.asarray(w))
                > rel * float(np.abs(np.asarray(w)).max())).sum()
               for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want))]
        total = sum(np.size(w) for w in jax.tree.leaves(want))
        assert sum(far) <= 1e-3 * total, (name, sum(far), total)


def test_prefill_then_decode_matches_forward_and_reference(zamba):
    jm, tree, batches = zamba
    toks = batches[1]["inputs"][:, :16]
    jparams = jax.tree.map(jnp.asarray, tree)
    model, _ = _port("zamba2_7b", tree)
    with torch.no_grad():
        full = model(torch.from_numpy(toks))
        lp, cache = model.prefill(torch.from_numpy(toks[:, :-1]), max_len=20)
        ld, new = model.decode_step(torch.from_numpy(toks[:, -1]), cache)
    assert int(new.length) == 16
    assert new.shared.k.shape == (2, 2, 20, 4, 16)
    _close(lp, full[:, -2], 1e-5, "prefill vs forward")
    _close(ld, full[:, -1], 1e-4, "decode vs forward")
    jlp, jcache = jm.prefill(jparams, jnp.asarray(toks[:, :-1]), max_len=20)
    jld, jnew = jm.decode_step(jparams, jnp.asarray(toks[:, -1]), jcache)
    _close(lp, jlp, 1e-5, "prefill vs reference")
    _close(ld, jld, 1e-5, "decode vs reference")
    for got, want, what in (
            (cache.layers.ssm, jcache.layers.ssm, "prefill ssm state"),
            (cache.layers.conv, jcache.layers.conv, "prefill conv tail"),
            (cache.shared.k, jcache.shared.k, "prefill shared k"),
            (new.layers.ssm, jnew.layers.ssm, "decode ssm state"),
            (new.shared.v, jnew.shared.v, "decode shared v")):
        _close(got, want, 1e-5, what)
    assert cache.shared.length.tolist() == np.asarray(
        jcache.shared.length).tolist()


@pytest.mark.parametrize("arch_id", ["zamba2_7b", "rwkv6_7b"])
def test_init_cache_shapes_and_slot_bytes_match_reference(arch_id):
    jm, tree = _reference(arch_id)
    model, _ = _port(arch_id, tree)
    want = jax.eval_shape(lambda: jm.init_cache(3, 24))
    got = model.init_cache(3, 24)
    if arch_id == "zamba2_7b":
        got = {"layers": got.layers, "shared": got.shared,
               "length": got.length}
        want = {"layers": want.layers, "shared": want.shared,
                "length": want.length}
    else:
        got = {"layers": got.layers, "length": got.length}
        want = {"layers": want.layers, "length": want.length}
    shapes = jax.tree.map(lambda t: (tuple(t.shape),
                                     str(t.dtype).split(".")[-1]), got,
                          is_leaf=torch.is_tensor)
    assert shapes == jax.tree.map(lambda s: (s.shape, str(s.dtype)), want)
    assert not any(bool(t.any()) for t in jax.tree.leaves(
        got, is_leaf=torch.is_tensor))
    assert kv_cache.model_slot_bytes(model, 24) == jkv.model_slot_bytes(
        jm, 24)


# ---------------------------------------------------------------------------
# Serving (the sequential decode_step fallback)
# ---------------------------------------------------------------------------


PROMPT_LENS, MAX_NEW = (5, 9, 12), 5


def _prompts(vocab, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n, dtype=np.int32)
            for n in PROMPT_LENS]


def _port_hand_rolled(model, prompt):
    cache = model.init_cache(1, 40)._replace(
        length=torch.zeros(1, dtype=torch.int32))
    with torch.no_grad():
        for tok in prompt:
            logits, cache = model.decode_step(torch.tensor([int(tok)]),
                                              cache)
        toks = [int(logits[0].argmax())]
        while len(toks) < MAX_NEW:
            logits, cache = model.decode_step(torch.tensor([toks[-1]]),
                                              cache)
            toks.append(int(logits[0].argmax()))
    return toks


def _reference_hand_rolled(jm, params, prompt):
    """The reference model's greedy decode by hand, ``decode_step`` per
    token (its ``extend`` takes attention models only; its engine is not
    the oracle: ROADMAP.md, queue C)."""
    cache = jm.init_cache(1, 40)._replace(length=jnp.zeros(1, jnp.int32))
    step = jax.jit(jm.decode_step)
    for tok in prompt:
        logits, cache = step(params, jnp.asarray([tok], jnp.int32), cache)
    toks = [int(np.argmax(np.asarray(logits[0])))]
    while len(toks) < MAX_NEW:
        logits, cache = step(params, jnp.asarray([toks[-1]], jnp.int32),
                             cache)
        toks.append(int(np.argmax(np.asarray(logits[0]))))
    return toks


@pytest.mark.parametrize("arch_id", ["zamba2_7b", "rwkv6_7b"])
def test_engine_greedy_tokens_match_hand_rolled_decode(arch_id):
    jm, tree = _reference(arch_id)
    model, cfg = _port(arch_id, tree)
    prompts = _prompts(cfg.vocab)
    engine = ServeEngine(model, batch_size=2, max_len=24, prefill_chunk=8)
    assert not engine._native_extend
    for rid, p in enumerate(prompts):
        engine.submit(Request(rid=rid, prompt=p, max_new_tokens=MAX_NEW))
    engine.warmup()
    got = {r.rid: r.out_tokens for r in engine.run()}
    jparams = jax.tree.map(jnp.asarray, tree)
    assert got == {rid: _port_hand_rolled(model, p)
                   for rid, p in enumerate(prompts)}
    assert got == {rid: _reference_hand_rolled(jm, jparams, p)
                   for rid, p in enumerate(prompts)}
    assert engine.slot_cost["total"] == kv_cache.model_slot_bytes(model, 24)


@pytest.mark.parametrize("layers", [2, 4])
def test_prefill_and_sequential_routes_agree_in_f32(layers):
    """The two serving routes of the hybrid in f32, the shared block after
    every 2 layers: ``prefill`` over the prompt (the scan and attention
    kernels' plain versions) then ``decode_step``, against the engine's
    sequential route (every prompt token through ``decode_step``).  Both
    give the same 16 greedy tokens, and each route's logits at every
    step equal the reference's ``prefill`` / ``decode_step`` on the same
    tokens within 1e-5 of their scale.  (On the card in bf16 at 81
    layers the routes part after 4 tokens: ROADMAP.md, queue C.)"""
    jm, tree = _reference("zamba2_7b", num_layers=layers)
    model, cfg = _port("zamba2_7b", tree, num_layers=layers)
    assert cfg.hybrid.shared_every == 2
    prompt = np.random.default_rng(11).integers(0, cfg.vocab, 12,
                                                dtype=np.int32)
    n_new = 16
    engine = ServeEngine(model, batch_size=1, max_len=32, prefill_chunk=8)
    engine.submit(Request(rid=0, prompt=prompt, max_new_tokens=n_new))
    seq_tokens = engine.run()[0].out_tokens
    max_len = engine.cache_len
    with torch.no_grad():
        logits, cache = model.prefill(torch.from_numpy(prompt[None]),
                                      max_len=max_len)
        route = [logits[0]]
        toks = [int(logits[0].argmax())]
        while len(toks) < n_new:
            logits, cache = model.decode_step(torch.tensor([toks[-1]]),
                                              cache)
            route.append(logits[0])
            toks.append(int(logits[0].argmax()))
    assert toks == seq_tokens
    jparams = jax.tree.map(jnp.asarray, tree)
    jlogits, jcache = jm.prefill(jparams, jnp.asarray(prompt[None]),
                                 max_len=max_len)
    want = [jlogits[0]]
    step = jax.jit(jm.decode_step)
    for tok in toks[:-1]:
        jlogits, jcache = step(jparams, jnp.asarray([tok], jnp.int32),
                               jcache)
        want.append(jlogits[0])
    for i, (got, w) in enumerate(zip(route, want)):
        _close(got, w, 1e-5, f"prefill route, token {i}")
    # The sequential route, by hand: the prompt, then the same tokens.
    seq_cache = model.init_cache(1, max_len)._replace(
        length=torch.zeros(1, dtype=torch.int32))
    with torch.no_grad():
        for tok in prompt:
            logits, seq_cache = model.decode_step(torch.tensor([int(tok)]),
                                                  seq_cache)
        seq = [logits[0]]
        for tok in toks[:-1]:
            logits, seq_cache = model.decode_step(torch.tensor([tok]),
                                                  seq_cache)
            seq.append(logits[0])
    for i, (got, w) in enumerate(zip(seq, want)):
        _close(got, w, 1e-5, f"sequential route, token {i}")


# ---------------------------------------------------------------------------
# Convert, AdamW, CLIs
# ---------------------------------------------------------------------------


def test_convert_round_trip(zamba):
    _, tree, _ = zamba
    _, cfg = _port("zamba2_7b", tree)
    sd = params_from_numpy(tree, cfg)
    assert "shared.attn.o.cores.0" in sd and "layers.3.mamba.A_log" in sd
    back = to_numpy_tree(sd, cfg)
    jax.tree.map(np.testing.assert_array_equal, back, tree)


def test_adamw_decays_every_zamba2_leaf_the_reference_decays(zamba):
    """The reference decays every leaf of rank >= 2: every stacked Mamba
    leaf (``A_log``, ``D_skip``, ``norm`` included), no 1-D shared or
    final-norm scale."""
    _, tree, _ = zamba
    model, _ = _port("zamba2_7b", tree)
    want = {}
    jax.tree_util.tree_map_with_path(
        lambda path, a: want.__setitem__(
            ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path), (a.ndim, a.ndim >= 2)), tree)
    seen = set()
    for name, p in model.named_parameters():
        ref_name = ("layers." + name.split(".", 2)[2]
                    if name.startswith("layers.") else name)
        ndim, decays = want[ref_name]
        assert reference_ndim(name, p) == ndim, name
        assert AdamW.decays(name, p) == decays, name
        seen.add(ref_name)
    assert seen == set(want)
    for leaf in ("layers.mamba.A_log", "layers.mamba.D_skip",
                 "layers.mamba.norm", "layers.ln.scale"):
        assert want[leaf][1]
    assert not want["shared.ln1.scale"][1]


def test_train_cli_runs_zamba2_on_the_cpu(capsys):
    train_cli.main(["--arch", "zamba2_7b", "--smoke", "--tnn",
                    "--tnn-backend", "cuda", "--device", "cpu", "--steps",
                    "2", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "step     1 loss" in out and "done: final loss" in out


def test_train_takes_a_tnn_config():
    arch = tbase.get("zamba2_7b")
    out = train_cli.train("zamba2_7b", smoke=True, tnn=True, steps=1,
                          global_batch=2, seq_len=16, lr=1e-3,
                          tnn_backend="cuda", device="cpu",
                          tnn_cfg=arch.tnn_one_card)
    cfg = out["cfg"]
    assert cfg.tnn.targets == TARGETS and cfg.tnn.backend == "cuda"
    assert np.isfinite(out["losses"]).all()


def test_serve_cli_serves_zamba2_on_the_cpu(capsys):
    done = serve_cli.main(["--arch", "zamba2_7b", "--smoke", "--tnn",
                           "--tnn-backend", "cuda", "--device", "cpu",
                           "--requests", "3", "--batch", "2",
                           "--prompt-len", "6", "--max-new", "3"])
    assert len(done) == 3 and all(len(r.out_tokens) == 3 for r in done)
    assert "backend cuda" in capsys.readouterr().out
