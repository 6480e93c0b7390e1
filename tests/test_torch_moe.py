"""The MoE family (``olmoe_1b_7b``, ``qwen3_moe_235b_a22b``) in the port
against the JAX reference.

The reference runs at f32 on ``tnn_default``'s ``einsum`` backend; the
port on its ``cuda`` backend (the kernels' plain versions on the CPU)
and, where said, on ``einsum``.  Inputs are numpy-seeded.  Tolerances
are ``tests/test_torch_dense.py``'s: logits, outputs and losses 1e-5
relative, gradients 4e-5 of each leaf's scale, three AdamW steps as
there.

* configs field for field, and ``olmoe_1b_7b``'s full parameter count
  (1,565,067,264 under ``tnn_default``) by config arithmetic against the
  reference's abstract init;
* the ``MoE`` block: output, ``lb_loss`` and ``z_loss`` with dense and
  with TT experts; a router biased so that assignments are dropped, whose
  slot tables equal the reference's dispatch exactly (read from the
  reference's own gather) and a numpy oracle's, with the combine exact
  against the reference's scatter-add at f32;
* the LM's logits, loss (with its ``lb_loss`` / ``z_loss``) and
  gradients, with and without remat; three AdamW steps; ``prefill`` then
  ``decode_step`` against ``forward`` and the reference;
* the convert round trip, checkpoints written by either package and
  restored by the other, the memory planner's stash sites, the serving
  profiles' expert layers;
* the batched plain kernels against a loop of the 2-D ones, and the
  expert-batched plans against one plan run per expert (one batched
  launch per plan op, counted on the CPU through the plain versions);
* the refusals (quantized experts, ``phase_paths=False``), and the train
  and serve CLIs on the CPU.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import memory as jmemory  # noqa: E402
from repro.checkpoint import store as jstore  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models.lm import LM as JLM  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW  # noqa: E402
from repro_torch import memory  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import params_from_numpy, to_numpy_tree  # noqa: E402
from repro_torch.core import contraction, factorizations, tensorized  # noqa: E402
from repro_torch.core.tensorized import TensorizedLinear  # noqa: E402
from repro_torch.kernels import fused_contraction as fc  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.optim.adamw import AdamW, OptState  # noqa: E402
from repro_torch.serving import profiles  # noqa: E402

MOE = ["olmoe_1b_7b", "qwen3_moe_235b_a22b"]
#: olmoe_1b_7b's parameters under ``tnn_default``
OLMOE_PARAMS = 1_565_067_264


def _close(got, want, rel, what=""):
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()),
                                              1e-30), err_msg=what)


def _reference(arch_id, seed=0):
    """The reference smoke LM (f32, ``tnn_default``) and its init as
    numpy, the norm scales drawn from a numpy seed."""
    jarch = jbase.get(arch_id)
    jm = JLM(dataclasses.replace(jarch.smoke(jarch.tnn_default),
                                 compute_dtype=jnp.float32))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    rng = np.random.default_rng(seed)

    def draw(path, a):
        if "scale" in jax.tree_util.keystr(path):
            a = a + 0.1 * rng.standard_normal(a.shape)
        return np.asarray(a, np.float32)

    return jm, jax.tree_util.tree_map_with_path(draw, tree)


def _port(arch_id, tree, backend="cuda", remat=None):
    arch = tbase.get(arch_id)
    model, cfg = steps.build_model(arch, tnn=arch.tnn_default, smoke=True,
                                   device="cpu", backend=backend,
                                   compute_dtype=torch.float32)
    if remat is not None:
        cfg = model.cfg = dataclasses.replace(cfg, remat=remat)
    model.load_state_dict(params_from_numpy(tree, cfg))
    return model, cfg


def _batches(vocab, n=3, seed=7, t=33):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, (2, t)).astype(np.int32)
        out.append({"inputs": toks[:, :-1], "targets": toks[:, 1:]})
    return out


@pytest.fixture(scope="module", params=MOE)
def moe(request):
    jm, tree = _reference(request.param)
    return request.param, jm, tree, _batches(jm.cfg.vocab)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch_id", MOE)
def test_configs_are_the_reference_configs(arch_id):
    arch, jarch = tbase.get(arch_id), jbase.get(arch_id)
    assert arch.family == jarch.family == "moe"
    for make in ("model", "smoke"):
        got = getattr(arch, make)(arch.tnn_default)
        want = getattr(jarch, make)(jarch.tnn_default)
        for f in ("name", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "hd", "d_ff", "vocab", "block",
                  "qkv_bias", "rope_theta", "norm_eps", "tie_embeddings",
                  "q_chunk", "kv_chunk", "remat"):
            assert getattr(got, f) == getattr(want, f), (make, f)
        assert dataclasses.asdict(got.moe) == dataclasses.asdict(want.moe)
    assert arch.model().moe.capacity_factor == 1.25


def _arithmetic_params(cfg) -> int:
    """Parameters of a MoE LM from its config: dense q/k/v/o, the f32
    router, E experts' TT cores for gate/up/down, two norms a layer, the
    embedding, ``lm_head`` and the final norm."""
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    tnn, m = cfg.tnn, cfg.moe

    def tt(d_in, d_out):
        fact = factorizations.make(
            tnn.method, factorizations.factorize_dim(d_out, tnn.num_factors),
            factorizations.factorize_dim(d_in, tnn.num_factors), tnn.rank)
        return fact.num_params

    attn = 2 * D * H * hd + 2 * D * KV * hd
    experts = m.num_experts * (2 * tt(D, m.d_ff_expert)
                               + tt(m.d_ff_expert, D))
    layer = attn + D * m.num_experts + experts + 2 * D
    return cfg.num_layers * layer + 2 * cfg.vocab * D + D


def test_olmoe_parameter_count_by_config_arithmetic():
    arch = tbase.get("olmoe_1b_7b")
    for name in MOE:
        a = tbase.get(name)
        smoke, _ = steps.build_model(a, tnn=a.tnn_default, smoke=True,
                                     device="cpu")
        assert sum(p.numel() for p in smoke.parameters()) == (
            _arithmetic_params(smoke.cfg))
    assert _arithmetic_params(arch.model(arch.tnn_default)) == OLMOE_PARAMS
    jarch = jbase.get("olmoe_1b_7b")
    shapes = jax.eval_shape(JLM(jarch.model(jarch.tnn_default)).init,
                            jax.random.key(0))
    assert sum(math.prod(s.shape) for s in jax.tree.leaves(shapes)) == (
        OLMOE_PARAMS)


def test_unported_families_still_raise_and_moe_builds():
    for arch_id in ("no_such_arch", "seamless-m4t-large"):
        with pytest.raises(KeyError, match="not ported"):
            tbase.get(arch_id)
    arch = tbase.get("qwen3_moe_235b_a22b")
    full = arch.model()                       # registered, never built
    assert (full.num_layers, full.moe.num_experts) == (94, 128)


# ---------------------------------------------------------------------------
# The MoE block
# ---------------------------------------------------------------------------

D_MODEL, D_FF, E, K = 32, 32, 4, 2


def _block_pair(tnn: bool, backend="cuda", seed=1):
    """The reference ``MoE`` (f32) and the port's with the same numbers."""
    jtnn = (dataclasses.replace(jbase.get("olmoe_1b_7b").tnn_default,
                                backend="einsum") if tnn else None)
    jmoe = jblocks.MoE(D_MODEL, D_FF, E, K, tnn=jtnn,
                       compute_dtype=jnp.float32)
    tree = jax.tree.map(lambda a: np.array(a, np.float32),
                        jmoe.init(jax.random.key(seed)))
    ttnn = (dataclasses.replace(tbase.get("olmoe_1b_7b").tnn_default,
                                backend=backend) if tnn else None)
    moe = blocks.MoE(D_MODEL, D_FF, E, K, tnn=ttnn,
                     compute_dtype=torch.float32, device="cpu")
    moe.load_state_dict(params_from_numpy(tree, None))
    return jmoe, tree, moe


def _recording_shard():
    seen = {}

    def shard(x, axes):
        if axes and axes[0] == "moe_groups":
            seen["xe"] = np.asarray(x)
        return x
    return shard, seen


@pytest.mark.parametrize("tnn,backend", [(False, None), (True, "cuda"),
                                         (True, "einsum")])
def test_moe_block_matches_reference(tnn, backend):
    jmoe, tree, moe = _block_pair(tnn, backend or "cuda")
    x = np.random.default_rng(2).standard_normal(
        (3, 16, D_MODEL)).astype(np.float32)
    jy, jaux = jmoe(jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    with torch.no_grad():
        y, aux = moe(torch.from_numpy(x))
    _close(y, jy, 1e-5, "y")
    for k in ("lb_loss", "z_loss"):
        assert float(aux[k]) == pytest.approx(float(jaux[k]), rel=1e-5), k


def _oracle_tables(eidx, gates, n_exp, cap):
    """The dispatch rule in plain numpy: each pick's slot is its rank
    among its expert's picks in token-major, k-descending order."""
    G, Ts, k = eidx.shape
    tok = np.zeros((G, n_exp, cap), np.int64)
    gate = np.zeros((G, n_exp, cap), np.float32)
    for g in range(G):
        used = [0] * n_exp
        for t in range(Ts):
            for j in range(k):
                e = eidx[g, t, j]
                if used[e] < cap:
                    tok[g, e, used[e]] = t
                    gate[g, e, used[e]] = gates[g, t, j]
                used[e] += 1
    return tok, gate


def test_dropped_assignments_match_reference_exactly():
    """A router biased towards expert 0 overfills it (every token picks
    it; capacity 24 of 32 tokens): the dropped picks, the slot tables
    and the empty slots (token 0, gate 0) are the reference's."""
    jmoe, tree, moe = _block_pair(False, seed=3)
    tree["router"]["w"][:, 0] += 1.0
    moe.load_state_dict(params_from_numpy(tree, None))
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 32, D_MODEL)) + 2.0).astype(np.float32)
    shard, seen = _recording_shard()
    jy, _ = jmoe(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), shard)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        slot_tok, slot_gate, _ = moe.route(xt)
        y, _ = moe(xt)
    C = moe.capacity(32)
    assert C == 24 and tuple(slot_tok.shape) == (2, E, C)
    # The reference's dispatch gather, row by row, is x at our table.
    np.testing.assert_array_equal(
        seen["xe"], x[np.arange(2)[:, None, None], slot_tok.numpy()])
    with torch.no_grad():
        probs = torch.softmax(moe.router(xt.float()), -1)
        g, e = torch.topk(probs, K, dim=-1)
    g = (g / g.sum(-1, keepdim=True)).numpy()
    want_tok, want_gate = _oracle_tables(e.numpy(), g, E, C)
    assert (e[..., 0] == 0).all()                  # expert 0 overfilled
    np.testing.assert_array_equal(slot_tok.numpy(), want_tok)
    np.testing.assert_array_equal(slot_gate.numpy(), want_gate)
    assert (slot_gate[:, 0] > 0).all()             # 24 of 32 kept
    _close(y, jy, 1e-5, "y with drops")

    # The combine, given the same expert outputs, is the reference's
    # scatter-add bit for bit at f32.
    ye = rng.standard_normal((2, E, C, D_MODEL)).astype(np.float32)

    def combine_group(ye_g, tok_g, gate_g):
        w = ye_g * gate_g[..., None]
        return jnp.zeros((32, D_MODEL), ye_g.dtype).at[
            tok_g.reshape(-1)].add(w.reshape(-1, D_MODEL))

    want = jax.vmap(combine_group)(jnp.asarray(ye),
                                   jnp.asarray(slot_tok.numpy()),
                                   jnp.asarray(slot_gate.numpy()))
    got = blocks.moe_combine(torch.from_numpy(ye), slot_tok, slot_gate, 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ts", [1, 32, 128, 24 * 8])
def test_capacity_is_the_reference_rule(ts):
    jmoe = jblocks.MoE(2048, 1024, 64, 8)
    assert blocks.moe_capacity(ts, 8, 64, 1.25) == jmoe._capacity(ts)
    assert blocks.moe_capacity(128, 8, 64, 1.25) == 24


# ---------------------------------------------------------------------------
# The LM: logits, loss, gradients, AdamW steps, serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True])
def test_logits_loss_and_grads_match_reference(moe, remat):
    arch_id, jm, tree, batches = moe
    batch = {k: jnp.asarray(v) for k, v in batches[0].items()}
    jparams = jax.tree.map(jnp.asarray, tree)
    jlogits, _ = jm(jparams, batch["inputs"])
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, batch), has_aux=True)(jparams)
    model, cfg = _port(arch_id, tree, remat=remat)
    tbatch = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    with torch.no_grad():
        _close(model(tbatch["inputs"]), jlogits, 1e-5, "logits")
    loss, met = model.loss(tbatch)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    for k in ("lb_loss", "z_loss"):
        assert float(met[k]) == pytest.approx(float(jmet[k]), rel=1e-5), k
    got = to_numpy_tree({n: p.grad for n, p in model.named_parameters()},
                        cfg)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(jgrads))
    jax.tree_util.tree_map_with_path(
        lambda path, g, w: _close(g, w, 4e-5, jax.tree_util.keystr(path)),
        got, jax.tree.map(np.asarray, jgrads))


def test_train_steps_match_reference(moe):
    """Three AdamW steps against the reference's jitted train step, to
    ``tests/test_torch_dense.py``'s tolerances."""
    arch_id, jm, tree, batches = moe
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=4)
    jopt = JAdamW(**kw)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = {"params": jparams, "opt": jopt.init(jparams)}
    jstep = jax.jit(jsteps.make_train_step(jm, jopt, jblocks.no_shard))
    model, cfg = _port(arch_id, tree)
    opt = AdamW(**kw)
    params = dict(model.named_parameters())
    state = {"params": params, "opt": opt.init(params)}
    step = steps.make_train_step(model, opt)
    lr_sum = 0.0
    for batch in batches:
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        lr_sum += float(jm_["lr"])
        for key, rel in (("loss", 1e-5), ("grad_norm", 1e-4), ("lr", 1e-6),
                         ("lb_loss", 1e-5), ("z_loss", 1e-5)):
            assert float(m[key]) == pytest.approx(float(jm_[key]),
                                                  rel=rel), key
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


def test_prefill_then_decode_matches_forward_and_reference(moe):
    """``prefill`` routes each batch row as one group, as ``forward``
    does, and a token's slot never depends on later tokens, so the
    prompt's last logits equal ``forward``'s; ``decode_step`` routes its
    one token alone (capacity 8), which equals ``forward`` where the
    forward pass dropped none of the last token's picks."""
    arch_id, jm, tree, batches = moe
    toks = batches[1]["inputs"][:, :16]
    model, cfg = _port(arch_id, tree)
    with torch.no_grad():
        full = model(torch.from_numpy(toks))
        lp, cache = model.prefill(torch.from_numpy(toks[:, :-1]), max_len=20)
        ld, new = model.decode_step(torch.from_numpy(toks[:, -1]), cache)
    assert int(cache.length) == 15 and int(new.length) == 16
    _close(lp, full[:, -2], 1e-5, "prefill vs forward")
    if blocks.moe_capacity(16, cfg.moe.top_k, cfg.moe.num_experts,
                           1.25) >= 16:
        _close(ld, full[:, -1], 1e-5, "decode vs forward")
    jparams = jax.tree.map(jnp.asarray, tree)
    jlp, jcache = jm.prefill(jparams, jnp.asarray(toks[:, :-1]), max_len=20)
    jld, jnew = jm.decode_step(jparams, jnp.asarray(toks[:, -1]), jcache)
    _close(lp, jlp, 1e-5, "prefill vs reference")
    _close(ld, jld, 1e-5, "decode vs reference")
    _close(new.k, jnew.layers.k, 1e-5, "decode k")


def test_extend_with_padded_columns_matches_reference(moe):
    """The engine's tick: a chunk at per-slot depths whose padded columns
    are routed too (and take capacity from the real tokens), as the
    reference's ``extend``."""
    arch_id, jm, tree, batches = moe
    model, cfg = _port(arch_id, tree)
    toks = batches[2]["inputs"][:, :8]
    length = np.array([3, 5], np.int32)
    valid = np.array([8, 4], np.int32)
    cache = model.init_cache(2, 24)
    jparams = jax.tree.map(jnp.asarray, tree)
    jcache = jm.init_cache(2, 24)
    rng = np.random.default_rng(9)
    k0 = rng.standard_normal(tuple(cache.k.shape)).astype(np.float32)
    v0 = rng.standard_normal(tuple(cache.v.shape)).astype(np.float32)
    cache = cache._replace(k=torch.from_numpy(k0), v=torch.from_numpy(v0),
                           length=torch.from_numpy(length))
    jcache = jcache._replace(
        layers=jcache.layers._replace(k=jnp.asarray(k0), v=jnp.asarray(v0)),
        length=jnp.asarray(length))
    with torch.no_grad():
        lg, new = model.extend(torch.from_numpy(toks), cache,
                               valid=torch.from_numpy(valid))
    jlg, jnew = jm.extend(jparams, jnp.asarray(toks), jcache,
                          valid=jnp.asarray(valid))
    for row, n in enumerate(valid):
        _close(lg[row, :n], jlg[row, :n], 1e-5, "extend logits")
    assert new.length.tolist() == np.asarray(jnew.length).tolist()


def test_profiles_and_planner_list_the_experts():
    for arch_id in MOE:
        arch, jarch = tbase.get(arch_id), jbase.get(arch_id)
        cfg = arch.smoke(arch.tnn_default)
        model = LM(cfg, device="cpu")
        built = {(m.fact.N, m.fact.M, m.num_experts) for m in model.modules()
                 if isinstance(m, TensorizedLinear)}
        m = cfg.moe
        assert built == {(cfg.d_model, m.d_ff_expert, m.num_experts),
                         (m.d_ff_expert, cfg.d_model, m.num_experts)}
        listed = {(d_in, d_out) for _, d_in, d_out
                  in profiles.tensorized_projections(cfg)}
        assert listed == {(n, mm) for n, mm, _ in built}
        prof = profiles.build_profiles(cfg, batch_size=4, prefill_chunk=32)
        assert {p.tokens for p in prof.values()} == {128, 4}
        assert prof["decode"].expert_tokens == 4 * 8
        assert prof["prefill"].expert_tokens == 4 * blocks.moe_capacity(
            32, m.top_k, m.num_experts, 1.25)
        jcfg = jarch.smoke(jarch.tnn_default)
        for stash in ("store", "recompute", "quantized"):
            got = memory.stash_report(cfg, 8, 128, 1,
                                      memory.StashPolicy.parse(stash))
            want = jmemory.stash_report(
                jcfg, 8, 128, 1, jmemory.StashPolicy.parse(stash))
            assert [(s.name, s.elems_per_token) for s in got.sites] == [
                (s.name, s.elems_per_token) for s in want.sites]
            assert got.peak_bytes == want.peak_bytes
            assert got.describe() == want.describe()


# ---------------------------------------------------------------------------
# Convert and checkpoints
# ---------------------------------------------------------------------------


def test_convert_round_trip_and_weight_decay_ranks(moe):
    arch_id, _, tree, _ = moe
    model, cfg = _port(arch_id, tree)
    sd = params_from_numpy(tree, cfg)
    E = cfg.moe.num_experts
    assert tuple(sd["layers.1.mlp.router.w"].shape) == (cfg.d_model, E)
    core = sd["layers.1.mlp.experts.gate.cores.0"]
    assert core.shape[0] == E
    jax.tree.map(np.testing.assert_array_equal, to_numpy_tree(sd, cfg),
                 tree)
    from repro_torch.convert import reference_ndim
    assert reference_ndim("layers.1.mlp.router.w", sd[
        "layers.1.mlp.router.w"]) == 3
    assert reference_ndim("layers.1.mlp.experts.gate.cores.0", core) == (
        core.dim() + 1)


def _states(arch_id, seed=1):
    """A reference train state with non-trivial leaves and the port's
    state holding the same numbers."""
    jarch, arch = jbase.get(arch_id), tbase.get(arch_id)
    jm = JLM(jarch.smoke(jarch.tnn_default))
    cfg = arch.smoke(arch.tnn_default)
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    rng = np.random.default_rng(seed)

    def draw():
        return jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(
            np.float32), shapes)

    p, m, v = draw(), draw(), draw()
    jstate = {"params": jax.tree.map(jnp.asarray, p),
              "opt": JAdamW().init(p)._replace(
                  m=jax.tree.map(jnp.asarray, m),
                  v=jax.tree.map(jnp.asarray, v),
                  step=jnp.asarray(5, jnp.int32))}

    def port(zero):
        def sd(t):
            out = params_from_numpy(t, cfg)
            return ({n: torch.zeros_like(x) for n, x in out.items()}
                    if zero else out)
        return {"params": sd(p), "opt": OptState(
            m=sd(m), v=sd(v),
            step=torch.tensor(0 if zero else 5, dtype=torch.int32),
            master=None)}
    return jstate, port, cfg


def _equal(port_state, jtree):
    want = jax.tree_util.tree_leaves(jtree)
    got = store.leaf_slots(port_state)
    assert len(got) == len(want)
    for slot, w in zip(got, want):
        g = (torch.stack([t.detach() for t in slot]) if len(slot) > 1
             else slot[0].detach())
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("arch_id", MOE)
def test_checkpoints_restore_across_packages(arch_id, writer, tmp_path):
    jstate, port, _ = _states(arch_id)
    if writer == "port":
        state = port(zero=False)
        store.save(str(tmp_path), 5, state)
        step, got = jstore.restore(str(tmp_path),
                                   jax.tree.map(jnp.zeros_like, jstate))
        assert step == 5
        _equal(state, got)
    else:
        jstore.save(str(tmp_path), 5, jstate)
        step, got = store.restore(str(tmp_path), port(zero=True))
        assert step == 5 and int(got["opt"].step) == 5
        _equal(got, jstate)


# ---------------------------------------------------------------------------
# The batched kernels' plain versions and the batched plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("trans", [False, True])
def test_batched_plain_gemm_is_a_loop_of_2d(dtype, trans):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, 24, 12, generator=g).to(dtype)
    w = torch.randn(5, *((10, 12) if trans else (12, 10)),
                    generator=g).to(dtype)
    got = fc.matmul_cuda(x, w, transpose_rhs=trans)
    want = torch.stack([ref.matmul(x[e], w[e], transpose_rhs=trans)
                        for e in range(5)])
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(ref.matmul(x, w, transpose_rhs=trans), want)
    with pytest.raises(fc.ChainLoweringError, match="batch mismatch"):
        fc.matmul_cuda(x, w[:4], transpose_rhs=trans)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_plain_chain_is_a_loop_of_2d(dtype):
    g = torch.Generator().manual_seed(1)
    shapes = [(16, 8), (32, 4), (8, 6)]
    x = torch.randn(3, 64, 16, generator=g).to(dtype)
    ws = [torch.randn(3, *s, generator=g).to(dtype) for s in shapes]
    got = fc.chain_n_cuda(x, ws)
    want = torch.stack([ref.chain_n(x[e], [w[e] for w in ws])
                        for e in range(3)])
    assert tuple(got.shape) == (3, 64 // 4 // 2, 6)
    # The wrapper on the CPU is the plain version; a batched f32 product
    # may block its sums otherwise than a 2-D one.
    assert torch.equal(got, ref.chain_n(x, ws))
    _close(got, want.float(), 1e-6 if dtype == torch.float32 else 0.0,
           "chain")


@pytest.mark.parametrize("tokens", [8, 32, 48])
def test_expert_batched_plans_equal_one_run_per_expert(tokens):
    """Every FP/BP/WG plan of an expert-stacked layer, run once for all
    experts (``batch=E``) on both backends, equals the plan run for each
    expert alone; gradients too."""
    arch = tbase.get("olmoe_1b_7b")
    tnn = dataclasses.replace(arch.tnn_default, backend="cuda", rank=8)
    n_exp = 3
    layer = tensorized.make_tensorized_linear(
        48, 32, tnn, compute_dtype=torch.float32, num_experts=n_exp,
        generator=torch.Generator().manual_seed(2))
    twin = tensorized.make_tensorized_linear(
        48, 32, tnn, compute_dtype=torch.float32)
    x = torch.randn(n_exp, tokens, 32, generator=torch.Generator()
                    .manual_seed(3), requires_grad=True)
    y = layer(x)
    dy = torch.randn_like(y)
    (y * dy).sum().backward()
    for e in range(n_exp):
        with torch.no_grad():
            for c, ce in zip(twin.cores, layer.cores):
                c.copy_(ce[e])
        twin.zero_grad()
        xe = x.detach()[e].clone().requires_grad_(True)
        ye = twin(xe)
        (ye * dy[e]).sum().backward()
        _close(y[e], ye.detach(), 1e-6, f"y[{e}]")
        _close(x.grad[e], xe.grad, 1e-6, f"dx[{e}]")
        for i, (c, ce) in enumerate(zip(twin.cores, layer.cores)):
            _close(ce.grad[e], c.grad, 1e-6, f"dcore{i}[{e}]")
    fact = layer.fact
    for phase, results in tensorized.phase_plans(fact, tokens,
                                                 layer.opts).items():
        for r in results:
            net = r.plan.network
            ts = [torch.randn((n_exp,) + net.node_shape(i))
                  for i in range(net.num_nodes)]
            want = torch.stack([contraction.execute(
                r.plan, [t[e] for t in ts], backend="einsum")
                for e in range(n_exp)])
            for backend in ("einsum", "cuda"):
                got = contraction.execute(r.plan, ts, backend=backend,
                                          batch=n_exp)
                _close(got, want, 1e-6, f"{phase} {backend}")


def test_expert_plans_launch_once_per_op_on_the_cpu(monkeypatch):
    """On the CPU the plain versions run, but the plan compiler calls the
    wrappers once per plan op for all experts, never once per expert."""
    from repro_torch.core import plan_compiler
    calls = []
    real_mm, real_chain = plan_compiler.matmul_cuda, plan_compiler.chain_n_cuda

    def mm(x, w, **kw):
        calls.append(("gemm", x.dim()))
        return real_mm(x, w, **kw)

    def chain(x, ws, **kw):
        calls.append(("chain", x.dim()))
        return real_chain(x, ws, **kw)

    monkeypatch.setattr(plan_compiler, "matmul_cuda", mm)
    monkeypatch.setattr(plan_compiler, "chain_n_cuda", chain)
    arch = tbase.get("olmoe_1b_7b")
    tnn = dataclasses.replace(arch.tnn_default, backend="cuda")
    layer = tensorized.make_tensorized_linear(64, 64, tnn,
                                              num_experts=4)
    x = torch.randn(4, 16, 64, requires_grad=True)
    layer(x).sum().backward()
    ops = 0
    for results in tensorized.phase_plans(layer.fact, 16,
                                          layer.opts).values():
        for r in results:
            compiled = plan_compiler.compile_cached(
                r.plan, fuse=layer.opts.fused_chain,
                max_chain_len=layer.opts.max_chain_len)
            ops += sum(not isinstance(op, plan_compiler.EinsumOp)
                       for op in compiled.ops)
    assert len(calls) == ops and all(d == 3 for _, d in calls)


# ---------------------------------------------------------------------------
# Refusals and the CLIs
# ---------------------------------------------------------------------------


def test_quantized_and_phase_paths_off_experts_are_refused():
    arch = tbase.get("olmoe_1b_7b")
    with pytest.raises(NotImplementedError, match="item 13"):
        train_cli.train("olmoe_1b_7b", smoke=True, tnn=True, steps=1,
                        global_batch=2, seq_len=8, lr=1e-3, device="cpu",
                        tnn_precision="fp8")
    with pytest.raises(NotImplementedError, match="item 13"):
        steps.build_model(arch, dataclasses.replace(
            arch.tnn_default, remat="quantized"), smoke=True, device="cpu")
    with pytest.raises(NotImplementedError, match="item 14"):
        steps.build_model(arch, dataclasses.replace(
            arch.tnn_default, phase_paths=False), smoke=True, device="cpu")
    model, _ = steps.build_model(arch, arch.tnn_default, smoke=True,
                                 device="cpu")
    layer = model.layers[0].mlp.experts["gate"]
    layer.phase_paths = False
    with pytest.raises(NotImplementedError, match="item 14"):
        model(torch.zeros((1, 4), dtype=torch.long))


@pytest.mark.parametrize("arch_id", MOE)
def test_train_cli_runs_moe_on_the_cpu(arch_id, capsys):
    train_cli.main(["--arch", arch_id, "--smoke", "--tnn",
                    "--tnn-backend", "cuda", "--device", "cpu", "--steps",
                    "2", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "step     1 loss" in out and "lb " in out and "z " in out
    assert "done: final loss" in out


@pytest.mark.parametrize("arch_id", MOE)
def test_serve_cli_serves_moe_on_the_cpu(arch_id, capsys):
    done = serve_cli.main(["--arch", arch_id, "--smoke", "--tnn",
                           "--tnn-backend", "cuda", "--device", "cpu",
                           "--requests", "3", "--batch", "2",
                           "--prompt-len", "6", "--max-new", "3"])
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(len(r.out_tokens) == 3 for r in done)
    assert "experts" in capsys.readouterr().out
