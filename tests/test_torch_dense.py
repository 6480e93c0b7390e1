"""The dense GQA family (``tinyllama_1_1b``, ``internlm2_1_8b``,
``phi4_mini_3_8b``, ``qwen2_7b``) in the port against the JAX reference.

Weights are the reference's init of each smoke config under its
``tnn_default`` (TT rank 64, 2 factors, the MLP), with qwen2's
zero-initialised QKV biases and the norm scales drawn from a numpy seed
first, so the bias path is exercised; the port gets them through
``convert.params_from_numpy``.  In f32, one parametrised case per config:

* the configs equal the reference's (model and smoke, field for field);
  the full models' parameter counts by config arithmetic, with no model
  built, equal the reference's abstract init;
* logits and loss within 1e-5 relative, gradients within 4e-5 of each
  leaf's scale; three AdamW steps against the reference's jitted
  ``make_train_step`` (parameters, m and v per leaf for 99.9% of the
  elements, as ``tests/test_torch_zamba2.py``);
* ``LM.prefill`` then ``decode_step`` against the port's ``forward`` and
  the reference's ``prefill`` / ``decode_step`` (1e-5), the K/V caches
  too, and through ``steps.make_prefill_step`` / ``make_decode_step``;
* GQA at qwen2_7b's group of 7 (28 heads over 4) at a narrow head dim,
  the training forward and the serving ``extend`` with a bias, against
  the reference's ``Attention``;
* the convert round trip (the bias leaves included), the serving
  profiles' projections, and the train and serve CLIs on the CPU (the
  serve CLI with an fp8 KV cache).
"""

import dataclasses
import math

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
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import params_from_numpy, to_numpy_tree  # noqa: E402
from repro_torch.core import factorizations  # noqa: E402
from repro_torch.core.tensorized import TensorizedLinear  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.blocks import Attention, KVCache  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.serving import profiles  # noqa: E402

DENSE = ["tinyllama_1_1b", "internlm2_1_8b", "phi4_mini_3_8b", "qwen2_7b"]
#: the full models' parameters under ``tnn_default``, by config arithmetic
FULL_PARAMS = {"tinyllama_1_1b": 373_182_464, "internlm2_1_8b": 722_733_056,
               "phi4_mini_3_8b": 2_092_305_408, "qwen2_7b": 1_980_923_392}
DRAWN = ("'b'", "scale")


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
    numpy, the biases and norm scales drawn from a numpy seed."""
    jarch = jbase.get(arch_id)
    jm = JLM(dataclasses.replace(jarch.smoke(jarch.tnn_default),
                                 compute_dtype=jnp.float32))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = jax.tree_util.keystr(path)
        if any(k in name for k in DRAWN):
            a = a + 0.1 * rng.standard_normal(a.shape)
        return np.asarray(a, np.float32)

    return jm, jax.tree_util.tree_map_with_path(draw, tree)


def _port(arch_id, tree, backend="cuda"):
    arch = tbase.get(arch_id)
    model, cfg = steps.build_model(arch, tnn=arch.tnn_default, smoke=True,
                                   device="cpu", backend=backend,
                                   compute_dtype=torch.float32)
    model.load_state_dict(params_from_numpy(tree, cfg))
    return model, cfg


def _batches(vocab, n=3, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, (2, 33)).astype(np.int32)
        out.append({"inputs": toks[:, :-1], "targets": toks[:, 1:]})
    return out


@pytest.fixture(scope="module", params=DENSE)
def dense(request):
    jm, tree = _reference(request.param)
    return request.param, jm, tree, _batches(jm.cfg.vocab)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch_id", DENSE)
def test_configs_are_the_reference_configs(arch_id):
    arch, jarch = tbase.get(arch_id), jbase.get(arch_id)
    assert arch.family == jarch.family == "dense"
    for f in dataclasses.fields(arch.tnn_default):    # the port's fields
        assert repr(getattr(arch.tnn_default, f.name)) == repr(
            getattr(jarch.tnn_default, f.name)), f.name
    for make in ("model", "smoke"):
        got = getattr(arch, make)(arch.tnn_default)
        want = getattr(jarch, make)(jarch.tnn_default)
        for f in ("name", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "hd", "d_ff", "vocab", "block",
                  "qkv_bias", "rope_theta", "norm_eps", "tie_embeddings",
                  "q_chunk", "kv_chunk", "remat"):
            assert getattr(got, f) == getattr(want, f), (make, f)
    assert arch.model().qkv_bias == (arch_id == "qwen2_7b")


def _arithmetic_params(cfg) -> int:
    """Parameters of an attention LM from its config alone: dense
    q/k/v/o (and the QKV bias), the TT MLP's cores, the two norms a
    layer, the embedding, ``lm_head`` and the final norm."""
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    tnn = cfg.tnn

    def tt(d_in, d_out):
        fact = factorizations.make(
            tnn.method, factorizations.factorize_dim(d_out, tnn.num_factors),
            factorizations.factorize_dim(d_in, tnn.num_factors), tnn.rank)
        return fact.num_params

    attn = 2 * D * H * hd + 2 * D * KV * hd
    if cfg.qkv_bias:
        attn += H * hd + 2 * KV * hd
    mlp = 2 * tt(D, cfg.d_ff) + tt(cfg.d_ff, D)
    return cfg.num_layers * (attn + mlp + 2 * D) + 2 * cfg.vocab * D + D


@pytest.mark.parametrize("arch_id", DENSE)
def test_parameter_counts_by_config_arithmetic(arch_id):
    """The arithmetic holds on the smoke model (built) and gives the full
    model's count, which equals the reference's abstract init (no array
    is made on either side)."""
    arch = tbase.get(arch_id)
    smoke, _ = steps.build_model(arch, tnn=arch.tnn_default, smoke=True,
                                 device="cpu")
    assert sum(p.numel() for p in smoke.parameters()) == _arithmetic_params(
        smoke.cfg)
    full = arch.model(arch.tnn_default)
    assert _arithmetic_params(full) == FULL_PARAMS[arch_id]
    jarch = jbase.get(arch_id)
    shapes = jax.eval_shape(JLM(jarch.model(jarch.tnn_default)).init,
                            jax.random.key(0))
    assert sum(math.prod(s.shape) for s in jax.tree.leaves(shapes)) == (
        FULL_PARAMS[arch_id])


def test_profiles_list_the_tensorized_mlp():
    for arch_id in DENSE:
        arch = tbase.get(arch_id)
        cfg = arch.smoke(arch.tnn_default)
        model = LM(cfg, device="cpu")
        built = {(m.fact.N, m.fact.M) for m in model.modules()
                 if isinstance(m, TensorizedLinear)}
        listed = {(d_in, d_out) for _, d_in, d_out
                  in profiles.tensorized_projections(cfg)}
        assert built == listed == {(cfg.d_model, cfg.d_ff),
                                   (cfg.d_ff, cfg.d_model)}


# ---------------------------------------------------------------------------
# Training: logits, loss, gradients, AdamW steps
# ---------------------------------------------------------------------------


def test_logits_loss_and_grads_match_reference(dense):
    arch_id, jm, tree, batches = dense
    batch = {k: jnp.asarray(v) for k, v in batches[0].items()}
    jparams = jax.tree.map(jnp.asarray, tree)
    jlogits, _ = jm(jparams, batch["inputs"])
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, batch), has_aux=True)(jparams)
    model, cfg = _port(arch_id, tree)
    tbatch = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    with torch.no_grad():
        _close(model(tbatch["inputs"]), jlogits, 1e-5, "logits")
    loss, _ = model.loss(tbatch)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    got = to_numpy_tree({n: p.grad for n, p in model.named_parameters()},
                        cfg)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(jgrads))
    jax.tree_util.tree_map_with_path(
        lambda path, g, w: _close(g, w, 4e-5, jax.tree_util.keystr(path)),
        got, jax.tree.map(np.asarray, jgrads))


def test_train_steps_match_reference(dense):
    """Three AdamW steps against the reference's jitted train step: loss
    1e-5, grad norm 1e-4, lr 1e-6; parameters 1e-5, first moments 1e-4,
    second 2e-4 of each leaf's scale for 99.9% of all elements, and
    every parameter within twice the summed learning rate (Adam turns
    f32 roundoff in a nearly cancelling gradient into a step of up to
    lr: ``tests/test_torch_zamba2.py``)."""
    arch_id, jm, tree, batches = dense
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


# ---------------------------------------------------------------------------
# Serving: prefill, decode, GQA, bias
# ---------------------------------------------------------------------------


def test_prefill_then_decode_matches_forward_and_reference(dense):
    arch_id, jm, tree, batches = dense
    toks = batches[1]["inputs"][:, :16]
    model, cfg = _port(arch_id, tree)
    with torch.no_grad():
        full = model(torch.from_numpy(toks))
        lp, cache = model.prefill(torch.from_numpy(toks[:, :-1]), max_len=20)
        ld, new = model.decode_step(torch.from_numpy(toks[:, -1]), cache)
    shape = (cfg.num_layers, 2, 20, cfg.num_kv_heads, cfg.hd)
    assert tuple(cache.k.shape) == tuple(cache.v.shape) == shape
    assert int(cache.length) == 15 and int(new.length) == 16
    assert not bool(cache.k[:, :, 15:].any())
    _close(lp, full[:, -2], 1e-5, "prefill vs forward")
    _close(ld, full[:, -1], 1e-5, "decode vs forward")
    jparams = jax.tree.map(jnp.asarray, tree)
    jlp, jcache = jm.prefill(jparams, jnp.asarray(toks[:, :-1]), max_len=20)
    jld, jnew = jm.decode_step(jparams, jnp.asarray(toks[:, -1]), jcache)
    _close(lp, jlp, 1e-5, "prefill vs reference")
    _close(ld, jld, 1e-5, "decode vs reference")
    for got, want, what in ((cache.k, jcache.layers.k, "prefill k"),
                            (cache.v, jcache.layers.v, "prefill v"),
                            (new.k, jnew.layers.k, "decode k"),
                            (new.v, jnew.layers.v, "decode v")):
        _close(got, want, 1e-5, what)
    assert int(jnew.length) == int(new.length)

    # The launcher's step builders drive the same two calls.
    prefill_step = steps.make_prefill_step(model, 20)
    decode_step = steps.make_decode_step(model)
    lp2, c2 = prefill_step(toks[:, :-1])
    ld2, _ = decode_step(toks[:, -1], c2)
    assert torch.equal(lp2, lp) and torch.equal(ld2, ld)


def _reference_attention(H, KV, D, d_model, bias):
    return jblocks.Attention(d_model, H, KV, D, qkv_bias=bias, q_chunk=8,
                             kv_chunk=8, compute_dtype=jnp.float32)


@pytest.mark.parametrize("heads", [(28, 4, 8), (16, 8, 16), (32, 4, 8)])
def test_gqa_attention_matches_reference(heads):
    """qwen2_7b's group of 7 (28 / 4), internlm2's 2 and tinyllama's 8 at
    narrow head dims, with a QKV bias: the training forward (flash path,
    two q and kv chunks) and the serving ``extend`` at per-slot depths."""
    H, KV, D = heads
    d_model = 32
    ja = _reference_attention(H, KV, D, d_model, True)
    rng = np.random.default_rng(3)
    tree = jax.tree.map(
        lambda a: np.asarray(a + 0.1 * rng.standard_normal(a.shape),
                             np.float32),
        jax.tree.map(np.asarray, ja.init(jax.random.key(1))))
    attn = Attention(d_model, H, KV, D, qkv_bias=True, q_chunk=8,
                     kv_chunk=8, compute_dtype=torch.float32, device="cpu")
    attn.load_state_dict(params_from_numpy(tree, None))
    x = rng.standard_normal((2, 16, d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16)[None], (2, 16))
    jparams = jax.tree.map(jnp.asarray, tree)
    with torch.no_grad():
        got = attn(torch.from_numpy(x), torch.from_numpy(pos.copy()))
    _close(got, ja(jparams, jnp.asarray(x), jnp.asarray(pos)), 1e-5,
           "forward")
    length = np.array([3, 7], np.int32)
    k0 = rng.standard_normal((2, 24, KV, D)).astype(np.float32)
    v0 = rng.standard_normal((2, 24, KV, D)).astype(np.float32)
    valid = np.array([5, 2], np.int32)
    with torch.no_grad():
        out, new = attn.extend(torch.from_numpy(x[:, :5]), KVCache(
            torch.from_numpy(k0), torch.from_numpy(v0),
            torch.from_numpy(length)), valid=torch.from_numpy(valid))
    jout, jnew = ja.extend(jparams, jnp.asarray(x[:, :5]), jblocks.KVCache(
        jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(length)),
        valid=jnp.asarray(valid))
    for row, n in enumerate(valid):
        _close(out[row, :n], jout[row, :n], 1e-5, "extend")
    _close(new.k, jnew.k, 1e-5, "extend k")
    assert new.length.tolist() == np.asarray(jnew.length).tolist()


def test_convert_round_trip_carries_the_bias(dense):
    arch_id, _, tree, _ = dense
    _, cfg = _port(arch_id, tree)
    sd = params_from_numpy(tree, cfg)
    assert ("layers.1.attn.q.b" in sd) == cfg.qkv_bias
    assert "layers.1.mlp.down.cores.3" in sd
    jax.tree.map(np.testing.assert_array_equal, to_numpy_tree(sd, cfg),
                 tree)


# ---------------------------------------------------------------------------
# CLIs on the CPU
# ---------------------------------------------------------------------------


def test_train_cli_runs_qwen2_on_the_cpu(capsys):
    train_cli.main(["--arch", "qwen2_7b", "--smoke", "--tnn",
                    "--tnn-backend", "cuda", "--device", "cpu", "--steps",
                    "2", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "step     1 loss" in out and "done: final loss" in out


@pytest.mark.parametrize("kv", ["bf16", "fp8"])
def test_serve_cli_serves_qwen2_on_the_cpu(kv):
    done = serve_cli.main(["--arch", "qwen2_7b", "--smoke", "--tnn",
                           "--tnn-backend", "cuda", "--device", "cpu",
                           "--serve-kv-dtype", kv, "--requests", "3",
                           "--batch", "2", "--prompt-len", "6",
                           "--max-new", "3"])
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(len(r.out_tokens) == 3 for r in done)
