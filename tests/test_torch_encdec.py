"""The encoder-decoder family (``seamless_m4t_medium``) and the
embeddings-input backbone (``llava_next_34b``) in the port against the
JAX reference.

Weights are the reference's init of each smoke config, with the norm
scales drawn from a numpy seed first (so the norms' gradients and their
weight decay show); the port gets them through
``convert.params_from_numpy``.  Two TNN variants of ``seamless``'s smoke
config, in f32: ``tnn_default`` (TT rank 64 on both stacks' SwiGLU) and
TT rank 8 on ``("qkv", "out", "mlp")`` (the cross-attention's k/v then
see the encoder's token count while its q sees the decoder's).  The
reference runs on its ``einsum`` backend and, for the logits of the
TT-on-attention variant, on ``pallas`` in interpret mode too; the port on its ``cuda`` backend,
whose wrappers run their plain versions on the CPU.  Tolerances:

* configs field for field; parameter counts of the full models by config
  arithmetic, equal to the reference's abstract init;
* logits 1e-5 of their scale, the loss 1e-5 relative, every gradient
  4e-5 of its leaf's scale;
* three AdamW steps through ``make_train_step`` against the reference's
  jitted one: loss 1e-5, grad norm 1e-4, lr 1e-6; parameters, m and v
  per leaf (1e-5 / 1e-4 / 2e-4 of the leaf's scale) for 99.9% of the
  elements (99.5% with TT on attention), every moment within five times
  its bound, and every parameter within twice the summed lr, as
  ``tests/test_torch_dense.py``; the stacked norm scales decayed as the
  reference decays its 2-D ``[L, D]`` leaves;
* ``blockwise_attention(causal=False)`` at ``Tq != Tk`` (down to one
  query): output 1e-5 and gradients 4e-5 of their scale;
* ``prefill`` plus ``decode_step`` logits at every greedy step within
  1e-5 of the reference's and of teacher-forced ``forward``; equal
  tokens;
* llava's embeddings input: logits, loss, gradients and ``decode_step``
  on ``[B]`` ids and on ``[B, D]`` embeddings as above;
* ``SyntheticLM(embed_dim=...)`` batches bit-equal to the reference's;
  the convert round trip exact; the train CLI on llava on the CPU.
"""

import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models.encdec import EncDec as JEncDec  # noqa: E402
from repro.models.lm import LM as JLM  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    params_from_numpy, reference_ndim, to_numpy_tree,
)
from repro_torch.core import factorizations  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import modality  # noqa: E402
from repro_torch.models.blocks import blockwise_attention  # noqa: E402
from repro_torch.models.encdec import EncDec  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402

SEAMLESS, LLAVA = "seamless_m4t_medium", "llava_next_34b"
#: the full models' parameters (under ``tnn_default``, and dense)
FULL_PARAMS = {SEAMLESS: (704_624_640, 977_860_608),
               LLAVA: (8_140_459_008, 34_388_917_248)}
#: seamless's smoke variants: the default TT MLP, and TT on attention too
VARIANTS = {"mlp": {}, "attn": {"rank": 8, "targets": ("qkv", "out", "mlp")}}
S_ENC, T_DEC, BATCH = 24, 16, 2


def _close(got, want, rel, what=""):
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()),
                                              1e-30), err_msg=what)


def _tnn(arch_id, variant, backend):
    arch = jbase.get(arch_id) if backend != "cuda" else tbase.get(arch_id)
    return dataclasses.replace(arch.tnn_default, backend=backend,
                               **VARIANTS[variant])


def _draw_scales(tree, seed):
    rng = np.random.default_rng(seed)

    def draw(path, a):
        if "scale" in jax.tree_util.keystr(path):
            a = a + 0.1 * rng.standard_normal(a.shape)
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


@functools.lru_cache(maxsize=None)
def _reference(arch_id, variant="mlp", backend="einsum", seed=0):
    """The reference smoke model (f32) and its init as numpy (made once
    per argument set; callers do not modify the tree)."""
    jarch = jbase.get(arch_id)
    cfg = dataclasses.replace(jarch.smoke(_tnn(arch_id, variant, backend)),
                              compute_dtype=jnp.float32)
    jm = (JEncDec if jarch.model_kind == "encdec" else JLM)(cfg)
    tree = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.key(seed)))
    return jm, _draw_scales(tree, seed)


def _port(arch_id, tree, variant="mlp"):
    arch = tbase.get(arch_id)
    model, cfg = steps.build_model(arch, tnn=_tnn(arch_id, variant, "cuda"),
                                   smoke=True, device="cpu",
                                   compute_dtype=torch.float32)
    model.load_state_dict(params_from_numpy(tree, cfg))
    return model, cfg


def _encdec_batches(vocab, d_model, n=3, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, (BATCH, T_DEC + 1)).astype(np.int32)
        enc = (0.02 * rng.standard_normal((BATCH, S_ENC, d_model))
               ).astype(np.float32)
        out.append({"enc_embeds": enc, "dec_inputs": toks[:, :-1],
                    "dec_targets": toks[:, 1:]})
    return out


@pytest.fixture(scope="module", params=list(VARIANTS))
def seamless(request):
    jm, tree = _reference(SEAMLESS, request.param)
    return (request.param, jm, tree,
            _encdec_batches(jm.cfg.vocab, jm.cfg.d_model))


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch_id", [SEAMLESS, LLAVA])
def test_configs_are_the_reference_configs(arch_id):
    arch, jarch = tbase.get(arch_id), jbase.get(arch_id)
    for f in ("family", "model_kind", "input_kind", "notes"):
        assert getattr(arch, f) == getattr(jarch, f), f
    for f in dataclasses.fields(arch.tnn_default):
        assert repr(getattr(arch.tnn_default, f.name)) == repr(
            getattr(jarch.tnn_default, f.name)), f.name
    for make in ("model", "smoke"):
        got = getattr(arch, make)(arch.tnn_default)
        want = getattr(jarch, make)(jarch.tnn_default)
        names = [f.name for f in dataclasses.fields(got)
                 if f.name not in ("tnn", "param_dtype", "compute_dtype")]
        assert names and set(names) <= {f.name for f in
                                        dataclasses.fields(want)}
        for f in names + ["hd"]:
            assert getattr(got, f) == getattr(want, f), (make, f)
    if arch_id == SEAMLESS:
        from repro_torch.configs import seamless_m4t_medium as tcfg
        assert tcfg.VOCAB_PADDED == 256256 == arch.model().vocab


def test_every_reference_architecture_is_registered():
    assert set(tbase.ARCH_IDS) == set(jbase.ARCH_IDS) | {"paper_atis_tt"}
    for arch_id in tbase.ARCH_IDS:
        assert tbase.get(arch_id).id == arch_id
    with pytest.raises(KeyError, match="not ported"):
        tbase.get("no_such_arch")


def _tt_params(tnn, d_in, d_out):
    return factorizations.make(
        tnn.method, factorizations.factorize_dim(d_out, tnn.num_factors),
        factorizations.factorize_dim(d_in, tnn.num_factors),
        tnn.rank).num_params


def _arithmetic_params(cfg, encdec: bool) -> int:
    """Parameters from the config alone: dense (or TT) attention
    projections, the SwiGLU, the norms, ``embed`` and ``lm_head``."""
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    tnn = cfg.tnn

    def proj(d_in, d_out, target):
        if tnn.enabled and target in tnn.targets:
            return _tt_params(tnn, d_in, d_out)
        return d_in * d_out

    attn = (proj(D, H * hd, "qkv") + 2 * proj(D, KV * hd, "qkv")
            + proj(H * hd, D, "out"))
    mlp = 2 * proj(D, cfg.d_ff, "mlp") + proj(cfg.d_ff, D, "mlp")
    if encdec:
        enc = cfg.num_enc_layers * (attn + mlp + 2 * D)
        dec = cfg.num_dec_layers * (2 * attn + mlp + 3 * D)
        return enc + dec + 2 * cfg.vocab * D + 2 * D
    return cfg.num_layers * (attn + mlp + 2 * D) + 2 * cfg.vocab * D + D


@pytest.mark.parametrize("arch_id", [SEAMLESS, LLAVA])
def test_parameter_counts_by_config_arithmetic(arch_id):
    """The arithmetic holds on the smoke models (built, both variants) and
    gives the full models' counts, which equal the reference's abstract
    init (no array is made on either side)."""
    arch, jarch = tbase.get(arch_id), jbase.get(arch_id)
    encdec = arch.model_kind == "encdec"
    for variant in VARIANTS:
        smoke, cfg = steps.build_model(
            arch, tnn=_tnn(arch_id, variant, "cuda"), smoke=True,
            device="cpu")
        assert isinstance(smoke, EncDec) == encdec
        assert sum(p.numel() for p in smoke.parameters()) == (
            _arithmetic_params(cfg, encdec))
    for tnn, jtnn, want in zip((arch.tnn_default, None),
                               (jarch.tnn_default, None),
                               FULL_PARAMS[arch_id]):
        full = arch.model(tnn)
        assert _arithmetic_params(full, encdec) == want
        jm = (JEncDec if encdec else JLM)(jarch.model(jtnn))
        shapes = jax.eval_shape(jm.init, jax.random.key(0))
        assert sum(math.prod(s.shape) for s in jax.tree.leaves(shapes)) == (
            want)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_profiles_list_the_tensorized_projections(variant):
    """``profiles.tensorized_projections`` lists every distinct TT layer
    the encoder-decoder builds (both stacks and the cross-attention)."""
    from repro_torch.core.tensorized import TensorizedLinear
    from repro_torch.serving import profiles
    arch = tbase.get(SEAMLESS)
    model, cfg = steps.build_model(arch, tnn=_tnn(SEAMLESS, variant, "cuda"),
                                   smoke=True, device="cpu")
    built = {(m.fact.N, m.fact.M) for m in model.modules()
             if isinstance(m, TensorizedLinear)}
    listed = {(d_in, d_out) for _, d_in, d_out
              in profiles.tensorized_projections(cfg)}
    assert built == listed
    assert (cfg.d_model, cfg.d_ff) in listed
    assert ((cfg.d_model, cfg.num_heads * cfg.hd) in listed) == (
        variant == "attn")


def test_build_model_cuts_both_stacks_and_keeps_the_backend():
    arch = tbase.get(SEAMLESS)
    model, cfg = steps.build_model(arch, tnn=arch.tnn_default, smoke=True,
                                   device="cpu", backend="cuda",
                                   num_layers=1,
                                   compute_dtype=torch.float32)
    assert (cfg.num_enc_layers, cfg.num_dec_layers) == (1, 1)
    assert (len(model.enc_layers), len(model.dec_layers)) == (1, 1)
    assert cfg.tnn.backend == "cuda" and cfg.compute_dtype == torch.float32
    assert not cfg.remat
    recompute = dataclasses.replace(arch.tnn_default, remat="recompute")
    _, cfg = steps.build_model(arch, tnn=recompute, smoke=True, device="cpu")
    assert cfg.remat                 # the recompute stash turns remat on
    assert steps.ENC_FRAMES_DECODE == jsteps.ENC_FRAMES_DECODE == 1024


# ---------------------------------------------------------------------------
# Training: logits, loss, gradients, AdamW steps
# ---------------------------------------------------------------------------


def test_logits_loss_and_grads_match_reference(seamless):
    variant, jm, tree, batches = seamless
    batch = _jnp(batches[0])
    jparams = jax.tree.map(jnp.asarray, tree)
    jlogits, _ = jax.jit(jm)(jparams, batch["enc_embeds"],
                             batch["dec_inputs"])
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, batch), has_aux=True))(jparams)
    model, cfg = _port(SEAMLESS, tree, variant)
    tbatch = _torch(batches[0])
    with torch.no_grad():
        _close(model(tbatch["enc_embeds"], tbatch["dec_inputs"]), jlogits,
               1e-5, "logits")
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


def test_reference_pallas_logits_agree():
    """The reference's ``pallas`` backend (interpret mode on the CPU)
    gives the logits its ``einsum`` backend and the port give, with TT
    on every projection (the variant that sends the most layers through
    the Pallas kernels)."""
    variant = "attn"
    jm, tree = _reference(SEAMLESS, variant)
    batches = _encdec_batches(jm.cfg.vocab, jm.cfg.d_model)
    jp = JEncDec(dataclasses.replace(jm.cfg, tnn=dataclasses.replace(
        jm.cfg.tnn, backend="pallas")))
    b = _jnp(batches[0])
    jparams = jax.tree.map(jnp.asarray, tree)
    want, _ = jax.jit(jm)(jparams, b["enc_embeds"], b["dec_inputs"])
    got, _ = jp(jparams, b["enc_embeds"], b["dec_inputs"])
    _close(got, want, 1e-5, "reference pallas vs einsum")
    model, _ = _port(SEAMLESS, tree, variant)
    with torch.no_grad():
        _close(model(torch.from_numpy(batches[0]["enc_embeds"]),
                     torch.from_numpy(batches[0]["dec_inputs"])),
               got, 1e-5, "port vs reference pallas")


def test_train_steps_match_reference(seamless):
    """Three AdamW steps through ``make_train_step`` (tolerances in the
    module docstring); every stacked norm scale is decayed, as the
    reference decays its ``[L, D]`` leaves."""
    variant, jm, tree, batches = seamless
    # TT on attention puts three more TT products on every path, and by
    # step 3 f32 roundoff takes ~0.2% of m's elements past 1e-4 of their
    # leaf's scale (the largest 2e-4): that variant is held to 99.5%.
    share = 1e-3 if variant == "mlp" else 5e-3
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=4)
    jopt = JAdamW(**kw)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = {"params": jparams, "opt": jopt.init(jparams)}
    jstep = jax.jit(jsteps.make_train_step(jm, jopt, jblocks.no_shard))
    model, cfg = _port(SEAMLESS, tree, variant)
    opt = AdamW(**kw)
    params = dict(model.named_parameters())
    decayed = {n for n, p in params.items() if opt.decays(n, p)}
    norms = {n for n in params if ".ln" in n and n.endswith(".scale")}
    assert norms and norms <= decayed
    assert {"ln_f.scale", "ln_enc.scale"}.isdisjoint(decayed)
    assert reference_ndim("dec_layers.3.ln_x.scale", params["ln_f.scale"]
                          ) == 2
    state = {"params": params, "opt": opt.init(params)}
    step = steps.make_train_step(model, opt)
    lr_sum = 0.0
    for batch in batches:
        jstate, jm_ = jstep(jstate, _jnp(batch))
        state, m = step(state, _torch(batch))
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
        assert sum(far) <= share * total, (name, sum(far), total)
        worst = max(float(np.abs(g - np.asarray(w)).max())
                    / max(float(np.abs(np.asarray(w)).max()), 1e-30)
                    for g, w in zip(jax.tree.leaves(got),
                                    jax.tree.leaves(want)))
        assert name == "params" or worst <= 5 * rel, (name, worst)
    # The norm scales are each decayed like the reference's: equal per
    # element to its updated [L, D] leaves.
    for stack in ("enc_layers", "dec_layers"):
        np.testing.assert_allclose(got_params[stack]["ln2"]["scale"],
                                   want_params[stack]["ln2"]["scale"],
                                   rtol=0, atol=2 * lr_sum)


@pytest.mark.parametrize("tq,tk,qc,kc", [(16, 48, 8, 16), (1, 48, 1, 48),
                                         (16, 16, 8, 8)])
def test_noncausal_attention_across_sequences(tq, tk, qc, kc):
    """``blockwise_attention(causal=False)`` with q from one sequence and
    k/v from another (GQA, 8 heads over 2): output and gradients against
    the reference's."""
    rng = np.random.default_rng(tq * 100 + tk)
    q = rng.standard_normal((2, tq, 8, 16)).astype(np.float32)
    k = rng.standard_normal((2, tk, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, tk, 2, 16)).astype(np.float32)
    w = rng.standard_normal((2, tq, 8, 16)).astype(np.float32)

    def jfn(q, k, v):
        out = jblocks.blockwise_attention(q, k, v, causal=False, q_chunk=qc,
                                          kv_chunk=kc)
        return jnp.sum(out * w), out

    (_, jout), jg = jax.value_and_grad(jfn, argnums=(0, 1, 2),
                                       has_aux=True)(q, k, v)
    tq_, tk_, tv_ = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = blockwise_attention(tq_, tk_, tv_, causal=False, q_chunk=qc,
                              kv_chunk=kc)
    (out * torch.from_numpy(w)).sum().backward()
    _close(out, jout, 1e-5, "out")
    for t, g, name in zip((tq_, tk_, tv_), jg, "qkv"):
        _close(t.grad, g, 4e-5, f"d{name}")


# ---------------------------------------------------------------------------
# Serving: prefill and greedy decode
# ---------------------------------------------------------------------------


def test_prefill_and_greedy_decode_match_reference(seamless):
    """``prefill`` then greedy ``decode_step`` through the step builders:
    each step's logits within 1e-5 of the reference's and of ``forward``
    over the tokens so far, and the same greedy tokens."""
    variant, jm, tree, batches = seamless
    enc = batches[1]["enc_embeds"]
    prompt = batches[1]["dec_inputs"][:, :6]
    new, max_len = 5, 12
    model, cfg = _port(SEAMLESS, tree, variant)
    prefill = steps.make_prefill_step(model, max_len)
    decode = steps.make_decode_step(model)
    jparams = jax.tree.map(jnp.asarray, tree)
    jprefill = jax.jit(jsteps.make_prefill_step(jm, jblocks.no_shard,
                                                max_len))
    jdecode = jax.jit(jsteps.make_decode_step(jm, jblocks.no_shard))
    logits, cache = prefill(enc, prompt)
    jlogits, jcache = jprefill(jparams, jnp.asarray(enc),
                               jnp.asarray(prompt))
    assert tuple(cache.self_kv.k.shape) == (
        cfg.num_dec_layers, BATCH, max_len, cfg.num_kv_heads, cfg.hd)
    assert int(cache.length) == 6
    _close(cache.enc_out, jcache.enc_out, 1e-5, "encoder output")
    toks = prompt
    for i in range(new):
        _close(logits, jlogits, 1e-5, f"step {i} vs reference")
        with torch.no_grad():
            full = model(torch.from_numpy(enc), torch.from_numpy(toks))
        _close(logits, full[:, -1], 1e-5, f"step {i} vs forward")
        nxt = logits.argmax(-1).numpy().astype(np.int32)
        assert (nxt == np.asarray(jlogits).argmax(-1)).all(), i
        toks = np.concatenate([toks, nxt[:, None]], axis=1)
        if i < new - 1:
            logits, cache = decode(nxt, cache)
            jlogits, jcache = jdecode(jparams, jnp.asarray(nxt), jcache)
    assert int(cache.length) == 6 + new - 1
    _close(cache.self_kv.k, jcache.self_kv.k, 1e-5, "self-attention k")
    assert cache.self_kv.length.tolist() == np.asarray(
        jcache.self_kv.length).tolist()


# ---------------------------------------------------------------------------
# llava: the embeddings input
# ---------------------------------------------------------------------------


def test_llava_embeddings_input_matches_reference():
    """Forward, loss and gradients on ``[B, T, D]`` embeddings; prefill on
    embeddings, then ``decode_step`` on ``[B]`` ids and on ``[B, D]``
    embeddings."""
    jm, tree = _reference(LLAVA)
    model, cfg = _port(LLAVA, tree)
    rng = np.random.default_rng(5)
    emb = (0.02 * rng.standard_normal((BATCH, 12, cfg.d_model))
           ).astype(np.float32)
    targets = rng.integers(0, cfg.vocab, (BATCH, 12)).astype(np.int32)
    jparams = jax.tree.map(jnp.asarray, tree)
    jbatch = {"inputs": jnp.asarray(emb), "targets": jnp.asarray(targets)}
    jlogits, _ = jax.jit(jm)(jparams, jbatch["inputs"])
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jbatch), has_aux=True))(jparams)
    with torch.no_grad():
        _close(model(torch.from_numpy(emb)), jlogits, 1e-5, "logits")
    loss, _ = model.loss({"inputs": torch.from_numpy(emb),
                          "targets": torch.from_numpy(targets)})
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    got = to_numpy_tree({n: p.grad for n, p in model.named_parameters()
                         if p.grad is not None}, cfg)
    want = jax.tree.map(np.asarray, jgrads)
    assert not want["embed"].any() and "embed" not in got
    del want["embed"]                  # the table is not read: zero grad
    jax.tree_util.tree_map_with_path(
        lambda path, g, w: _close(g, w, 4e-5, jax.tree_util.keystr(path)),
        got, want)

    with torch.no_grad():
        lp, cache = model.prefill(torch.from_numpy(emb[:, :-1]), max_len=16)
    jlp, jcache = jm.prefill(jparams, jnp.asarray(emb[:, :-1]), max_len=16)
    _close(lp, jlp, 1e-5, "prefill")
    for token in (targets[:, 0], emb[:, -1]):
        with torch.no_grad():
            ld, new = model.decode_step(torch.from_numpy(token), cache)
        jld, jnew = jm.decode_step(jparams, jnp.asarray(token), jcache)
        _close(ld, jld, 1e-5, f"decode on {token.shape}")
        _close(new.k, jnew.layers.k, 1e-5, "decode k")
        assert int(new.length) == int(jnew.length) == 12
    with torch.no_grad():           # the embeddings' step is forward's row
        _close(ld, model(torch.from_numpy(emb))[:, -1], 1e-5, "vs forward")


def test_synthetic_embeddings_are_the_reference_batches():
    for kind in ("ngram", "uniform"):
        kw = dict(vocab=97, seq_len=9, global_batch=4, seed=3, kind=kind,
                  embed_dim=16)
        ours = pipeline.SyntheticLM(pipeline.DataConfig(**kw))
        ref = jpipeline.SyntheticLM(jpipeline.DataConfig(**kw))
        for step in (0, 5):
            for host in (0, 1):
                a = ours.batch(step, host_index=host, host_count=2)
                b = ref.batch(step, host_index=host, host_count=2)
                assert a.keys() == b.keys()
                for k in a:
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k])
        assert a["inputs"].shape == (2, 9, 16)


def test_modality_stubs_draw_from_a_generator():
    gen = torch.Generator().manual_seed(4)
    x = modality.frame_embeddings(gen, 3, 40, 32, device="cpu")
    assert x.shape == (3, 40, 32) and x.dtype == torch.bfloat16
    assert 0.015 < float(x.float().std()) < 0.025
    y = modality.patch_embeddings(torch.Generator().manual_seed(4), 3, 40,
                                  32, dtype=torch.float32, device="cpu")
    assert y.dtype == torch.float32 and torch.equal(y.bfloat16(), x)


# ---------------------------------------------------------------------------
# Convert, CLIs
# ---------------------------------------------------------------------------


def test_convert_round_trip_of_an_encdec_tree(seamless):
    variant, _, tree, _ = seamless
    _, cfg = _port(SEAMLESS, tree, variant)
    sd = params_from_numpy(tree, cfg)
    assert "dec_layers.1.self.q.w" in sd or (
        "dec_layers.1.self.q.cores.0" in sd)
    assert "enc_layers.1.mlp.down.cores.3" in sd and "ln_enc.scale" in sd
    jax.tree.map(np.testing.assert_array_equal, to_numpy_tree(sd, cfg),
                 tree)
    bad = dict(tree, dec_layers=jax.tree.map(lambda a: a[:1],
                                             tree["dec_layers"]))
    with pytest.raises(ValueError, match="num_dec_layers"):
        params_from_numpy(bad, cfg)


def test_train_cli_trains_llava_on_embeddings_on_the_cpu(capsys):
    train_cli.main(["--arch", LLAVA, "--smoke", "--tnn", "--tnn-backend",
                    "cuda", "--device", "cpu", "--steps", "2", "--batch",
                    "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "step     1 loss" in out and "done: final loss" in out


def test_clis_refuse_the_encoder_decoder():
    with pytest.raises(SystemExit):
        train_cli.main(["--arch", SEAMLESS, "--smoke", "--device", "cpu"])
    with pytest.raises(ValueError, match="encoder-decoder"):
        train_cli.train(SEAMLESS, smoke=True, tnn=False, steps=1,
                        global_batch=2, seq_len=8, lr=1e-3, device="cpu")
    with pytest.raises(SystemExit, match="encoder-decoder"):
        serve_cli.main(["--arch", SEAMLESS, "--smoke", "--device", "cpu"])
