"""Port serving path (LM, ServeEngine, serve CLI) vs the JAX reference.

The model is ``paper_atis_tt``'s smoke config (2 layers) in f32, with the
reference's parameters loaded through ``params_from_numpy``.  Logits of
``LM.extend`` / ``LM.decode_step`` (per-slot lengths, a partial
``valid``) match the JAX model within 1e-4 relative, on both the einsum
and the cuda backend (plain kernel versions on the CPU).  The engine
engine's greedy tokens equal a greedy decode of the JAX model by hand.
The engine properties the reference's ``tests/test_serving.py`` and
``tests/test_substrate.py`` state (engine == hand-rolled decode,
solo-vs-batched invariance, chunking independence, stops, admission
budget) are held on the port itself.
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
from repro.models.lm import LM as JLM  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.blocks import KVCache  # noqa: E402
from repro_torch.serving import kv_cache  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402


def _numpy_params(shapes, seed=0):
    """Seeded numpy weights in the reference's parameter tree (its
    structure from ``eval_shape``, so no reference init is compiled)."""
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
def reference():
    cfg = dataclasses.replace(jbase.get("paper_atis_tt").smoke(),
                              compute_dtype=jnp.float32, remat=False)
    model = JLM(cfg)
    tree = _numpy_params(jax.eval_shape(model.init, jax.random.key(0)))
    return model, jax.tree.map(jnp.asarray, tree), tree


def _port(reference, backend="einsum"):
    _, _, tree = reference
    model, cfg = steps.build_model(tbase.get("paper_atis_tt"), smoke=True,
                                   device="cpu", backend=backend,
                                   compute_dtype=torch.float32)
    model.load_state_dict(params_from_numpy(tree, cfg))
    return model, cfg


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rel,
                               atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("backend", ["einsum", "cuda"])
def test_extend_and_decode_match_reference(reference, backend):
    jm, params, _ = reference
    model, cfg = _port(reference, backend)
    B, C, T = 3, 8, 40
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, C),
                                             dtype=np.int32)
    lengths = np.array([0, 3, 7], np.int32)
    valid = np.array([8, 5, 0], np.int32)
    jc = jm.init_cache(B, T)._replace(length=jnp.asarray(lengths))
    jl, jc2 = jm.extend(params, jnp.asarray(toks), jc,
                        valid=jnp.asarray(valid))
    tc = model.init_cache(B, T)._replace(length=torch.from_numpy(lengths))
    with torch.no_grad():
        tl, tc2 = model.extend(torch.from_numpy(toks), tc,
                               valid=torch.from_numpy(valid))
    _close(tl, jl)
    np.testing.assert_array_equal(tc2.length.numpy(),
                                  np.asarray(jc2.length))
    _close(tc2.k, jc2.layers.k)

    tok = np.array([1, 2, 3], np.int32)
    depth = lengths + valid
    jd, _ = jm.decode_step(params, jnp.asarray(tok),
                           jc2._replace(length=jnp.asarray(depth)))
    with torch.no_grad():
        td, _ = model.decode_step(
            torch.from_numpy(tok), tc2._replace(length=torch.from_numpy(depth)))
    _close(td, jd)


def _prompts(vocab, lengths, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n, dtype=np.int32) for n in lengths]


PROMPT_LENS = (5, 9, 12)


def _port_tokens(model, prompts, *, batch=2, chunk=8, max_new=5, **kw):
    engine = ServeEngine(model, batch_size=batch, max_len=24,
                         prefill_chunk=chunk, **kw)
    for rid, p in enumerate(prompts):
        engine.submit(Request(rid=rid, prompt=p, max_new_tokens=max_new))
    engine.warmup()
    return {r.rid: r.out_tokens for r in engine.run()}, engine


def _hand_rolled(model, prompt, max_new):
    """Greedy decode with the port's LM by hand: one extend over the
    prompt, then decode steps."""
    cache = model.init_cache(1, 40)._replace(
        length=torch.zeros(1, dtype=torch.int32))
    with torch.no_grad():
        logits, cache = model.extend(torch.from_numpy(prompt[None]), cache)
        toks = [int(logits[0, -1].argmax())]
        while len(toks) < max_new:
            logits, cache = model.decode_step(torch.tensor([toks[-1]]), cache)
            toks.append(int(logits[0].argmax()))
    return toks


def _reference_greedy(reference, prompt, max_new):
    """Greedy decode with the JAX model by hand: one ``extend`` over the
    prompt, then ``decode_step`` per token, argmax on the host.

    The JAX engine is not the oracle: on jax 0.9 its greedy tokens for
    these requests depend on what ran before in the process (ROADMAP.md,
    queue C).  Its model is, and this loop is what the engine computes.
    """
    jm, params, _ = reference
    cache = jm.init_cache(1, 40)._replace(length=jnp.zeros(1, jnp.int32))
    logits, cache = jm.extend(params, jnp.asarray(prompt[None]), cache)
    toks = [int(np.argmax(np.asarray(logits[0, -1])))]
    while len(toks) < max_new:
        logits, cache = jm.decode_step(
            params, jnp.asarray([toks[-1]], jnp.int32), cache)
        toks.append(int(np.argmax(np.asarray(logits[0]))))
    return toks


@pytest.fixture(scope="module")
def reference_tokens(reference):
    prompts = _prompts(reference[0].cfg.vocab, PROMPT_LENS)
    return prompts, {rid: _reference_greedy(reference, p, 5)
                     for rid, p in enumerate(prompts)}


@pytest.mark.parametrize("backend", ["einsum", "cuda"])
def test_engine_greedy_tokens_match_reference_decode(reference,
                                                     reference_tokens,
                                                     backend):
    """The port's engine, batched and chunked, gives the JAX model's
    greedy tokens, every one of them."""
    model, _ = _port(reference, backend)
    prompts, want = reference_tokens
    got, _ = _port_tokens(model, prompts)
    assert got == want


def test_engine_greedy_tokens_match_hand_rolled_decode(reference):
    """The port's engine == the same greedy decode by hand on the port's
    own LM (the property the reference's ``tests/test_substrate.py``
    states for its engine)."""
    model, cfg = _port(reference, "cuda")
    prompts = _prompts(cfg.vocab, PROMPT_LENS)
    got, _ = _port_tokens(model, prompts)
    assert got == {rid: _hand_rolled(model, p, 5)
                   for rid, p in enumerate(prompts)}


def test_solo_vs_batched_invariance(reference):
    model, cfg = _port(reference)
    prompts = _prompts(cfg.vocab, PROMPT_LENS)
    batched, _ = _port_tokens(model, prompts, batch=3)
    for rid, p in enumerate(prompts):
        solo, _ = _port_tokens(model, [p], batch=1)
        assert solo[0] == batched[rid]


def test_outputs_independent_of_prefill_chunk(reference):
    model, cfg = _port(reference)
    prompts = _prompts(cfg.vocab, PROMPT_LENS)
    a, ea = _port_tokens(model, prompts, chunk=4)
    b, eb = _port_tokens(model, prompts, chunk=16)
    assert a == b
    assert ea.tick != eb.tick


def test_max_new_tokens_and_eos_stop(reference):
    model, cfg = _port(reference)
    prompts = _prompts(cfg.vocab, PROMPT_LENS)
    free, _ = _port_tokens(model, prompts, max_new=4)
    assert all(len(t) == 4 for t in free.values())
    eos = free[1][1]
    stopped, _ = _port_tokens(model, prompts, max_new=4, eos_id=eos)
    for rid, toks in free.items():
        want = toks[:toks.index(eos) + 1] if eos in toks else toks
        assert stopped[rid] == want


def test_admission_capped_by_memory_budget(reference):
    model, cfg = _port(reference)
    prompts = _prompts(cfg.vocab, PROMPT_LENS + (6,))
    slot = kv_cache.slot_bytes(cfg, 24)["total"]
    got, engine = _port_tokens(model, prompts, batch=4,
                               memory_budget=2 * slot + 1)
    assert engine.capacity == 2 and engine.max_occupancy == 2
    free, _ = _port_tokens(model, prompts, batch=4)
    assert got == free
    with pytest.raises(ValueError, match="cannot hold one slot"):
        ServeEngine(model, batch_size=2, max_len=24, memory_budget=slot - 1)
    assert ServeEngine(model, batch_size=2, max_len=24,
                       memory_budget="1MB").capacity == 2


def test_sampling_is_seeded_and_in_vocab(reference):
    model, cfg = _port(reference)
    prompts = _prompts(cfg.vocab, PROMPT_LENS)

    def sampled(seed):
        engine = ServeEngine(model, batch_size=2, max_len=24,
                             prefill_chunk=8, seed=seed)
        for rid, p in enumerate(prompts):
            engine.submit(Request(rid=rid, prompt=p, max_new_tokens=4,
                                  temperature=0.8))
        return {r.rid: r.out_tokens for r in engine.run()}

    a, b = sampled(0), sampled(0)
    assert a == b
    assert all(0 <= t < cfg.vocab for toks in a.values() for t in toks)


def test_kv_write_past_the_cache_is_refused(reference):
    model, cfg = _port(reference)
    attn = model.layers[0].attn
    cache = KVCache(torch.zeros(1, 10, cfg.num_kv_heads, cfg.hd),
                    torch.zeros(1, 10, cfg.num_kv_heads, cfg.hd),
                    torch.tensor([7], dtype=torch.int32))
    x = torch.zeros(1, 4, cfg.d_model)
    with pytest.raises(ValueError, match="past the cache length"):
        attn.extend(x, cache)
    out, new = attn.extend(x[:, :3], cache)
    assert out.shape == (1, 3, cfg.d_model)
    assert int(new.length[0]) == 10


def test_engine_refuses_what_is_not_ported(reference):
    """A quantized KV cache now runs on an attention model (engine and
    CLI; ``tests/test_torch_kv_quant.py`` holds it to its properties);
    an architecture no package registers is refused."""
    model, cfg = _port(reference)
    engine = ServeEngine(model, batch_size=2, max_len=24, kv_policy="fp8")
    engine.submit(Request(rid=0, prompt=np.array([3, 1, 4], np.int32),
                          max_new_tokens=2))
    assert [len(r.out_tokens) for r in engine.run()] == [2]
    assert engine.slot_cost == kv_cache.slot_bytes(
        cfg, 24, engine.kv_policy)
    assert serve_cli.parse_args(["--arch", "paper_atis_tt",
                                 "--serve-kv-dtype", "fp8"]
                                ).serve_kv_dtype == "fp8"
    for arch_id in ("no_such_arch", "llava_next_72b"):
        with pytest.raises(KeyError, match="not ported"):
            tbase.get(arch_id)


def test_serve_cli_runs_on_cpu(capsys):
    done = serve_cli.main(["--arch", "paper_atis_tt", "--smoke", "--tnn",
                           "--tnn-backend", "pallas", "--device", "cpu",
                           "--requests", "3", "--batch", "2",
                           "--prompt-len", "6", "--max-new", "3"])
    assert len(done) == 3 and all(len(r.out_tokens) == 3 for r in done)
    out = capsys.readouterr().out
    assert "[profiles] prefill" in out and "backend cuda" in out
