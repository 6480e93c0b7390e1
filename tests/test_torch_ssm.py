"""Port RWKV-6 path (the scan's plain versions, its autograd Function, the
RWKV-6 block and LM) against the JAX reference on the same numpy inputs.

* The port's ``ops.linear_scan`` on the CPU (kernel B8's plain twin)
  against the reference's ``ops.linear_scan(use_pallas=True)`` (the Pallas
  kernel in interpret mode) and its sequential oracle
  ``ref.linear_scan_batched``, both modes, on the reference test's grid
  of ``(T, chunk)``: output and final state within 5e-3 (f32) and 5e-2
  (bf16), the reference test's tolerances.  Chunk 64 against 128 (chunk
  boundaries invisible, 1e-4).  Gradients of q, k, v, log-decay and u
  against ``jax.vjp`` of the reference within 1e-5 of each leaf's scale
  (f32; the two twins sum in other orders).
* The overflow of the chunked factorization: at a constant log-decay of
  -0.7 (a chunk's ``lc`` reaches -89.6) the reference's chunked twin is
  non-finite.  The port's ``ssd`` form for a decay broadcast over ``dk``
  (an expanded view, as Mamba-2 passes it) is finite there and at -2.0,
  and equals the sequential oracle within 1e-4 of its scale; where the
  reference is finite it equals the reference's twin and its Pallas
  kernel (interpret mode), outputs within 1e-4 (f32) / 5e-2 (bf16) and
  gradients within 1e-5 of each leaf's scale.  ``rwkv6`` and a
  per-channel ``ssd`` decay keep the reference's factorization: non-finite
  exactly where the reference is, equal to it elsewhere.  (Near the
  overflow ``exp(lc)`` is subnormal, which the reference's CPU backend
  flushes to zero and torch does not, so finite values there are not
  compared.)
* ``rwkv6_7b``'s smoke config in f32 with the TNN default (TT on
  ``cm_k``/``cm_v``): the block's time and channel mix; ``LM.forward``
  logits and loss within 1e-5 of their scale; every gradient within 4e-5
  of its leaf's scale; three steps of the reference's jitted
  ``make_train_step`` (``no_shard``) against the port's, loss and grad
  norm within 6e-5 relative; ``prefill`` + ``decode_step`` against the
  port's own ``forward`` and the reference's prefill/decode.
* AdamW decays every RWKV leaf the reference decays; the train and
  serve CLIs run ``rwkv6_7b`` on the CPU, and a quantized KV cache for
  it is refused with its ROADMAP item; shapes the scan kernel cannot
  take raise on either device.

The CUDA kernel is held against its plain twin on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
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
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models.lm import LM as JLM  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    params_from_numpy, reference_ndim, to_numpy_tree,
)
from repro_torch.kernels import ops, ref, ssm_scan  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.lm import LMConfig, RWKVLayer  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

MODES = ["ssd", "rwkv6"]


def _close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()),
                                              1e-30), err_msg=what)


def _scan_inputs(t, seed=0, bh=3, dk=32, dv=64):
    """The reference kernel test's distributions, from numpy."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (
        (0.5 * rng.standard_normal((bh, t, dk))).astype(f32),
        (0.5 * rng.standard_normal((bh, t, dk))).astype(f32),
        (0.5 * rng.standard_normal((bh, t, dv))).astype(f32),
        (-np.exp(rng.standard_normal((bh, t, dk))) * 0.1).astype(f32),
        (0.5 * rng.standard_normal((bh, dk))).astype(f32))


def _torch_bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# The scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,chunk", [(256, 64), (128, 128), (384, 96)])
@pytest.mark.parametrize("mode", MODES)
def test_linear_scan_matches_pallas_and_oracle(mode, t, chunk, dtype):
    q, k, v, ld, u = _scan_inputs(t)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    want, want_state = jops.linear_scan(jq, jk, jv, jnp.asarray(ld),
                                        jnp.asarray(u), mode=mode,
                                        chunk=chunk, use_pallas=True)
    oracle, oracle_state = jref.linear_scan_batched(
        jq, jk, jv, jnp.asarray(ld), jnp.asarray(u), mode=mode)
    conv = torch.from_numpy if dtype == "float32" else _torch_bf16
    got, got_state = ops.linear_scan(conv(q), conv(k), conv(v),
                                     torch.from_numpy(ld),
                                     torch.from_numpy(u), mode=mode,
                                     chunk=chunk)
    assert got.dtype == getattr(torch, dtype) and got.shape == (3, t, 64)
    assert got_state.dtype == torch.float32
    tol = 5e-3 if dtype == "float32" else 5e-2
    for w, ws in ((want, want_state), (oracle, oracle_state)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(w, np.float32), rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(got_state.numpy(), np.asarray(ws),
                                   rtol=tol, atol=tol)


def test_linear_scan_sequential_oracle_matches_the_reference():
    q, k, v, ld, u = _scan_inputs(64, seed=1)
    for mode in MODES:
        want, want_state = jref.linear_scan_batched(
            *map(jnp.asarray, (q, k, v, ld, u)), mode=mode)
        got, got_state = ref.linear_scan_batched(
            *map(torch.from_numpy, (q, k, v, ld, u)), mode=mode)
        _close(got, want, 1e-5, mode)
        _close(got_state, want_state, 1e-5, mode)
        one, one_state = ref.linear_scan(
            *(torch.from_numpy(a[0]) for a in (q, k, v, ld, u)), mode=mode)
        _close(one, want[0], 1e-5, mode)
        _close(one_state, want_state[0], 1e-5, mode)


def test_linear_scan_state_continuity():
    """Chunk boundaries are invisible: chunk 64 == chunk 128."""
    rng = np.random.default_rng(2)
    bh, t, dk, dv = 2, 256, 16, 16
    q, k, v = (torch.from_numpy((0.5 * rng.standard_normal(
        (bh, t, d))).astype(np.float32)) for d in (dk, dk, dv))
    ld = torch.full((bh, t, dk), -0.05)
    a, sa = ops.linear_scan(q, k, v, ld, mode="ssd", chunk=64)
    b, sb = ops.linear_scan(q, k, v, ld, mode="ssd", chunk=128)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sa.numpy(), sb.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", MODES)
def test_linear_scan_grads_match_reference(mode):
    q, k, v, ld, u = _scan_inputs(128, seed=3, bh=2, dk=16, dv=24)
    rng = np.random.default_rng(4)
    do = rng.standard_normal((2, 128, 24)).astype(np.float32)
    dst = rng.standard_normal((2, 16, 24)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jops.linear_scan(*a, mode=mode, chunk=64,
                                                 use_pallas=True),
                     *map(jnp.asarray, (q, k, v, ld, u)))
    want = vjp((jnp.asarray(do), jnp.asarray(dst)))
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, ld, u)]
    o, st = ops.linear_scan(*ins, mode=mode, chunk=64)
    torch.autograd.backward((o, st), (torch.from_numpy(do),
                                      torch.from_numpy(dst)))
    for name, x, w in zip(("dq", "dk", "dv", "dlog_decay", "du"), ins, want):
        if mode == "ssd" and name == "du":
            assert x.grad is None or not x.grad.any()
            continue
        _close(x.grad, w, 1e-5, f"{mode} {name}")


def _broadcast_decay(decay, bh, t, dk):
    """A log-decay of one scalar per (stream, token), broadcast over dk
    as an expanded view: numpy ``[bh, t, 1]`` and its torch view."""
    ld = np.broadcast_to(np.asarray(decay, np.float32), (bh, t, 1)).copy()
    return ld, torch.from_numpy(ld).expand(bh, t, dk)


@pytest.mark.parametrize("decay", [-0.7, -0.6])
@pytest.mark.parametrize("mode", MODES)
def test_chunked_factorization_overflow(mode, decay):
    """rwkv6: a chunk's cumulative log-decay below about -88.7 overflows
    the ``k * exp(-lc)`` factor in both packages at the same elements.
    ssd with the decay broadcast over dk (how Mamba-2 passes it): the
    port's twin takes the ``exp(lc_i - lc_j)`` form and stays finite,
    equal to the sequential oracle, where the reference overflows.  The
    sequential oracle never overflows."""
    q, k, v, _, u = _scan_inputs(128, seed=5, bh=2, dk=8, dv=8)
    if mode == "ssd":
        ld, tld = _broadcast_decay(decay, 2, 128, 8)
        jld = np.broadcast_to(ld, q.shape)
    else:
        jld = ld = np.full(q.shape, decay, np.float32)
        tld = torch.from_numpy(ld)
    want, want_state = jref.chunked_linear_scan(
        *map(jnp.asarray, (q, k, v, jld, u)), mode=mode, chunk=128)
    tq, tk, tv, tu = map(torch.from_numpy, (q, k, v, u))
    got, got_state = ref.chunked_linear_scan(tq, tk, tv, tld, tu, mode=mode,
                                             chunk=128)
    oracle, oracle_state = ref.linear_scan_batched(tq, tk, tv, tld, tu,
                                                   mode=mode)
    want = np.asarray(want)
    assert torch.isfinite(oracle).all() and torch.isfinite(
        oracle_state).all()
    if decay == -0.7:
        assert not np.isfinite(want).all()
    else:
        assert np.isfinite(want).all()
        _close(got, want, 1e-4, "vs reference")
    if mode == "ssd":
        assert torch.isfinite(got).all() and torch.isfinite(got_state).all()
        _close(got, oracle, 1e-4, "vs oracle")
        _close(got_state, oracle_state, 1e-4, "state vs oracle")
        return
    np.testing.assert_array_equal(torch.isfinite(got).numpy(),
                                  np.isfinite(want))
    np.testing.assert_array_equal(torch.isfinite(got_state).numpy(),
                                  np.isfinite(np.asarray(want_state)))
    if decay == -0.6:
        _close(got, oracle, 1e-4, "vs oracle")


@pytest.mark.parametrize("decay", [-0.7, -0.6])
def test_per_channel_ssd_decay_keeps_the_reference_factorization(decay):
    """A per-channel ssd decay (a full array, not a broadcast view) keeps
    the reference's ``k * exp(-lc)`` factorization: non-finite exactly
    where the reference is at -0.7, equal to it at -0.6."""
    q, k, v, _, u = _scan_inputs(128, seed=5, bh=2, dk=8, dv=8)
    ld = np.full(q.shape, decay, np.float32)
    want, want_state = jref.chunked_linear_scan(
        *map(jnp.asarray, (q, k, v, ld, u)), mode="ssd", chunk=128)
    got, got_state = ops.linear_scan(
        *map(torch.from_numpy, (q, k, v, ld, u)), mode="ssd", chunk=128)
    want = np.asarray(want)
    np.testing.assert_array_equal(torch.isfinite(got).numpy(),
                                  np.isfinite(want))
    np.testing.assert_array_equal(torch.isfinite(got_state).numpy(),
                                  np.isfinite(np.asarray(want_state)))
    if decay == -0.7:
        assert not np.isfinite(want).all()
    else:
        _close(got, want, 1e-4, "vs reference")
        _close(got_state, want_state, 1e-4, "state vs reference")


@pytest.mark.parametrize("decay", [-0.7, -2.0])
def test_scalar_ssd_form_is_finite_and_matches_the_oracle(decay):
    """At -0.7 and -2.0 a token (a chunk's lc reaches -89.6 and -256) the
    broadcast ssd form is finite through every entry point that reaches
    it on the CPU (the plain twin, the kernel wrapper and the autograd
    Function) and equals the sequential oracles of both packages, over
    two chunks (the state crosses a boundary)."""
    bh, t, dk, dv = 2, 256, 16, 24
    q, k, v, _, _ = _scan_inputs(t, seed=7, bh=bh, dk=dk, dv=dv)
    ld, tld = _broadcast_decay(decay, bh, t, dk)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    oracle, oracle_state = ref.linear_scan_batched(tq, tk, tv, tld)
    joracle, joracle_state = jref.linear_scan_batched(
        *map(jnp.asarray, (q, k, v, np.broadcast_to(ld, q.shape))))
    _close(oracle, joracle, 1e-5, "oracles")
    _close(oracle_state, joracle_state, 1e-5, "oracle states")
    for name, fn in (("twin", ref.chunked_linear_scan),
                     ("wrapper", ssm_scan.linear_scan_cuda),
                     ("ops", ops.linear_scan)):
        got, got_state = fn(tq, tk, tv, tld, mode="ssd", chunk=128)
        assert torch.isfinite(got).all() and torch.isfinite(got_state).all()
        _close(got, oracle, 1e-4, name)
        _close(got_state, oracle_state, 1e-4, f"{name} state")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,chunk", [(256, 64), (128, 128), (384, 96)])
def test_scalar_ssd_form_matches_the_reference_where_finite(t, chunk, dtype):
    """Where the reference is finite (the reference test's decay, one
    scalar per token), the broadcast form equals the reference's chunked
    twin and its Pallas kernel in interpret mode."""
    q, k, v, ld_full, _ = _scan_inputs(t, seed=8)
    ld = ld_full[..., :1]
    jld = jnp.asarray(np.broadcast_to(ld, q.shape))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    conv = torch.from_numpy if dtype == "float32" else _torch_bf16
    tld = torch.from_numpy(ld).expand(q.shape)
    got, got_state = ops.linear_scan(conv(q), conv(k), conv(v), tld,
                                     mode="ssd", chunk=chunk)
    tol = 1e-4 if dtype == "float32" else 5e-2
    for use_pallas in (False, True):
        want, want_state = jops.linear_scan(jq, jk, jv, jld, mode="ssd",
                                            chunk=chunk,
                                            use_pallas=use_pallas)
        _close(got.float(), np.asarray(want, np.float32), tol,
               f"pallas={use_pallas}")
        _close(got_state, want_state, tol, f"state pallas={use_pallas}")


def test_linear_scan_grads_of_a_broadcast_decay_match_reference():
    """Gradients through ``ops.linear_scan`` of an expanded ssd decay (the
    backward runs the twin's overflow-free form) against ``jax.vjp`` of
    the reference with the decay broadcast the same way, within 1e-5 of
    each leaf's scale; the decay's gradient arrives summed over dk."""
    bh, t, dk, dv = 2, 128, 16, 24
    q, k, v, ld_full, _ = _scan_inputs(t, seed=9, bh=bh, dk=dk, dv=dv)
    ld = ld_full[..., :1]
    rng = np.random.default_rng(10)
    do = rng.standard_normal((bh, t, dv)).astype(np.float32)
    dst = rng.standard_normal((bh, dk, dv)).astype(np.float32)

    def jfn(q, k, v, ld):
        return jops.linear_scan(q, k, v, jnp.broadcast_to(ld, q.shape),
                                mode="ssd", chunk=64, use_pallas=True)

    _, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v, ld)))
    want = vjp((jnp.asarray(do), jnp.asarray(dst)))
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, ld)]
    o, st = ops.linear_scan(ins[0], ins[1], ins[2],
                            ins[3].expand(bh, t, dk), mode="ssd", chunk=64)
    torch.autograd.backward((o, st), (torch.from_numpy(do),
                                      torch.from_numpy(dst)))
    for name, x, w in zip(("dq", "dk", "dv", "dlog_decay"), ins, want):
        _close(x.grad, w, 1e-5, name)


def test_scan_refuses_what_the_kernel_cannot_take():
    q = torch.zeros(2, 128, 256)
    with pytest.raises(ssm_scan.ScanLoweringError, match="shared memory"):
        ssm_scan.linear_scan_cuda(q, q, torch.zeros(2, 128, 256), q,
                                  torch.zeros(2, 256), mode="rwkv6")
    q = torch.zeros(2, 100, 16)
    with pytest.raises(ValueError, match="not a multiple"):
        ssm_scan.linear_scan_cuda(q, q, q, q, torch.zeros(2, 16),
                                  mode="rwkv6", chunk=64)
    with pytest.raises(ValueError, match="requires the u"):
        ssm_scan.linear_scan_cuda(q, q, q, q, mode="rwkv6", chunk=50)
    with pytest.raises(ssm_scan.ScanLoweringError, match="exceeds"):
        q = torch.zeros(2, 16, 136)
        ssm_scan.linear_scan_cuda(q, q, torch.zeros(2, 16, 8), q,
                                  torch.zeros(2, 136), mode="rwkv6", chunk=16)
    # the footprint rule: rwkv6's shape in bf16 leaves room for two blocks
    # an SM (228 KB, 1 KB reserved a block); zamba2's and f32 fit one
    assert ssm_scan.scan_smem_bytes(128, 64, 64, 2) == 111_616
    assert 2 * (111_616 + 1024) <= 233_472
    assert ssm_scan.scan_smem_bytes(128, 64, 112, 2) <= 232_448
    assert ssm_scan.scan_smem_bytes(128, 64, 112, 4) <= 232_448
    assert ssm_scan.scan_smem_bytes(256, 64, 64, 2) <= 232_448
    assert ssm_scan.scan_smem_bytes(512, 64, 64, 2) > 232_448


# ---------------------------------------------------------------------------
# The RWKV-6 block and LM (rwkv6_7b smoke config, f32)
# ---------------------------------------------------------------------------


def _numpy_params(shapes, seed=0):
    """Seeded numpy weights in the reference's tree, near the init's
    values where the init is a constant (mixes, w0, norm scales)."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        a = rng.standard_normal(s.shape)
        if "scale" in name or "ln_x" in name:
            a = 1.0 + 0.1 * a
        elif "cores" in name:
            a = 0.35 * a
        elif "mix" in name:
            a = 0.5 + 0.1 * a
        elif "w0" in name:
            a = -2.0 + 0.3 * a
        elif "'u'" in name:
            a = 0.1 * a
        elif "wA" in name or "wB" in name:
            a = 0.05 * a
        else:
            a = a / np.sqrt(s.shape[-2])
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def rwkv():
    """Reference and port rwkv6_7b smoke LMs in f32 with the TNN default,
    from the same numpy weights, and three batches."""
    jarch, arch = jbase.get("rwkv6_7b"), tbase.get("rwkv6_7b")
    jcfg = dataclasses.replace(jarch.smoke(jarch.tnn_default),
                               compute_dtype=jnp.float32)
    jm = JLM(jcfg)
    tree = _numpy_params(jax.eval_shape(jm.init, jax.random.key(0)))
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(3):
        toks = rng.integers(0, jcfg.vocab, (2, 33)).astype(np.int32)
        batches.append({"inputs": toks[:, :-1], "targets": toks[:, 1:]})
    return jm, tree, batches, arch


def _port_model(rwkv, backend="cuda"):
    _, tree, _, arch = rwkv
    model, cfg = steps.build_model(arch, tnn=arch.tnn_default, smoke=True,
                                   device="cpu", backend=backend,
                                   compute_dtype=torch.float32)
    model.load_state_dict(params_from_numpy(tree, cfg))
    return model, cfg


def test_block_time_and_channel_mix_match_reference(rwkv):
    jm, tree, _, _ = rwkv
    model, cfg = _port_model(rwkv)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    xp = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    lp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["layers"]["rwkv"])
    block = model.layers[0].rwkv
    want, want_state = jm.rwkv.time_mix(lp, jnp.asarray(x))
    got, got_state = block.time_mix(torch.from_numpy(x))
    _close(got.detach(), want, 1e-5, "time_mix")
    _close(got_state.detach(), want_state, 1e-5, "time_mix state")
    want = jm.rwkv.channel_mix(lp, jnp.asarray(x), jnp.asarray(xp))
    got = block.channel_mix(torch.from_numpy(x), torch.from_numpy(xp))
    _close(got.detach(), want, 1e-5, "channel_mix")


@pytest.fixture(scope="module")
def rwkv_grads(rwkv):
    """The reference's logits, loss and gradients on the first batch."""
    jm, tree, batches, _ = rwkv
    batch = {k: jnp.asarray(v) for k, v in batches[0].items()}
    jparams = jax.tree.map(jnp.asarray, tree)
    jlogits, _ = jm(jparams, batch["inputs"])
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, batch), has_aux=True)(jparams)
    return jlogits, jloss, jgrads


@pytest.mark.parametrize("remat", [False, True])
def test_lm_logits_loss_and_grads_match_reference(rwkv, rwkv_grads, remat):
    _, _, batches, _ = rwkv
    batch = batches[0]
    jlogits, jloss, jgrads = rwkv_grads
    model, cfg = _port_model(rwkv)
    model.cfg = dataclasses.replace(cfg, remat=remat)
    logits = model(torch.from_numpy(batch["inputs"]))
    _close(logits.detach(), jlogits, 1e-5, "logits")
    loss, _ = model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    got = to_numpy_tree({n: p.grad for n, p in model.named_parameters()},
                        cfg)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(jgrads))
    jax.tree_util.tree_map_with_path(
        lambda path, g, w: _close(g, w, 4e-5, jax.tree_util.keystr(path)),
        got, jax.tree.map(np.asarray, jgrads))


def test_train_steps_match_reference(rwkv):
    jm, tree, batches, _ = rwkv
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=4)
    jopt = JAdamW(**kw)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = {"params": jparams, "opt": jopt.init(jparams)}
    jstep = jax.jit(jsteps.make_train_step(jm, jopt, jblocks.no_shard))
    model, _ = _port_model(rwkv)
    opt = AdamW(**kw)
    params = dict(model.named_parameters())
    state = {"params": params, "opt": opt.init(params)}
    step = steps.make_train_step(model, opt)
    for batch in batches:
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        for key in ("loss", "grad_norm"):
            assert float(m[key]) == pytest.approx(float(jm_[key]),
                                                  rel=6e-5), key


def test_prefill_then_decode_matches_forward_and_reference(rwkv):
    jm, tree, batches, _ = rwkv
    toks = batches[1]["inputs"][:, :16]
    jparams = jax.tree.map(jnp.asarray, tree)
    model, _ = _port_model(rwkv)
    with torch.no_grad():
        full = model(torch.from_numpy(toks))
        lp, cache = model.prefill(torch.from_numpy(toks[:, :-1]), max_len=20)
        ld, cache = model.decode_step(torch.from_numpy(toks[:, -1]), cache)
    assert int(cache.length) == 16 and cache.layers.wkv.dtype == torch.float32
    _close(lp, full[:, -2], 1e-5, "prefill vs forward")
    _close(ld, full[:, -1], 1e-4, "decode vs forward")
    jlp, jcache = jm.prefill(jparams, jnp.asarray(toks[:, :-1]), max_len=20)
    jld, _ = jm.decode_step(jparams, jnp.asarray(toks[:, -1]), jcache)
    _close(lp, jlp, 1e-5, "prefill vs reference")
    _close(ld, jld, 1e-5, "decode vs reference")
    _close(cache.layers.wkv, np.asarray(
        jm.decode_step(jparams, jnp.asarray(toks[:, -1]), jcache)[1]
        .layers.wkv), 1e-5, "decode state vs reference")
    fresh = model.init_cache(2, 20)
    assert fresh.layers.wkv.shape == (2, 2, 4, 16, 16)
    assert not fresh.layers.wkv.any() and int(fresh.length) == 0


def test_adamw_decays_every_rwkv_leaf_the_reference_decays(rwkv):
    _, tree, _, _ = rwkv
    model, cfg = _port_model(rwkv)
    want = {}
    jax.tree_util.tree_map_with_path(
        lambda path, a: want.__setitem__(
            ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path), a.ndim >= 2), tree)
    seen = set()
    for name, p in model.named_parameters():
        ref_name = ("layers." + name.split(".", 2)[2]
                    if name.startswith("layers.") else name)
        assert AdamW.decays(name, p) == want[ref_name], name
        assert reference_ndim(name, p) == tree_ndim(tree, ref_name)
        seen.add(ref_name)
    assert seen == set(want)
    for leaf in ("layers.rwkv.mix.r", "layers.rwkv.w0", "layers.rwkv.u",
                 "layers.rwkv.ln_x"):
        assert want[leaf]


def tree_ndim(tree, name):
    node = tree
    for part in name.split("."):
        node = node[int(part)] if isinstance(node, (tuple, list)) \
            else node[part]
    return node.ndim


def test_convert_round_trip(rwkv):
    _, tree, _, _ = rwkv
    _, cfg = _port_model(rwkv)
    back = to_numpy_tree(params_from_numpy(tree, cfg), cfg)
    jax.tree.map(np.testing.assert_array_equal, back, tree)


# ---------------------------------------------------------------------------
# Config, CLIs
# ---------------------------------------------------------------------------


def test_full_config_is_the_published_shape():
    arch = tbase.get("rwkv6_7b")
    cfg = arch.model(arch.tnn_default)
    jcfg = jbase.get("rwkv6_7b").model()
    for f in ("num_layers", "d_model", "num_heads", "head_dim", "d_ff",
              "vocab", "block", "remat"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert (cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab) == (
        32, 4096, 14336, 65536)
    # One layer on the meta device (nothing allocated), times 32, plus
    # the embedding, lm_head and final norm: the reference's count.
    layer = RWKVLayer(cfg, device="meta")
    n = (cfg.num_layers * sum(p.numel() for p in layer.parameters())
         + 2 * cfg.vocab * cfg.d_model + cfg.d_model)
    assert n == 3_825_438_720
    assert [tuple(c.shape) for c in layer.rwkv.cm_k.cores] == [
        (128, 64), (64, 112, 64), (64, 64, 64), (64, 64)]


def test_recompute_stash_turns_on_remat():
    arch = tbase.get("rwkv6_7b")
    tnn = dataclasses.replace(arch.tnn_default, remat="recompute")
    _, cfg = steps.build_model(arch, tnn=tnn, smoke=True, device="meta")
    assert cfg.remat and not arch.smoke(tnn).remat


def test_build_model_cuts_depth_only():
    arch = tbase.get("rwkv6_7b")
    model, cfg = steps.build_model(arch, tnn=arch.tnn_default, device="meta",
                                   num_layers=2)
    full = arch.model(arch.tnn_default)
    assert len(model.layers) == cfg.num_layers == 2
    assert dataclasses.replace(cfg, num_layers=full.num_layers) == full


def test_unported_blocks_raise_with_their_roadmap_item():
    """Mamba-2 is ported (``tests/test_torch_zamba2.py``) and so is the
    attention family's prefill (``tests/test_torch_dense.py``); what is
    not raises: an unknown block, and an architecture no package
    registers (the message points at ROADMAP.md)."""
    with pytest.raises(ValueError, match="unknown block"):
        LMConfig(name="m", num_layers=1, d_model=8, num_heads=1,
                 num_kv_heads=1, d_ff=8, vocab=8, block="moe").validate()
    LMConfig(name="m", num_layers=1, d_model=8, num_heads=1,
             num_kv_heads=1, d_ff=8, vocab=8, block="mamba2").validate()
    for arch_id in ("no_such_arch", "seamless-m4t-large"):
        with pytest.raises(KeyError, match="ROADMAP.md"):
            tbase.get(arch_id)
    model, _ = steps.build_model(tbase.get("paper_atis_tt"), smoke=True,
                                 device="cpu")
    logits, cache = model.prefill(torch.zeros((1, 4), dtype=torch.long),
                                  max_len=8)
    assert logits.shape == (1, model.cfg.vocab) and int(cache.length) == 4


def test_train_cli_runs_rwkv6_on_the_cpu(capsys):
    train_cli.main(["--arch", "rwkv6_7b", "--smoke", "--tnn",
                    "--tnn-backend", "cuda", "--device", "cpu", "--steps",
                    "2", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "step     1 loss" in out and "done: final loss" in out


def test_serve_cli_refuses_rwkv6_with_its_roadmap_item():
    """The serve CLI serves rwkv6_7b (the engine's sequential
    ``decode_step`` fallback); a quantized KV cache for it is refused,
    by the CLI and by the engine, with the reference's ``ValueError``: a
    quantized cache needs an attention-only model."""
    done = serve_cli.main(["--arch", "rwkv6_7b", "--smoke", "--device",
                           "cpu", "--requests", "1", "--prompt-len", "4",
                           "--max-new", "2"])
    assert [len(r.out_tokens) for r in done] == [2]
    with pytest.raises(ValueError, match="attention-only"):
        serve_cli.main(["--arch", "rwkv6_7b", "--smoke", "--device", "cpu",
                        "--serve-kv-dtype", "fp8"])
    model, _ = steps.build_model(tbase.get("rwkv6_7b"), smoke=True,
                                 device="cpu")
    with pytest.raises(ValueError, match="attention-only"):
        ServeEngine(model, batch_size=1, max_len=8, kv_policy="fp8")
