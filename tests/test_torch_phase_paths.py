"""``phase_paths=False`` (autodiff through the FP plan) in the port.

* The GEMM and chain kernels' autograd Functions
  (``repro_torch.kernels.ops.matmul`` / ``chain_n``): values and the
  gradients of ``x`` and every weight against torch autograd through
  their plain versions (``kernels/ref.py``), f32 within 1e-5 of each
  gradient's scale (the same products summed in another order); bf16
  within two bf16 ulps of the scale (the backward rounds each link's
  gradient to bf16 where autograd of the plain version does too, but
  sums in another order).  Chains of 2 and 3 links.
* ``TensorizedLinear`` with ``phase_paths=False`` against ``True`` on
  TT/TTM/TR, f32: outputs within 1e-5 and gradients within 2e-3 (the
  reference's ``tests/test_core.py::test_phase_paths_off_matches_on``),
  and against the reference's ``einsum`` layer with ``phase_paths=False``
  under ``jax.grad`` on the same numpy inputs (the reference's autodiff
  is the definition; its ``pallas`` route cannot be differentiated in
  this mode on the CPU): outputs within 1e-5, gradients within 2e-3.
* A few smoke training steps through the train entry point with the
  ``cuda`` backend on the CPU and ``phase_paths=False``, in f32, against
  the per-phase run: losses within 1e-4 (two contraction orders), the
  plans' chains through the chain Function.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import csse as jcsse  # noqa: E402
from repro.core import factorizations as jF  # noqa: E402
from repro.core import tensorized as jtensorized  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import csse, plan_compiler, tensorized  # noqa: E402
from repro_torch.core import factorizations as F  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import steps as steps_lib  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402

SPECS = {"tt": ((4, 4, 4), (4, 4, 4), 6),
         "ttm": ((4, 4, 4), (4, 4, 4), 6),
         "tr": ((4, 4), (4, 4), 5)}


def _bf16_ulp(scale: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(scale, 1e-30))) - 7)


def _close(got, want, rel, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()),
                                              1e-30), err_msg=what)


def _grads(fn, inputs, dy):
    ins = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(ins)
    out.backward(dy)
    return out.detach(), [t.grad for t in ins]


def _tol(dtype, scale):
    return 1e-5 * scale if dtype == torch.float32 else 2 * _bf16_ulp(scale)


# ---------------------------------------------------------------------------
# The kernels' autograd Functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("transpose_rhs", [False, True])
def test_matmul_function_grads_match_autograd_of_plain(transpose_rhs, dtype):
    rng = np.random.default_rng(1)
    m, n, k = 24, 40, 16
    x = torch.from_numpy(rng.standard_normal((m, k))).to(dtype)
    w = torch.from_numpy(rng.standard_normal(
        (n, k) if transpose_rhs else (k, n))).to(dtype)
    dy = torch.from_numpy(rng.standard_normal((m, n))).to(dtype)
    got = _grads(lambda t: ops.matmul(t[0], t[1],
                                      transpose_rhs=transpose_rhs),
                 [x, w], dy)
    want = _grads(lambda t: ref.matmul(t[0], t[1],
                                       transpose_rhs=transpose_rhs),
                  [x, w], dy)
    assert torch.equal(got[0], want[0])
    for name, g, r in zip(("dx", "dw"), got[1], want[1]):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        scale = float(r.float().abs().max())
        assert float((g.float() - r.float()).abs().max()) <= _tol(
            dtype, scale), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("links", [
    # (m0, ((k_i, n_i), ...)): a 2-link chain without regroup, one with
    # a regroup, and a 3-link chain regrouping twice.
    (32, ((12, 12), (12, 8))),
    (48, ((8, 4), (8, 6))),
    (64, ((8, 4), (16, 6), (12, 5)))])
def test_chain_function_grads_match_autograd_of_plain(links, dtype):
    m0, shapes = links
    rng = np.random.default_rng(len(shapes))
    x = torch.from_numpy(rng.standard_normal((m0, shapes[0][0]))).to(dtype)
    ws = [torch.from_numpy(rng.standard_normal(s)).to(dtype) for s in shapes]
    out = ref.chain_n(x, ws)
    dy = torch.from_numpy(rng.standard_normal(tuple(out.shape))).to(dtype)
    got = _grads(lambda t: ops.chain_n(t[0], t[1:]), [x, *ws], dy)
    want = _grads(lambda t: ref.chain_n(t[0], t[1:]), [x, *ws], dy)
    assert torch.equal(got[0], want[0])
    for i, (g, r) in enumerate(zip(got[1], want[1])):
        assert g.dtype == r.dtype and g.shape == r.shape, i
        scale = float(r.float().abs().max())
        assert float((g.float() - r.float()).abs().max()) <= _tol(
            dtype, scale), f"input {i}"


def test_chain_function_skips_unneeded_grads():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((32, 8))).float()
    w1 = torch.from_numpy(rng.standard_normal((8, 4))).float()
    w2 = torch.from_numpy(rng.standard_normal((8, 3))).float()
    w2.requires_grad_()
    ops.chain_n(x, [w1, w2]).sum().backward()
    assert x.grad is None and w1.grad is None
    (want,) = torch.autograd.grad(ref.chain_n(x, [w1, w2]).sum(), [w2])
    torch.testing.assert_close(w2.grad, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# TensorizedLinear: phase_paths=False against True and the reference
# ---------------------------------------------------------------------------


def _inputs(method):
    out, inp, rank = SPECS[method]
    jfact = jF.make(method, out, inp, rank)
    rng = np.random.default_rng(10 + len(method))
    cores = [0.5 * rng.standard_normal(jfact.core_shape(i)).astype(np.float32)
             for i in range(jfact.num_cores)]
    x = rng.standard_normal((4, jfact.N)).astype(np.float32)
    return jfact, cores, x


def _reference(method):
    """The reference einsum layer with phase_paths=False: its output and
    ``jax.grad`` of ``sum(y**2)`` in the cores and x."""
    jfact, cores, x = _inputs(method)
    layer = jtensorized.TensorizedLinear(
        fact=jfact, phase_paths=False, compute_dtype=jnp.float32,
        opts=jcsse.SearchOptions(fused_chain=True), backend="einsum")
    params = {"cores": tuple(jnp.asarray(c) for c in cores)}
    y = layer(params, jnp.asarray(x))
    gp, gx = jax.grad(lambda p, xx: jnp.sum(layer(p, xx) ** 2),
                      argnums=(0, 1))(params, jnp.asarray(x))
    return (np.asarray(y), [np.asarray(g) for g in gp["cores"]],
            np.asarray(gx))


def _port(method, backend, phase_paths):
    out, inp, rank = SPECS[method]
    _, cores, x = _inputs(method)
    layer = tensorized.TensorizedLinear(
        F.make(method, out, inp, rank), phase_paths=phase_paths,
        opts=csse.SearchOptions(fused_chain=True),
        compute_dtype=torch.float32, backend=backend, device="cpu")
    with torch.no_grad():
        for p, c in zip(layer.cores, cores):
            p.copy_(torch.from_numpy(c))
    tx = torch.from_numpy(x).requires_grad_()
    y = layer(tx)
    (y ** 2).sum().backward()
    return (y.detach().numpy(), [p.grad.numpy() for p in layer.cores],
            tx.grad.numpy())


@pytest.mark.parametrize("backend", ["einsum", "cuda"])
@pytest.mark.parametrize("method", sorted(SPECS))
def test_phase_paths_off_matches_on_and_reference(method, backend):
    y_on, g_on, gx_on = _port(method, backend, True)
    y_off, g_off, gx_off = _port(method, backend, False)
    y_ref, g_ref, gx_ref = _reference(method)
    np.testing.assert_allclose(y_off, y_on, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y_off, y_ref, rtol=1e-5, atol=1e-5)
    for i, (a, b, r) in enumerate(zip(g_off + [gx_off], g_on + [gx_on],
                                      g_ref + [gx_ref])):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3,
                                   err_msg=f"grad {i} vs phase_paths=True")
        np.testing.assert_allclose(a, r, rtol=2e-3, atol=2e-3,
                                   err_msg=f"grad {i} vs the reference")


def test_phase_paths_off_cuda_route_reaches_the_functions(monkeypatch):
    """On the cuda backend under grad, the FP plan's GEMMs and chains go
    through the autograd Functions (this TT layer's FP plan at 4 tokens
    fuses two chains); without grad, through the plain wrappers."""
    calls = {"matmul": 0, "chain_n": 0}

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(plan_compiler.ops, "matmul",
                        counted("matmul", ops.matmul))
    monkeypatch.setattr(plan_compiler.ops, "chain_n",
                        counted("chain_n", ops.chain_n))
    fact = F.tt((4, 4, 4), (4, 4, 4), 6)
    layer = tensorized.TensorizedLinear(
        fact, phase_paths=False, opts=csse.SearchOptions(fused_chain=True),
        compute_dtype=torch.float32, backend="cuda", device="cpu")
    x = torch.randn(4, fact.N)
    with torch.no_grad():
        layer(x)
    assert calls == {"matmul": 0, "chain_n": 0}
    layer(x).sum().backward()
    assert calls["matmul"] > 0 and calls["chain_n"] > 0
    assert all(p.grad is not None for p in layer.cores)


def test_quantized_phase_paths_off_refuses_grad_but_serves():
    tnn = tensorized.TNNConfig(enabled=True, rank=3, num_factors=2,
                               phase_paths=False, backend="cuda",
                               precision=tensorized.QuantPolicy(
                                   dtype="fp8_e4m3"))
    layer = tensorized.make_tensorized_linear(16, 16, tnn,
                                              compute_dtype=torch.float32,
                                              device="cpu")
    x = torch.randn(4, 16)
    with torch.no_grad():
        assert torch.isfinite(layer(x)).all()
    with pytest.raises(NotImplementedError, match="item 12"):
        layer(x)


# ---------------------------------------------------------------------------
# Training through the train entry point
# ---------------------------------------------------------------------------


def test_phase_paths_off_trains_like_per_phase_in_f32(monkeypatch):
    build = steps_lib.build_model
    monkeypatch.setattr(steps_lib, "build_model", lambda *a, **k: build(
        *a, compute_dtype=torch.float32, **k))
    chains = {"n": 0}
    chain_fn = ops.chain_n

    def counted(*a, **k):
        chains["n"] += 1
        return chain_fn(*a, **k)

    monkeypatch.setattr(plan_compiler.ops, "chain_n", counted)
    arch = tbase.get("paper_atis_tt")
    kw = dict(smoke=True, tnn=True, steps=3, global_batch=2, seq_len=16,
              lr=3e-3, device="cpu", log_every=100, tnn_backend="cuda")
    on = train_cli.train("paper_atis_tt", tnn_cfg=arch.tnn_default, **kw)
    assert chains["n"] == 0
    off = train_cli.train("paper_atis_tt", tnn_cfg=dataclasses.replace(
        arch.tnn_default, phase_paths=False), **kw)
    assert chains["n"] > 0
    assert not off["cfg"].tnn.phase_paths
    assert all(np.isfinite(off["losses"]))
    np.testing.assert_allclose(off["losses"], on["losses"], rtol=1e-4)
    np.testing.assert_allclose(off["grad_norms"], on["grad_norms"],
                               rtol=1e-3)
