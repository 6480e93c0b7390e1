"""Port flash attention (kernel B7's plain version, the blockwise
attention Function and its backward) against the JAX reference.

* The port's plain ``flash_attention_fwd`` (out and lse) against the
  reference's Pallas ``flash_attention_fwd`` in interpret mode and its jnp
  twin ``_blockwise_attention_fwd_only``: causal and not, GQA (KV 2, G 3),
  several chunks with ``q_chunk != kv_chunk``.  Tolerances: f32 2e-5 of
  the output scale (sums in another order); bf16 one bf16 ulp of the
  scale (out is rounded to bf16 once).
* On :func:`~repro_torch.kernels.flash_attention.rounding_probe`'s bf16
  inputs, the plain forward against both references within one bf16 ulp
  of each element, and the same forward without ``p``'s rounding, or
  stepped over half the kv chunk, shown to miss by several: the check the
  CUDA kernel is held to on the card fails a kernel that skips either.
* ``blockwise_attention``'s gradients (dq, dk, dv) against ``jax.grad``
  through the reference's custom VJP, f32 within 1e-4 of each gradient's
  scale.

The CUDA kernel is held against its plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Tiny shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the CPU.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention_fwd as jflash,
)
from repro.models import blocks as jblocks  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused_contraction as fc  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import blocks  # noqa: E402

# (B, T, H, KV, D, q_chunk, kv_chunk, causal)
CASES = {
    "causal_one_chunk": (2, 16, 4, 4, 8, 16, 16, True),
    "noncausal_one_chunk": (2, 16, 4, 4, 8, 16, 16, False),
    "gqa_causal_multichunk": (2, 16, 6, 2, 8, 8, 4, True),
    "gqa_noncausal_multichunk": (1, 24, 6, 2, 12, 12, 8, False),
    "causal_qchunk_lt_kvchunk": (1, 16, 3, 1, 8, 4, 8, True),
}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _bf16_ulp(scale: float) -> float:
    return 2.0 ** (math.floor(math.log2(max(scale, 1e-30))) - 7)


def _elem_ulps(got, want):
    """|got - want| in bf16 ulps of each element of ``want``."""
    w = want.float()
    ulp = 2.0 ** (torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
    return (got.float() - w).abs() / ulp


def _qkv(B, T, H, KV, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, D)).astype(np.float32),
            rng.standard_normal((B, T, KV, D)).astype(np.float32),
            rng.standard_normal((B, T, KV, D)).astype(np.float32))


def _tol(dtype, scale):
    return 2e-5 * scale if dtype == "float32" else _bf16_ulp(scale)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_forward_matches_reference(case, dtype):
    B, T, H, KV, D, qc, kc, causal = CASES[case]
    tdt, jdt = DTYPES[dtype]
    arrays = _qkv(B, T, H, KV, D, seed=len(case))
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrays)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in arrays)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, q_chunk=qc,
                                      kv_chunk=kc)
    assert out.dtype == tdt and lse.dtype == torch.float32
    assert tuple(lse.shape) == (B, T, KV, H // KV)
    twin = jblocks._blockwise_attention_fwd_only(
        jq, jk, jv, causal=causal, q_chunk=qc, kv_chunk=kc)
    pallas = jflash(jq, jk, jv, causal=causal, q_chunk=qc, kv_chunk=kc,
                    interpret=True)
    for want_out, want_lse in (twin, pallas):
        w = np.asarray(want_out.astype(jnp.float32))
        scale = float(np.abs(w).max())
        err = float(np.abs(out.float().numpy() - w).max())
        assert err <= _tol(dtype, scale), (err, scale)
        wl = np.asarray(want_lse)
        np.testing.assert_allclose(lse.numpy(), wl, rtol=0,
                                   atol=2e-5 * float(np.abs(wl).max()))


@pytest.mark.parametrize("kv_chunk", [32, 16])
def test_rounding_probe_holds_the_reference_rounding(kv_chunk):
    B, T, H, D = 2, 32, 4, 16
    q, k, v = fa.rounding_probe(B, T, H, D)
    kw = dict(causal=False, q_chunk=T, kv_chunk=kv_chunk)
    out, _ = fa.flash_attention_fwd(q, k, v, **kw)
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (q, k, v))
    for want, _ in (jblocks._blockwise_attention_fwd_only(jq, jk, jv, **kw),
                    jflash(jq, jk, jv, interpret=True, **kw)):
        want = torch.from_numpy(np.array(want.astype(jnp.float32)))
        assert float(_elem_ulps(out, want).max()) <= 1.0
    unrounded, _ = ref.flash_attention_fwd(q, k, v.float(), **kw)
    half_chunk, _ = ref.flash_attention_fwd(q, k, v, causal=False,
                                            q_chunk=T, kv_chunk=kv_chunk // 2)
    assert float(_elem_ulps(unrounded, out).min()) > 4.0
    # Odd rows put the peak key last: a half-chunk step misses there.
    assert float(_elem_ulps(half_chunk, out)[:, :, 1::2].min()) > 4.0


@pytest.mark.parametrize("case", sorted(CASES))
def test_blockwise_attention_grads_match_reference(case):
    B, T, H, KV, D, qc, kc, causal = CASES[case]
    q, k, v = _qkv(B, T, H, KV, D, seed=3)
    do = np.random.default_rng(4).standard_normal((B, T, H, D)).astype(
        np.float32)

    def jloss(q, k, v):
        out = jblocks.blockwise_attention(q, k, v, causal=causal, q_chunk=qc,
                                          kv_chunk=kc)
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = blocks.blockwise_attention(tq, tk, tv, causal=causal, q_chunk=qc,
                                     kv_chunk=kc)
    (out * torch.from_numpy(do)).sum().backward()
    for name, got, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        w = np.asarray(w)
        np.testing.assert_allclose(
            got.numpy(), w, rtol=0, atol=1e-4 * float(np.abs(w).max()),
            err_msg=f"d{name}")


def test_flash_backward_equals_autograd_through_the_plain_forward():
    """The hand-written backward against autograd through the chunked
    plain forward (``ref.flash_attention_fwd``), f32 within 1e-4 of the
    scale."""
    B, T, H, KV, D, qc, kc, causal = CASES["gqa_causal_multichunk"]
    arrays = _qkv(B, T, H, KV, D, seed=9)
    grads = []
    for attend in (blocks.blockwise_attention,
                   lambda *ts, **kw: ref.flash_attention_fwd(*ts, **kw)[0]):
        ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
        out = attend(*ts, causal=causal, q_chunk=qc, kv_chunk=kc)
        (out.square().sum()).backward()
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))


def test_wrapper_refuses_what_the_kernel_cannot_take():
    q = torch.zeros(1, 4, 2, 160)
    with pytest.raises(fa.AttentionLoweringError, match="head dim"):
        fa.flash_attention_fwd(q, q[:, :, :1], q[:, :, :1])
    q = torch.zeros(1, 4, 3, 8)
    with pytest.raises(fa.AttentionLoweringError, match="multiple"):
        fa.flash_attention_fwd(q, q[:, :, :2], q[:, :, :2])
    with pytest.raises(ValueError, match="no kernel for device"):
        t = torch.zeros(1, 4, 2, 8, device="meta")
        fa.flash_attention_fwd(t, t, t)
    with pytest.raises(ValueError, match="divisible"):
        t = torch.zeros(1, 12, 2, 8)
        blocks.blockwise_attention(t, t, t, causal=True, q_chunk=8,
                                   kv_chunk=8)


def test_cpu_forward_launches_nothing():
    before = dict(fc.LAUNCHES)
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 2, 2, 8, seed=1))
    fa.flash_attention_fwd(q, k, v)
    assert fc.LAUNCHES == before


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 64, "tensor_cores"), (torch.bfloat16, 128, "tensor_cores"),
    (torch.bfloat16, 24, "tensor_cores"), (torch.bfloat16, 20, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt")])
def test_kernel_for_picks_tensor_cores_for_bf16_only(dtype, D, want):
    """bf16 with a head dim that is a multiple of 8 runs the tensor-core
    kernel; f32 stays on the SIMT kernel (TF32 would miss the f32 gate),
    as does a head dim the 16-byte copies cannot take."""
    q = torch.zeros(1, 4, 2, D, dtype=dtype)
    assert fa.kernel_for(q, q, q) == want
    if want == "tensor_cores":   # a view 2 bytes into its storage
        off = torch.zeros(1 * 4 * 2 * D + 1, dtype=dtype)[1:].reshape(q.shape)
        assert fa.kernel_for(off, q, q) == "simt"
