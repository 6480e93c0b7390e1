"""The port's CUDA kernels on the card, against their plain versions.

Every test here is ``cuda``-marked and skips without a card (the check
is made inside a fixture).  This file imports neither JAX nor the
reference, so it runs on a machine that has only PyTorch and the CUDA
toolkit::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 1e-5 of the output scale (sums in another order); bf16
2e-2 of the scale for the GEMM/chain kernels (one bf16 ulp, carried
through a chain link) and one bf16 ulp of the scale for attention (one
bf16 ulp of each element on the rounding probe).  The quantize and
dequantize kernels are bit-exact; the scaled GEMM sums exact f32
products in another order (1e-5 of the scale); the scaled chain rounds
its intermediates to bf16, where a sum in another order now and then
lands one ulp apart: at most 0.5% of the elements beyond 1e-5 of the
scale and none beyond two bf16 ulps (``ref.chain_scaled_agreement``).
The scan kernel: output as the GEMM's f32 rule and one bf16 ulp of the
scale in bf16 (one rounding of the f32 result); its f32 final state
within 1e-5 of the state's scale, against the twin and, for the
broadcast ``ssd`` form, against the sequential oracle too.
"""

import ctypes
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import contraction, csse  # noqa: E402
from repro_torch.core.tnetwork import TensorNetwork  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused_contraction as fc  # noqa: E402
from repro_torch.kernels import quantized as qk  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssm_scan as sk  # noqa: E402
from repro_torch.precision import QuantPolicy, quant  # noqa: E402

QUANT = ["fp8_e4m3", "fp8_e5m2", "int8"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this on the GPU")
    return torch.device("cuda")


def _bf16_ulp(scale: float) -> float:
    return 2.0 ** (math.floor(math.log2(max(scale, 1e-30))) - 7)


def _max_err(got, want):
    return float((got.float() - want.float()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain_versions(cuda_device, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(128, 8, generator=gen, device=cuda_device).to(dtype)
    w = torch.randn(768, 8, generator=gen, device=cuda_device).to(dtype)
    before = dict(fc.LAUNCHES)
    got = fc.matmul_cuda(x, w, transpose_rhs=True)
    want = ref.matmul(x, w, transpose_rhs=True)
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2 * scale
    xc = torch.randn(2048, 192, generator=gen, device=cuda_device).to(dtype)
    ws = [torch.randn(s, generator=gen, device=cuda_device).to(dtype)
          for s in ((192, 8), (128, 8))]
    got = fc.chain_n_cuda(xc, ws)
    want = ref.chain_n(xc, ws)
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2 * scale
    assert fc.LAUNCHES["matmul"] == before["matmul"] + 1
    assert fc.LAUNCHES["chain_n"] == before["chain_n"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,k,trans", [
    (768, 3072, 1024, False),      # the shared WG strategy's dW
    (768, 8, 3072, True),          # a per-core WG product, K walked serially
    (12, 64, 1, False),            # an outer product: no contracted axis
])
def test_cuda_gemm_at_training_shapes(cuda_device, dtype, m, n, k, trans):
    gen = torch.Generator(device=cuda_device).manual_seed(m + n + k)
    x = torch.randn(m, k, generator=gen, device=cuda_device).to(dtype)
    w = torch.randn((n, k) if trans else (k, n), generator=gen,
                    device=cuda_device).to(dtype)
    got = fc.matmul_cuda(x, w, transpose_rhs=trans)
    want = ref.matmul(x, w, transpose_rhs=trans)
    scale = float(want.float().abs().max())
    tol = 1e-5 * scale if dtype == torch.float32 else _bf16_ulp(scale)
    assert _max_err(got, want) <= tol


@pytest.mark.cuda
def test_cuda_outer_product_step_runs_the_gemm(cuda_device):
    net = TensorNetwork(sizes={"a": 3, "b": 4, "c": 5},
                        nodes=(("a", "b"), ("c",)), node_names=("A", "C"),
                        output=("a", "c", "b"))
    plan = csse.search(net).plan
    rng = np.random.default_rng(0)
    ts = [torch.from_numpy(rng.standard_normal(net.node_shape(i)).astype(
        np.float32)).to(cuda_device) for i in range(2)]
    before = fc.LAUNCHES["matmul"]
    got = contraction.execute(plan, ts, backend="cuda")
    assert fc.LAUNCHES["matmul"] == before + 1
    torch.testing.assert_close(got, torch.einsum("ab,c->acb", *ts),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_kernel_matches_plain_version(cuda_device, dtype):
    """At the plain version's own chunking: one kv chunk, several, a
    ragged last sub-tile (kv chunk 100) and the largest chunk."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for B, T, H, KV, D, causal, kc in ((8, 128, 12, 12, 64, True, 128),
                                       (2, 256, 8, 2, 128, False, 64),
                                       (2, 200, 6, 2, 24, True, 100),
                                       (1, 1024, 4, 4, 64, True, 1024)):
        q, k, v = (torch.randn(s, generator=gen, device=cuda_device).to(dtype)
                   for s in ((B, T, H, D), (B, T, KV, D), (B, T, KV, D)))
        before = fc.LAUNCHES["flash_attention_fwd"]
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                          q_chunk=T, kv_chunk=kc)
        want, want_lse = ref.flash_attention_fwd(
            q, k, v, causal=causal, q_chunk=T, kv_chunk=kc)
        torch.cuda.synchronize()
        assert fc.LAUNCHES["flash_attention_fwd"] == before + 1
        scale = float(want.float().abs().max())
        tol = 1e-5 * scale if dtype == torch.float32 else _bf16_ulp(scale)
        assert _max_err(out, want) <= tol
        torch.testing.assert_close(lse, want_lse, rtol=0,
                                   atol=1e-5 * float(want_lse.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("kv_chunk", [128, 64])
def test_cuda_flash_kernel_rounds_p_per_chunk(cuda_device, kv_chunk):
    """On the rounding probe every output element is within one bf16 ulp
    of the plain version's: a kernel that skipped ``p``'s rounding, or
    stepped its softmax over fewer keys than the chunk, misses by many
    (``tests/test_torch_flash.py`` shows both)."""
    B, T, H, D = 8, 128, 12, 64
    q, k, v = fa.rounding_probe(B, T, H, D, device=cuda_device)
    kw = dict(causal=False, q_chunk=T, kv_chunk=kv_chunk)
    out, _ = fa.flash_attention_fwd(q, k, v, **kw)
    want, _ = ref.flash_attention_fwd(q, k, v, **kw)
    w = want.float()
    ulp = 2.0 ** (torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
    assert float(((out.float() - w).abs() / ulp).max()) <= 1.0


@pytest.mark.cuda
def test_cuda_train_step_matches_the_cpu(cuda_device):
    """One f32 training step of the smoke LM through the kernels on the
    card and through their plain versions on the CPU: loss within 1e-5
    and every gradient within 1e-4 of its scale."""
    from repro_torch.configs import base
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import steps

    arch = base.get("paper_atis_tt")
    grads, losses = [], []
    for device in ("cpu", cuda_device):
        model, cfg = steps.build_model(arch, arch.tnn_default, smoke=True,
                                       device=device, backend="cuda",
                                       compute_dtype=torch.float32)
        batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64,
                                       global_batch=4)).batch(0)
        before = dict(fc.LAUNCHES)
        loss, _ = model.loss({k: torch.from_numpy(v)
                              for k, v in batch.items()})
        loss.backward()
        if device != "cpu":
            # The unquantized path's kernels (the scaled ones and the
            # quantize/dequantize pair run only under a quantized policy).
            assert all(fc.LAUNCHES[k] > before[k]
                       for k in ("matmul", "chain_n", "flash_attention_fwd"))
        losses.append(float(loss.detach()))
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters()})
    assert losses[1] == pytest.approx(losses[0], rel=1e-5)
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=0,
                                   atol=1e-4 * float(g.abs().max()))


@pytest.mark.cuda
def test_cuda_rwkv6_train_step_matches_the_cpu(cuda_device):
    """One f32 training step of the rwkv6_7b smoke LM (remat on, TT
    channel mix) through the GEMM and scan kernels on the card and
    through their plain versions on the CPU: loss within 1e-5 and every
    gradient within 1e-4 of its scale."""
    import dataclasses

    from repro_torch.configs import base
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import steps

    arch = base.get("rwkv6_7b")
    grads, losses = [], []
    for device in ("cpu", cuda_device):
        model, cfg = steps.build_model(arch, arch.tnn_default, smoke=True,
                                       device=device, backend="cuda",
                                       compute_dtype=torch.float32)
        model.cfg = dataclasses.replace(cfg, remat=True)
        if grads:
            model.load_state_dict(base_sd)
        else:
            base_sd = {k: v.clone() for k, v in model.state_dict().items()}
        batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64,
                                       global_batch=4)).batch(0)
        before = dict(fc.LAUNCHES)
        loss, _ = model.loss({k: torch.from_numpy(v)
                              for k, v in batch.items()})
        loss.backward()
        if device != "cpu":
            # forward and the checkpoint re-run of each of the 2 layers
            assert fc.LAUNCHES["linear_scan"] == before["linear_scan"] + 4
            assert fc.LAUNCHES["matmul"] > before["matmul"]
        losses.append(float(loss.detach()))
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters()})
    assert losses[1] == pytest.approx(losses[0], rel=1e-5)
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=0,
                                   atol=1e-4 * float(g.abs().max()))


def _bits(t):
    """The raw bytes of ``t`` on the host, for bit-for-bit comparison."""
    return t.contiguous().reshape(-1).view(torch.uint8).cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", QUANT)
def test_cuda_quantize_kernels_are_bit_exact(cuda_device, dtype):
    """On the tie probe (every rounding a close call) and on random
    inputs, in f32 and bf16: the quantize kernel's payload and the
    dequantize kernel's f32/bf16 output equal the plain versions' bits."""
    pol = QuantPolicy.parse(dtype)
    x, s = ref.tie_probe(pol, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    r = torch.randn(300, 96, generator=gen, device=cuda_device) * 3
    rs = quant.quantize(r, pol).row_scales()
    for xin, sc in ((x, s), (x.bfloat16(), s), (r, rs), (r.bfloat16(), rs)):
        before = dict(fc.LAUNCHES)
        got = qk.quantize_cuda(xin, sc, pol)
        want = ref.quantize(xin, sc, pol)
        assert torch.equal(_bits(got), _bits(want))
        for out in (torch.float32, torch.bfloat16):
            d = qk.dequantize_cuda(got, sc, out)
            assert torch.equal(_bits(d), _bits(ref.dequantize(want, sc,
                                                              out)))
        assert fc.LAUNCHES["quantize"] == before["quantize"] + 1
        assert fc.LAUNCHES["dequantize"] == before["dequantize"] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", QUANT)
@pytest.mark.parametrize("m,n,k,trans", [
    (1024, 96, 8, True),           # an FP product of the ATIS layers
    (768, 8, 3072, True),          # a WG product, K walked serially
    (100, 120, 96, False),
])
def test_cuda_scaled_gemm_matches_plain_version(cuda_device, dtype, m, n, k,
                                                trans):
    pol = QuantPolicy.parse(dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(m + n + k)
    x = torch.randn(m, k, generator=gen, device=cuda_device)
    w = torch.randn((n, k) if trans else (k, n), generator=gen,
                    device=cuda_device)
    qx, qw = quant.quantize(x, pol), quant.quantize(w, pol)
    sl = qx.row_scales() * 1.5
    sr = torch.rand(1, n, generator=gen, device=cuda_device) + 0.5
    before = fc.LAUNCHES["matmul_scaled"]
    got = fc.matmul_cuda(qx.q, qw.q, transpose_rhs=trans, scales=(sl, sr))
    want = ref.matmul_scaled(qx.q, qw.q, sl, sr, transpose_rhs=trans)
    torch.cuda.synchronize()
    assert fc.LAUNCHES["matmul_scaled"] == before + 1
    assert got.dtype == torch.float32
    assert _max_err(got, want) <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", QUANT)
@pytest.mark.parametrize("m0,links", [
    (2048, ((192, 8), (128, 8))),          # regroup g = 16
    (1536, ((8, 8), (64, 8), (96, 8))),    # 3 links, g = 8 then 12
    (1024, ((96, 8), (8, 64))),            # g = 1
])
def test_cuda_scaled_chain_matches_plain_version(cuda_device, dtype, m0,
                                                 links):
    pol = QuantPolicy.parse(dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(m0)
    x = quant.quantize(torch.randn(m0, links[0][0], generator=gen,
                                   device=cuda_device), pol)
    ws = [quant.quantize(torch.randn(s_, generator=gen, device=cuda_device),
                         pol) for s_ in links]
    s_first = x.row_scales() * ws[0].scale
    mids = [w.scale.reshape(1, 1) for w in ws[1:-1]]
    s_last = torch.full((1, links[-1][1]), float(ws[-1].scale),
                        device=cuda_device)
    scales = (s_first, *mids, s_last)
    before = fc.LAUNCHES["chain_n_scaled"]
    got = fc.chain_n_cuda(x.q, [w.q for w in ws], scales=scales)
    want = ref.chain_n_scaled(x.q, [w.q for w in ws], scales)
    torch.cuda.synchronize()
    assert fc.LAUNCHES["chain_n_scaled"] == before + 1
    good, nums = ref.chain_scaled_agreement(got, want)
    assert good, nums


@pytest.mark.cuda
def test_cuda_refused_quantized_chain_raises(cuda_device, monkeypatch):
    """A quantized chain the kernel refuses at run time is a fault on the
    card: it propagates instead of running the plain chain math."""
    from repro_torch.core import factorizations as F
    from repro_torch.core import plan_compiler

    net = F.tt((12, 8, 8), (8, 8, 12), 8).forward_network(
        batch_axes=(("b", 128),))
    plan = csse.search(net, csse.SearchOptions(fused_chain=True)).plan
    compiled = plan_compiler.compile_plan(plan,
                                          policy=QuantPolicy.parse("fp8"))
    assert compiled.report()["num_chain"] >= 1
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    ts = [torch.randn(net.node_shape(i), generator=gen, device=cuda_device)
          for i in range(net.num_nodes)]

    def refuse(*a, **k):
        raise fc.ChainLoweringError("refused for the test")

    monkeypatch.setattr(plan_compiler, "chain_n_cuda", refuse)
    plan_compiler.reset_degrade_counts()
    with pytest.raises(fc.ChainLoweringError, match="refused for the test"):
        plan_compiler.run(compiled, ts)
    assert plan_compiler.DEGRADE_COUNTS["runtime_quantized"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,dv,chunk", [("rwkv6", 64, 128),
                                           ("ssd", 112, 128),
                                           ("rwkv6", 48, 64)])
def test_cuda_scan_matches_plain_twin(cuda_device, mode, dv, chunk, dtype):
    """The scan kernel's output and final state against its plain twin:
    f32 output within 1e-5 of its scale, bf16 within one bf16 ulp of it
    (one rounding of the f32 result), the f32 state within 1e-5."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    bh, t, dk = 16, 256, 64
    q, k = (torch.randn(bh, t, dk, generator=gen, device=cuda_device)
            .to(dtype) for _ in range(2))
    v = torch.randn(bh, t, dv, generator=gen, device=cuda_device).to(dtype)
    ld = -torch.exp(torch.randn(bh, t, dk, generator=gen,
                                device=cuda_device)) * 0.1
    u = torch.randn(bh, dk, generator=gen, device=cuda_device) * 0.5
    before = fc.LAUNCHES["linear_scan"]
    o, st = sk.linear_scan_cuda(q, k, v, ld, u, mode=mode, chunk=chunk)
    wo, wst = ref.chunked_linear_scan(q, k, v, ld, u, mode=mode, chunk=chunk)
    torch.cuda.synchronize()
    assert fc.LAUNCHES["linear_scan"] == before + 1
    assert o.dtype == dtype and st.dtype == torch.float32
    scale = float(wo.float().abs().max())
    tol = 1e-5 * scale if dtype == torch.float32 else _bf16_ulp(scale)
    assert _max_err(o, wo) <= tol
    assert _max_err(st, wst) <= 1e-5 * float(wst.abs().max())


@pytest.mark.cuda
def test_cuda_scan_refuses_what_it_cannot_take(cuda_device):
    z = torch.zeros(2, 128, 256, device=cuda_device)
    u = torch.zeros(2, 256, device=cuda_device)
    before = fc.LAUNCHES["linear_scan"]
    with pytest.raises(sk.ScanLoweringError, match="shared memory"):
        sk.linear_scan_cuda(z, z, z, z, u, mode="rwkv6")
    z = torch.zeros(2, 100, 16, device=cuda_device)
    with pytest.raises(ValueError, match="not a multiple"):
        sk.linear_scan_cuda(z, z, z, z, u[:, :16], mode="rwkv6", chunk=64)
    assert fc.LAUNCHES["linear_scan"] == before


@pytest.mark.cuda
def test_cuda_scan_footprint_rule_matches_the_kernel(cuda_device):
    """The wrapper's footprint rule is the kernel's, shape for shape, and
    rwkv6's training shape in bf16 runs two blocks an SM."""
    lib = sk._lib()
    for chunk, dk, dv in ((128, 64, 64), (128, 64, 112), (96, 32, 64),
                          (1, 64, 64), (64, 128, 128)):
        for size in (2, 4):
            assert lib.ss_smem_bytes(chunk, dk, dv, size) == \
                sk.scan_smem_bytes(chunk, dk, dv, size) <= 232_448
    assert sk.blocks_per_sm(128, 64, 64, torch.bfloat16) >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["rwkv6", "ssd"])
def test_cuda_scan_split_tf32_over_wide_exp_factors(cuda_device, mode,
                                                    dtype):
    """Split TF32 keeps f32 accuracy where the factored form's exp factors
    span 1e-30 to 1e30 (a chunk's lc reaching about -69 per channel): the
    gates of test_cuda_scan_matches_plain_twin, over two chunks."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    bh, t, dk, dv, chunk = 32, 256, 64, 64, 128
    q, k = (torch.randn(bh, t, dk, generator=gen, device=cuda_device)
            .to(dtype) for _ in range(2))
    v = torch.randn(bh, t, dv, generator=gen, device=cuda_device).to(dtype)
    ld = -1.08 * torch.rand(bh, t, dk, generator=gen, device=cuda_device)
    u = torch.randn(bh, dk, generator=gen, device=cuda_device) * 0.5
    o, st = sk.linear_scan_cuda(q, k, v, ld, u, mode=mode, chunk=chunk)
    wo, wst = ref.chunked_linear_scan(q, k, v, ld, u, mode=mode, chunk=chunk)
    torch.cuda.synchronize()
    lc = torch.cumsum(ld.reshape(bh, 2, chunk, dk), 2)
    assert float(lc.min()) < -69.0 and torch.isfinite(wo).all()
    scale = float(wo.float().abs().max())
    tol = 1e-5 * scale if dtype == torch.float32 else _bf16_ulp(scale)
    assert _max_err(o, wo) <= tol
    assert _max_err(st, wst) <= 1e-5 * float(wst.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("decay", [-0.7, "random"])
def test_cuda_scan_broadcast_ssd_form(cuda_device, decay, dtype):
    """zamba2's ssd shape (BH 512, T 128, dk 64, dv 112) with the decay
    one scalar per token, broadcast over dk (Mamba-2's form): at -0.7 a
    token, where the factored form overflows, the kernel is finite and
    holds its gates against the twin and the sequential oracle; at the
    reference test's decay too."""
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    bh, t, dk, dv = 512, 128, 64, 112
    q, k = (torch.randn(bh, t, dk, generator=gen, device=cuda_device)
            .to(dtype) for _ in range(2))
    v = torch.randn(bh, t, dv, generator=gen, device=cuda_device).to(dtype)
    if decay == "random":
        ld1 = -torch.exp(torch.randn(bh, t, 1, generator=gen,
                                     device=cuda_device)) * 0.1
    else:
        ld1 = torch.full((bh, t, 1), decay, device=cuda_device)
    ld = ld1.expand(bh, t, dk)
    before = fc.LAUNCHES["linear_scan"]
    o, st = sk.linear_scan_cuda(q, k, v, ld, mode="ssd", chunk=128)
    wo, wst = ref.chunked_linear_scan(q, k, v, ld, mode="ssd", chunk=128)
    oo, ost = ref.linear_scan_batched(q, k, v, ld, mode="ssd",
                                      out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert fc.LAUNCHES["linear_scan"] == before + 1
    assert torch.isfinite(o).all() and torch.isfinite(st).all()
    for want, want_st in ((wo, wst), (oo, ost)):
        scale = float(want.float().abs().max())
        tol = 1e-5 * scale if dtype == torch.float32 else _bf16_ulp(scale)
        assert _max_err(o, want) <= tol
        assert _max_err(st, want_st) <= 1e-5 * float(want_st.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv_chunk", [256, 1024])
def test_cuda_flash_tensor_cores_two_pass_gqa(cuda_device, kv_chunk, causal):
    """The tensor-core kernel at D 128 with GQA (G 4) over chunks longer
    than its 128 register-resident keys (two passes over each chunk):
    one bf16 ulp of the scale against the plain version, lse within 1e-5
    of its scale; and on the rounding probe at such a chunk, every element
    within one ulp."""
    gen = torch.Generator(device=cuda_device).manual_seed(kv_chunk)
    B, T, H, KV, D = 2, 1024, 16, 4, 128
    q, k, v = (torch.randn(s, generator=gen, device=cuda_device)
               .to(torch.bfloat16)
               for s in ((B, T, H, D), (B, T, KV, D), (B, T, KV, D)))
    assert fa.kernel_for(q, k, v) == "tensor_cores"
    kw = dict(causal=causal, q_chunk=T, kv_chunk=kv_chunk)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    want, want_lse = ref.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert _max_err(out, want) <= _bf16_ulp(float(want.float().abs().max()))
    torch.testing.assert_close(lse, want_lse, rtol=0,
                               atol=1e-5 * float(want_lse.abs().max()))
    q, k, v = fa.rounding_probe(1, kv_chunk, 12, 64, device=cuda_device)
    kw = dict(causal=False, q_chunk=kv_chunk, kv_chunk=kv_chunk)
    out, _ = fa.flash_attention_fwd(q, k, v, **kw)
    w = ref.flash_attention_fwd(q, k, v, **kw)[0].float()
    ulp = 2.0 ** (torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
    assert float(((out.float() - w).abs() / ulp).max()) <= 1.0


@pytest.mark.cuda
def test_cuda_flash_picks_simt_for_f32(cuda_device):
    """f32 runs the SIMT kernel (within 1e-5 of the scale), bf16 the
    tensor-core one, on the same inputs."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v = (torch.randn(2, 128, 4, 64, generator=gen, device=cuda_device)
               for _ in range(3))
    assert fa.kernel_for(q, k, v) == "simt"
    out, _ = fa.flash_attention_fwd(q, k, v, q_chunk=128, kv_chunk=128)
    want, _ = ref.flash_attention_fwd(q, k, v, q_chunk=128, kv_chunk=128)
    assert _max_err(out, want) <= 1e-5 * float(want.abs().max())
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    assert fa.kernel_for(qb, kb, vb) == "tensor_cores"


GEMM_DTYPES = [torch.float32, torch.bfloat16] + QUANT


def _gemm_case(device, dtype, m, n, k, trans, seed, x_offset=0):
    """X, W (and, for a quantized dtype, the scales) on the card, with X
    ``x_offset`` elements into its storage; the call and its plain twin."""
    gen = torch.Generator(device=device).manual_seed(seed)
    xs = torch.randn(m * k + x_offset, generator=gen, device=device)
    w = torch.randn((n, k) if trans else (k, n), generator=gen, device=device)
    if isinstance(dtype, str):
        pol = QuantPolicy.parse(dtype)
        qx, qw = quant.quantize(xs, pol), quant.quantize(w, pol)
        x = qx.q[x_offset:].view(m, k)
        sl = qx.scale * (torch.rand(m, 1, generator=gen, device=device) + .5)
        sr = qw.scale * (torch.rand(1, n, generator=gen, device=device) + .5)
        kw = dict(transpose_rhs=trans, scales=(sl, sr))
        return (x, qw.q, kw,
                lambda: ref.matmul_scaled(x, qw.q, sl, sr,
                                          transpose_rhs=trans))
    x = xs.to(dtype)[x_offset:].view(m, k)
    w = w.to(dtype)
    return (x, w, dict(transpose_rhs=trans),
            lambda: ref.matmul(x, w, transpose_rhs=trans))


def _gemm_tol(dtype, scale):
    """The kernel gates: one bf16 ulp of the scale in bf16 (one rounding
    of an f32 sum), 1e-5 of it in f32 and for the scaled kinds (f32 sums
    of exact products, in another order)."""
    return _bf16_ulp(scale) if dtype == torch.bfloat16 else 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", GEMM_DTYPES, ids=str)
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("m,n,k,split", [
    (12, 64, 1, False),          # an outer product
    (100, 8, 8, False),          # N = 8, ragged M
    (12, 40, 12, False),         # M = 12, K = 12: rows 24 (bf16) / 12 bytes
    (200, 72, 112, False),       # ragged M, N and last stage
    (130, 20, 1000, True),       # ragged everything, split
    (768, 8, 3072, True),        # the ATIS WG product
    (64, 1024, 14336, True),     # rwkv6's longest K
])
def test_cuda_gemm_matches_plain_version_in_every_config(
        cuda_device, dtype, trans, m, n, k, split):
    """Both GEMM kernels (tensor cores for bf16/fp8/int8, FMA for f32)
    against ``ref.matmul`` / ``ref.matmul_scaled`` in both W layouts,
    split-K and not, at the existing gates."""
    x, w, kw, plain = _gemm_case(cuda_device, dtype, m, n, k, trans,
                                 m + n + k)
    cfg = fc.gemm_config_for(x, w, trans)
    assert (cfg.splits > 1) == split, cfg
    key = "matmul" if isinstance(dtype, torch.dtype) else "matmul_scaled"
    before = dict(fc.LAUNCHES)
    got = fc.matmul_cuda(x, w, **kw)
    want = plain()
    torch.cuda.synchronize()
    assert fc.LAUNCHES[key] == before[key] + 1
    assert (fc.LAUNCHES[key + "_reduce"]
            == before[key + "_reduce"] + int(split))
    assert got.dtype == want.dtype and got.shape == (m, n)
    scale = float(want.float().abs().max())
    assert _max_err(got, want) <= _gemm_tol(dtype, scale), cfg


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, "fp8_e4m3", "int8",
                                   torch.float32], ids=str)
@pytest.mark.parametrize("offset", [1, 12])
def test_cuda_gemm_reads_misaligned_views(cuda_device, dtype, offset):
    """X a row-offset view (``offset`` elements into its storage, K = 12):
    the wrapper narrows the copies to what the base address allows."""
    m, n, k = 96, 8, 12
    x, w, kw, plain = _gemm_case(cuda_device, dtype, m, n, k, False, 7,
                                 x_offset=offset)
    cfg = fc.gemm_config_for(x, w, False)
    size, want_copy = x.element_size(), 16
    while any(b % want_copy for b in (offset * size, k * size, n * size)):
        want_copy //= 2
    assert cfg.copy_bytes == want_copy
    got = fc.matmul_cuda(x, w, **kw)
    want = plain()
    scale = float(want.float().abs().max())
    assert _max_err(got, want) <= _gemm_tol(dtype, scale), cfg


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,m,n,k,trans", [
    (torch.bfloat16, 64, 1024, 14336, True),
    ("fp8_e4m3", 1024, 8, 3072, True),
    ("int8", 768, 8, 3072, False),
    (torch.float32, 1024, 64, 14336, False),
], ids=str)
def test_cuda_gemm_split_k_is_deterministic(cuda_device, dtype, m, n, k,
                                            trans):
    """Two calls on the same inputs give the same bits (the split slices
    are summed in a fixed order, without atomics)."""
    x, w, kw, _ = _gemm_case(cuda_device, dtype, m, n, k, trans, 11)
    assert fc.gemm_config_for(x, w, trans).splits > 1
    a = fc.matmul_cuda(x, w, **kw)
    b = fc.matmul_cuda(x, w, **kw)
    assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,m,n,k,trans", [
    ("fp8_e4m3", 1024, 8, 3072, True),     # the longest fp8 K
    ("fp8_e5m2", 1024, 8, 3072, True),
    (torch.bfloat16, 64, 1024, 14336, True),   # the longest bf16 K
], ids=str)
def test_cuda_gemm_error_at_the_longest_k(cuda_device, dtype, m, n, k,
                                          trans):
    """The tensor cores' sums stay within the gates at the main paths'
    longest K: fp8's promoted into f32 every stage (1e-5 of the scale),
    bf16's within one bf16 ulp of it."""
    x, w, kw, plain = _gemm_case(cuda_device, dtype, m, n, k, trans, 13)
    got, want = fc.matmul_cuda(x, w, **kw), plain()
    scale = float(want.float().abs().max())
    assert _max_err(got, want) <= _gemm_tol(dtype, scale)


@pytest.mark.cuda
def test_cuda_gemm_config_rule_matches_the_kernel(cuda_device,
                                                  monkeypatch):
    """The kernel's check takes every configuration ``gemm_config``
    picks, with the same K slice and shared memory, and refuses one it
    cannot run; the wrapper then raises and counts no launch."""
    lib = fc._lib()
    codes = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2,
             torch.int8: 4}
    for dtype, code in codes.items():
        for trans in (False, True):
            for tile in range(len(fc.GEMM_TILES)):
                assert lib.fc_gemm_smem_bytes(dtype.itemsize, int(trans),
                                              tile) == \
                    fc.gemm_smem_bytes(dtype.itemsize, trans, tile)
            for m, n, k in ((768, 8, 3072), (12, 40, 12), (1024, 14336, 64),
                            (64, 64, 4096), (2048, 12, 8), (12, 64, 1)):
                for align in (16, 8, 4, 2, 1):
                    cfg = fc.gemm_config(m, n, k, dtype, trans, align)
                    ptr = 1 << 20 | align
                    assert lib.fc_gemm_k_slice(
                        code, int(trans), cfg.tile, cfg.splits,
                        cfg.copy_bytes, ptr, 1 << 20, m, n, k) == \
                        cfg.k_slice, (dtype, trans, m, n, k, align, cfg)
    # a 16-byte copy from an address 2 bytes in: refused
    assert lib.fc_gemm_k_slice(1, 0, 1, 1, 16, (1 << 20) + 2, 1 << 20, 64,
                               64, 64) == -1
    x = torch.zeros(64, 64, device=cuda_device, dtype=torch.bfloat16)
    bad = fc.gemm_config(64, 64, 64, torch.bfloat16, False)._replace(
        splits=3)      # 2 stages of K cannot make 3 slices
    monkeypatch.setattr(fc, "gemm_config_for", lambda *a: bad)
    before = fc.LAUNCHES["matmul"]
    with pytest.raises(RuntimeError, match="matmul_cuda launch failed"):
        fc.matmul_cuda(x, x)
    assert fc.LAUNCHES["matmul"] == before


#: every chain geometry of the ATIS serve, train and fp8-train plans
#: (``chip_smoke.py``'s enumeration), then ragged K and N and 3 links
ATIS_CHAINS = [
    (4, ((96, 8), (8, 64))), (4, ((96, 8), (8, 96))),
    (4, ((128, 8), (8, 64))), (384, ((8, 8), (64, 8))),
    (1024, ((12, 8), (128, 8))), (1536, ((64, 8), (96, 8))),
    (2048, ((192, 8), (128, 8))), (768, ((768, 8), (64, 8))),
    (768, ((3072, 8), (64, 8))), (3072, ((768, 8), (96, 8))),
    (96, ((64, 8), (64, 8))), (12288, ((192, 8), (128, 8))),
    (12288, ((256, 8), (96, 8))),
]
FP8_CHAINS = ATIS_CHAINS[7:]
ODD_CHAINS = [
    (24, ((16, 8), (8, 12))),              # g = 1, ragged N
    (130, ((5, 4), (8, 6))),               # K0 = 5: 10-byte rows, g = 2
    (12, ((4, 2), (4, 6), (12, 3))),       # 3 links, n0 = 2
    (1536, ((8, 8), (64, 8), (96, 8))),    # 3 links, g = 8 then 12
    (512, ((40, 20), (40, 12))),           # n0 = 20: three n8 passes
    (512, ((16, 2), (256, 4))),            # g = 128: two link-0 row passes
    (3072, ((1100, 8), (96, 8))),          # K0 of 34.4 k-steps (8-bit)
]


def _chain_case(device, dtype, m0, links, seed):
    """X and W (and, for a quantized dtype, the folded scales) on the card;
    the kernel's call and its plain twin."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(m0, links[0][0], generator=gen, device=device)
    ws = [torch.randn(s_, generator=gen, device=device) for s_ in links]
    if isinstance(dtype, torch.dtype):
        x, ws = x.to(dtype), [w.to(dtype) for w in ws]
        return (x, ws, lambda: fc.chain_n_cuda(x, ws),
                lambda: ref.chain_n(x, ws))
    pol = QuantPolicy.parse(dtype)
    qx, qws = quant.quantize(x, pol), [quant.quantize(w, pol) for w in ws]
    scales = (qx.row_scales() * qws[0].scale,
              *[w.scale.reshape(1, 1) for w in qws[1:-1]],
              qws[-1].scale * (torch.rand(1, links[-1][1], generator=gen,
                                          device=device) + 0.5))
    wq = [w.q for w in qws]
    return (qx.q, wq, lambda: fc.chain_n_cuda(qx.q, wq, scales=scales),
            lambda: ref.chain_n_scaled(qx.q, wq, scales))


def _chain_ok(dtype, got, want):
    """bf16: two ulps of the scale (a rounded intermediate one ulp apart,
    carried by the next link); scaled: ``ref.chain_scaled_agreement``;
    f32: 1e-5 of the scale."""
    if isinstance(dtype, str):
        return ref.chain_scaled_agreement(got, want)
    scale = float(want.float().abs().max())
    tol = 1e-5 * scale if dtype == torch.float32 else 2 * _bf16_ulp(scale)
    err = _max_err(got, want)
    return err <= tol, {"max_abs_err": err, "tol": tol}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,m0,links", [
    *[(torch.bfloat16, m0, links) for m0, links in ATIS_CHAINS + ODD_CHAINS],
    *[(d, m0, links) for d in QUANT
      for m0, links in FP8_CHAINS + ODD_CHAINS[3:4] + ODD_CHAINS[-1:]],
], ids=str)
def test_cuda_chain_tc_matches_plain_version(cuda_device, dtype, m0, links):
    """The tensor-core chain at every ATIS chain geometry, ragged K and N,
    several n8 passes and link-0 row passes, and 3 links: one launch,
    counted, within the gates of ``chip_smoke.py``."""
    x, ws, call, plain = _chain_case(cuda_device, dtype, m0, links, m0)
    assert fc.chain_kernel_for(x) == "tensor_cores"
    assert fc.chain_config_for(x, ws).kernel == "tensor_cores"
    key = "chain_n" if isinstance(dtype, torch.dtype) else "chain_n_scaled"
    before = dict(fc.LAUNCHES)
    got = call()
    want = plain()
    torch.cuda.synchronize()
    assert fc.LAUNCHES[key] == before[key] + 1
    assert got.shape == want.shape and got.dtype == want.dtype
    good, nums = _chain_ok(dtype, got, want)
    assert good, (nums, fc.chain_config_for(x, ws))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,m0,links", [
    (torch.bfloat16, 768, ((3072, 8), (64, 8))),
    ("fp8_e4m3", 12288, ((192, 8), (128, 8))),
    ("fp8_e5m2", 768, ((768, 8), (64, 8))),
    ("int8", 3072, ((768, 8), (96, 8))),
], ids=str)
def test_cuda_chain_tc_is_deterministic(cuda_device, dtype, m0, links):
    """Two calls on the same inputs give the same bits (link 0's warp
    partials are summed in a fixed order)."""
    _, _, call, _ = _chain_case(cuda_device, dtype, m0, links, 21)
    assert torch.equal(_bits(call()), _bits(call()))


@pytest.mark.cuda
def test_cuda_chain_picks_its_kernel_by_dtype(cuda_device):
    """f32 runs the SIMT kernel (1e-5 of the scale), the other dtypes the
    tensor-core one; both count under the same key."""
    m0, links = 2048, ((192, 8), (128, 8))
    x, ws, call, plain = _chain_case(cuda_device, torch.float32, m0, links, 4)
    assert fc.chain_kernel_for(x) == "simt"
    assert fc.chain_config_for(x, ws).kernel == "simt"
    before = fc.LAUNCHES["chain_n"]
    good, nums = _chain_ok(torch.float32, call(), plain())
    assert good, nums
    assert fc.LAUNCHES["chain_n"] == before + 1
    for dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2,
                  torch.int8):
        assert fc.chain_kernel_for(x.to(dtype)) == "tensor_cores"


@pytest.mark.cuda
def test_cuda_chain_config_rule_matches_the_kernel(cuda_device,
                                                   monkeypatch):
    """The kernel's own layout gives the shared memory ``chain_config``
    computed, at every geometry above in every dtype; a warp slice it does
    not take is refused, the wrapper raises and counts no launch."""
    lib = fc._lib()
    codes = {torch.bfloat16: 1, torch.float8_e4m3fn: 2,
             torch.float8_e5m2: 3, torch.int8: 4}
    for m0, links in ATIS_CHAINS + ODD_CHAINS:
        rows, _ = fc.chain_plan(m0, links)
        n = len(links)
        ks = (ctypes.c_int * n)(*(k for k, _ in links))
        ns = (ctypes.c_int * n)(*(c for _, c in links))
        ms = (ctypes.c_int * n)(*(r // rows[-1] for r in rows))
        for dtype, code in codes.items():
            cfg = fc.chain_config(m0, links, dtype)
            assert lib.fc_chain_tc_smem_bytes(
                code, ks, ns, ms, n, cfg.band, cfg.warp_k) == \
                cfg.smem_bytes, (m0, links, dtype, cfg)
    x, ws, call, _ = _chain_case(cuda_device, torch.bfloat16, 768,
                                 ((768, 8), (64, 8)), 3)
    bad = fc.chain_config_for(x, ws)._replace(warp_k=8)  # half a k-step
    monkeypatch.setattr(fc, "chain_config_for", lambda *a: bad)
    before = fc.LAUNCHES["chain_n"]
    with pytest.raises(RuntimeError, match="chain_n_cuda launch failed"):
        call()
    assert fc.LAUNCHES["chain_n"] == before


# ---------------------------------------------------------------------------
# B5 / B6 with a per-tensor scalar scale, and the per-tensor requantize
# ---------------------------------------------------------------------------


def _same_bits(got, want) -> bool:
    """Bit-equal, a NaN matching any NaN."""
    g, w = torch.isnan(got.float()), torch.isnan(want.float())
    if not torch.equal(g, w):
        return False
    gb = got.contiguous().reshape(-1).view(torch.uint8).reshape(g.numel(), -1)
    wb = want.contiguous().reshape(-1).view(torch.uint8).reshape(w.numel(),
                                                                 -1)
    keep = ~g.reshape(-1)
    return torch.equal(gb[keep], wb[keep])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", QUANT)
@pytest.mark.parametrize("rows,cols,offset", [
    (1024, 768, 0), (8, 96, 0), (12288, 8, 0), (3, 5, 0), (1, 4099, 0),
    (300, 13, 0), (64, 64, 1), (128, 768, 3)])
def test_cuda_quantize_scalar_and_row_scales_are_bit_exact(
        cuda_device, dtype, rows, cols, offset):
    """B5 and B6 with one device-scalar scale and with per-row scales, in
    f32 and bf16, at row lengths that are and are not multiples of the
    8-element step and at misaligned views (``offset`` elements into the
    storage): the plain versions' bits; one launch each."""
    pol = QuantPolicy.parse(dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(rows * cols)
    base = torch.randn(rows * cols + offset, generator=gen,
                       device=cuda_device) * 3
    x32 = base[offset:].view(rows, cols)
    st = quant.quantize(x32, pol).scale
    srow = quant.expand_row_scales(st, rows) * torch.linspace(
        0.5, 2.0, rows, device=cuda_device)[:, None]
    for xin in (x32, x32.bfloat16()):
        for sc in (st, srow):
            before = dict(fc.LAUNCHES)
            got = qk.quantize_cuda(xin, sc, pol)
            assert torch.equal(_bits(got), _bits(ref.quantize(xin, sc, pol)))
            q8 = torch.empty(rows * cols + offset, dtype=got.dtype,
                             device=cuda_device)[offset:].view(rows, cols)
            q8.copy_(got)
            for out in (torch.float32, torch.bfloat16):
                d = qk.dequantize_cuda(q8, sc, out)
                assert torch.equal(_bits(d), _bits(ref.dequantize(q8, sc,
                                                                  out)))
            assert fc.LAUNCHES["quantize"] == before["quantize"] + 1
            assert fc.LAUNCHES["dequantize"] == before["dequantize"] + 2


def _requant_input(device, case, n, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, generator=gen, device=device) * 3
    if case == "zeros":
        x.zero_()
    elif case == "nan":
        x[n // 2] = float("nan")
        x[0] = float("inf")
    elif case == "inf":
        x[n - 1], x[n // 3] = float("-inf"), float("inf")
    elif case == "negzero":
        x.zero_()
        x[::2] = -0.0
        x[n // 2] = -1.25
    elif case == "tiny":
        x *= 1e-30
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", QUANT)
@pytest.mark.parametrize("n", [1, 7, 64, 4099, 24576, 32768, 32769, 200003,
                               3_145_728])
@pytest.mark.parametrize("case", ["random", "zeros", "nan", "inf", "negzero",
                                  "tiny"])
def test_cuda_requantize_is_bit_exact(cuda_device, dtype, n, case):
    """The requantize kernel(s) against ``ref.requantize``: payload and
    scale bit for bit (a NaN as a NaN), across the one-launch limit, on
    all zeros (the 1e-12 floor), NaN, ±inf, -0.0 and subnormal-scale
    inputs; repeats give identical bits; one launch up to
    ``REQUANT_ONE_LAUNCH_MAX`` elements (one block), a cast and an amax
    launch above it."""
    pol = QuantPolicy.parse(dtype)
    x = _requant_input(cuda_device, case, n, n)
    before = dict(fc.LAUNCHES)
    q, s = qk.requantize_cuda(x, pol)
    wq, ws = ref.requantize(x, pol)
    torch.cuda.synchronize()
    assert _same_bits(q, wq) and _same_bits(s, ws), (float(s), float(ws))
    assert q.dtype == pol.operand_dtype and s.shape == ()
    two = n > qk.REQUANT_ONE_LAUNCH_MAX
    assert fc.LAUNCHES["requantize"] == before["requantize"] + 1
    assert (fc.LAUNCHES["requantize_amax"]
            == before["requantize_amax"] + int(two))
    q2, s2 = qk.requantize_cuda(x, pol)
    assert torch.equal(_bits(q2), _bits(q)) and torch.equal(_bits(s2),
                                                            _bits(s))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", QUANT)
@pytest.mark.parametrize("layout", ["permuted", "misaligned", "bf16",
                                    "tie_probe", "big_permuted"])
def test_cuda_requantize_layouts(cuda_device, dtype, layout):
    """A permuted op result (walked in storage order; ``q`` keeps the
    strides torch's ops give), a misaligned view, bf16 input and the tie
    probe's values, against ``ref.requantize``; a non-dense view raises."""
    pol = QuantPolicy.parse(dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    if layout == "permuted":
        x = torch.randn(16, 12, 8, generator=gen,
                        device=cuda_device).permute(2, 0, 1)
    elif layout == "big_permuted":
        x = torch.randn(1024, 96, 8, generator=gen,
                        device=cuda_device).permute(1, 2, 0)
    elif layout == "misaligned":
        x = torch.randn(40001, generator=gen, device=cuda_device)[1:]
    elif layout == "bf16":
        x = torch.randn(300, 96, generator=gen,
                        device=cuda_device).bfloat16()
    else:
        x, _ = ref.tie_probe(pol, device=cuda_device)
    q, s = qk.requantize_cuda(x, pol)
    wq, ws = ref.requantize(x, pol)
    assert torch.equal(_bits(q), _bits(wq)) and torch.equal(_bits(s),
                                                            _bits(ws))
    assert q.stride() == wq.stride() == x.stride()
    with pytest.raises(ValueError, match="dense"):
        qk.requantize_cuda(torch.randn(8, 1, device=cuda_device).expand(8, 4),
                           pol)


@pytest.mark.cuda
def test_cuda_requantize_limits_match_the_kernel(cuda_device):
    """The wrapper's launch rule uses the CUDA source's own limits; the
    two-launch path without its scratch is refused, not run."""
    lib = qk._lib()
    assert lib.q_requantize_one_launch_max() == qk.REQUANT_ONE_LAUNCH_MAX
    assert lib.q_requantize_max_partials() == qk.REQUANT_MAX_PARTIALS
    x = torch.ones(qk.REQUANT_ONE_LAUNCH_MAX + 1, device=cuda_device)
    q = torch.empty(x.shape, dtype=torch.int8, device=cuda_device)
    s = torch.empty((), device=cuda_device)
    rc = lib.q_requantize(0, 4, x.data_ptr(), q.data_ptr(), s.data_ptr(),
                          None, x.numel(), 127.0, 1.0, 1e-12,
                          ctypes.c_void_p(
                              torch.cuda.current_stream().cuda_stream))
    assert rc != 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", QUANT)
def test_cuda_quantized_plan_requantizes_every_op_through_the_kernel(
        cuda_device, dtype, monkeypatch):
    """A quantized FP plan on the card: one requantize launch per op, and
    ``quant.quantize`` derives no scale from a tensor on the card."""
    from repro_torch.core import factorizations as F
    from repro_torch.core import plan_compiler

    net = F.tt((12, 8, 8), (8, 8, 12), 8).forward_network(
        batch_axes=(("b", 1024),))
    plan = csse.search(net, csse.SearchOptions(fused_chain=True)).plan
    compiled = plan_compiler.compile_plan(plan,
                                          policy=QuantPolicy.parse(dtype))
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    ts = [torch.randn(net.node_shape(i), generator=gen, device=cuda_device)
          for i in range(net.num_nodes)]
    calls = []
    real = quant.quantize
    monkeypatch.setattr(quant, "quantize", lambda x, p, scale=None: (
        calls.append(scale is None and x.is_cuda) or real(x, p, scale=scale)))
    before = dict(fc.LAUNCHES)
    out = plan_compiler.run(compiled, ts)
    torch.cuda.synchronize()
    assert fc.LAUNCHES["requantize"] == (before["requantize"]
                                         + len(compiled.ops))
    assert fc.LAUNCHES["quantize"] == before["quantize"] + len(ts)
    assert fc.LAUNCHES["dequantize"] == before["dequantize"] + 1
    assert not any(calls)
    assert bool(torch.isfinite(out).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", QUANT)
def test_cuda_requantize_scale_is_the_true_divide(cuda_device, dtype):
    """The kernel's scale is ``clamp(amax, 1e-12) * margin / qmax`` with a
    true f32 divide, as the CPU (and the reference) computes it, at 64
    amaxes; torch on the card divides a tensor by a Python number as a
    multiply by its reciprocal, so ``policy.compute_scale`` there is not
    the oracle (``ref.requantize`` divides by a device tensor)."""
    pol = QuantPolicy.parse(dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    for i in range(64):
        x = torch.randn(257, generator=gen, device=cuda_device) * (i + 1)
        _, s = qk.requantize_cuda(x, pol)
        amax = x.abs().amax().cpu()
        want = torch.clamp(amax, min=1e-12) * pol.margin / pol.qmax
        assert torch.equal(_bits(s), _bits(want)), (i, float(s), float(want))


def _fp8_op_results():
    """Every op-result shape the fp8 training plans of ``paper_atis_tt``
    requantize (one per size): the sizes ``chip_smoke.py``'s
    ``kernel:requantize`` checks."""
    import dataclasses

    from repro_torch.configs import base
    from repro_torch.core import plan_compiler, tensorized
    from repro_torch.serving import profiles

    arch = base.get("paper_atis_tt")
    cfg = arch.model(arch.tnn_default)
    tnn = dataclasses.replace(cfg.tnn, precision=QuantPolicy.parse("fp8"))
    shapes = {}
    for _, d_in, d_out in profiles.tensorized_projections(cfg):
        layer = tensorized.make_tensorized_linear(
            d_out, d_in, tnn, compute_dtype=cfg.compute_dtype, device="meta")
        for results in tensorized.phase_plans(layer.fact, 8 * 128,
                                              layer.opts).values():
            for r in results:
                net = r.plan.network
                compiled = plan_compiler.compile_cached(
                    r.plan, fuse=layer.opts.fused_chain,
                    max_chain_len=layer.opts.max_chain_len,
                    policy=layer.precision)
                for op in compiled.ops:
                    if isinstance(op, plan_compiler.GemmOp):
                        axes = op.mat.m_axes + op.mat.n_axes
                    elif isinstance(op, plan_compiler.ChainOp):
                        axes = op.m_axes + op.n_axes
                    else:
                        axes = op.step.out_axes
                    shape = tuple(net.sizes[a] for a in axes)
                    shapes[math.prod(shape)] = shape
    return [shapes[n] for n in sorted(shapes)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", QUANT)
def test_cuda_compute_scale_is_the_reference_divide(cuda_device, dtype):
    """``policy.compute_scale`` on a CUDA amax equals numpy's f32
    ``max(amax, eps) * margin / qmax`` bit for bit (the reference's true
    divide), at the amax of every fp8 training op result, as the
    requantize kernel's scale does; so the scales the torch ops derive
    (delayed and just in time) are the kernel's."""
    from repro_torch.precision.policy import compute_scale

    pol = QuantPolicy.parse(dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    shapes = _fp8_op_results()
    assert len(shapes) == 20
    for shape in shapes:
        x = torch.randn(shape, generator=gen, device=cuda_device) * 3.0
        amax = x.abs().amax()
        got = compute_scale(amax, pol.qmax, pol.margin)
        a = np.float32(amax.item())
        want = (np.maximum(a, np.float32(1e-12)) * np.float32(pol.margin)
                / np.float32(pol.qmax))
        assert got.dtype == torch.float32 and got.is_cuda
        assert got.cpu().numpy().tobytes() == np.float32(want).tobytes(), (
            shape, float(got), float(want))
        assert torch.equal(_bits(got), _bits(qk.requantize_cuda(x, pol)[1]))
        assert torch.equal(_bits(quant.quantize(x, pol).scale), _bits(got))


@pytest.mark.cuda
def test_cuda_zamba2_train_step_matches_the_cpu(cuda_device):
    """One f32 training step of the zamba2_7b smoke LM (remat on, TT on
    the Mamba-2 projections, the shared attention's o and the shared
    MLP) through the kernels on the card and their plain versions on the
    CPU: loss within 1e-5 and every gradient within 1e-4 of its scale;
    the scan kernel runs twice a layer (forward and the checkpoint
    re-run), the attention kernel once a shared-block application."""
    import dataclasses

    from repro_torch.configs import base
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import steps

    arch = base.get("zamba2_7b")
    grads, losses = [], []
    for device in ("cpu", cuda_device):
        model, cfg = steps.build_model(arch, arch.tnn_one_card, smoke=True,
                                       device=device, backend="cuda",
                                       compute_dtype=torch.float32)
        model.cfg = dataclasses.replace(cfg, remat=True)
        if grads:
            model.load_state_dict(base_sd)
        else:
            base_sd = {k: v.clone() for k, v in model.state_dict().items()}
        batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64,
                                       global_batch=4)).batch(0)
        before = dict(fc.LAUNCHES)
        loss, _ = model.loss({k: torch.from_numpy(v)
                              for k, v in batch.items()})
        loss.backward()
        if device != "cpu":
            assert fc.LAUNCHES["linear_scan"] == (before["linear_scan"]
                                                  + 2 * cfg.num_layers)
            groups = cfg.num_layers // cfg.hybrid.shared_every
            assert fc.LAUNCHES["flash_attention_fwd"] == (
                before["flash_attention_fwd"] + groups)
            assert fc.LAUNCHES["matmul"] > before["matmul"]
        losses.append(float(loss.detach()))
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters()})
    assert losses[1] == pytest.approx(losses[0], rel=1e-5)
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=0,
                                   atol=1e-4 * float(g.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_mamba2_block_matches_the_cpu(cuda_device, dtype):
    """The Mamba-2 block at its init decay (about -0.7 a token), T 128,
    chunk 128, where the factored scan overflows: on the card (the GEMM
    and the scan kernel's broadcast-decay form) against the same block
    on the CPU (their plain versions), finite, within 1e-5 of the scale
    in f32 and 2e-2 in bf16 (a bf16 rounding of a projection or the
    scan's output landing one ulp apart, carried on)."""
    from repro_torch.configs import base
    from repro_torch.launch import steps

    arch = base.get("zamba2_7b")
    outs = []
    x = torch.randn(2, 128, 64, generator=torch.Generator().manual_seed(5))
    for device in ("cpu", cuda_device):
        model, _ = steps.build_model(arch, arch.tnn_one_card, smoke=True,
                                     device=device, backend="cuda",
                                     compute_dtype=dtype)
        if outs:
            model.load_state_dict(base_sd)
        else:
            base_sd = {k: v.clone() for k, v in model.state_dict().items()}
        before = fc.LAUNCHES["linear_scan"]
        with torch.no_grad():
            y = model.layers[0].mamba(x.to(device, dtype), chunk=128)
        if device != "cpu":
            assert fc.LAUNCHES["linear_scan"] == before + 1
        outs.append(y.float().cpu())
    assert bool(torch.isfinite(outs[1]).all())
    scale = float(outs[0].abs().max())
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert _max_err(outs[1], outs[0]) <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", QUANT)
def test_cuda_quantize_kv_equals_the_cpu(cuda_device, dtype):
    """The quantized KV cache's torch ops on the card (the serving
    engine's path there, no CPU branch) give the CPU's bits: the scale
    is a true divide by an f32 tensor on either device, and so is the
    cast's ``x / scale``.  Dequantizing and requantizing on the card under
    the same amax gives the cache back."""
    from repro_torch.serving import kv_cache

    pol = QuantPolicy.parse(dtype)
    gen = torch.Generator().manual_seed(3)
    layer = (10.0 ** torch.arange(3.0)).reshape(3, 1, 1, 1, 1)
    k, v = (torch.randn((3, 4, 48, 4, 128), generator=gen) * layer
            for _ in "kv")
    k, v = k.bfloat16(), v.bfloat16()
    want = kv_cache.quantize_kv(k, v, pol)
    got = kv_cache.quantize_kv(k.to(cuda_device), v.to(cuda_device), pol)
    for g, w in ((got.qk, want.qk), (got.qv, want.qv),
                 (got.k_amax, want.k_amax)):
        assert torch.equal(_bits(g.cpu()), _bits(w))
    again = kv_cache.quantize_kv(*kv_cache.dequantize_kv(got, pol), pol,
                                 prev=got)
    assert torch.equal(_bits(again.qk), _bits(got.qk))
    assert torch.equal(again.k_amax, got.k_amax)


@pytest.mark.cuda
def test_cuda_qwen2_prefill_and_decode_match_the_cpu(cuda_device):
    """``LM.prefill`` of the qwen2_7b smoke LM (GQA 4 / 2, a QKV bias) in
    f32 through the attention kernel on the card (once a layer), then
    ``decode_step``, against the CPU's plain versions within 1e-5 of the
    logits' scale."""
    from repro_torch.configs import base
    from repro_torch.launch import steps

    arch = base.get("qwen2_7b")
    toks = torch.randint(0, 256, (2, 16),
                         generator=torch.Generator().manual_seed(4))
    outs = []
    for device in ("cpu", cuda_device):
        model, cfg = steps.build_model(arch, arch.tnn_default, smoke=True,
                                       device=device, backend="cuda",
                                       compute_dtype=torch.float32)
        before = fc.LAUNCHES["flash_attention_fwd"]
        with torch.no_grad():
            lp, cache = model.prefill(toks[:, :-1], max_len=24)
            ld, _ = model.decode_step(toks[:, -1], cache)
        if device != "cpu":
            assert fc.LAUNCHES["flash_attention_fwd"] == (
                before + cfg.num_layers)
        outs.append((lp.cpu(), ld.cpu()))
    for got, want in zip(outs[1], outs[0]):
        assert _max_err(got, want) <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    ("matmul", 1024, 768, 8, False), ("matmul", 1024, 8, 768, True),
    ("chain", 768, ((768, 8), (64, 8))),
    ("chain", 64, ((8, 4), (16, 6), (12, 5)))])
def test_cuda_autograd_functions_match_the_cpu(cuda_device, case, dtype):
    """The GEMM and chain kernels' autograd Functions (``kernels.ops``)
    on the card against the same Functions on the CPU (their plain
    versions): the value and the gradient of every input, with the GEMM
    rule's tolerance (f32 1e-5, bf16 2e-2 of each one's scale); every
    backward GEMM on the card counts under ``matmul_bwd``."""
    from repro_torch.kernels import ops

    gen = torch.Generator().manual_seed(7)
    if case[0] == "matmul":
        _, m, n, k, trans = case
        shapes = [(m, k), (n, k) if trans else (k, n)]
        fn = lambda t: ops.matmul(t[0], t[1], transpose_rhs=trans)  # noqa
    else:
        _, m0, links = case
        shapes = [(m0, links[0][0]), *links]
        fn = lambda t: ops.chain_n(t[0], t[1:])  # noqa
    host = [torch.randn(s, generator=gen).to(dtype) for s in shapes]
    results = []
    for device in ("cpu", cuda_device):
        ins = [t.detach().clone().to(device).requires_grad_()
               for t in host]
        before = dict(fc.LAUNCHES)
        out = fn(ins)
        dy = torch.ones_like(out)
        out.backward(dy)
        if device != "cpu":
            torch.cuda.synchronize()
            assert fc.LAUNCHES["matmul_bwd"] > before["matmul_bwd"]
            key = "matmul" if case[0] == "matmul" else "chain_n"
            assert fc.LAUNCHES[key] == before[key] + 1
        results.append([out.detach().cpu()] + [t.grad.cpu() for t in ins])
    rel = 1e-5 if dtype == torch.float32 else 2e-2
    for i, (got, want) in enumerate(zip(results[1], results[0])):
        assert got.dtype == want.dtype, i
        assert _max_err(got, want) <= rel * float(want.float().abs().max()), i


@pytest.mark.cuda
def test_cuda_measure_reads_the_allocator(cuda_device):
    """On a card the probe always measures: the peak of the call net of
    what was allocated before it, named by the card."""
    from repro_torch import memory
    from repro_torch.configs import base

    keep = torch.empty(1 << 20, dtype=torch.uint8, device=cuda_device)
    got = memory.measure(lambda: torch.empty(8 << 20, dtype=torch.uint8,
                                             device=cuda_device),
                         device=cuda_device)
    assert got is not None and got.measured
    assert got.source == "measured:" + torch.cuda.get_device_name(
        cuda_device)
    assert 8 << 20 <= got.peak_bytes < 9 << 20
    assert got.detail["resident_before"] >= keep.numel()
    # without a step to run, the probe is the planner's model
    modeled = memory.probe_training(base.get("paper_atis_tt").smoke(), 2,
                                    16, device=cuda_device)
    assert not modeled.measured


# ---------------------------------------------------------------------------
# The expert-batched GEMM and chain (3-D operands, one launch for every
# expert): each entry against its plain version, the launches counted
# under their own keys.
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("e,m,n,k", [
    (64, 192, 1024, 64),      # an olmoe FP product, one split
    (64, 64, 192, 2048),      # split-K (16 slices an expert)
    (64, 32, 64, 4096),       # split-K (32 slices), the decode batch
    (3, 100, 20, 36),         # ragged tiles, an unaligned K
])
def test_cuda_batched_gemm_matches_plain_version(cuda_device, dtype, trans,
                                                 e, m, n, k):
    gen = torch.Generator(device=cuda_device).manual_seed(e + m + n + k)
    x = torch.randn(e, m, k, generator=gen, device=cuda_device).to(dtype)
    w = torch.randn(e, *((n, k) if trans else (k, n)), generator=gen,
                    device=cuda_device).to(dtype)
    before = dict(fc.LAUNCHES)
    got = fc.matmul_cuda(x, w, transpose_rhs=trans)
    want = ref.matmul(x, w, transpose_rhs=trans)
    assert tuple(got.shape) == (e, m, n) and got.dtype == dtype
    for i in range(e):           # each expert at its own scale
        scale = want[i].float().abs().max().item()
        tol = 1e-5 * scale if dtype == torch.float32 else 2e-2 * scale
        assert _max_err(got[i], want[i]) <= tol, i
    cfg = fc.gemm_config_for(x, w, trans)
    assert fc.LAUNCHES["matmul_batched"] == before["matmul_batched"] + 1
    assert fc.LAUNCHES["matmul_batched_reduce"] == (
        before["matmul_batched_reduce"] + (cfg.splits > 1))
    assert fc.LAUNCHES["matmul"] == before["matmul"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,m0,links", [
    (64, 6144, ((32, 8), (256, 8))),      # olmoe's rank-8 FP chain
    (64, 2048, ((1024, 8), (256, 8))),    # its WG chain
    (5, 96, ((12, 8), (16, 4), (8, 6))),  # three links, an unaligned K
])
def test_cuda_batched_chain_matches_plain_version(cuda_device, dtype, e, m0,
                                                  links):
    gen = torch.Generator(device=cuda_device).manual_seed(m0)
    x = torch.randn(e, m0, links[0][0], generator=gen,
                    device=cuda_device).to(dtype)
    ws = [torch.randn(e, *s, generator=gen, device=cuda_device).to(dtype)
          for s in links]
    before = dict(fc.LAUNCHES)
    got = fc.chain_n_cuda(x, ws)
    want = ref.chain_n(x, ws)
    assert got.shape == want.shape
    for i in range(e):
        scale = want[i].float().abs().max().item()
        tol = 1e-5 * scale if dtype == torch.float32 else 2 * _bf16_ulp(
            scale)
        assert _max_err(got[i], want[i]) <= tol, i
    assert fc.LAUNCHES["chain_n_batched"] == before["chain_n_batched"] + 1
    assert fc.LAUNCHES["chain_n"] == before["chain_n"]


@pytest.mark.cuda
def test_cuda_batched_plan_equals_a_loop_over_experts(cuda_device):
    """A TT layer's FP plan with a leading expert axis (the batched
    kernels) against the same plan run expert by expert (the 2-D ones)."""
    import dataclasses

    from repro_torch.core import tensorized
    tnn = tensorized.TNNConfig(enabled=True, rank=8, num_factors=2,
                               backend="cuda")
    layer = tensorized.make_tensorized_linear(
        1024, 2048, dataclasses.replace(tnn), compute_dtype=torch.float32,
        device=cuda_device, num_experts=4)
    x = torch.randn(4, 192, 2048, device=cuda_device)
    with torch.no_grad():
        got = layer(x)
        plan = tensorized.fp_plan(layer.fact, 192, layer.opts).plan
        want = torch.stack([
            contraction.execute(
                plan, [x[e].reshape((192,) + tuple(layer.fact.in_dims)),
                       *(c[e] for c in layer.cores)], backend="cuda")
            .reshape(192, 1024) for e in range(4)])
    scale = want.abs().max().item()
    assert _max_err(got, want) <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,tq,tk,qc,kc", [
    (8, 128, 128, 128, 128),     # seamless encoder training, non-causal
    (4, 1024, 1024, 512, 1024),  # encoder serving: two q chunks, 1024 keys
    (4, 16, 1024, 16, 1024),     # cross-attention prefill
    (4, 1, 1024, 1, 1024),       # cross-attention decode: one query
    (2, 48, 160, 48, 32),        # Tq != Tk over five kv chunks
])
def test_cuda_flash_noncausal_across_sequences(cuda_device, dtype, B, tq, tk,
                                               qc, kc):
    """The attention kernel non-causal with q from one sequence and k/v
    from another (seamless's encoder and cross-attention shapes, H = KV =
    16, D 64), against its plain version: ``out`` within 1e-5 of the
    scale in f32 and one bf16 ulp in bf16, ``lse`` within 1e-5."""
    gen = torch.Generator(device=cuda_device).manual_seed(tq + tk)
    H = KV = 16
    D = 64
    q = torch.randn((B, tq, H, D), generator=gen, device=cuda_device)
    k, v = (torch.randn((B, tk, KV, D), generator=gen, device=cuda_device)
            for _ in "kv")
    q, k, v = (t.to(dtype) for t in (q, k, v))
    kw = dict(causal=False, q_chunk=qc, kv_chunk=kc)
    before = fc.LAUNCHES["flash_attention_fwd"]
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    want, want_lse = ref.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fc.LAUNCHES["flash_attention_fwd"] == before + 1
    assert out.shape == q.shape and lse.shape == (B, tq, KV, H // KV)
    scale = float(want.float().abs().max())
    tol = 1e-5 * scale if dtype == torch.float32 else _bf16_ulp(scale)
    assert _max_err(out, want) <= tol
    torch.testing.assert_close(lse, want_lse, rtol=0,
                               atol=1e-5 * float(want_lse.abs().max()))


@pytest.mark.cuda
def test_cuda_seamless_step_and_decode_match_the_cpu(cuda_device):
    """One f32 training step of the seamless smoke model through the
    kernels on the card and their plain versions on the CPU (loss 1e-5,
    every gradient 1e-4 of its scale), then prefill and a decode step
    (logits 1e-5 of their scale); on the card the attention kernel runs
    every attention of the step and the prefill, and each decode step's
    cross-attentions."""
    from repro_torch.configs import base
    from repro_torch.launch import steps
    from repro_torch.models import modality

    arch = base.get("seamless_m4t_medium")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (2, 17)).astype(np.int64)
    out = []
    for device in ("cpu", cuda_device):
        model, cfg = steps.build_model(arch, arch.tnn_default, smoke=True,
                                       device=device, backend="cuda",
                                       compute_dtype=torch.float32)
        enc = modality.frame_embeddings(torch.Generator().manual_seed(1), 2,
                                        32, cfg.d_model, torch.float32,
                                        device)
        batch = {"enc_embeds": enc, "dec_inputs": torch.from_numpy(toks[:, :-1]),
                 "dec_targets": torch.from_numpy(toks[:, 1:])}
        before = fc.LAUNCHES["flash_attention_fwd"]
        loss, _ = model.loss(batch)
        loss.backward()
        prefill = steps.make_prefill_step(model, 24)
        decode = steps.make_decode_step(model)
        lp, cache = prefill(enc, toks[:, :8])
        mid = fc.LAUNCHES["flash_attention_fwd"]
        ld, cache = decode(toks[:, 8], cache)
        if device != "cpu":
            layers = cfg.num_enc_layers + 2 * cfg.num_dec_layers
            assert mid - before == 2 * layers      # training + prefill
            assert fc.LAUNCHES["flash_attention_fwd"] - mid == (
                cfg.num_dec_layers)                # the cross-attentions
        out.append((float(loss.detach()),
                    {n: p.grad.cpu() for n, p in model.named_parameters()},
                    lp.cpu(), ld.cpu()))
    (l0, g0, p0, d0), (l1, g1, p1, d1) = out
    assert l1 == pytest.approx(l0, rel=1e-5)
    for name, g in g0.items():
        torch.testing.assert_close(g1[name], g, rtol=0,
                                   atol=1e-4 * float(g.abs().max()))
    for got, want in ((p1, p0), (d1, d0)):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))
