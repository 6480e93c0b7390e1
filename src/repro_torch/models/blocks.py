"""Transformer building blocks as PyTorch modules.

Port of ``src/repro/models/blocks.py``: :func:`make_dense` (a dense
matrix, or a :class:`~repro_torch.core.tensorized.TensorizedLinear` when a
TNN config targets the projection), :func:`rmsnorm`,
:func:`groupnorm_heads` (RWKV-6's per-head output norm), :func:`rope`,
:class:`KVCache`, the GQA :class:`Attention` with its full-sequence
training forward and its serving paths (``prefill``, which
``LM.prefill`` runs for the attention layers and the hybrid's shared
block, ``extend`` — chunked prefill at per-slot depths — and
``decode_step``), :func:`blockwise_attention` with the flash
backward, :class:`SwiGLU`, and the top-k routed :class:`MoE` (router,
capacity-dropped dispatch per token group, the experts' SwiGLU as
stacked dense matrices or as expert-stacked TT cores, the combine as a
scatter-add).

Parameter names and layouts are the reference's (``Dense.w`` is
``[d_in, d_out]``, TT cores keep their shapes), so
:func:`repro_torch.convert.params_from_numpy` maps the reference's
parameter tree one to one.  The full-sequence attention forward runs the
flash-attention kernel (:mod:`repro_torch.kernels.flash_attention`) on a
CUDA tensor and its plain version on the CPU, as the reference runs its
Pallas kernel on a TPU and the jnp twin elsewhere; the flash backward is
torch ops, as the reference's is plain jnp.  The serving paths' attention
is the reference's plain-array code (f32 scores, softmax, f32 context).

GQA takes any ``H`` that is a multiple of ``KV`` (``qwen2_7b``'s 28 / 4);
a QKV bias (``qkv_bias``) is the q/k/v projections' own bias, as in the
reference.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn
from torch.profiler import record_function

from repro_torch.core.tensorized import TNNConfig, make_tensorized_linear
from repro_torch.kernels import flash_attention as fa


class Dense(nn.Module):
    """A dense projection ``y = x @ w (+ b)``, ``w[d_in, d_out]``."""

    def __init__(self, d_in: int, d_out: int, *, use_bias: bool = False,
                 param_dtype=torch.float32, compute_dtype=torch.bfloat16,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.use_bias = use_bias
        self.compute_dtype = compute_dtype
        std = 1.0 / math.sqrt(d_in)
        self.w = nn.Parameter(
            (torch.randn(d_in, d_out, generator=generator) * std).to(
                device=device, dtype=param_dtype))
        if use_bias:
            self.b = nn.Parameter(torch.zeros(d_out, dtype=param_dtype,
                                              device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        # Products of compute-dtype operands, summed in f32.
        y = torch.matmul(x.to(cd).float(), self.w.to(cd).float())
        if self.use_bias:
            y = y + self.b.float()
        return y.to(x.dtype)


def make_dense(d_in: int, d_out: int, *, use_bias: bool = False,
               tnn: TNNConfig | None = None, param_dtype=torch.float32,
               compute_dtype=torch.bfloat16, device=None,
               generator: torch.Generator | None = None) -> nn.Module:
    """The reference's ``Dense``: a :class:`TensorizedLinear` when ``tnn``
    is enabled (parameters ``cores`` / ``bias``), else a :class:`Dense`
    (``w`` / ``b``) — the reference's parameter names either way."""
    if tnn is not None and tnn.enabled:
        return make_tensorized_linear(
            d_out, d_in, tnn, use_bias=use_bias, param_dtype=param_dtype,
            compute_dtype=compute_dtype, device=device, generator=generator)
    return Dense(d_in, d_out, use_bias=use_bias, param_dtype=param_dtype,
                 compute_dtype=compute_dtype, device=device,
                 generator=generator)


class RMSNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device))

    def forward(self, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        return rmsnorm(self.scale, x, eps)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def groupnorm_heads(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
                    ) -> torch.Tensor:
    """Per-head normalisation of the RWKV-6 output (``x [..., H, D]``,
    ``scale [H, D]``): mean and biased variance over D, in f32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps) * scale).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0
         ) -> torch.Tensor:
    """Rotary embedding.  x: [B, T, H, D], positions: [B, T]."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[..., None].float() * freqs        # [B, T, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class KVCache(NamedTuple):
    k: torch.Tensor          # [B, max_len, KV, D] on the model's device
    v: torch.Tensor          # [B, max_len, KV, D]
    length: torch.Tensor     # [B] (or [] scalar) int32 depths, on the CPU:
                             # the host owns the slot table, so bounds
                             # checks never wait for the device


def _positions(length: torch.Tensor, batch: int, chunk: int,
               cache_len: int) -> torch.Tensor:
    """Host ``[B, chunk]`` write/query positions of a chunk appended at
    each slot's depth.

    The reference's ``dynamic_update_slice`` clamps a start index that
    would run past the buffer, moving the write onto live entries; here
    such a write is refused instead (the serving engine sizes its buffer
    with a chunk of slack so it never happens)."""
    length = length.cpu().long()
    if length.dim() == 0:
        length = length.expand(batch)
    pos = length[:, None] + torch.arange(chunk)[None, :]
    if batch and int(pos.max()) >= cache_len:
        raise ValueError(f"KV write up to position {int(pos.max())} past "
                         f"the cache length {cache_len}")
    return pos


def _write_slots(buf: torch.Tensor, new: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """``buf`` with ``new[b, c]`` written at ``buf[b, positions[b, c]]``
    (positions already bounds-checked by :func:`_positions`)."""
    out = buf.clone()
    rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
    out[rows, positions] = new.to(buf.dtype)
    return out


class Attention(nn.Module):
    """GQA attention; q/k/v/o come from :func:`make_dense` (tensorized
    when the TNN config targets ``qkv`` / ``out``).  ``causal=False``
    (an encoder's self-attention) lets every position see every key in
    the full-sequence paths (``forward``, ``prefill``)."""

    def __init__(self, d_model: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, *, qkv_bias: bool = False,
                 causal: bool = True, rope_theta: float = 10000.0,
                 q_chunk: int = 512, kv_chunk: int = 1024,
                 tnn: TNNConfig | None = None,
                 param_dtype=torch.float32, compute_dtype=torch.bfloat16,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.num_heads, self.num_kv_heads = num_heads, num_kv_heads
        self.head_dim = head_dim
        self.causal = causal
        self.rope_theta = rope_theta
        self.q_chunk, self.kv_chunk = q_chunk, kv_chunk
        H, KV, D = num_heads, num_kv_heads, head_dim

        def proj(d_in, d_out, bias, target):
            t = tnn if (tnn and target in tnn.targets) else None
            return make_dense(d_in, d_out, use_bias=bias, tnn=t,
                              param_dtype=param_dtype,
                              compute_dtype=compute_dtype, device=device,
                              generator=generator)

        self.q = proj(d_model, H * D, qkv_bias, "qkv")
        self.k = proj(d_model, KV * D, qkv_bias, "qkv")
        self.v = proj(d_model, KV * D, qkv_bias, "qkv")
        self.o = proj(H * D, d_model, False, "out")

    def _qkv(self, x, positions):
        B, T, _ = x.shape
        H, KV, D = self.num_heads, self.num_kv_heads, self.head_dim
        q = self.q(x).reshape(B, T, H, D)
        k = self.k(x).reshape(B, T, KV, D)
        v = self.v(x).reshape(B, T, KV, D)
        return (rope(q, positions, self.rope_theta),
                rope(k, positions, self.rope_theta), v)

    def forward(self, x: torch.Tensor, positions: torch.Tensor
                ) -> torch.Tensor:
        """Full-sequence attention (training).  x: [B, T, d_model],
        positions: [B, T]."""
        B, T, _ = x.shape
        q, k, v = self._qkv(x, positions)
        ctx = blockwise_attention(q, k, v, causal=self.causal,
                                  q_chunk=self.q_chunk,
                                  kv_chunk=self.kv_chunk)
        return self.o(ctx.reshape(B, T, self.num_heads * self.head_dim))

    def prefill(self, x: torch.Tensor, positions: torch.Tensor,
                max_len: int) -> tuple[torch.Tensor, KVCache]:
        """Full attention over the prompt (the flash path, as
        :meth:`forward`) and the K/V cache it leaves: k/v zero-padded to
        ``max_len`` positions, length ``T`` (a host scalar)."""
        B, T, _ = x.shape
        q, k, v = self._qkv(x, positions)
        ctx = blockwise_attention(q, k, v, causal=self.causal,
                                  q_chunk=self.q_chunk,
                                  kv_chunk=self.kv_chunk)
        pad = (0, 0, 0, 0, 0, max_len - T)
        cache = KVCache(torch.nn.functional.pad(k, pad),
                        torch.nn.functional.pad(v, pad),
                        torch.tensor(T, dtype=torch.int32))
        return self.o(ctx.reshape(B, T, self.num_heads * self.head_dim)), cache

    def _attend(self, q, kc, vc, positions, dtype):
        """Scores of ``q [B, C, H, D]`` against the whole cache, masked to
        ``t <= position``; f32 softmax and context, as the reference."""
        B, C, H, D = q.shape
        KV = self.num_kv_heads
        qg = q.reshape(B, C, KV, H // KV, D)
        scores = torch.einsum("bckgd,btkd->bkgct", qg.float(),
                              kc.float()) / math.sqrt(D)
        t_idx = torch.arange(kc.shape[1], device=kc.device)
        mask = (t_idx[None, None, None, None, :]
                <= positions[:, None, None, :, None])
        scores = torch.where(mask, scores, torch.full((), -1e30,
                                                      device=kc.device))
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bkgct,btkd->bckgd", probs, vc.float()).to(dtype)
        return self.o(ctx.reshape(B, C, H * D))

    def decode_step(self, x: torch.Tensor, cache: KVCache):
        """One-token decode at each slot's depth.  x: [B, 1, d_model]."""
        return self.extend(x, cache)

    def extend(self, x: torch.Tensor, cache: KVCache,
               valid: torch.Tensor | None = None):
        """Append a C-token chunk per slot at each slot's depth (chunked
        prefill; ``C = 1`` is a decode step).  ``valid`` ([B] host ints,
        None = all C) bounds the real tokens per slot; k/v past it are
        written as zeros (they sit past the advanced length, so no mask
        ever exposes them)."""
        B, C, _ = x.shape
        pos_host = _positions(cache.length, B, C, cache.k.shape[1])
        positions = pos_host.to(x.device)
        q, k, v = self._qkv(x, positions)
        if valid is not None:
            keep = (torch.arange(C)[None, :] < valid.cpu()[:, None])
            keep = keep.to(x.device)[..., None, None]
            k = torch.where(keep, k, torch.zeros((), dtype=k.dtype,
                                                 device=k.device))
            v = torch.where(keep, v, torch.zeros((), dtype=v.dtype,
                                                 device=v.device))
        kc = _write_slots(cache.k, k, positions)
        vc = _write_slots(cache.v, v, positions)
        adv = C if valid is None else valid.cpu().to(cache.length.dtype)
        out = self._attend(q, kc, vc, positions, x.dtype)
        return out, KVCache(kc, vc, cache.length + adv)


# ---------------------------------------------------------------------------
# Blockwise (flash) attention
# ---------------------------------------------------------------------------


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, q_chunk: int, kv_chunk: int,
                        softmax_scale: float | None = None) -> torch.Tensor:
    """Memory-efficient attention with an online softmax.

    GQA: q ``[B, Tq, H, D]``, k/v ``[B, Tk, KV, D]`` with ``H = KV * G``.
    Runs through :class:`_FlashAttention`, whose backward recomputes
    per-chunk probabilities from the saved ``(q, k, v, out, lse)``."""
    scale = softmax_scale or 1.0 / math.sqrt(q.shape[-1])
    qc, kc = min(q_chunk, q.shape[1]), min(kv_chunk, k.shape[1])
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal, qc, kc, scale)


class _FlashAttention(torch.autograd.Function):
    """The reference's ``_flash_attention`` custom VJP.  The forward runs
    the flash kernel on a CUDA tensor and the plain version on the CPU
    (:func:`repro_torch.kernels.flash_attention.flash_attention_fwd`);
    the backward is :func:`_flash_bwd`.  Both run inside
    ``torch.profiler`` ranges (``attn.fwd``, ``attn.bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_chunk, kv_chunk, scale):
        with record_function("attn.fwd"):
            out, lse = fa.flash_attention_fwd(
                q, k, v, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk,
                softmax_scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.static = (causal, q_chunk, kv_chunk, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        with record_function("attn.bwd"):
            dq, dk, dv = _flash_bwd(*ctx.static, ctx.saved_tensors, do)
        return dq, dk, dv, None, None, None, None


def _flash_bwd(causal, q_chunk, kv_chunk, scale, res, do):
    """Flash backward: for each (kv, q) chunk pair, recompute
    ``p = exp(q k^T scale - lse)`` from the saved stats, then

        dv_j += p^T do_i
        ds    = p * (do_i v_j^T - delta_i) * scale
        dq_i += ds k_j ;  dk_j += ds^T q_i

    with the reference's rounding points: ``p`` cast to v's dtype and
    ``ds`` to q's before their products, f32 accumulators, and dq/dk/dv
    cast to their operands' dtypes at the end."""
    q, k, v, out, lse = res
    B, Tq, H, D = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    G = H // KV
    nq, nk = Tq // q_chunk, Tk // kv_chunk
    f32 = torch.float32
    dev = q.device

    # delta_i = rowsum(do * out)  [B, Tq, KV, G]
    delta = (do.float() * out.float()).sum(dim=-1).reshape(B, Tq, KV, G)
    q_pos = torch.arange(Tq, device=dev)
    k_pos = torch.arange(Tk, device=dev)
    dq = torch.zeros((B, Tq, KV, G, D), dtype=f32, device=dev)
    dks, dvs = [], []
    for j in range(nk):
        ks = slice(j * kv_chunk, (j + 1) * kv_chunk)
        k_blk, v_blk = k[:, ks].float(), v[:, ks].float()
        dk_j = torch.zeros((B, kv_chunk, KV, D), dtype=f32, device=dev)
        dv_j = torch.zeros((B, kv_chunk, KV, D), dtype=f32, device=dev)
        for i in range(nq):
            qs = slice(i * q_chunk, (i + 1) * q_chunk)
            q_raw = q[:, qs].reshape(B, q_chunk, KV, G, D)
            q_blk = q_raw.float()
            do_blk = do[:, qs].reshape(B, q_chunk, KV, G, D).float()
            lse_blk = lse[:, qs].permute(0, 2, 3, 1)[..., None]
            dl_blk = delta[:, qs].permute(0, 2, 3, 1)[..., None]
            s = torch.einsum("bqkgd,btkd->bkgqt", q_blk, k_blk) * scale
            if causal:
                mask = q_pos[qs][:, None] >= k_pos[ks][None, :]
                s = torch.where(mask, s, torch.full((), -torch.inf,
                                                    device=dev))
            p = torch.exp(s - lse_blk)
            dov = torch.einsum("bqkgd,btkd->bkgqt", do_blk, v_blk)
            ds = p * (dov - dl_blk) * scale
            pb = p.to(v.dtype).float()
            dsb = ds.to(q.dtype).float()
            dv_j = dv_j + torch.einsum("bkgqt,bqkgd->btkd", pb, do_blk)
            dk_j = dk_j + torch.einsum("bkgqt,bqkgd->btkd", dsb, q_blk)
            dq[:, qs] += torch.einsum("bkgqt,btkd->bqkgd", dsb, k_blk)
        dks.append(dk_j)
        dvs.append(dv_j)
    return (dq.reshape(B, Tq, H, D).to(q.dtype),
            torch.cat(dks, dim=1).to(k.dtype),
            torch.cat(dvs, dim=1).to(v.dtype))


class SwiGLU(nn.Module):
    def __init__(self, d_model: int, d_ff: int, *,
                 tnn: TNNConfig | None = None, param_dtype=torch.float32,
                 compute_dtype=torch.bfloat16, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        t = tnn if (tnn and "mlp" in tnn.targets) else None
        kw = dict(tnn=t, param_dtype=param_dtype, compute_dtype=compute_dtype,
                  device=device, generator=generator)
        self.gate = make_dense(d_model, d_ff, **kw)
        self.up = make_dense(d_model, d_ff, **kw)
        self.down = make_dense(d_ff, d_model, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.gate(x)
        u = self.up(x)
        h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
        return self.down(h)


# ---------------------------------------------------------------------------
# Mixture of Experts (top-k, capacity-dropped, gather/scatter dispatch)
# ---------------------------------------------------------------------------


class StackedDense(nn.Module):
    """E experts' dense matrices ``w[E, d_in, d_out]``."""

    def __init__(self, num_experts: int, d_in: int, d_out: int, std: float,
                 *, param_dtype=torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.w = nn.Parameter(
            (torch.randn(num_experts, d_in, d_out, generator=generator)
             * std).to(device=device, dtype=param_dtype))


def moe_capacity(tokens_per_group: int, top_k: int, num_experts: int,
                 capacity_factor: float) -> int:
    """Slots an expert has in one token group: ``ceil(Ts * K * cf / E)``,
    at least 8 and rounded up to a multiple of 8 (the reference's
    ``MoE._capacity``)."""
    c = math.ceil(tokens_per_group * top_k * capacity_factor / num_experts)
    return max(8, -(-c // 8) * 8)


def moe_route(eidx: torch.Tensor, gates: torch.Tensor, num_experts: int,
              capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Slot tables of each group: ``slot_tok[G, E, C]`` (the token in the
    slot) and ``slot_gate[G, E, C]`` (its f32 gate) from the top-k picks
    ``eidx`` / ``gates`` ``[G, Ts, K]``.

    A pick's slot is its rank among the picks of its expert in the
    group's flat ``[Ts * K]`` order (token-major, then k in descending
    probability): the reference's cumsum over the one-hot picks.  Picks
    ranked ``>= C`` are dropped; an empty slot holds token 0 with gate 0.
    """
    G, Ts, K = eidx.shape
    flat_e = eidx.reshape(G, Ts * K)
    flat_g = gates.reshape(G, Ts * K).float()
    onehot = torch.nn.functional.one_hot(flat_e, num_experts)
    pos = (torch.cumsum(onehot, dim=1) - 1).gather(2, flat_e[..., None])[
        ..., 0]                                           # [G, Ts*K]
    keep = pos < capacity
    grp = torch.arange(G, device=eidx.device)[:, None].expand(G, Ts * K)
    tok = (torch.arange(Ts * K, device=eidx.device) // K).expand(G, Ts * K)
    slot_tok = torch.zeros((G, num_experts, capacity), dtype=torch.long,
                           device=eidx.device)
    slot_gate = torch.zeros((G, num_experts, capacity), dtype=torch.float32,
                            device=eidx.device)
    where = (grp[keep], flat_e[keep], pos[keep])
    slot_tok[where] = tok[keep]
    slot_gate[where] = flat_g[keep]
    return slot_tok, slot_gate


def moe_combine(ye: torch.Tensor, slot_tok: torch.Tensor,
                slot_gate: torch.Tensor, tokens_per_group: int
                ) -> torch.Tensor:
    """``y[G, Ts, D]``: every slot's expert output ``ye[G, E, C, D]``
    times its gate, summed into its token (a scatter-add in ye's dtype;
    on the CPU in slot order: expert-major, then slot).  On the card the
    sum is ``index_put_``'s accumulate, which sorts the indices first and
    so adds a token's slots in one order every run; ``index_add_`` there
    adds them with atomics, in whatever order they land."""
    G, E, C, D = ye.shape
    weighted = ye * slot_gate[..., None].to(ye.dtype)
    base = torch.arange(G, device=ye.device)[:, None, None] * tokens_per_group
    idx = (slot_tok + base).reshape(-1)
    y = torch.zeros((G * tokens_per_group, D), dtype=ye.dtype,
                    device=ye.device)
    src = weighted.reshape(-1, D)
    y = (y.index_put((idx,), src, accumulate=True) if y.is_cuda
         else y.index_add(0, idx, src))
    return y.reshape(G, tokens_per_group, D)


class MoE(nn.Module):
    """Top-k routed expert SwiGLU FFN (the reference's ``MoE``).

    ``forward(x [G, Ts, D]) -> (y, aux)`` per token group (the LM's groups
    are batch rows): the f32 router and softmax, top-k with the gates
    renormalised to sum to one, the Switch load-balance loss
    (``lb_loss``) and the router z-loss (``z_loss``) in ``aux``, the
    capacity-dropped dispatch of :func:`moe_route` (a gather), the
    experts, and the combine of :func:`moe_combine`.  Each part runs in
    a ``torch.profiler`` range: ``moe.route``, ``moe.experts``,
    ``moe.combine``.

    Experts: with a TNN config targeting ``"mlp"``, ``gate``/``up``/
    ``down`` are expert-stacked :class:`TensorizedLinear` layers (cores
    ``[E, ...]``, one factorization), fed ``[E, G, C, D]``: unquantized,
    the groups fold into the tokens an expert holds; quantized, each
    (expert, group) instance keeps its own scales, as the reference's
    vmap over the groups does; either way each plan op launches one
    batched kernel for all of them.  Otherwise they are stacked dense
    matrices ``w[E, d_in, d_out]``, products of compute-dtype operands
    summed in f32 (the reference's ``einsum_f32``).
    """

    def __init__(self, d_model: int, d_ff: int, num_experts: int,
                 top_k: int, capacity_factor: float = 1.25, *,
                 tnn: TNNConfig | None = None, param_dtype=torch.float32,
                 compute_dtype=torch.bfloat16, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        E, D, F = num_experts, d_model, d_ff
        self.num_experts, self.top_k = E, top_k
        self.capacity_factor = capacity_factor
        self.compute_dtype = compute_dtype
        self.router = Dense(D, E, param_dtype=torch.float32,
                            compute_dtype=torch.float32, device=device,
                            generator=generator)
        self.tnn_on = tnn is not None and tnn.enabled and "mlp" in tnn.targets
        if self.tnn_on:
            def proj(d_in, d_out):
                return make_tensorized_linear(
                    d_out, d_in, tnn, param_dtype=param_dtype,
                    compute_dtype=compute_dtype, device=device,
                    generator=generator, num_experts=E)
        else:
            def proj(d_in, d_out):
                return StackedDense(E, d_in, d_out, 1.0 / math.sqrt(d_in),
                                    param_dtype=param_dtype, device=device,
                                    generator=generator)
        self.experts = nn.ModuleDict({"gate": proj(D, F), "up": proj(D, F),
                                      "down": proj(F, D)})

    def capacity(self, tokens_per_group: int) -> int:
        return moe_capacity(tokens_per_group, self.top_k, self.num_experts,
                            self.capacity_factor)

    def route(self, x: torch.Tensor):
        """Router, top-k and aux losses of ``x [G, Ts, D]``: returns
        ``(slot_tok, slot_gate, aux)``."""
        E, K = self.num_experts, self.top_k
        logits = self.router(x.float())                      # [G, Ts, E]
        probs = torch.softmax(logits, dim=-1)
        gates, eidx = torch.topk(probs, K, dim=-1, sorted=True)
        gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
        me = probs.mean(dim=(0, 1))
        ce = (torch.nn.functional.one_hot(eidx, E).sum(2) > 0).float().mean(
            dim=(0, 1))
        aux = {"lb_loss": E * torch.sum(me * ce),
               "z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2)}
        slot_tok, slot_gate = moe_route(eidx, gates, E,
                                        self.capacity(x.shape[1]))
        return slot_tok, slot_gate, aux

    def expert_ffn(self, xe: torch.Tensor) -> torch.Tensor:
        """The experts' SwiGLU on the dispatched ``xe [G, E, C, D]``."""
        cd = self.compute_dtype
        ex = self.experts
        if self.tnn_on:
            xf = xe.to(cd).transpose(0, 1)                   # [E, G, C, D]
            g = ex["gate"](xf)
            u = ex["up"](xf)
            h = torch.nn.functional.silu(g.float()).to(cd) * u.to(cd)
            return ex["down"](h).transpose(0, 1)

        def mm(spec, a, w):
            return torch.einsum(spec, a.to(cd).float(), w.to(cd).float())

        g = mm("gecd,edf->gecf", xe, ex["gate"].w)
        u = mm("gecd,edf->gecf", xe, ex["up"].w)
        h = (torch.nn.functional.silu(g) * u).to(cd)
        return mm("gecf,efd->gecd", h, ex["down"].w)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
        G, Ts, D = x.shape
        with record_function("moe.route"):
            slot_tok, slot_gate, aux = self.route(x)
            grp = torch.arange(G, device=x.device)[:, None, None]
            xe = x[grp, slot_tok]                            # [G, E, C, D]
        with record_function("moe.experts"):
            ye = self.expert_ffn(xe).to(x.dtype)
        with record_function("moe.combine"):
            y = moe_combine(ye, slot_tok, slot_gate, Ts)
        return y, aux
