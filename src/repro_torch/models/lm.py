"""Decoder-only language model: the dense-attention, MoE, RWKV-6, Mamba-2
and hybrid (Mamba-2 with a shared attention block) families.

Port of ``src/repro/models/lm.py``: :class:`MoESpec`, :class:`HybridSpec`,
:class:`LMConfig`, and :class:`LM` with the training forward (``forward``
— the reference's ``__call__`` — over :meth:`LM.apply_layers`, and the
masked next-token loss ``token_loss`` / ``loss``) and the serving entry
points ``init_cache``, ``extend`` (chunked prefill at per-slot depths,
attention only), ``prefill`` and ``decode_step``.  Each takes token ids
or, for an embeddings-input architecture (``llava_next_34b``), the
modality stub's floating ``[B, T, D]`` embeddings (``[B, D]`` a decode
step), which bypass the table (:meth:`LM._embed`).
Every projection consults ``cfg.tnn``
(:func:`repro_torch.models.blocks.make_dense`), which is how the paper's
technique, and with ``backend="cuda"`` the CUDA kernels, enter the model.

``block="rwkv6"`` stacks RWKV-6 layers (:mod:`repro_torch.models.ssm`):
their full-sequence time mix runs the scan kernel (B8), and ``prefill``
hands the kernel's final states to ``decode_step``'s single-step
recurrence through a :class:`StateCache`.  ``block="mamba2"`` stacks
Mamba-2 layers (``ln``, ``mamba``), whose SSD also runs B8; with a
:class:`HybridSpec` (``zamba2_7b``) one shared block (``shared.ln1``,
``shared.attn``, ``shared.ln2``, ``shared.mlp``, the same weights every
time) follows every ``shared_every`` layers, and the decode state is a
:class:`MambaCache`: the stacked per-layer :class:`~repro_torch.models.ssm.MambaState`
and one K/V cache per shared-block application.

``remat`` re-runs each layer's forward inside the backward
(``torch.utils.checkpoint`` per layer, non-reentrant), the reference's
per-layer ``jax.checkpoint`` with ``nothing_saveable``; as there, the
hybrid's shared block is not checkpointed.  The reference's
``scan_layers`` and ``remat_group`` choose how XLA lowers the layer stack;
an eager loop over per-layer modules has nothing to choose, so they are
left out.

With a :class:`MoESpec` each attention layer's MLP is a
:class:`~repro_torch.models.blocks.MoE` whose token groups are the batch
rows (in training, ``prefill``, ``extend`` and ``decode_step`` alike);
its per-layer ``lb_loss`` / ``z_loss``, meaned over the layers, reach
:meth:`LM.loss` through ``forward(..., aux=...)``, which adds
``0.01 * lb + 1e-3 * z`` and reports both.

Parameter names follow the reference's tree with the stacked ``[L, ...]``
layer leaves split per layer (``layers.<l>.attn.q.cores.<i>``,
``layers.<l>.rwkv.mix.r``, ``layers.<l>.mamba.in.cores.<i>``,
``layers.<l>.mlp.router.w``, ``layers.<l>.mlp.experts.gate.cores.<i>``
of shape ``[E, ...]``) and the shared block unstacked
(``shared.attn.o.cores.<i>``), so
:func:`repro_torch.convert.params_from_numpy` loads reference parameters.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.tensorized import TNNConfig
from repro_torch.models import ssm
from repro_torch.models.blocks import (
    Attention, Dense, KVCache, MoE, RMSNorm, SwiGLU,
)


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class HybridSpec:
    """Zamba2-style: one shared attention block applied after every
    ``shared_every`` backbone layers (the same weights each time)."""
    shared_every: int = 27
    d_ff_shared: int | None = None


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None            # default d_model // num_heads
    block: str = "attn"                    # attn | rwkv6 | mamba2
    moe: MoESpec | None = None
    hybrid: HybridSpec | None = None
    ssm_state: int = 64
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    tnn: TNNConfig = TNNConfig()
    q_chunk: int = 512                     # blockwise attention tile sizes
    kv_chunk: int = 1024
    remat: bool = True                     # per-layer activation remat
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def validate(self):
        if self.block not in ("attn", "rwkv6", "mamba2"):
            raise ValueError(f"unknown block {self.block!r}")
        if self.moe and self.block != "attn":
            raise ValueError("MoE layers have an attention block")
        if self.hybrid:
            if self.block != "mamba2":
                raise ValueError("a hybrid stack has a mamba2 backbone")
            if self.num_layers % self.hybrid.shared_every:
                raise ValueError(
                    f"{self.num_layers} layers not divisible by "
                    f"shared_every={self.hybrid.shared_every}")


class DecodeCache(NamedTuple):
    """Per-model decode state: stacked per-layer K/V + per-slot depths."""
    k: torch.Tensor       # [L, B, T, KV, hd] on the model's device
    v: torch.Tensor       # [L, B, T, KV, hd]
    length: torch.Tensor  # [B] (or [] scalar) int32, on the CPU


class StateCache(NamedTuple):
    """RWKV-6 decode state: per-layer states stacked ``[L, ...]``."""
    layers: ssm.RWKVState  # wkv [L, B, H, hd, hd] f32, shifts [L, B, D]
    length: torch.Tensor   # [] int32 tokens seen, on the CPU


class MambaCache(NamedTuple):
    """Mamba-2 decode state (the reference's ``DecodeCache`` for the
    block): per-layer states stacked ``[L, ...]`` and, for the hybrid,
    the shared block's K/V stacked per application."""
    layers: ssm.MambaState  # ssm [L, B, H, dk, hd], conv [L, B, W-1, C] f32
    shared: KVCache | None  # k/v [G, B, max_len, KV, hd]; length [G] (CPU)
    length: torch.Tensor    # [] (or [B]) int32 tokens seen, on the CPU


def masked_nll(logits: torch.Tensor, targets, mask=None
               ) -> tuple[torch.Tensor, dict]:
    """The mean over ``mask`` (all ones when absent) of ``logsumexp -
    gold`` of ``logits [..., V]`` at ``targets``, in f32: the loss and
    ``{"nll", "tokens"}``."""
    device = logits.device
    targets = torch.as_tensor(targets).to(device).long()
    mask = (torch.ones(targets.shape, device=device) if mask is None
            else torch.as_tensor(mask).to(device, torch.float32))
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, targets[..., None])[..., 0]
    loss = ((lse - gold) * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return loss, {"nll": loss, "tokens": mask.sum()}


def _stacked(states: list):
    """Per-layer state tuples -> one tuple of ``[L, ...]`` stacks."""
    return type(states[0])(*(torch.stack(s) for s in zip(*states)))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: LMConfig, device=None, generator=None):
        super().__init__()
        c = cfg
        tnn = c.tnn if c.tnn.enabled else None
        common = dict(param_dtype=c.param_dtype, compute_dtype=c.compute_dtype,
                      device=device, generator=generator)
        self.ln1 = RMSNorm(c.d_model, device=device)
        self.attn = Attention(c.d_model, c.num_heads, c.num_kv_heads, c.hd,
                              qkv_bias=c.qkv_bias, rope_theta=c.rope_theta,
                              q_chunk=c.q_chunk, kv_chunk=c.kv_chunk,
                              tnn=tnn, **common)
        self.ln2 = RMSNorm(c.d_model, device=device)
        if c.moe:
            m = c.moe
            self.mlp = MoE(c.d_model, m.d_ff_expert, m.num_experts, m.top_k,
                           m.capacity_factor, tnn=tnn, **common)
        else:
            self.mlp = SwiGLU(c.d_model, c.d_ff, tnn=tnn, **common)


class RWKVLayer(nn.Module):
    def __init__(self, cfg: LMConfig, device=None, generator=None):
        super().__init__()
        c = cfg
        self.ln1 = RMSNorm(c.d_model, device=device)
        self.ln2 = RMSNorm(c.d_model, device=device)
        self.rwkv = ssm.RWKV6Block(
            c.d_model, head_dim=c.hd, d_ff=c.d_ff,
            tnn=c.tnn if c.tnn.enabled else None,
            param_dtype=c.param_dtype, compute_dtype=c.compute_dtype,
            device=device, generator=generator)


class MambaLayer(nn.Module):
    def __init__(self, cfg: LMConfig, device=None, generator=None):
        super().__init__()
        c = cfg
        self.ln = RMSNorm(c.d_model, device=device)
        self.mamba = ssm.Mamba2Block(
            c.d_model, d_state=c.ssm_state, head_dim=c.hd,
            tnn=c.tnn if c.tnn.enabled else None,
            param_dtype=c.param_dtype, compute_dtype=c.compute_dtype,
            device=device, generator=generator)


class SharedBlock(nn.Module):
    """The hybrid's shared attention + SwiGLU block."""

    def __init__(self, cfg: LMConfig, device=None, generator=None):
        super().__init__()
        c = cfg
        tnn = c.tnn if c.tnn.enabled else None
        common = dict(param_dtype=c.param_dtype, compute_dtype=c.compute_dtype,
                      device=device, generator=generator)
        self.ln1 = RMSNorm(c.d_model, device=device)
        self.attn = Attention(c.d_model, c.num_heads, c.num_kv_heads, c.hd,
                              rope_theta=c.rope_theta, q_chunk=c.q_chunk,
                              kv_chunk=c.kv_chunk, tnn=tnn, **common)
        self.ln2 = RMSNorm(c.d_model, device=device)
        self.mlp = SwiGLU(c.d_model, c.hybrid.d_ff_shared or c.d_ff, tnn=tnn,
                          **common)


_LAYERS = {"attn": DecoderLayer, "rwkv6": RWKVLayer, "mamba2": MambaLayer}


class LM(nn.Module):
    """``device`` defaults to ``cuda``; weights are random from ``seed``
    (or loaded with ``load_state_dict``)."""

    def __init__(self, cfg: LMConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        cfg.validate()
        self.cfg = c = cfg
        self.device = torch.device(device)
        gen = torch.Generator().manual_seed(seed)
        std = 1.0 / math.sqrt(c.d_model)
        self.embed = nn.Parameter(
            (torch.randn(c.vocab, c.d_model, generator=gen) * std).to(
                device=self.device, dtype=c.param_dtype))
        self.ln_f = RMSNorm(c.d_model, device=self.device)
        layer = _LAYERS[c.block]
        self.layers = nn.ModuleList(
            layer(c, device=self.device, generator=gen)
            for _ in range(c.num_layers))
        if not c.tie_embeddings:
            self.lm_head = Dense(c.d_model, c.vocab,
                                 param_dtype=c.param_dtype,
                                 compute_dtype=c.compute_dtype,
                                 device=self.device, generator=gen)
        if c.hybrid:
            self.shared = SharedBlock(c, device=self.device, generator=gen)

    # -- pieces ---------------------------------------------------------------

    def _embed(self, inputs: torch.Tensor) -> torch.Tensor:
        """Token ids ``[B, T]`` index the table; a floating ``[B, T, D]``
        input (the modality stub's embeddings) is cast to the compute
        dtype instead."""
        cd = self.cfg.compute_dtype
        inputs = inputs.to(self.device)
        if inputs.is_floating_point():
            return inputs.to(cd)
        return self.embed.to(cd)[inputs.long()]

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        if c.tie_embeddings:
            w = self.embed.to(c.compute_dtype).float()
            return torch.einsum("btd,vd->btv", x.float(), w).to(
                c.compute_dtype)
        return self.lm_head(x)

    # -- full-sequence forward (training) --------------------------------------

    def _attn_layer(self, layer: DecoderLayer, x: torch.Tensor,
                    positions: torch.Tensor):
        """One attention layer; a MoE layer also returns its ``lb_loss``
        and ``z_loss`` (``(x, lb, z)``)."""
        c = self.cfg
        x = x + layer.attn(layer.ln1(x, c.norm_eps), positions)
        if c.moe:
            ym, aux = layer.mlp(layer.ln2(x, c.norm_eps))
            return x + ym, aux["lb_loss"], aux["z_loss"]
        return x + layer.mlp(layer.ln2(x, c.norm_eps))

    def _ffn(self, mlp, y: torch.Tensor) -> torch.Tensor:
        """The MLP's output alone: a MoE layer's aux losses are dropped
        outside training."""
        out = mlp(y)
        return out[0] if self.cfg.moe else out

    def _rwkv_layer(self, layer: RWKVLayer, x: torch.Tensor,
                    want_state: bool = False):
        """One RWKV-6 layer; with ``want_state`` also its decode state
        (the scan's final wkv state and the two shift tokens)."""
        c = self.cfg
        xn1 = layer.ln1(x, c.norm_eps)
        tm, wkv = layer.rwkv.time_mix(xn1)
        x = x + tm
        xn2 = layer.ln2(x, c.norm_eps)
        x = x + layer.rwkv.channel_mix(xn2, ssm.token_shift(xn2))
        if want_state:
            return x, ssm.RWKVState(
                wkv=wkv, shift_tm=xn1[:, -1].to(c.compute_dtype),
                shift_cm=xn2[:, -1].to(c.compute_dtype))
        return x

    def _mamba_layer(self, layer: MambaLayer, x: torch.Tensor,
                     want_state: bool = False):
        """One Mamba-2 layer; with ``want_state`` also its decode state."""
        xn = layer.ln(x, self.cfg.norm_eps)
        if want_state:
            h, state = layer.mamba(xn, return_state=True)
            return x + h, state
        return x + layer.mamba(xn)

    def _shared_block(self, x: torch.Tensor, positions: torch.Tensor
                      ) -> torch.Tensor:
        c, sb = self.cfg, self.shared
        x = x + sb.attn(sb.ln1(x, c.norm_eps), positions)
        return x + sb.mlp(sb.ln2(x, c.norm_eps))

    def _shared_after(self, li: int) -> bool:
        """Whether the hybrid's shared block follows layer ``li``."""
        h = self.cfg.hybrid
        return h is not None and (li + 1) % h.shared_every == 0

    def apply_layers(self, x: torch.Tensor, positions: torch.Tensor,
                     aux: dict | None = None) -> torch.Tensor:
        """Run the layer stack (the hybrid's shared block after every
        ``shared_every`` layers); with ``cfg.remat`` and grad enabled,
        each layer's activations are recomputed in the backward.  A MoE
        stack appends each layer's ``lb_loss`` and ``z_loss`` to the
        lists ``aux`` holds under those keys, when given."""
        block = self.cfg.block
        if block == "rwkv6":
            fn, extra = self._rwkv_layer, ()
        elif block == "mamba2":
            fn, extra = self._mamba_layer, ()
        else:
            fn, extra = self._attn_layer, (positions,)
        for li, layer in enumerate(self.layers):
            if self.cfg.remat and torch.is_grad_enabled():
                x = checkpoint(fn, layer, x, *extra, use_reentrant=False)
            else:
                x = fn(layer, x, *extra)
            if self.cfg.moe:
                x, lb, z = x
                if aux is not None:
                    aux.setdefault("lb_loss", []).append(lb)
                    aux.setdefault("z_loss", []).append(z)
            if self._shared_after(li):
                x = self._shared_block(x, positions)
        return x

    def forward(self, inputs: torch.Tensor, aux: dict | None = None
                ) -> torch.Tensor:
        """inputs: ``[B, T]`` token ids (or ``[B, T, D]`` embeddings) ->
        logits ``[B, T, V]``; a MoE
        model fills ``aux`` (when given) with ``lb_loss`` and ``z_loss``,
        each the mean over the layers."""
        B, T = inputs.shape[:2]
        positions = torch.arange(T, device=self.device)[None].expand(B, T)
        per_layer: dict = {}
        x = self.apply_layers(self._embed(inputs), positions, per_layer)
        if aux is not None:
            aux.update({k: torch.stack(v).mean()
                        for k, v in per_layer.items()})
        return self._logits(self.ln_f(x, self.cfg.norm_eps))

    # -- loss -------------------------------------------------------------------

    def token_loss(self, logits: torch.Tensor, batch: dict
                   ) -> tuple[torch.Tensor, dict]:
        """Masked next-token NLL from precomputed logits
        (:func:`masked_nll` of ``batch["targets"]``)."""
        return masked_nll(logits, batch["targets"], batch.get("mask"))

    def loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """batch: ``{"inputs": [B, T] (or [B, T, D]), "targets": [B, T],
        "mask"?}``.  A
        MoE model adds ``0.01 * lb_loss + 1e-3 * z_loss`` and reports
        both."""
        inputs = torch.as_tensor(batch["inputs"]).to(self.device)
        aux: dict = {}
        loss, metrics = self.token_loss(self(inputs, aux=aux), batch)
        if "lb_loss" in aux:
            lb, zl = aux["lb_loss"], aux["z_loss"]
            loss = loss + 0.01 * lb + 1e-3 * zl
            metrics.update(lb_loss=lb, z_loss=zl)
        return loss, metrics

    # -- caches ---------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int
                   ) -> DecodeCache | StateCache | MambaCache:
        """Zeroed decode state: K/V buffers of ``max_len`` positions, or
        for RWKV-6 and Mamba-2 the per-layer recurrent states (``max_len``
        sizes only the hybrid's shared-block K/V)."""
        c = self.cfg
        length = torch.zeros((), dtype=torch.int32)
        if c.block == "rwkv6":
            states = [layer.rwkv.init_state(batch) for layer in self.layers]
            return StateCache(_stacked(states), length)
        kv_shape = (batch, max_len, c.num_kv_heads, c.hd)
        if c.block == "mamba2":
            one = self.layers[0].mamba.init_state(batch)
            layers = type(one)(*(torch.zeros((c.num_layers,) + s.shape,
                                             dtype=s.dtype, device=s.device)
                                 for s in one))
            shared = None
            if c.hybrid:
                groups = c.num_layers // c.hybrid.shared_every
                shared = KVCache(
                    *(torch.zeros((groups,) + kv_shape, dtype=c.compute_dtype,
                                  device=self.device) for _ in "kv"),
                    torch.zeros(groups, dtype=torch.int32))
            return MambaCache(layers, shared, length)
        shape = (c.num_layers,) + kv_shape
        return DecodeCache(
            k=torch.zeros(shape, dtype=c.compute_dtype, device=self.device),
            v=torch.zeros(shape, dtype=c.compute_dtype, device=self.device),
            length=length)

    # -- serving --------------------------------------------------------------

    def extend(self, tokens: torch.Tensor, cache: DecodeCache,
               valid: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, DecodeCache]:
        """Ingest a ``[B, C]`` token chunk at each slot's depth.

        ``cache.length`` may be per-slot ([B]); ``valid`` ([B], None =
        all C) bounds how many chunk tokens are real per slot.  Returns
        logits for every chunk position ([B, C, V]) and the advanced
        cache.  Attention blocks only, as in the reference."""
        c = self.cfg
        if c.block != "attn":
            raise NotImplementedError(
                "extend() requires an attention-block model")
        x = self._embed(tokens)
        ks, vs = [], []
        for li, layer in enumerate(self.layers):
            lkv = KVCache(cache.k[li], cache.v[li], cache.length)
            h, new_kv = layer.attn.extend(layer.ln1(x, c.norm_eps), lkv,
                                          valid=valid)
            x = x + h
            x = x + self._ffn(layer.mlp, layer.ln2(x, c.norm_eps))
            ks.append(new_kv.k)
            vs.append(new_kv.v)
        adv = tokens.shape[1] if valid is None else valid.cpu().to(
            cache.length.dtype)
        logits = self._logits(self.ln_f(x, c.norm_eps))
        return logits, DecodeCache(torch.stack(ks), torch.stack(vs),
                                   cache.length + adv)

    def decode_step(self, token: torch.Tensor,
                    cache: DecodeCache | StateCache | MambaCache
                    ) -> tuple[torch.Tensor,
                               DecodeCache | StateCache | MambaCache]:
        """token: [B] ids (or [B, D] embeddings) -> (logits [B, V],
        advanced cache).  RWKV-6 and
        Mamba-2 run each layer's single-step recurrence on its carried
        state; the hybrid's shared block attends over its application's
        K/V cache at each slot's depth (``cache.length``)."""
        c = self.cfg
        if c.block == "mamba2":
            return self._mamba_decode_step(token, cache)
        if c.block != "rwkv6":
            logits, new = self.extend(token[:, None], cache)
            return logits[:, 0], new
        x = self._embed(token[:, None])
        new_states = []
        for li, layer in enumerate(self.layers):
            st = ssm.RWKVState(*(s[li] for s in cache.layers))
            tm, wkv, sh_tm = layer.rwkv.time_mix_step(
                layer.ln1(x, c.norm_eps), st.wkv, st.shift_tm)
            x = x + tm
            cm, sh_cm = layer.rwkv.channel_mix_step(
                layer.ln2(x, c.norm_eps), st.shift_cm)
            x = x + cm
            new_states.append(ssm.RWKVState(wkv, sh_tm, sh_cm))
        logits = self._logits(self.ln_f(x, c.norm_eps))[:, 0]
        return logits, StateCache(_stacked(new_states), cache.length + 1)

    def _mamba_decode_step(self, token: torch.Tensor, cache: MambaCache
                           ) -> tuple[torch.Tensor, MambaCache]:
        c = self.cfg
        x = self._embed(token[:, None])
        states, ks, vs = [], [], []
        for li, layer in enumerate(self.layers):
            st = ssm.MambaState(*(s[li] for s in cache.layers))
            h, st = layer.mamba.decode_step(layer.ln(x, c.norm_eps), st)
            x = x + h
            states.append(st)
            if self._shared_after(li):
                gi, sb = len(ks), self.shared
                kv = KVCache(cache.shared.k[gi], cache.shared.v[gi],
                             cache.length)
                h, kv = sb.attn.decode_step(sb.ln1(x, c.norm_eps), kv)
                x = x + h
                x = x + sb.mlp(sb.ln2(x, c.norm_eps))
                ks.append(kv.k)
                vs.append(kv.v)
        shared = (KVCache(torch.stack(ks), torch.stack(vs),
                          cache.shared.length + 1) if ks else None)
        logits = self._logits(self.ln_f(x, c.norm_eps))[:, 0]
        return logits, MambaCache(_stacked(states), shared, cache.length + 1)

    def prefill(self, inputs: torch.Tensor, max_len: int
                ) -> tuple[torch.Tensor,
                           DecodeCache | StateCache | MambaCache]:
        """Ingest the prompt ``[B, T]`` (or ``[B, T, D]`` embeddings)
        with the full-sequence path and
        return the last position's logits ``[B, V]`` and the decode
        state.  Attention layers run the flash kernel over the prompt and
        leave their K/V zero-padded to ``max_len`` (a
        :class:`DecodeCache` of length ``T``); RWKV-6 and Mamba-2 run the
        scan kernel and keep its final states, the hybrid's shared
        attention as the attention layers do."""
        c = self.cfg
        B, T = inputs.shape[:2]
        positions = torch.arange(T, device=self.device)[None].expand(B, T)
        x = self._embed(inputs)
        states, ks, vs = [], [], []

        def attn_block(attn, ln1, ln2, mlp, x):
            h, kv = attn.prefill(ln1(x, c.norm_eps), positions, max_len)
            x = x + h
            ks.append(kv.k)
            vs.append(kv.v)
            return x + self._ffn(mlp, ln2(x, c.norm_eps))

        for li, layer in enumerate(self.layers):
            if c.block == "attn":
                x = attn_block(layer.attn, layer.ln1, layer.ln2, layer.mlp, x)
                continue
            if c.block == "rwkv6":
                x, st = self._rwkv_layer(layer, x, want_state=True)
            else:
                x, st = self._mamba_layer(layer, x, want_state=True)
            states.append(st)
            if self._shared_after(li):
                sb = self.shared
                x = attn_block(sb.attn, sb.ln1, sb.ln2, sb.mlp, x)
        logits = self._logits(self.ln_f(x, c.norm_eps)[:, -1:])[:, 0]
        length = torch.tensor(T, dtype=torch.int32)
        if c.block == "attn":
            return logits, DecodeCache(torch.stack(ks), torch.stack(vs),
                                       length)
        if c.block == "rwkv6":
            return logits, StateCache(_stacked(states), length)
        shared = (KVCache(torch.stack(ks), torch.stack(vs),
                          torch.full((len(ks),), T, dtype=torch.int32))
                  if ks else None)
        return logits, MambaCache(_stacked(states), shared, length)
