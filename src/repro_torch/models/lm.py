"""Decoder-only language model, dense-attention family (serving path).

Port of ``src/repro/models/lm.py``: :class:`LMConfig`, and :class:`LM`
with the serving entry points ``init_cache``, ``extend`` (chunked
prefill at per-slot depths) and ``decode_step``.  Every projection
consults ``cfg.tnn`` (:func:`repro_torch.models.blocks.make_dense`), which
is how the paper's technique, and with ``backend="cuda"`` the CUDA
kernels, enter the model.

Parameter names follow the reference's tree with the stacked ``[L, ...]``
layer leaves split per layer (``layers.<l>.attn.q.cores.<i>``), so
:func:`repro_torch.convert.params_from_numpy` loads reference parameters.

Not ported yet: MoE, RWKV6/Mamba2 and hybrid blocks, the training
``__call__``/loss and ``prefill`` (ROADMAP.md, queue A).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.core.tensorized import TNNConfig
from repro_torch.models.blocks import (
    Attention, Dense, KVCache, RMSNorm, SwiGLU,
)


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
    block: str = "attn"                    # only attn is ported
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    tnn: TNNConfig = TNNConfig()
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def validate(self):
        if self.block != "attn":
            raise NotImplementedError(
                f"block {self.block!r} is not ported yet (ROADMAP.md, "
                "queue A: SSM and remaining models)")


class DecodeCache(NamedTuple):
    """Per-model decode state: stacked per-layer K/V + per-slot depths."""
    k: torch.Tensor       # [L, B, T, KV, hd] on the model's device
    v: torch.Tensor       # [L, B, T, KV, hd]
    length: torch.Tensor  # [B] (or [] scalar) int32, on the CPU


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
                              tnn=tnn, **common)
        self.ln2 = RMSNorm(c.d_model, device=device)
        self.mlp = SwiGLU(c.d_model, c.d_ff, tnn=tnn, **common)


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
                device=self.device, dtype=c.param_dtype), requires_grad=False)
        self.ln_f = RMSNorm(c.d_model, device=self.device)
        self.layers = nn.ModuleList(
            DecoderLayer(c, device=self.device, generator=gen)
            for _ in range(c.num_layers))
        if not c.tie_embeddings:
            self.lm_head = Dense(c.d_model, c.vocab,
                                 param_dtype=c.param_dtype,
                                 compute_dtype=c.compute_dtype,
                                 device=self.device, generator=gen)

    # -- pieces ---------------------------------------------------------------

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        table = self.embed.to(self.cfg.compute_dtype)
        return table[tokens.to(self.device).long()]

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        if c.tie_embeddings:
            w = self.embed.to(c.compute_dtype).float()
            return torch.einsum("btd,vd->btv", x.float(), w).to(
                c.compute_dtype)
        return self.lm_head(x)

    # -- caches ---------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int) -> DecodeCache:
        c = self.cfg
        shape = (c.num_layers, batch, max_len, c.num_kv_heads, c.hd)
        return DecodeCache(
            k=torch.zeros(shape, dtype=c.compute_dtype, device=self.device),
            v=torch.zeros(shape, dtype=c.compute_dtype, device=self.device),
            length=torch.zeros((), dtype=torch.int32))

    # -- serving --------------------------------------------------------------

    def extend(self, tokens: torch.Tensor, cache: DecodeCache,
               valid: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, DecodeCache]:
        """Ingest a ``[B, C]`` token chunk at each slot's depth.

        ``cache.length`` may be per-slot ([B]); ``valid`` ([B], None =
        all C) bounds how many chunk tokens are real per slot.  Returns
        logits for every chunk position ([B, C, V]) and the advanced
        cache."""
        c = self.cfg
        x = self._embed(tokens)
        ks, vs = [], []
        for li, layer in enumerate(self.layers):
            lkv = KVCache(cache.k[li], cache.v[li], cache.length)
            h, new_kv = layer.attn.extend(layer.ln1(x, c.norm_eps), lkv,
                                          valid=valid)
            x = x + h
            x = x + layer.mlp(layer.ln2(x, c.norm_eps))
            ks.append(new_kv.k)
            vs.append(new_kv.v)
        adv = tokens.shape[1] if valid is None else valid.cpu().to(
            cache.length.dtype)
        logits = self._logits(self.ln_f(x, c.norm_eps))
        return logits, DecodeCache(torch.stack(ks), torch.stack(vs),
                                   cache.length + adv)

    def decode_step(self, token: torch.Tensor, cache: DecodeCache
                    ) -> tuple[torch.Tensor, DecodeCache]:
        """token: [B] ids -> (logits [B, V], advanced cache)."""
        logits, new = self.extend(token[:, None], cache)
        return logits[:, 0], new
