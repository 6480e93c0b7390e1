"""Encoder-decoder transformer (the seamless-m4t backbone).

Port of ``src/repro/models/encdec.py``: :class:`EncDecConfig`,
:class:`EncDecCache` and :class:`EncDec`.  The modality frontend (a
speech feature extractor) is a stub: the encoder reads precomputed frame
embeddings ``[B, S_enc, d_model]`` (:mod:`repro_torch.models.modality`).
Encoder layers are bidirectional self-attention with RoPE; the decoder
is a causal transformer whose layers add cross-attention into the
encoder output: q from the decoder, k/v from the encoder, no RoPE, no
mask (:meth:`EncDec._cross`).  Every attention's full-sequence path runs
the flash-attention kernel on a CUDA tensor (non-causal in the encoder
and the cross-attention, whose query and key lengths differ, down to one
query a decode step); the decoder's own decode step attends over its
K/V cache with the serving path's plain code
(:meth:`~repro_torch.models.blocks.Attention.decode_step`).

Parameter names are the reference's tree with the stacked ``[L, ...]``
leaves split per layer: ``enc_layers.<l>.{ln1,attn,ln2,mlp}``,
``dec_layers.<l>.{ln1,self,ln_x,cross,ln2,mlp}``, and ``embed``,
``ln_enc``, ``ln_f``, ``lm_head`` (:func:`repro_torch.convert.
params_from_numpy` maps them).  ``remat`` re-runs each layer's forward
inside the backward (``torch.utils.checkpoint`` per layer), the
reference's per-layer ``jax.checkpoint`` with ``nothing_saveable``; the
reference's ``scan_layers`` chooses how XLA lowers the stacks, which an
eager loop over per-layer modules has no use for.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.tensorized import TNNConfig
from repro_torch.models.blocks import (
    Attention, Dense, KVCache, RMSNorm, SwiGLU, blockwise_attention,
)
from repro_torch.models.lm import masked_nll


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    num_enc_layers: int
    num_dec_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tnn: TNNConfig = TNNConfig()
    q_chunk: int = 512
    kv_chunk: int = 1024
    remat: bool = True
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads


class EncDecCache(NamedTuple):
    """Decode state: the encoder output (fixed while decoding) and the
    decoder's self-attention K/V stacked ``[L_dec, ...]``."""
    enc_out: torch.Tensor  # [B, S_enc, D] on the model's device
    self_kv: KVCache       # k/v [L_dec, B, max_len, KV, hd]; length [L_dec]
    length: torch.Tensor   # [] int32 decoder tokens seen, on the CPU


def _attention(c: EncDecConfig, causal: bool, **common) -> Attention:
    tnn = c.tnn if c.tnn.enabled else None
    return Attention(c.d_model, c.num_heads, c.num_kv_heads, c.hd,
                     causal=causal, rope_theta=c.rope_theta,
                     q_chunk=c.q_chunk, kv_chunk=c.kv_chunk, tnn=tnn,
                     **common)


def _mlp(c: EncDecConfig, **common) -> SwiGLU:
    return SwiGLU(c.d_model, c.d_ff, tnn=c.tnn if c.tnn.enabled else None,
                  **common)


class EncoderLayer(nn.Module):
    def __init__(self, c: EncDecConfig, device=None, generator=None):
        super().__init__()
        common = dict(param_dtype=c.param_dtype, compute_dtype=c.compute_dtype,
                      device=device, generator=generator)
        self.ln1 = RMSNorm(c.d_model, device=device)
        self.attn = _attention(c, False, **common)
        self.ln2 = RMSNorm(c.d_model, device=device)
        self.mlp = _mlp(c, **common)


class DecoderLayer(nn.Module):
    """``self`` (causal self-attention), ``cross`` (into the encoder
    output) and the SwiGLU, each after its RMSNorm."""

    def __init__(self, c: EncDecConfig, device=None, generator=None):
        super().__init__()
        common = dict(param_dtype=c.param_dtype, compute_dtype=c.compute_dtype,
                      device=device, generator=generator)
        self.ln1 = RMSNorm(c.d_model, device=device)
        self.add_module("self", _attention(c, True, **common))
        self.ln_x = RMSNorm(c.d_model, device=device)
        self.cross = _attention(c, False, **common)
        self.ln2 = RMSNorm(c.d_model, device=device)
        self.mlp = _mlp(c, **common)


class EncDec(nn.Module):
    """``device`` defaults to ``cuda``; weights are random from ``seed``
    (or loaded with ``load_state_dict``)."""

    def __init__(self, cfg: EncDecConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        self.cfg = c = cfg
        self.device = torch.device(device)
        gen = torch.Generator().manual_seed(seed)
        std = 1.0 / math.sqrt(c.d_model)
        self.embed = nn.Parameter(
            (torch.randn(c.vocab, c.d_model, generator=gen) * std).to(
                device=self.device, dtype=c.param_dtype))
        self.enc_layers = nn.ModuleList(
            EncoderLayer(c, device=self.device, generator=gen)
            for _ in range(c.num_enc_layers))
        self.dec_layers = nn.ModuleList(
            DecoderLayer(c, device=self.device, generator=gen)
            for _ in range(c.num_dec_layers))
        self.ln_enc = RMSNorm(c.d_model, device=self.device)
        self.ln_f = RMSNorm(c.d_model, device=self.device)
        self.lm_head = Dense(c.d_model, c.vocab, param_dtype=c.param_dtype,
                             compute_dtype=c.compute_dtype,
                             device=self.device, generator=gen)

    # -- pieces ---------------------------------------------------------------

    def _embed(self, tokens) -> torch.Tensor:
        table = self.embed.to(self.cfg.compute_dtype)
        return table[torch.as_tensor(tokens).to(self.device).long()]

    def _positions(self, batch: int, length: int) -> torch.Tensor:
        return torch.arange(length, device=self.device)[None].expand(
            batch, length)

    def _cross(self, attn: Attention, x: torch.Tensor,
               enc_out: torch.Tensor) -> torch.Tensor:
        """q from ``x [B, T, D]``, k/v from ``enc_out [B, S, D]``; no
        RoPE, every key visible."""
        c = self.cfg
        B, T, _ = x.shape
        S = enc_out.shape[1]
        H, KV, D = c.num_heads, c.num_kv_heads, c.hd
        q = attn.q(x).reshape(B, T, H, D)
        k = attn.k(enc_out).reshape(B, S, KV, D)
        v = attn.v(enc_out).reshape(B, S, KV, D)
        ctx = blockwise_attention(q, k, v, causal=False,
                                  q_chunk=min(c.q_chunk, T),
                                  kv_chunk=min(c.kv_chunk, S))
        return attn.o(ctx.reshape(B, T, H * D))

    def _enc_layer(self, layer: EncoderLayer, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
        eps = self.cfg.norm_eps
        x = x + layer.attn(layer.ln1(x, eps), positions)
        return x + layer.mlp(layer.ln2(x, eps))

    def _dec_tail(self, layer: DecoderLayer, x: torch.Tensor,
                  enc_out: torch.Tensor) -> torch.Tensor:
        """The cross-attention and MLP halves of a decoder layer."""
        eps = self.cfg.norm_eps
        x = x + self._cross(layer.cross, layer.ln_x(x, eps), enc_out)
        return x + layer.mlp(layer.ln2(x, eps))

    def _dec_layer(self, layer: DecoderLayer, x: torch.Tensor,
                   positions: torch.Tensor, enc_out: torch.Tensor
                   ) -> torch.Tensor:
        x = x + layer.self(layer.ln1(x, self.cfg.norm_eps), positions)
        return self._dec_tail(layer, x, enc_out)

    def _run(self, fn, layer, *args):
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(fn, layer, *args, use_reentrant=False)
        return fn(layer, *args)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.lm_head(self.ln_f(x, self.cfg.norm_eps))

    # -- encoder ------------------------------------------------------------

    def encode(self, enc_embeds) -> torch.Tensor:
        """``[B, S, D]`` frame embeddings -> encoder output ``[B, S, D]``
        in the compute dtype."""
        c = self.cfg
        x = torch.as_tensor(enc_embeds).to(self.device, c.compute_dtype)
        positions = self._positions(*x.shape[:2])
        for layer in self.enc_layers:
            x = self._run(self._enc_layer, layer, x, positions)
        return self.ln_enc(x, c.norm_eps)

    # -- decoder (teacher-forced) --------------------------------------------

    def forward(self, enc_embeds, dec_tokens) -> torch.Tensor:
        """Logits ``[B, T, V]`` of the decoder over ``dec_tokens [B, T]``
        given the encoder's frames."""
        enc_out = self.encode(enc_embeds)
        x = self._embed(dec_tokens)
        positions = self._positions(*x.shape[:2])
        for layer in self.dec_layers:
            x = self._run(self._dec_layer, layer, x, positions, enc_out)
        return self._logits(x)

    def loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """batch: ``{"enc_embeds": [B, S, D], "dec_inputs": [B, T],
        "dec_targets": [B, T], "mask"?}`` -> the masked next-token NLL
        (:func:`~repro_torch.models.lm.masked_nll`)."""
        logits = self(batch["enc_embeds"], batch["dec_inputs"])
        return masked_nll(logits, batch["dec_targets"], batch.get("mask"))

    # -- serving ----------------------------------------------------------------

    def prefill(self, enc_embeds, dec_tokens, max_len: int
                ) -> tuple[torch.Tensor, EncDecCache]:
        """Encode the frames, ingest the decoder prompt ``[B, T]`` (its
        self-attention through the flash path, K/V zero-padded to
        ``max_len``) and return the last position's logits ``[B, V]``
        and the decode state."""
        c = self.cfg
        enc_out = self.encode(enc_embeds)
        x = self._embed(dec_tokens)
        B, T = x.shape[:2]
        positions = self._positions(B, T)
        ks, vs = [], []
        for layer in self.dec_layers:
            h, kv = layer.self.prefill(layer.ln1(x, c.norm_eps), positions,
                                       max_len)
            x = self._dec_tail(layer, x + h, enc_out)
            ks.append(kv.k)
            vs.append(kv.v)
        logits = self._logits(x[:, -1:])[:, 0]
        self_kv = KVCache(torch.stack(ks), torch.stack(vs),
                          torch.full((c.num_dec_layers,), T,
                                     dtype=torch.int32))
        return logits, EncDecCache(enc_out, self_kv,
                                   torch.tensor(T, dtype=torch.int32))

    def decode_step(self, token, cache: EncDecCache
                    ) -> tuple[torch.Tensor, EncDecCache]:
        """token: ``[B]`` ids -> (logits ``[B, V]``, advanced cache).  The
        self-attention appends at the cache's depth; the cross-attention
        attends over the whole encoder output (one query a row)."""
        c = self.cfg
        x = self._embed(torch.as_tensor(token)[:, None])
        ks, vs = [], []
        for li, layer in enumerate(self.dec_layers):
            lkv = KVCache(cache.self_kv.k[li], cache.self_kv.v[li],
                          cache.length)
            h, new_kv = layer.self.decode_step(layer.ln1(x, c.norm_eps), lkv)
            x = self._dec_tail(layer, x + h, cache.enc_out)
            ks.append(new_kv.k)
            vs.append(new_kv.v)
        logits = self._logits(x)[:, 0]
        self_kv = KVCache(torch.stack(ks), torch.stack(vs),
                          cache.self_kv.length + 1)
        return logits, EncDecCache(cache.enc_out, self_kv, cache.length + 1)
