"""Model and step builders shared by the launchers.

Port of ``src/repro/launch/steps.py``: :func:`build_model` (with the
reference's rule that the ``recompute`` stash policy turns on per-layer
remat), :func:`make_train_step`, :func:`make_prefill_step` and
:func:`make_decode_step`.  The reference's steps are pure functions
jitted by the launcher; these run eagerly.  The train step accumulates
the gradients in the parameters' ``.grad`` and updates the parameters
and optimizer state in place (:class:`repro_torch.optim.adamw.AdamW`);
the serving steps hold the model, so they take no parameters.  An
``encdec`` architecture builds an :class:`~repro_torch.models.encdec.EncDec`
(the step builders are its entry points: its batches carry the encoder's
frames, which the train loop's synthetic data does not make, in the
reference too).  :data:`ENC_FRAMES_DECODE` is the reference's fixed
encoder stub length for the encoder-decoder decode cells.  The dry-run
input specs wait for the dry run (ROADMAP.md, queue A item 9).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.tensorized import TNNConfig
from repro_torch.models.encdec import EncDec
from repro_torch.models.lm import LM
from repro_torch.optim.adamw import AdamW

ENC_FRAMES_DECODE = 1024   # fixed encoder stub length for enc-dec decode cells


def build_model(arch: ArchConfig, tnn: TNNConfig | None = None,
                smoke: bool = False, *, device="cuda", seed: int = 0,
                backend: str | None = None, compute_dtype=None,
                num_layers: int | None = None,
                shared_every: int | None = None):
    """``(model, cfg)`` for ``arch``: its published config (or the smoke
    one), random weights from ``seed`` on ``device``: an :class:`LM`, or
    an :class:`EncDec` for ``model_kind == "encdec"``.  ``backend``
    overrides the TNN executor (``einsum`` | ``cuda`` | ``pallas``),
    ``compute_dtype`` the model's compute dtype, ``num_layers`` its
    depth (an encoder-decoder's ``num_enc_layers`` and
    ``num_dec_layers`` both) and ``shared_every`` a hybrid's
    shared-block period (a depth cut must stay a multiple of it)."""
    if arch.model_kind not in ("lm", "encdec"):
        raise ValueError(f"unknown model kind {arch.model_kind!r}")
    encdec = arch.model_kind == "encdec"
    cfg = arch.smoke(tnn) if smoke else arch.model(tnn)
    if backend is not None:
        cfg = dataclasses.replace(
            cfg, tnn=dataclasses.replace(cfg.tnn, backend=backend))
    if compute_dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    if num_layers is not None:
        cfg = dataclasses.replace(
            cfg, **({"num_enc_layers": num_layers,
                     "num_dec_layers": num_layers} if encdec
                    else {"num_layers": num_layers}))
    if shared_every is not None:
        cfg = dataclasses.replace(cfg, hybrid=dataclasses.replace(
            cfg.hybrid, shared_every=shared_every))
    if (cfg.tnn.enabled and cfg.tnn.stash_policy().mode == "recompute"
            and not cfg.remat):
        # The recompute stash is realised at the model level: per-layer
        # checkpointing drops every tensorized residual and re-runs the
        # FP plans inside the backward.
        cfg = dataclasses.replace(cfg, remat=True)
    return (EncDec if encdec else LM)(cfg, device=device, seed=seed), cfg


def make_train_step(model: LM | EncDec, opt: AdamW, microbatches: int = 1):
    """``train_step(state, batch) -> (state, metrics)`` with ``state =
    {"params": {name: Parameter}, "opt": OptState}``.

    With ``microbatches > 1`` the batch splits along dim 0 and gradients
    accumulate over the pieces (summed, then averaged, as the reference's
    scan).  The ``quant_amax`` "gradients" are state deltas (``hist -
    new_hist``): they combine by their minimum, i.e. the largest amax any
    microbatch observed, and are never summed or averaged, so the delayed
    scaling window records the worst microbatch instead of a diluted
    mean.  Static loss scaling (``opt.loss_scale``) multiplies the loss
    before the backward; AdamW divides it back out of the gradients."""
    ls = opt.loss_scale

    def grad_fn(mb: dict):
        loss, metrics = model.loss(mb)
        if ls != 1.0:
            loss = loss * ls
        loss.backward()
        loss = loss.detach()
        if ls != 1.0:
            loss = loss / ls
        return loss, metrics

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        for p in params.values():
            p.grad = None
        if microbatches == 1:
            loss, metrics = grad_fn(batch)
        else:
            rows = len(next(iter(batch.values())))
            if rows % microbatches:
                raise ValueError(f"batch of {rows} does not split into "
                                 f"{microbatches} microbatches")
            n = rows // microbatches
            amax = [p for name, p in params.items() if opt.is_amax(name)]
            amax_acc: list = [None] * len(amax)
            loss = torch.zeros((), dtype=torch.float32)
            for i in range(microbatches):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                mb_loss, metrics = grad_fn(mb)
                loss = loss.to(mb_loss.device) + mb_loss
                for j, p in enumerate(amax):
                    # Take each microbatch's delta out of autograd's sum.
                    if p.grad is not None:
                        amax_acc[j] = (p.grad if amax_acc[j] is None
                                       else torch.minimum(amax_acc[j], p.grad))
                        p.grad = None
            loss = loss / microbatches
            for name, p in params.items():
                if not opt.is_amax(name) and p.grad is not None:
                    p.grad.div_(microbatches)
            for p, g in zip(amax, amax_acc):
                p.grad = g
        # A parameter the loss never read (the embedding table under an
        # embeddings input) has the reference's zero gradient.
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                 for n, p in params.items()}
        params, new_opt, om = opt.update(grads, state["opt"], params)
        metrics = {k: v.detach() if torch.is_tensor(v) else v
                   for k, v in metrics.items()}
        return ({"params": params, "opt": new_opt},
                {**metrics, **om, "loss": loss})

    return train_step


def make_prefill_step(model: LM | EncDec, max_len: int):
    """``prefill_step(inputs) -> (logits [B, V], cache)``: the prompt
    through :meth:`LM.prefill`, its cache sized ``max_len``; for an
    :class:`EncDec`, ``prefill_step(enc_embeds, dec_tokens)`` through
    :meth:`EncDec.prefill`."""
    if isinstance(model, EncDec):
        @torch.no_grad()
        def prefill_step(enc_embeds, dec_tokens):
            return model.prefill(enc_embeds, dec_tokens, max_len)
    else:
        @torch.no_grad()
        def prefill_step(inputs):
            return model.prefill(torch.as_tensor(inputs).to(model.device),
                                 max_len)
    return prefill_step


def make_decode_step(model: LM | EncDec):
    """``decode_step(token, cache) -> (logits [B, V], cache)``: one token
    a slot through the model's ``decode_step`` (either kind)."""
    @torch.no_grad()
    def decode_step(token, cache):
        return model.decode_step(torch.as_tensor(token).to(model.device),
                                 cache)
    return decode_step
