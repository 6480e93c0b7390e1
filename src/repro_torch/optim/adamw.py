"""AdamW with decoupled weight decay, global-norm clipping and LR schedule.

Port of ``src/repro/optim/adamw.py`` over named parameters (the port's
state dict names, :mod:`repro_torch.convert`).  The state mirrors the
reference's ``OptState(m, v, step, master)`` with dicts keyed by
parameter name.  Unlike the reference, whose arrays are immutable,
:meth:`AdamW.update` writes the new parameters, moments and master copies
into the existing tensors in place (one copy of each instead of two).
The scalar arithmetic (schedule, bias corrections) runs on f32 scalars
like the reference's.

* ``loss_scale`` — the train step scales the loss by it
  (:mod:`repro_torch.launch.steps`); the gradients are divided back here
  before the norm, clipping and moments.
* ``master_weights`` — f32 master copies in the state; the parameter
  becomes a cast of the updated master.
* ``moment_dtype`` — the storage dtype of m and v.
* ``quant_amax`` passthrough — a parameter named ``...quant_amax`` is a
  quantized layer's delayed-scaling history, and its gradient is the
  state delta ``hist - new_hist``: it updates as ``p - g`` and takes no
  part in loss-scale unscaling, the grad norm, clipping, the moments or
  weight decay.

**Weight decay follows the reference's rule on the reference's leaves**:
decay where ``p.ndim >= 2``, read on its *stacked* ``[L, ...]`` per-layer
leaves.  The port keeps per-layer tensors, so a per-layer ``ln1.scale``
is ``[d]`` here but ``[L, d]`` there, and is decayed;
:func:`repro_torch.convert.reference_ndim` counts the layer axis back in.

Not ported: ``chunk_threshold`` (an XLA lowering knob).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch.profiler import record_function

from repro_torch.convert import reference_ndim
from repro_torch.precision.policy import AMAX_KEY


class OptState(NamedTuple):
    m: dict                    # name -> first moment (moment_dtype)
    v: dict                    # name -> second moment (moment_dtype)
    step: torch.Tensor         # [] int32, on the CPU
    master: dict | None = None  # name -> f32 weight copy


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moment_dtype: torch.dtype = torch.float32
    loss_scale: float = 1.0
    master_weights: bool = False

    def init(self, params: dict[str, torch.Tensor]) -> OptState:
        def zeros():
            return {n: torch.zeros(p.shape, dtype=self.moment_dtype,
                                   device=p.device)
                    for n, p in params.items()}
        master = ({n: p.detach().float().clone() for n, p in params.items()}
                  if self.master_weights else None)
        return OptState(m=zeros(), v=zeros(),
                        step=torch.zeros((), dtype=torch.int32),
                        master=master)

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        """Linear warm-up to ``lr``, then cosine decay to
        ``lr * min_lr_ratio`` at ``total_steps`` (f32 scalars)."""
        step = step.to(torch.float32)
        warm = torch.clamp(step / max(self.warmup_steps, 1), max=1.0)
        frac = torch.clamp((step - self.warmup_steps)
                           / max(self.total_steps - self.warmup_steps, 1),
                           0, 1)
        cos = 0.5 * (1 + torch.cos(math.pi * frac))
        decay = self.min_lr_ratio + (1 - self.min_lr_ratio) * cos
        return self.lr * warm * decay

    @staticmethod
    def is_amax(name: str) -> bool:
        """Whether ``name`` is a delayed-scaling amax history (the
        reference's ``_path_has_amax``: any path key is ``quant_amax``)."""
        return AMAX_KEY in name.split(".")

    @staticmethod
    def decays(name: str, p: torch.Tensor) -> bool:
        """The reference's ``p.ndim >= 2`` on its stacked leaves."""
        return reference_ndim(name, p) >= 2

    @torch.no_grad()
    def update(self, grads: dict[str, torch.Tensor], state: OptState,
               params: dict[str, torch.Tensor]
               ) -> tuple[dict, OptState, dict]:
        """One step; updates ``params`` and the moments in place and
        returns ``(params, new_state, {"grad_norm", "lr"})``.  Runs in a
        ``torch.profiler`` range ``optim.update``."""
        with record_function("optim.update"):
            return self._update(grads, state, params)

    def _update(self, grads, state, params):
        names = list(params)
        if set(grads) != set(names):
            raise ValueError("gradients and parameters name different "
                             f"tensors: {sorted(set(grads) ^ set(names))}")
        flat_g = [grads[n] for n in names]
        amax = [self.is_amax(n) for n in names]
        # Unscale first (loss scaling), except the amax passthrough
        # leaves, whose "gradient" is a state delta.
        if self.loss_scale != 1.0:
            inv_ls = 1.0 / self.loss_scale
            flat_g = [g if a else g.float() * inv_ls
                      for g, a in zip(flat_g, amax)]
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g, a in zip(flat_g, amax) if not a))
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        step = state.step + 1
        lr = self.schedule(step)
        b1c = 1 - _f32(self.b1) ** step.to(torch.float32)
        b2c = 1 - _f32(self.b2) ** step.to(torch.float32)
        for n, g, a in zip(names, flat_g, amax):
            p, m, v = params[n], state.m[n], state.v[n]
            master = state.master[n] if state.master is not None else None
            if a:
                # Delayed-scaling state channel: g = hist - new_hist, so
                # the plain step with lr 1 is the state update.
                new = (p.float() - g.float()).to(p.dtype)
                p.copy_(new)
                if master is not None:
                    master.copy_(new.float())
                continue
            src = p if master is None else master
            g = g.float() * scale
            m32 = self.b1 * m.float() + (1 - self.b1) * g
            v32 = self.b2 * v.float() + (1 - self.b2) * g * g
            mhat = m32 / b1c          # 0-d CPU scalars broadcast on any
            vhat = v32 / b2c          # device without a copy
            delta = mhat / (torch.sqrt(vhat) + self.eps)
            if self.decays(n, p):
                delta = delta + self.weight_decay * src.float()
            new_master = src.float() - lr * delta
            p.copy_(new_master.to(p.dtype))
            m.copy_(m32.to(self.moment_dtype))
            v.copy_(v32.to(self.moment_dtype))
            if master is not None:
                master.copy_(new_master)
        return params, state._replace(step=step), {"grad_norm": gnorm,
                                                   "lr": lr}
