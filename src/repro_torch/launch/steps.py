"""Model builders shared by the launchers.

Part-port of ``src/repro/launch/steps.py``: :func:`build_model`.  The
training and dry-run step builders arrive with their slices (ROADMAP.md,
queue A).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig
from repro_torch.core.tensorized import TNNConfig
from repro_torch.models.lm import LM


def build_model(arch: ArchConfig, tnn: TNNConfig | None = None,
                smoke: bool = False, *, device="cuda", seed: int = 0,
                backend: str | None = None, compute_dtype=None):
    """``(model, cfg)`` for ``arch``: its published config (or the smoke
    one), random weights from ``seed`` on ``device``.  ``backend``
    overrides the TNN executor (``einsum`` | ``cuda`` | ``pallas``) and
    ``compute_dtype`` the model's compute dtype."""
    if arch.model_kind != "lm":
        raise NotImplementedError(f"model kind {arch.model_kind!r} is not "
                                  "ported yet (ROADMAP.md, queue A)")
    cfg = arch.smoke(tnn) if smoke else arch.model(tnn)
    if backend is not None:
        cfg = dataclasses.replace(
            cfg, tnn=dataclasses.replace(cfg.tnn, backend=backend))
    if compute_dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    return LM(cfg, device=device, seed=seed), cfg
