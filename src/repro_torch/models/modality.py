"""Modality frontend stubs: synthetic patch and frame embeddings.

Port of ``src/repro/models/modality.py``.  The ``[vlm]`` and ``[audio]``
architectures specify the transformer backbone only; the frontend
provides precomputed ``[B, S, d_model]`` embeddings.  These helpers draw
deterministic synthetic ones for smoke runs: ``N(0, 1) * 0.02`` in f32,
then cast to ``dtype``, from an explicit :class:`torch.Generator` (the
streams differ from ``jax.random``'s by design), and placed on
``device``.  A real deployment would swap in a ViT or speech encoder
producing the same interface.  The reference's ``embedding_spec`` (a
dry-run ``ShapeDtypeStruct``) waits for the dry run (ROADMAP.md, queue A
item 9).
"""

from __future__ import annotations

import torch


def _embeddings(generator: torch.Generator, shape: tuple, dtype, device
                ) -> torch.Tensor:
    x = torch.randn(shape, generator=generator, dtype=torch.float32) * 0.02
    return x.to(device=device, dtype=dtype)


def patch_embeddings(generator: torch.Generator, batch: int, seq: int,
                     d_model: int, dtype=torch.bfloat16, device="cuda"
                     ) -> torch.Tensor:
    """LLaVA-style anyres vision stub: ``seq`` patch embeddings per
    sample (the anyres tiling decides how many patches exist; here
    ``seq`` already counts them)."""
    return _embeddings(generator, (batch, seq, d_model), dtype, device)


def frame_embeddings(generator: torch.Generator, batch: int, frames: int,
                     d_model: int, dtype=torch.bfloat16, device="cuda"
                     ) -> torch.Tensor:
    """Speech frontend stub: ``frames`` acoustic frame embeddings."""
    return _embeddings(generator, (batch, frames, d_model), dtype, device)
