"""Deterministic synthetic LM data.

Port of ``src/repro/data/pipeline.py`` (:class:`DataConfig`,
:class:`SyntheticLM`) in numpy: batches are a pure function of (seed,
step, host slice), drawn with the same numpy generators in the same
order as the reference, so they are bit-equal to its batches.  With
``embed_dim`` set (embeddings-input architectures: ``llava_next_34b``)
``inputs`` are deterministic f32 pseudo-embeddings ``[rows, T,
embed_dim]`` drawn after the ids, as the reference draws them.  The
multi-host ``make_global_batch`` waits for the distributed slice
(ROADMAP.md, queue A item 8).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "ngram"          # ngram | uniform
    embed_dim: int | None = None  # set for embeds-input archs (vlm/audio)


class SyntheticLM:
    """Synthetic corpus: Zipf unigrams + a deterministic bigram successor
    table, giving learnable structure (bigram entropy << unigram)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        # Each token has 8 plausible successors (deterministic table).
        self.successors = rng.integers(0, v, size=(v, 8), dtype=np.int32)

    def _tokens(self, rng: np.random.Generator, n: int) -> np.ndarray:
        cfg = self.cfg
        out = np.empty(n, dtype=np.int32)
        out[0] = rng.choice(cfg.vocab, p=self.unigram)
        # With p = 0.8 follow the successor table, else resample from the
        # unigram.
        follow = rng.random(n) < 0.8
        fresh = rng.choice(cfg.vocab, size=n, p=self.unigram)
        pick = rng.integers(0, 8, size=n)
        for i in range(1, n):
            out[i] = (self.successors[out[i - 1], pick[i]]
                      if follow[i] else fresh[i])
        return out

    def batch(self, step: int, *, host_index: int = 0, host_count: int = 1
              ) -> dict[str, np.ndarray]:
        """The host-local slice of global batch ``step`` (pure function)."""
        cfg = self.cfg
        if cfg.global_batch % host_count:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {host_count} hosts")
        rows = cfg.global_batch // host_count
        rng = np.random.default_rng((cfg.seed, step, host_index))
        if cfg.kind == "uniform":
            toks = rng.integers(0, cfg.vocab,
                                size=(rows, cfg.seq_len + 1), dtype=np.int32)
        else:
            toks = np.stack([self._tokens(np.random.default_rng(
                (cfg.seed, step, host_index, r)), cfg.seq_len + 1)
                for r in range(rows)])
        batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
        if cfg.embed_dim:
            # embeds-input archs: deterministic pseudo-embeddings
            rngf = np.random.default_rng((cfg.seed, step, host_index, 10**6))
            batch["inputs"] = rngf.standard_normal(
                (rows, cfg.seq_len, cfg.embed_dim)).astype(np.float32) * 0.02
        return batch
