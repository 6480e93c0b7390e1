"""Memory-aware training planner: activation-stash accounting + budgets.

Port of ``src/repro/memory/planner.py``.  In tensorized training the
*activation* stash, not the weights, dominates the footprint.  The
planner answers two questions before any tensor is allocated:

1. **How many bytes does one training step keep alive?**
   :func:`stash_report` walks an :class:`~repro_torch.models.lm.LMConfig`
   and accounts every tensorized projection's residual under a
   :class:`~repro_torch.memory.stash.StashPolicy`, per layer and per
   microbatch, plus the per-layer boundary stash when ``recompute``
   rematerializes.

2. **How do I fit a budget?**  :func:`plan_microbatches` picks the
   smallest microbatch count (a divisor of the global batch) whose stash
   fits ``memory_budget``; the trainer wires it into gradient
   accumulation (``train --tnn-memory-budget ...``).

The same budget also rides into CSSE as ``SearchOptions.memory_budget``,
constraining each contraction plan's live-tensor working set
(:func:`repro_torch.core.perf_model.plan_peak_elems`).  The numbers are
the reference's: the same config gives the same bytes in both packages
(``tests/test_torch_memory.py``).  :func:`parse_budget` and
:func:`format_bytes` also serve the serving engine's admission control.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from repro_torch.memory.stash import STORE, StashPolicy

_UNITS = {"b": 1, "kb": 2 ** 10, "mb": 2 ** 20, "gb": 2 ** 30,
          "kib": 2 ** 10, "mib": 2 ** 20, "gib": 2 ** 30}


def parse_budget(value) -> int | None:
    """``"64MB"`` / ``"1.5gb"`` / ``4096`` / ``None`` -> bytes (binary
    units: 1MB == 2**20)."""
    if value is None:
        return None
    if isinstance(value, (int, float)):
        return int(value)
    m = re.fullmatch(r"\s*([0-9.]+)\s*([a-zA-Z]*)\s*", str(value))
    if not m:
        raise ValueError(f"cannot parse memory budget {value!r}")
    num, unit = float(m.group(1)), m.group(2).lower() or "b"
    if unit not in _UNITS:
        raise ValueError(f"unknown memory unit {unit!r} in {value!r} "
                         f"(expected one of {sorted(_UNITS)})")
    return int(num * _UNITS[unit])


def format_bytes(n: int) -> str:
    for unit, width in (("GB", 2 ** 30), ("MB", 2 ** 20), ("KB", 2 ** 10)):
        if n >= width:
            return f"{n / width:.2f}{unit}"
    return f"{n}B"


# ---------------------------------------------------------------------------
# Per-layer stash sites
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StashSite:
    """One tensorized projection's activation residual, per layer."""

    name: str                 # e.g. "mlp.down"
    elems_per_token: int      # input features stashed per token


def tnn_stash_sites(cfg) -> tuple[StashSite, ...]:
    """The tensorized projections of one layer of an LM config, as the
    reference counts them: ``targets`` names which projections are
    tensorized, and each tensorized layer stashes its *input*.  MoE
    experts are approximated at routed capacity (``top_k`` tokens per
    token; no ported config has ``moe`` yet); SSM mixers stash their
    ``d_model``-wide mixer inputs.  Dense projections stash nothing
    here."""
    tnn = getattr(cfg, "tnn", None)
    if tnn is None or not tnn.enabled:
        return ()
    targets = tnn.targets
    d_model = cfg.d_model
    sites: list[StashSite] = []
    block = getattr(cfg, "block", "attn")
    if block == "attn":
        if "mlp" in targets:
            moe = getattr(cfg, "moe", None)
            if moe is not None:
                k = moe.top_k
                sites += [
                    StashSite("moe.gate", k * d_model),
                    StashSite("moe.up", k * d_model),
                    StashSite("moe.down", k * moe.d_ff_expert),
                ]
            else:
                sites += [
                    StashSite("mlp.gate", d_model),
                    StashSite("mlp.up", d_model),
                    StashSite("mlp.down", cfg.d_ff),
                ]
        if "qkv" in targets:
            sites += [StashSite(f"attn.{n}", d_model) for n in "qkv"]
        if "out" in targets:
            sites.append(StashSite("attn.out", cfg.num_heads * cfg.hd))
    else:
        # rwkv6 / mamba2: "mix"-target projections read d_model-wide
        # inputs; the ffn half mirrors SwiGLU when targeted.
        if "mix" in targets:
            sites += [StashSite(f"{block}.mix{i}", d_model)
                      for i in range(4)]
        if "mlp" in targets and getattr(cfg, "d_ff", 0):
            sites += [
                StashSite("mlp.gate", d_model),
                StashSite("mlp.up", d_model),
                StashSite("mlp.down", cfg.d_ff),
            ]
    return tuple(sites)


# ---------------------------------------------------------------------------
# The report
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MemoryReport:
    """Deterministic activation-stash accounting for one train step."""

    stash: StashPolicy
    microbatches: int
    tokens_per_microbatch: int
    num_layers: int
    sites: tuple[StashSite, ...]
    site_bytes: tuple[int, ...]      # per site, per layer, per microbatch
    boundary_bytes: int              # per-layer checkpoint-boundary stash
    detail: dict = field(default_factory=dict)

    @property
    def layer_bytes(self) -> int:
        return sum(self.site_bytes) + self.boundary_bytes

    @property
    def peak_bytes(self) -> int:
        """All layers' stashes coexist at the forward -> backward
        turnaround (one microbatch in flight at a time under gradient
        accumulation): the peak the budget constrains."""
        return self.layer_bytes * self.num_layers

    def describe(self) -> str:
        lines = [f"stash policy {self.stash.tag()}: "
                 f"{self.num_layers} layers x "
                 f"{format_bytes(self.layer_bytes)} / layer "
                 f"({self.microbatches} microbatch(es) of "
                 f"{self.tokens_per_microbatch} tokens) -> peak "
                 f"{format_bytes(self.peak_bytes)}"]
        for site, nbytes in zip(self.sites, self.site_bytes):
            lines.append(f"  {site.name:12s} {format_bytes(nbytes)}")
        if self.boundary_bytes:
            lines.append(f"  {'boundary':12s} "
                         f"{format_bytes(self.boundary_bytes)}")
        return "\n".join(lines)


def stash_report(cfg, global_batch: int, seq_len: int,
                 microbatches: int = 1,
                 stash: StashPolicy = STORE,
                 shards: int = 1) -> MemoryReport:
    """Model the tensorized activation stash of one training step, per
    device.

    ``cfg`` is an LM config (``num_layers``, ``d_model``, ``tnn``,
    ``compute_dtype``).  Gradient accumulation splits the batch, so the
    per-microbatch tokens divide the stash by the microbatch count; under
    ``recompute`` the per-site stashes collapse to the per-layer boundary
    input the checkpoint keeps.  ``shards`` is the data-parallel factor:
    each device stashes only its batch slice (a non-dividing factor is
    treated as 1).
    """
    if global_batch % microbatches:
        raise ValueError(f"global batch {global_batch} does not split "
                         f"into {microbatches} microbatches")
    if shards > 1 and (global_batch // microbatches) % shards != 0:
        shards = 1
    tokens = (global_batch // microbatches // shards) * seq_len
    sites = tnn_stash_sites(cfg)
    site_bytes = tuple(
        stash.stash_bytes(tokens * s.elems_per_token, cfg.compute_dtype)
        for s in sites)
    boundary = 0
    if stash.mode == "recompute":
        boundary = tokens * cfg.d_model * cfg.compute_dtype.itemsize
    return MemoryReport(stash=stash, microbatches=microbatches,
                        tokens_per_microbatch=tokens,
                        num_layers=cfg.num_layers, sites=sites,
                        site_bytes=site_bytes, boundary_bytes=boundary,
                        detail={"global_batch": global_batch,
                                "seq_len": seq_len,
                                "shards": shards,
                                # scalar scale/amax metadata, kept out of
                                # the payload accounting
                                "meta_bytes": (stash.meta_bytes()
                                               * len(sites)
                                               * cfg.num_layers)})


def plan_microbatches(cfg, global_batch: int, seq_len: int,
                      memory_budget: int | None,
                      stash: StashPolicy = STORE,
                      at_least: int = 1,
                      shards: int = 1) -> tuple[int, MemoryReport]:
    """Smallest microbatch split (a divisor of ``global_batch``, >=
    ``at_least``) whose modeled per-device stash fits ``memory_budget``.

    With no budget the split is the smallest eligible divisor; with an
    unsatisfiable budget the maximal split (one sample per microbatch) is
    returned, and the report says what peak the caller will see (CSSE's
    budget degrades the same way: least infeasible, never an error).
    """
    divisors = [m for m in range(1, global_batch + 1)
                if global_batch % m == 0 and m >= at_least]
    if not divisors:
        # No divisor reaches the caller's floor (microbatches > batch):
        # clamp to the maximal split.
        divisors = [global_batch]
    if memory_budget is None:
        chosen = divisors[0]
        return chosen, stash_report(cfg, global_batch, seq_len, chosen,
                                    stash, shards)
    for m in divisors:
        report = stash_report(cfg, global_batch, seq_len, m, stash, shards)
        if report.peak_bytes <= memory_budget:
            return m, report
    return divisors[-1], report
