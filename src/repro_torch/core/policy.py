"""ExecutionPolicy — the one object describing how a contraction executes.

Port of ``src/repro/core/policy.py``.  :class:`ExecutionPolicy` is a
frozen dataclass carrying every planning axis (sequence search, fusion,
tile sweep, mesh, precision, stash/memory budget, serving phase); it
validates on construction (:class:`PolicyError` names the offending
field), serialises, and produces the one cache signature the CSSE winner
cache keys on.  ``search_options`` is the legacy ``SearchOptions`` view
the search layer consumes.

Not ported: the pipeline axis (``perf_model.PipelineSpec``), which
belongs to the distributed slice, and the JSON / legacy-kwargs
serialisation, which only the joint search uses (ROADMAP.md, queue A).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field

from repro_torch.core import perf_model
from repro_torch.memory.stash import STORE, StashPolicy
from repro_torch.precision.policy import QuantPolicy

#: stage-2 objectives the search layer understands
OBJECTIVES = ("latency", "energy", "edp", "flops", "measured")

#: stage-1 engines (auto picks dfs below dfs_max_nodes, dp above)
ENGINES = ("auto", "dfs", "dp")

#: tile-sweep strategies of the autotuner (docs/SEARCH.md)
SWEEP_STRATEGIES = ("full", "halving")


class PolicyError(ValueError):
    """An ExecutionPolicy (or legacy SearchOptions) field failed
    validation.  ``field`` names the offending field — the typed error
    the planning layers raise *at construction*, instead of the deep
    perf_model repricing failures an invalid policy used to cause."""

    def __init__(self, field_name: str, message: str):
        self.field = field_name
        super().__init__(f"{field_name}: {message}")


def _validate(owner: str, *, objective, num_candidates, engine,
              dfs_max_nodes, mesh, precision, stash, memory_budget,
              tile_sweep, sweep_strategy, phase,
              max_chain_len=2) -> None:
    """Shared validator — ExecutionPolicy and the SearchOptions shim both
    funnel through here so the two surfaces can never drift."""
    def err(name, msg):
        raise PolicyError(f"{owner}.{name}", msg)

    if objective not in OBJECTIVES:
        err("objective", f"unknown objective {objective!r}; expected one "
            f"of {OBJECTIVES}")
    if engine not in ENGINES:
        err("engine", f"unknown engine {engine!r}; expected one of "
            f"{ENGINES}")
    if not isinstance(num_candidates, int) or num_candidates < 1:
        err("num_candidates", f"must be a positive int, got "
            f"{num_candidates!r}")
    if not isinstance(dfs_max_nodes, int) or dfs_max_nodes < 1:
        err("dfs_max_nodes", f"must be a positive int, got "
            f"{dfs_max_nodes!r}")
    if mesh is not None and not isinstance(mesh, perf_model.MeshSpec):
        err("mesh", f"expected a perf_model.MeshSpec or None, got "
            f"{type(mesh).__name__} (a live device mesh must be mirrored first)")
    if precision is not None and not isinstance(precision, QuantPolicy):
        err("precision", f"expected a repro_torch.precision.QuantPolicy or "
            f"None, got {type(precision).__name__}")
    if not isinstance(stash, StashPolicy):
        err("stash", f"expected a repro_torch.memory.StashPolicy, got "
            f"{type(stash).__name__}")
    if memory_budget is not None and (
            not isinstance(memory_budget, int) or memory_budget <= 0):
        err("memory_budget", f"must be a positive byte count or None, "
            f"got {memory_budget!r}")
    if (not isinstance(tile_sweep, tuple) or not tile_sweep
            or not all(isinstance(t, int) and t > 0 for t in tile_sweep)):
        err("tile_sweep", f"must be a non-empty tuple of positive tile "
            f"sizes, got {tile_sweep!r}")
    if sweep_strategy not in SWEEP_STRATEGIES:
        err("sweep_strategy", f"unknown strategy {sweep_strategy!r}; "
            f"expected one of {SWEEP_STRATEGIES}")
    if not isinstance(phase, str):
        err("phase", f"must be a string tag, got {type(phase).__name__}")
    if not isinstance(max_chain_len, int) or max_chain_len < 2:
        err("max_chain_len", f"must be an int >= 2 (2 = historical "
            f"pairwise fusion), got {max_chain_len!r}")


@dataclass(frozen=True)
class ExecutionPolicy:
    """Every knob of one contraction execution, one frozen object.

    Field groups mirror the planning axes (docs/SEARCH.md):

    * **sequence** — ``objective`` / ``num_candidates`` / ``engine`` /
      ``dfs_max_nodes`` / ``allow_outer`` / ``anchor_input``: the CSSE
      two-stage search space and stage-2 metric.
    * **fusion** — ``fused_chain``: stage 2 models (and the compiler
      emits) on-chip chain execution; ``max_chain_len`` caps how
      many links one megakernel chain may fuse (2 = the historical
      pairwise fusion).
    * **tile** — ``tile_sweep`` / ``sweep_strategy`` /
      ``measure_dtype``: the autotuner's per-step grid and how it is
      swept (``full`` exhaustive vs ``halving`` successive-halving).
    * **mesh** — ``mesh``: the pure :class:`perf_model.MeshSpec` mirror
      stage 2 prices collectives against.
    * **precision** — ``precision``: the :class:`QuantPolicy` both
      executors run under and every byte term reprices at.
    * **memory** — ``stash`` (fwd->bwd activation residual policy) and
      ``memory_budget`` (hard per-device peak constraint).
    * **phase** — serving's ``"prefill"``/``"decode"`` cache tag
      (``""`` = training).
    """

    # sequence axis
    objective: str = "edp"
    num_candidates: int = 8
    engine: str = "auto"
    dfs_max_nodes: int = 7
    allow_outer: bool = True
    anchor_input: bool = False
    # fusion axis
    fused_chain: bool = False
    max_chain_len: int = 2
    # tile axis
    tile_sweep: tuple[int, ...] = (128, 256, 512)
    sweep_strategy: str = "full"
    measure_dtype: str = "float32"
    # mesh axis
    mesh: perf_model.MeshSpec | None = None
    # precision axis
    precision: QuantPolicy = field(default_factory=QuantPolicy)
    # memory axis
    stash: StashPolicy = STORE
    memory_budget: int | None = None
    # execution phase tag
    phase: str = ""

    def __post_init__(self):
        _validate("ExecutionPolicy", objective=self.objective,
                  num_candidates=self.num_candidates, engine=self.engine,
                  dfs_max_nodes=self.dfs_max_nodes, mesh=self.mesh,
                  precision=self.precision, stash=self.stash,
                  memory_budget=self.memory_budget,
                  tile_sweep=self.tile_sweep,
                  sweep_strategy=self.sweep_strategy, phase=self.phase,
                  max_chain_len=self.max_chain_len)

    # -- derived ------------------------------------------------------------

    @property
    def quantized(self) -> bool:
        return self.precision.quantized

    @property
    def quant_policy(self) -> QuantPolicy | None:
        """The legacy ``policy=`` kwarg value: None when unquantized (the
        bf16 policy is byte-identical to the historical path)."""
        return self.precision if self.precision.quantized else None

    # -- the one cache signature --------------------------------------------

    def signature_payload(self) -> dict:
        """Hash-stable JSON payload of every axis — THE per-policy cache
        fragment.  ``csse`` composes it with the network and hardware
        model; nothing else re-derives per-axis signature pieces."""
        return {
            "sequence": (self.objective, self.num_candidates, self.engine,
                         self.dfs_max_nodes, self.allow_outer,
                         self.anchor_input),
            "fused_chain": self.fused_chain,
            "tile": (list(self.tile_sweep), self.sweep_strategy,
                     self.measure_dtype),
            # Pairwise (the historical default) hashes as the absent key,
            # so pre-megakernel cache entries stay valid.
            **({"max_chain_len": self.max_chain_len}
               if self.max_chain_len != 2 else {}),
            "mesh": (None if self.mesh is None
                     else list(self.mesh.signature_payload())),
            # bf16 hashes as None: byte-identical to the historical
            # unquantized path, so pre-policy cache entries stay valid.
            "precision": (None if not self.precision.quantized
                          else list(self.precision.signature_payload())),
            "stash": self.stash.tag(),
            "memory_budget": self.memory_budget,
            "phase": self.phase,
        }

    def signature(self) -> str:
        return hashlib.sha256(json.dumps(
            self.signature_payload(), sort_keys=True,
            default=str).encode()).hexdigest()

    def search_options(self):
        """The legacy ``csse.SearchOptions`` view of this policy (lazy
        import — csse imports this module at top level)."""
        from repro_torch.core import csse
        return csse.SearchOptions(
            objective=self.objective, num_candidates=self.num_candidates,
            engine=self.engine, dfs_max_nodes=self.dfs_max_nodes,
            fused_chain=self.fused_chain,
            max_chain_len=self.max_chain_len,
            allow_outer=self.allow_outer,
            anchor_input=self.anchor_input,
            measure_dtype=self.measure_dtype, mesh=self.mesh,
            policy=self.quant_policy, memory_budget=self.memory_budget,
            phase=self.phase)
