"""CSSE — Contraction Sequence Search Engine (paper §IV, Algorithm 1).

Port of ``src/repro/core/csse.py``.  Two-stage search over contraction
sequences of a tensor network:

* **Stage 1** enumerates sequences under the cheap FLOPs metric and keeps
  the best ``num_candidates`` — ``dfs`` (the paper's Algorithm 1:
  exhaustive depth-first recursion with accumulated-FLOPs
  branch-and-bound) or ``dp`` (exact k-best dynamic programming over node
  subsets, for larger networks).
* **Stage 2** reranks the candidates under the analytic performance model
  (:mod:`repro_torch.core.perf_model`, H100 by default) on the requested
  objective (``latency`` / ``energy`` / ``edp`` / ``flops``).  With
  ``memory_budget`` set, the modeled live-tensor peak is a hard
  constraint.

The algorithm, signature and cache semantics are the reference's, so a
search with the same :class:`~repro_torch.core.perf_model.HardwareModel`
values picks the same tree in both packages.  Results are memoised
in-process and on disk under ``$REPRO_CSSE_CACHE/torch`` when that
variable is set (the test session points it at a temporary directory),
else under ``.cache/csse_torch/`` at the repository root.

Not ported yet: ``objective="measured"`` (stage 2 priced by the
autotuner), which arrives with the autotune slice (ROADMAP.md, queue A).
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import dataclass, field

from repro_torch import telemetry as tm
from repro_torch.core import perf_model
from repro_torch.core.policy import ExecutionPolicy, PolicyError, _validate
from repro_torch.core.tnetwork import (
    ContractionPlan, TensorNetwork, TreeT, canonical_tree, plan_from_tree,
    tree_leaves,
)
from repro_torch.memory.stash import STORE
from repro_torch.precision.policy import QuantPolicy

_DEFAULT_CACHE_DIR = os.path.join(os.path.dirname(__file__), "..", "..",
                                  "..", ".cache", "csse_torch")
#: memo entries are (perf_model.MODEL_VERSION at store time, result) so a
#: model-semantics change invalidates observably even in-process
_MEMO: dict[str, tuple[int, "SearchResult"]] = {}

#: Winner-cache counters, the CSSE analog of ``Tuner.stats`` (same
#: always-on dict convention): every ``search`` call lands in exactly one
#: of memo_hits / disk_hits / misses, and ``invalidations`` additionally
#: counts entries dropped because they were ranked under a different
#: ``perf_model.MODEL_VERSION``.  A snapshot is surfaced in every
#: ``SearchResult.stats["cache_stats"]``; mirrored into telemetry
#: counters (``csse.cache.*``) when tracing is enabled.
CACHE_STATS = {"memo_hits": 0, "disk_hits": 0, "misses": 0,
               "invalidations": 0}


def _count(kind: str) -> None:
    CACHE_STATS[kind] += 1
    tm.inc(f"csse.cache.{kind}")


def _cache_dir() -> str:
    """Resolved per call so tests (and operators) can repoint
    ``REPRO_CSSE_CACHE`` after import; the port keeps its own ``torch``
    subdirectory there, so its entries never mix with the reference's."""
    root = os.environ.get("REPRO_CSSE_CACHE")
    return os.path.join(root, "torch") if root else _DEFAULT_CACHE_DIR


@dataclass(frozen=True)
class SearchOptions:
    objective: str = "edp"    # stage-2: latency|energy|edp|flops|measured
    num_candidates: int = 8           # paper's N
    engine: str = "auto"              # auto|dfs|dp
    dfs_max_nodes: int = 7            # auto: dfs up to here, dp beyond
    fused_chain: bool = False         # stage-2 models fused chain kernels
    max_chain_len: int = 2            # megakernel chain-length cap stage 2
                                      # prices and the compiler emits
                                      # (2 = historical pairwise fusion)
    allow_outer: bool = True          # enlarged space (paper); False = Tetrix-ish
    anchor_input: bool = False        # True = Tetrix-style: X merges every step
    measure_dtype: str = "float32"    # objective="measured": operand dtype
                                      # the tuner times (match the executor's
                                      # compute dtype so rankings and tile
                                      # caches describe what actually runs)
    mesh: perf_model.MeshSpec | None = None
                                      # communication-aware stage 2: rank by
                                      # per-device compute+memory at sharded
                                      # step shapes plus the deferred-psum
                                      # collective term (both analytic and
                                      # measured objectives)
    policy: object = None             # quantization policy (repro_torch.precision.
                                      # QuantPolicy): stage 2 prices every
                                      # byte term at the policy's storage
                                      # width (fp8/int8 halve HBM + ICI), and
                                      # measured searches time the quantized
                                      # kernels — a new axis candidates can
                                      # flip winners over
    memory_budget: int | None = None  # peak-footprint constraint (bytes,
                                      # per device): stage 2 drops every
                                      # candidate whose modeled live-tensor
                                      # peak (perf_model.plan_peak_elems x
                                      # policy width / mesh factors) exceeds
                                      # it and ranks the survivors by the
                                      # objective; with no feasible
                                      # candidate the minimum-peak sequence
                                      # wins (documented degradation, never
                                      # an error) — docs/MEMORY.md
    phase: str = ""                   # execution-phase tag ("" = training;
                                      # serving uses "prefill"/"decode").
                                      # Enters every cache signature so the
                                      # phase-specialized serving profiles
                                      # (repro_torch.serving.profiles) resolve
                                      # their own memo/disk/measurement
                                      # entries: prefill's long-sequence
                                      # GEMMs and decode's batch-wide GEMVs
                                      # must never share winners even when
                                      # their network shapes collide.

    def __post_init__(self):
        # Validate at construction with the typed, field-naming error —
        # an invalid policy used to surface only deep inside perf_model
        # repricing (apply_policy touching .dtype_bytes on a non-policy).
        if self.policy is not None and not isinstance(self.policy,
                                                      QuantPolicy):
            raise PolicyError(
                "SearchOptions.policy",
                f"expected a repro_torch.precision.QuantPolicy or None, got "
                f"{type(self.policy).__name__}")
        _validate("SearchOptions", objective=self.objective,
                  num_candidates=self.num_candidates, engine=self.engine,
                  dfs_max_nodes=self.dfs_max_nodes, mesh=self.mesh,
                  precision=self.policy, stash=STORE,
                  memory_budget=self.memory_budget,
                  tile_sweep=(128,), sweep_strategy="full",
                  phase=self.phase, max_chain_len=self.max_chain_len)

    # -- ExecutionPolicy interop (the unified surface, docs/SEARCH.md) ------

    @classmethod
    def from_policy(cls, xp: ExecutionPolicy) -> "SearchOptions":
        """The sequence-search view of a unified ExecutionPolicy."""
        return xp.search_options()

    def to_policy(self, **overrides) -> ExecutionPolicy:
        """Lift these options into the unified ExecutionPolicy (tile/stash
        axes at their defaults unless overridden)."""
        kw = dict(objective=self.objective,
                  num_candidates=self.num_candidates, engine=self.engine,
                  dfs_max_nodes=self.dfs_max_nodes,
                  fused_chain=self.fused_chain,
                  max_chain_len=self.max_chain_len,
                  allow_outer=self.allow_outer,
                  anchor_input=self.anchor_input,
                  measure_dtype=self.measure_dtype, mesh=self.mesh,
                  precision=self.policy or QuantPolicy(),
                  memory_budget=self.memory_budget, phase=self.phase)
        kw.update(overrides)
        return ExecutionPolicy(**kw)


OptsT = "SearchOptions | ExecutionPolicy"


def _as_options(opts) -> SearchOptions:
    """Public entry points accept either surface."""
    if isinstance(opts, ExecutionPolicy):
        return SearchOptions.from_policy(opts)
    return opts


@dataclass
class SearchResult:
    tree: TreeT
    plan: ContractionPlan
    cost: perf_model.PlanCost
    candidates: list[tuple[int, TreeT]]          # stage-1 (flops, tree)
    stage2_costs: list[tuple[float, TreeT]]      # (objective value, tree)
    stats: dict = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Bitmask scaffolding shared by both engines
# ---------------------------------------------------------------------------


class _Graph:
    """Bitmask view of a TensorNetwork for fast subset algebra."""

    def __init__(self, net: TensorNetwork):
        self.net = net
        axes = sorted({a for node in net.nodes for a in node})
        self.axis_bit = {a: i for i, a in enumerate(axes)}
        self.axis_size = [net.sizes[a] for a in axes]
        self.node_mask = [
            self._mask(node) for node in net.nodes
        ]
        self.out_mask = self._mask([a for a in net.output if a in self.axis_bit])
        self.K = len(net.nodes)
        self.full = (1 << self.K) - 1
        # union of node axis masks per node subset, computed lazily
        self._union: dict[int, int] = {0: 0}
        self._prod: dict[int, int] = {0: 1}

    def _mask(self, axes) -> int:
        m = 0
        for a in axes:
            m |= 1 << self.axis_bit[a]
        return m

    def union(self, subset: int) -> int:
        got = self._union.get(subset)
        if got is not None:
            return got
        low = subset & -subset
        m = self.union(subset ^ low) | self.node_mask[low.bit_length() - 1]
        self._union[subset] = m
        return m

    def prod(self, axis_mask: int) -> int:
        got = self._prod.get(axis_mask)
        if got is not None:
            return got
        low = axis_mask & -axis_mask
        p = self.prod(axis_mask ^ low) * self.axis_size[low.bit_length() - 1]
        self._prod[axis_mask] = p
        return p

    def live(self, subset: int) -> int:
        """Axis mask of the tensor produced by contracting ``subset``."""
        outside = self.union(self.full ^ subset) | self.out_mask
        return self.union(subset) & outside

    def pair_flops(self, live_a: int, live_b: int) -> int:
        return 2 * self.prod(live_a | live_b)

    def connected(self, live_a: int, live_b: int) -> bool:
        return bool(live_a & live_b)


# ---------------------------------------------------------------------------
# Stage 1 — DFS (paper Algorithm 1)
# ---------------------------------------------------------------------------


def _dfs_candidates(g: _Graph, opts: SearchOptions) -> list[tuple[int, TreeT]]:
    """Exhaustive DFS with accumulated-FLOPs branch-and-bound (Alg. 1)."""
    best: list[tuple[int, str, TreeT]] = []     # (flops, key, tree) heap-ish
    seen_keys: set[str] = set()
    N = opts.num_candidates

    # Seed the bound with a greedy solution so pruning bites immediately.
    greedy = _greedy_tree(g, opts)
    if greedy is not None:
        flops, tree = greedy
        key = repr(canonical_tree(tree))
        best.append((flops, key, tree))
        seen_keys.add(key)

    def worst() -> int:
        return best[-1][0] if len(best) >= N else (1 << 62)

    def insert(flops: int, tree: TreeT):
        key = repr(canonical_tree(tree))
        if key in seen_keys:
            return
        seen_keys.add(key)
        best.append((flops, key, tree))
        best.sort(key=lambda x: x[0])
        del best[N:]

    stats = {"visited": 0, "pruned": 0}

    def recurse(nodes: list[tuple[int, int, TreeT]], acc: int):
        # nodes: list of (subset_mask, live_axis_mask, tree)
        stats["visited"] += 1
        if len(nodes) == 1:
            if acc < worst():
                insert(acc, nodes[0][2])
            return
        n = len(nodes)
        pairs = []
        for i in range(n):
            for j in range(i + 1, n):
                if opts.anchor_input and 0 not in (i, j):
                    continue   # Tetrix-style: input node anchors every merge
                la, lb = nodes[i][1], nodes[j][1]
                if not opts.allow_outer and not g.connected(la, lb):
                    continue
                pairs.append((g.pair_flops(la, lb), i, j))
        pairs.sort()
        for cost, i, j in pairs:
            new_acc = acc + cost
            if new_acc >= worst():
                # pairs are sorted: every later pair at this level costs more,
                # but deeper completions might still beat — cannot break the
                # whole loop, only skip (bound is on the *accumulated* cost,
                # which is monotone along a path).
                stats["pruned"] += 1
                continue
            sub = nodes[i][0] | nodes[j][0]
            merged = (sub, g.live(sub), (nodes[i][2], nodes[j][2]))
            rest = [merged if k == i else nodes[k]
                    for k in range(n) if k != j]
            # keep merged node at position 0 when anchoring on the input
            if opts.anchor_input:
                rest = [merged] + [x for x in rest if x is not merged]
            recurse(rest, new_acc)

    leaves = [(1 << i, g.live(1 << i), i) for i in range(g.K)]
    recurse(leaves, 0)
    return [(f, t) for f, _, t in best], stats


def _greedy_tree(g: _Graph, opts: SearchOptions) -> tuple[int, TreeT] | None:
    """Cheapest-pair-first greedy; seeds the DFS bound."""
    nodes: list[tuple[int, int, TreeT]] = [
        (1 << i, g.live(1 << i), i) for i in range(g.K)]
    total = 0
    while len(nodes) > 1:
        best = None
        n = len(nodes)
        for i in range(n):
            for j in range(i + 1, n):
                la, lb = nodes[i][1], nodes[j][1]
                if not opts.allow_outer and not g.connected(la, lb):
                    continue
                c = g.pair_flops(la, lb)
                if best is None or c < best[0]:
                    best = (c, i, j)
        if best is None:
            return None
        c, i, j = best
        total += c
        sub = nodes[i][0] | nodes[j][0]
        merged = (sub, g.live(sub), (nodes[i][2], nodes[j][2]))
        nodes = [merged] + [nodes[k] for k in range(n) if k not in (i, j)]
    return total, nodes[0][2]


# ---------------------------------------------------------------------------
# Stage 1 — exact k-best subset DP (beyond paper)
# ---------------------------------------------------------------------------


def _dp_candidates(g: _Graph, opts: SearchOptions) -> list[tuple[int, TreeT]]:
    """k-best contraction trees by total FLOPs via subset DP.

    cand[S] holds up to k (flops, tree) pairs for fully contracting subset S.
    Splits iterate A ∋ lowbit(S) over proper submasks — every unordered
    partition once.  Complexity O(3^K · k^2); exact within the full enlarged
    space (outer products = disconnected splits are included).
    """
    K, full = g.K, g.full
    k = max(1, opts.num_candidates)
    cand: list[list[tuple[int, TreeT]]] = [[] for _ in range(full + 1)]
    for i in range(K):
        cand[1 << i] = [(0, i)]

    # Enumerate subsets in increasing popcount order.
    by_pop: list[list[int]] = [[] for _ in range(K + 1)]
    for s in range(1, full + 1):
        by_pop[s.bit_count()].append(s)

    live = [0] * (full + 1)
    for s in range(1, full + 1):
        live[s] = g.live(s)

    for pop in range(2, K + 1):
        for S in by_pop[pop]:
            low = S & -S
            rest = S ^ low
            out: list[tuple[int, TreeT]] = []
            seen: set[str] = set()
            # iterate submasks T of rest; A = low | T, B = S \ A
            T = rest
            while True:
                A = low | T
                B = S ^ A
                if B:
                    ca, cb = cand[A], cand[B]
                    if ca and cb:
                        la, lb = live[A], live[B]
                        if opts.allow_outer or g.connected(la, lb):
                            step = g.pair_flops(la, lb)
                            for fa, ta in ca:
                                for fb, tb in cb:
                                    f = fa + fb + step
                                    if len(out) >= k and f >= out[-1][0]:
                                        continue
                                    tree = canonical_tree((ta, tb))
                                    key = repr(tree)
                                    if key in seen:
                                        continue
                                    seen.add(key)
                                    out.append((f, tree))
                                    out.sort(key=lambda x: x[0])
                                    del out[k:]
                if T == 0:
                    break
                T = (T - 1) & rest
            cand[S] = out
    return cand[full], {"subsets": full}


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def _signature(net: TensorNetwork, opts, hw: perf_model.HardwareModel) -> str:
    """THE cache key: network + the unified policy payload + hardware.

    Every per-axis fragment — mesh shape/device kind (a winner ranked for
    one mesh must never be served for another), quantization width (the
    policy reshapes every byte term the ranking weighed), memory budget
    (feasibility filtering can flip winners), execution phase
    (phase-specialized serving profiles resolve distinct entries even for
    identical networks) — is hashed through
    :meth:`ExecutionPolicy.signature_payload`, the one signature function
    of the planning stack.  Legacy ``SearchOptions`` lift through
    ``to_policy()`` first.
    """
    xp = opts if isinstance(opts, ExecutionPolicy) else opts.to_policy()
    payload = {
        "sizes": sorted(net.sizes.items()),
        "nodes": net.nodes, "output": net.output,
        "policy": xp.signature_payload(),
        "hw": (hw.name, hw.peak_flops, hw.hbm_bw, hw.dtype_bytes,
               hw.step_overhead_s, hw.ici_bw),
        # Winners are ranked BY the analytic model; when its semantics
        # change (e.g. the chain-elision predicate), every cached tree was
        # chosen under a model that no longer exists and must re-rank.
        # MODEL_VERSION is deliberately NOT part of this hash: it is
        # stored inside the memo/disk entries and checked at load, so a
        # version bump reads as an *observable invalidation*
        # (CACHE_STATS["invalidations"]) instead of a silent signature
        # miss that strands the stale entry on disk forever.
    }
    return hashlib.sha256(json.dumps(payload, default=str).encode()).hexdigest()


def plan_signature(net: TensorNetwork, opts=None,
                   hw: perf_model.HardwareModel = perf_model.H100_SXM) -> str:
    """Public cache key of a (network, policy, hardware) search — what the
    memo and the disk cache are keyed by.  ``opts`` is an
    :class:`ExecutionPolicy` or legacy :class:`SearchOptions` (default:
    ``SearchOptions()``).  Serving's phase profiles expose it so tests can
    assert that prefill and decode resolve *distinct* entries (``phase``
    is part of the key).  The quantization policy is applied to ``hw``
    first, mirroring what :func:`search` hashes."""
    if opts is None:
        opts = SearchOptions()
    quant = (opts.quant_policy if isinstance(opts, ExecutionPolicy)
             else opts.policy)
    return _signature(net, opts, perf_model.apply_policy(hw, quant))


def _valid_tree(tree, net: TensorNetwork) -> bool:
    try:
        leaves = tree_leaves(tree)
    except (TypeError, RecursionError):
        # RecursionError: a non-int leaf (e.g. a string, which iterates
        # into itself) from a hand-edited / partially-written entry.
        return False
    if not all(isinstance(x, int) for x in leaves):
        return False
    return sorted(leaves) == list(range(net.num_nodes))


def _disk_load(sig: str, net: TensorNetwork
               ) -> tuple[TreeT, list[tuple[int, TreeT]]] | None:
    """Load a cached winner plus its stage-1 candidate list; any
    corruption (bad JSON, wrong structure, a tree that does not cover the
    network) reads as a miss so the search falls through to a fresh run
    and overwrites the bad entry.  Candidates are best-effort: invalid
    entries are dropped rather than invalidating the winner — consumers
    like the joint search only use them to widen their sequence pool."""
    path = os.path.join(_cache_dir(), sig + ".json")
    try:
        with open(path) as f:
            payload = json.load(f)
        tree = _untuple(payload["tree"])
    except (OSError, ValueError, KeyError, TypeError):
        return None
    if payload.get("model_version") != perf_model.MODEL_VERSION:
        # Ranked under different model semantics: the tree may be valid
        # but the *choice* is stale — drop it (the fresh search
        # overwrites) and count the invalidation distinctly from a miss.
        _count("invalidations")
        return None
    if not _valid_tree(tree, net):
        return None
    candidates: list[tuple[int, TreeT]] = []
    try:
        for flops, cand in payload.get("candidates", []):
            cand = _untuple(cand)
            if isinstance(flops, int) and _valid_tree(cand, net):
                candidates.append((flops, cand))
    except (ValueError, TypeError):
        candidates = []
    return tree, candidates


def _disk_store(sig: str, tree: TreeT,
                candidates: list[tuple[int, TreeT]] | None = None) -> None:
    try:
        os.makedirs(_cache_dir(), exist_ok=True)
        path = os.path.join(_cache_dir(), sig + ".json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"tree": tree, "candidates": candidates or [],
                       "model_version": perf_model.MODEL_VERSION}, f)
        os.replace(tmp, path)
    except OSError:
        pass


def _untuple(x):
    return tuple(_untuple(v) for v in x) if isinstance(x, list) else x


def search(net: TensorNetwork, opts=None,
           hw: perf_model.HardwareModel = perf_model.H100_SXM
           ) -> SearchResult:
    """Run the two-stage CSSE on ``net`` and return the best plan.

    ``opts`` is an :class:`ExecutionPolicy` (the unified surface) or the
    legacy :class:`SearchOptions` view; default ``SearchOptions()``.  The
    cache signature always hashes the *full* policy.  Every call lands in
    exactly one :data:`CACHE_STATS` bucket and the returned
    ``stats["cache_stats"]`` carries the snapshot; with tracing enabled
    the whole search runs under a ``csse.search`` span.
    """
    if not tm.enabled():
        return _search_impl(net, opts, hw)
    probe = opts if opts is not None else SearchOptions()
    with tm.span("csse.search", nodes=net.num_nodes,
                 objective=getattr(probe, "objective", "edp"),
                 phase=getattr(probe, "phase", "")):
        return _search_impl(net, opts, hw)


def _search_impl(net: TensorNetwork, opts,
                 hw: perf_model.HardwareModel) -> SearchResult:
    sig_opts = opts if opts is not None else SearchOptions()
    opts = _as_options(sig_opts)
    hw = perf_model.apply_policy(hw, opts.policy)
    if opts.objective == "measured":
        raise NotImplementedError(
            "objective='measured' needs the autotuner, which is not ported "
            "yet (ROADMAP.md, queue A: autotune and joint search)")

    sig = _signature(net, sig_opts, hw)
    got = _MEMO.get(sig)
    if got is not None:
        ver, memo = got
        if ver == perf_model.MODEL_VERSION:
            _count("memo_hits")
            memo.stats["cache_stats"] = dict(CACHE_STATS)
            return memo
        # Ranked under superseded model semantics (a test or a reload
        # bumped MODEL_VERSION mid-process): observable invalidation.
        _count("invalidations")
        del _MEMO[sig]

    if net.num_nodes == 1:
        _count("misses")
        plan = plan_from_tree(net, 0)
        cost = perf_model.evaluate(plan, hw, fused_chain=opts.fused_chain,
                                   max_chain_len=opts.max_chain_len,
                                   mesh=opts.mesh)
        res = SearchResult(0, plan, cost, [(0, 0)], [(0.0, 0)],
                           {"cache_stats": dict(CACHE_STATS)})
        _MEMO[sig] = (perf_model.MODEL_VERSION, res)
        return res

    cached = _disk_load(sig, net)
    if cached is not None:
        _count("disk_hits")
        cached_tree, cached_cands = cached
        plan = plan_from_tree(net, cached_tree)
        cost = perf_model.evaluate(plan, hw,
                                   fused_chain=opts.fused_chain,
                                   max_chain_len=opts.max_chain_len,
                                   mesh=opts.mesh)
        res = SearchResult(cached_tree, plan, cost,
                           cached_cands
                           or [(plan.total_flops, cached_tree)],
                           [(cost.metric(opts.objective), cached_tree)],
                           {"cache": "disk",
                            "cache_stats": dict(CACHE_STATS)})
        _MEMO[sig] = (perf_model.MODEL_VERSION, res)
        return res

    _count("misses")
    g = _Graph(net)
    t0 = time.perf_counter()
    engine = opts.engine
    if engine == "auto":
        engine = "dfs" if g.K <= opts.dfs_max_nodes else "dp"
    with tm.span("csse.stage1", engine=engine, nodes=g.K):
        if engine == "dfs":
            candidates, stats = _dfs_candidates(g, opts)
        elif engine == "dp":
            candidates, stats = _dp_candidates(g, opts)
        else:
            raise ValueError(f"unknown engine {engine!r}")
    stats = dict(stats)
    stats["engine"] = engine
    stats["stage1_s"] = time.perf_counter() - t0
    tm.inc("csse.stage1.candidates", len(candidates))
    tm.inc("csse.stage1.pruned", stats.get("pruned", 0))

    assert candidates, "stage 1 found no complete contraction sequence"

    # Stage 2: rerank under the hardware model.
    scored: list[tuple[float, TreeT, ContractionPlan, perf_model.PlanCost]] = []
    with tm.span("csse.stage2", candidates=len(candidates),
                 objective=opts.objective):
        for flops, tree in candidates:
            plan = plan_from_tree(net, tree)
            cost = perf_model.evaluate(plan, hw,
                                       fused_chain=opts.fused_chain,
                                       max_chain_len=opts.max_chain_len,
                                       mesh=opts.mesh)
            scored.append((cost.metric(opts.objective), tree, plan, cost))
    scored.sort(key=lambda x: x[0])
    # Memory budget: a hard constraint, not a tiebreak.  Rank only the
    # candidates whose modeled peak fits; when nothing fits, degrade to the
    # minimum-peak sequence (the least-infeasible plan) and say so in stats.
    chosen = scored
    if opts.memory_budget is not None:
        feasible = [s for s in scored
                    if s[3].peak_bytes <= opts.memory_budget]
        if feasible:
            chosen = feasible
            stats["budget"] = "feasible"
        else:
            chosen = sorted(scored, key=lambda x: x[3].peak_bytes)
            stats["budget"] = "infeasible"
    best_metric, tree, plan, cost = chosen[0]
    stats["stage2_s"] = time.perf_counter() - t0 - stats["stage1_s"]
    stats["cache_stats"] = dict(CACHE_STATS)

    res = SearchResult(
        tree=tree, plan=plan, cost=cost,
        candidates=candidates,
        stage2_costs=[(m, t) for m, t, _, _ in scored],
        stats=stats,
    )
    _MEMO[sig] = (perf_model.MODEL_VERSION, res)
    _disk_store(sig, tree, candidates)
    return res


def clear_memo() -> None:
    _MEMO.clear()
