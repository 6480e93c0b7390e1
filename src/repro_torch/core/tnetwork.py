"""Tensor-network intermediate representation.

Port of ``src/repro/core/tnetwork.py``; the IR is pure Python and kept
identical, so both packages build the same networks and plans.

This module defines the graph IR the whole framework reasons about:

* a :class:`TensorNetwork` — a set of named tensor nodes with labeled axes
  (edges).  Axes shared between nodes are contracted; axes listed in
  ``output`` are free (dangling) and survive into the result.  Axes may be
  *hyperedges* (shared by more than two nodes, e.g. the block axis of a BT
  decomposition or the batch axis): they are summed out only once every
  holder has been merged, exactly matching ``einsum`` semantics.

* a :class:`ContractionTree` — a binary tree over node indices describing
  one full contraction order ("sequence" in the paper's terms).  The paper's
  Alg. 1 searches over these.

* :class:`ContractionStep` / :class:`ContractionPlan` — the linearised,
  executable form: per step, the einsum spec, FLOPs and byte traffic.  The
  executor (``repro_torch.core.contraction``) and the analytic performance model
  (``repro_torch.core.perf_model``) both consume plans, so the cost the search
  optimises is exactly the cost the runtime incurs.

Everything here is pure Python + integers — no torch imports — so the CSSE
search can run at trace time (and be memoised) without touching device
state.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from functools import cached_property
from typing import Iterable, Mapping, Sequence, Union

AxisId = str

# A contraction tree is either a leaf (node index) or a pair of subtrees.
TreeT = Union[int, tuple]


# ---------------------------------------------------------------------------
# Network definition
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TensorNetwork:
    """An immutable tensor network.

    Attributes:
      sizes: axis label -> dimension size.
      nodes: per node, the ordered tuple of axis labels (defines the array
        layout the executor will be handed).
      node_names: human-readable name per node (``"X"``, ``"G1"``, ...).
      output: ordered axis labels of the result tensor.
    """

    sizes: Mapping[AxisId, int]
    nodes: tuple[tuple[AxisId, ...], ...]
    node_names: tuple[str, ...]
    output: tuple[AxisId, ...]

    def __post_init__(self):
        assert len(self.nodes) == len(self.node_names)
        for axes in self.nodes:
            for a in axes:
                assert a in self.sizes, f"axis {a!r} has no size"
        for a in self.output:
            assert a in self.sizes, f"output axis {a!r} has no size"

    # -- basic queries -----------------------------------------------------

    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    @cached_property
    def axis_holders(self) -> dict[AxisId, frozenset[int]]:
        """axis -> set of node indices that carry it."""
        holders: dict[AxisId, set[int]] = {}
        for i, axes in enumerate(self.nodes):
            for a in axes:
                holders.setdefault(a, set()).add(i)
        return {a: frozenset(s) for a, s in holders.items()}

    @cached_property
    def output_set(self) -> frozenset[AxisId]:
        return frozenset(self.output)

    def node_shape(self, i: int) -> tuple[int, ...]:
        return tuple(self.sizes[a] for a in self.nodes[i])

    def node_numel(self, i: int) -> int:
        return math.prod(self.node_shape(i))

    def size_of(self, axes: Iterable[AxisId]) -> int:
        return math.prod(self.sizes[a] for a in axes)

    # -- subset algebra (used by the search) --------------------------------

    def live_axes(self, subset: frozenset[int]) -> frozenset[AxisId]:
        """Axes of the tensor obtained by fully contracting ``subset``.

        An axis held by a node in ``subset`` stays *live* iff it is also held
        by some node outside the subset, or it is an output axis.  Everything
        else has been summed out.
        """
        live = set()
        for a, holders in self.axis_holders.items():
            if holders & subset and (holders - subset or a in self.output_set):
                live.add(a)
        return frozenset(live)

    def pair_cost(
        self, axes_a: frozenset[AxisId], axes_b: frozenset[AxisId],
        axes_out: frozenset[AxisId],
    ) -> tuple[int, int]:
        """(flops, output_numel) of contracting tensors with the given axes.

        FLOPs uses the standard multiply-add convention: ``2 * prod(size of
        every axis involved)`` — every output element (prod of free axes) is a
        sum over the contracted axes.
        """
        involved = axes_a | axes_b
        flops = 2 * self.size_of(involved)
        return flops, self.size_of(axes_out)


# ---------------------------------------------------------------------------
# Executable plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ContractionStep:
    """One pairwise contraction, fully specified for execution and costing."""

    lhs: int                      # intermediate slot index of left operand
    rhs: int                      # intermediate slot index of right operand
    out: int                      # slot index the result is stored into
    lhs_axes: tuple[AxisId, ...]
    rhs_axes: tuple[AxisId, ...]
    out_axes: tuple[AxisId, ...]
    lhs_shape: tuple[int, ...]
    rhs_shape: tuple[int, ...]
    out_shape: tuple[int, ...]
    flops: int                    # 2 * prod(all involved axis sizes)
    # byte traffic assuming operands stream from/to HBM once (dtype-agnostic:
    # counts elements; the perf model multiplies by dtype width).
    read_elems: int
    write_elems: int

    @property
    def batch_axes(self) -> tuple[AxisId, ...]:
        """Axes present in both operands and the output (einsum batch dims)."""
        rhs = set(self.rhs_axes)
        out = set(self.out_axes)
        return tuple(a for a in self.lhs_axes if a in rhs and a in out)

    @property
    def contracted_axes(self) -> tuple[AxisId, ...]:
        out = set(self.out_axes)
        seen = set()
        axes = []
        for a in self.lhs_axes + self.rhs_axes:
            if a not in out and a not in seen:
                seen.add(a)
                axes.append(a)
        return tuple(axes)

    def gemm_dims(self, sizes: Mapping[AxisId, int]) -> tuple[int, int, int, int]:
        """Collapse the step to (B, M, N, K) GEMM dims for the perf model.

        B: batch axes (in both operands and output), M: free axes of lhs,
        N: free axes of rhs, K: contracted axes.
        """
        batch = set(self.batch_axes)
        contracted = set(self.contracted_axes)
        m = math.prod(sizes[a] for a in self.lhs_axes
                      if a not in batch and a not in contracted) or 1
        n = math.prod(sizes[a] for a in self.rhs_axes
                      if a not in batch and a not in contracted
                      and a not in set(self.lhs_axes)) or 1
        k = math.prod(sizes[a] for a in contracted) or 1
        b = math.prod(sizes[a] for a in batch) or 1
        return b, m, n, k


@dataclass(frozen=True)
class ContractionPlan:
    """A linearised contraction tree over a :class:`TensorNetwork`.

    Slots ``0..num_nodes-1`` hold the input tensors; each step appends one
    intermediate.  The final step's ``out`` slot holds the network output
    (with axes ``steps[-1].out_axes`` — the executor transposes to
    ``network.output`` order if they differ).
    """

    network: TensorNetwork
    steps: tuple[ContractionStep, ...]
    tree: TreeT

    @property
    def total_flops(self) -> int:
        return sum(s.flops for s in self.steps)

    @property
    def total_read_elems(self) -> int:
        return sum(s.read_elems for s in self.steps)

    @property
    def total_write_elems(self) -> int:
        return sum(s.write_elems for s in self.steps)

    @property
    def total_mem_elems(self) -> int:
        return self.total_read_elems + self.total_write_elems

    def peak_live_elems(self, include_inputs: bool = False) -> int:
        """Max live-tensor footprint (elements) over the schedule.

        Mirrors the executor's slot lifetimes exactly (an operand is freed
        after its last use).  With ``include_inputs`` the input nodes are
        resident from the start — the whole-working-set quantity the
        memory planner budgets (``perf_model.plan_peak_elems``); without,
        only intermediates count.
        """
        last_use: dict[int, int] = {}
        for t, s in enumerate(self.steps):
            last_use[s.lhs] = t
            last_use[s.rhs] = t
        live: dict[int, int] = {}
        if include_inputs:
            live = {i: self.network.node_numel(i)
                    for i in range(self.network.num_nodes)}
        peak = sum(live.values())
        for t, s in enumerate(self.steps):
            live[s.out] = math.prod(s.out_shape)
            peak = max(peak, sum(live.values()))
            for op in (s.lhs, s.rhs):
                if op in live and last_use.get(op) == t:
                    del live[op]
        return peak

    @property
    def peak_intermediate_elems(self) -> int:
        """Max live intermediate footprint (elements) over the schedule."""
        return self.peak_live_elems(include_inputs=False)

    def describe(self) -> str:
        """Human-readable dump (used in logs / EXPERIMENTS.md)."""
        names = list(self.network.node_names)
        lines = []
        for s in self.steps:
            lname = names[s.lhs] if s.lhs < len(names) else f"t{s.lhs}"
            rname = names[s.rhs] if s.rhs < len(names) else f"t{s.rhs}"
            lines.append(
                f"t{s.out} = contract({lname}{list(s.lhs_shape)}, "
                f"{rname}{list(s.rhs_shape)}) -> {list(s.out_shape)} "
                f"[{s.flops/1e6:.2f} MFLOPs]"
            )
        lines.append(
            f"total: {self.total_flops/1e6:.2f} MFLOPs, "
            f"{self.total_mem_elems/1e6:.2f} M elems moved"
        )
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Tree -> plan lowering
# ---------------------------------------------------------------------------


def tree_leaves(tree: TreeT) -> tuple[int, ...]:
    if isinstance(tree, int):
        return (tree,)
    out: list[int] = []
    for sub in tree:
        out.extend(tree_leaves(sub))
    return tuple(out)


def plan_from_tree(network: TensorNetwork, tree: TreeT) -> ContractionPlan:
    """Lower a contraction tree to an executable :class:`ContractionPlan`."""
    leaves = sorted(tree_leaves(tree))
    assert leaves == list(range(network.num_nodes)), (
        f"tree must cover all {network.num_nodes} nodes, got {leaves}")

    steps: list[ContractionStep] = []
    next_slot = network.num_nodes

    def recurse(sub: TreeT) -> tuple[int, tuple[AxisId, ...], frozenset[int]]:
        nonlocal next_slot
        if isinstance(sub, int):
            return sub, network.nodes[sub], frozenset([sub])
        assert len(sub) == 2, f"contraction tree nodes must be binary: {sub}"
        lslot, laxes, lset = recurse(sub[0])
        rslot, raxes, rset = recurse(sub[1])
        sset = lset | rset
        out_live = network.live_axes(sset)
        # Deterministic output axis order: batch/lhs-major, matching how the
        # executor will want to feed the next GEMM (lhs free axes first).
        out_axes = tuple(a for a in laxes if a in out_live) + tuple(
            a for a in raxes if a in out_live and a not in set(laxes))
        flops, _ = network.pair_cost(
            frozenset(laxes), frozenset(raxes), out_live)
        lshape = tuple(network.sizes[a] for a in laxes)
        rshape = tuple(network.sizes[a] for a in raxes)
        oshape = tuple(network.sizes[a] for a in out_axes)
        step = ContractionStep(
            lhs=lslot, rhs=rslot, out=next_slot,
            lhs_axes=laxes, rhs_axes=raxes, out_axes=out_axes,
            lhs_shape=lshape, rhs_shape=rshape, out_shape=oshape,
            flops=flops,
            read_elems=math.prod(lshape) + math.prod(rshape),
            write_elems=math.prod(oshape),
        )
        steps.append(step)
        slot = next_slot
        next_slot += 1
        return slot, out_axes, sset

    if network.num_nodes == 1:
        # Degenerate single-node network: identity plan.
        return ContractionPlan(network=network, steps=(), tree=tree)

    recurse(tree)
    final = steps[-1]
    assert frozenset(final.out_axes) == frozenset(network.output), (
        f"final axes {final.out_axes} != declared output {network.output}")
    return ContractionPlan(network=network, steps=tuple(steps), tree=tree)


def localize_network(network: TensorNetwork,
                     factors: Mapping[AxisId, int]) -> TensorNetwork:
    """The per-shard view of a network whose axes are split SPMD-style.

    ``factors[a] = p`` divides axis ``a``'s size by ``p`` (each device holds
    one of ``p`` equal blocks).  Node orders, axis labels and the output
    signature are unchanged, so any contraction tree of the global network is
    a valid tree of the local one — ``plan_from_tree(localize_network(net,
    f), tree)`` is the plan every shard executes.  Axes missing from
    ``factors`` (or mapped to 1) are replicated.  Non-divisible splits are a
    caller bug (the sharding rules guard divisibility before building
    factors), asserted here rather than silently mis-sized.
    """
    sizes = dict(network.sizes)
    for a, p in factors.items():
        if a not in sizes or p <= 1:
            continue
        assert sizes[a] % p == 0, (
            f"axis {a!r} of size {sizes[a]} does not divide by {p}")
        sizes[a] = sizes[a] // p
    return TensorNetwork(sizes=sizes, nodes=network.nodes,
                         node_names=network.node_names,
                         output=network.output)


def sequence_to_tree(pairs: Sequence[tuple[int, int]], num_nodes: int) -> TreeT:
    """Convert a paper-style merge sequence [(i,j), ...] into a tree.

    Indices refer to *current* node slots: inputs are 0..num_nodes-1 and each
    merge appends a new slot (num_nodes, num_nodes+1, ...), mirroring
    Alg. 1's graph-rewriting formulation.
    """
    slots: dict[int, TreeT] = {i: i for i in range(num_nodes)}
    nxt = num_nodes
    for i, j in pairs:
        slots[nxt] = (slots.pop(i), slots.pop(j))
        nxt += 1
    remaining = list(slots.values())
    assert len(remaining) == 1, f"sequence leaves {len(remaining)} components"
    return remaining[0]


def canonical_tree(tree: TreeT) -> TreeT:
    """Canonicalise commutativity: order children by smallest leaf index."""
    if isinstance(tree, int):
        return tree
    a, b = canonical_tree(tree[0]), canonical_tree(tree[1])
    if min(tree_leaves(a)) > min(tree_leaves(b)):
        a, b = b, a
    return (a, b)


def all_trees(num_nodes: int):
    """Yield every distinct (unordered) binary contraction tree.

    Used only by tests for tiny networks to check the search is exhaustive;
    count is the double factorial (2K-3)!!.
    """
    def build(leaf_sets: tuple[TreeT, ...]):
        if len(leaf_sets) == 1:
            yield leaf_sets[0]
            return
        first = leaf_sets[0]
        for k in range(1, len(leaf_sets)):
            merged = (first, leaf_sets[k])
            rest = (merged,) + leaf_sets[1:k] + leaf_sets[k + 1:]
            yield from build(rest)

    # Enumerate by recursively pairing; dedupe by canonical form.
    seen = set()
    def gen(items: tuple[TreeT, ...]):
        if len(items) == 1:
            t = canonical_tree(items[0])
            key = repr(t)
            if key not in seen:
                seen.add(key)
                yield t
            return
        for i, j in itertools.combinations(range(len(items)), 2):
            merged = (items[i], items[j])
            rest = tuple(x for k, x in enumerate(items) if k not in (i, j))
            yield from gen(rest + (merged,))

    yield from gen(tuple(range(num_nodes)))
