"""Tensor-decomposition builders for tensorized linear layers.

Port of ``src/repro/core/factorizations.py`` (pure Python, kept identical).

Implements the five decompositions evaluated in the paper (§II-B, Fig. 2):
Tensor-Train (TT), Tensor-Train Matrix (TTM), Tensor-Ring (TR), Hierarchical
Tucker (HT) and Block-Term (BT).  Each builder describes the factorization of
a weight matrix ``W[M, N]`` (with ``M = prod(out_dims)``, ``N = prod(in_dims)``)
as a :class:`~repro_torch.core.tnetwork.TensorNetwork` fragment, and can emit:

* ``forward_network(batch)`` — the FP network ``Y[b, m...] = X[b, n...] · cores``,
* ``weight_network()``       — cores only -> dense ``W`` (reconstruction),
* ``fixed_tree(net)``        — the fixed contraction sequence prior accelerators
  hard-code (TIE/ETTE/FDHT-style ascending-index; the paper's baseline),
* shape/param accounting (compression ratios, Table II reproduction).

Axis naming: batch ``b``, input factors ``n0..n{t-1}``, output factors
``m0..m{s-1}``, chain/leaf ranks ``r*``.  Size-1 boundary ranks (R0=Rd=1 for
TT/TTM) are elided so no degenerate axes reach the executor.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import cached_property
from typing import Sequence

from repro_torch.core.tnetwork import AxisId, TensorNetwork, TreeT


@dataclass(frozen=True)
class Factorization:
    """A concrete factorization of a ``[M, N]`` weight matrix."""

    method: str                        # "tt" | "ttm" | "tr" | "ht" | "bt"
    out_dims: tuple[int, ...]          # M_i, prod = M
    in_dims: tuple[int, ...]           # N_j, prod = N
    core_names: tuple[str, ...]
    core_axes: tuple[tuple[AxisId, ...], ...]
    sizes: dict[AxisId, int]

    def __hash__(self):  # sizes is a dict; hash via a canonical signature
        return hash((self.method, self.out_dims, self.in_dims,
                     self.core_names, self.core_axes,
                     tuple(sorted(self.sizes.items()))))

    # -- accounting ---------------------------------------------------------

    @property
    def M(self) -> int:
        return math.prod(self.out_dims)

    @property
    def N(self) -> int:
        return math.prod(self.in_dims)

    @property
    def num_cores(self) -> int:
        return len(self.core_axes)

    def core_shape(self, i: int) -> tuple[int, ...]:
        return tuple(self.sizes[a] for a in self.core_axes[i])

    @cached_property
    def num_params(self) -> int:
        return sum(math.prod(self.core_shape(i)) for i in range(self.num_cores))

    @property
    def dense_params(self) -> int:
        return self.M * self.N

    @property
    def compression_ratio(self) -> float:
        return self.dense_params / self.num_params

    @cached_property
    def contracted_rank_product(self) -> int:
        """Product of sizes of all internal (rank/block) axes — the number of
        multiplicative paths through the network; used for variance-correct
        initialisation of the cores."""
        external = set(f"m{i}" for i in range(len(self.out_dims)))
        external |= set(f"n{j}" for j in range(len(self.in_dims)))
        prod = 1
        for a, s in self.sizes.items():
            if a not in external:
                prod *= s
        return prod

    def init_std(self, target_std: float) -> float:
        """Per-core init std so the reconstructed W has ~``target_std``.

        var(W) ~= (prod_i sigma_i^2) * (number of rank paths); with equal
        sigma across the K cores: sigma = (target_var / paths)^(1/2K).
        """
        k = self.num_cores
        var = (target_std ** 2) / max(self.contracted_rank_product, 1)
        return var ** (1.0 / (2 * k))

    # -- networks -----------------------------------------------------------

    def forward_network(self, batch_axes: Sequence[tuple[str, int]] = (("b", 1),)
                        ) -> TensorNetwork:
        """FP network: ``Y[b.., m..] = sum_n X[b.., n..] * W_cores``."""
        t = len(self.in_dims)
        sizes = dict(self.sizes)
        baxes = tuple(name for name, _ in batch_axes)
        for name, size in batch_axes:
            sizes[name] = size
        x_axes = baxes + tuple(f"n{j}" for j in range(t))
        out = baxes + tuple(f"m{i}" for i in range(len(self.out_dims)))
        return TensorNetwork(
            sizes=sizes,
            nodes=(x_axes,) + self.core_axes,
            node_names=("X",) + self.core_names,
            output=out,
        )

    def weight_network(self) -> TensorNetwork:
        """Cores only -> dense ``W[m.., n..]`` (reconstruction / Scheme-2)."""
        out = tuple(f"m{i}" for i in range(len(self.out_dims))) + tuple(
            f"n{j}" for j in range(len(self.in_dims)))
        return TensorNetwork(
            sizes=dict(self.sizes),
            nodes=self.core_axes,
            node_names=self.core_names,
            output=out,
        )

    def fixed_tree(self, network: TensorNetwork) -> TreeT:
        """The fixed (prior-work) sequence: left-deep, ascending core index,
        anchored at X when X is in the network (node 0)."""
        has_x = network.node_names[0] == "X"
        order = list(range(network.num_nodes))
        if has_x:
            # X first, then cores in an order that always shares an axis with
            # the running intermediate (n-side chain first for TT/TR).
            order = [0] + _ascending_share_order(network)
        tree: TreeT = order[0]
        for idx in order[1:]:
            tree = (tree, idx)
        return tree


def _ascending_share_order(network: TensorNetwork) -> list[int]:
    """Order core nodes the way the fixed prior-work schemes do: anchored on
    X, always contracting the adjacent core that keeps the running
    intermediate smallest (chain-following for TT/TR, ascending index for
    TTM/HT/BT — TIE/ETTE/FDHT's hard-coded Scheme-1 of Fig. 4)."""
    merged = frozenset([0])
    remaining = set(range(1, network.num_nodes))
    order: list[int] = []
    while remaining:
        live = network.live_axes(merged)
        sharing = sorted(i for i in remaining
                         if live & frozenset(network.nodes[i]))
        pool = sharing if sharing else sorted(remaining)
        # pick the candidate whose merge leaves the smallest intermediate
        pick = min(pool, key=lambda i: (
            network.size_of(network.live_axes(merged | frozenset([i]))), i))
        order.append(pick)
        remaining.discard(pick)
        merged = merged | frozenset([pick])
    return order


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------


def _uniform_ranks(n: int, rank: int | Sequence[int]) -> tuple[int, ...]:
    if isinstance(rank, int):
        return (rank,) * n
    ranks = tuple(rank)
    assert len(ranks) == n, f"need {n} ranks, got {len(ranks)}"
    return ranks


def tt(out_dims: Sequence[int], in_dims: Sequence[int],
       rank: int | Sequence[int]) -> Factorization:
    """Tensor-Train (paper Eq. 3): d = s + t 3rd-order cores.

    Cores 0..s-1 carry the output factors (m-side), cores s..d-1 the input
    factors (n-side); chain ranks r1..r{d-1}; boundary ranks are 1 (elided).
    """
    s, t = len(out_dims), len(in_dims)
    d = s + t
    ranks = _uniform_ranks(d - 1, rank)
    sizes: dict[AxisId, int] = {}
    names, axes = [], []
    for i, m in enumerate(out_dims):
        sizes[f"m{i}"] = m
    for j, n in enumerate(in_dims):
        sizes[f"n{j}"] = n
    for k, r in enumerate(ranks):
        sizes[f"r{k+1}"] = r
    for i in range(d):
        mode = f"m{i}" if i < s else f"n{i - s}"
        ax: list[AxisId] = []
        if i > 0:
            ax.append(f"r{i}")
        ax.append(mode)
        if i < d - 1:
            ax.append(f"r{i+1}")
        names.append(f"G{i}")
        axes.append(tuple(ax))
    return Factorization("tt", tuple(out_dims), tuple(in_dims),
                         tuple(names), tuple(axes), sizes)


def ttm(out_dims: Sequence[int], in_dims: Sequence[int],
        rank: int | Sequence[int]) -> Factorization:
    """Tensor-Train Matrix (paper Eq. 4): d 4th-order cores [r, m_i, n_i, r]."""
    assert len(out_dims) == len(in_dims), "TTM needs s == t"
    d = len(out_dims)
    ranks = _uniform_ranks(d - 1, rank)
    sizes: dict[AxisId, int] = {}
    for i, (m, n) in enumerate(zip(out_dims, in_dims)):
        sizes[f"m{i}"] = m
        sizes[f"n{i}"] = n
    for k, r in enumerate(ranks):
        sizes[f"r{k+1}"] = r
    names, axes = [], []
    for i in range(d):
        ax: list[AxisId] = []
        if i > 0:
            ax.append(f"r{i}")
        ax += [f"m{i}", f"n{i}"]
        if i < d - 1:
            ax.append(f"r{i+1}")
        names.append(f"G{i}")
        axes.append(tuple(ax))
    return Factorization("ttm", tuple(out_dims), tuple(in_dims),
                         tuple(names), tuple(axes), sizes)


def tr(out_dims: Sequence[int], in_dims: Sequence[int],
       rank: int | Sequence[int]) -> Factorization:
    """Tensor-Ring (paper Eq. 5): TT with the boundary ranks joined, R0=Rd=R."""
    s, t = len(out_dims), len(in_dims)
    d = s + t
    ranks = _uniform_ranks(d, rank)   # r0 (= ring closure) .. r{d-1}
    sizes: dict[AxisId, int] = {}
    for i, m in enumerate(out_dims):
        sizes[f"m{i}"] = m
    for j, n in enumerate(in_dims):
        sizes[f"n{j}"] = n
    for k, r in enumerate(ranks):
        sizes[f"r{k}"] = r
    names, axes = [], []
    for i in range(d):
        mode = f"m{i}" if i < s else f"n{i - s}"
        ax = (f"r{i}", mode, f"r{(i + 1) % d}")
        names.append(f"G{i}")
        axes.append(ax)
    return Factorization("tr", tuple(out_dims), tuple(in_dims),
                         tuple(names), tuple(axes), sizes)


def ht(out_dims: Sequence[int], in_dims: Sequence[int],
       rank: int | Sequence[int]) -> Factorization:
    """Hierarchical Tucker: leaf cores [m_i, n_i, r_i] + a balanced binary
    tree of transfer tensors [r_left, r_right, r_parent] (root has no parent).
    """
    assert len(out_dims) == len(in_dims), "HT needs s == t"
    d = len(out_dims)
    assert d >= 2
    sizes: dict[AxisId, int] = {}
    for i, (m, n) in enumerate(zip(out_dims, in_dims)):
        sizes[f"m{i}"] = m
        sizes[f"n{i}"] = n
    names: list[str] = []
    axes: list[tuple[AxisId, ...]] = []
    rank_of: dict[str, int] = {}

    # Leaves.
    n_ranks = 0
    def new_rank() -> str:
        nonlocal n_ranks
        r = f"r{n_ranks}"
        n_ranks += 1
        return r

    if isinstance(rank, int):
        rank_value = lambda: rank  # noqa: E731
    else:
        rank_iter = iter(rank)
        rank_value = lambda: next(rank_iter)  # noqa: E731

    frontier: list[str] = []   # open rank axis per subtree
    for i in range(d):
        r = new_rank()
        sizes[r] = rank_value()
        names.append(f"G{i}")
        axes.append((f"m{i}", f"n{i}", r))
        frontier.append(r)

    # Transfer tensors, pairing left-to-right level by level.
    u = 0
    while len(frontier) > 1:
        nxt: list[str] = []
        for k in range(0, len(frontier) - 1, 2):
            rl, rr = frontier[k], frontier[k + 1]
            if len(frontier) == 2:
                names.append(f"U{u}")
                axes.append((rl, rr))          # root: no parent axis
            else:
                rp = new_rank()
                sizes[rp] = rank_value()
                names.append(f"U{u}")
                axes.append((rl, rr, rp))
                nxt.append(rp)
            u += 1
        if len(frontier) % 2 == 1:
            nxt.append(frontier[-1])
        frontier = nxt
    return Factorization("ht", tuple(out_dims), tuple(in_dims),
                         tuple(names), tuple(axes), sizes)


def bt(out_dims: Sequence[int], in_dims: Sequence[int],
       rank: int | Sequence[int], num_blocks: int = 2) -> Factorization:
    """Block-Term: K block terms, each a Tucker-like product of a transfer
    tensor U^(k)[R1..Rd] with d cores G^(k,i)[M_i, N_i, R_i].  Implemented by
    stacking the K terms along a hyperedge axis ``k`` shared by every weight
    node and summed once all of them have merged (einsum hyperedge semantics).
    """
    assert len(out_dims) == len(in_dims), "BT needs s == t"
    d = len(out_dims)
    ranks = _uniform_ranks(d, rank)
    sizes: dict[AxisId, int] = {"k": num_blocks}
    for i, (m, n) in enumerate(zip(out_dims, in_dims)):
        sizes[f"m{i}"] = m
        sizes[f"n{i}"] = n
    for i, r in enumerate(ranks):
        sizes[f"r{i}"] = r
    names, axes = [], []
    for i in range(d):
        names.append(f"G{i}")
        axes.append(("k", f"m{i}", f"n{i}", f"r{i}"))
    names.append("U")
    axes.append(("k",) + tuple(f"r{i}" for i in range(d)))
    return Factorization("bt", tuple(out_dims), tuple(in_dims),
                         tuple(names), tuple(axes), sizes)


BUILDERS = {"tt": tt, "ttm": ttm, "tr": tr, "ht": ht, "bt": bt}


def make(method: str, out_dims: Sequence[int], in_dims: Sequence[int],
         rank: int | Sequence[int], **kw) -> Factorization:
    try:
        builder = BUILDERS[method]
    except KeyError:
        raise ValueError(f"unknown factorization {method!r}; "
                         f"one of {sorted(BUILDERS)}") from None
    return builder(out_dims, in_dims, rank, **kw)


# ---------------------------------------------------------------------------
# Dim factoring helper — pick balanced factors for a given M (config use)
# ---------------------------------------------------------------------------


def factorize_dim(n: int, num_factors: int) -> tuple[int, ...]:
    """Split integer ``n`` into ``num_factors`` balanced factors (descending).

    Used by configs to tensorize e.g. d_ff=14336 -> (16, 16, 8, 7).  Falls
    back to trailing 1s when n has too few prime factors.
    """
    assert n >= 1 and num_factors >= 1
    primes: list[int] = []
    x = n
    p = 2
    while p * p <= x:
        while x % p == 0:
            primes.append(p)
            x //= p
        p += 1
    if x > 1:
        primes.append(x)
    factors = [1] * num_factors
    for p in sorted(primes, reverse=True):
        # greedily add to the currently-smallest factor
        i = min(range(num_factors), key=lambda i: factors[i])
        factors[i] *= p
    return tuple(sorted(factors, reverse=True))
