"""Analytic performance model — CSSE's stage-2 cost predictor (H100).

Port of ``src/repro/core/perf_model.py``.  The cost semantics are the
reference's, unchanged, so that a search run with the same
:class:`HardwareModel` field values ranks candidates identically in both
packages (``tests/test_torch_plan.py`` holds the two to that):

* per contraction step, collapse to a batched GEMM (B, M, N, K) and charge
    compute = FLOPs / (peak_flops * mxu_utilisation(M, N, K))
    memory  = bytes_moved / hbm_bw
    step    = max(compute, memory) + fixed step overhead
* ``fused_chain=True`` models the fused chain kernel, where an
  intermediate small enough for on-chip residency (here: half of one
  block's shared memory, ``vmem_bytes // 2``) never round-trips device
  memory.

What changes is the default machine: :data:`H100_SXM`, one NVIDIA H100
SXM card.  The field names are the reference's (so the parity tests can
hand the same values to both packages); on this card they mean:

* ``peak_flops`` — dense bf16 tensor-core rate, 989e12 FLOP/s;
* ``hbm_bw`` — device memory, 3.35e12 B/s;
* ``ici_bw`` — NVLink to another card of the host, 450e9 B/s each way;
* ``vmem_bytes`` — shared memory one thread block may use, 232,448 B;
* ``mxu_dim`` — the 64-row warpgroup ``wgmma`` tile M and N are padded
  to, and ``sublane`` the 16-deep bf16 k-step (the utilisation model
  shape, not a measured curve).

(NVIDIA's H100 SXM data sheet and the Hopper architecture white paper.)
The energy constants and ``step_overhead_s`` have no H100 figure in this
repository: they carry over uncalibrated and are used only for relative
rankings (queued in ROADMAP.md for the autotune slice).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Mapping

from repro_torch.analysis.roofline import ring_allreduce_bytes
from repro_torch.core.tnetwork import (
    AxisId, ContractionPlan, ContractionStep, TensorNetwork, localize_network,
    plan_from_tree,
)

#: Bump whenever the analytic cost semantics change (byte accounting,
#: elision predicate, utilisation curve): cached sequence winners were
#: ranked by the old model and must be invalidated through the search
#: signature (csse._signature).
#: 2: chain elision restricted to once-consumed lhs links, mirroring the
#:    compiler's _fusable_link predicate.
MODEL_VERSION = 2


@dataclass(frozen=True)
class HardwareModel:
    """Roofline constants for one accelerator chip."""

    name: str = "h100-sxm"
    peak_flops: float = 989e12          # bf16 dense tensor-core peak, FLOP/s
    hbm_bw: float = 3.35e12             # device memory, bytes/s
    ici_bw: float = 450e9               # NVLink, bytes/s each way
    vmem_bytes: int = 232_448           # shared memory per thread block
    mxu_dim: int = 64                   # wgmma tile rows (M/N padding)
    sublane: int = 16                   # bf16 k-step of one wgmma
    dtype_bytes: int = 2                # bf16
    # Uncalibrated on the H100 (no measurement in this repository yet):
    step_overhead_s: float = 2e-6       # launch + fill per op
    e_flop: float = 0.35e-12            # J per FLOP
    e_hbm_byte: float = 25e-12          # J per device-memory byte
    e_ici_byte: float = 10e-12          # J per NVLink byte

    def mxu_utilisation(self, m: int, n: int, k: int) -> float:
        """Fraction of tensor-core MACs doing useful work for an (M,N,K)
        GEMM: M and N pad to ``mxu_dim``, K to ``sublane``."""
        def eff(d: int, tile: int) -> float:
            return d / (tile * math.ceil(d / tile))
        return eff(m, self.mxu_dim) * eff(n, self.mxu_dim) * eff(k, self.sublane)


H100_SXM = HardwareModel()


def apply_policy(hw: HardwareModel, policy) -> HardwareModel:
    """Retarget a hardware model to a quantization policy's storage width.

    The policy (:class:`repro_torch.precision.policy.QuantPolicy`) changes what the
    executor streams — fp8/int8 operands and intermediates — so every
    byte-denominated term (step HBM traffic, HBM energy, the deferred-psum
    ICI payload) reprices at ``policy.dtype_bytes``.  Compute terms keep
    the bf16 peak: the quantized kernels upcast on chip, so FLOP
    throughput is unchanged — the win this model captures is pure traffic,
    which is exactly what the low-precision tensorized-training line of
    work banks on.  ``dtype_bytes`` is already part of every CSSE/autotune
    cache signature, so policy-retargeted searches can never collide with
    bf16 entries.

    Note the ICI term keeps :func:`collective_cost`'s storage-dtype
    convention: the sharded executor all-reduces **f32 partial sums**
    regardless of policy (exactness of the deferred reduction), so the
    repriced collective is a *modeled* quantity — consistent with every
    other byte term, which is all a ranking needs within one policy.
    Shipping quantized psum payloads (all-reduce the q tensors + a scale
    combine) is the open item that would realise it on the wire.
    """
    if policy is None or not policy.quantized:
        return hw
    return dataclasses.replace(hw, dtype_bytes=policy.dtype_bytes)

# ---------------------------------------------------------------------------
# Mesh spec — the pure-Python mirror of a device mesh
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshSpec:
    """How a contraction network is laid out over a device mesh, for costing.

    A hashable, framework-free mirror of (device mesh, per-axis sharding intent) so
    CSSE searches stay pure-Python at trace time and memoise correctly:

    * ``axes`` — the mesh shape as ordered ``(name, size)`` pairs.
    * ``axis_sharding`` — network axis label -> the mesh axes it splits over
      (e.g. ``(("b", ("data",)),)`` for batch-parallel FP/BP and
      contraction-split WG — the butterfly-distribution analog).
    * ``device_kind`` — provenance tag; enters every disk-cache signature so
      single-device entries can never be served for sharded runs.

    The distributed layer that builds one from a live process group is
    not ported yet (ROADMAP.md, queue A); single-device plans pass None.
    """

    axes: tuple[tuple[str, int], ...]
    axis_sharding: tuple[tuple[AxisId, tuple[str, ...]], ...] = ()
    device_kind: str = "unknown"

    @property
    def num_devices(self) -> int:
        return math.prod(s for _, s in self.axes)

    def mesh_size(self, names: tuple[str, ...]) -> int:
        shape = dict(self.axes)
        return math.prod(shape.get(n, 1) for n in names)

    def factor(self, axis: AxisId, sizes: Mapping[AxisId, int]) -> int:
        """Ways ``axis`` is split, honouring the divisibility guard the
        executor applies (non-dividing splits are dropped, not errors)."""
        for a, mesh_axes in self.axis_sharding:
            if a == axis:
                p = self.mesh_size(mesh_axes)
                if p > 1 and sizes.get(axis, 0) % p == 0:
                    return p
        return 1

    def factors(self, net: TensorNetwork) -> dict[AxisId, int]:
        return {a: self.factor(a, net.sizes) for a, _ in self.axis_sharding
                if a in net.sizes}

    def signature_payload(self) -> tuple:
        """Hash-stable tuple for disk-cache keys (csse/autotune)."""
        return (self.axes, self.axis_sharding, self.device_kind,
                self.num_devices)


def localize_plan(plan: ContractionPlan, mesh: MeshSpec | None
                  ) -> ContractionPlan:
    """The per-shard plan: same contraction tree, sharded axes scaled down.

    This is exactly what every device executes under
    ``contraction.execute(..., mesh=...)`` — the executor and the cost model
    lower through the same function so stage-2 prices real shard shapes.
    """
    if mesh is None:
        return plan
    factors = mesh.factors(plan.network)
    if all(p == 1 for p in factors.values()):
        return plan
    local = localize_network(plan.network, factors)
    if not plan.steps:
        return ContractionPlan(network=local, steps=(), tree=plan.tree)
    return plan_from_tree(local, plan.tree)


@dataclass(frozen=True)
class CollectiveCost:
    """The communication half of a sharded plan's cost."""

    bytes_ici: int
    latency_s: float
    psum_devices: int          # devices participating in the final psum


def collective_cost(plan: ContractionPlan, mesh: MeshSpec | None,
                    hw: "HardwareModel") -> CollectiveCost:
    """Price the deferred ``psum`` a sharded execution performs.

    The executor keeps partial sums device-local until the whole local plan
    has run (multilinearity makes that exact) and then all-reduces the
    *output*-shaped partials over every mesh axis that split a contracted
    network axis — the butterfly-reduction analog.  Ring all-reduce bytes
    over the per-shard output, at ICI bandwidth, plus one dispatch overhead.
    Phase networks whose sharded axes all survive into the output (FP/BP
    batch parallelism) cost nothing here.

    The payload is priced at ``hw.dtype_bytes`` — the same storage-dtype
    convention as every HBM term in this model (the executor actually psums
    in f32; rankings only need terms consistent *with each other*, and the
    measured objective charges this same function so the two can never
    rank one plan's collective differently).
    """
    if mesh is None:
        return CollectiveCost(0, 0.0, 1)
    net = plan.network
    out_set = set(net.output)
    psum = 1
    for a, _ in mesh.axis_sharding:
        if a in net.sizes and a not in out_set:
            psum *= mesh.factor(a, net.sizes)
    if psum <= 1:
        return CollectiveCost(0, 0.0, 1)
    factors = mesh.factors(net)
    local_out = 1
    for a in net.output:
        local_out *= net.sizes[a] // factors.get(a, 1)
    nbytes = local_out * hw.dtype_bytes
    moved = ring_allreduce_bytes(nbytes, psum)
    return CollectiveCost(bytes_ici=moved,
                          latency_s=moved / hw.ici_bw + hw.step_overhead_s,
                          psum_devices=psum)


def plan_peak_elems(plan: ContractionPlan) -> int:
    """Peak live-tensor footprint (elements) of executing ``plan``.

    Live-tensor accounting that mirrors the executor's slot lifetime rules
    exactly (``contraction.execute`` frees an operand after its last use):
    every input node is resident from the start, each step's output joins
    the live set before its operands can be freed, and the peak is taken at
    the step boundary where lhs, rhs and out coexist.  Elements, not bytes —
    the hardware model multiplies by its (policy-repriced) ``dtype_bytes``.
    One implementation, shared with ``peak_intermediate_elems``:
    :meth:`~repro_torch.core.tnetwork.ContractionPlan.peak_live_elems`.
    """
    return plan.peak_live_elems(include_inputs=True)


def peak_bytes(plan: ContractionPlan, hw: "HardwareModel | None" = None,
               mesh: MeshSpec | None = None, policy=None) -> int:
    """Modeled peak memory (bytes) of one plan execution on one device.

    Composes the contraction schedule (live-tensor accounting over
    steps), the quantization policy (fp8/int8 storage widths via
    :func:`apply_policy`) and the mesh (per-shard operands,
    :func:`localize_plan`).  This is the quantity CSSE's
    ``memory_budget`` constrains and the CPU fallback of the probe
    (:mod:`repro_torch.memory.probe`) reports.  The default machine is
    :data:`H100_SXM` (the reference's is its TPU model; both store bf16,
    2 bytes, so the number is the same)."""
    hw = apply_policy(hw or H100_SXM, policy)
    return plan_peak_elems(localize_plan(plan, mesh)) * hw.dtype_bytes


@dataclass(frozen=True)
class StepCost:
    flops: int
    bytes_hbm: int
    compute_s: float
    memory_s: float
    latency_s: float
    bound: str               # "compute" | "memory" | "overhead"
    util: float


@dataclass(frozen=True)
class PlanCost:
    """Aggregate cost of a :class:`ContractionPlan` on one chip — or, with a
    :class:`MeshSpec`, the *per-device* cost of the sharded execution
    (``latency_s`` then includes ``collective_s``, the deferred-psum term).
    """

    latency_s: float
    energy_j: float
    flops: int
    bytes_hbm: int
    steps: tuple[StepCost, ...] = field(repr=False, default=())
    bytes_ici: int = 0
    collective_s: float = 0.0
    peak_bytes: int = 0      # live-tensor peak of the (localized) schedule

    @property
    def edp(self) -> float:
        return self.latency_s * self.energy_j

    @property
    def compute_s(self) -> float:
        return sum(s.compute_s for s in self.steps)

    @property
    def memory_s(self) -> float:
        return sum(s.memory_s for s in self.steps)

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.bytes_hbm, 1)

    @property
    def dominant(self) -> str:
        counts: dict[str, float] = {}
        for s in self.steps:
            counts[s.bound] = counts.get(s.bound, 0.0) + s.latency_s
        return max(counts, key=counts.get) if counts else "none"

    def metric(self, objective: str) -> float:
        return {
            "latency": self.latency_s,
            "energy": self.energy_j,
            "edp": self.edp,
            "flops": float(self.flops),
            "memory": float(self.bytes_hbm),
            "collective": float(self.bytes_ici),
            "peak_bytes": float(self.peak_bytes),
        }[objective]


def evaluate_step(step: ContractionStep, sizes, hw: HardwareModel,
                  read_elems: int | None = None,
                  write_elems: int | None = None) -> StepCost:
    b, m, n, k = step.gemm_dims(sizes)
    util = hw.mxu_utilisation(m, n, k)
    compute = step.flops / (hw.peak_flops * util)
    re = step.read_elems if read_elems is None else read_elems
    we = step.write_elems if write_elems is None else write_elems
    bytes_hbm = (re + we) * hw.dtype_bytes
    memory = bytes_hbm / hw.hbm_bw
    lat = max(compute, memory) + hw.step_overhead_s
    if hw.step_overhead_s > max(compute, memory):
        bound = "overhead"
    elif compute >= memory:
        bound = "compute"
    else:
        bound = "memory"
    return StepCost(flops=step.flops, bytes_hbm=bytes_hbm, compute_s=compute,
                    memory_s=memory, latency_s=lat, bound=bound, util=util)


def evaluate(plan: ContractionPlan, hw: HardwareModel = H100_SXM,
             fused_chain: bool = False, max_chain_len: int = 2,
             mesh: MeshSpec | None = None, policy=None) -> PlanCost:
    """Cost a full contraction plan.

    With ``fused_chain``, an intermediate consumed by the next step and small
    enough for on-chip residency skips its HBM write+read (fused chain
    kernel / FETTA butterfly analogue).  ``max_chain_len`` caps how many
    consecutive steps one on-chip-resident run may span, matching the
    compiler's megakernel chain-length cap: after ``max_chain_len`` fused
    links the intermediate is written back to HBM and a new chain begins
    (2 = the historical pairwise fusion).

    With ``policy`` (a quantization policy), every byte term reprices at
    the policy's storage width via :func:`apply_policy` — FP8/INT8 halve
    HBM traffic, the on-chip-residency window for chaining doubles, and the
    deferred-psum ICI payload shrinks by the same factor.

    With ``mesh``, the returned cost is *per device* of the SPMD execution:
    every step is priced at its per-shard dims (sharded axes scaled by their
    mesh factors — steps where no sharded axis is live run at full size on
    every device), and the deferred psum over contracted sharded axes adds
    ``collective_s`` / ``bytes_ici`` (ring all-reduce at ICI bandwidth).
    This is CSSE stage-2's communication-aware objective.
    """
    hw = apply_policy(hw, policy)
    coll = collective_cost(plan, mesh, hw)
    plan = localize_plan(plan, mesh)
    sizes = plan.network.sizes
    num_inputs = plan.network.num_nodes
    uses: dict[int, int] = {}    # slot -> consumption count across the plan
    for step in plan.steps:
        uses[step.lhs] = uses.get(step.lhs, 0) + 1
        uses[step.rhs] = uses.get(step.rhs, 0) + 1
    resident: set[int] = set()   # slots currently resident on chip only
    step_costs: list[StepCost] = []
    run_len = 1                  # steps in the current on-chip-resident chain
    for i, step in enumerate(plan.steps):
        read = 0
        consumed_resident = False
        for slot, axes in ((step.lhs, step.lhs_shape), (step.rhs, step.rhs_shape)):
            if slot in resident:
                consumed_resident = True
                continue
            read += math.prod(axes)
        run_len = run_len + 1 if consumed_resident else 1
        write = math.prod(step.out_shape)
        if fused_chain and run_len < max_chain_len:
            out_elems = math.prod(step.out_shape)
            # Mirror the compiler's chain predicate (_fusable_link): only
            # an intermediate consumed exactly once, as the *next* step's
            # lhs, can stay on-chip-resident — rhs consumption never chains,
            # so crediting it here would steer the sequence search toward
            # plans the lowering then refuses to fuse.  (The layout-order
            # half of the predicate needs matricization and stays with the
            # compiler; _score prices the compiled plan, so any residual
            # optimism is corrected before candidates are ranked.)
            consumed_next = (i + 1 < len(plan.steps) and
                             plan.steps[i + 1].lhs == step.out and
                             uses.get(step.out, 0) == 1)
            if consumed_next and out_elems * hw.dtype_bytes <= hw.vmem_bytes // 2:
                resident.add(step.out)
                write = 0
        step_costs.append(evaluate_step(step, sizes, hw, read, write))
    flops = sum(s.flops for s in step_costs)
    bytes_hbm = sum(s.bytes_hbm for s in step_costs)
    latency = sum(s.latency_s for s in step_costs) + coll.latency_s
    energy = (flops * hw.e_flop + bytes_hbm * hw.e_hbm_byte
              + coll.bytes_ici * hw.e_ici_byte)
    return PlanCost(latency_s=latency, energy_j=energy, flops=flops,
                    bytes_hbm=bytes_hbm, steps=tuple(step_costs),
                    bytes_ici=coll.bytes_ici, collective_s=coll.latency_s,
                    peak_bytes=plan_peak_elems(plan) * hw.dtype_bytes)
