"""Plan compiler — lowers a :class:`ContractionPlan` to CUDA kernel calls.

Port of ``src/repro/core/plan_compiler.py``.  The pipeline is the
reference's:

1. **Matricization** — each :class:`ContractionStep` is analysed into a
   GEMM ``C[M, N] = A[M, K] @ B[K, N]``: lhs-free axes flatten to M,
   rhs-free axes to N, contracted axes to K (in lhs order).  A rhs laid
   out ``[N, K]`` is not transposed in device memory: the step routes to
   :func:`~repro_torch.kernels.fused_contraction.matmul_cuda` with
   ``transpose_rhs=True``, which transposes the tile in shared memory.
   Axis orders no reshape can express get an explicit permute.

2. **Chain fusion** — maximal runs of adjacent steps where each
   intermediate is consumed exactly once, feeds the next step as its lhs
   with compatible axis groups, and the operand set fits one block's
   shared memory (:func:`_chain_fits`, the same check the kernel wrapper
   applies) fuse into one
   :func:`~repro_torch.kernels.fused_contraction.chain_n_cuda` call of up
   to ``max_chain_len`` links.  A chain the kernel refuses before launch
   (:class:`ChainLoweringError`) degrades to per-link GEMM kernels; a
   failed build or launch is a ``RuntimeError`` and propagates.

3. **Fallback** — steps that are not matricizable (batch axes shared by
   both operands and the output, e.g. BT's block hyperedge) run as the
   reference einsum step.

4. **Quantized dispatch** — a plan compiled under a quantized
   :class:`~repro_torch.precision.policy.QuantPolicy` keeps the same ops
   and runs them in :func:`_run_quantized`: input nodes through the
   quantize kernel, GEMMs and chains through their scaled kernels with
   the dequantization in the epilogue, every op's result requantized per
   tensor (:func:`_requantize`: on the card through the requantize
   kernel, amax and scale included; the reference does it in jnp), the
   output through the dequantize kernel.  A quantized chain the kernel
   refuses at run time raises on the card (compilation fused it against
   the wrapper's own budget, so that is a fault); CPU operands run the
   plain chain math instead, counted as ``runtime_quantized``.

Because the shared-memory budget (227 KB) differs from the reference's
VMEM budget (100 MiB), fusion choices may differ from the reference's;
the two are held equal on outputs.  Not ported yet: autotuned tiles
(ROADMAP.md, queue A).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Sequence, Union

import torch

from repro_torch import telemetry as tm
from repro_torch.core.contraction import (
    _einsum_spec, _einsum_step, output_perm,
)
from repro_torch.core.tnetwork import AxisId, ContractionPlan, ContractionStep
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fused_contraction import (
    ChainLoweringError, chain_band_rows, chain_n_cuda, chain_plan,
    matmul_cuda,
)
from repro_torch.kernels.quantized import (
    dequantize_cuda, quantize_cuda, requantize_cuda,
)
from repro_torch.precision import policy as qpolicy
from repro_torch.precision import quant as q

_log = tm.get_logger("plan_compiler")

#: ChainLoweringError degrades by site, always counted (tracer on or off);
#: mirrored into the tracer as ``plan_compiler.chain_degrade.<site>``.
DEGRADE_COUNTS = {"compile": 0, "runtime": 0, "runtime_quantized": 0}


def reset_degrade_counts() -> None:
    for k in DEGRADE_COUNTS:
        DEGRADE_COUNTS[k] = 0


def _degrade(site: str, err: Exception) -> None:
    """Count a ChainLoweringError degrade and warn once per site."""
    DEGRADE_COUNTS[site] += 1
    tm.inc(f"plan_compiler.chain_degrade.{site}")
    _log.warn_once(
        f"plan_compiler.chain_degrade.{site}",
        f"chain fusion degraded to unfused GEMMs at {site}: {err} "
        "(warning once; every occurrence is counted in "
        f"plan_compiler.chain_degrade.{site})")


# ---------------------------------------------------------------------------
# Lowered ops
# ---------------------------------------------------------------------------


def _perm_or_none(src: Sequence[AxisId], dst: Sequence[AxisId]
                  ) -> tuple[int, ...] | None:
    """Permutation taking ``src`` axis order to ``dst``; None if identity."""
    if sorted(src) != sorted(dst):
        raise ValueError(f"axis sets differ: {src} vs {dst}")
    if tuple(src) == tuple(dst):
        return None
    return tuple(src.index(a) for a in dst)


@dataclass(frozen=True)
class Matricization:
    """How one step collapses to ``C[M, N] = A[M, K] @ B``.

    ``k_axes`` follow lhs order.  ``lhs_perm`` / ``rhs_perm`` are
    device-memory permutes applied before the reshape; ``transpose_rhs``
    means the rhs reshapes to ``[N, K]`` and the kernel transposes it on
    chip instead.
    """

    m_axes: tuple[AxisId, ...]
    n_axes: tuple[AxisId, ...]
    k_axes: tuple[AxisId, ...]
    m: int
    n: int
    k: int
    lhs_perm: tuple[int, ...] | None
    rhs_perm: tuple[int, ...] | None
    transpose_rhs: bool
    out_perm: tuple[int, ...] | None    # [M-axes, N-axes] -> step.out_axes

    @property
    def hbm_transposes(self) -> int:
        return sum(p is not None
                   for p in (self.lhs_perm, self.rhs_perm, self.out_perm))


@dataclass(frozen=True)
class GemmOp:
    """One step lowered to :func:`matmul_cuda`."""

    step: ContractionStep
    mat: Matricization


@dataclass(frozen=True)
class ChainOp:
    """>= 2 consecutive steps fused into one :func:`chain_n_cuda` call.

    X is ``steps[0]``'s lhs matricized to ``[m0, k]``; W_i is
    ``steps[i]``'s rhs matricized to ``link_shapes[i]``; ``m`` is the
    final row count ``m0 / prod(g_i)``.
    """

    steps: tuple[ContractionStep, ...]
    m_axes: tuple[AxisId, ...]          # LAST step's free lhs axes
    n_axes: tuple[AxisId, ...]
    m: int                              # final output rows
    m0: int                             # first link's rows (x rows)
    n: int
    k: int                              # first link's contraction size
    link_shapes: tuple[tuple[int, int], ...]   # (k_i, n_i) per link
    x_perm: tuple[int, ...] | None
    w_perms: tuple[tuple[int, ...] | None, ...]  # rhs_i -> [k_i, n_i]
    out_perm: tuple[int, ...] | None

    @property
    def length(self) -> int:
        return len(self.steps)

    @property
    def hbm_transposes(self) -> int:
        return sum(p is not None
                   for p in (self.x_perm, *self.w_perms, self.out_perm))


@dataclass(frozen=True)
class EinsumOp:
    """Non-matricizable step kept on the reference einsum path."""

    step: ContractionStep
    spec: str
    reason: str


LoweredOp = Union[GemmOp, ChainOp, EinsumOp]


# ---------------------------------------------------------------------------
# Step analysis
# ---------------------------------------------------------------------------


def matricize(step: ContractionStep) -> Matricization | str:
    """Collapse a step to GEMM form, or return the reason it cannot be."""
    lhs, rhs, out = step.lhs_axes, step.rhs_axes, step.out_axes
    if len(set(lhs)) != len(lhs) or len(set(rhs)) != len(rhs):
        return "repeated axis within an operand (trace)"
    if step.batch_axes:
        return (f"batch axes {step.batch_axes} on both operands and the "
                "output (>2D residual)")
    out_set, rhs_set, lhs_set = set(out), set(rhs), set(lhs)
    for a in step.contracted_axes:
        if not (a in lhs_set and a in rhs_set):
            return f"axis {a!r} reduced on a single operand"

    m_axes = tuple(a for a in lhs if a in out_set)
    n_axes = tuple(a for a in rhs if a in out_set)
    k_axes = tuple(a for a in lhs if a not in out_set)   # lhs order

    lhs_perm = _perm_or_none(lhs, m_axes + k_axes)
    # rhs laid out [N, K]? -> transpose the tile on chip (transpose_rhs).
    if rhs == n_axes + k_axes and k_axes:
        rhs_perm, transpose_rhs = None, True
    else:
        rhs_perm, transpose_rhs = _perm_or_none(rhs, k_axes + n_axes), False
    out_perm = _perm_or_none(m_axes + n_axes, out)

    sizes = dict(zip(lhs + rhs, step.lhs_shape + step.rhs_shape))
    prod = lambda axes: math.prod(sizes[a] for a in axes)  # noqa: E731
    return Matricization(
        m_axes=m_axes, n_axes=n_axes, k_axes=k_axes,
        m=prod(m_axes), n=prod(n_axes), k=prod(k_axes),
        lhs_perm=lhs_perm, rhs_perm=rhs_perm, transpose_rhs=transpose_rhs,
        out_perm=out_perm)


def _consumed_exactly_once(plan: ContractionPlan, slot: int,
                           consumer: ContractionStep) -> bool:
    uses = sum((s.lhs == slot) + (s.rhs == slot) for s in plan.steps)
    return uses == 1 and slot in (consumer.lhs, consumer.rhs)


def _fusable_link(plan: ContractionPlan, g_prev: GemmOp,
                  g_next: GemmOp) -> bool:
    """May ``g_next`` extend an on-chip chain ending at ``g_prev``?

    The intermediate must be consumed once and feed the next step's lhs
    in layout order: the next step keeps a prefix of the m-group free and
    consumes the remaining m-suffix plus the whole n-group as its K (the
    suffix is the TT/TTM regroup, ``chain_plan``'s ``g_i``)."""
    s_prev, s_next = g_prev.step, g_next.step
    if s_next.lhs != s_prev.out:
        return False
    if not _consumed_exactly_once(plan, s_prev.out, s_next):
        return False
    m_prev, m_next = g_prev.mat, g_next.mat
    if m_next.lhs_perm is not None or m_prev.out_perm is not None:
        return False
    keep = len(m_next.m_axes)
    if m_next.m_axes != m_prev.m_axes[:keep]:
        return False
    return m_next.k_axes == m_prev.m_axes[keep:] + m_prev.n_axes


def _chain_shapes(run: Sequence[GemmOp]) -> tuple[tuple[int, int], ...]:
    """Per-link matricized weight shapes ``(k_i, n_i)`` of a chain run."""
    return tuple((g.mat.k, g.mat.n) for g in run)


def _chain_fits(run: Sequence[GemmOp]) -> bool:
    """Whether the chain kernel accepts the run: the wrapper's own
    geometry and shared-memory check."""
    try:
        chain_band_rows(run[0].mat.m, _chain_shapes(run))
    except ChainLoweringError:
        return False
    return True


def _build_chain(run: Sequence[GemmOp]) -> ChainOp:
    """Assemble the ChainOp for a validated run of >= 2 fusable GEMMs
    (every weight as ``[k_i, n_i]``: the chain kernel takes no
    stored-transposed weight)."""
    if len(run) < 2:
        raise ChainLoweringError(f"chain needs >= 2 steps, got {len(run)}")
    first, last = run[0], run[-1]
    shapes = _chain_shapes(run)
    rows, _ = chain_plan(first.mat.m, shapes)
    if rows[-1] != last.mat.m:
        raise ChainLoweringError(
            f"chain row geometry mismatch: {rows[-1]} vs {last.mat.m}")
    w_perms = tuple(
        _perm_or_none(g.step.rhs_axes, g.mat.k_axes + g.mat.n_axes)
        for g in run)
    return ChainOp(
        steps=tuple(g.step for g in run),
        m_axes=last.mat.m_axes, n_axes=last.mat.n_axes,
        m=last.mat.m, m0=first.mat.m,
        n=last.mat.n, k=first.mat.k, link_shapes=shapes,
        x_perm=first.mat.lhs_perm, w_perms=w_perms,
        out_perm=last.mat.out_perm)


# ---------------------------------------------------------------------------
# Compilation
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CompiledPlan:
    """A :class:`ContractionPlan` lowered to kernel dispatches."""

    plan: ContractionPlan
    ops: tuple[LoweredOp, ...]
    #: quantized-execution policy (a quantized QuantPolicy) or None; the
    #: lowering is dtype-independent, the policy changes what run()
    #: streams: fp8/int8 operands, scale epilogues, requantized
    #: intermediates
    policy: object = None

    def report(self) -> dict:
        """Lowering summary — what the compiler did with the plan."""
        gemms = [op for op in self.ops if isinstance(op, GemmOp)]
        chains = [op for op in self.ops if isinstance(op, ChainOp)]
        einsums = [op for op in self.ops if isinstance(op, EinsumOp)]
        num_steps = len(self.plan.steps)
        fused_steps = sum(op.length for op in chains)
        return {
            "num_steps": num_steps,
            "num_ops": len(self.ops),
            "num_gemm": len(gemms),
            "num_chain": len(chains),
            "num_einsum_fallback": len(einsums),
            "fused_steps": fused_steps,
            "fusion_hit_rate": fused_steps / num_steps if num_steps else 0.0,
            "max_chain_len_emitted": max(
                (op.length for op in chains), default=0),
            "onchip_transposes": sum(g.mat.transpose_rhs for g in gemms),
            "hbm_transposes": (sum(g.mat.hbm_transposes for g in gemms)
                               + sum(c.hbm_transposes for c in chains)),
            "fallback_reasons": tuple(op.reason for op in einsums),
            "policy": None if self.policy is None else self.policy.tag,
        }


def compile_plan(plan: ContractionPlan, *, fuse: bool = True,
                 max_chain_len: int = 2, policy=None) -> CompiledPlan:
    """Lower every step; then (unless ``fuse=False``) fuse maximal
    eligible runs of adjacent GEMMs into chains of up to
    ``max_chain_len`` links that fit the chain kernel's shared-memory
    budget (``fused_contraction.CHAIN_SMEM_BUDGET_BYTES``; the scaled
    chain keeps its weights as f32 too, so the budget does not depend on
    the policy).  A quantized ``policy``
    (:class:`~repro_torch.precision.policy.QuantPolicy`) makes :func:`run`
    execute quantized."""
    if policy is not None and not policy.quantized:
        policy = None
    t0 = tm.now_us()
    lowered: list[LoweredOp] = []
    for step in plan.steps:
        mat = matricize(step)
        if isinstance(mat, str):
            lowered.append(EinsumOp(step=step, spec=_einsum_spec(step),
                                    reason=mat))
        else:
            lowered.append(GemmOp(step=step, mat=mat))
    if not fuse:
        return _emit_compile(CompiledPlan(plan=plan, ops=tuple(lowered),
                                          policy=policy), t0)

    fused: list[LoweredOp] = []
    i = 0
    while i < len(lowered):
        op0 = lowered[i]
        chain = None
        if isinstance(op0, GemmOp) and max_chain_len >= 2:
            run = [op0]
            while (len(run) < max_chain_len
                   and i + len(run) < len(lowered)
                   and isinstance(lowered[i + len(run)], GemmOp)
                   and _fusable_link(plan, run[-1], lowered[i + len(run)])
                   and _chain_fits(run + [lowered[i + len(run)]])):
                run.append(lowered[i + len(run)])
            if len(run) >= 2:
                try:
                    chain = _build_chain(run)
                except ChainLoweringError as err:
                    _degrade("compile", err)
        if chain is not None:
            fused.append(chain)
            i += chain.length
        else:
            fused.append(op0)
            i += 1
    return _emit_compile(CompiledPlan(plan=plan, ops=tuple(fused),
                                      policy=policy), t0)


#: compile_cached memo: id(plan) -> (plan, {(fuse, max_chain_len, policy):
#: compiled});
#: the plan is held so its id stays unique while the entry lives
_COMPILED: dict[int, tuple[ContractionPlan, dict]] = {}


def compile_cached(plan: ContractionPlan, *, fuse: bool = True,
                   max_chain_len: int = 2, policy=None) -> CompiledPlan:
    """:func:`compile_plan` memoised per plan object — eager execution
    calls the executor every forward, where the reference compiled once
    under ``jit``.  Plans come from the CSSE memo, so they are few and
    long-lived."""
    plan_ref, by_opts = _COMPILED.setdefault(id(plan), (plan, {}))
    if plan_ref is not plan:           # id reused after the plan died
        plan_ref, by_opts = _COMPILED[id(plan)] = (plan, {})
    if policy is not None and not policy.quantized:
        policy = None
    key = (fuse, max_chain_len, policy)
    got = by_opts.get(key)
    if got is None:
        got = by_opts[key] = compile_plan(plan, fuse=fuse,
                                          max_chain_len=max_chain_len,
                                          policy=policy)
    return got


def _emit_compile(compiled: CompiledPlan, t0: float) -> CompiledPlan:
    """Publish one compile's lowering summary to the tracer."""
    if not tm.enabled():
        return compiled
    tm.complete_span("plan.compile", t0, tm.now_us(),
                     steps=len(compiled.plan.steps),
                     ops=len(compiled.ops))
    rep = compiled.report()
    tm.inc("plan_compiler.compiled")
    tm.inc("plan_compiler.steps", rep["num_steps"])
    tm.inc("plan_compiler.fused_steps", rep["fused_steps"])
    tm.inc("plan_compiler.chains", rep["num_chain"])
    tm.inc("plan_compiler.einsum_fallbacks", rep["num_einsum_fallback"])
    tm.sample("plan_compiler.fusion_hit_rate", rep["fusion_hit_rate"])
    return compiled


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------


def _lead(perm: tuple[int, ...] | None, lead: int
          ) -> tuple[int, ...] | None:
    """``perm`` behind ``lead`` untouched batch axes."""
    if perm is None:
        return None
    return tuple(range(lead)) + tuple(p + lead for p in perm)


def _as_2d(x: torch.Tensor, perm: tuple[int, ...] | None,
           rows: int, cols: int, lead: int = 0) -> torch.Tensor:
    """Matricize an operand (behind ``lead`` batch axes, which stay); a
    permute is the same device-memory transpose the reference's
    ``jnp.transpose`` does."""
    if perm is not None:
        x = x.permute(_lead(perm, lead))
    return x.reshape(tuple(x.shape[:lead]) + (rows, cols)).contiguous()


def _op_reads(op: LoweredOp) -> tuple[int, ...]:
    if isinstance(op, ChainOp):
        return (op.steps[0].lhs, *(s.rhs for s in op.steps))
    return (op.step.lhs, op.step.rhs)


def run(compiled: CompiledPlan, tensors: Sequence[torch.Tensor],
        out_dtype=None, input_scales=None, batched: bool = False
        ) -> torch.Tensor:
    """Execute a compiled plan; semantics match ``contraction.execute``:
    f32 accumulation within a step, storage dtype between steps (the
    policy's dtype when the plan compiled quantized; ``input_scales``
    then carries optional delayed per-node scales).

    ``batched``: every tensor has a leading expert axis, carried through
    each layout copy; the GEMM and chain ops then launch the batched
    kernels (3-D operands, one launch for every expert), a refused chain
    degrades to one batched GEMM launch per link, and the einsum fallback
    gets the axis as one more letter.  No autograd or quantized route
    takes the axis.

    When autograd records (grad mode on and an input that requires a
    gradient: ``phase_paths=False`` training), the GEMM and chain ops
    run through the kernels' autograd Functions (:mod:`repro_torch.
    kernels.ops`), whose backward runs the GEMM kernel; otherwise through
    the kernel wrappers as they are.  The layout copies and the einsum
    fallback are torch ops, differentiable as they stand."""
    plan = compiled.plan
    net = plan.network
    if out_dtype is None:
        out_dtype = tensors[0].dtype
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
    if batched and (compiled.policy is not None or grad):
        raise NotImplementedError(
            "an expert-batched plan runs unquantized and outside autograd "
            "(ROADMAP.md, queue A items 13 and 14)")
    if compiled.policy is not None:
        return _run_quantized(compiled, tensors, out_dtype=out_dtype,
                              input_scales=input_scales)
    if not plan.steps:
        return tensors[0].to(out_dtype)

    if grad:
        matmul, chain = ops.matmul, ops.chain_n
    else:
        matmul, chain = matmul_cuda, chain_n_cuda
    lead = int(batched)
    bshape = tuple(tensors[0].shape[:lead])
    slots: dict[int, torch.Tensor] = dict(enumerate(tensors))
    sizes = net.sizes
    last_use: dict[int, int] = {}
    for t, op in enumerate(compiled.ops):
        for slot in _op_reads(op):
            last_use[slot] = t
    trace = tm.enabled()
    for t, op in enumerate(compiled.ops):
        t0 = tm.now_us() if trace else 0.0
        if isinstance(op, EinsumOp):
            res = _einsum_step(op.step, slots[op.step.lhs],
                               slots[op.step.rhs], batched=batched)
            out_slot = op.step.out
        elif isinstance(op, GemmOp):
            mat = op.mat
            x = _as_2d(slots[op.step.lhs], mat.lhs_perm, mat.m, mat.k, lead)
            if mat.transpose_rhs:
                w = _as_2d(slots[op.step.rhs], mat.rhs_perm, mat.n, mat.k,
                           lead)
            else:
                w = _as_2d(slots[op.step.rhs], mat.rhs_perm, mat.k, mat.n,
                           lead)
            res = matmul(x, w, transpose_rhs=mat.transpose_rhs,
                         out_dtype=out_dtype)
            res = res.reshape(bshape + tuple(sizes[a] for a in
                                             mat.m_axes + mat.n_axes))
            if mat.out_perm is not None:
                res = res.permute(_lead(mat.out_perm, lead))
            out_slot = op.step.out
        else:                            # ChainOp
            x = _as_2d(slots[op.steps[0].lhs], op.x_perm, op.m0, op.k, lead)
            ws = [_as_2d(slots[s.rhs], p, ki, ni, lead)
                  for (s, p), (ki, ni) in zip(zip(op.steps, op.w_perms),
                                              op.link_shapes)]
            try:
                res = chain(x, ws, out_dtype=out_dtype)
            except ChainLoweringError as err:
                # Refused before launch: one GEMM kernel per link, storage
                # dtype between links, the regroup as a reshape.
                _degrade("runtime", err)
                res = x
                for w, (ki, _) in zip(ws, op.link_shapes):
                    res = matmul(res.reshape(bshape + (-1, ki)), w,
                                 out_dtype=out_dtype)
            res = res.reshape(bshape + tuple(sizes[ax] for ax in
                                             op.m_axes + op.n_axes))
            if op.out_perm is not None:
                res = res.permute(_lead(op.out_perm, lead))
            out_slot = op.steps[-1].out
        slots[out_slot] = res.to(out_dtype)
        if trace:
            kind = ("einsum" if isinstance(op, EinsumOp)
                    else "gemm" if isinstance(op, GemmOp) else "chain")
            tm.complete_span(f"exec.{kind}", t0, tm.now_us(), op_index=t)
        for slot in _op_reads(op):
            if slot != out_slot and last_use[slot] == t and slot in slots:
                del slots[slot]

    out = slots[plan.steps[-1].out]
    perm = output_perm(plan, lead)
    if perm is not None:
        out = out.permute(perm)
    return out.to(out_dtype)


# ---------------------------------------------------------------------------
# Quantized execution (CompiledPlan.policy set)
# ---------------------------------------------------------------------------


def _quantize_input(x: torch.Tensor, scale, policy) -> q.QTensor:
    """An input node in the policy dtype: >= 2-D nodes through the
    quantize kernel on their ``[rows, -1]`` view, with the per-tensor
    scale as is or tile scales expanded per row."""
    if x.dim() < 2:
        return q.quantize(x, policy, scale=scale)
    if scale is None:
        if policy.granularity == "tile":
            amax = qpolicy.tile_amax(x, policy.tile_rows)
        else:
            amax = qpolicy.amax_of(x)
        scale = qpolicy.compute_scale(amax, policy.qmax, policy.margin)
    else:
        scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    rows = x.shape[0]
    q2 = quantize_cuda(x.reshape(rows, -1).contiguous(),
                       scale if scale.dim() == 0
                       else q.expand_row_scales(scale, rows), policy)
    return q.QTensor(q=q2.reshape(x.shape), scale=scale)


def _dequantize_output(t: q.QTensor) -> torch.Tensor:
    """The plan output back to f32 through the dequantize kernel, on its
    ``[rows, -1]`` view (the reference's ``quant.dequantize``)."""
    if t.q.dim() < 2:
        return q.dequantize(t)
    rows = t.q.shape[0]
    out = dequantize_cuda(t.q.reshape(rows, -1).contiguous(),
                          t.scale if t.per_tensor
                          else q.expand_row_scales(t.scale, rows))
    return out.reshape(t.q.shape)


def _requantize(res: torch.Tensor, policy) -> q.QTensor:
    """An op's f32 result back in the policy dtype, per tensor: on the
    card through the requantize kernel (amax, scale and cast; a permuted
    result is walked in its storage order, no copy), on the CPU through
    ``quant.quantize``, the plain ops the kernel is held to."""
    if res.device.type == "cpu":
        return q.quantize(res, policy)
    qq, scale = requantize_cuda(res, policy)
    return q.QTensor(q=qq, scale=scale)


def _run_quantized(compiled: CompiledPlan, tensors: Sequence[torch.Tensor],
                   *, out_dtype, input_scales) -> torch.Tensor:
    """Quantized dispatch (the reference's ``_run_quantized``): operands
    live in the policy dtype end to end.

    Input nodes go through the quantize kernel (delayed scales when
    ``input_scales`` gives them).  GEMM and chain ops stream the
    quantized values through the scaled kernels, with the dequantization
    in their epilogues.  Every op's f32 result is requantized per tensor
    (:func:`_requantize`).  Tile-granular input scales apply where the
    lhs reaches its GEMM as a pure reshape; a layout change that would
    move the scale groups collapses them to one per-tensor scale first
    (``per_tensor``: dequantize and quantize in torch ops; no training
    path has tile scales there).  Einsum-fallback steps dequantize, run
    the reference einsum, and requantize.  The plan output goes through
    the dequantize kernel.
    """
    policy = compiled.policy
    inter_policy = dataclasses.replace(policy, granularity="tensor")
    plan = compiled.plan
    net = plan.network
    sizes = net.sizes

    def per_tensor(t: q.QTensor) -> q.QTensor:
        return t if t.per_tensor else q.requantize_per_tensor(t, policy)

    qslots: dict[int, q.QTensor] = {
        i: _quantize_input(x, None if input_scales is None
                           else input_scales[i], policy)
        for i, x in enumerate(tensors)}
    if not plan.steps:
        return q.dequantize(qslots[0], out_dtype)

    last_use: dict[int, int] = {}
    for t, op in enumerate(compiled.ops):
        for slot in _op_reads(op):
            last_use[slot] = t
    trace = tm.enabled()
    for t, op in enumerate(compiled.ops):
        t0 = tm.now_us() if trace else 0.0
        if isinstance(op, EinsumOp):
            res = _einsum_step(op.step, q.dequantize(qslots[op.step.lhs]),
                               q.dequantize(qslots[op.step.rhs]))
            out_slot = op.step.out
        elif isinstance(op, GemmOp):
            mat = op.mat
            ql = qslots[op.step.lhs]
            if not ql.per_tensor and (mat.lhs_perm is not None
                                      or not mat.m_axes):
                ql = per_tensor(ql)
            x2 = _as_2d(ql.q, mat.lhs_perm, mat.m, mat.k)
            sl = q.expand_row_scales(ql.scale, mat.m)
            qr = per_tensor(qslots[op.step.rhs])
            if mat.transpose_rhs:
                w2 = _as_2d(qr.q, mat.rhs_perm, mat.n, mat.k)
            else:
                w2 = _as_2d(qr.q, mat.rhs_perm, mat.k, mat.n)
            sr = q.expand_row_scales(qr.scale, mat.n).reshape(1, mat.n)
            res = matmul_cuda(x2, w2, transpose_rhs=mat.transpose_rhs,
                              scales=(sl, sr))
            res = res.reshape(tuple(sizes[a] for a in mat.m_axes + mat.n_axes))
            if mat.out_perm is not None:
                res = res.permute(mat.out_perm)
            out_slot = op.step.out
        else:                            # ChainOp
            qx = qslots[op.steps[0].lhs]
            if not qx.per_tensor and (op.x_perm is not None
                                      or not op.m_axes):
                qx = per_tensor(qx)
            qws = [per_tensor(qslots[s.rhs]) for s in op.steps]
            x2 = _as_2d(qx.q, op.x_perm, op.m0, op.k)
            w2s = [_as_2d(qw.q, p, ki, ni)
                   for (qw, p), (ki, ni) in zip(zip(qws, op.w_perms),
                                                op.link_shapes)]
            # Folded per-link dequantization: the lhs row scales absorb
            # W1's per-tensor scale, each interior weight contributes a
            # [1, 1] scalar, the last weight's scale applies per output
            # column.  Per-tensor scalars commute with the row regroup.
            s_first = q.expand_row_scales(qx.scale, op.m0) * qws[0].scale
            mids = [qw.scale.reshape(1, 1) for qw in qws[1:-1]]
            s_last = q.expand_row_scales(qws[-1].scale, op.n).reshape(1, op.n)
            scales = (s_first, *mids, s_last)
            try:
                res = chain_n_cuda(x2, w2s, scales=scales)
            except ChainLoweringError as err:
                # compile_plan fused this chain against the wrapper's own
                # budget, so a refusal is a fault: on the card it raises.
                # CPU operands take the plain chain's link math (the
                # reference's unfused fallback).
                if x2.is_cuda:
                    raise
                _degrade("runtime_quantized", err)
                res = ref.chain_n_scaled(x2, w2s, scales)
            res = res.reshape(tuple(sizes[ax] for ax in op.m_axes + op.n_axes))
            if op.out_perm is not None:
                res = res.permute(op.out_perm)
            out_slot = op.steps[-1].out
        qslots[out_slot] = _requantize(res, inter_policy)
        if trace:
            kind = ("einsum" if isinstance(op, EinsumOp)
                    else "gemm" if isinstance(op, GemmOp) else "chain")
            tm.complete_span(f"exec.{kind}", t0, tm.now_us(), op_index=t,
                             policy=policy.tag)
        for slot in _op_reads(op):
            if slot != out_slot and last_use[slot] == t and slot in qslots:
                del qslots[slot]

    out = _dequantize_output(qslots[plan.steps[-1].out])
    last_axes = plan.steps[-1].out_axes
    if last_axes != net.output:
        out = out.permute(tuple(last_axes.index(a) for a in net.output))
    return out.to(out_dtype)
