"""Contraction-plan executor: lowers a ContractionPlan to torch ops.

Port of ``src/repro/core/contraction.py`` (single device).
``backend="einsum"`` runs each :class:`ContractionStep` as one
``torch.einsum`` on f32 operands — f32 accumulation within a step, the
storage dtype between steps, the reference's semantics — and is what the
kernel backend is tested against.  ``backend="cuda"`` (``"pallas"`` is
accepted as an alias, so reference configs carry over) compiles the plan
with :mod:`repro_torch.core.plan_compiler` into calls of the hand-written
GEMM and chain kernels.  Under a quantized ``policy`` both backends run
the precision subsystem's semantics (the einsum one as separate
quantize / dequantize-einsum / requantize ops, the parity oracle of the
kernels' fused scales).

``batch=E`` runs E networks of the same plan at once: every tensor
carries a leading expert axis (``[E, *node_shape]``), each einsum step
gets one more letter and the kernel backend launches the batched
kernels, one launch for all E (the reference's ``jax.vmap`` over the
experts' stacked cores).  Under a quantized policy ``groups=G`` adds the
token groups: a tensor is then an expert's (``[E, *node_shape]``, its
cores) or an instance's (``[E, G, *node_shape]``), every quantize and
requantize is per expert or per instance, and a step with an instance
operand is per instance (the reference's ``jax.vmap`` over the groups of
its quantized layer, with the cores broadcast, inside the vmap over the
experts): on the einsum backend the group axis is one more letter, the
CPU oracle of the kernels' instance batch.

Not ported yet: the SPMD ``mesh`` path (distributed slice, ROADMAP.md
queue A).
"""

from __future__ import annotations

import dataclasses
import string
from typing import Sequence

import torch

from repro_torch.core.tnetwork import ContractionPlan, ContractionStep

_LETTERS = string.ascii_lowercase + string.ascii_uppercase

#: backend names :func:`execute` accepts -> the executor that runs them
BACKENDS = {"einsum": "einsum", "cuda": "cuda", "pallas": "cuda"}


def canonical_backend(backend: str) -> str:
    try:
        return BACKENDS[backend]
    except KeyError:
        raise ValueError(f"unknown backend {backend!r}; one of "
                         f"{sorted(BACKENDS)}") from None


def _einsum_spec(step: ContractionStep, batched: bool = False) -> str:
    """The step as an einsum spec; ``batched`` prefixes one more letter
    to every operand (a leading expert axis)."""
    axes = []
    for a in step.lhs_axes + step.rhs_axes + step.out_axes:
        if a not in axes:
            axes.append(a)
    if len(axes) + batched > len(_LETTERS):
        raise ValueError(f"too many axes in one step: {len(axes)}")
    sym = {a: _LETTERS[i + batched] for i, a in enumerate(axes)}
    b = _LETTERS[0] if batched else ""
    lhs = "".join(sym[a] for a in step.lhs_axes)
    rhs = "".join(sym[a] for a in step.rhs_axes)
    out = "".join(sym[a] for a in step.out_axes)
    return f"{b}{lhs},{b}{rhs}->{b}{out}"


def _einsum_step(step: ContractionStep, lhs: torch.Tensor,
                 rhs: torch.Tensor, batched: bool = False) -> torch.Tensor:
    """One reference step: exact products of the operands accumulated in
    f32 (the reference's ``preferred_element_type=f32``).  Shared by the
    einsum backend and the plan compiler's fallback path."""
    return torch.einsum(_einsum_spec(step, batched), lhs.float(),
                        rhs.float())


def _einsum_step_lead(step: ContractionStep, lhs: torch.Tensor,
                      rhs: torch.Tensor, lhs_lead: int, rhs_lead: int
                      ) -> torch.Tensor:
    """:func:`_einsum_step` on operands with ``lhs_lead`` / ``rhs_lead``
    leading instance axes (0; 1, an expert's; 2, an (expert, group)
    instance's): the expert and group axes as two more letters, the
    result carrying the most either operand has."""
    if lhs_lead == rhs_lead < 2:
        return _einsum_step(step, lhs, rhs, batched=bool(lhs_lead))
    axes = []
    for a in step.lhs_axes + step.rhs_axes + step.out_axes:
        if a not in axes:
            axes.append(a)
    if len(axes) + 2 > len(_LETTERS):
        raise ValueError(f"too many axes in one step: {len(axes)}")
    sym = {a: _LETTERS[i + 2] for i, a in enumerate(axes)}
    inst = _LETTERS[:2]
    lead = max(lhs_lead, rhs_lead)
    spec = (f"{inst[:lhs_lead]}{''.join(sym[a] for a in step.lhs_axes)},"
            f"{inst[:rhs_lead]}{''.join(sym[a] for a in step.rhs_axes)}->"
            f"{inst[:lead]}{''.join(sym[a] for a in step.out_axes)}")
    return torch.einsum(spec, lhs.float(), rhs.float())


def output_perm(plan: ContractionPlan, lead: int = 0):
    """The permute taking the last step's output axes to the network's
    output order (after ``lead`` batch axes), or None."""
    last_axes = plan.steps[-1].out_axes
    if last_axes == plan.network.output:
        return None
    return tuple(range(lead)) + tuple(
        lead + last_axes.index(a) for a in plan.network.output)


def execute(plan: ContractionPlan, tensors: Sequence[torch.Tensor],
            out_dtype=None, backend: str = "einsum",
            fused_chain: bool = True, max_chain_len: int = 2,
            policy=None, input_scales=None,
            batch: int | None = None,
            groups: int | None = None) -> torch.Tensor:
    """Run the plan over concrete tensors (one per network node, in order;
    with ``batch`` each ``[batch, *node_shape]``, and with ``groups``
    (quantized only) each ``[batch, *node_shape]`` or ``[batch, groups,
    *node_shape]``: the result is per instance, ``[batch, groups, ...]``,
    when any input is).

    ``fused_chain`` / ``max_chain_len`` steer the cuda backend's chain
    fusion (the einsum backend runs step by step either way).

    ``policy`` may be an :class:`~repro_torch.core.policy.ExecutionPolicy`
    (its fusion axis then overrides ``fused_chain`` / ``max_chain_len``
    and its precision axis is threaded as below) or a
    :class:`~repro_torch.precision.policy.QuantPolicy`, which quantizes
    the execution: input nodes in the policy dtype, f32 accumulation with
    the dequantization scales applied per step, intermediates requantized
    per tensor; the result is a real (dequantized) tensor.
    ``input_scales`` (one f32 scale or None per node) overrides the
    just-in-time amax scales: the delayed scaling of ``TensorizedLinear``.
    Batched, a node's scale is one per leading index (``[batch]`` or
    ``[batch, groups]``, its tensor's leading axes).
    """
    from repro_torch.core.policy import ExecutionPolicy
    if isinstance(policy, ExecutionPolicy):
        fused_chain = policy.fused_chain
        max_chain_len = policy.max_chain_len
        policy = policy.quant_policy
    if policy is not None and not policy.quantized:
        policy = None                       # bf16 policy: the plain path
    backend = canonical_backend(backend)
    net = plan.network
    if len(tensors) != net.num_nodes:
        raise ValueError(f"plan has {net.num_nodes} nodes, got "
                         f"{len(tensors)} tensors")
    lead = () if batch is None else (batch,)
    if groups is not None and (batch is None or policy is None):
        raise ValueError("groups need a batch and a quantized policy")
    for i, t in enumerate(tensors):
        shapes = [lead + net.node_shape(i)]
        if groups is not None:
            shapes.append(lead + (groups,) + net.node_shape(i))
        if tuple(t.shape) not in shapes:
            raise ValueError(f"node {net.node_names[i]}: expected "
                             f"{' or '.join(map(str, shapes))}, got "
                             f"{tuple(t.shape)}")
    if out_dtype is None:
        out_dtype = tensors[0].dtype

    if backend == "cuda":
        from repro_torch.core import plan_compiler
        compiled = plan_compiler.compile_cached(
            plan, fuse=fused_chain, max_chain_len=max_chain_len,
            policy=policy)
        return plan_compiler.run(compiled, tensors, out_dtype=out_dtype,
                                 input_scales=input_scales,
                                 batched=batch is not None)

    if policy is not None:
        return _execute_einsum_quantized(plan, tensors, policy, input_scales,
                                         out_dtype, batch is not None)

    if not plan.steps:                      # single-node network
        return tensors[0].to(out_dtype)
    slots: dict[int, torch.Tensor] = dict(enumerate(tensors))
    for step in plan.steps:
        res = _einsum_step(step, slots[step.lhs], slots[step.rhs],
                           batched=batch is not None)
        # f32 accumulation within a step, storage dtype between steps.
        slots[step.out] = res.to(out_dtype)
        for op in (step.lhs, step.rhs):
            if op in slots and not _used_later(plan, step, op):
                del slots[op]
    out = slots[plan.steps[-1].out]
    perm = output_perm(plan, len(lead))
    if perm is not None:
        out = out.permute(perm)
    return out.to(out_dtype)


def _execute_einsum_quantized(plan: ContractionPlan, tensors, policy,
                              input_scales, out_dtype, batched: bool = False
                              ) -> torch.Tensor:
    """Reference semantics of quantized execution: quantize the input
    nodes (delayed scales where given), dequantize and einsum every step
    with f32 accumulation, requantize each intermediate per tensor.
    ``batched``: per expert or per (expert, group) instance, by each
    tensor's leading axes (:func:`execute`)."""
    from repro_torch.precision import quant as q

    inter_policy = dataclasses.replace(policy, granularity="tensor")
    net = plan.network
    leads = [t.dim() - len(net.node_shape(i)) if batched else 0
             for i, t in enumerate(tensors)]
    qslots = {i: q.quantize(x, policy, lead=leads[i],
                            scale=None if input_scales is None
                            else input_scales[i])
              for i, x in enumerate(tensors)}
    if not plan.steps:
        return q.dequantize(qslots[0], out_dtype)
    for step in plan.steps:
        ql, qr = qslots[step.lhs], qslots[step.rhs]
        res = _einsum_step_lead(step, q.dequantize(ql), q.dequantize(qr),
                                ql.lead, qr.lead)
        qslots[step.out] = q.quantize(res, inter_policy,
                                      lead=max(ql.lead, qr.lead))
        for op in (step.lhs, step.rhs):
            if op in qslots and not _used_later(plan, step, op):
                del qslots[op]
    final = qslots[plan.steps[-1].out]
    out = q.dequantize(final)
    perm = output_perm(plan, final.lead)
    if perm is not None:
        out = out.permute(perm)
    return out.to(out_dtype)


def _used_later(plan: ContractionPlan, current: ContractionStep, slot: int
                ) -> bool:
    after = False
    for s in plan.steps:
        if after and slot in (s.lhs, s.rhs):
            return True
        if s is current:
            after = True
    return False
