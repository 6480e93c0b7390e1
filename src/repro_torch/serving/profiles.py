"""Phase-specialized execution profiles: CSSE per serving phase.

Port of ``src/repro/serving/profiles.py``.  Serving has two steady
states with very different flattened token batches — **prefill**
(``batch_size * prefill_chunk`` tokens per tick) and **decode**
(``batch_size`` tokens) — and the best contraction sequence differs
between them.  :func:`build_profiles` runs the plan search once per
phase at server start, each under its own phase-tagged
:class:`~repro_torch.core.policy.ExecutionPolicy`, so the two phases
resolve distinct cache entries even when their shapes coincide.

A MoE model's expert layers (the port lists them where the reference
lists the dense MLP's shapes) see another token batch: the slots of
every expert, ``batch_size * capacity(tokens a slot sends)``, since each
slot is one token group; their plans are searched there.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import csse, perf_model, tensorized
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.core.tensorized import TNNConfig


@dataclasses.dataclass(frozen=True)
class ExecutionProfile:
    """One serving phase's resolved planning state.

    ``signatures`` maps projection name -> the CSSE cache key its forward
    plan resolved under (phase-tagged).  ``modeled_latency_s`` is the
    summed modeled forward latency of one tick's tensorized projections
    on the hardware model — a ranking signal, not a measurement.
    """

    phase: str                              # "prefill" | "decode"
    tokens: int                             # flattened token batch per tick
    opts: csse.SearchOptions
    signatures: tuple[tuple[str, str], ...]
    modeled_latency_s: float
    policy: ExecutionPolicy | None = None
    expert_tokens: int | None = None        # MoE: an expert's plan batch


def phase_tnn(tnn: TNNConfig, phase: str) -> TNNConfig:
    """Tag a TNN config with an execution phase (plan cache keys only)."""
    return dataclasses.replace(tnn, phase=phase)


def tensorized_projections(cfg) -> list[tuple[str, int, int]]:
    """``(name, d_in, d_out)`` of every distinct tensorized projection an
    ``LMConfig`` (or an ``EncDecConfig``: the attention family's, for
    both stacks and the cross-attention) instantiates, per its
    ``tnn.targets``.  For Mamba-2 the
    port also lists the block's ``in`` (``mix``) and ``out`` projections
    and, for the hybrid, the shared block's attention and MLP (the
    reference lists the attention family's projections for every
    block), and for a MoE model its expert layers (``experts.in``,
    ``experts.down`` at ``d_ff_expert``) in the MLP's place."""
    c = cfg
    out: list[tuple[str, int, int]] = []
    seen: set[tuple[int, int]] = set()

    def add(name, d_in, d_out):
        if (d_in, d_out) not in seen:
            seen.add((d_in, d_out))
            out.append((name, d_in, d_out))

    targets = c.tnn.targets
    block = getattr(c, "block", "attn")
    if block == "rwkv6":
        # RWKV-6: r/k/v/g and cm_r are "mix", o is "out", cm_k/cm_v "mlp"
        if "mix" in targets:
            add("rwkv.mix", c.d_model, c.d_model)
        if "out" in targets:
            add("rwkv.o", c.d_model, c.d_model)
        if "mlp" in targets:
            add("rwkv.cm_k", c.d_model, c.d_ff)
            add("rwkv.cm_v", c.d_ff, c.d_model)
        return out
    d_ff = c.moe.d_ff_expert if getattr(c, "moe", None) else c.d_ff
    if block == "mamba2":
        d_inner = 2 * c.d_model
        if "mix" in targets:
            add("mamba.in", c.d_model,
                2 * d_inner + 2 * c.ssm_state + d_inner // c.hd)
        if "out" in targets:
            add("mamba.out", d_inner, c.d_model)
        if not c.hybrid:
            return out
        d_ff = c.hybrid.d_ff_shared or c.d_ff
    if "qkv" in targets:
        add("attn.q", c.d_model, c.num_heads * c.hd)
        add("attn.kv", c.d_model, c.num_kv_heads * c.hd)
    if "out" in targets:
        add("attn.o", c.num_heads * c.hd, c.d_model)
    if "mlp" in targets and getattr(c, "moe", None) is not None:
        add("experts.in", c.d_model, d_ff)
        add("experts.down", d_ff, c.d_model)
    elif "mlp" in targets:
        add("mlp.in", c.d_model, d_ff)
        add("mlp.down", d_ff, c.d_model)
    return out


def expert_tokens(cfg, groups: int, tokens_per_group: int) -> int | None:
    """The token batch of a MoE model's expert plans when ``groups``
    token groups of ``tokens_per_group`` each pass a layer: every group's
    capacity, folded (None without MoE)."""
    m = getattr(cfg, "moe", None)
    if m is None:
        return None
    from repro_torch.models.blocks import moe_capacity
    return groups * moe_capacity(tokens_per_group, m.top_k, m.num_experts,
                                 m.capacity_factor)


def build_profile(cfg, phase: str, tokens: int,
                  hw: perf_model.HardwareModel = perf_model.H100_SXM,
                  groups: int = 1) -> ExecutionProfile:
    """Search (or recall) plans for every tensorized projection at this
    phase's token batch (``tokens`` over ``groups`` slots: a MoE's
    expert layers at :func:`expert_tokens`); returns the profile with
    its cache keys."""
    tnn = phase_tnn(cfg.tnn, phase)
    policy = tnn.execution_policy(cfg.compute_dtype)
    opts = csse.SearchOptions.from_policy(policy)
    sigs: list[tuple[str, str]] = []
    latency = 0.0
    e_tokens = expert_tokens(cfg, groups, tokens // groups)
    for name, d_in, d_out in tensorized_projections(cfg):
        layer = tensorized.make_tensorized_linear(
            d_out, d_in, tnn, param_dtype=cfg.param_dtype,
            compute_dtype=cfg.compute_dtype, device="meta")
        n = e_tokens if name.startswith("experts.") else tokens
        fp = tensorized.fp_plan(layer.fact, n, layer.opts, hw)
        net = layer.fact.forward_network(batch_axes=(("b", n),))
        sigs.append((name, csse.plan_signature(net, layer.opts, hw)))
        latency += fp.cost.latency_s
    return ExecutionProfile(phase=phase, tokens=tokens, opts=opts,
                            signatures=tuple(sigs),
                            modeled_latency_s=latency, policy=policy,
                            expert_tokens=e_tokens)


def build_profiles(cfg, *, batch_size: int, prefill_chunk: int,
                   hw: perf_model.HardwareModel = perf_model.H100_SXM
                   ) -> dict[str, ExecutionProfile]:
    """Server-start planning: one profile per phase, keyed ``"prefill"``
    / ``"decode"``.  Empty when the model has nothing tensorized."""
    if not (cfg.tnn and cfg.tnn.enabled):
        return {}
    return {
        "prefill": build_profile(cfg, "prefill",
                                 batch_size * prefill_chunk, hw,
                                 groups=batch_size),
        "decode": build_profile(cfg, "decode", batch_size, hw,
                                groups=batch_size),
    }


def profile_summary(profiles: dict[str, ExecutionProfile]) -> str:
    """One line per phase for server-start logging."""
    lines = []
    for phase, p in profiles.items():
        experts = ("" if p.expert_tokens is None
                   else f" experts: tokens/expert={p.expert_tokens}")
        lines.append(
            f"[profiles] {phase}: tokens/tick={p.tokens} "
            f"projections={len(p.signatures)} "
            f"modeled={p.modeled_latency_s * 1e6:.1f}us{experts}")
    return "\n".join(lines)
