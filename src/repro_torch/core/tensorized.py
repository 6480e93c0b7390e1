"""TensorizedLinear — the paper's technique as a PyTorch module.

Port of ``src/repro/core/tensorized.py``.  A drop-in replacement for
``y = x @ W.T`` where ``W[M, N]`` is stored as TT / TTM / TR / HT / BT
factor cores.  The training-specific contribution of the paper (§III-A,
§IV) is a ``torch.autograd.Function`` (the reference's ``custom_vjp``):

* **FP** runs the CSSE-optimal sequence for the forward network
  ``Y[b, m..] = X[b, n..] · cores``;
* **BP** (dX) and **WG** (one network per core gradient) are different
  tensor networks over the same cores; each gets its own CSSE search
  instead of the autodiff transpose of the forward plan.  WG runs either
  ``indep`` (one network per core over {X, dY, other cores}) or
  ``shared`` (dW = X·dY once, then per-core contractions over {dW, other
  cores}), whichever the hardware model prices lower (:func:`_plans`).

Every phase runs through the einsum executor or the CUDA kernel backend
(:mod:`repro_torch.core.contraction`).  Plans are searched with the H100
model (:data:`repro_torch.core.perf_model.H100_SXM`) where the reference
defaults to its TPU model, and memoised per (layer, token batch).

Under a quantized ``precision`` every phase runs quantized with delayed
scaling (:class:`_TNNApplyQ`): the layer carries an f32 amax history
(``quant_amax``, one row per tensor role: x, dY, each core), whose
"gradient" is the state update the optimizer applies.

``phase_paths=False`` is the ablation baseline (§III-A, §IV): the FP
plan alone, and under grad plain autodiff through it, as the reference's
``jax.grad`` through its einsum steps; on the ``cuda`` backend the plan's
GEMMs and chains then run through the kernels' autograd Functions
(:mod:`repro_torch.kernels.ops`), whose backward runs the GEMM kernel.
Quantized execution with ``phase_paths=False`` serves but is refused
under grad (ROADMAP.md, queue A item 12): the reference differentiates
through its ``round``/``clip`` there.

With ``num_experts=E`` the layer is E experts' matrices under one
factorization (the reference's ``jax.vmap(layer.init)`` over a MoE's
experts): each core is one ``[E, ...]`` parameter, the input is ``[E,
T, N]`` (T tokens an expert: the MoE folds its token groups into this
axis) and every FP, BP and WG plan, searched at batch T, runs once for
all E through the batched kernels (``contraction.execute(...,
batch=E)``).  Each expert's WG gradient is then the sum over all its T
tokens, as the reference's vmap over groups sums its per-group
gradients.  Expert layers run unquantized and under ``phase_paths``
only (ROADMAP.md, queue A items 13 and 14).

Not ported yet: autotuned tiles (item 5); the SPMD mesh path (item 8).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import lru_cache

import torch
from torch import nn
from torch.profiler import record_function

from repro_torch.core import contraction, csse, factorizations, perf_model
from repro_torch.core.factorizations import Factorization
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.core.tnetwork import TensorNetwork
from repro_torch.memory.stash import (
    STORE, StashPolicy, stash, stashed_amax, unstash,
)
from repro_torch.precision.policy import (
    AMAX_KEY, QuantPolicy, amax_of, scale_from_history,
)

#: torch dtype -> the dtype name the reference's policies key on
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16"}


@dataclass(frozen=True)
class TNNConfig:
    """Config block attached to architecture configs (``cfg.tnn``)."""

    enabled: bool = False
    method: str = "tt"                    # tt|ttm|tr|ht|bt
    rank: int = 16
    num_factors: int = 3                  # how many factors to split M/N into
    targets: tuple[str, ...] = ("mlp",)   # which projections to tensorize
    phase_paths: bool = True              # per-phase CSSE (paper) vs autodiff
    objective: str = "edp"                # CSSE stage-2 metric
    fused_chain: bool = True              # model + emit on-chip chaining
    num_blocks: int = 2                   # BT only
    backend: str = "einsum"               # executor: einsum | cuda (| pallas)
    autotune: bool = False                # not ported yet (autotune slice)
    precision: QuantPolicy = field(default_factory=QuantPolicy)
    remat: str = "store"                  # stash policy: store | recompute
    memory_budget: int | None = None      # CSSE peak-footprint constraint
    phase: str = ""                       # execution-phase cache tag

    def __post_init__(self):
        contraction.canonical_backend(self.backend)

    def stash_policy(self) -> StashPolicy:
        return StashPolicy.parse(self.remat)

    def execution_policy(self, compute_dtype=None) -> ExecutionPolicy:
        """The unified :class:`ExecutionPolicy` this config describes."""
        if self.autotune:
            raise NotImplementedError(
                "TNNConfig.autotune needs the autotuner, which is not "
                "ported yet (ROADMAP.md, queue A: autotune)")
        if self.precision.quantized:
            dtype = self.precision.dtype
        else:
            dtype = _DTYPE_NAMES[compute_dtype or torch.bfloat16]
        return ExecutionPolicy(
            objective=self.objective,
            fused_chain=self.fused_chain,
            measure_dtype=dtype,
            precision=self.precision,
            stash=self.stash_policy(),
            memory_budget=self.memory_budget,
            phase=self.phase)

    def search_options(self, compute_dtype=None) -> csse.SearchOptions:
        return csse.SearchOptions.from_policy(
            self.execution_policy(compute_dtype))


# ---------------------------------------------------------------------------
# Gradient networks
# ---------------------------------------------------------------------------


def _bp_network(fact: Factorization, batch: int) -> TensorNetwork:
    """dX[b, n..] = sum_m dY[b, m..] * W[m.., n..]."""
    s, t = len(fact.out_dims), len(fact.in_dims)
    sizes = dict(fact.sizes)
    sizes["b"] = batch
    dy_axes = ("b",) + tuple(f"m{i}" for i in range(s))
    out = ("b",) + tuple(f"n{j}" for j in range(t))
    return TensorNetwork(sizes=sizes, nodes=(dy_axes,) + fact.core_axes,
                         node_names=("dY",) + fact.core_names, output=out)


def _wg_network(fact: Factorization, batch: int, core_idx: int
                ) -> TensorNetwork:
    """dG_i = contraction of {X, dY, cores j != i} with output = core i's
    axes (W is multilinear in its cores)."""
    s, t = len(fact.out_dims), len(fact.in_dims)
    sizes = dict(fact.sizes)
    sizes["b"] = batch
    nodes = [("b",) + tuple(f"n{j}" for j in range(t)),
             ("b",) + tuple(f"m{i}" for i in range(s))]
    names = ["X", "dY"]
    for j, (nm, ax) in enumerate(zip(fact.core_names, fact.core_axes)):
        if j != core_idx:
            nodes.append(ax)
            names.append(nm)
    return TensorNetwork(sizes=sizes, nodes=tuple(nodes),
                         node_names=tuple(names),
                         output=fact.core_axes[core_idx])


def _dw_network(fact: Factorization, batch: int) -> TensorNetwork:
    """Shared WG intermediate: dW[m.., n..] = sum_b X[b, n..] dY[b, m..]."""
    s, t = len(fact.out_dims), len(fact.in_dims)
    sizes = dict(fact.sizes)
    sizes["b"] = batch
    x_axes = ("b",) + tuple(f"n{j}" for j in range(t))
    dy_axes = ("b",) + tuple(f"m{i}" for i in range(s))
    out = tuple(f"m{i}" for i in range(s)) + tuple(f"n{j}" for j in range(t))
    return TensorNetwork(sizes=sizes, nodes=(x_axes, dy_axes),
                         node_names=("X", "dY"), output=out)


def _wg_from_dw_network(fact: Factorization, core_idx: int) -> TensorNetwork:
    """dG_i from the stashed dW: contraction of {dW, cores j != i}."""
    s, t = len(fact.out_dims), len(fact.in_dims)
    nodes = [tuple(f"m{i}" for i in range(s))
             + tuple(f"n{j}" for j in range(t))]
    names = ["dW"]
    for j, (nm, ax) in enumerate(zip(fact.core_names, fact.core_axes)):
        if j != core_idx:
            nodes.append(ax)
            names.append(nm)
    return TensorNetwork(sizes=dict(fact.sizes), nodes=tuple(nodes),
                         node_names=tuple(names),
                         output=fact.core_axes[core_idx])


# ---------------------------------------------------------------------------
# Plan cache (per layer signature x batch)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _plans(fact: Factorization, batch: int, opts: csse.SearchOptions,
           hw: perf_model.HardwareModel = perf_model.H100_SXM):
    """FP/BP plans plus the cheaper of two WG strategies, ``indep`` (one
    network per core gradient over {X, dY, others}) or ``shared`` (dW =
    X·dY once, then per-core contractions over {dW, others}), by total
    modeled latency.  Returns ``(fp, bp, (kind, dw | None, wg))``."""
    fp = csse.search(fact.forward_network(batch_axes=(("b", batch),)), opts,
                     hw)
    bp = csse.search(_bp_network(fact, batch), opts, hw)
    wg_indep = tuple(csse.search(_wg_network(fact, batch, i), opts, hw)
                     for i in range(fact.num_cores))
    dw = csse.search(_dw_network(fact, batch), opts, hw)
    wg_shared = tuple(csse.search(_wg_from_dw_network(fact, i), opts, hw)
                      for i in range(fact.num_cores))
    cost_indep = sum(w.cost.latency_s for w in wg_indep)
    cost_shared = dw.cost.latency_s + sum(w.cost.latency_s
                                          for w in wg_shared)
    if cost_shared < cost_indep:
        wg = ("shared", dw, wg_shared)
    else:
        wg = ("indep", None, wg_indep)
    return fp, bp, wg


def fp_plan(fact: Factorization, batch: int, opts: csse.SearchOptions,
            hw: perf_model.HardwareModel = perf_model.H100_SXM
            ) -> csse.SearchResult:
    """The CSSE-optimal FP plan of one layer at one token batch."""
    return _plans(fact, batch, opts, hw)[0]


def phase_plans(fact: Factorization, batch: int, opts: csse.SearchOptions,
                hw: perf_model.HardwareModel = perf_model.H100_SXM
                ) -> dict[str, list[csse.SearchResult]]:
    """Every plan one training step of the layer runs, by phase:
    ``{"fp": [...], "bp": [...], "wg": [dW?, per-core...]}``."""
    fp, bp, (kind, dw, wg) = _plans(fact, batch, opts, hw)
    return {"fp": [fp], "bp": [bp],
            "wg": ([dw] if kind == "shared" else []) + list(wg)}


def layer_cost(fact: Factorization, batch: int,
               opts: csse.SearchOptions | None = None,
               hw: perf_model.HardwareModel = perf_model.H100_SXM
               ) -> dict[str, perf_model.PlanCost]:
    """Modeled FP/BP/WG cost of one tensorized layer."""
    opts = opts or csse.SearchOptions()
    phases = phase_plans(fact, batch, opts, hw)

    def ev(r):
        return perf_model.evaluate(r.plan, hw, fused_chain=opts.fused_chain,
                                   mesh=opts.mesh, policy=opts.policy)

    wg_cs = [ev(r) for r in phases["wg"]]
    return {"fp": ev(phases["fp"][0]), "bp": ev(phases["bp"][0]),
            "wg": perf_model.PlanCost(
                latency_s=sum(c.latency_s for c in wg_cs),
                energy_j=sum(c.energy_j for c in wg_cs),
                flops=sum(c.flops for c in wg_cs),
                bytes_hbm=sum(c.bytes_hbm for c in wg_cs),
                bytes_ici=sum(c.bytes_ici for c in wg_cs),
                collective_s=sum(c.collective_s for c in wg_cs),
                # WG contractions run one after another with frees in
                # between: the group's peak is the worst single plan.
                peak_bytes=max((c.peak_bytes for c in wg_cs), default=0))}


# ---------------------------------------------------------------------------
# The FP/BP/WG autograd Function (the reference's custom_vjp)
# ---------------------------------------------------------------------------


class _TNNApply(torch.autograd.Function):
    """``y = FP(x, cores)``; the backward runs the BP plan for dX and the
    chosen WG strategy for every core gradient.  ``fact`` / ``opts`` /
    ``backend`` / ``remat`` / ``batched`` are static (the reference's
    nondiff args); ``batched``: x and every core carry a leading expert
    axis, and each plan runs once for all experts.
    Each phase runs inside a ``torch.profiler`` range (``tnn.fp``,
    ``tnn.bp``, ``tnn.wg``), which ``repro_torch.analysis.train_profile``
    reads to split a step's device time by phase."""

    @staticmethod
    def forward(ctx, fact, opts, backend, remat, batched, x, *cores):
        batch = x.shape[0] if batched else None
        fp, _, _ = _plans(fact, x.shape[int(batched)], opts)
        with record_function("tnn.fp"):
            y = contraction.execute(fp.plan, [x, *cores], backend=backend,
                                    fused_chain=opts.fused_chain,
                                    max_chain_len=opts.max_chain_len,
                                    batch=batch)
        ctx.static = (fact, opts, backend, remat, batched)
        if any(ctx.needs_input_grad):
            # What survives to the backward is the stash policy's call:
            # x as is (store; recompute drops it at the model level, where
            # the per-layer checkpoint re-runs this forward) or an fp8/int8
            # payload with its scale (quantized).  Cores are parameters,
            # alive anyway.
            ctx.save_for_backward(*stash(x, remat), *cores)
        return y

    @staticmethod
    def backward(ctx, dy):
        fact, opts, backend, remat, batched = ctx.static
        payload, scale, amax, *cores = ctx.saved_tensors
        x = unstash((payload, scale, amax), remat,
                    cores[0].dtype if cores else dy.dtype)
        _, bp, (wg_kind, dw_res, wg) = _plans(fact, x.shape[int(batched)],
                                              opts)
        kw = dict(backend=backend, fused_chain=opts.fused_chain,
                  max_chain_len=opts.max_chain_len,
                  batch=x.shape[0] if batched else None)
        dy = dy.to(x.dtype)
        with record_function("tnn.bp"):
            dx = contraction.execute(bp.plan, [dy, *cores], **kw)
        dcores = []
        with record_function("tnn.wg"):
            if wg_kind == "shared":
                dw = contraction.execute(dw_res.plan, [x, dy], **kw)
                for i, w in enumerate(wg):
                    others = [c for j, c in enumerate(cores) if j != i]
                    dcores.append(contraction.execute(w.plan, [dw, *others],
                                                      **kw))
            else:
                for i, w in enumerate(wg):
                    others = [c for j, c in enumerate(cores) if j != i]
                    dcores.append(contraction.execute(
                        w.plan, [x, dy, *others], **kw))
        return (None, None, None, None, None, dx, *dcores)


# Quantized variant: the same per-phase plans, executed under a
# QuantPolicy with delayed scaling.  The amax history rides as a
# differentiable input purely for its state-update channel: the backward
# returns ``hist - new_hist`` as its gradient, and the optimizer's
# quant_amax passthrough (``p - g``, repro_torch.optim.adamw) turns that
# into ``new_hist``, so the history advances once per optimizer step.


def _phase_scales(policy: QuantPolicy, hist: torch.Tensor, rows, tensors):
    """Delayed per-tensor scales for one phase's input nodes; ``rows[i]``
    is the history row backing ``tensors[i]``."""
    return [scale_from_history(hist[row], amax_of(t), policy.qmax,
                               policy.margin)
            for row, t in zip(rows, tensors)]


def _stash_policy_q(policy: QuantPolicy, remat: StashPolicy) -> StashPolicy:
    """Quantized runs stash in the execution policy's dtype: the WG phase
    quantizes x with the same delayed scale anyway, so a quantized stash
    reproduces the executor's bits exactly."""
    return StashPolicy(mode=remat.mode, dtype=policy.dtype)


class _TNNApplyQ(torch.autograd.Function):
    """``y = FP(x, cores)`` under ``policy`` with delayed scales from the
    amax history ``hist`` (row 0: x, row 1: dY, rows 2..: the cores).  The
    backward runs BP and WG quantized and returns ``hist - new_hist`` as
    the history's gradient, ``new_hist`` being the history rolled one
    slot with this step's amaxes (x's from the forward, as stashed).  The
    reference's ``_tnn_apply_q`` / ``_tnn_q_fwd`` / ``_tnn_q_bwd``."""

    @staticmethod
    def forward(ctx, fact, opts, backend, policy, remat, x, hist, *cores):
        fp, _, _ = _plans(fact, x.shape[0], opts)
        core_rows = list(range(2, 2 + len(cores)))
        scales = _phase_scales(policy, hist, [0] + core_rows, (x, *cores))
        with record_function("tnn.fp"):
            y = contraction.execute(fp.plan, [x, *cores], backend=backend,
                                    fused_chain=opts.fused_chain,
                                    max_chain_len=opts.max_chain_len,
                                    policy=policy, input_scales=scales)
        ctx.static = (fact, opts, backend, policy, remat)
        if any(ctx.needs_input_grad):
            sp = _stash_policy_q(policy, remat)
            # A quantized stash pins the delayed scale the executor used,
            # so the backward's re-quantization of x-hat is bit-identical.
            ctx.save_for_backward(
                *stash(x, sp, scale=scales[0] if sp.quantized else None),
                hist, *cores)
        return y

    @staticmethod
    def backward(ctx, dy):
        fact, opts, backend, policy, remat = ctx.static
        payload, s_stash, amax_stash, hist, *cores = ctx.saved_tensors
        sp = _stash_policy_q(policy, remat)
        xres = (payload, s_stash, amax_stash)
        x = unstash(xres, sp, cores[0].dtype if cores else dy.dtype)
        amax_x = stashed_amax(xres, x)
        _, bp, (wg_kind, dw_res, wg) = _plans(fact, x.shape[0], opts)
        kw = dict(backend=backend, fused_chain=opts.fused_chain,
                  max_chain_len=opts.max_chain_len, policy=policy)
        dy = dy.to(x.dtype)
        core_rows = list(range(2, 2 + len(cores)))
        s_x = scale_from_history(hist[0], amax_x, policy.qmax, policy.margin)
        s_dy, *s_cores = _phase_scales(policy, hist, [1] + core_rows,
                                       (dy, *cores))
        with record_function("tnn.bp"):
            dx = contraction.execute(bp.plan, [dy, *cores],
                                     input_scales=[s_dy, *s_cores], **kw)
        dcores = []
        with record_function("tnn.wg"):
            if wg_kind == "shared":
                dw = contraction.execute(dw_res.plan, [x, dy],
                                         input_scales=[s_x, s_dy], **kw)
            for i, w in enumerate(wg):
                others = [c for j, c in enumerate(cores) if j != i]
                s_others = [s for j, s in enumerate(s_cores) if j != i]
                if wg_kind == "shared":
                    # dW has no cross-step identity: just-in-time scale.
                    dcores.append(contraction.execute(
                        w.plan, [dw, *others],
                        input_scales=[None, *s_others], **kw))
                else:
                    dcores.append(contraction.execute(
                        w.plan, [x, dy, *others],
                        input_scales=[s_x, s_dy, *s_others], **kw))
        # The state-update channel: roll every history row one slot with
        # this step's amaxes and hand back the delta as the gradient.
        current = torch.stack([amax_x, amax_of(dy)]
                              + [amax_of(c) for c in cores])
        new_hist = torch.cat([current[:, None], hist[:, :-1]], dim=1)
        return (None, None, None, None, None, dx, hist - new_hist, *dcores)


class TensorizedLinear(nn.Module):
    """``x[..., N] -> y[..., M]`` with W factorized per ``fact``.

    Parameters: ``cores`` (one tensor per factor core, in ``fact``'s core
    order and shapes, the reference's layout), with ``use_bias``
    ``bias[M]``, and under a quantized ``precision`` the delayed-scaling
    history ``quant_amax`` (f32 ``[2 + num_cores, amax_history_len]``,
    zeros: the first step scales just in time).  A quantized layer whose
    ``quant_amax`` was removed runs with just-in-time scales.

    ``num_experts=E``: E experts' matrices, each core ``[E, *core
    shape]``, ``x[E, ..., N] -> y[E, ..., M]`` (see the module's
    docstring); no bias, unquantized, ``phase_paths`` only.
    """

    def __init__(self, fact: Factorization, *, use_bias: bool = False,
                 phase_paths: bool = True,
                 opts: csse.SearchOptions | None = None,
                 param_dtype=torch.float32, compute_dtype=torch.bfloat16,
                 backend: str = "einsum", remat: StashPolicy = STORE,
                 precision: QuantPolicy = QuantPolicy(),
                 num_experts: int | None = None,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        if num_experts is not None:
            _check_experts(use_bias, phase_paths, remat, precision)
        self.num_experts = num_experts
        self.fact = fact
        self.use_bias = use_bias
        self.phase_paths = phase_paths
        self.opts = opts or csse.SearchOptions()
        self.compute_dtype = compute_dtype
        self.backend = contraction.canonical_backend(backend)
        self.remat = remat
        self.precision = precision
        std = fact.init_std(1.0 / math.sqrt(fact.N))
        lead = () if num_experts is None else (num_experts,)
        self.cores = nn.ParameterList([
            nn.Parameter((torch.randn(lead + tuple(fact.core_shape(i)),
                                      generator=generator)
                          * std).to(device=device, dtype=param_dtype))
            for i in range(fact.num_cores)])
        if use_bias:
            self.bias = nn.Parameter(
                torch.zeros(fact.M, dtype=param_dtype, device=device))
        if precision.quantized:
            # Never cast to the compute dtype: the history stays f32.
            self.register_parameter(AMAX_KEY, nn.Parameter(torch.zeros(
                (2 + fact.num_cores, precision.amax_history_len),
                dtype=torch.float32, device=device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.num_experts is not None:
            return self._forward_experts(x)
        *lead, n = x.shape
        if n != self.fact.N:
            raise ValueError(f"input dim {n} != {self.fact.N}")
        batch = math.prod(lead) if lead else 1
        xt = x.reshape((batch,) + tuple(self.fact.in_dims))
        xt = xt.to(self.compute_dtype)
        cores = [c.to(self.compute_dtype) for c in self.cores]
        quantized = self.precision.quantized
        if quantized and self.phase_paths:
            hist = self._parameters.get(AMAX_KEY)
            if hist is None:            # no history: just-in-time scales
                hist = torch.zeros(
                    (2 + self.fact.num_cores,
                     self.precision.amax_history_len),
                    dtype=torch.float32, device=xt.device)
            y = _TNNApplyQ.apply(self.fact, self.opts, self.backend,
                                 self.precision, self.remat, xt, hist,
                                 *cores)
        elif self.phase_paths:
            y = _TNNApply.apply(self.fact, self.opts, self.backend,
                                self.remat, False, xt, *cores)
        else:
            # The ablation: the FP plan, differentiated by autograd.
            if quantized and torch.is_grad_enabled() and (
                    xt.requires_grad or any(c.requires_grad for c in cores)):
                raise NotImplementedError(
                    "quantized phase_paths=False under grad (autodiff "
                    "through round/clip) is not ported yet (ROADMAP.md, "
                    "queue A item 12)")
            fp, _, _ = _plans(self.fact, batch, self.opts)
            with record_function("tnn.fp"):
                y = contraction.execute(
                    fp.plan, [xt, *cores], backend=self.backend,
                    fused_chain=self.opts.fused_chain,
                    max_chain_len=self.opts.max_chain_len,
                    policy=self.precision if quantized else None)
        y = y.reshape(tuple(lead) + (self.fact.M,))
        if self.use_bias:
            y = y + self.bias.to(self.compute_dtype)
        return y.to(x.dtype)

    def _forward_experts(self, x: torch.Tensor) -> torch.Tensor:
        """``x[E, ..., N]``: every expert's tokens through its matrix, the
        FP/BP/WG plans searched at the tokens an expert holds and run once
        for all E (the batched kernels on the ``cuda`` backend)."""
        E, *lead, n = x.shape
        if E != self.num_experts or n != self.fact.N:
            raise ValueError(f"expert input {tuple(x.shape)} for "
                             f"{self.num_experts} experts of N "
                             f"{self.fact.N}")
        _check_experts(False, self.phase_paths, self.remat, self.precision)
        tokens = math.prod(lead) if lead else 1
        xt = x.reshape((E, tokens) + tuple(self.fact.in_dims))
        xt = xt.to(self.compute_dtype)
        cores = [c.to(self.compute_dtype) for c in self.cores]
        y = _TNNApply.apply(self.fact, self.opts, self.backend, self.remat,
                            True, xt, *cores)
        return y.reshape((E, *lead, self.fact.M)).to(x.dtype)


def _check_experts(use_bias: bool, phase_paths: bool, remat: StashPolicy,
                   precision: QuantPolicy) -> None:
    """Refuse what the expert-stacked layer does not run, with the
    ROADMAP.md item that ports it."""
    if precision.quantized or remat.quantized:
        raise NotImplementedError(
            "quantized MoE experts (the batched scaled GEMM and chain, B3 "
            "and B4) are not ported yet (ROADMAP.md, queue A item 13)")
    if not phase_paths:
        raise NotImplementedError(
            "MoE experts under phase_paths=False (autodiff through the "
            "batched FP plan) are not ported yet (ROADMAP.md, queue A item "
            "14)")
    if use_bias:
        raise ValueError("expert-stacked layers carry no bias")


def make_tensorized_linear(out_features: int, in_features: int,
                           tnn: TNNConfig, use_bias: bool = False,
                           param_dtype=torch.float32,
                           compute_dtype=torch.bfloat16, device=None,
                           generator: torch.Generator | None = None,
                           num_experts: int | None = None
                           ) -> TensorizedLinear:
    out_dims = factorizations.factorize_dim(out_features, tnn.num_factors)
    in_dims = factorizations.factorize_dim(in_features, tnn.num_factors)
    kw = {"num_blocks": tnn.num_blocks} if tnn.method == "bt" else {}
    fact = factorizations.make(tnn.method, out_dims, in_dims, tnn.rank, **kw)
    return TensorizedLinear(fact, use_bias=use_bias,
                            phase_paths=tnn.phase_paths,
                            opts=tnn.search_options(compute_dtype),
                            param_dtype=param_dtype,
                            compute_dtype=compute_dtype,
                            backend=tnn.backend, remat=tnn.stash_policy(),
                            precision=tnn.precision,
                            num_experts=num_experts, device=device,
                            generator=generator)
