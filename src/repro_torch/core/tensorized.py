"""TensorizedLinear — the paper's technique as a PyTorch module.

Port of ``src/repro/core/tensorized.py``, forward only.  A drop-in
replacement for ``y = x @ W.T`` where ``W[M, N]`` is stored as TT / TTM /
TR / HT / BT factor cores.  The forward runs the CSSE-optimal sequence
for the FP network ``Y[b, m..] = X[b, n..] · cores`` — the reference's
``phase_paths=True`` FP plan — through the einsum executor or the CUDA
kernel backend.

Not ported yet: the custom backward with its own BP/WG plans
(``torch.autograd.Function``), quantized execution and autotuned tiles;
they arrive with the training, precision and autotune slices
(ROADMAP.md, queue A).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import lru_cache

import torch
from torch import nn

from repro_torch.core import contraction, csse, factorizations, perf_model
from repro_torch.core.factorizations import Factorization
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.memory.stash import StashPolicy
from repro_torch.precision.policy import QuantPolicy

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
    remat: str = "store"                  # stash policy (training slice)
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


@lru_cache(maxsize=None)
def fp_plan(fact: Factorization, batch: int, opts: csse.SearchOptions,
            hw: perf_model.HardwareModel = perf_model.H100_SXM
            ) -> csse.SearchResult:
    """The CSSE-optimal FP plan of one layer at one token batch (memoised;
    the reference's ``_plans(...)[0]``)."""
    return csse.search(fact.forward_network(batch_axes=(("b", batch),)),
                       opts, hw)


class TensorizedLinear(nn.Module):
    """``x[..., N] -> y[..., M]`` with W factorized per ``fact``.

    Parameters: ``cores`` (one tensor per factor core, in ``fact``'s core
    order and shapes, the reference's layout) and, with ``use_bias``,
    ``bias[M]``.
    """

    def __init__(self, fact: Factorization, *, use_bias: bool = False,
                 opts: csse.SearchOptions | None = None,
                 param_dtype=torch.float32, compute_dtype=torch.bfloat16,
                 backend: str = "einsum", device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.fact = fact
        self.use_bias = use_bias
        self.opts = opts or csse.SearchOptions()
        self.compute_dtype = compute_dtype
        self.backend = contraction.canonical_backend(backend)
        std = fact.init_std(1.0 / math.sqrt(fact.N))
        self.cores = nn.ParameterList([
            nn.Parameter((torch.randn(fact.core_shape(i), generator=generator)
                          * std).to(device=device, dtype=param_dtype),
                         requires_grad=False)
            for i in range(fact.num_cores)])
        if use_bias:
            self.bias = nn.Parameter(
                torch.zeros(fact.M, dtype=param_dtype, device=device),
                requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        *lead, n = x.shape
        if n != self.fact.N:
            raise ValueError(f"input dim {n} != {self.fact.N}")
        batch = math.prod(lead) if lead else 1
        xt = x.reshape((batch,) + tuple(self.fact.in_dims))
        xt = xt.to(self.compute_dtype)
        cores = [c.to(self.compute_dtype) for c in self.cores]
        fp = fp_plan(self.fact, batch, self.opts)
        y = contraction.execute(fp.plan, [xt, *cores], backend=self.backend,
                                fused_chain=self.opts.fused_chain,
                                max_chain_len=self.opts.max_chain_len)
        y = y.reshape(tuple(lead) + (self.fact.M,))
        if self.use_bias:
            y = y + self.bias.to(self.compute_dtype)
        return y.to(x.dtype)


def make_tensorized_linear(out_features: int, in_features: int,
                           tnn: TNNConfig, use_bias: bool = False,
                           param_dtype=torch.float32,
                           compute_dtype=torch.bfloat16, device=None,
                           generator: torch.Generator | None = None
                           ) -> TensorizedLinear:
    out_dims = factorizations.factorize_dim(out_features, tnn.num_factors)
    in_dims = factorizations.factorize_dim(in_features, tnn.num_factors)
    kw = {"num_blocks": tnn.num_blocks} if tnn.method == "bt" else {}
    fact = factorizations.make(tnn.method, out_dims, in_dims, tnn.rank, **kw)
    return TensorizedLinear(fact, use_bias=use_bias,
                            opts=tnn.search_options(compute_dtype),
                            param_dtype=param_dtype,
                            compute_dtype=compute_dtype,
                            backend=tnn.backend, device=device,
                            generator=generator)
