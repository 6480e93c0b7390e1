"""Port ``TensorizedLinear`` forward vs the JAX layer from the same cores.

The TT / TTM / TR cases of ``tests/test_plan_compiler.py``.  Each package
plans with its own hardware model (the reference's TPU model, the port's
H100 model), so the contraction sequences may differ; the outputs must
not: f32 within 1e-5 relative, bf16 within 2e-2 relative (roundings to
bf16 between steps land at other points).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Tiny shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the CPU.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import csse as jcsse  # noqa: E402
from repro.core import factorizations as jF  # noqa: E402
from repro.core.tensorized import TensorizedLinear as JLinear  # noqa: E402
from repro_torch.core import csse  # noqa: E402
from repro_torch.core import factorizations as F  # noqa: E402
from repro_torch.core.tensorized import (  # noqa: E402
    TensorizedLinear, TNNConfig, make_tensorized_linear,
)

CASES = {
    "tt": ((4, 4, 4), (4, 4, 4), 6),
    "ttm": ((4, 4, 4), (4, 4, 4), 6),
    "tr": ((4, 4), (4, 4), 5),
}
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


@pytest.mark.parametrize("method", sorted(CASES))
@pytest.mark.parametrize("backend", ["einsum", "cuda"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(method, backend, dtype):
    out, inp, rank = CASES[method]
    tdt, jdt, rel = DTYPES[dtype]
    jlayer = JLinear(fact=jF.make(method, out, inp, rank), use_bias=True,
                     opts=jcsse.SearchOptions(fused_chain=True),
                     compute_dtype=jdt, backend="einsum")
    layer = TensorizedLinear(F.make(method, out, inp, rank), use_bias=True,
                             opts=csse.SearchOptions(fused_chain=True),
                             compute_dtype=tdt, backend=backend,
                             device="cpu")
    rng = np.random.default_rng(7)
    cores = [rng.standard_normal(layer.fact.core_shape(i)).astype(np.float32)
             * 0.5 for i in range(layer.fact.num_cores)]
    bias = rng.standard_normal(layer.fact.M).astype(np.float32)
    x = rng.standard_normal((3, 5, layer.fact.N)).astype(np.float32)
    with torch.no_grad():
        for p, c in zip(layer.cores, cores):
            p.copy_(torch.from_numpy(c))
        layer.bias.copy_(torch.from_numpy(bias))
    got = layer(torch.from_numpy(x).to(tdt))
    want = jlayer({"cores": tuple(jnp.asarray(c) for c in cores),
                   "bias": jnp.asarray(bias)}, jnp.asarray(x).astype(jdt))
    assert got.shape == want.shape and got.dtype == tdt
    w = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.detach().float().numpy(), w, rtol=rel,
                               atol=rel * float(np.abs(w).max()))


def test_make_tensorized_linear_factors_like_the_reference():
    tnn = TNNConfig(enabled=True, rank=8, num_factors=3, backend="pallas")
    layer = make_tensorized_linear(3072, 768, tnn, device="meta")
    assert layer.fact.out_dims == (16, 16, 12)
    assert layer.fact.in_dims == (12, 8, 8)
    assert layer.backend == "cuda"
    with pytest.raises(ValueError, match="unknown backend"):
        TNNConfig(backend="xla")
    with pytest.raises(NotImplementedError, match="autotune"):
        TNNConfig(autotune=True).execution_policy()
