"""Mixed-precision contraction subsystem (port of ``src/repro/precision/``).

:mod:`.policy` holds :class:`QuantPolicy` and the scale math,
:mod:`.quant` the quantize/dequantize semantics the kernels are held to.
"""

from repro_torch.precision.policy import (
    ALIASES, AMAX_KEY, DTYPES, QuantPolicy, amax_of, compute_scale,
    scale_from_history, tile_amax, update_history,
)
from repro_torch.precision.quant import (
    QTensor, dequantize, expand_row_scales, quantize, quantize_nodes,
    requantize_per_tensor,
)

__all__ = [
    "ALIASES", "AMAX_KEY", "DTYPES", "QTensor", "QuantPolicy",
    "amax_of", "compute_scale", "dequantize", "expand_row_scales",
    "quantize", "quantize_nodes", "requantize_per_tensor",
    "scale_from_history", "tile_amax", "update_history",
]
