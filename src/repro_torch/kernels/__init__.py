"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Port of ``src/repro/kernels/``: :mod:`.fused_contraction` (GEMM, chain,
each with a scaled fp8/int8 form), :mod:`.quantized` (quantize,
dequantize), :mod:`.flash_attention` and :mod:`.ssm_scan` hold the
kernel wrappers (sources in ``csrc/``, built by :mod:`.build` at first
use), :mod:`.ref` the plain versions they are held against, and
:mod:`.ops` the differentiable ``linear_scan``.
"""
