"""PyTorch/CUDA port of the FETTA tensorized-network system (``src/repro/``).

The package mirrors the JAX reference module for module
(``repro_torch/<x>/<y>.py`` ports ``repro/<x>/<y>.py``) and imports
neither JAX nor the reference.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; on the card the tensorized projections
reach hand-written CUDA kernels (:mod:`repro_torch.kernels`).
"""
