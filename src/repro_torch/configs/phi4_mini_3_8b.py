"""phi4-mini-3.8b — 32L d=3072 24H (GQA kv=8, head_dim 128) d_ff=8192
vocab=200064, RoPE + SwiGLU.

Port of ``src/repro/configs/phi4_mini_3_8b.py`` [arXiv:2412.08905; hf]:
the model and smoke configs are the reference's; ``--tnn`` tensorizes
the SwiGLU (``tnn_default``).
"""
from repro_torch.configs.base import ArchConfig, register
from repro_torch.core.tensorized import TNNConfig
from repro_torch.models.lm import LMConfig


def make_model(tnn=None):
    return LMConfig(
        name="phi4-mini-3.8b", num_layers=32, d_model=3072, num_heads=24,
        num_kv_heads=8, head_dim=128, d_ff=8192, vocab=200064,
        tnn=tnn or TNNConfig())


def make_smoke(tnn=None):
    return LMConfig(
        name="phi4-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
        remat=False, tnn=tnn or TNNConfig())


CONFIG = register(ArchConfig(
    id="phi4_mini_3_8b", family="dense", model_kind="lm",
    make_model=make_model, make_smoke=make_smoke,
    notes="long_500k skipped (full attention)",
))
