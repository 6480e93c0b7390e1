"""internlm2-1.8b — 24L d=2048 16H (GQA kv=8, head_dim 128) d_ff=8192
vocab=92544.

Port of ``src/repro/configs/internlm2_1_8b.py`` [arXiv:2403.17297; hf]:
the model and smoke configs are the reference's; ``--tnn`` tensorizes
the SwiGLU (``tnn_default``).
"""
from repro_torch.configs.base import ArchConfig, register
from repro_torch.core.tensorized import TNNConfig
from repro_torch.models.lm import LMConfig


def make_model(tnn=None):
    return LMConfig(
        name="internlm2-1.8b", num_layers=24, d_model=2048, num_heads=16,
        num_kv_heads=8, head_dim=128, d_ff=8192, vocab=92544,
        tnn=tnn or TNNConfig())


def make_smoke(tnn=None):
    return LMConfig(
        name="internlm2-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
        remat=False, tnn=tnn or TNNConfig())


CONFIG = register(ArchConfig(
    id="internlm2_1_8b", family="dense", model_kind="lm",
    make_model=make_model, make_smoke=make_smoke,
    notes="GQA dense; long_500k skipped (full attention)",
))
