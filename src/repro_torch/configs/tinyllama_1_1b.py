"""tinyllama-1.1b — 22L d=2048 32H (GQA kv=4, head_dim 64) d_ff=5632
vocab=32000 (llama2 arch, small).

Port of ``src/repro/configs/tinyllama_1_1b.py`` [arXiv:2401.02385; hf]:
the model and smoke configs are the reference's; ``--tnn`` tensorizes
the SwiGLU (``tnn_default``).
"""
from repro_torch.configs.base import ArchConfig, register
from repro_torch.core.tensorized import TNNConfig
from repro_torch.models.lm import LMConfig


def make_model(tnn=None):
    return LMConfig(
        name="tinyllama-1.1b", num_layers=22, d_model=2048, num_heads=32,
        num_kv_heads=4, head_dim=64, d_ff=5632, vocab=32000,
        tnn=tnn or TNNConfig())


def make_smoke(tnn=None):
    return LMConfig(
        name="tinyllama-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
        remat=False, tnn=tnn or TNNConfig())


CONFIG = register(ArchConfig(
    id="tinyllama_1_1b", family="dense", model_kind="lm",
    make_model=make_model, make_smoke=make_smoke,
    notes="long_500k skipped (full attention)",
))
