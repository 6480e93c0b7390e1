"""qwen2-7b — 28L d=3584 28H (GQA kv=4, head_dim 128) d_ff=18944
vocab=152064, QKV bias.

Port of ``src/repro/configs/qwen2_7b.py`` [arXiv:2407.10671; hf]: the
model and smoke configs are the reference's.  ``--tnn``
(``tnn_default``: TT rank 64, 2 factors, targets ``("mlp",)``)
tensorizes the SwiGLU's gate/up/down; q/k/v/o, the QKV bias and
``lm_head`` stay dense, as the reference's note says.  That leaves
1,980,923,392 parameters (embedding and ``lm_head`` 544,997,376 each,
attention 822,212,608, the MLP's 84 TT matrices 68,511,744), about 31.7
GB of f32 weights, gradients and two AdamW moments: the full model
trains on one 80 GB card.
"""
from repro_torch.configs.base import ArchConfig, register
from repro_torch.core.tensorized import TNNConfig
from repro_torch.models.lm import LMConfig


def make_model(tnn=None):
    return LMConfig(
        name="qwen2-7b", num_layers=28, d_model=3584, num_heads=28,
        num_kv_heads=4, head_dim=128, d_ff=18944, vocab=152064,
        qkv_bias=True, tnn=tnn or TNNConfig())


def make_smoke(tnn=None):
    return LMConfig(
        name="qwen2-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
        qkv_bias=True, remat=False, tnn=tnn or TNNConfig())


CONFIG = register(ArchConfig(
    id="qwen2_7b", family="dense", model_kind="lm",
    make_model=make_model, make_smoke=make_smoke,
    notes="QKV bias kept dense under TNN; long_500k skipped (full attention)",
))
