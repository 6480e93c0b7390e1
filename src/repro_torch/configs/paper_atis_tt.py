"""The paper's own Transformer-on-ATIS benchmark (Table II row 1).

Port of ``src/repro/configs/paper_atis_tt.py``: a small transformer whose
MLP, QKV and output projections are TT-compressed at the paper's shapes
(d = 768, TT rank 8, three factors per dimension).  The model config is
the reference's, full width and depth.
"""
from repro_torch.configs.base import ArchConfig, register
from repro_torch.core.tensorized import TNNConfig
from repro_torch.models.lm import LMConfig

_TNN = TNNConfig(enabled=True, method="tt", rank=8, num_factors=3,
                 targets=("mlp", "qkv", "out"))


def make_model(tnn=None):
    return LMConfig(
        name="paper-atis-tt", num_layers=2, d_model=768, num_heads=12,
        num_kv_heads=12, head_dim=64, d_ff=3072, vocab=1024,
        tnn=tnn if tnn is not None else _TNN)


def make_smoke(tnn=None):
    return LMConfig(
        name="paper-atis-smoke", num_layers=2, d_model=96, num_heads=4,
        num_kv_heads=4, head_dim=24, d_ff=192, vocab=256, remat=False,
        tnn=tnn if tnn is not None else TNNConfig(
            enabled=True, method="tt", rank=4, num_factors=2,
            targets=("mlp",)))


CONFIG = register(ArchConfig(
    id="paper_atis_tt", family="dense", model_kind="lm",
    make_model=make_model, make_smoke=make_smoke,
    tnn_default=_TNN,
    notes="the paper's Table II ATIS transformer; TNN on by default",
))
