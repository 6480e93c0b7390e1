"""rwkv6-7b — Finch: 32L d_model=4096 attention-free, data-dependent decay.

Port of ``src/repro/configs/rwkv6_7b.py`` [arXiv:2404.05892; hf]:
d_ff=14336 (channel mix), vocab=65536, head_dim 64.  The model and smoke
configs are the reference's; ``--tnn`` tensorizes the channel mix's
``cm_k`` / ``cm_v`` (``tnn_default``: TT rank 64, 2 factors, targets
``("mlp",)``).
"""
from repro_torch.configs.base import ArchConfig, register
from repro_torch.core.tensorized import TNNConfig
from repro_torch.models.lm import LMConfig


def make_model(tnn=None):
    return LMConfig(
        name="rwkv6-7b", num_layers=32, d_model=4096, num_heads=64,
        num_kv_heads=64, head_dim=64, d_ff=14336, vocab=65536,
        block="rwkv6", tnn=tnn or TNNConfig())


def make_smoke(tnn=None):
    return LMConfig(
        name="rwkv6-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab=256,
        block="rwkv6", remat=False, tnn=tnn or TNNConfig())


CONFIG = register(ArchConfig(
    id="rwkv6_7b", family="ssm", model_kind="lm",
    make_model=make_model, make_smoke=make_smoke,
    notes="attention-free; long_500k runs on the recurrent state",
))
