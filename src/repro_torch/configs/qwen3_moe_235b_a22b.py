"""qwen3-moe-235b-a22b — 94L d=4096 64H (GQA kv=4, head_dim 128) MoE 128e
top-8, d_ff_expert=1536, vocab=151936.

Port of ``src/repro/configs/qwen3_moe_235b_a22b.py`` [hf:Qwen/Qwen3-30B-A3B
family; hf]: the model and smoke configs are the reference's.  The port
runs it at smoke size only: the full config is registered for its
dimensions and never built (its weights alone pass one card's memory).
"""
from repro_torch.configs.base import ArchConfig, register
from repro_torch.core.tensorized import TNNConfig
from repro_torch.models.lm import LMConfig, MoESpec


def make_model(tnn=None):
    return LMConfig(
        name="qwen3-moe-235b-a22b", num_layers=94, d_model=4096, num_heads=64,
        num_kv_heads=4, head_dim=128, d_ff=1536, vocab=151936,
        moe=MoESpec(num_experts=128, top_k=8, d_ff_expert=1536),
        tnn=tnn or TNNConfig())


def make_smoke(tnn=None):
    return LMConfig(
        name="qwen3-moe-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=64, vocab=256,
        moe=MoESpec(num_experts=8, top_k=2, d_ff_expert=64),
        remat=False, tnn=tnn or TNNConfig())


CONFIG = register(ArchConfig(
    id="qwen3_moe_235b_a22b", family="moe", model_kind="lm",
    make_model=make_model, make_smoke=make_smoke,
    notes="expert-parallel over `model`; long_500k skipped (full attention)",
))
