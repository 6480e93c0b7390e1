"""olmoe-1b-7b — 16L d=2048 16H (kv=16) MoE 64e top-8, d_ff_expert=1024,
vocab=50304.

Port of ``src/repro/configs/olmoe_1b_7b.py`` [arXiv:2409.02060; hf]: the
model and smoke configs are the reference's.  ``--tnn``
(``tnn_default``: TT rank 64, 2 factors, targets ``("mlp",)``) stores
each expert's gate/up/down as TT cores stacked over the 64 experts; the
attention, the f32 router and the untied embedding and ``lm_head`` stay
dense.  That leaves 1,565,067,264 parameters (the experts' cores about
1.09 B, attention 268 M, embedding and ``lm_head`` 206 M), about 25.0 GB
of f32 weights, gradients and two AdamW moments: the full model trains on
one 80 GB card.  The dense model (6.92 B parameters, ~111 GB of training
state) does not.
"""
from repro_torch.configs.base import ArchConfig, register
from repro_torch.core.tensorized import TNNConfig
from repro_torch.models.lm import LMConfig, MoESpec


def make_model(tnn=None):
    return LMConfig(
        name="olmoe-1b-7b", num_layers=16, d_model=2048, num_heads=16,
        num_kv_heads=16, head_dim=128, d_ff=1024, vocab=50304,
        moe=MoESpec(num_experts=64, top_k=8, d_ff_expert=1024),
        tnn=tnn or TNNConfig())


def make_smoke(tnn=None):
    return LMConfig(
        name="olmoe-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=64, vocab=256,
        moe=MoESpec(num_experts=4, top_k=2, d_ff_expert=64),
        remat=False, tnn=tnn or TNNConfig())


CONFIG = register(ArchConfig(
    id="olmoe_1b_7b", family="moe", model_kind="lm",
    make_model=make_model, make_smoke=make_smoke,
    notes="64 experts top-8; long_500k skipped (full attention)",
))
