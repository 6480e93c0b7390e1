"""zamba2-7b — hybrid: 81 Mamba-2 backbone blocks (ssm_state=64) with a
parameter-shared attention block (32H MHA kv=32, d=3584, d_ff=14336)
applied every 27 layers, vocab=32000.

Port of ``src/repro/configs/zamba2_7b.py`` [arXiv:2411.15242]: the model
and smoke configs are the reference's, with its simplifications of the
HF release (one shared block, not two alternating; no per-application
LoRA on the shared weights; no concat-with-embedding input to the shared
block).  Mamba-2's head dim is ``cfg.hd`` = 112: d_inner 7168, 64 heads.

``tnn_default`` (TT rank 64, 2 factors, targets ``("mlp",)``) reaches
only the shared block's MLP and leaves 6,585,274,176 parameters, about
105 GB of f32 weights, gradients and two AdamW moments: more than one
80 GB card.  ``tnn_one_card`` adds the Mamba-2 ``in`` (``mix``) and
``out`` projections and the shared attention's ``o`` (``out``): the
FETTA-native choice, 374,829,056 parameters (about 6.0 GB of that
state), with width and depth uncut.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, register
from repro_torch.core.tensorized import TNNConfig
from repro_torch.models.lm import HybridSpec, LMConfig


def make_model(tnn=None):
    return LMConfig(
        name="zamba2-7b", num_layers=81, d_model=3584, num_heads=32,
        num_kv_heads=32, head_dim=112, d_ff=14336, vocab=32000,
        block="mamba2", ssm_state=64,
        hybrid=HybridSpec(shared_every=27, d_ff_shared=14336),
        tnn=tnn or TNNConfig())


def make_smoke(tnn=None):
    return LMConfig(
        name="zamba2-smoke", num_layers=4, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab=256,
        block="mamba2", ssm_state=16,
        hybrid=HybridSpec(shared_every=2, d_ff_shared=128),
        remat=False, tnn=tnn or TNNConfig())


_TNN_DEFAULT = ArchConfig.__dataclass_fields__["tnn_default"].default

CONFIG = register(ArchConfig(
    id="zamba2_7b", family="hybrid", model_kind="lm",
    make_model=make_model, make_smoke=make_smoke,
    notes="long_500k runs: Mamba-2 state + shared-attn KV sharded over "
          "`model`",
    tnn_one_card=dataclasses.replace(_TNN_DEFAULT,
                                     targets=("mlp", "mix", "out")),
))
