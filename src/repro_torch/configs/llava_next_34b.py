"""llava-next-34b backbone — 60L d=7168 56H (GQA kv=8, head_dim 128)
d_ff=20480 vocab=64000.

Port of ``src/repro/configs/llava_next_34b.py`` [hf:llava-hf/llava-v1.6;
unverified]: the model and smoke configs are the reference's.  The
vision frontend is a stub: inputs are precomputed anyres patch
embeddings ``[B, T, d_model]``
(:func:`repro_torch.models.modality.patch_embeddings`; the train loop's
``DataConfig.embed_dim``).  Under ``tnn_default`` the backbone has
8,140,459,008 parameters (dense: 34,388,917,248), about 130 GB of f32
training state: it does not train on one 80 GB card, and is held at
smoke size.
"""
from repro_torch.configs.base import ArchConfig, register
from repro_torch.core.tensorized import TNNConfig
from repro_torch.models.lm import LMConfig


def make_model(tnn=None):
    return LMConfig(
        name="llava-next-34b", num_layers=60, d_model=7168, num_heads=56,
        num_kv_heads=8, head_dim=128, d_ff=20480, vocab=64000,
        tnn=tnn or TNNConfig())


def make_smoke(tnn=None):
    return LMConfig(
        name="llava-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
        remat=False, tnn=tnn or TNNConfig())


CONFIG = register(ArchConfig(
    id="llava_next_34b", family="vlm", model_kind="lm",
    make_model=make_model, make_smoke=make_smoke,
    input_kind="embeds",
    notes="anyres tiling lives in the stubbed frontend; backbone consumes "
          "patch embeddings; long_500k skipped (full attention)",
))
