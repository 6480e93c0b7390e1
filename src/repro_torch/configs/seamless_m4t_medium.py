"""seamless-m4t-medium — enc-dec, 12L+12L d=1024 16H (kv=16) d_ff=4096
vocab=256206 (padded to 256256 = 16*16016 so the vocab dim shards over the
16-way model axis; padded rows are never targeted).

Port of ``src/repro/configs/seamless_m4t_medium.py`` [arXiv:2308.11596;
hf]: the model and smoke configs are the reference's.  The speech
frontend is a stub: the encoder reads frame embeddings
(:func:`repro_torch.models.modality.frame_embeddings`).  ``--tnn``
(``tnn_default``: TT rank 64, 2 factors, targets ``("mlp",)``)
tensorizes both stacks' SwiGLUs; attention, ``embed`` and ``lm_head``
stay dense.  That leaves 704,624,640 parameters (dense: 977,860,608),
about 11.3 GB of f32 weights, gradients and two AdamW moments: the full
model trains on one 80 GB card.
"""
from repro_torch.configs.base import ArchConfig, register
from repro_torch.core.tensorized import TNNConfig
from repro_torch.models.encdec import EncDecConfig

VOCAB_PADDED = 256256   # 256206 rounded up to a multiple of 16


def make_model(tnn=None):
    return EncDecConfig(
        name="seamless-m4t-medium", num_enc_layers=12, num_dec_layers=12,
        d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
        d_ff=4096, vocab=VOCAB_PADDED, tnn=tnn or TNNConfig())


def make_smoke(tnn=None):
    return EncDecConfig(
        name="seamless-smoke", num_enc_layers=2, num_dec_layers=2,
        d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, remat=False, tnn=tnn or TNNConfig())


CONFIG = register(ArchConfig(
    id="seamless_m4t_medium", family="audio", model_kind="encdec",
    make_model=make_model, make_smoke=make_smoke,
    input_kind="embeds",
    notes="enc-dec; decode shapes exercise the decoder with a fixed "
          "1024-frame encoder stub; long_500k skipped (full attention)",
))
