"""Architecture-config registry.

Port of ``src/repro/configs/base.py``: each architecture module defines an
:class:`ArchConfig` with its published model config, a reduced smoke
config of the same family and its TNN variant; ``--arch <id>`` resolves
through :func:`get`.  Ported so far: the paper's own ``paper_atis_tt``,
``rwkv6_7b``, ``zamba2_7b``, the dense GQA family (``tinyllama_1_1b``,
``internlm2_1_8b``, ``phi4_mini_3_8b``, ``qwen2_7b``), the MoE family
(``olmoe_1b_7b``, ``qwen3_moe_235b_a22b``), the encoder-decoder
``seamless_m4t_medium`` (``model_kind="encdec"``) and the
embeddings-input ``llava_next_34b``: every architecture of the
reference's ``ARCH_IDS``, and ``paper_atis_tt``.  ``input_kind`` says
whether a model reads token ids (``tokens``) or the modality stub's
``[B, T, d_model]`` embeddings (``embeds``).  ``tnn_one_card`` (the
port's addition) names the TNN config
that fits the full model's training state on one 80 GB card where
``tnn_default`` does not.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable

from repro_torch.core.tensorized import TNNConfig

#: architectures this package has ported
ARCH_IDS = ["paper_atis_tt", "rwkv6_7b", "zamba2_7b", "tinyllama_1_1b",
            "internlm2_1_8b", "phi4_mini_3_8b", "qwen2_7b", "olmoe_1b_7b",
            "qwen3_moe_235b_a22b", "llava_next_34b", "seamless_m4t_medium"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    id: str
    family: str                     # ssm | moe | vlm | audio | dense | hybrid
    model_kind: str                 # "lm" | "encdec"
    make_model: Callable[..., Any]  # (tnn) -> LMConfig | EncDecConfig
    make_smoke: Callable[..., Any]  # reduced same-family config
    input_kind: str = "tokens"      # tokens | embeds (modality stub)
    notes: str = ""
    tnn_default: TNNConfig = TNNConfig(
        enabled=True, method="tt", rank=64, num_factors=2, targets=("mlp",),
        backend="einsum")
    tnn_one_card: TNNConfig | None = None

    def model(self, tnn: TNNConfig | None = None):
        return self.make_model(tnn=tnn)

    def smoke(self, tnn: TNNConfig | None = None):
        return self.make_smoke(tnn=tnn)


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.id] = cfg
    return cfg


def get(arch_id: str) -> ArchConfig:
    arch_id = arch_id.replace("-", "_").replace(".", "_")
    if arch_id not in _REGISTRY:
        if arch_id not in ARCH_IDS:
            raise KeyError(f"arch {arch_id!r} is not ported (ported: "
                           f"{ARCH_IDS}; the rest are queued in ROADMAP.md)")
        importlib.import_module(f"repro_torch.configs.{arch_id}")
    return _REGISTRY[arch_id]
