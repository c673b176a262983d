"""Model configuration for the port: its own copy of ``ModelConfig`` /
``QuantSpec`` and the registry, restricted to the dense family and the
paper's two evaluation models (``llama3-8b``, ``qwen3-8b``).

``get_config(name)`` returns the full-scale config, ``get_config(name,
reduced=True)`` the small smoke-test reduction (same code paths).
"""

from __future__ import annotations

import dataclasses
import importlib

__all__ = ["ModelConfig", "QuantSpec", "register", "get_config", "list_configs", "ARCH_IDS"]


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Serving-precision selection (paper §5 settings)."""

    mode: str = "bf16"  # bf16 | w4a8 | w4a4
    rank: int = 128  # low-rank branch rank r (paper default)
    group_size: int = 128  # quantization group (paper default)

    @property
    def a_bits(self) -> int:
        return {"bf16": 16, "w4a16": 16, "w4a8": 8, "w4a4": 4}[self.mode]

    @property
    def w_bits(self) -> int:
        return 16 if self.mode == "bf16" else 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Dense decoder-only transformer configuration."""

    name: str = ""
    family: str = "dense"
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab: int = 1024
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0  # fraction of head_dim that is rotated
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    quant: QuantSpec = QuantSpec()

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256."""
        return ((self.vocab + 255) // 256) * 256

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


_REGISTRY: dict[str, ModelConfig] = {}
_REDUCED: dict[str, ModelConfig] = {}

ARCH_IDS = ["llama3-8b", "qwen3-8b"]

_MODULES = {"llama3-8b": "llama3_8b", "qwen3-8b": "qwen3_8b"}


def register(full: ModelConfig, reduced: ModelConfig) -> None:
    _REGISTRY[full.name] = full
    _REDUCED[full.name] = reduced


def get_config(name: str, reduced: bool = False, **overrides) -> ModelConfig:
    if name not in _REGISTRY:
        if name not in _MODULES:
            raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
        importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    cfg = (_REDUCED if reduced else _REGISTRY)[name]
    return cfg.replace(**overrides) if overrides else cfg


def list_configs() -> list[str]:
    return list(ARCH_IDS)
