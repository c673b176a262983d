"""Model configuration for the port: its own copy of ``ModelConfig`` /
``QuantSpec`` and the registry, restricted to the families the port serves
(``dense``: the paper's two evaluation models ``llama3-8b`` and
``qwen3-8b``, and ``qwen2-1.5b``, ``stablelm-12b``, ``phi4-mini-3.8b``,
``internlm2-1.8b``; ``moe``: ``olmoe-1b-7b``; ``mla_moe``:
``deepseek-v3-671b``; ``vlm``: ``internvl2-2b``; ``encdec``:
``whisper-base``; ``xlstm``: ``xlstm-1.3b``; ``mamba_hybrid``:
``zamba2-1.2b``): every arch of the reference's ``ARCH_IDS``.

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
    """Model configuration: a decoder-only transformer (dense or MoE FFN;
    GQA or MLA attention), an encoder-decoder, an xLSTM or a Mamba2
    hybrid."""

    name: str = ""
    family: str = "dense"  # dense | moe | mla_moe | vlm | encdec | xlstm | mamba_hybrid
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
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    first_k_dense: int = 0  # leading dense layers (DeepSeek-V3 style)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    # MLA (DeepSeek-V3; family "mla_moe" selects it)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mtp: bool = False  # multi-token-prediction aux layer+head
    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    n_frames: int = 0  # encoder frontend stub: precomputed frame embeddings
    # VLM: patch embeddings the frontend stub prepends to the prompt
    n_patches: int = 0
    # xLSTM
    slstm_every: int = 0  # every k-th block is sLSTM (0 = pure mLSTM)
    xlstm_proj_factor: float = 2.0
    # Mamba2 / hybrid (zamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    shared_attn_every: int = 0  # zamba2: shared attention block cadence
    quant: QuantSpec = QuantSpec()
    # training: each layer rematerialised in a loss's backward (the serving
    # forwards run under no_grad and ignore it)
    remat: bool = True

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def d_inner_ssm(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner_ssm // self.ssm_head_dim if self.ssm_head_dim else 0

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve a 500k context (O(1) recurrent state)?"""
        return self.family in ("xlstm", "mamba_hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # no encoder-only arch among ARCH_IDS

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def active_params(self) -> int:
        """Dense-equivalent active parameter count (MoE: the routed top-k)."""
        from repro_torch.models.registry import count_active_params

        return count_active_params(self)

    def total_params(self) -> int:
        from repro_torch.models.registry import count_total_params

        return count_total_params(self)


_REGISTRY: dict[str, ModelConfig] = {}
_REDUCED: dict[str, ModelConfig] = {}

# the reference's ARCH_IDS, in its order
ARCH_IDS = ["olmoe-1b-7b", "deepseek-v3-671b", "qwen2-1.5b", "stablelm-12b", "phi4-mini-3.8b",
            "internlm2-1.8b", "internvl2-2b", "whisper-base", "xlstm-1.3b", "zamba2-1.2b",
            "llama3-8b", "qwen3-8b"]

_MODULES = {"llama3-8b": "llama3_8b", "qwen3-8b": "qwen3_8b", "qwen2-1.5b": "qwen2_1_5b",
            "stablelm-12b": "stablelm_12b", "phi4-mini-3.8b": "phi4_mini_3_8b",
            "internlm2-1.8b": "internlm2_1_8b", "olmoe-1b-7b": "olmoe_1b_7b",
            "internvl2-2b": "internvl2_2b", "deepseek-v3-671b": "deepseek_v3_671b",
            "whisper-base": "whisper_base", "xlstm-1.3b": "xlstm_1_3b",
            "zamba2-1.2b": "zamba2_1_2b"}


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
