"""Model registry of the port: family -> entry points.

    init_params(cfg, seed, device) -> params
    forward(params, cfg, tokens) -> logits (dense, mamba_hybrid) | (logits, aux)
        (moe) | (logits, aux, hidden) (mla_moe); forward(params, cfg, tokens,
        frames) -> logits (encdec)
    init_decode_state(cfg, batch, max_len, device=...) -> state
    prefill(params, cfg, tokens, state[, patches | frames], length=None, prefix=None)
        -> (logits, state)
    decode_step(params, cfg, state, tokens) -> (logits, state)
    ragged_step(params, cfg, state, tokens, slot, pos, ctx, logit_idx)
        -> (logits, state)
    count_params(cfg) -> (total, active)

The ``dense`` (llama3, qwen3, qwen2, stablelm, phi4, internlm2), ``moe``
(OLMoE), ``mla_moe`` (DeepSeek-V3), ``vlm`` (internvl2: the dense backbone
behind a patch frontend), ``encdec`` (whisper: the encoder behind a frame
frontend) and ``mamba_hybrid`` (zamba2) families are ported. ``mla_moe``,
``vlm``, ``encdec`` and ``mamba_hybrid`` have no ``ragged_step``, as in
the reference: the engine serves them bucketed or paged. The prefills of
``encdec`` and ``mamba_hybrid`` take ``prefix=None`` only (no prefix
cache).
"""

from __future__ import annotations

from types import SimpleNamespace

from repro_torch.configs import ModelConfig
from repro_torch.models import deepseek, dense, encdec, mamba_hybrid, olmoe

__all__ = ["get_model"]

_DENSE = SimpleNamespace(
    init_params=dense.init_params,
    forward=dense.forward,
    init_decode_state=dense.init_decode_state,
    prefill=dense.prefill,
    decode_step=dense.decode_step,
    ragged_step=dense.ragged_step,
    count_params=dense.count_params,
)


# dense's entry points (its prefill takes the patches) without a
# ragged_step, as the reference's
_VLM = SimpleNamespace(
    init_params=dense.init_params,
    forward=dense.forward,
    init_decode_state=dense.init_decode_state,
    prefill=dense.prefill,
    decode_step=dense.decode_step,
    count_params=dense.count_params,
)


_MOE = SimpleNamespace(
    init_params=olmoe.init_params,
    forward=olmoe.forward,
    init_decode_state=olmoe.init_decode_state,
    prefill=olmoe.prefill,
    decode_step=olmoe.decode_step,
    ragged_step=olmoe.ragged_step,
    count_params=olmoe.count_params,
)

_MLA_MOE = SimpleNamespace(
    init_params=deepseek.init_params,
    forward=deepseek.forward,
    init_decode_state=deepseek.init_decode_state,
    prefill=deepseek.prefill,
    decode_step=deepseek.decode_step,
    count_params=deepseek.count_params,
)

_ENCDEC = SimpleNamespace(
    init_params=encdec.init_params,
    forward=encdec.forward,
    init_decode_state=encdec.init_decode_state,
    prefill=encdec.prefill,
    decode_step=encdec.decode_step,
    count_params=encdec.count_params,
)

_MAMBA_HYBRID = SimpleNamespace(
    init_params=mamba_hybrid.init_params,
    forward=mamba_hybrid.forward,
    init_decode_state=mamba_hybrid.init_decode_state,
    prefill=mamba_hybrid.prefill,
    decode_step=mamba_hybrid.decode_step,
    count_params=mamba_hybrid.count_params,
)

_FAMILIES = {"dense": _DENSE, "vlm": _VLM, "moe": _MOE, "mla_moe": _MLA_MOE,
             "encdec": _ENCDEC, "mamba_hybrid": _MAMBA_HYBRID}


def get_model(cfg: ModelConfig) -> SimpleNamespace:
    """Entry points of ``cfg.family``."""
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1)")
    return _FAMILIES[cfg.family]
