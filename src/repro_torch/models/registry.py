"""Model registry of the port: family -> entry points.

    init_params(cfg, seed, device) -> params
    forward(params, cfg, tokens) -> logits (dense) | (logits, aux) (moe)
    init_decode_state(cfg, batch, max_len, device=...) -> state
    prefill(params, cfg, tokens, state, length=None) -> (logits, state)
    decode_step(params, cfg, state, tokens) -> (logits, state)
    ragged_step(params, cfg, state, tokens, slot, pos, ctx, logit_idx)
        -> (logits, state)

The ``dense`` (llama3, qwen3) and ``moe`` (OLMoE) families are ported.
"""

from __future__ import annotations

from types import SimpleNamespace

from repro_torch.configs import ModelConfig
from repro_torch.models import dense, olmoe

__all__ = ["get_model"]

_DENSE = SimpleNamespace(
    init_params=dense.init_params,
    forward=dense.forward,
    init_decode_state=dense.init_decode_state,
    prefill=dense.prefill,
    decode_step=dense.decode_step,
    ragged_step=dense.ragged_step,
)


_MOE = SimpleNamespace(
    init_params=olmoe.init_params,
    forward=olmoe.forward,
    init_decode_state=olmoe.init_decode_state,
    prefill=olmoe.prefill,
    decode_step=olmoe.decode_step,
    ragged_step=olmoe.ragged_step,
)

_FAMILIES = {"dense": _DENSE, "moe": _MOE}


def get_model(cfg: ModelConfig) -> SimpleNamespace:
    """Entry points of ``cfg.family``."""
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1)")
    return _FAMILIES[cfg.family]
