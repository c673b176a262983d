"""Model registry of the port: family -> entry points.

    init_params(cfg, seed, device) -> params
    forward(params, cfg, tokens) -> logits
    init_decode_state(cfg, batch, max_len, device=...) -> state
    prefill(params, cfg, tokens, state, length=None) -> (logits, state)
    decode_step(params, cfg, state, tokens) -> (logits, state)
    ragged_step(params, cfg, state, tokens, slot, pos, ctx, logit_idx)
        -> (logits, state)

Only the ``dense`` family is ported so far.
"""

from __future__ import annotations

from types import SimpleNamespace

from repro_torch.configs import ModelConfig
from repro_torch.models import dense

__all__ = ["get_model"]

_DENSE = SimpleNamespace(
    init_params=dense.init_params,
    forward=dense.forward,
    init_decode_state=dense.init_decode_state,
    prefill=dense.prefill,
    decode_step=dense.decode_step,
    ragged_step=dense.ragged_step,
)


def get_model(cfg: ModelConfig) -> SimpleNamespace:
    """Entry points of ``cfg.family``."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1, items 11-12)"
        )
    return _DENSE
