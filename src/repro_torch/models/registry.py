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
    loss_fn(params, cfg, batch) -> scalar f32 loss, differentiable once the
        weights are parameters (``common.trainable``); ``batch`` holds
        ``tokens`` and ``labels`` (B, S) and the family's ``patches`` (vlm)
        or ``frames`` (encdec)

The ``dense`` (llama3, qwen3, qwen2, stablelm, phi4, internlm2), ``moe``
(OLMoE), ``mla_moe`` (DeepSeek-V3), ``vlm`` (internvl2: the dense backbone
behind a patch frontend), ``encdec`` (whisper: the encoder behind a frame
frontend), ``xlstm`` (xlstm-1.3b) and ``mamba_hybrid`` (zamba2) families
are ported: all seven of the reference. ``mla_moe``, ``vlm``, ``encdec``,
``xlstm`` and ``mamba_hybrid`` have no ``ragged_step``, as in the
reference: the engine serves them bucketed or paged (``xlstm``'s paged
layout is the dense per-slot one: its state has nothing to page). The
prefills of ``encdec``, ``xlstm`` and ``mamba_hybrid`` take ``prefix=None``
only (no prefix cache).

Beside the entry points, the reference's counters and dry-run shapes:
:func:`count_total_params`, :func:`count_active_params`, ``SHAPE_SETS``,
:func:`input_specs` (``device="meta"`` tensors where the reference has
``ShapeDtypeStruct``s) and :func:`applicable_shapes`.
"""

from __future__ import annotations

from types import SimpleNamespace

from repro_torch.configs import ModelConfig
import torch

from repro_torch.models import deepseek, dense, encdec, mamba_hybrid, olmoe, xlstm

__all__ = ["SHAPE_SETS", "applicable_shapes", "count_active_params", "count_total_params",
           "get_model", "input_specs"]

_DENSE = SimpleNamespace(
    init_params=dense.init_params,
    forward=dense.forward,
    loss_fn=dense.loss_fn,
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
    loss_fn=dense.loss_fn,
    init_decode_state=dense.init_decode_state,
    prefill=dense.prefill,
    decode_step=dense.decode_step,
    count_params=dense.count_params,
)


_MOE = SimpleNamespace(
    init_params=olmoe.init_params,
    forward=olmoe.forward,
    loss_fn=olmoe.loss_fn,
    init_decode_state=olmoe.init_decode_state,
    prefill=olmoe.prefill,
    decode_step=olmoe.decode_step,
    ragged_step=olmoe.ragged_step,
    count_params=olmoe.count_params,
)

_MLA_MOE = SimpleNamespace(
    init_params=deepseek.init_params,
    forward=deepseek.forward,
    loss_fn=deepseek.loss_fn,
    init_decode_state=deepseek.init_decode_state,
    prefill=deepseek.prefill,
    decode_step=deepseek.decode_step,
    count_params=deepseek.count_params,
)

_ENCDEC = SimpleNamespace(
    init_params=encdec.init_params,
    forward=encdec.forward,
    loss_fn=encdec.loss_fn,
    init_decode_state=encdec.init_decode_state,
    prefill=encdec.prefill,
    decode_step=encdec.decode_step,
    count_params=encdec.count_params,
)

_MAMBA_HYBRID = SimpleNamespace(
    init_params=mamba_hybrid.init_params,
    forward=mamba_hybrid.forward,
    loss_fn=mamba_hybrid.loss_fn,
    init_decode_state=mamba_hybrid.init_decode_state,
    prefill=mamba_hybrid.prefill,
    decode_step=mamba_hybrid.decode_step,
    count_params=mamba_hybrid.count_params,
)

_XLSTM = SimpleNamespace(
    init_params=xlstm.init_params,
    forward=xlstm.forward,
    loss_fn=xlstm.loss_fn,
    init_decode_state=xlstm.init_decode_state,
    prefill=xlstm.prefill,
    decode_step=xlstm.decode_step,
    count_params=xlstm.count_params,
)

_FAMILIES = {"dense": _DENSE, "vlm": _VLM, "moe": _MOE, "mla_moe": _MLA_MOE,
             "encdec": _ENCDEC, "xlstm": _XLSTM, "mamba_hybrid": _MAMBA_HYBRID}


def get_model(cfg: ModelConfig) -> SimpleNamespace:
    """Entry points of ``cfg.family``."""
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(f"unknown model family {cfg.family!r}; the port serves "
                                  f"{sorted(_FAMILIES)}")
    return _FAMILIES[cfg.family]


def count_total_params(cfg: ModelConfig) -> int:
    return int(get_model(cfg).count_params(cfg)[0])


def count_active_params(cfg: ModelConfig) -> int:
    return int(get_model(cfg).count_params(cfg)[1])


# ---------------------------------------------------------------------------
# input specs: shape and dtype stand-ins for every model input per shape
# (the dry-run cells), as meta tensors: nothing is allocated
# ---------------------------------------------------------------------------

SHAPE_SETS = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def input_specs(cfg: ModelConfig, shape_name: str, reduced: bool = False) -> dict:
    """Meta tensors of the given (arch x shape) cell's step inputs."""
    spec = SHAPE_SETS[shape_name]
    b, s = spec["batch"], spec["seq"]
    if reduced:
        b, s = min(b, 2), min(s, 2 * 256)

    def meta(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    out = {}
    if spec["kind"] in ("train", "prefill"):
        out["tokens"] = meta((b, s))
        if spec["kind"] == "train":
            out["labels"] = meta((b, s))
        if cfg.family == "vlm":
            out["patches"] = meta((b, cfg.n_patches, cfg.d_model), torch.bfloat16)
        if cfg.family == "encdec":
            out["frames"] = meta((b, cfg.n_frames, cfg.d_model), torch.bfloat16)
    else:  # decode: one token, cache of length s
        out["tokens"] = meta((b, 1))
    return out


def applicable_shapes(cfg: ModelConfig) -> dict[str, str]:
    """shape -> 'run' | reason to skip."""
    out = {}
    for name in SHAPE_SETS:
        if name == "long_500k" and not cfg.sub_quadratic:
            out[name] = "skip: full-attention arch; 500k decode needs sub-quadratic attention"
        else:
            out[name] = "run"
    return out
