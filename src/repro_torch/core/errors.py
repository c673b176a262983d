"""Error decomposition & theorem diagnostics (paper Eq. 5, Eq. 8, Thm 4.1).

Analysis utilities: the per-term quantization errors of a decomposed layer,
the exact output error, and the two gains of Theorem 4.1 (activation
flattening ``zeta`` and low-rank re-parameterization ``eta``).
"""

from __future__ import annotations

import torch

from repro_torch.core.quantization import QuantConfig, dequantize, quantize

__all__ = [
    "quant_error",
    "groupwise_error_map",
    "error_terms",
    "zeta_gain",
    "eta_gain",
    "total_delta",
]


def quant_error(x: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """E_X = X - Q(X)."""
    return x - dequantize(quantize(x, cfg), dtype=x.dtype)


def groupwise_error_map(x: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """Per-group RMS quantization error (the Fig. 1b / Fig. 7 heatmaps)."""
    e = quant_error(x, cfg)
    axis = cfg.axis % x.ndim
    n = x.shape[axis]
    g = e.reshape(x.shape[:axis] + (n // cfg.group_size, cfg.group_size) + x.shape[axis + 1:])
    return torch.sqrt(torch.mean(g ** 2, dim=axis + 1))


def error_terms(x, U, V, R, aq: QuantConfig, wq_u: QuantConfig, wq_v: QuantConfig,
                wq_r: QuantConfig) -> dict:
    """The three Eq.-5 terms: activation / low-rank / residual errors."""
    w_hat = U @ V + R
    e_x = quant_error(x, aq)
    e_u = quant_error(U, wq_u)
    e_v = quant_error(V, wq_v)
    e_r = quant_error(R, wq_r)
    e_uv = e_u @ V + U @ e_v
    act = torch.sum((e_x @ w_hat) ** 2)
    lowrank = torch.sum((x @ e_uv) ** 2)
    residual = torch.sum((x @ e_r) ** 2)
    return {"activation": act, "lowrank": lowrank, "residual": residual,
            "total_linearized": act + lowrank + residual}


def total_delta(x, U, V, R, aq, wq_u, wq_v, wq_r) -> torch.Tensor:
    """Exact ||Delta||_F^2 of Eq. 4 (no independence approximation)."""

    def q(t, c):
        return dequantize(quantize(t, c), dtype=t.dtype)

    y_ref = x @ (U @ V + R)
    y_q = q(x, aq) @ (q(U, wq_u) @ q(V, wq_v) + q(R, wq_r))
    return torch.sum((y_ref - y_q) ** 2)


def zeta_gain(x: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """Activation flattening gain zeta(Q, X) = E||X||_inf^2 / E||XQ||_inf^2,
    ||.||_inf per row (per-token max magnitude), expectation over rows."""
    num = torch.mean(torch.amax(torch.abs(x), dim=-1) ** 2)
    den = torch.mean(torch.amax(torch.abs(x @ Q), dim=-1) ** 2)
    return num / den


def _uv_proxy(U, V) -> torch.Tensor:
    return (torch.amax(torch.abs(U)) ** 2) * torch.sum(V ** 2) + \
        (torch.amax(torch.abs(V)) ** 2) * torch.sum(U ** 2)


def eta_gain(U, V, U2, V2) -> torch.Tensor:
    """Low-rank re-parameterization gain eta (Eq. 8 proxy ratio)."""
    return _uv_proxy(U, V) / _uv_proxy(U2, V2)
