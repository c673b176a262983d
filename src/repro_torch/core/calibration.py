"""Per-layer TwinQuant calibration: the three-stage joint optimization of
(Q, G) over Stiefel x GL (paper §4.2).

The layer objective is Eq. 6:

    || X W_hat  -  fq(X Q) [ fq(Q^T U G) fq(G^-1 V) + fq(Q^T R) ] ||_F^2
      + reg * conditioning_penalty(G)

with `fq` the STE fake-quantizer. Stages:

    (i)   Global Alignment      — only Q trains
    (ii)  Invertible Adaptation — only G = (P, L, gamma) trains
    (iii) Joint Refinement      — everything trains

Stage selection is a per-leaf learning-rate scale, so one step function
serves all three stages; every step computes every leaf's gradient and
advances every leaf's momentum, as the reference's one jitted step does.
Matmuls run in full f32 (TF32 off for the process), and every SVD, QR and
solve runs on the device the inputs are moved to.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.decomposition import Decomposition, decompose, search_alpha
from repro_torch.core.manifold import HybridOpt, HybridState, tree_leaves, tree_map
from repro_torch.core.quantization import QuantConfig, fake_quant
from repro_torch.core.transforms import (
    GLParams,
    gl_conditioning_penalty,
    gl_init,
    gl_inverse,
    gl_materialize,
    orthogonal_init,
)
from repro_torch.kernels.ref import _exact_matmuls

__all__ = ["CalibConfig", "CalibResult", "calibrate_layer", "calibration_step",
           "layer_quant_configs", "STIEFEL_MASK", "stage_scales"]


@dataclasses.dataclass(frozen=True)
class CalibConfig:
    rank: int = 128
    w_bits: int = 4
    a_bits: int = 4
    group_size: int = 128
    # paper defaults are 400/400/200; CPU-scale callers shrink these
    steps_global: int = 400
    steps_invert: int = 400
    steps_joint: int = 200
    lr: float = 5e-3
    momentum: float = 0.9
    reg_lambda: float = 1e-3
    # SpinQuant-style practice: start from a Hadamard rotation so the learned
    # Q can only improve on the fixed-rotation baseline (best-iterate kept)
    q_init: str = "hadamard"  # identity | hadamard | random
    smooth_alpha: Optional[float] = None  # None => grid search
    # learn Q at all? (False => fixed rotation ablation, e.g. +Hadamard)
    learn_q: bool = True
    learn_g: bool = True


@dataclasses.dataclass
class CalibResult:
    Q: torch.Tensor
    G: torch.Tensor  # materialized
    G_inv: torch.Tensor
    decomp: Decomposition  # the *untransformed* smoothed decomposition
    loss_history: list
    final_loss: float
    init_loss: float
    # host-clock seconds of each stage's steps (each ends on a host sync)
    stage_seconds: list = dataclasses.field(default_factory=list)


# which leaves of {"Q": ..., "G": GLParams} live on the Stiefel manifold
STIEFEL_MASK = {"Q": True, "G": GLParams(P=True, L=False, gamma=False)}


def layer_quant_configs(m: int, r: int, cfg: CalibConfig):
    """Quantizers for (activations, U, V, R). Groups run along the matmul
    contraction dims; V's contraction dim is the rank, which may be < 128."""
    aq = QuantConfig(bits=cfg.a_bits, group_size=min(cfg.group_size, m), axis=-1)
    uq = QuantConfig(bits=cfg.w_bits, group_size=min(cfg.group_size, m), axis=0)
    vq = QuantConfig(bits=cfg.w_bits, group_size=min(cfg.group_size, r), axis=0)
    rq = QuantConfig(bits=cfg.w_bits, group_size=min(cfg.group_size, m), axis=0)
    return aq, uq, vq, rq


def stage_scales(cfg: CalibConfig) -> list:
    """Per-leaf learning-rate scales of the three stages."""
    q_on = 1.0 if cfg.learn_q else 0.0
    g_on = 1.0 if cfg.learn_g else 0.0
    return [
        {"Q": q_on, "G": GLParams(P=0.0, L=0.0, gamma=0.0)},
        {"Q": 0.0, "G": GLParams(P=g_on, L=g_on, gamma=g_on)},
        {"Q": q_on, "G": GLParams(P=g_on, L=g_on, gamma=g_on)},
    ]


def _transformed_components(params, U, V, R):
    Q = params["Q"]
    Gm = gl_materialize(params["G"])
    Gi = gl_inverse(params["G"])
    U2 = Q.T @ U @ Gm
    V2 = Gi @ V
    R2 = Q.T @ R
    return Q, U2, V2, R2


def _layer_loss(params, x, y_ref, U, V, R, aq, uq, vq, rq, reg_lambda, a_bits):
    Q, U2, V2, R2 = _transformed_components(params, U, V, R)
    xq = x @ Q
    xfq = fake_quant(xq, aq) if a_bits < 16 else xq
    w_eff = fake_quant(U2, uq) @ fake_quant(V2, vq) + fake_quant(R2, rq)
    y = xfq @ w_eff
    recon = torch.mean((y - y_ref) ** 2)
    return recon + reg_lambda * gl_conditioning_penalty(params["G"]), recon


def calibration_step(params, state: HybridState, opt: HybridOpt, lr_scale, loss_kw: dict):
    """One optimizer step: the loss and every leaf's gradient at ``params``,
    then the hybrid update. Returns (new_params, new_state, recon) with
    ``recon`` the reconstruction loss at ``params`` (before the update)."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, recon = _layer_loss(live, **loss_kw)
        grads = torch.autograd.grad(loss, tree_leaves(live))
    it = iter(grads)
    grads = tree_map(lambda _: next(it), live)
    new_params, new_state = opt.update(grads, state, params, STIEFEL_MASK, lr_scale)
    return new_params, new_state, recon.detach()


def calibrate_layer(x: torch.Tensor, w: torch.Tensor, cfg: CalibConfig,
                    generator: Optional[torch.Generator] = None, device=None) -> CalibResult:
    """Run the full three-stage calibration for one linear layer.

    x: (samples, m) calibration activations; w: (m, n) weight. Both move to
    ``device`` (the card unless asked otherwise); ``generator`` draws the
    random initial Q of ``q_init="random"`` (seed 0 on that device if
    omitted)."""
    dev = resolve_device(device)
    _exact_matmuls()
    x, w = x.to(dev), w.to(dev)
    m, n = w.shape
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    with torch.no_grad():
        # 1) smoothing (alpha grid-search) + SVD decomposition
        aq_s, uq, vq, rq = layer_quant_configs(m, cfg.rank, cfg)
        if cfg.smooth_alpha is None:
            alpha, _ = search_alpha(x, w, cfg.rank, rq, aq_s)
        else:
            alpha = cfg.smooth_alpha
        decomp = decompose(w, cfg.rank, act_absmax=torch.amax(torch.abs(x), dim=0), alpha=alpha)
        x_hat = x / decomp.lam[None, :]
        U, V, R = decomp.U, decomp.V, decomp.R
        r = decomp.rank
        y_ref = x_hat @ (U @ V + R)

    # 2) parameters
    params = {"Q": orthogonal_init(m, cfg.q_init, generator=generator, device=dev),
              "G": gl_init(r, device=dev)}
    opt = HybridOpt(lr=cfg.lr, momentum=cfg.momentum)
    state = opt.init(params)
    aq, uq, vq, rq = layer_quant_configs(m, r, cfg)
    loss_kw = dict(x=x_hat, y_ref=y_ref, U=U, V=V, R=R, aq=aq, uq=uq, vq=vq, rq=rq,
                   reg_lambda=cfg.reg_lambda, a_bits=cfg.a_bits)

    def recon_at(p) -> float:
        with torch.no_grad():
            return float(_layer_loss(p, **loss_kw)[1])

    init_loss = recon_at(params)
    history = [init_loss]
    # best-params tracking: the hard-quantized objective is noisy under SGD,
    # so the best iterate is returned rather than the last one
    best_loss, best_params = init_loss, params
    stage_seconds = []
    for scales, steps in zip(stage_scales(cfg),
                             (cfg.steps_global, cfg.steps_invert, cfg.steps_joint)):
        recon = history[-1]
        t0 = time.perf_counter()
        for _ in range(steps):
            prev = params
            params, state, recon = calibration_step(params, state, opt, scales, loss_kw)
            rv = float(recon)  # loss evaluated at `prev`
            if rv < best_loss:
                best_loss, best_params = rv, prev
        stage_seconds.append(time.perf_counter() - t0)
        history.append(float(recon))
    final_eval = recon_at(params)
    if final_eval < best_loss:
        best_loss, best_params = final_eval, params
    params = best_params

    with torch.no_grad():
        Gm = gl_materialize(params["G"])
        Gi = gl_inverse(params["G"])
    return CalibResult(Q=params["Q"], G=Gm, G_inv=Gi, decomp=decomp, loss_history=history,
                       final_loss=best_loss, init_loss=init_loss, stage_seconds=stage_seconds)
