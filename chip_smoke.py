"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure ends the run non-zero):

1. device  — card name, count, ``nvidia-smi`` name and power limit;
2. build   — compiles every ``src/repro_torch/csrc/*.cu`` (one ``nvcc`` per
   source, all at once) and prints the ``-Xptxas -v`` lines;
3. kernels — the four dual-component kernels at llama3-8b shapes, each held
   to its plain PyTorch version with ``torch.equal`` and timed (CUDA events)
   beside the plain version, a bf16 ``torch.matmul`` of the same (M, K) x
   (K, N) as a yardstick, and the least time the card could take;
4. serve   — llama3-8b at full width (depth cut), random weights from seed
   0, W4A4 TwinQuant packs, through the bucketed ``ContinuousBatchingEngine``;
   checks every request finishes, every kernel route ran with no plain-version
   route, kernel-vs-plain logits, and solo-vs-interleaved greedy tokens.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX or of ``repro``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
sys.path.insert(0, str(SRC))

HBM_BYTES_S = 3.35e12  # H100 SXM memory rate
INT8_OPS_S = 1.979e15  # H100 SXM dense int8 tensor-core rate
SERVE_LAYERS = 32  # llama3-8b's full depth

KERNELS = {
    # wrapper name -> (source, TPU kernel it replaces, representative case)
    "dual_gemv": ("src/repro_torch/csrc/twinquant_dual_gemv.cu",
                  "src/repro/kernels/twinquant_dual_gemv.py:139", ("down", 8)),
    "dual_gemv_group": ("src/repro_torch/csrc/twinquant_dual_gemv.cu",
                        "src/repro/kernels/twinquant_dual_gemv.py:200", ("gate_up", 8)),
    "dual_gemm": ("src/repro_torch/csrc/twinquant_dual_gemm.cu",
                  "src/repro/kernels/twinquant_dual_gemm.py:167", ("down", 512)),
    "dual_gemm_group": ("src/repro_torch/csrc/twinquant_dual_gemm.cu",
                        "src/repro/kernels/twinquant_dual_gemm.py:239", ("gate_up", 512)),
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call over ``iters`` calls, CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: kernels at llama3-8b shapes
# ---------------------------------------------------------------------------


def make_pack(gen, k, n, r, device):
    import torch

    from repro_torch.kernels.ref import pack_twinquant_weights

    def rnd(*shape, s):
        return torch.randn(*shape, generator=gen, device=device) * s

    return pack_twinquant_weights(rnd(k, r, s=0.1), rnd(r, n, s=0.1), rnd(k, n, s=0.05),
                                  a_bits=4, group=128)


def pack_bytes(gw) -> int:
    ts = [gw.up, gw.us, gw.rp, gw.rs, *gw.vps, *gw.vss]
    return sum(t.numel() * t.element_size() for t in ts)


def bound(m: int, k: int, gw) -> tuple[float, str]:
    """Least time (ms) and what bounds it: each input read once and the
    output written once over the memory rate, vs the int8 operations
    (residual, H, and V products) over the int8 rate."""
    n, r = gw.ndim_out, gw.rank
    nbytes = m * k * 2 + pack_bytes(gw) + m * n * 2
    ops = 2 * m * k * n + 2 * m * k * r + sum(2 * m * rj * nj for rj, nj in zip(gw.seg_r, gw.seg_n))
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / INT8_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(device) -> dict:
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.twinquant_dual_gemm import dual_gemm, dual_gemm_group
    from repro_torch.kernels.twinquant_dual_gemv import dual_gemv, dual_gemv_group

    gen = torch.Generator(device=device).manual_seed(0)
    d, f, r = 4096, 14336, 128
    single = {"o": make_pack(gen, d, d, r, device), "down": make_pack(gen, f, d, r, device)}
    fused = {
        "qkv": ref.fuse_twinquant_weights([make_pack(gen, d, n, r, device)
                                           for n in (4096, 1024, 1024)]),
        "gate_up": ref.fuse_twinquant_weights([make_pack(gen, d, f, r, device)
                                               for _ in range(2)]),
    }
    cases = {
        "dual_gemv": (dual_gemv, ref.dual_gemm_ref, single, (1, 8)),
        "dual_gemv_group": (dual_gemv_group, ref.dual_gemm_group_ref, fused, (1, 8)),
        "dual_gemm": (dual_gemm, ref.dual_gemm_ref, single, (16, 512)),
        "dual_gemm_group": (dual_gemm_group, ref.dual_gemm_group_ref, fused, (16, 512)),
    }
    table = {}
    for name, (kern, plain, packs, ms_) in cases.items():
        worst = 0.0
        rep = None
        for lname, w in packs.items():
            gw = w if isinstance(w, ref.TwinQuantGroupWeights) else ref.as_group(w)
            k, n = gw.kdim, gw.ndim_out
            # enough copies of the pack to exceed the 50 MB L2, so every
            # timed launch reads its weights from device memory like a layer
            # of the real model does
            copies = [w] + [_clone(w) for _ in range(min(7, 120_000_000 // pack_bytes(gw)))]
            for m in ms_:
                x = (torch.randn(m, k, generator=gen, device=device) * 2).to(torch.bfloat16)
                y_k = kern(x, w)
                y_p = plain(x, w)
                torch.cuda.synchronize()
                err = (y_k.float() - y_p.float()).abs().max().item()
                worst = max(worst, err)
                if not torch.equal(y_k, y_p):
                    fail(f"{name} {lname} M={m}: kernel != plain version "
                         f"({int((y_k != y_p).sum())} of {y_k.numel()} differ, max |d| {err})")
                it = [0]

                def run_k():
                    it[0] = (it[0] + 1) % len(copies)
                    kern(x, copies[it[0]])

                t_k = cuda_ms(run_k, iters=50)
                t_p = cuda_ms(lambda: plain(x, w), iters=3, warmup=1)
                wb = torch.randn(k, n, generator=gen, device=device).to(torch.bfloat16)
                t_lib = cuda_ms(lambda: torch.matmul(x, wb), iters=50)
                del wb
                t_b, by = bound(m, k, gw)
                print(f"kernel {name:16s} {lname:8s} M={m:4d} K={k:5d} N={n:5d} equal "
                      f"ms={t_k:.4f} plain_ms={t_p:.4f} bf16_matmul_ms={t_lib:.4f} "
                      f"bound_ms={t_b:.4f} ({by}) share={t_b / t_k:.3f}", flush=True)
                if (lname, m) == KERNELS[name][2]:
                    rep = dict(ms=t_k, plain_ms=t_p, library_ms=t_lib, bound_ms=t_b,
                               bound_by=by)
            del copies
        torch.cuda.empty_cache()
        table[name] = dict(max_abs_err=worst, **rep)

    # a shape no kernel tiles raises on the card instead of running the plain version
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.contracts import ContractError

    odd = make_pack(gen, d, 100, r, device)
    for m in (8, 16):
        x = torch.randn(m, d, generator=gen, device=device).to(torch.bfloat16)
        try:
            dispatch.quant_linear(x, odd)
        except ContractError as e:
            print(f"kernel dispatch N=100 M={m} raises: {str(e).splitlines()[0][:100]}",
                  flush=True)
        else:
            fail(f"dispatch ran an untileable N=100 M={m} shape on the card")
    dispatch.reset_dispatch_counters()
    return table


def _clone(w):
    """A copy of a pack in fresh device memory."""
    import dataclasses

    import torch

    def c(v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        if isinstance(v, tuple):
            return tuple(c(t) for t in v)
        return v

    return dataclasses.replace(w, **{f.name: c(getattr(w, f.name)) for f in dataclasses.fields(w)})


# ---------------------------------------------------------------------------
# phase 4: serve llama3-8b (full width, cut depth)
# ---------------------------------------------------------------------------

PROMPT_LENS = (3, 6, 8, 20, 40, 64, 300, 500, 512, 700, 900, 1024)  # buckets 8 .. 1024


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_phase(device, card: str, cfg, prompt_lens=PROMPT_LENS, max_len: int = 2048,
                rank: int = 128) -> dict:
    """Serve ``cfg`` (random weights, seed 0, W4A4) through the engine and
    check it; returns the kernel launch counts of the main-path run. Runs on
    the CPU too (plain versions), which is how it is rehearsed off the card."""
    import numpy as np
    import torch

    from repro_torch.configs import QuantSpec
    from repro_torch.core.twinquant import fuse_params, quantize_params
    from repro_torch.kernels import cuda_launch, dispatch
    from repro_torch.launch.serve import ContinuousBatchingEngine, Request, SamplingParams
    from repro_torch.models import dense

    print(f"serve config {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} "
          f"head_dim={cfg.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab} n_layers={cfg.n_layers}",
          flush=True)
    t0 = time.perf_counter()
    params = dense.init_params(cfg, seed=0, device=device)
    _sync(device)
    t1 = time.perf_counter()
    qp = fuse_params(quantize_params(params, cfg, QuantSpec("w4a4", rank=rank, group_size=128)))
    _sync(device)
    t2 = time.perf_counter()
    del params
    nbytes = sum(t.numel() * t.element_size() for t in qp.buffers())
    print(f"serve init_s={t1 - t0:.2f} quantize_fuse_s={t2 - t1:.2f} param_bytes={nbytes}",
          flush=True)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in prompt_lens]

    def requests():
        return [Request(p, max_new=32,
                        sampling=SamplingParams(temperature=0.8, top_k=50, seed=1)
                        if i == 3 else SamplingParams())
                for i, p in enumerate(prompts)]

    # kernel vs plain logits on one prompt, through the model entry point
    state = dense.init_decode_state(cfg, 1, 64, device=device)
    toks = torch.as_tensor(prompts[4][None, :], device=device, dtype=torch.long)
    lk, _ = dense.prefill(qp, cfg, toks, state)
    prev = dispatch.set_force_ref(True)
    try:
        lp, _ = dense.prefill(qp, cfg, toks, state)
    finally:
        dispatch.set_force_ref(prev)
    if not torch.equal(lk, lp):
        fail(f"prefill logits through the kernels != plain versions "
             f"(max |d| {(lk.float() - lp.float()).abs().max().item()})")
    print("serve prefill logits kernel == plain: equal", flush=True)

    engine = ContinuousBatchingEngine(cfg, qp, batch_slots=8, max_len=max_len, device=device)
    reqs = requests()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    dispatch.reset_dispatch_counters()
    cuda_launch.reset_launch_counts()
    t0 = time.perf_counter()
    engine.serve(reqs)
    _sync(device)
    wall = time.perf_counter() - t0
    launches = cuda_launch.launch_counts()
    routes = dispatch.dispatch_counters()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else "not measured"
    bad = [(r.request_id, r.status, r.error) for r in reqs if r.status != "DONE"]
    if bad:
        fail(f"requests not DONE: {bad}")
    if any(len(r.out) != 32 for r in reqs):
        fail(f"short outputs: {[len(r.out) for r in reqs]}")
    print(f"serve routes {json.dumps(routes, sort_keys=True)}", flush=True)
    print(f"serve launches {json.dumps(launches, sort_keys=True)}", flush=True)
    for key in ("dual/decode", "dual/prefill", "dual_fused/decode", "dual_fused/prefill"):
        if routes.get(key, 0) <= 0:
            fail(f"route {key} never taken")
    if any("/ref" in key for key in routes):
        fail(f"plain-version routes taken: {routes}")
    for name in KERNELS if device.type == "cuda" else ():
        if launches.get(name, 0) <= 0:
            fail(f"kernel {name} never launched on the main path")
    tp = engine.throughput()
    steps, prefills = tp["decode_steps"], engine.compile_stats()["prefill_calls"]
    print(f"serve launches_per_decode_step dual_gemv={2 * cfg.n_layers} "
          f"dual_gemv_group={2 * cfg.n_layers} (o, down / qkv, gate_up per layer; "
          f"{steps} decode steps, {prefills} prefills)", flush=True)
    print(f"serve done requests={len(reqs)} wall_s={wall:.3f} decode_tok_s={tp['decode_tok_s']:.2f} "
          f"prefill_tok_s={tp['prefill_tok_s']:.2f} decode_steps={tp['decode_steps']} "
          f"max_memory_allocated={peak} compile_stats={json.dumps(engine.compile_stats())} "
          f"card=\"{card}\"", flush=True)

    # DESIGN.md §10: a request served interleaved equals the same request alone
    solo_engine = ContinuousBatchingEngine(cfg, qp, batch_slots=8, max_len=max_len, device=device)
    solo = requests()[5]
    solo_engine.serve([solo])
    if solo.out != reqs[5].out:
        fail("solo vs interleaved greedy tokens differ")
    print("serve solo == interleaved: equal", flush=True)
    return launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    print(f"device name={name} count={count}", flush=True)
    print(card, flush=True)

    from repro_torch.kernels import build

    secs = build.build_all()
    print(f"build seconds={secs:.1f}", flush=True)
    for src, lines in build.ptxas_report().items():
        for ln in lines:
            print(f"build {src}: {ln}", flush=True)

    table = kernel_phase(device)
    from repro_torch.configs import get_config

    launches = serve_phase(device, card, get_config("llama3-8b").replace(n_layers=SERVE_LAYERS))

    rows = []
    for kname, (source, replaces, _) in KERNELS.items():
        rows.append(dict(name=kname, route="cuda", source=source, replaces=replaces,
                         launches=launches.get(kname, 0), **table[kname]))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
