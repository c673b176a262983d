"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--spec-probe N]
    python3 chip_smoke.py --dual-only      # build + the dual kernels' phase
    python3 chip_smoke.py --timing-only [--src OTHER_TREE/src]
    python3 chip_smoke.py --ragged-serve [--src OTHER_TREE/src]
    python3 chip_smoke.py --lifecycle-only  # build, W4A4 llama3-8b, the lifecycle phase
    python3 chip_smoke.py --calib-only      # build, then the calibration phase
    python3 chip_smoke.py --olmoe-only      # build, then the OLMoE phase

Phases (each prints its own lines; any failure ends the run non-zero):

1. device  — card name, count, ``nvidia-smi`` name and power limit;
2. build   — compiles every ``src/repro_torch/csrc/*.cu`` (one ``nvcc`` per
   source, all at once) and prints the ``-Xptxas -v`` lines;
3. kernels — the four dual-component kernels at llama3-8b shapes (GEMV at
   M in {1, 2, 5, 8}, GEMM at M in {9, 16, 32, 100, 256, 512}), each held to
   its plain PyTorch version with ``torch.equal`` at a_bits 4 and 8, each
   row of a launch ``torch.equal`` to that row launched alone, and timed:
   device ms per call (calls captured in a CUDA graph and replayed), the
   wrapper's host µs per call, the plain version, a bf16 ``torch.matmul`` of
   the same (M, K) x (K, N) as a yardstick, and the least time the card
   could take; fused groups with odd ranks and segments that end mid-tile
   take the kernels' masked paths; the weight-only ``w4a16_gemm`` at every llama3-8b shape
   and M in {1, 8, 32, 256, 512}, held per row to its plain version run in
   f32 (relative error <= ``W4A16_REL_MAX``, a check two planted faults must
   fail) and to the bf16 plain version at ``W4A16_TOL``, each row
   ``torch.equal`` to a one-row launch, and timed the same way; then the
   paged-decode (sq 1 and 4, commit on and off) and ragged (T = 256)
   attention kernels, each split block's shared memory checked against its
   contract, held to their plain versions at atol 0.03 / rtol 0.05
   (committed pools ``torch.equal``) and, per row and head, to the plain
   version run in f32 (relative error <= ``ATT_REL_MAX``, a check that
   planted faults at the longest context must fail), timed (device ms from
   a CUDA graph) beside the plain version and SDPA over a dense view; the
   paged kernel's stacked rows held ``torch.equal`` to sequential one-row
   launches (one slot's rows straddling a chunk boundary of its key
   split), and the ragged kernel's rows ``torch.equal`` to two launches
   with one slot's 200-row chunk cut in two (the first part committed into
   its pages between them), its decode rows to a launch without the
   chunks;
4. serve   — llama3-8b at full width and depth, random weights from seed 0:
   first the bf16 model's ragged-step vs bucketed-prefill logits at several
   depths (gated at full depth), then W4A4 TwinQuant packs (quantized once)
   and the W4A16 baseline through ``ContinuousBatchingEngine`` four times
   each: bucketed dense cache, paged (prefix cache on), paged with
   speculation (spec_k 4) and ragged (token budget 256); W4A8 (the W4A4
   packs at a_bits 8) paged. Every engine runs its step as one CUDA graph
   (the engine's default on the card). Checks every request finishes,
   every run routes its kernels and no plain-version route, each kernel
   launches as often as the engine's steps say (attention once a layer,
   ``w4a16_gemm`` seven times; a replay counts its graph's launches), one
   capture per engine, kernel-vs-plain logits, solo-vs-interleaved greedy
   tokens, and speculative == paged tokens. For W4A4 and W4A16 in each
   mode: after step ``CHECK_STEP`` one step replayed from the graph and run
   eagerly from one state (logits and every state tensor ``torch.equal``),
   and an eager run (``step_graphs=False``) with the same tokens, launches
   and routes; for ``STEP_TIMED`` also eager vs graph host-clock step ms,
   device ms per step (profiler kernel sums, CUDA events around replays)
   and the device's busy share of a step. W4A16 paged and W4A4 ragged are
   served once more under the port's sanitizers (``guarded_decode``,
   ``no_recompiles``, ``page_invariant_checks``, ``lifecycle_checks``,
   ``assert_compile_budget``). A speculative W4A4 run with the norms and
   head over the whole draft stack reports which of them gave a row other
   bits (``--spec-probe N``: every variant, N times);
   Between the W4A4 and W4A8 runs, the lifecycle phase on the same W4A4
   packs (``lifecycle_phase``; 4 slots, max_len 128, page 16): the
   reference's default traffic mix (``launch/workload.make_workload``, seed
   0, 12 draws) replayed with preemption (a pool of ``LIFE_PAGES`` pages)
   in the paged, ragged and speculative modes and once each without (a
   pool that never runs short), under ``lifecycle_checks``,
   ``page_invariant_checks``, ``guarded_decode`` from the third step (and
   ``no_recompiles``, ragged) and ``assert_compile_budget``: every request
   terminal, preemption and prefix hits in each run with preemption,
   ``on_token`` once per emitted token, no page held past the prefix
   cache's registrations, one capture per engine, no plain-version route;
   each resumed request's restored pages checked exactly against its pages
   at preemption (a planted swapped page must fail), and every request's
   token rows against the run without preemption (``torch.equal`` gated in
   ``RESUME_EQUAL``, else printed); ``latency()`` per run; then host-side
   faults on a 4-slot paged engine, each confined to its own request (NaN
   logits in one slot, a tampered pack, allocation denials, cancels and a
   step deadline) and the plain versions forced at 2 layers (routes
   ``ref[forced]``, no kernel launched, the kernels again after
   ``restore()``; the forced run's steps are eager, since the plain paged
   decode's masked writes do not capture);
5. qwen3-8b — the paper's second model at full width, depth cut to
   ``QWEN_LAYERS``, W4A4 (fused) and W4A16, paged, with the same checks;
6. calibration — TwinQuant's (Q, G) learned on the card at llama3-8b's
   widths (rank 128, group 128, a_bits 4, 2048 rows of outlier-heavy
   synthetic layers built by the reference test's recipe, seed 0, f32 with
   TF32 off): (a) the q-shaped 4096 x 4096 layer at the paper's 400 / 400 /
   200 steps, host ms per step of each stage, the output error of the naive,
   +LowRank, +Hadamard and TwinQuant variants, zeta, eta, and the reference
   test's six gates (TwinQuant below +Hadamard and +LowRank, the loss
   reduced, Q orthogonal and G G^-1 = I within 1e-3, the fold-offline
   identity within 2e-3); (b) the gate/up- and down-shaped layers at
   ``CALIB_STEPS_CUT``, with a ``torch.profiler`` top-5 of one stage-3 step
   of down (Q is 14336 x 14336); (c) the calibrated q and down packs through
   ``dispatch.quant_linear`` at M = 8 (``dual_gemv``) and 512
   (``dual_gemm``), each ``torch.equal`` to ``dual_gemm_ref``, routed to the
   kernel, counts zeroed just before and read after (both kernels must have
   launched), with the relative error against f32 beside the RTN-SVD pack's;
   (d) ``simulate_quantize_params`` on llama3-8b at one layer (taps from
   ``forward_with_taps`` over 2048 seeded tokens), four methods, seconds and
   logits error against the bf16 model each (not gated);
7. olmoe-1b-7b — the ``moe`` family at full width (d_model 2048, 16 / 16
   heads, 64 experts, top-8, d_ff_expert 1024, vocab 50304) and depth
   ``OLMOE_LAYERS``: the four dual kernels on expert-stacked packs (one
   launch for all 64 experts) at Cp 8 (GEMV) and at every Cp the served
   runs give a GEMM (``MOE_GEMM_CPS``, 16 .. 1024), a_bits 4 and 8, each
   ``torch.equal`` to the stacked plain version and
   expert by expert to one-expert launches, experts 0 and 1 with swapped
   ``rp`` caught, timed beside one bf16 ``torch.bmm`` and the bound; the
   attention kernels of phase 3 at H = KV = 16; W4A4 packs (rank 128, one
   batched SVD per expert linear) served in the four modes at
   ``capacity_factor`` ``OLMOE_CF`` (drop-free) with the serve phase's
   checks (every model call four dual launches a layer: q/k/v, o, the
   experts' gate/up and down), a graph step == eager step in each mode,
   paged and ragged again under the sanitizers, and one eager paged run at
   the published capacity factor 1.25 printing the expert assignments
   dropped per model call (``moe_layer.record_drops``).

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX or of ``repro``.

``--dual-only`` runs phases 1-2 and the dual kernels' part of phase 3 and
prints no result line, as do ``--ragged-serve`` (phases 1-2, then
llama3-8b's W4A16 and W4A4 ragged-mode runs of phase 4 alone) and
``--lifecycle-only`` (phases 1-2, then the lifecycle phase on llama3-8b's
W4A4 packs), ``--calib-only`` (phases 1-2, then phase 6) and
``--olmoe-only`` (phases 1-2, then phase 7);
``--timing-only`` times the four dual wrappers at their table cases,
``w4a16_gemm`` at the four llama3-8b shapes and M in
``W4A16_MS``, the paged decode kernel at its table case (sq 1 and 4,
commit off) and the ragged kernel at its (T = 256): device ms from a CUDA
graph, host µs, CUDA events ms, each launch's device µs from
``torch.profiler``, and for the last three one library call's device ms
(bf16 ``torch.matmul``, SDPA), with ``--src``
naming another tree's ``src`` to time (a parent commit unpacked with ``git
archive``).
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
sys.path.insert(0, str(SRC))

HBM_BYTES_S = 3.35e12  # H100 SXM memory rate
INT8_OPS_S = 1.979e15  # H100 SXM dense int8 tensor-core rate
BF16_OPS_S = 9.89e14  # H100 SXM dense bf16 tensor-core rate
SERVE_LAYERS = 32  # llama3-8b's full depth
QWEN_LAYERS = 8  # qwen3-8b's 36 layers cut to keep the command near 600 s

KERNELS = {
    # wrapper name -> (source, TPU kernel it replaces)
    "dual_gemv": ("src/repro_torch/csrc/twinquant_dual_gemv.cu",
                  "src/repro/kernels/twinquant_dual_gemv.py:139"),
    "dual_gemv_group": ("src/repro_torch/csrc/twinquant_dual_gemv.cu",
                        "src/repro/kernels/twinquant_dual_gemv.py:200"),
    "dual_gemm": ("src/repro_torch/csrc/twinquant_dual_gemm.cu",
                  "src/repro/kernels/twinquant_dual_gemm.py:167"),
    "dual_gemm_group": ("src/repro_torch/csrc/twinquant_dual_gemm.cu",
                        "src/repro/kernels/twinquant_dual_gemm.py:239"),
    "paged_decode_kernel": ("src/repro_torch/csrc/paged_attention.cu",
                            "src/repro/kernels/paged_attention.py:294"),
    "ragged_attention_kernel": ("src/repro_torch/csrc/ragged_attention.cu",
                                "src/repro/kernels/ragged_attention.py:232"),
    "w4a16_gemm": ("src/repro_torch/csrc/w4a16_gemm.cu", "src/repro/kernels/w4a16_gemm.py:58"),
}
# the dual kernels' representative main-path case (layer, M) for the table
DUAL_REP = {"dual_gemv": ("down", 8), "dual_gemv_group": ("gate_up", 8),
            "dual_gemm": ("down", 512), "dual_gemm_group": ("gate_up", 512)}


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


GEMV_MS = (1, 2, 5, 8)  # the decode panel
GEMM_MS = (9, 16, 32, 100, 256, 512)  # prefill buckets, spec (32), ragged (256)


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Device ms per call: ``calls`` calls of ``fn`` captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so the wrapper's
    host work is not in the figure."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph
    return ms


def host_us(fn, calls: int = 20, batches: int = 5) -> float:
    """Host µs per call: the host clock over ``calls`` back-to-back calls
    that only enqueue (the device drains afterwards, outside the clock);
    the median of ``batches`` such batches."""
    import torch

    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return sorted(per)[batches // 2]


def dual_cases(gen, device):
    """The four dual wrappers with their plain versions, llama3-8b packs
    (single: o, down; fused: qkv, gate_up) and the M of their regime."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.twinquant_dual_gemm import dual_gemm, dual_gemm_group
    from repro_torch.kernels.twinquant_dual_gemv import dual_gemv, dual_gemv_group

    d, f, r = 4096, 14336, 128
    single = {"o": make_pack(gen, d, d, r, device), "down": make_pack(gen, f, d, r, device)}
    fused = {
        "qkv": ref.fuse_twinquant_weights([make_pack(gen, d, n, r, device)
                                           for n in (4096, 1024, 1024)]),
        "gate_up": ref.fuse_twinquant_weights([make_pack(gen, d, f, r, device)
                                               for _ in range(2)]),
    }
    return {
        "dual_gemv": (dual_gemv, ref.dual_gemm_ref, single, GEMV_MS),
        "dual_gemv_group": (dual_gemv_group, ref.dual_gemm_group_ref, fused, GEMV_MS),
        "dual_gemm": (dual_gemm, ref.dual_gemm_ref, single, GEMM_MS),
        "dual_gemm_group": (dual_gemm_group, ref.dual_gemm_group_ref, fused, GEMM_MS),
    }


def _rotating(kern, x, copies):
    it = [0]

    def run():
        it[0] = (it[0] + 1) % len(copies)
        kern(x, copies[it[0]])

    return run


def _copies(w, gw):
    # enough copies of the pack to exceed the 50 MB L2, so every timed
    # launch reads its weights from device memory like a layer of the model
    return [w] + [_clone(w) for _ in range(min(7, 120_000_000 // pack_bytes(gw)))]


def _unequal(y_k, y_p) -> str:
    err = (y_k.float() - y_p.float()).abs().max().item()
    return f"{int((y_k != y_p).sum())} of {y_k.numel()} differ, max |d| {err}"


def kernel_phase(device) -> dict:
    """The four dual kernels at llama3-8b shapes and every M of their regime:
    ``torch.equal`` to the plain version at a_bits 4 and 8, each row equal to
    a one-row launch, timed (device ms from a CUDA graph, the wrapper's host
    µs, the plain version, a bf16 ``torch.matmul`` of the same (M, K) x (K,
    N), the bound); odd segment shapes that take the kernels' masked and
    unaligned paths; a shape no kernel tiles raises."""
    import torch

    from repro_torch.kernels import build, contracts, ref

    for lib, fn, want in (
            ("twinquant_dual_gemv", "tq_gemv_smem_bytes", contracts.gemv_smem_bytes()),
            ("twinquant_dual_gemm", "tq_gemm_smem_bytes", contracts.gemm_smem_bytes())):
        got = getattr(build.load(lib), fn)()
        print(f"kernel {lib} dynamic shared memory {got} B, contracts say {want} B", flush=True)
        if got != want:
            fail(f"{lib}: the kernel's shared memory {got} B != the contract's {want} B")

    gen = torch.Generator(device=device).manual_seed(0)
    cases = dual_cases(gen, device)
    table = {}
    for name, (kern, plain, packs, ms_) in cases.items():
        worst, rep = 0.0, None
        for lname, w in packs.items():
            gw = w if isinstance(w, ref.TwinQuantGroupWeights) else ref.as_group(w)
            k, n = gw.kdim, gw.ndim_out
            copies = _copies(w, gw)
            wb = torch.randn(k, n, generator=gen, device=device).to(torch.bfloat16)
            for m in ms_:
                x = (torch.randn(m, k, generator=gen, device=device) * 2).to(torch.bfloat16)
                y_k, y_p = kern(x, w), plain(x, w)
                torch.cuda.synchronize()
                worst = max(worst, (y_k.float() - y_p.float()).abs().max().item())
                if not torch.equal(y_k, y_p):
                    fail(f"{name} {lname} M={m}: kernel != plain version ({_unequal(y_k, y_p)})")
                rows = torch.cat([kern(x[i:i + 1], w) for i in range(m)])
                if not torch.equal(rows, y_k):
                    fail(f"{name} {lname} M={m}: {int((rows != y_k).any(dim=1).sum())} rows "
                         f"differ from one-row launches")
                t_k = graph_ms(_rotating(kern, x, copies))
                t_h = host_us(_rotating(kern, x, copies))
                t_p = cuda_ms(lambda: plain(x, w), iters=2, warmup=1)
                t_lib = cuda_ms(lambda: torch.matmul(x, wb), iters=50)
                t_b, by = bound(m, k, gw)
                print(f"kernel {name:16s} {lname:8s} M={m:4d} K={k:5d} N={n:5d} equal, rows == "
                      f"one-row launches device_ms={t_k:.4f} host_us={t_h:.1f} "
                      f"plain_ms={t_p:.4f} bf16_matmul_ms={t_lib:.4f} bound_ms={t_b:.4f} ({by}) "
                      f"share={t_b / t_k:.3f} vs_matmul={t_k / t_lib:.2f}x", flush=True)
                if (lname, m) == DUAL_REP[name]:
                    rep = dict(ms=t_k, plain_ms=t_p, library_ms=t_lib, bound_ms=t_b,
                               bound_by=by)
            del copies, wb
        torch.cuda.empty_cache()
        table[name] = dict(max_abs_err=worst, **rep)

    # W4A8: the same packs at a_bits 8 (packing does not depend on it)
    for name, (kern, plain, packs, ms_) in cases.items():
        for lname, w in packs.items():
            w8 = dataclasses.replace(w, a_bits=8)
            for m in ms_:
                x = (torch.randn(m, w.kdim, generator=gen, device=device) * 2).to(torch.bfloat16)
                y_k, y_p = kern(x, w8), plain(x, w8)
                torch.cuda.synchronize()
                if not torch.equal(y_k, y_p):
                    fail(f"{name} {lname} M={m} a_bits=8: kernel != plain version "
                         f"({_unequal(y_k, y_p)})")
        print(f"kernel {name:16s} a_bits=8 equal at {list(packs)} M={list(ms_)}", flush=True)
    del cases
    torch.cuda.empty_cache()
    _odd_shapes(gen, device)

    # a shape no kernel tiles raises on the card instead of running the plain version
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.contracts import ContractError

    odd = make_pack(gen, 4096, 100, 128, device)
    for m in (8, 16):
        x = torch.randn(m, 4096, generator=gen, device=device).to(torch.bfloat16)
        try:
            dispatch.quant_linear(x, odd)
        except ContractError as e:
            print(f"kernel dispatch N=100 M={m} raises: {str(e).splitlines()[0][:100]}",
                  flush=True)
        else:
            fail(f"dispatch ran an untileable N=100 M={m} shape on the card")
    dispatch.reset_dispatch_counters()
    return table


# Fused groups the contracts admit that take the kernels' other paths: the
# GEMV's odd ranks (byte-wise H and Hq loads, an H tile past R, groups that
# are not whole 16-row k-steps), the GEMM's segments that end mid-tile.
ODD_GEMV = dict(k=512, seg_n=(256, 128, 96), seg_r=(64, 30, 6))
ODD_GEMM = dict(k=512, seg_n=(192, 64, 320), seg_r=(64, 32, 128))


def _odd_shapes(gen, device) -> None:
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.twinquant_dual_gemm import dual_gemm_group
    from repro_torch.kernels.twinquant_dual_gemv import dual_gemv_group

    for kern, spec, ms_ in ((dual_gemv_group, ODD_GEMV, (1, 3, 8)),
                            (dual_gemm_group, ODD_GEMM, (9, 100, 130))):
        gw = ref.fuse_twinquant_weights([make_pack(gen, spec["k"], n, r, device)
                                         for n, r in zip(spec["seg_n"], spec["seg_r"])])
        for a_bits in (4, 8):
            w = dataclasses.replace(gw, a_bits=a_bits)
            for m in ms_:
                x = (torch.randn(m, spec["k"], generator=gen, device=device) * 2).to(torch.bfloat16)
                y_k, y_p = kern(x, w), ref.dual_gemm_group_ref(x, w)
                torch.cuda.synchronize()
                if not torch.equal(y_k, y_p):
                    fail(f"{kern.__name__} N={spec['seg_n']} r={spec['seg_r']} M={m} "
                         f"a_bits={a_bits}: kernel != plain version ({_unequal(y_k, y_p)})")
        print(f"kernel {kern.__name__:16s} segments N={spec['seg_n']} r={spec['seg_r']} "
              f"M={list(ms_)} a_bits 4 and 8: equal", flush=True)


# names of the port's CUDA kernels as the profiler shows them
KERNEL_PREFIXES = ("tq_", "pd_", "rg_", "w4a16_", "paged_decode", "ragged_attention",
                   "_Z")


def device_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """``graph_ms`` of ``fn``; CUDA events (``cuda_ms``) when it cannot be
    captured in a CUDA graph."""
    import torch

    try:
        return graph_ms(fn, calls, replays)
    except RuntimeError:
        torch.cuda.synchronize()
        return cuda_ms(fn, iters=calls * replays)


def profile_split(fn, calls: int = 10) -> dict:
    """Device µs per call of each kernel ``fn`` launches, from
    ``torch.profiler``'s ``key_averages()`` over ``calls`` calls (empty when
    the profiler shows no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if t and e.key.replace("void ", "").startswith(KERNEL_PREFIXES) and e.count >= calls:
            split[e.key.split("(")[0].replace("void ", "")[:40]] = round(t / calls, 2)
    return split


def _time_case(label: str, fn, lib=None) -> None:
    """One ``--timing-only`` line: device ms (CUDA graph), host µs, CUDA
    events ms, each launch's device µs (profiler), and one library call's
    device ms beside it when given."""
    t_k = graph_ms(fn)
    t_h = host_us(fn)
    t_e = cuda_ms(fn, iters=50)
    split = profile_split(fn)
    t_lib = f" library_ms={device_ms(lib):.4f}" if lib is not None else ""
    print(f"timing {label} device_ms={t_k:.4f} host_us={t_h:.1f} events_ms={t_e:.4f} "
          f"split_us={json.dumps(split)}{t_lib} src={SRC}", flush=True)


def timing_phase(device) -> None:
    """Device ms (CUDA graph), host µs and the per-kernel device split
    (profiler) of the four dual wrappers at their table cases, of
    ``w4a16_gemm`` at the four llama3-8b shapes and M in ``W4A16_MS``, and of
    the paged decode kernel at its table case (sq 1 and 4, commit off)
    (``--timing-only``; runs on any tree whose wrappers take the same
    arguments, so a parent commit can be timed beside this one)."""
    import torch

    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(0)
    for name, (kern, _, packs, _) in dual_cases(gen, device).items():
        lname, m = DUAL_REP[name]
        w = packs[lname]
        gw = w if isinstance(w, ref.TwinQuantGroupWeights) else ref.as_group(w)
        copies = _copies(w, gw)
        for m_ in sorted({m, 32 if m > 8 else 1}):
            x = (torch.randn(m_, gw.kdim, generator=gen, device=device) * 2).to(torch.bfloat16)
            _time_case(f"{name:16s} {lname:8s} M={m_:4d}", _rotating(kern, x, copies))
        del copies
        torch.cuda.empty_cache()
    _timing_w4a16(gen, device)
    _timing_paged(gen, device)
    _timing_ragged(gen, device)


def _timing_w4a16(gen, device) -> None:
    import torch

    from repro_torch.kernels.w4a16_gemm import w4a16_gemm

    for lname, (k, n) in W4A16_SHAPES.items():
        wp, ws = _w4a16_pack(gen, k, n, device)
        copies = _w4a16_copies(wp, ws)
        wb = torch.randn(k, n, generator=gen, device=device).to(torch.bfloat16)
        for m in W4A16_MS:
            x = (torch.randn(m, k, generator=gen, device=device) * 2).to(torch.bfloat16)
            it = [0]

            def run(x=x):
                it[0] = (it[0] + 1) % len(copies)
                w4a16_gemm(x, *copies[it[0]])

            _time_case(f"w4a16_gemm       {lname:8s} M={m:4d}", run,
                       lib=lambda x=x: torch.matmul(x, wb))
        del copies, wb
        torch.cuda.empty_cache()


def _timing_paged(gen, device) -> None:
    import torch

    from repro_torch.kernels.paged_attention import paged_decode_kernel

    c = ATT
    B, H, KV, hd = c["B"], c["H"], c["KV"], c["hd"]
    cpu_gen = torch.Generator().manual_seed(2)
    pools = _pools(gen, device, copies=4)
    pos = torch.tensor(DECODE_LENS, dtype=torch.int32, device=device)
    for sq in (1, 4):
        bt = _tables(DECODE_LENS, [sq if n else 0 for n in DECODE_LENS], cpu_gen, device)
        q, kt, vt = (torch.randn(*shape, generator=gen, device=device).to(torch.bfloat16)
                     for shape in ((B, sq, H, hd), (B, sq, KV, hd), (B, sq, KV, hd)))
        it = [0]

        def run(q=q, kt=kt, vt=vt, bt=bt):
            it[0] = (it[0] + 1) % len(pools)
            paged_decode_kernel(q, *pools[it[0]], kt, vt, bt, pos, commit=False)

        sdpa = _sdpa_case(q, *pools[0], kt, vt, bt, pos)
        _time_case(f"paged_decode     sq={sq}     lens={max(DECODE_LENS)}", run, lib=sdpa)
    del pools
    torch.cuda.empty_cache()


def _clone(w):
    """A copy of a pack in fresh device memory."""
    import torch

    def c(v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        if isinstance(v, tuple):
            return tuple(c(t) for t in v)
        return v

    return dataclasses.replace(w, **{f.name: c(getattr(w, f.name)) for f in dataclasses.fields(w)})


# ---------------------------------------------------------------------------
# phase 3a: the weight-only W4A16 GEMM at llama3-8b shapes
# ---------------------------------------------------------------------------

W4A16_SHAPES = {"q/o": (4096, 4096), "k/v": (4096, 1024), "gate/up": (4096, 14336),
                "down": (14336, 4096)}  # (K, N)
W4A16_MS = (1, 8, 32, 256, 512)
W4A16_REP = ("down", 8)  # the table's case: decode M, the widest K
# Per row: ||y_kernel - y32|| / ||y32||, y32 the plain version run in f32
# (before its bf16 cast). The kernel differs from it only by the order of
# the sum inside a group and then rounds once to bf16 (<= 2^-9 of each
# value), so a sound row reads about 0.001; one group's scales taken from
# the next group reads ~0.17 / sqrt(K / 128), about 0.016 at K = 14336.
W4A16_REL_MAX = 0.004
W4A16_TOL = dict(atol=0.01, rtol=0.01)  # against the bf16 plain version: ~1 bf16 ULP


def _w4a16_pack(gen, k, n, device):
    import torch

    from repro_torch.kernels.ref import pack_rows_groupsplit, quantize_rows_ref

    wq, ws = quantize_rows_ref(torch.randn(k, n, generator=gen, device=device) * 0.05, 128, 4)
    return pack_rows_groupsplit(wq, 128), ws


def _w4a16_copies(wp, ws) -> list:
    """``(wp, ws)`` and copies of it past the 50 MB L2, so each timed launch
    reads its weights from device memory as a layer of the real model does."""
    pack_b = wp.numel() + ws.numel() * 4
    return [(wp, ws)] + [(wp.clone(), ws.clone()) for _ in range(min(7, 120_000_000 // pack_b))]


def _swap_nibbles(wp, g: int, group: int = 128):
    """``wp`` with the two nibbles of every byte of scale group ``g`` swapped
    (rows j and j + G/2 of the group trade places)."""
    import torch

    out = wp.clone()
    rows = slice(g * group // 2, (g + 1) * group // 2)
    u = out[rows].to(torch.int32) & 0xFF
    sw = ((u & 0x0F) << 4) | (u >> 4)
    out[rows] = (((sw + 128) % 256) - 128).to(torch.int8)
    return out


def w4a16_phase(device) -> dict:
    """``w4a16_gemm`` against its plain version at every llama3-8b linear
    shape and M in ``W4A16_MS``: per-row rel against the f32 plain version,
    atol/rtol against the bf16 one, two planted faults, rows equal to one-row
    launches; timed beside the plain version, a bf16 ``torch.matmul`` and
    the bound."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.w4a16_gemm import w4a16_gemm

    gen = torch.Generator(device=device).manual_seed(3)
    worst_err, worst_rel, rep = 0.0, 0.0, None
    for lname, (k, n) in W4A16_SHAPES.items():
        wp, ws = _w4a16_pack(gen, k, n, device)
        copies = _w4a16_copies(wp, ws)
        mid = k // 128 // 2  # the planted faults' group
        faults = {"scales of group %d read from group %d" % (mid, mid + 1):
                  (wp, torch.cat([ws[:mid], ws[mid + 1:mid + 2], ws[mid + 1:]])),
                  "nibble halves of group %d swapped" % mid: (_swap_nibbles(wp, mid), ws)}
        for m in W4A16_MS:
            x = (torch.randn(m, k, generator=gen, device=device) * 2).to(torch.bfloat16)
            y_k = w4a16_gemm(x, wp, ws)
            y_p = ref.w4a16_gemm_ref(x, wp, ws)
            y32 = ref.w4a16_gemm_f32(x, wp, ws)
            torch.cuda.synchronize()
            err = (y_k.float() - y_p.float()).abs().max().item()
            rel = _rel_rows(y_k, y32).max().item()
            rel_p = _rel_rows(y_p, y32).max().item()
            worst_err, worst_rel = max(worst_err, err), max(worst_rel, rel)
            if not torch.allclose(y_k.float(), y_p.float(), **W4A16_TOL):
                fail(f"w4a16_gemm {lname} M={m}: kernel vs plain version beyond atol "
                     f"{W4A16_TOL['atol']} / rtol {W4A16_TOL['rtol']} (max |d| {err})")
            if not rel <= W4A16_REL_MAX:
                fail(f"w4a16_gemm {lname} M={m}: kernel vs f32 plain version rel {rel} per row "
                     f"> {W4A16_REL_MAX}")
            rows = torch.cat([w4a16_gemm(x[i:i + 1], wp, ws) for i in range(m)])
            if not torch.equal(rows, y_k):
                fail(f"w4a16_gemm {lname} M={m}: {int((rows != y_k).any(dim=1).sum())} rows "
                     f"differ from one-row launches")
            if m == 8:
                for what, (fwp, fws) in faults.items():
                    y_f = w4a16_gemm(x, fwp, fws)
                    rel_f = _rel_rows(y_f, y32).max().item()
                    tol_ok = torch.allclose(y_f.float(), y_p.float(), **W4A16_TOL)
                    print(f"kernel planted fault (w4a16_gemm {lname}: {what}): rel {rel_f:.5f} "
                          f"vs limit {W4A16_REL_MAX} -> "
                          f"{'caught' if rel_f > W4A16_REL_MAX else 'MISSED'}; atol/rtol check "
                          f"alone: {'passes it' if tol_ok else 'caught'}", flush=True)
                    if not rel_f > W4A16_REL_MAX:
                        fail(f"planted fault (w4a16_gemm {lname}: {what}) passes the rel check")
            it = [0]

            def run_k():
                it[0] = (it[0] + 1) % len(copies)
                w4a16_gemm(x, *copies[it[0]])

            t_k = device_ms(run_k)
            t_p = cuda_ms(lambda: ref.w4a16_gemm_ref(x, wp, ws), iters=3, warmup=1)
            wb = torch.randn(k, n, generator=gen, device=device).to(torch.bfloat16)
            t_lib = device_ms(lambda: torch.matmul(x, wb))
            t_lib_ev = cuda_ms(lambda: torch.matmul(x, wb), iters=50)
            del wb
            nbytes = k * n // 2 + (k // 128) * n * 4 + m * k * 2 + m * n * 2
            t_b, t_o = nbytes / HBM_BYTES_S * 1e3, 2 * m * n * k / BF16_OPS_S * 1e3
            t_b, by = (t_b, "bytes") if t_b >= t_o else (t_o, "operations")
            print(f"kernel w4a16_gemm       {lname:8s} M={m:4d} K={k:5d} N={n:5d} close "
                  f"max_abs_err={err:.5f} max_rel={rel:.5f} (limit {W4A16_REL_MAX}; bf16 plain "
                  f"{rel_p:.5f}) rows == one-row launches ms={t_k:.4f} plain_ms={t_p:.4f} "
                  f"bf16_matmul_ms={t_lib:.4f} bf16_matmul_events_ms={t_lib_ev:.4f} "
                  f"bound_ms={t_b:.4f} ({by}) share={t_b / t_k:.3f}",
                  flush=True)
            if (lname, m) == W4A16_REP:
                rep = dict(ms=t_k, plain_ms=t_p, library_ms=t_lib, bound_ms=t_b, bound_by=by)
        del copies, faults
        torch.cuda.empty_cache()
    print(f"kernel w4a16_gemm max rel per row vs the f32 plain version {worst_rel:.5f} "
          f"(limit {W4A16_REL_MAX})", flush=True)
    return {"w4a16_gemm": dict(max_abs_err=worst_err, **rep)}


# ---------------------------------------------------------------------------
# phase 3b: the block-table attention kernels at llama3-8b shapes
def _timing_ragged(gen, device) -> None:
    import torch

    from repro_torch.kernels.ragged_attention import ragged_attention_kernel

    rc = _ragged_case(gen, torch.Generator().manual_seed(2), device)
    pools = _pools(gen, device, copies=4)
    args = [rc[k] for k in ("kt", "vt", "bt", "slot", "pos", "ctx")]
    it = [0]

    def run():
        it[0] = (it[0] + 1) % len(pools)
        ragged_attention_kernel(rc["q"], *pools[it[0]], *args)

    sdpa = _sdpa_ragged(rc, *pools[0])
    t_b, by = _bound_ragged(rc)
    _time_case(f"ragged_attention T={rc['T']}   ctx={max(rc['ctx_l'])} bound_ms={t_b:.4f} ({by})",
               run, lib=sdpa)
    del pools, sdpa
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------

ATT = dict(B=8, H=32, KV=8, hd=128, page=16, maxp=128)  # llama3-8b, max_len 2048
ATT_TOL = dict(atol=0.03, rtol=0.05)  # the reference's own kernel-vs-oracle bound
# Per (row, head): ||y_kernel - y32|| / ||y32|| over hd, y32 the plain version
# run on the same inputs in f32. The kernel folds in f32 and rounds once to
# bf16 (<= 2^-8 of each value), so a sound row reads ~0.002; dropping one key
# of 2000 reads ~0.04. atol/rtol alone passes such faults at long contexts,
# where |out| ~ 0.05-0.1.
ATT_REL_MAX = 0.005
DECODE_LENS = (0, 1, 250, 511, 777, 1024, 1500, 2000)  # slot 0 idle: pos 0, bt all -1


def _f32(*xs):
    return [x.float() for x in xs]


def _rel_rows(y, y32, rows=None):
    """Per-(row, head) relative L2 error of ``y`` against ``y32``."""
    a, b = y.float(), y32.float()
    if rows is not None:
        a, b = a[rows], b[rows]
    return (a - b).norm(dim=-1) / b.norm(dim=-1)


def _att_close(name: str, y_k, y_p, y32, rows=None) -> tuple[float, float]:
    """Hold a kernel's output to its plain version (atol/rtol) and to the
    plain version in f32 (per row and head, ``ATT_REL_MAX``); returns (max
    |d| vs plain, max rel vs f32) and prints the plain version's own rel."""
    import torch

    a, b = y_k.float(), y_p.float()
    if rows is not None:
        a, b = a[rows], b[rows]
    err = (a - b).abs().max().item()
    if not torch.allclose(a, b, **ATT_TOL):
        fail(f"{name}: kernel vs plain version beyond atol {ATT_TOL['atol']} / rtol "
             f"{ATT_TOL['rtol']} (max |d| {err})")
    rel = _rel_rows(y_k, y32, rows).max().item()
    rel_p = _rel_rows(y_p, y32, rows).max().item()
    print(f"kernel {name}: max rel per (row, head) vs the f32 plain version: kernel "
          f"{rel:.5f} (limit {ATT_REL_MAX}), bf16 plain version {rel_p:.5f}", flush=True)
    if not rel <= ATT_REL_MAX:
        fail(f"{name}: kernel vs f32 plain version rel {rel} per (row, head) > {ATT_REL_MAX}")
    return err, rel


def _planted(name: str, y_f, y_p, y32, rows=None) -> None:
    """A kernel run on deliberately wrong metadata must fail the rel check
    (and is reported against the atol/rtol check)."""
    import torch

    rel = _rel_rows(y_f, y32, rows).max().item()
    a, b = y_f.float(), y_p.float()
    if rows is not None:
        a, b = a[rows], b[rows]
    tol_ok = torch.allclose(a, b, **ATT_TOL)
    print(f"kernel planted fault ({name}): rel {rel:.5f} vs limit {ATT_REL_MAX} -> caught; "
          f"atol/rtol check alone: {'passes it' if tol_ok else 'caught'}", flush=True)
    if not rel > ATT_REL_MAX:
        fail(f"planted fault ({name}) passes the rel check (rel {rel})")


def _spare_page(bt, att: dict = ATT) -> int:
    """A pool page no block table maps."""
    used = set(bt[bt >= 0].tolist())
    return next(i for i in range(att["B"] * att["maxp"]) if i not in used)


def _tables(lens, extra, gen, device, att: dict = ATT):
    """Block tables mapping each slot's pages for ``lens[b] + extra[b]``
    rows from a shuffled pool of ``att``'s size (pages taken in turn), -1
    elsewhere (slot with no rows: all -1)."""
    import torch

    c = att
    perm = torch.randperm(c["B"] * c["maxp"], generator=gen, device="cpu")
    bt = torch.full((len(lens), c["maxp"]), -1, dtype=torch.int32)
    used = 0
    for b, (n, e) in enumerate(zip(lens, extra)):
        if n + e:
            n_pg = (n + e - 1) // c["page"] + 1
            bt[b, :n_pg] = perm[used:used + n_pg].to(torch.int32)
            used += n_pg
    return bt.to(device)


def _sdpa_case(q, kp, vp, kt, vt, bt, pos):
    """SDPA over the dense view the plain paged version builds (the draft
    rows written in, a per-row prefix mask): a function of no arguments,
    the paged kernel's library yardstick."""
    import torch
    import torch.nn.functional as F

    B, sq, H, hd = q.shape
    KV, S = kt.shape[2], bt.shape[1] * kp.shape[1]
    dev = q.device
    rows = pos.long()[:, None] + torch.arange(sq, device=dev)[None, :]
    kc = kp[bt.long().clamp(min=0)].reshape(B, S, KV, hd).clone()
    vc = vp[bt.long().clamp(min=0)].reshape(B, S, KV, hd).clone()
    bi = torch.arange(B, device=dev)[:, None].expand(B, sq)
    kc[bi, rows], vc[bi, rows] = kt, vt
    mask = (torch.arange(S, device=dev)[None, None, :] <= rows[:, :, None])[:, None]
    q4, k4, v4 = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    try:
        F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, enable_gqa=True)
    except TypeError:  # torch without enable_gqa: expand the KV heads first
        k4 = k4.repeat_interleave(H // KV, dim=1)
        v4 = v4.repeat_interleave(H // KV, dim=1)
        return lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)


def _pools(gen, device, copies: int, att: dict = ATT):
    """``copies`` pairs of (P, page, KV, hd) pools at ``att``'s heads, enough
    to rotate the pages read past the 50 MB L2 between timed launches."""
    import torch

    c = att
    shape = (c["B"] * c["maxp"], c["page"], c["KV"], c["hd"])
    return [tuple(torch.randn(*shape, generator=gen, device=device).to(torch.bfloat16)
                  for _ in range(2)) for _ in range(copies)]


def _bound_attn(nbytes: int, flops: int) -> tuple[float, str]:
    t_b, t_o = nbytes / HBM_BYTES_S * 1e3, flops / BF16_OPS_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


RAGGED_CTX = [1, 250, 777, 1500, 2000, 512, 0, 0]
RAGGED_RUNS = [1, 1, 1, 1, 1, 200, 40, 0]  # slot 7 idle; 11 pad rows
RAGGED_CUT = 77  # slot 5's chunk cut for the two-launch check (mid-tile: 8 rows a tile)


def _ragged_rows(ctx_l, runs, T):
    """slot and pos lists of a ragged batch: each slot's run of ``runs[s]``
    rows from ``ctx_l[s]`` in slot order, then pad rows (slot B)."""
    B = len(ctx_l)
    slot_l, pos_l = [], []
    for s_i, (n0, r) in enumerate(zip(ctx_l, runs)):
        slot_l += [s_i] * r
        pos_l += list(range(n0, n0 + r))
    n_real = len(slot_l)
    return slot_l + [B] * (T - n_real), pos_l + [0] * (T - n_real), n_real


def _ragged_case(gen, cpu_gen, device, T: int = 256, att: dict = ATT) -> dict:
    """The ragged table case: T = 256 rows of decode rows behind {1 .. 2000}
    keys, a 200-row chunk behind 512 committed keys, a cold 40-row chunk and
    pad rows, at ``att``'s heads (kept as ``att``); block tables from
    ``cpu_gen``."""
    import torch

    from repro_torch.kernels.contracts import check_ragged_rows

    c = att
    B, H, KV, hd = c["B"], c["H"], c["KV"], c["hd"]
    slot_l, pos_l, n_real = _ragged_rows(RAGGED_CTX, RAGGED_RUNS, T)
    check_ragged_rows(slot_l, pos_l, RAGGED_CTX)  # (no s_max: a parent tree's takes none)

    def t32(x):
        return torch.tensor(x, dtype=torch.int32, device=device)

    q, kt, vt = (torch.randn(*shape, generator=gen, device=device).to(torch.bfloat16)
                 for shape in ((T, H, hd), (T, KV, hd), (T, KV, hd)))
    return dict(att=att, T=T, n_real=n_real, ctx_l=RAGGED_CTX, runs=RAGGED_RUNS, slot_l=slot_l,
                pos_l=pos_l, q=q, kt=kt, vt=vt,
                bt=_tables(RAGGED_CTX, RAGGED_RUNS, cpu_gen, device, att),
                slot=t32(slot_l), pos=t32(pos_l), ctx=t32(RAGGED_CTX))


def _ragged_chunking(rc, kp, vp, y_whole) -> None:
    """The kernel's rows do not depend on the chunking: the table case
    launched whole equals, row for row and bit for bit, two launches with
    slot 5's 200-row chunk cut at ``RAGGED_CUT`` (its first part, with
    every other row, in the first launch, committed into its pages before
    the second); its decode rows equal a launch without the chunks."""
    import torch

    from repro_torch.kernels.contracts import check_ragged_rows
    from repro_torch.kernels.paged_attention import pool_rows, write_page_rows
    from repro_torch.kernels.ragged_attention import ragged_attention_kernel

    att = rc["att"]
    B = att["B"]
    T, q, kt, vt, bt, slot, pos, ctx = (rc[k] for k in ("T", "q", "kt", "vt", "bt", "slot",
                                                      "pos", "ctx"))
    dev = q.device
    r5 = sum(RAGGED_RUNS[:5])  # slot 5's first row
    n5 = RAGGED_RUNS[5]

    def launch(rows, ctx_, kp_, vp_):
        """The kernel on rows ``rows`` of the table case (then pad rows)."""
        idx = torch.tensor(rows, dtype=torch.long, device=dev)
        pad = T - len(rows)

        def fill(x, v):
            return torch.cat([x[idx], torch.full((pad, *x.shape[1:]), v, dtype=x.dtype,
                                                 device=dev)])

        sl, ps = fill(slot, B), fill(pos, 0)
        check_ragged_rows(sl.cpu().numpy(), ps.cpu().numpy(), ctx_.cpu().numpy(),
                          s_max=att["maxp"] * att["page"])
        return ragged_attention_kernel(fill(q, 0), kp_, vp_, fill(kt, 0), fill(vt, 0), bt, sl,
                                       ps, ctx_)

    first = list(range(r5 + RAGGED_CUT)) + list(range(r5 + n5, rc["n_real"]))
    second = list(range(r5 + RAGGED_CUT, r5 + n5))
    y1 = launch(first, ctx, kp, vp)
    kc, vc = kp.clone(), vp.clone()
    done = torch.arange(r5, r5 + RAGGED_CUT, device=dev)
    where = pool_rows(bt, slot[done], pos[done], kp.shape[1], kp.shape[0])
    write_page_rows(kc[None], kt[done][None], where)
    write_page_rows(vc[None], vt[done][None], where)
    ctx2 = ctx.clone()
    ctx2[5] += RAGGED_CUT
    y2 = launch(second, ctx2, kc, vc)
    decode = list(range(r5))
    y3 = launch(decode, ctx, kp, vp)
    torch.cuda.synchronize()
    two = torch.empty_like(y_whole[:rc["n_real"]])
    two[first] = y1[:len(first)]
    two[second] = y2[:len(second)]
    one = y_whole[:rc["n_real"]]
    if not torch.equal(one, two):
        bad_rows = int((one != two).flatten(1).any(dim=1).sum())
        fail(f"ragged one launch != two launches with slot 5's chunk cut at {RAGGED_CUT} "
             f"({bad_rows} of {rc['n_real']} rows differ)")
    if not torch.equal(y_whole[:r5], y3[:r5]):
        fail("ragged decode rows differ between the table case and a launch without the chunks")
    print(f"kernel ragged_attention_kernel one launch == two launches (slot 5's {n5}-row chunk "
          f"cut at {RAGGED_CUT}, the first part committed between): equal ({rc['n_real']} rows); "
          f"decode rows == a launch without the chunks: equal ({r5} rows)", flush=True)
    del kc, vc


def _sdpa_ragged(rc, kp, vp):
    """SDPA over every slot's dense view with the in-batch rows written in,
    one call with a (T, B*S) mask: a function of no arguments, the ragged
    kernel's library yardstick."""
    import torch
    import torch.nn.functional as F

    c = rc["att"]
    B, H, KV, hd = c["B"], c["H"], c["KV"], c["hd"]
    S = c["maxp"] * c["page"]
    q, kt, vt, bt, slot, pos = (rc[k] for k in ("q", "kt", "vt", "bt", "slot", "pos"))
    dev = q.device
    real = slot < B
    kc = kp[bt.long().clamp(min=0)].reshape(B, S, KV, hd).clone()
    vc = vp[bt.long().clamp(min=0)].reshape(B, S, KV, hd).clone()
    kc[slot.long()[real], pos.long()[real]] = kt[real]
    vc[slot.long()[real], pos.long()[real]] = vt[real]
    key_slot = torch.arange(B, device=dev).repeat_interleave(S)
    key_pos = torch.arange(S, device=dev).repeat(B)
    mask = (key_slot[None, :] == slot.long()[:, None]) & (key_pos[None, :] <= pos.long()[:, None])
    q4 = q.transpose(0, 1)[None]
    k4 = kc.reshape(B * S, KV, hd).transpose(0, 1)[None]
    v4 = vc.reshape(B * S, KV, hd).transpose(0, 1)[None]
    try:
        F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, enable_gqa=True)
    except TypeError:  # torch without enable_gqa: expand the KV heads first
        k4 = k4.repeat_interleave(H // KV, dim=1)
        v4 = v4.repeat_interleave(H // KV, dim=1)
        return lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)


def _bound_ragged(rc) -> tuple[float, str]:
    """The ragged table case's bound: the committed keys and values of the
    slots with rows, the rows' q, k, v and output, the metadata, read or
    written once; the score and P.V operations of every real row."""
    c = rc["att"]
    B, H, KV, hd = c["B"], c["H"], c["KV"], c["hd"]
    T = rc["T"]
    keys_ctx = sum(n0 for n0, r in zip(rc["ctx_l"], rc["runs"]) if r)
    nbytes = (2 * keys_ctx * KV * hd * 2 + T * (2 * H + 2 * KV) * hd * 2 + rc["bt"].numel() * 4
              + T * 8 + B * 4)
    flops = sum(4 * hd * H * (p + 1) for p, s_i in zip(rc["pos_l"], rc["slot_l"]) if s_i < B)
    return _bound_attn(nbytes, flops)


def attention_phase(device, att: dict = ATT) -> dict:
    """The paged-decode and ragged kernels against their plain versions at
    the heads and pools of ``att`` (llama3-8b's by default), timed beside
    the plain version and SDPA over a dense view; plus the
    stacked-vs-sequential identity of the paged kernel and the
    one-vs-two-launch identity of the ragged kernel."""
    import torch

    from repro_torch.kernels import build, contracts
    from repro_torch.kernels.paged_attention import paged_decode_kernel, paged_decode_ref
    from repro_torch.kernels.ragged_attention import ragged_attention_kernel, ragged_attention_ref

    c = att
    B, H, KV, hd = c["B"], c["H"], c["KV"], c["hd"]
    for lib, fn, args, want in (
            ("paged_attention", "paged_decode_smem_bytes", (hd, H // KV),
             contracts.paged_smem_bytes(hd, H // KV)),
            ("paged_attention", "paged_decode_smem_bytes", (hd, 4 * H // KV),
             contracts.paged_smem_bytes(hd, 4 * H // KV)),
            ("ragged_attention", "ragged_attention_smem_bytes", (hd,),
             contracts.ragged_smem_bytes(hd))):
        got = getattr(build.load(lib), fn)(*args)
        print(f"kernel {lib} split block dynamic shared memory {got} B at {args}, contracts "
              f"say {want} B", flush=True)
        if got != want:
            fail(f"{lib}: the kernel's shared memory {got} B != the contract's {want} B")
    gen = torch.Generator(device=device).manual_seed(2)
    cpu_gen = torch.Generator().manual_seed(2)
    pools = _pools(gen, device, copies=4, att=att)
    kp, vp = pools[0]
    table = {}

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(torch.bfloat16)

    # -- paged decode: sq = 1 (decode) and 4 (speculative verify), commit on/off
    pos = torch.tensor(DECODE_LENS, dtype=torch.int32, device=device)
    worst, rep = 0.0, None
    for sq in (1, 4):
        bt = _tables(DECODE_LENS, [sq if n else 0 for n in DECODE_LENS], cpu_gen, device, att)
        q, kt, vt = rnd(B, sq, H, hd), rnd(B, sq, KV, hd), rnd(B, sq, KV, hd)
        for commit in (False, True):
            kk, vk = kp.clone(), vp.clone()
            res_k = paged_decode_kernel(q, kk, vk, kt, vt, bt, pos, commit=commit)
            res_p = paged_decode_ref(q, kp, vp, kt, vt, bt, pos, commit=commit)
            torch.cuda.synchronize()
            out_k, out_p = (res_k[0], res_p[0]) if commit else (res_k, res_p)
            y32 = paged_decode_ref(*_f32(q, kp, vp, kt, vt), bt, pos, commit=False)
            err, rel = _att_close(f"paged_decode sq={sq} commit={commit}", out_k, out_p, y32)
            worst = max(worst, err)
            if (sq, commit) == (1, False):
                # faults confined to the longest context (slot 7, 2000 keys)
                short = pos.clone()
                short[7] -= 1
                _planted("paged: slot 7 misses its last committed key",
                         paged_decode_kernel(q, kp, vp, kt, vt, bt, short, commit=False),
                         out_p, y32)
                bad = bt.clone()
                bad[7, 60] = _spare_page(bt, att)
                _planted("paged: slot 7 reads one wrong page",
                         paged_decode_kernel(q, kp, vp, kt, vt, bad, pos, commit=False),
                         out_p, y32)
            del y32
            if commit:
                if not (torch.equal(res_k[1], res_p[1]) and torch.equal(res_k[2], res_p[2])):
                    fail(f"paged_decode sq={sq}: committed pools differ from the plain version's")
            del kk, vk, res_k, res_p
            it = [0]

            def run_k():
                it[0] = (it[0] + 1) % len(pools)
                paged_decode_kernel(q, *pools[it[0]], kt, vt, bt, pos, commit=commit)

            t_k = device_ms(run_k)
            t_p = cuda_ms(lambda: paged_decode_ref(q, kp, vp, kt, vt, bt, pos, commit=commit),
                          iters=3, warmup=1)
            # SDPA yardstick: one call over the dense view the plain version
            # builds, timed as the kernel is and with CUDA events
            lib = _sdpa_case(q, kp, vp, kt, vt, bt, pos)
            t_lib, t_lib_ev = device_ms(lib), cuda_ms(lib, iters=20)
            del lib
            nbytes = (2 * sum(DECODE_LENS) * KV * hd * 2 + 2 * B * sq * H * hd * 2
                      + (2 + 2 * commit) * B * sq * KV * hd * 2 + bt.numel() * 4 + B * 4)
            flops = sum(4 * hd * H * (n + i + 1) for n in DECODE_LENS for i in range(sq))
            t_b, by = _bound_attn(nbytes, flops)
            print(f"kernel paged_decode_kernel sq={sq} commit={int(commit)} B={B} H={H}/{KV} "
                  f"hd={hd} lens={list(DECODE_LENS)} close max_abs_err={err:.5f} "
                  f"max_rel={rel:.5f} ms={t_k:.4f} "
                  f"plain_ms={t_p:.4f} sdpa_ms={t_lib:.4f} sdpa_events_ms={t_lib_ev:.4f} "
                  f"bound_ms={t_b:.4f} ({by}) share={t_b / t_k:.3f}", flush=True)
            if (sq, commit) == (1, False):
                rep = dict(ms=t_k, plain_ms=t_p, library_ms=t_lib, bound_ms=t_b, bound_by=by)
    table["paged_decode_kernel"] = dict(max_abs_err=worst, **rep)

    # -- stacked sq = 4 rows == four sequential sq = 1 launches, drafts committed
    #    between; one more slot's rows straddle a chunk boundary of the kernel's
    #    key split (positions PAGED_CHUNK - 2 .. PAGED_CHUNK + 1)
    from repro_torch.kernels.autotune import PAGED_CHUNK

    sq = 4
    lens = DECODE_LENS + (PAGED_CHUNK - 2,)
    nb = len(lens)
    pos_s = torch.tensor(lens, dtype=torch.int32, device=device)
    bt = _tables(lens, [sq if n else 0 for n in lens], cpu_gen, device, att)
    q, kt, vt = rnd(nb, sq, H, hd), rnd(nb, sq, KV, hd), rnd(nb, sq, KV, hd)
    stacked = paged_decode_kernel(q, kp, vp, kt, vt, bt, pos_s, commit=False)
    ks, vs = kp.clone(), vp.clone()
    seq = []
    for i in range(sq):
        o, ks, vs = paged_decode_kernel(q[:, i:i + 1].contiguous(), ks, vs,
                                        kt[:, i:i + 1].contiguous(), vt[:, i:i + 1].contiguous(),
                                        bt, pos_s + i, commit=True)
        seq.append(o)
    torch.cuda.synchronize()
    seq = torch.cat(seq, dim=1)
    # slots whose draft pages are mapped (the idle slot's drafts commit nowhere)
    mapped = pos_s > 0
    if not torch.equal(stacked[mapped], seq[mapped]):
        fail(f"paged_decode stacked sq=4 rows != sequential launches "
             f"({int((stacked[mapped] != seq[mapped]).sum())} of {seq[mapped].numel()} differ)")
    print(f"kernel paged_decode_kernel stacked sq=4 == 4 sequential sq=1 launches: equal "
          f"({int(mapped.sum())} mapped slots, lens {list(lens)}, chunk {PAGED_CHUNK})",
          flush=True)
    del ks, vs

    # -- ragged: T = 256 rows, decode rows + a chunk behind committed pages +
    #    a cold chunk + pad rows
    rc = _ragged_case(gen, cpu_gen, device, att=att)
    q, kt, vt, bt, slot, rpos, ctx = (rc[k] for k in ("q", "kt", "vt", "bt", "slot", "pos", "ctx"))
    T, n_real = rc["T"], rc["n_real"]
    y_k = ragged_attention_kernel(q, kp, vp, kt, vt, bt, slot, rpos, ctx)
    y_p = ragged_attention_ref(q, kp, vp, kt, vt, bt, slot, rpos, ctx)
    torch.cuda.synchronize()
    real = slot < B
    y32 = ragged_attention_ref(*_f32(q, kp, vp, kt, vt), bt, slot, rpos, ctx)
    err, rel = _att_close("ragged T=256", y_k, y_p, y32, rows=real)
    if not torch.equal(y_k[~real], torch.zeros_like(y_k[~real])):
        fail("ragged pad rows are not zero")
    short = ctx.clone()
    short[4] -= 1  # slot 4: one decode row behind 2000 committed keys
    _planted("ragged: slot 4 misses its last committed key",
             ragged_attention_kernel(q, kp, vp, kt, vt, bt, slot, rpos, short), y_p, y32, real)
    bad = bt.clone()
    bad[5, 10] = _spare_page(bt, att)  # slot 5: a 200-row chunk behind 512 committed keys
    _planted("ragged: slot 5 reads one wrong page",
             ragged_attention_kernel(q, kp, vp, kt, vt, bad, slot, rpos, ctx), y_p, y32, real)
    del y32
    _ragged_chunking(rc, kp, vp, y_k)
    it = [0]

    def run_r():
        it[0] = (it[0] + 1) % len(pools)
        ragged_attention_kernel(q, *pools[it[0]], kt, vt, bt, slot, rpos, ctx)

    t_k = device_ms(run_r)
    t_p = cuda_ms(lambda: ragged_attention_ref(q, kp, vp, kt, vt, bt, slot, rpos, ctx),
                  iters=2, warmup=1)
    # SDPA yardstick: every slot's dense view, in-batch rows written in, one
    # call over all of them with a (T, B*S) mask; timed as the kernel is,
    # and with CUDA events
    lib = _sdpa_ragged(rc, kp, vp)
    t_lib, t_lib_ev = device_ms(lib), cuda_ms(lib, iters=10)
    del lib
    t_b, by = _bound_ragged(rc)
    print(f"kernel ragged_attention_kernel T={T} rows={n_real} runs={rc['runs']} "
          f"ctx={rc['ctx_l']} close max_abs_err={err:.5f} max_rel={rel:.5f} ms={t_k:.4f} "
          f"plain_ms={t_p:.4f} sdpa_ms={t_lib:.4f} sdpa_events_ms={t_lib_ev:.4f} "
          f"bound_ms={t_b:.4f} ({by}) share={t_b / t_k:.3f}", flush=True)
    table["ragged_attention_kernel"] = dict(max_abs_err=err, ms=t_k, plain_ms=t_p,
                                            library_ms=t_lib, bound_ms=t_b, bound_by=by)
    del pools
    torch.cuda.empty_cache()
    return table


# ---------------------------------------------------------------------------
# phase 4: serve llama3-8b (full width, cut depth)
# ---------------------------------------------------------------------------

PROMPT_LENS = (3, 6, 8, 20, 40, 64, 300, 500, 512, 700, 900, 1024)  # buckets 8 .. 1024


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ttft(reqs) -> tuple[float, float]:
    """Mean and max time to first token (s, host clock from submit)."""
    t = [r.t_first_token - r.t_submit for r in reqs]
    return sum(t) / len(t), max(t)


def _param_bytes(model) -> int:
    return sum(t.numel() * t.element_size() for t in model.buffers())


def _drive(name: str, engine, reqs, device, n_layers: int) -> dict:
    """Serve ``reqs`` with the launch and route counters zeroed just before,
    check the run, print its lines; returns the run's (launch counts,
    routes)."""
    import torch

    from repro_torch.kernels import cuda_launch, dispatch

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    # what is resident before the run (this model's and any other kept
    # model's tensors): the run's own peak is max_memory_allocated above it
    resident = torch.cuda.memory_allocated(device) if cuda else "not measured"
    dispatch.reset_dispatch_counters()
    cuda_launch.reset_launch_counts()
    t0 = time.perf_counter()
    engine.serve(reqs)
    _sync(device)
    wall = time.perf_counter() - t0
    launches = cuda_launch.launch_counts()
    routes = dispatch.dispatch_counters()
    peak = torch.cuda.max_memory_allocated(device) if cuda else "not measured"
    bad = [(r.request_id, r.status, r.error) for r in reqs if r.status != "DONE"]
    if bad:
        fail(f"{name}: requests not DONE: {bad}")
    if any(len(r.out) != r.max_new for r in reqs):
        fail(f"{name}: short outputs: {[len(r.out) for r in reqs]}")
    print(f"serve {name} routes {json.dumps(routes, sort_keys=True)}", flush=True)
    print(f"serve {name} launches {json.dumps(launches, sort_keys=True)}", flush=True)
    if any("/ref" in key for key in routes):
        fail(f"{name}: plain-version routes taken: {routes}")
    tp = engine.throughput()
    mean_ttft, max_ttft = _ttft(reqs)
    print(f"serve {name} done requests={len(reqs)} wall_s={wall:.3f} "
          f"decode_tok_s={tp['decode_tok_s']:.2f} prefill_tok_s={tp['prefill_tok_s']:.2f} "
          f"decode_steps={tp['decode_steps']} decode_tokens={tp['decode_tokens']} "
          f"decode_s={tp['decode_s']:.4f} prefill_s={tp['prefill_s']:.4f} "
          f"ttft_mean_s={mean_ttft:.4f} "
          f"ttft_max_s={max_ttft:.4f} param_bytes={_param_bytes(engine.params)} "
          f"resident_before={resident} max_memory_allocated={peak} "
          f"compile_stats={json.dumps(engine.compile_stats())}", flush=True)
    return launches, routes


# which per-row ops of the verify step run one draft column at a time
SPEC_VARIANTS = {"shipped": ("norms",), "stacked": (), "per_column": ("norms", "head")}


def _spec_run(variant: str, engine, reqs, want, cfg, device) -> None:
    """Serve ``reqs`` speculatively with the verify step's rmsnorms and bf16
    head run one draft column at a time or over the whole (B, spec_k, D)
    stack, as ``SPEC_VARIANTS[variant]`` says (``shipped`` is the decode
    step as it is). Every norm and head call of every verify step is run
    both ways on its real input, so the line names the ops that gave a
    verify row other bits stacked on this run's data; the tokens are
    compared with the paged run's ``want``. Not gated: spec == paged as
    shipped is the gate. The patches are in place before the engine's first
    step, so its step graph captures them; the rows are counted on the
    device, in place, so every replay counts too."""
    import torch

    from repro_torch.models import common as C
    from repro_torch.models import dense

    per_column, unembed = C.per_draft_row, dense._unembed
    cols = SPEC_VARIANTS[variant]
    calls, counts = [0], {}

    def both(name, fn, x, per_col):
        if x.shape[1] == 1:
            return fn(x)
        y_stk, y_col = fn(x), per_column(fn, x)
        if name not in counts:
            counts[name] = torch.zeros((), dtype=torch.long, device=x.device)
        counts[name] += (y_stk != y_col).any(dim=-1).sum()
        return y_col if per_col else y_stk

    def norm(fn, x):
        k = calls[0] % (2 * cfg.n_layers)
        calls[0] += 1
        return both(f"layer{k // 2}.ln{1 + k % 2}", fn, x, "norms" in cols)

    def head(params, c, x):
        return both("head", lambda y: unembed(params, c, y), x, "head" in cols)

    C.per_draft_row, dense._unembed = norm, head
    try:
        _drive(f"spec probe {variant}", engine, reqs, device, cfg.n_layers)
    finally:
        C.per_draft_row, dense._unembed = per_column, unembed
    moved = {k: int(v) for k, v in counts.items() if int(v)}
    diff = [i for i, (a, b) in enumerate(zip(reqs, want)) if a.out != b.out]
    norms = sum(v for k, v in moved.items() if k != "head")
    print(f"serve spec probe variant={variant} (per column: {list(cols) or 'none'}) tokens == "
          f"paged: {not diff} (differ: {diff}); verify rows with other bits stacked: head "
          f"{moved.get('head', 0)}, rmsnorm {norms} in {len(moved) - ('head' in moved)} of "
          f"{2 * cfg.n_layers} norms {json.dumps(dict(sorted(moved.items())[:6]))}", flush=True)


def _first_layers(model, k: int):
    """The same model cut to its first ``k`` layers (shared tensors)."""
    from repro_torch.models import dense

    return dense.DenseModel(model.embed, list(model.layers)[:k], model.ln_f, model.head)


def _ragged_vs_prefill(model, cfg, prompt, device, depths) -> list:
    """One whole prompt's last-row logits three ways, at each depth in
    ``depths``: the bucketed prefill (plain attention with the reference's
    bf16 roundings), the ragged step (the kernel, f32 fold, one rounding)
    and the ragged step with its attention swapped for the plain version run
    in f32 and rounded once (the kernel's numerics, written independently).
    Returns [(depth, rel ragged vs prefill, rel f32-plain step vs prefill,
    rel ragged vs f32-plain step, argmax equal, the prefill's top-2 gap)]."""
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.kernels.ragged_attention import ragged_attention_ref
    from repro_torch.models import common as C
    from repro_torch.models import dense

    def f32_plain(q, kp, vp, kt, vt, bt, slot, pos, ctx):
        return ragged_attention_ref(*_f32(q, kp, vp, kt, vt), bt, slot, pos, ctx).to(vt.dtype)

    def rel(x, y):
        return (torch.linalg.norm(x - y) / torch.linalg.norm(y)).item()

    n, page = len(prompt), 16
    toks = torch.as_tensor(prompt, dtype=torch.long, device=device)
    zeros = torch.zeros(n, dtype=torch.int32, device=device)
    out = []
    for k in depths:
        m, c = _first_layers(model, k), cfg.replace(n_layers=k)
        lb, _ = dense.prefill(m, c, toks[None], dense.init_decode_state(c, 1, n, device=device))
        steps = []
        for attn in (dispatch.ragged_attention, f32_plain):
            st = C.init_paged_state(dense.init_decode_state, c, 1, n, page, -(-n // page), device)
            st["bt"][0] = torch.arange(st["bt"].shape[1], dtype=torch.int32, device=device)
            kernel_attn, dispatch.ragged_attention = dispatch.ragged_attention, attn
            try:
                lr, _ = dense.ragged_step(m, c, st, toks, zeros,
                                          torch.arange(n, dtype=torch.int32, device=device),
                                          zeros[:1], torch.tensor([n - 1], device=device))
            finally:
                dispatch.ragged_attention = kernel_attn
            steps.append(lr[0, :cfg.vocab].float())
        a = lb[0, -1, :cfg.vocab].float()
        top2 = a.topk(2).values
        out.append((k, rel(steps[0], a), rel(steps[1], a), rel(steps[0], steps[1]),
                    bool(a.argmax() == steps[0].argmax()), (top2[0] - top2[1]).item()))
    return out


def _depth_line(rows) -> str:
    return " ".join(f"L{k}:ragged={r:.4f},f32_plain={rf:.4f},ragged_vs_f32_plain={rr:.4f},"
                    f"argmax_equal={e},top2_gap={g:.4f}" for k, r, rf, rr, e, g in rows)


# the ragged step vs the bucketed prefill on the bf16 model (before
# quantization): no 4-bit activation can flip, so what differs is the
# attention's rounding carried through the depth (read 0.0196 at 32 layers
# on an H100, PERF.md; the argmax is not held: random weights leave the top
# two logits within that error)
RAGGED_BF16_REL_MAX = 0.025
DEPTHS = (1, 2, 4, 8, 16, 32)


MODES = {
    "bucketed": {},
    "paged": dict(paged=True),
    "spec": dict(paged=True, speculation=True, spec_k=4),
    "ragged": dict(paged=True, ragged=True, token_budget=256),
}
# kernel-vs-plain prefill logits of the W4A16 model at full depth (rel, one
# prompt): the kernel differs from the plain version only by the order of the
# sum inside a group, a bf16 ULP on some outputs of each linear, which random
# weights carry and grow through the depth (read 0.0198 at 32 layers on an
# H100, PERF.md; the bf16 model's ragged-vs-prefill reads alike)
W4A16_LOGITS_REL_MAX = 0.03


def _w4a16_f32_order(x, wp, ws, group=128):
    """The W4A16 plain version with each group's dot a float32 matmul (the
    order a matmul sums in) instead of f64: a second sound version."""
    import torch

    from repro_torch.kernels.ref import unpack_rows_groupsplit

    wq = unpack_rows_groupsplit(wp, group)
    acc = torch.zeros((x.shape[0], wq.shape[1]), dtype=torch.float32, device=x.device)
    for g in range(wq.shape[0] // group):
        w = (wq[g * group:(g + 1) * group].float() * ws[g:g + 1]).to(torch.bfloat16)
        acc = acc + x[:, g * group:(g + 1) * group].float() @ w.float()
    return acc.to(torch.bfloat16)


# the graph run's engine step after which one step is replayed from the
# graph and run eagerly from the same state (all 8 slots live in every mode)
CHECK_STEP = 6
# (setting, mode) pairs whose eager and graph steps are timed, and how many
# steps each reading takes
STEP_TIMED = {("w4a16", "paged"), ("w4a4", "paged"), ("w4a4", "ragged"),
              ("olmoe w4a4", "paged")}
STEP_REPS = 10
# profiler name prefixes of the hand-written kernels (csrc/*.cu)
HANDWRITTEN = ("tq_", "pd_", "rg_", "w4a16_")
GRAPH_KEY = {"bucketed": "decode_graphs", "paged": "decode_graphs", "spec": "spec_graphs",
             "ragged": "ragged_graphs"}


def _clone_state(state) -> dict:
    return {k: v.clone() for k, v in state.items()}


def _restore_state(state, snap) -> None:
    for k, v in snap.items():
        state[k].copy_(v)


def _kernel_us(prof):
    """(kernel name, device µs, launches) of every device event in a
    profile."""
    import torch

    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if t and e.device_type == torch.autograd.DeviceType.CUDA:
            yield e.key.replace("void ", ""), t, e.count


def _after_step(eng, n: int, fn) -> None:
    """Run ``fn()`` once, right after the engine's ``n``-th step."""
    step, done = eng.step, [0]

    def wrapped(*args, **kwargs):
        out = step(*args, **kwargs)
        done[0] += 1
        if done[0] == n:
            fn()
        return out

    eng.step = wrapped


def _step_times(eng, snap) -> dict:
    """Device time per step, each reading over ``STEP_REPS`` steps run from
    ``snap`` (the state and the static inputs of one steady step, put back
    before each reading): the replays between CUDA events (and the host ms
    a replay takes to enqueue), and the kernel time (``torch.profiler``'s
    device events summed) of replays and of eager steps. Zero where the
    profiler shows no device time. The engine must be idle; its state is
    put back as it was."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import cuda_launch, dispatch

    sg = eng.step_graph
    launches, routes = cuda_launch.launch_counts(), dispatch.dispatch_counters()
    was = _clone_state(eng.state)
    _restore_state(sg.buffers, snap["buffers"])
    _restore_state(eng.state, snap["state"])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    for _ in range(STEP_REPS):
        sg.graph.replay()
    host = (time.perf_counter() - t0) / STEP_REPS * 1e3
    end.record()
    torch.cuda.synchronize()
    out = {"replay_events_ms": start.elapsed_time(end) / STEP_REPS, "replay_host_ms": host}
    for way, fn in (("graph", sg.graph.replay), ("eager", lambda: sg.fn(**sg.buffers))):
        _restore_state(eng.state, snap["state"])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(STEP_REPS):
                fn()
            torch.cuda.synchronize()
        events = list(_kernel_us(prof))
        out[f"{way}_kernel_ms"] = sum(t for _, t, _ in events) / STEP_REPS / 1e3
        out[f"{way}_handwritten_ms"] = sum(t for k, t, _ in events
                                           if k.startswith(HANDWRITTEN)) / STEP_REPS / 1e3
        out[f"{way}_launches"] = sum(n for _, _, n in events) / STEP_REPS
    _restore_state(eng.state, was)
    cuda_launch.reset_launch_counts()
    cuda_launch.add_launch_counts(launches)
    dispatch.reset_dispatch_counters()
    dispatch.add_dispatch_counts(routes)
    return out


def _step_check(name: str, eng, keep: bool) -> dict:
    """At a steady step of a graph run, the engine's last step replayed
    from its graph and run eagerly (the step function on the same static
    inputs) from one state: the logits and every state tensor (caches or
    pools, block table, positions) must be ``torch.equal``. The state is put
    back and the eager step's launch and route counts taken back, so the
    run goes on as if none of it ran. ``keep`` returns that state and the
    static inputs (for ``_step_times`` once the run is over)."""
    import torch

    from repro_torch.kernels import cuda_launch, dispatch

    sg = eng.step_graph
    if sg.graph is None:
        print(f"serve {name} step graph == eager step: not checked (eager on {eng.device})",
              flush=True)
        return {}
    launches, routes = cuda_launch.launch_counts(), dispatch.dispatch_counters()
    snap = _clone_state(eng.state)
    sg.graph.replay()
    out_g = sg.out.clone()
    after_g = _clone_state(eng.state)
    _restore_state(eng.state, snap)
    out_e = sg.fn(**sg.buffers)
    torch.cuda.synchronize()
    differ = [k for k in snap if not torch.equal(after_g[k], eng.state[k])]
    if not torch.equal(out_g, out_e) or differ:
        fail(f"{name}: a step replayed from the graph != the same step run eagerly (logits "
             f"equal: {torch.equal(out_g, out_e)}, state tensors that differ: {differ})")
    del after_g, out_g, out_e
    _restore_state(eng.state, snap)
    kept = {"state": snap, "buffers": _clone_state(sg.buffers)} if keep else {}
    del snap
    cuda_launch.reset_launch_counts()
    cuda_launch.add_launch_counts(launches)
    dispatch.reset_dispatch_counters()
    dispatch.add_dispatch_counts(routes)
    print(f"serve {name} step graph == eager step: logits and state {sorted(eng.state)} "
          f"equal (step {eng.stats['decode_steps']}, replayed and run eagerly from one state)",
          flush=True)
    return kept


def _step_ms(eng, mode: str) -> float:
    """Host-clock ms per model step, as the engine accounts it (a ragged
    step's time is split between its decode and prefill rows)."""
    st = eng.stats
    busy = st["decode_s"] + (st["prefill_s"] if mode == "ragged" else 0.0)
    return busy / max(st["decode_steps"], 1) * 1e3


def _submit_order(prompts, batch: int, max_len: int) -> list:
    """Request indices with one prompt of every prefill bucket among the
    first ``batch`` (admitted at once), so no later admission adds a
    prefill shape."""
    from repro_torch.launch.serve import ContinuousBatchingEngine

    seen, first, rest = set(), [], []
    for i, p in enumerate(prompts):
        b = ContinuousBatchingEngine._bucket(len(p), max_len)
        (rest if b in seen else first).append(i)
        seen.add(b)
    if len(first) > batch:
        fail(f"{len(first)} prefill buckets do not fit the first {batch} slots")
    return first + rest


class Served:
    """One quantized model served in several engine modes on the same 12
    requests: ``serve(mode)`` runs and checks a mode; ``launches`` holds each
    kernel's count from the run whose main path it is. Engines run their
    steps as CUDA graphs (the engine's default on the card); the eager path
    runs where a check asks for it."""

    def __init__(self, tag: str, cfg, qp, kind: str, prompts, device, max_len: int = 2048):
        import inspect

        from repro_torch.launch.serve import ContinuousBatchingEngine

        self.tag, self.cfg, self.qp, self.kind = tag, cfg, qp, kind
        self.prompts, self.device, self.max_len = prompts, device, max_len
        self.outs: dict = {}
        self.launches: dict = {}
        self.step_times: dict = {}
        # a tree before step graphs (``--src`` of a parent) serves eagerly
        self.graphs = "step_graphs" in inspect.signature(ContinuousBatchingEngine).parameters
        print(f"serve {tag} param_bytes={_param_bytes(qp)}", flush=True)

    def request(self, i):
        from repro_torch.launch.serve import Request, SamplingParams

        return Request(self.prompts[i], max_new=32,
                       sampling=SamplingParams(temperature=0.8, top_k=50, seed=1)
                       if i == 3 else SamplingParams())

    def requests(self):
        return [self.request(i) for i in range(len(self.prompts))]

    def engine(self, mode, **kw):
        """An engine in ``mode``; ``kw`` (``step_graphs``) only where the tree
        has step graphs."""
        from repro_torch.launch.serve import ContinuousBatchingEngine

        if not self.graphs:
            kw.pop("step_graphs", None)
        return ContinuousBatchingEngine(self.cfg, self.qp, batch_slots=8, max_len=self.max_len,
                                        device=self.device, **MODES[mode], **kw)

    def prefill_logits(self) -> None:
        """Kernel vs plain logits on one prompt through the model entry point:
        equal for the dual kernels. For W4A16 at each depth in ``DEPTHS``:
        the kernel and, as a control, the plain version with each group's
        dot summed in f32 in a matmul's order (another sound order), both
        against the plain version; gated at full depth."""
        import torch

        from repro_torch.kernels import dispatch, ref
        from repro_torch.models import dense

        toks = torch.as_tensor(self.prompts[4][None, :], device=self.device, dtype=torch.long)

        def logits(model, cfg, plain=None):
            state = dense.init_decode_state(cfg, 1, 64, device=self.device)
            if plain is None:
                return dense.prefill(model, cfg, toks, state)[0].float()
            prev, keep = dispatch.set_force_ref(True), ref.w4a16_gemm_ref
            ref.w4a16_gemm_ref = plain
            try:
                return dense.prefill(model, cfg, toks, state)[0].float()
            finally:
                dispatch.set_force_ref(prev)
                ref.w4a16_gemm_ref = keep

        if self.kind != "w4a16":
            lk, lp = logits(self.qp, self.cfg), logits(self.qp, self.cfg, ref.w4a16_gemm_ref)
            if not torch.equal(lk, lp):
                fail(f"{self.tag}: prefill logits through the kernels != plain versions "
                     f"(max |d| {(lk - lp).abs().max().item()})")
            print(f"serve {self.tag} prefill logits kernel == plain: equal", flush=True)
            return

        def rel(a, b):
            return (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()

        rows = []
        for k in [d for d in DEPTHS if d < self.cfg.n_layers] + [self.cfg.n_layers]:
            m, c = _first_layers(self.qp, k), self.cfg.replace(n_layers=k)
            lp = logits(m, c, ref.w4a16_gemm_ref)
            rows.append((k, rel(logits(m, c), lp), rel(logits(m, c, _w4a16_f32_order), lp)))
        print(f"serve {self.tag} prefill logits vs plain ({len(self.prompts[4])}-token prompt) "
              + " ".join(f"L{k}:kernel={a:.5f},f32_order_plain={b:.5f}" for k, a, b in rows)
              + f" (limit at full depth: kernel rel <= {W4A16_LOGITS_REL_MAX})", flush=True)
        if not rows[-1][1] <= W4A16_LOGITS_REL_MAX:
            fail(f"{self.tag}: prefill logits kernel vs plain rel {rows[-1][1]} > "
                 f"{W4A16_LOGITS_REL_MAX}")

    def _linears(self, mode, eng, got, routes) -> None:
        """The quantized linears' routes and launches for one run."""
        L, cuda = self.cfg.n_layers, self.device.type == "cuda"
        name = f"{self.tag} {mode}"
        if self.kind == "w4a16":
            calls = eng.stats["decode_steps"] + eng.compile_stats()["prefill_calls"]
            want = 7 * L * calls
            if any(k.startswith("dual") for k in routes) or routes.get("w4a16/prefill") != want:
                fail(f"{name}: want only w4a16/prefill x {want} (7 x {L} layers x {calls} model "
                     f"calls), routes {routes}")
            if cuda and got.get("w4a16_gemm", 0) != want:
                fail(f"{name}: w4a16_gemm launched {got.get('w4a16_gemm')} times, want {want}")
            print(f"serve {name} launches_per_model_call w4a16_gemm=7x{L} (q, k, v, o, gate, "
                  f"up, down) model_calls={calls}", flush=True)
            if mode == "bucketed":
                self.launches["w4a16_gemm"] = got.get("w4a16_gemm", 0)
            return
        if mode == "bucketed":
            for key in ("dual/decode", "dual/prefill", "dual_fused/decode", "dual_fused/prefill"):
                if routes.get(key, 0) <= 0:
                    fail(f"{name}: route {key} never taken")
            for kname in ("dual_gemv", "dual_gemv_group", "dual_gemm", "dual_gemm_group"):
                if cuda and got.get(kname, 0) <= 0:
                    fail(f"kernel {kname} never launched on the {name} path")
                self.launches[kname] = got.get(kname, 0)
            print(f"serve {name} launches_per_decode_step dual_gemv={2 * L} "
                  f"dual_gemv_group={2 * L} (o, down / qkv, gate_up per layer)", flush=True)
        elif not any(k.startswith("dual") for k in routes):
            fail(f"{name}: no dual-kernel route taken: {routes}")

    def _attention(self, mode, eng, got, routes) -> None:
        """The attention kernel of the mode launches once a layer a step."""
        L, cuda = self.cfg.n_layers, self.device.type == "cuda"
        name = f"{self.tag} {mode}"
        kernel, route = {"paged": ("paged_decode_kernel", "paged_decode/kernel"),
                         "spec": ("paged_decode_kernel", "paged_decode/kernel"),
                         "ragged": ("ragged_attention_kernel", "ragged/kernel")}[mode]
        steps = eng.stats["spec_launches"] if mode == "spec" else eng.stats["decode_steps"]
        if routes.get(route, 0) != L * steps:
            fail(f"{name}: {route} routed {routes.get(route)} times, want {L} x {steps} steps")
        if cuda and got.get(kernel, 0) != L * steps:
            fail(f"{name}: {kernel} launched {got.get(kernel)} times, want {L} per step "
                 f"({steps})")
        if mode != "spec":
            self.launches.setdefault(kernel, got.get(kernel, 0))

    def _graph(self, mode, eng) -> None:
        """One capture per engine: the mode's step graph, replayed at every
        later step (eager off the card)."""
        if not self.graphs:
            return
        cs, cuda = eng.compile_stats(), self.device.type == "cuda"
        steps = eng.step_graph.steps
        want = {key: 0 for key in set(GRAPH_KEY.values())}
        want[GRAPH_KEY[mode]] = 1 if cuda else 0
        got = {key: cs[key] for key in want}
        replays = steps - 1 if cuda else 0
        if got != want or cs["graph_replays"] != replays:
            fail(f"{self.tag} {mode}: step graphs {got} replays {cs['graph_replays']}, want "
                 f"{want} and {replays} replays of {steps} steps")
        print(f"serve {self.tag} {mode} step graph captures={got[GRAPH_KEY[mode]]} "
              f"replays={cs['graph_replays']} of {steps} steps", flush=True)

    def _against_eager(self, mode, reqs, got, routes, eng) -> None:
        """The same run with ``step_graphs=False``: the same tokens for all
        12 requests, the same launch and route counts."""
        name = f"{self.tag} {mode}"
        eager = self.engine(mode, step_graphs=False)
        reqs_e = self.requests()
        got_e, routes_e = _drive(f"{name} eager", eager, reqs_e, self.device, self.cfg.n_layers)
        diff = [i for i, (a, b) in enumerate(zip(reqs, reqs_e)) if a.out != b.out]
        if diff:
            fail(f"{name}: graph-run tokens != eager-run tokens for requests {diff}")
        if got_e != got or routes_e != routes:
            fail(f"{name}: graph run launches {got} routes {routes} != eager run launches "
                 f"{got_e} routes {routes_e}")
        print(f"serve {name} graph == eager: tokens equal ({len(reqs)} requests), launches and "
              f"routes equal", flush=True)
        times = self.step_times.get(mode)
        if times is None:
            return
        ms_e, ms_g = _step_ms(eager, mode), _step_ms(eng, mode)
        dev_g = times["graph_kernel_ms"] or times["replay_events_ms"]
        times.update(host_step_ms_eager=ms_e, host_step_ms_graph=ms_g,
                     busy_share_eager=times["eager_kernel_ms"] / ms_e, busy_share_graph=dev_g / ms_g)
        t = times
        print(f"serve {name} step eager vs graph: host_step_ms eager={ms_e:.3f} graph={ms_g:.3f} "
              f"({ms_e / ms_g:.2f}x); device_ms_per_step (profiler kernel sum) eager="
              f"{t['eager_kernel_ms']:.3f} graph={t['graph_kernel_ms']:.3f}, of it hand-written "
              f"kernels eager={t['eager_handwritten_ms']:.3f} graph={t['graph_handwritten_ms']:.3f}; "
              f"device launches a step eager={t['eager_launches']:.0f} "
              f"graph={t['graph_launches']:.0f}; replay (CUDA events) ms={t['replay_events_ms']:.3f} "
              f"enqueue host ms={t['replay_host_ms']:.3f}; busy_share eager="
              f"{t['busy_share_eager']:.3f} graph={t['busy_share_graph']:.3f} (graph from "
              f"{'profiler' if t['graph_kernel_ms'] else 'events'})", flush=True)

    def serve(self, mode, against_eager: bool = False) -> list:
        """Serve the 12 requests in ``mode`` and check the run; with
        ``against_eager`` also check one graph step against the eager step
        and the whole run against an eager run."""
        L, cuda = self.cfg.n_layers, self.device.type == "cuda"
        name = f"{self.tag} {mode}"
        reqs = self.requests()
        eng = self.engine(mode)
        kept = {}
        if against_eager and self.graphs:
            timed = (self.tag, mode) in STEP_TIMED
            _after_step(eng, CHECK_STEP, lambda: kept.update(_step_check(name, eng, timed)))
        got, routes = _drive(name, eng, reqs, self.device, L)
        if kept:  # timed once the run is over, so its TTFT and wall clock are its own
            self.step_times[mode] = _step_times(eng, kept)
            del kept
        self._linears(mode, eng, got, routes)
        self._graph(mode, eng)
        if mode != "bucketed":
            self._attention(mode, eng, got, routes)
            eng.check_page_invariants()
        if against_eager and self.graphs:
            self._against_eager(mode, reqs, got, routes, eng)
        if mode == "paged":
            print(f"serve {name} memory {json.dumps(eng.memory(), sort_keys=True)} prefix_hits="
                  f"{eng.stats['prefix_hits']} prefix_hit_tokens={eng.stats['prefix_hit_tokens']}",
                  flush=True)
        if mode == "spec":
            diff = [i for i, (a, b) in enumerate(zip(reqs, self.outs["paged"])) if a.out != b.out]
            if diff:
                fail(f"{name}: speculative tokens != paged tokens for requests {diff}")
            tp = eng.throughput()
            print(f"serve {name} spec == paged tokens: equal ({len(reqs)} requests) "
                  f"acceptance_rate={tp['acceptance_rate']:.4f} "
                  f"tokens_per_step={tp['tokens_per_step']:.4f} "
                  f"spec_launches={eng.stats['spec_launches']}", flush=True)
        self.outs[mode] = reqs
        del eng
        if mode == "spec":
            return reqs
        # solo == interleaved greedy tokens. Ragged: the 1024-token prompt
        # (chunked differently alone and interleaved) and the 3-token one;
        # the kernels give a row the same bits however it is batched, while
        # the plain attention (a CPU rehearsal) keeps the reference's
        # multi-chunk f32 reassociation, so there only the short one is held.
        held = ((len(self.prompts) - 1, 0) if cuda else (0,)) if mode == "ragged" else (5,)
        solo_eng = self.engine(mode)
        for i in held:
            solo = self.request(i)
            solo_eng.serve([solo])
            if solo.out != reqs[i].out:
                fail(f"{name}: solo vs interleaved greedy tokens differ for the "
                     f"{len(self.prompts[i])}-token prompt")
        print(f"serve {name} solo == interleaved: equal (prompts of "
              f"{[len(self.prompts[i]) for i in held]} tokens)", flush=True)
        return reqs

    def sanitized(self, mode) -> None:
        """The 12 requests once more in ``mode``, submitted so that every
        prefill bucket is among the first 8, under the port's sanitizers:
        the allocator audit and the lifecycle audit after every step, and
        from the third step on (after the warm-up and the capture)
        ``guarded_decode`` (any host sync outside a ``# sync-point`` raises)
        and ``no_recompiles``; then ``assert_compile_budget``."""
        from repro_torch.analysis.sanitizers import (
            assert_compile_budget,
            guarded_decode,
            lifecycle_checks,
            no_recompiles,
            page_invariant_checks,
        )

        name = f"{self.tag} {mode}"
        eng = self.engine(mode)
        reqs = self.requests()
        with page_invariant_checks(eng), lifecycle_checks(eng):
            for i in _submit_order(self.prompts, eng.batch, self.max_len):
                eng.submit(reqs[i])
            eng.step()
            eng.step()
            with guarded_decode(), no_recompiles(eng):
                eng.run_until_done()
        cs = assert_compile_budget(eng)
        bad = [(r.request_id, r.status) for r in reqs if r.status != "DONE"]
        if bad or any(len(r.out) != r.max_new for r in reqs):
            fail(f"{name} sanitized: requests not DONE or short: {bad}")
        same = [a.out == b.out for a, b in zip(reqs, self.outs[mode])]
        print(f"serve {name} sanitized (guarded_decode, no_recompiles, page_invariant_checks, "
              f"lifecycle_checks, assert_compile_budget): ok, steps={eng.stats['decode_steps']} "
              f"compile_stats={json.dumps(cs)} tokens == the first run's: {sum(same)} of "
              f"{len(reqs)} requests (not gated)", flush=True)


# ---------------------------------------------------------------------------
# phase 4b: the request lifecycle on the W4A4 packs (preemption, cancel,
# deadlines, injected faults, the seeded traffic harness)
# ---------------------------------------------------------------------------

LIFE_SLOTS = 4
LIFE_MAX_LEN = 128  # the workload's longest timeline is 60 prompt + 16 new tokens
# fewer pages than 4 slots x the 5 pages a chat or summarize request
# reserves (page 16), so admission has to preempt
LIFE_PAGES = 10
LIFE_MODES = {"paged": {}, "ragged": dict(ragged=True, token_budget=64),
              "spec": dict(speculation=True, spec_k=4)}
# A run with preemption is compared with the same requests served by an
# engine whose pool never preempts, token by token up to a request's first
# differing token: rows torch.equal, else their relative L2 error against
# RESUME_REL_MAX (the bf16 ragged-vs-prefill bound, RAGGED_BF16_REL_MAX) and
# whether a differing token came where the uninterrupted row's top-2 margin
# is within RESUME_REL_MAX of its largest |logit|. Gated on the card in the
# modes of RESUME_EQUAL (rows torch.equal); elsewhere printed, since a
# resumed W4A4 request re-prefills rows that decode steps first wrote, and
# 4-bit activations carry that rounding difference far (W4A4 ragged-vs-
# prefill logits read 0.27-0.51 on the card, PERF.md). Every mode is gated
# on the copy-free restore itself (_RestoreCheck).
RESUME_REL_MAX = 0.025
RESUME_EQUAL = frozenset({"ragged"})
# the kernels this phase's runs launch (w4a16_gemm serves the W4A16 model)
LIFE_KERNELS = ("dual_gemv", "dual_gemv_group", "dual_gemm", "dual_gemm_group",
                "paged_decode_kernel", "ragged_attention_kernel")
FORCED_LAYERS = 2  # the plain dual GEMV takes ~24 ms a call on the card


def _counts() -> tuple[dict, dict]:
    """(launch counts, route counts) now."""
    from repro_torch.kernels import cuda_launch, dispatch

    return cuda_launch.launch_counts(), dispatch.dispatch_counters()


def _since(before: tuple[dict, dict]) -> tuple[dict, dict]:
    """The launches and routes added since ``before`` (a ``_counts()``)."""
    from repro_torch.launch.step_graph import _minus

    return tuple(_minus(a, b) for a, b in zip(_counts(), before))


def _life_engine(cfg, qp, device, mode: str, **kw):
    from repro_torch.launch.serve import ContinuousBatchingEngine

    return ContinuousBatchingEngine(cfg, qp, batch_slots=LIFE_SLOTS, max_len=LIFE_MAX_LEN,
                                    device=device, paged=True, page_size=16,
                                    **{**LIFE_MODES[mode], **kw})


def _life_workload(cfg):
    """The reference's default traffic mix (chat behind a 3-page shared
    prompt, summarize, bursts of 3 at top priority), 12 draws from seed 0;
    request ids name the items."""
    from repro_torch.launch.workload import default_scenarios, make_workload

    wl = make_workload(0, n_requests=12, mean_gap_steps=4,
                       scenarios=default_scenarios(page_size=16), vocab=cfg.vocab)
    for k, it in enumerate(wl.items):
        it.request.request_id = f"w{k}"
    return wl


class _TokenLogits:
    """The logits row behind every token an engine emits (host f32, the
    vocab's columns), per request id: the held row for a sampled token, and
    in a verify step the row each accepted draft (or the capped slot's last
    token) was checked against. Wraps ``_emit_token``, ``step`` and the
    logits tap, all on the host; ``close()`` takes them off."""

    def __init__(self, eng, vocab: int):
        import numpy as np

        from repro_torch.models import common as C

        self.rows: dict = {}
        self._eng, self._verify, self._taken = eng, None, {}
        self._emit, self._step = eng._emit_token, eng.step

        def tap(last, tag):
            if last.ndim == 3:  # the (B, spec_k, V) verify download
                self._verify, self._taken = last, {}
            return last

        def emit(req, tok):
            row = req._last_logits
            if self._verify is not None:
                i = next(i for i, s in enumerate(eng.slots) if s is req)
                j = self._taken.get(i, 0)
                self._taken[i] = j + 1
                row = self._verify[i, j]
            self.rows.setdefault(req.request_id, []).append(np.array(row[:vocab], np.float32))
            self._emit(req, tok)

        def step():
            self._verify = None
            return self._step()

        self._prev_tap = C.set_logits_tap(tap)
        eng._emit_token, eng.step = emit, step

    def close(self) -> None:
        from repro_torch.models import common as C

        C.set_logits_tap(self._prev_tap)
        self._eng._emit_token, self._eng.step = self._emit, self._step


class _RestoreCheck:
    """The copy-free restore of every resumed request, checked exactly: the
    victim's whole committed pages are saved when it is preempted, and when
    its readmission maps pages from the prefix cache, each restored page
    must be the one the cache holds under the request's own tokens at that
    position (the key chain, walked here without touching the cache's LRU
    ticks), and a page that is still the victim's own page at that position
    must hold, ``torch.equal``, the keys and values it held at preemption.
    Wraps the engine's ``_preempt`` and ``_reserve``."""

    def __init__(self, eng):
        import torch

        from repro_torch.launch.step_graph import sync_point

        self.saved: dict = {}  # request id -> [(page, {pool key: rows})] by position
        self.restores = 0  # readmissions that mapped restored pages
        self.compared = 0  # restored pages compared with their saved rows
        self.bad: list = []
        self.resumed: dict = {}  # request id -> (tokens out, effective prompt) at readmission
        preempt, reserve, pc = eng._preempt, eng._reserve, eng.prefix_cache

        def on_preempt(i, req):
            n = eng._committed_rows(i, req) // eng.page_size
            self.saved[req.request_id] = [
                (int(p), {k: eng.state[k][:, int(p)].clone() for k in eng._pool_keys})
                for p in eng._bt[i][:n]]
            return preempt(i, req)

        def chain(prompt) -> list:
            pages, parent = [], 0
            for j in range((len(prompt) - 1) // pc.page_size):
                e = pc.entries.get(pc._key(parent, prompt, j))
                if e is None:
                    break
                pages.append(e.page)
                parent = e.eid
            return pages

        def on_reserve(req, prompt, bucket_prefix):
            res = reserve(req, prompt, bucket_prefix)
            if res is not None and req._preemptions:
                self.resumed[req.request_id] = (len(req.out), prompt.copy())
            if res is None or not req._preemptions or not res[1]:
                return res
            shared = res[1]
            self.restores += 1
            if chain(prompt)[:len(shared)] != shared:
                self.bad.append((req.request_id, "pages", shared, chain(prompt)))
            for j, p in enumerate(shared):
                saved = self.saved.get(req.request_id, [])
                if j < len(saved) and saved[j][0] == p:
                    self.compared += 1
                    with sync_point(eng.device):
                        same = all(torch.equal(eng.state[k][:, p], v)  # sync-point: the check
                                   for k, v in saved[j][1].items())
                    if not same:
                        self.bad.append((req.request_id, "rows", j, p))
            return res

        eng._preempt, eng._reserve = on_preempt, on_reserve


def _life_replay(name: str, eng, wl, card: str, *, tight: bool) -> dict:
    """Replay ``wl`` through ``eng`` under ``lifecycle_checks`` and
    ``page_invariant_checks`` (every step), from the third step on (after
    the warm-up and the capture) ``guarded_decode`` and, ragged,
    ``no_recompiles``; then ``assert_compile_budget``. Checks every request
    terminal, ``on_token`` once per emitted token, no page held past the
    prefix cache's registrations, one capture per engine, no plain-version
    route, and (``tight``) that preemption and prefix hits happened, or
    (not ``tight``) that nothing was preempted. Returns the run."""
    import contextlib

    from repro_torch.analysis.sanitizers import (
        assert_compile_budget,
        guarded_decode,
        lifecycle_checks,
        no_recompiles,
        page_invariant_checks,
    )
    from repro_torch.launch.serve import RequestState
    from repro_torch.launch.workload import replay

    restore = _RestoreCheck(eng) if tight else None
    fired: dict = {}
    for it in wl.items:
        it.request.on_token = lambda r, t: fired.setdefault(r.request_id, []).append(t)
    rec = _TokenLogits(eng, eng.cfg.vocab)
    steady = contextlib.ExitStack()
    step, n = eng.step, [0]

    def steady_step():
        n[0] += 1
        if n[0] == 3:
            steady.enter_context(guarded_decode())
            if eng.ragged:
                steady.enter_context(no_recompiles(eng))
        return step()

    eng.step = steady_step
    before = _counts()
    t0 = time.perf_counter()
    try:
        with lifecycle_checks(eng), page_invariant_checks(eng), steady:
            reqs = replay(eng, wl)
    finally:
        eng.step = step
        rec.close()
    wall = time.perf_counter() - t0
    launches, routes = _since(before)
    cs = assert_compile_budget(eng)
    st = eng.stats
    if any(r.status not in RequestState.TERMINAL for r in reqs):
        fail(f"{name}: requests not terminal: {[(r.request_id, r.status) for r in reqs]}")
    twice = [r.request_id for r in reqs if fired.get(r.request_id, []) != r.out]
    if twice:
        fail(f"{name}: on_token did not fire once per emitted token for {twice}")
    held = eng.allocator.n_used - len(eng.prefix_cache)
    if held:
        fail(f"{name}: {held} pages held past the prefix cache's registrations")
    if any("/ref" in k for k in routes):
        fail(f"{name}: plain-version routes taken: {routes}")
    cuda = eng.device.type == "cuda"
    graphs = cs["ragged_graphs" if eng.ragged else "spec_graphs" if eng.speculation
                else "decode_graphs"]
    if cuda and (graphs != 1 or cs["graph_replays"] != eng.step_graph.steps - 1):
        fail(f"{name}: step graph captures {graphs}, replays {cs['graph_replays']} of "
             f"{eng.step_graph.steps} steps; want one capture")
    if tight and not (st["requests_preempted"] >= 1 and st["prefix_hits"] >= 1):
        fail(f"{name}: preempted {st['requests_preempted']}, prefix hits "
             f"{st['prefix_hits']}: the tight pool must preempt and hit")
    if not tight and st["requests_preempted"]:
        fail(f"{name}: the uninterrupted run preempted {st['requests_preempted']} times")
    status = {}
    for r in reqs:
        status[r.status] = status.get(r.status, 0) + 1
    lat = eng.latency()
    pct = {k: {q: round(lat[k][q], 3) for q in ("p50", "p95", "p99")}
           for k in ("ttft_ms", "tpot_ms", "e2e_ms")}
    print(f"lifecycle {name} requests={len(reqs)} {json.dumps(status)} "
          f"preempted={st['requests_preempted']} "
          f"(requests {sum(r._preemptions > 0 for r in reqs)}) prefix_hits={st['prefix_hits']}/"
          f"{st['prefix_lookups']} steps={eng._steps} wall_s={wall:.3f} pages={eng.n_pages} "
          f"graph captures={graphs} replays={cs['graph_replays']} routes_ref=0 on_token once "
          f"per token, no page held past {len(eng.prefix_cache)} registrations; sanitizers "
          f"(lifecycle_checks, page_invariant_checks, guarded_decode from step 3"
          f"{', no_recompiles' if eng.ragged else ''}, assert_compile_budget) ok", flush=True)
    print(f"lifecycle {name} latency {json.dumps(pct)} goodput_tok_s="
          f"{lat['goodput_tok_s']:.2f} preemption_rate={lat['preemption_rate']:.4f} "
          f"prefix_hit_rate={lat['prefix_hit_rate']:.4f} queue_depth_max="
          f"{lat['queue_depth_max']} (host clock; card {card})", flush=True)
    return {"reqs": reqs, "rows": rec.rows, "restore": restore, "eng": eng}


def _against_uninterrupted(got: dict, want: dict) -> dict:
    """Each DONE, untruncated request of a run with preemption against the
    same request in a run without (``RESUME_REL_MAX`` above), over the
    token rows both runs emitted, up to the request's first differing
    token."""
    import numpy as np

    out = {"requests": 0, "preempted": 0, "rows": 0, "equal_rows": 0, "within": 0,
           "max_rel": 0.0, "preempted_max_rel": 0.0, "parted": []}
    ref = {r.request_id: r for r in want["reqs"]}
    for r in got["reqs"]:
        w = ref[r.request_id]
        if r.status != "DONE" or r.truncated or w.status != "DONE" or w.truncated:
            continue
        out["requests"] += 1
        out["preempted"] += r._preemptions > 0
        for t, (a, b) in enumerate(zip(got["rows"][r.request_id], want["rows"][w.request_id])):
            out["rows"] += 1
            rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
            out["equal_rows"] += bool(np.array_equal(a, b))
            out["within"] += rel <= RESUME_REL_MAX
            out["max_rel"] = max(out["max_rel"], rel)
            if r._preemptions:
                out["preempted_max_rel"] = max(out["preempted_max_rel"], rel)
            if r.out[t] != w.out[t]:
                top = np.sort(b)[-2:]
                margin = float(top[1] - top[0]) / float(np.abs(b).max())
                out["parted"].append((r.request_id, t, round(margin, 5),
                                      "within" if margin <= RESUME_REL_MAX else "over"))
                break
    out["equal"] = out["equal_rows"] == out["rows"]
    return out


def _swap_restored_page(eng) -> list:
    """Plant a fault in a run with preemption: at the first admission of a
    preempted request whose prefix match restores pages, the first restored
    page is swapped for another cached page (another prompt's keys and
    values). Returns the log of swaps (empty until one was admitted)."""
    pc, done, trial = eng.prefix_cache, [], []
    match, admit = pc.match, eng._admit_one
    resuming = [False]

    def swapped(prompt):
        m, pages = match(prompt)
        others = [e.page for e in pc.entries.values() if e.page not in pages]
        if resuming[0] and pages and others and not done:
            trial.append((pages[0], others[0]))
            pages = [others[0]] + pages[1:]
        return m, pages

    def admit_one(req, i):
        resuming[0] = req._preemptions > 0
        try:
            ok = admit(req, i)
        finally:
            resuming[0] = False
        if ok and trial:  # an admission that waited for pages swaps again next time
            done.append(trial[-1])
        trial.clear()
        return ok

    pc.match, eng._admit_one = swapped, admit_one
    return done


def _resume_control(got: dict, want: dict) -> list:
    """Where a resumed request's first token after its last readmission
    follows the same tokens in both runs: that row (a prefill over the
    restored pages), the uninterrupted run's row (a decode step) and a
    fresh bucketed prefill of the same effective prompt, by relative L2
    error, [(request, token, resumed vs fresh, uninterrupted vs fresh,
    resumed vs uninterrupted)]. Run after the replay; not gated."""
    import numpy as np

    def rel(a, b):
        return round(float(np.linalg.norm(a - b) / np.linalg.norm(b)), 5)

    eng, ref = got["eng"], {r.request_id: r for r in want["reqs"]}
    out = []
    for r in got["reqs"]:
        if r.request_id not in got["restore"].resumed:
            continue
        t, eff = got["restore"].resumed[r.request_id]
        w = ref[r.request_id]
        if r.status != "DONE" or t >= len(w.out) or r.out[:t] != w.out[:t]:
            continue
        fresh = eng._run_prefill(eff)[0][:eng.cfg.vocab]
        a, b = got["rows"][r.request_id][t], want["rows"][r.request_id][t]
        out.append((r.request_id, t, rel(a, fresh), rel(b, fresh), rel(a, b)))
    return out


def _resume_line(mode: str, g: dict, restore) -> str:
    return (f"lifecycle {mode} resume: restored pages exact ({restore.restores} readmissions "
            f"restored pages, {restore.compared} pages torch.equal to their rows at "
            f"preemption); vs uninterrupted: {'equal' if g['equal'] else 'not equal'} "
            f"({g['equal_rows']} of {g['rows']} token rows torch.equal, {g['within']} within rel "
            f"{RESUME_REL_MAX}; {g['requests']} DONE requests, {g['preempted']} of them "
            f"preempted; max_rel {g['max_rel']:.5f}, over preempted requests "
            f"{g['preempted_max_rel']:.5f}); tokens parted at {g['parted']} (request, token, "
            f"top-2 margin / max |logit|)")


def _life_faults(cfg, qp, device, wl) -> None:
    """Host-side faults on a 4-slot paged engine (pool big enough not to
    preempt), each confined to its own request: NaN logits in one slot
    mid-decode, a tampered pack, allocation denials, cancels (live and
    queued) and a step deadline; then the plain versions forced at
    ``FORCED_LAYERS`` layers, and the kernels again after ``restore()``."""
    from repro_torch.analysis.sanitizers import lifecycle_checks, page_invariant_checks
    from repro_torch.launch.faults import FaultInjector
    from repro_torch.launch.serve import Request

    def reqs(ks, **kw):
        return [Request(wl.items[k].request.prompt, max_new=8, request_id=f"f{k}", **kw)
                for k in ks]

    def run(eng, rs, fn=None):
        with lifecycle_checks(eng), page_invariant_checks(eng):
            for r in rs:
                eng.submit(r)
            if fn is not None:
                fn(eng, rs)
            eng.run_until_done()
        held = eng.allocator.n_used - len(eng.prefix_cache)
        if held:
            fail(f"faults: {held} pages held past the prefix cache's registrations")
        return rs

    clean = run(_life_engine(cfg, qp, device, "paged"), reqs(range(4)))
    if any(r.status != "DONE" for r in clean):
        fail(f"faults: clean run not DONE: {[r.status for r in clean]}")
    want = {r.request_id: r.out for r in clean}

    def same(rs):
        return [r.request_id for r in rs if r.status == "DONE" and r.out != want[r.request_id]]

    with FaultInjector(seed=0) as fi:
        fi.corrupt_logits(slot=1, at_call=3, tag="decode")
        got = run(_life_engine(cfg, qp, device, "paged"), reqs(range(4)))
    bad = [(r.request_id, r.status, r.error) for r in got if r.status != "DONE"]
    victim = got[1]
    if (bad != [(victim.request_id, "FAILED", "nan_logits")] or same(got)
            or victim.out != want[victim.request_id][:len(victim.out)]):
        fail(f"faults: corrupt_logits not confined to slot 1: {bad}, others differ {same(got)}")
    print(f"lifecycle faults corrupt_logits (slot 1, 3rd decode download): {victim.request_id} "
          f"FAILED nan_logits after {len(victim.out)} tokens; the other 3 requests' tokens "
          f"equal the clean run's", flush=True)

    fi = FaultInjector(seed=0)
    bad_params = fi.tamper_pack(qp)
    got = run(_life_engine(cfg, bad_params, device, "paged"), reqs([0]))[0]
    if got.status != "FAILED" or got.error != "prefill_exception" \
            or "ContractError" not in (got.error_detail or ""):
        fail(f"faults: tampered pack gave {got.status} {got.error} {got.error_detail}")
    print(f"lifecycle faults tamper_pack ({fi.log[-1]['path']} rp {fi.log[-1]['rp_shape']}): "
          f"FAILED prefill_exception, {got.error_detail.splitlines()[0][:100]}", flush=True)
    del bad_params

    with FaultInjector(seed=0) as fi:
        eng = _life_engine(cfg, qp, device, "paged")
        fi.deny_alloc(eng, at_call=2, count=3)
        got = run(eng, reqs(range(4)))
    denied = sum(d["kind"] == "deny_alloc" for d in fi.log)
    if not denied or any(r.status != "DONE" for r in got) or same(got):
        fail(f"faults: deny_alloc ({denied} denials): {[r.status for r in got]}, "
             f"differ {same(got)}")
    print(f"lifecycle faults deny_alloc: {denied} denials, every request DONE with the clean "
          f"run's tokens", flush=True)

    rs = reqs(range(6))
    rs[2].deadline_steps = 3

    def cancel(eng, rs):
        eng.step()
        eng.step()
        if not (eng.cancel(rs[1]) and eng.cancel(rs[5].request_id)):
            fail("faults: cancel of a live and a queued request returned False")

    got = run(_life_engine(cfg, qp, device, "paged"), rs, cancel)
    want_status = ["DONE", "CANCELLED", "TIMED_OUT", "DONE", "DONE", "CANCELLED"]
    if [r.status for r in got] != want_status or got[2].error != "deadline_steps" \
            or got[5].out or same(got[:4]):
        fail(f"faults: cancel/deadline statuses {[(r.status, r.error) for r in got]}")
    print(f"lifecycle faults cancel/deadline: live {got[1].request_id} CANCELLED after "
          f"{len(got[1].out)} tokens, queued {got[5].request_id} CANCELLED, {got[2].request_id} "
          f"TIMED_OUT (deadline_steps 3) after {len(got[2].out)} tokens, pages back, survivors "
          f"equal the clean run's", flush=True)

    # the degraded mode serves eager steps: the plain paged decode writes the
    # draft rows through a boolean mask, which a graph capture refuses
    small, scfg = _first_layers(qp, FORCED_LAYERS), cfg.replace(n_layers=FORCED_LAYERS)
    with FaultInjector(seed=0) as fi:
        fi.force_ref_dispatch()
        before = _counts()
        forced = run(_life_engine(scfg, small, device, "paged", step_graphs=False),
                     reqs(range(2)))
        launches, routes = _since(before)
    if launches or not routes or not all(k.endswith(("/ref", "/ref[forced]")) for k in routes):
        fail(f"faults: forced run launched {launches}, routes {routes}")
    before = _counts()
    after = run(_life_engine(scfg, small, device, "paged"), reqs(range(2)))
    launches2, routes2 = _since(before)
    if any("/ref" in k for k in routes2) or (device.type == "cuda" and not launches2):
        fail(f"faults: after restore() routes {routes2}, launches {launches2}")
    print(f"lifecycle faults force_ref_dispatch ({FORCED_LAYERS} layers, eager steps): routes "
          f"{json.dumps(routes, sort_keys=True)}, no kernel launched; after restore() routes "
          f"{json.dumps(routes2, sort_keys=True)}; tokens equal: "
          f"{[a.out == b.out for a, b in zip(forced, after)]} (not gated)", flush=True)


def lifecycle_phase(device, card: str, cfg, qp) -> None:
    """The request lifecycle on ``qp`` (``cfg``'s W4A4 packs): the seeded
    workload replayed with preemption in the paged, ragged and speculative
    modes and without it (a pool that never runs short), each held by
    ``_life_replay``; per mode the copy-free restore (``_RestoreCheck``,
    which a planted swapped page must fail) and the comparison with the
    uninterrupted run (``_against_uninterrupted``, gated in
    ``RESUME_EQUAL`` on the card); then ``_life_faults``. Fails unless every
    kernel of ``LIFE_KERNELS`` launched in the phase."""
    from repro_torch.kernels import cuda_launch, dispatch

    cuda_launch.reset_launch_counts()
    dispatch.reset_dispatch_counters()
    for mode in LIFE_MODES:
        want = _life_replay(f"{mode} uninterrupted", _life_engine(cfg, qp, device, mode),
                            _life_workload(cfg), card, tight=False)
        got = _life_replay(f"{mode} preempting",
                           _life_engine(cfg, qp, device, mode, n_pages=LIFE_PAGES,
                                        preemption=True),
                           _life_workload(cfg), card, tight=True)
        g, restore = _against_uninterrupted(got, want), got["restore"]
        print(_resume_line(mode, g, restore), flush=True)
        if not got["eng"].ragged:
            print(f"lifecycle {mode} resume control (request, token, rel: resumed vs a fresh "
                  f"prefill of its timeline, uninterrupted decode vs that prefill, resumed vs "
                  f"uninterrupted): {_resume_control(got, want)}", flush=True)
        # a verify step's acceptance follows the tokens, so the speculative
        # schedule (and whether a resume restores pages) may differ by device
        if restore.bad or (mode != "spec" and not restore.compared):
            fail(f"{mode}: copy-free restore: {restore.bad[:3]}, {restore.compared} restored "
                 f"pages compared in {restore.restores} readmissions")
        if device.type == "cuda" and mode in RESUME_EQUAL and not g["equal"]:
            fail(f"{mode}: rows of the run with preemption != the uninterrupted run's: "
                 f"{g['rows'] - g['equal_rows']} of {g['rows']} differ, tokens parted at "
                 f"{g['parted']}")
        if mode == "paged":
            eng = _life_engine(cfg, qp, device, mode, n_pages=LIFE_PAGES, preemption=True)
            swaps = _swap_restored_page(eng)
            planted = _life_replay("paged planted fault", eng, _life_workload(cfg), card,
                                   tight=True)
            caught = planted["restore"].bad
            if not swaps or not caught:
                fail(f"planted fault (restored page swapped: {swaps}) not caught by the restore "
                     f"check")
            pg = _against_uninterrupted(planted, want)
            print(f"lifecycle paged planted fault (restored page {swaps[0][0]} swapped for "
                  f"{swaps[0][1]}): caught {caught[:2]}; vs uninterrupted max_rel over preempted "
                  f"requests {pg['preempted_max_rel']:.5f}, tokens parted at {pg['parted']}",
                  flush=True)
        del want, got
    _life_faults(cfg, qp, device, _life_workload(cfg))
    launches = cuda_launch.launch_counts()
    missing = [k for k in LIFE_KERNELS if not launches.get(k)]
    if device.type == "cuda" and missing:
        fail(f"lifecycle: kernels never launched in the phase: {missing}")
    print(f"lifecycle launches {json.dumps({k: launches.get(k, 0) for k in LIFE_KERNELS})}",
          flush=True)


def serve_phase(device, card: str, cfg, prompt_lens=PROMPT_LENS, max_len: int = 2048,
                rank: int = 128, spec_probe: int = 0, secs: dict | None = None) -> dict:
    """Serve ``cfg`` (random weights, seed 0) through the engine: W4A4
    (quantized once) and W4A16 in the bucketed, paged, speculative and
    ragged modes, W4A8 (the W4A4 packs at a_bits 8) paged; check each;
    between W4A4 and W4A8 the lifecycle phase on the W4A4 packs (its
    seconds into ``secs["lifecycle"]``); returns each kernel's launch count
    from the run whose main path it is.
    ``spec_probe`` > 0 repeats the W4A4 paged run and every speculative
    variant (``SPEC_VARIANTS``) that many times. Runs on the CPU too (plain
    versions), which is how it is rehearsed off the card."""
    import numpy as np

    from repro_torch.configs import QuantSpec
    from repro_torch.core.twinquant import fuse_params, quantize_params, with_activation_bits
    from repro_torch.models import dense

    print(f"serve config {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} "
          f"head_dim={cfg.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab} n_layers={cfg.n_layers} "
          f"card=\"{card}\"", flush=True)
    t0 = time.perf_counter()
    params = dense.init_params(cfg, seed=0, device=device)
    _sync(device)
    t1 = time.perf_counter()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in prompt_lens]
    depths = [k for k in DEPTHS if k < cfg.n_layers] + [cfg.n_layers]
    bf16_rows = _ragged_vs_prefill(params, cfg, prompts[5], device, depths)
    print(f"serve bf16 model: ragged step vs bucketed prefill logits ({len(prompts[5])}-token "
          f"prompt) {_depth_line(bf16_rows)} (limit at full depth: ragged rel <= "
          f"{RAGGED_BF16_REL_MAX})", flush=True)
    if not bf16_rows[-1][1] <= RAGGED_BF16_REL_MAX:
        fail(f"bf16 model: ragged step vs bucketed prefill logits rel {bf16_rows[-1][1]} "
             f"(limit {RAGGED_BF16_REL_MAX})")
    t2 = time.perf_counter()
    qp16 = quantize_params(params, cfg, QuantSpec("w4a16"))
    _sync(device)
    t3 = time.perf_counter()
    qp = fuse_params(quantize_params(params, cfg, QuantSpec("w4a4", rank=rank, group_size=128)))
    _sync(device)
    t4 = time.perf_counter()
    del params
    print(f"serve init_s={t1 - t0:.2f} w4a16_quantize_s={t3 - t2:.2f} "
          f"w4a4_quantize_fuse_s={t4 - t3:.2f}", flush=True)

    # -- W4A4: the four modes, the speculative probe, the ragged logits sweep
    w4 = Served("w4a4", cfg, qp, "w4a4", prompts, device, max_len)
    w4.prefill_logits()
    for mode in ("bucketed", "paged", "spec"):
        w4.serve(mode, against_eager=True)
    paged = w4.outs["paged"]
    for rep in range(max(spec_probe, 1)):
        if spec_probe:
            again = w4.requests()
            _drive("w4a4 paged again", w4.engine("paged"), again, device, cfg.n_layers)
            print(f"serve spec probe rep={rep} paged again == paged: "
                  f"{all(a.out == b.out for a, b in zip(again, paged))}", flush=True)
        for variant in SPEC_VARIANTS if spec_probe else ("stacked",):
            _spec_run(variant, w4.engine("spec"), w4.requests(), paged, cfg, device)
    ragged = w4.serve("ragged", against_eager=True)
    w4.sanitized("ragged")
    agree = sum(a == b for r, q in zip(ragged, paged) for a, b in zip(r.out, q.out))
    w4a4_rows = _ragged_vs_prefill(qp, cfg, prompts[5], device, depths)
    print(f"serve w4a4 ragged tokens agreeing with paged: {agree} of {32 * len(ragged)}, first "
          f"tokens {sum(r.out[0] == q.out[0] for r, q in zip(ragged, paged))} of {len(ragged)}; "
          f"W4A4 model: ragged step vs bucketed prefill logits ({len(prompts[5])}-token "
          f"prompt) {_depth_line(w4a4_rows)} (not gated) "
          f"ttft_1024_s={ragged[-1].t_first_token - ragged[-1].t_submit:.4f}", flush=True)
    launches = dict(w4.launches)
    w4_times = dict(w4.step_times)

    # -- the request lifecycle on the same packs
    t_life = time.perf_counter()
    lifecycle_phase(device, card, cfg, qp)
    life_s = time.perf_counter() - t_life
    if secs is not None:
        secs["lifecycle"] = life_s

    # -- W4A8: the same packs at a_bits 8, paged
    t5 = time.perf_counter()
    w8 = Served("w4a8", cfg, with_activation_bits(qp, 8), "w4a8", prompts, device, max_len)
    w8.prefill_logits()
    w8.serve("paged")
    del w8, w4, qp
    t6 = time.perf_counter()

    # -- W4A16: the four modes
    w16 = Served("w4a16", cfg, qp16, "w4a16", prompts, device, max_len)
    w16.prefill_logits()
    for mode in MODES:
        w16.serve(mode, against_eager=True)
    w16.sanitized("paged")
    launches["w4a16_gemm"] = w16.launches["w4a16_gemm"]
    for tag, served in (("w4a4", w4_times), ("w4a16", w16.step_times)):
        for mode, times in served.items():
            print(f"serve step times {json.dumps({'setting': tag, 'mode': mode, **times})}",
                  flush=True)
    t7 = time.perf_counter()
    print(f"serve phase seconds: w4a4 {t5 - t4 - life_s:.1f} lifecycle {life_s:.1f} "
          f"w4a8 {t6 - t5:.1f} w4a16 {t7 - t6:.1f}", flush=True)
    return launches


def ragged_serve_phase(device, card: str, cfg, prompt_lens=PROMPT_LENS, max_len: int = 2048,
                       rank: int = 128) -> None:
    """``cfg`` served in ragged mode alone, W4A16 then W4A4 (the serve
    phase's runs and checks), so that two trees' ragged steps can be timed
    in one call (``--ragged-serve``, with ``--src`` for the other tree)."""
    import numpy as np

    from repro_torch.configs import QuantSpec
    from repro_torch.core.twinquant import fuse_params, quantize_params
    from repro_torch.models import dense

    print(f"serve config {cfg.name} n_layers={cfg.n_layers} card=\"{card}\" src={SRC}", flush=True)
    params = dense.init_params(cfg, seed=0, device=device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in prompt_lens]
    w16 = Served("w4a16", cfg, quantize_params(params, cfg, QuantSpec("w4a16")), "w4a16",
                 prompts, device, max_len)
    w16.serve("ragged")
    _profile_ragged(w16)
    del w16
    qp = fuse_params(quantize_params(params, cfg, QuantSpec("w4a4", rank=rank, group_size=128)))
    del params
    w4 = Served("w4a4", cfg, qp, "w4a4", prompts, device, max_len)
    w4.serve("ragged")
    _profile_ragged(w4)


# kernel groups of a ragged step's device time (profiler key prefixes)
STEP_GROUPS = {"attention": ("rg_", "ragged_attention"), "linears": ("tq_", "w4a16_")}


def _profile_ragged(served) -> None:
    """The same ragged-mode run once more under ``torch.profiler``, with
    eager steps (the same kernels as the graph's, and a tree before step
    graphs runs them so too): device time per engine step of the attention
    kernel, of the quantized linears and of every kernel (the rest:
    PyTorch's own), from ``key_averages()`` (not printed off the card)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if served.device.type != "cuda":
        return
    eng, reqs = served.engine("ragged", step_graphs=False), served.requests()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.serve(reqs)
        torch.cuda.synchronize()
    steps = eng.stats["decode_steps"]
    total, groups = 0.0, dict.fromkeys(STEP_GROUPS, 0.0)
    for key, t, _ in _kernel_us(prof):
        total += t
        for g, prefixes in STEP_GROUPS.items():
            if key.startswith(prefixes):
                groups[g] += t
    per = {g: round(t / steps / 1e3, 4) for g, t in groups.items()}
    print(f"serve {served.tag} ragged profiled device ms per step: {json.dumps(per)} "
          f"all_kernels={total / steps / 1e3:.4f} steps={steps}", flush=True)


def qwen_phase(device, card: str, cfg, prompt_lens=PROMPT_LENS, max_len: int = 2048,
               rank: int = 128) -> None:
    """The paper's second model at full width and ``cfg``'s (cut) depth, in
    W4A16 and W4A4 (fused), paged, with the serve phase's checks."""
    import numpy as np

    from repro_torch.configs import QuantSpec
    from repro_torch.core.twinquant import fuse_params, quantize_params
    from repro_torch.models import dense

    t0 = time.perf_counter()
    print(f"qwen config {cfg.name} d_model={cfg.d_model} d_ff={cfg.d_ff} vocab={cfg.vocab} "
          f"padded_vocab={cfg.padded_vocab} rope_theta={cfg.rope_theta} n_layers={cfg.n_layers} "
          f"(cut from 36) card=\"{card}\"", flush=True)
    params = dense.init_params(cfg, seed=0, device=device)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in prompt_lens]
    qp16 = quantize_params(params, cfg, QuantSpec("w4a16"))
    _sync(device)
    t1 = time.perf_counter()
    w16 = Served("qwen3-8b w4a16", cfg, qp16, "w4a16", prompts, device, max_len)
    w16.prefill_logits()
    w16.serve("paged")
    del w16, qp16
    t2 = time.perf_counter()
    qp = fuse_params(quantize_params(params, cfg, QuantSpec("w4a4", rank=rank, group_size=128)))
    del params
    _sync(device)
    t3 = time.perf_counter()
    w4 = Served("qwen3-8b w4a4", cfg, qp, "w4a4", prompts, device, max_len)
    w4.prefill_logits()
    w4.serve("paged")
    del w4, qp
    t4 = time.perf_counter()
    print(f"qwen phase seconds: init+w4a16_quantize {t1 - t0:.1f} w4a16_serve {t2 - t1:.1f} "
          f"w4a4_quantize_fuse {t3 - t2:.1f} w4a4_serve {t4 - t3:.1f}", flush=True)


# ---------------------------------------------------------------------------
# calibration phase: TwinQuant's (Q, G) learned at llama3-8b's widths, the
# calibrated packs served by the dual kernels, the simulation path
# ---------------------------------------------------------------------------

CALIB_ROWS = 2048  # calibration samples (tokens) of each layer
CALIB_STEPS = (400, 400, 200)  # the paper's schedule, q-shaped layer
CALIB_STEPS_CUT = {"gate_up": (40, 40, 20), "down": (8, 8, 4)}  # ms per step is the reading
SIM_STEPS = (8, 8, 4)  # twinquant in simulate_quantize_params (the phase's budget)
SIM_LAYERS = 1  # llama3-8b's depth cut for the simulation path
CALIB_OUTLIERS = 6  # outlier input channels, as the reference test's layer
CALIB_GATES = dict(ortho=1e-3, ginv=1e-3, fold=2e-3)


def outlier_layer(gen, m: int, n: int, rows: int, device):
    """The reference test's synthetic layer (tests/test_core_calibration.py)
    at (m, n): W ~ N(0, 0.05^2) with ``CALIB_OUTLIERS`` input channels x12,
    X ~ N(0, 1) with those columns x8, times (1 + |t_3|) heavy tails (the t
    variable drawn as z / sqrt(chi2_3 / 3)). Returns (x (rows, m), w)."""
    import torch

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    w = normal(m, n) * 0.05
    idx = torch.randperm(m, generator=gen, device=device)[:CALIB_OUTLIERS]
    w[idx] *= 12.0
    x = normal(rows, m)
    x[:, idx] *= 8.0
    chi2 = sum(normal(rows, m) ** 2 for _ in range(3))
    t = normal(rows, m) / torch.sqrt(chi2 / torch.full_like(chi2, 3.0))
    return x * (1 + torch.abs(t)), w


def _calibrate(name: str, x, w, steps, device):
    """``calibrate_layer`` at rank 128, group 128, a_bits 4; prints its
    host-clock ms per step of each stage, the set-up (alpha search, SVD) and
    total seconds, and the loss."""
    from repro_torch.core.calibration import CalibConfig, calibrate_layer

    cfg = CalibConfig(rank=128, a_bits=4, group_size=128, steps_global=steps[0],
                      steps_invert=steps[1], steps_joint=steps[2])
    t0 = time.perf_counter()
    res = calibrate_layer(x, w, cfg, device=device)
    total = time.perf_counter() - t0
    ms = [1e3 * s / n if n else 0.0 for s, n in zip(res.stage_seconds, steps)]
    print(f"calib {name} K={w.shape[0]} N={w.shape[1]} rows={x.shape[0]} "
          f"steps={'/'.join(map(str, steps))} ms_per_step="
          f"{'/'.join(f'{v:.2f}' for v in ms)} setup_s={total - sum(res.stage_seconds):.2f} "
          f"total_s={total:.2f} init_loss={res.init_loss:.6g} final_loss={res.final_loss:.6g} "
          f"ratio={res.final_loss / res.init_loss:.4f}", flush=True)
    return cfg, res


def _calib_errors(name: str, x, cfg, res) -> None:
    """Phase (a)'s readings and gates: the output error of the quickstart's
    four variants, zeta and eta, Q's orthogonality, G G^-1, and the
    fold-offline identity."""
    import torch

    from repro_torch.core.calibration import layer_quant_configs
    from repro_torch.core.errors import eta_gain, total_delta, zeta_gain
    from repro_torch.core.quantization import QuantConfig, dequantize, quantize
    from repro_torch.core.transforms import hadamard_matrix, orthogonality_error

    d = res.decomp
    m = x.shape[1]
    aq, uq, vq, rq = layer_quant_configs(m, d.rank, cfg)
    x_hat = x / d.lam[None, :]
    U, V, R = d.U, d.V, d.R
    w_hat = U @ V + R
    Q, G, Gi = res.Q, res.G, res.G_inv
    U2, V2, R2 = Q.T @ U @ G, Gi @ V, Q.T @ R

    def dq(t, c):
        return dequantize(quantize(t, c))

    e_naive = float(torch.sum((dq(x_hat, aq) @ dq(w_hat, QuantConfig(4, 128, 0))
                               - x_hat @ w_hat) ** 2))
    H = hadamard_matrix(m, device=x.device)
    e_low = float(total_delta(x_hat, U, V, R, aq, uq, vq, rq))
    e_had = float(total_delta(x_hat @ H, H.T @ U, V, H.T @ R, aq, uq, vq, rq))
    e_twin = float(total_delta(x_hat @ Q, U2, V2, R2, aq, uq, vq, rq))
    ortho = float(orthogonality_error(Q))
    ginv = float(torch.max(torch.abs(G @ Gi - torch.eye(d.rank, device=x.device))))
    y_ref = x_hat @ w_hat
    fold = float(torch.linalg.norm((x_hat @ Q) @ (U2 @ V2 + R2) - y_ref)
                 / torch.linalg.norm(y_ref))
    print(f"calib {name} total_delta naive={e_naive:.6g} lowrank={e_low:.6g} "
          f"hadamard={e_had:.6g} twinquant={e_twin:.6g} twin/had={e_twin / e_had:.4f} "
          f"zeta={float(zeta_gain(x_hat, Q)):.4f} eta={float(eta_gain(U, V, U2, V2)):.4f} "
          f"ortho_err={ortho:.3g} max|G G^-1 - I|={ginv:.3g} fold_rel={fold:.3g}", flush=True)
    gates = {"e_twin < e_had": e_twin < e_had, "e_twin < e_low": e_twin < e_low,
             "final_loss < init_loss": res.final_loss < res.init_loss,
             f"ortho_err < {CALIB_GATES['ortho']}": ortho < CALIB_GATES["ortho"],
             f"max|G G^-1 - I| < {CALIB_GATES['ginv']}": ginv < CALIB_GATES["ginv"],
             f"fold rel < {CALIB_GATES['fold']}": fold < CALIB_GATES["fold"]}
    bad = [k for k, ok in gates.items() if not ok]
    if bad:
        fail(f"calibration {name}: {bad}")
    print(f"calib {name} gates ok: {list(gates)}", flush=True)


def _profile_step(name: str, x, cfg, res, device) -> None:
    """A ``torch.profiler`` top-5 (device time) of one stage-3 step at the
    calibrated Q, with G restarted at identity (the same shapes and work)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.calibration import (
        calibration_step,
        layer_quant_configs,
        stage_scales,
    )
    from repro_torch.core.manifold import HybridOpt
    from repro_torch.core.transforms import gl_init

    d = res.decomp
    x_hat = x / d.lam[None, :]
    aq, uq, vq, rq = layer_quant_configs(x.shape[1], d.rank, cfg)
    kw = dict(x=x_hat, y_ref=x_hat @ (d.U @ d.V + d.R), U=d.U, V=d.V, R=d.R, aq=aq, uq=uq,
              vq=vq, rq=rq, reg_lambda=cfg.reg_lambda, a_bits=cfg.a_bits)
    params = {"Q": res.Q, "G": gl_init(d.rank, device=device)}
    opt = HybridOpt(lr=cfg.lr, momentum=cfg.momentum)
    state = opt.init(params)
    scales = stage_scales(cfg)[2]
    params, state, recon = calibration_step(params, state, opt, scales, kw)  # warm-up
    float(recon)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        params, state, recon = calibration_step(params, state, opt, scales, kw)
        float(recon)
    wall = time.perf_counter() - t0
    kernels, ops = [], []
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if t and "CUDA" in str(getattr(e, "device_type", "")) and not e.key.startswith("aten::"):
            kernels.append((t / 1e3, e.key[:60], e.count))
        # the op that launched a kernel owns its device time as "self" time
        st = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if st and e.key.startswith("aten::"):
            ops.append((st / 1e3, e.key, e.count))
    kernels.sort(reverse=True)
    ops.sort(reverse=True)
    total = sum(r[0] for r in kernels)
    print(f"calib {name} stage-3 step profile profiled_wall_ms={1e3 * wall:.1f} "
          f"device_kernel_ms={total:.1f} top5_kernels="
          f"{json.dumps([f'{k} {ms:.2f}ms x{c}' for ms, k, c in kernels[:5]])} top5_ops="
          f"{json.dumps([f'{k} {ms:.2f}ms x{c}' for ms, k, c in ops[:5]])}", flush=True)


def _serve_calibrated(name: str, x, res, device) -> None:
    """Phase (c): the calibrated components packed (U2 = Q^T U G, V2 = G^-1
    V, R2 = Q^T R) and served through ``dispatch.quant_linear`` on (x_hat Q)
    in bf16 at M = 8 (dual GEMV) and M = 512 (dual GEMM): each output
    ``torch.equal`` to ``dual_gemm_ref``, routed to the kernel (never
    ``ref``), the kernel's launch count up by one; the relative error against
    the f32 ``x_hat @ W_hat`` beside the plain RTN-SVD pack of the same
    weight (not gated: the kernel requantizes H, the calibration loss does
    not)."""
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.kernels.ref import dual_gemm_ref, pack_twinquant_weights

    d = res.decomp
    Q, G, Gi = res.Q, res.G, res.G_inv
    pack = pack_twinquant_weights(Q.T @ d.U @ G, Gi @ d.V, Q.T @ d.R, a_bits=4, group=128)
    plain = pack_twinquant_weights(d.U, d.V, d.R, a_bits=4, group=128)
    x_hat = x / d.lam[None, :]
    w_hat = d.U @ d.V + d.R
    for m, kern in ((8, "dual_gemv"), (512, "dual_gemm")):
        xin = (x_hat[:m] @ Q).to(torch.bfloat16)
        before = _counts()
        y = dispatch.quant_linear(xin, pack)
        launches, routes = _since(before)
        if any("/ref" in k for k in routes):
            fail(f"calibrated {name} M={m}: plain-version route {routes}")
        if device.type == "cuda" and launches.get(kern, 0) != 1:
            fail(f"calibrated {name} M={m}: {kern} launches {launches}, want 1")
        y_p = dual_gemm_ref(xin, pack)
        if not torch.equal(y, y_p):
            fail(f"calibrated {name} M={m}: {kern} != plain version ({_unequal(y, y_p)})")
        y32 = x_hat[:m] @ w_hat
        y_rtn = dispatch.quant_linear(x_hat[:m].to(torch.bfloat16), plain)
        rel = float(torch.linalg.norm(y.float() - y32) / torch.linalg.norm(y32))
        rel_rtn = float(torch.linalg.norm(y_rtn.float() - y32) / torch.linalg.norm(y32))
        print(f"calib {name} pack M={m} {kern} routes={json.dumps(routes, sort_keys=True)} "
              f"launches={json.dumps(launches, sort_keys=True)} kernel == plain: equal "
              f"rel_vs_f32 calibrated={rel:.4f} rtn_svd={rel_rtn:.4f}", flush=True)


def _sim_phase(device, cfg, rows: int, steps) -> None:
    """Phase (d): ``simulate_quantize_params`` on the random-weight model at
    full width, depth ``cfg.n_layers``, taps from ``forward_with_taps`` over
    ``rows`` seeded random tokens; seconds per method and each simulated
    model's logits error against the bf16 model (not gated: random weights
    have no outliers)."""
    import torch

    from repro_torch.configs import QuantSpec
    from repro_torch.core.calibration import CalibConfig
    from repro_torch.core.twinquant import simulate_quantize_params
    from repro_torch.models import dense

    model = dense.init_params(cfg, seed=0, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (1, rows), generator=gen, device=device)
    logits, taps = dense.forward_with_taps(model, cfg, toks)
    ref = logits.float()
    del logits
    if tuple(taps["attn"].shape) != (cfg.n_layers, rows, cfg.d_model):
        fail(f"forward_with_taps: attn taps {tuple(taps['attn'].shape)}")
    spec = QuantSpec("w4a4", rank=128, group_size=128)
    cc = CalibConfig(rank=128, a_bits=4, group_size=128, steps_global=steps[0],
                     steps_invert=steps[1], steps_joint=steps[2])
    for method in ("naive", "lowrank", "hadamard", "twinquant"):
        t0 = time.perf_counter()
        sim = simulate_quantize_params(model, cfg, spec, method, taps, cc, device=device)
        _sync(device)
        secs = time.perf_counter() - t0
        lg = dense.forward(sim, cfg, toks).float()
        if not bool(torch.isfinite(lg).all()):
            fail(f"sim {method}: non-finite logits")
        rel = float(torch.linalg.norm(lg - ref) / torch.linalg.norm(ref))
        print(f"calib sim {cfg.name} layers={cfg.n_layers} tokens={rows} {method} "
              f"seconds={secs:.2f} logits_rel_vs_bf16={rel:.4f}", flush=True)
        del sim, lg
    del model, taps, ref


def calibration_phase(device, card: str, cfg, rows: int = CALIB_ROWS, steps=CALIB_STEPS,
                      cut_steps=None, sim_steps=SIM_STEPS) -> None:
    """TwinQuant calibration on the card at ``cfg``'s widths (rank 128,
    group 128, a_bits 4, ``rows`` calibration rows, seed 0): (a) the
    q-shaped layer at ``steps`` with the reference test's six gates; (b) the
    gate/up- and down-shaped layers at cut steps, with a profiler top-5 of
    one stage-3 step of down; (c) the calibrated q and down packs served by
    the dual kernels; (d) the simulation path. Launch and route counts are
    zeroed just before (c) and read just after it; each of ``dual_gemv``
    and ``dual_gemm`` must have run. Every SVD, QR and solve runs on
    ``device``; TF32 stays off."""
    import torch

    from repro_torch.kernels import cuda_launch, dispatch

    cut_steps = cut_steps or CALIB_STEPS_CUT
    gen = torch.Generator(device=device).manual_seed(0)
    d, f, hq = cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.head_dim
    secs = {}
    t = time.perf_counter()
    x, w = outlier_layer(gen, d, hq, rows, device)
    cq, rq = _calibrate("q", x, w, steps, device)
    _calib_errors("q", x, cq, rq)
    secs["a_q"] = time.perf_counter() - t
    t = time.perf_counter()
    x2, w2 = outlier_layer(gen, d, f, rows, device)
    _calibrate("gate_up", x2, w2, cut_steps["gate_up"], device)
    del x2, w2
    x3, w3 = outlier_layer(gen, f, d, rows, device)
    cd, rd = _calibrate("down", x3, w3, cut_steps["down"], device)
    _profile_step("down", x3, cd, rd, device)
    secs["b_gate_up_down"] = time.perf_counter() - t
    t = time.perf_counter()
    dispatch.reset_dispatch_counters()
    cuda_launch.reset_launch_counts()
    _serve_calibrated("q", x, rq, device)
    _serve_calibrated("down", x3, rd, device)
    launches = cuda_launch.launch_counts()
    print(f"calib packs launches {json.dumps(launches, sort_keys=True)} routes "
          f"{json.dumps(dispatch.dispatch_counters(), sort_keys=True)}", flush=True)
    if device.type == "cuda" and not all(launches.get(k, 0) > 0
                                         for k in ("dual_gemv", "dual_gemm")):
        fail(f"calibrated packs: a dual kernel did not launch: {launches}")
    secs["c_packs"] = time.perf_counter() - t
    del x, w, x3, w3, rq, rd
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    _sim_phase(device, cfg.replace(n_layers=SIM_LAYERS), rows, sim_steps)
    secs["d_sim"] = time.perf_counter() - t
    print(f"calib phase seconds {json.dumps({k: round(v, 1) for k, v in secs.items()})} "
          f"card {card}", flush=True)


# ---------------------------------------------------------------------------
# phase 7: OLMoE-1B-7B (moe family): the dual kernels over an expert axis, the
# attention kernels at one query head per KV head, the engine in every mode
# ---------------------------------------------------------------------------

OLMOE_LAYERS = 16  # OLMoE-1B-7B's full depth
OLMOE_CF = 8.0  # capacity_factor at which nothing drops: Cp >= T at E / top_k = 8
MOE_GEMV_CPS = (8,)  # decode (B = 8) and the prefill bucket 8 at either capacity factor
# Cp of every stacked GEMM the served runs launch. At OLMOE_CF (Cp = T): spec
# verify 32 (B 8 x sq 4), ragged 256 (the token budget), the prefill buckets
# 32, 64, 512, 1024. At the published 1.25 (the paged run only): the buckets
# 64, 512, 1024 give 16, 80, 160. And 40, the ragged budget's Cp at 1.25.
MOE_GEMM_CPS = (16, 32, 40, 64, 80, 160, 256, 512, 1024)
MOE_TABLE_CP = {"dual_gemv": 8, "dual_gemv_group": 8,  # the kernel table's row: ragged's
                "dual_gemm": 256, "dual_gemm_group": 256}  # Cp is the most launched GEMM
OLMOE_ATT = dict(B=8, H=16, KV=16, hd=128, page=16, maxp=128)  # max_len 2048
MOE_KERNELS = ("dual_gemv", "dual_gemv_group", "dual_gemm", "dual_gemm_group")


def _stacked_pack(gen, e, k, n, r, device):
    """An expert-stacked W4A4 pack: E experts' random (U, V, R), packed at once."""
    import torch

    from repro_torch.kernels.ref import pack_twinquant_weights

    def rnd(*shape, s):
        return torch.randn(*shape, generator=gen, device=device) * s

    return pack_twinquant_weights(rnd(e, k, r, s=0.1), rnd(e, r, n, s=0.1),
                                  rnd(e, k, n, s=0.05), a_bits=4, group=128)


def _bound_stacked(e: int, cp: int, k: int, gw) -> tuple[float, str]:
    """``bound`` of one launch over E experts: every expert's Cp rows in and
    out and the whole stacked pack moved once, every expert's operations."""
    n, r = gw.ndim_out, gw.rank
    nbytes = e * cp * k * 2 + pack_bytes(gw) + e * cp * n * 2
    ops = e * (2 * cp * k * n + 2 * cp * k * r
               + sum(2 * cp * rj * nj for rj, nj in zip(gw.seg_r, gw.seg_n)))
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / INT8_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _swap_experts(w, a: int = 0, b: int = 1):
    """A copy of stacked pack ``w`` whose experts ``a`` and ``b`` swap their
    residual packs (``rp``): the planted fault of the expert axis."""
    rp = w.rp.clone()
    rp[[a, b]] = rp[[b, a]]
    return dataclasses.replace(w, rp=rp)


def moe_kernel_phase(device, cfg) -> dict:
    """The four dual kernels on expert-stacked packs at ``cfg``'s widths
    (OLMoE: E = 64, gate_up 2048 -> 2 x 1024 fused, down 1024 -> 2048, rank
    128, group 128), GEMV at Cp in ``MOE_GEMV_CPS`` and GEMM at
    ``MOE_GEMM_CPS``, a_bits 4 and 8: each stacked launch ``torch.equal`` to
    the stacked plain version and, expert by expert, to one-expert launches;
    experts 0 and 1 with their ``rp`` swapped must fail the check; timed at
    a_bits 4 (device ms from a CUDA graph, host µs, the plain version, one
    bf16 ``torch.bmm`` of the same (E, Cp, K) x (E, K, N), the bound).
    Returns each wrapper's row for the table (at ``MOE_TABLE_CP``)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.twinquant_dual_gemm import dual_gemm, dual_gemm_group
    from repro_torch.kernels.twinquant_dual_gemv import dual_gemv, dual_gemv_group

    e, d, f, r = cfg.n_experts, cfg.d_model, cfg.d_ff_expert, 128
    gen = torch.Generator(device=device).manual_seed(7)
    down = _stacked_pack(gen, e, f, d, r, device)
    gate_up = ref.fuse_twinquant_weights([_stacked_pack(gen, e, d, f, r, device)
                                          for _ in range(2)])
    cases = {"dual_gemv": (dual_gemv, "down", down, MOE_GEMV_CPS),
             "dual_gemv_group": (dual_gemv_group, "gate_up", gate_up, MOE_GEMV_CPS),
             "dual_gemm": (dual_gemm, "down", down, MOE_GEMM_CPS),
             "dual_gemm_group": (dual_gemm_group, "gate_up", gate_up, MOE_GEMM_CPS)}
    table = {}
    for name, (kern, lname, w, cps) in cases.items():
        gw = w if isinstance(w, ref.TwinQuantGroupWeights) else ref.as_group(w)
        k, n = gw.kdim, gw.ndim_out
        wb = torch.randn(e, k, n, generator=gen, device=device).to(torch.bfloat16)
        worst = 0.0
        for a_bits in (4, 8):
            wa = dataclasses.replace(w, a_bits=a_bits)
            gwa = dataclasses.replace(gw, a_bits=a_bits)
            for cp in cps:
                x = (torch.randn(e, cp, k, generator=gen, device=device) * 2).to(torch.bfloat16)
                y_k, y_p = kern(x, wa), ref.dual_gemm_group_ref(x, gwa)
                torch.cuda.synchronize()
                worst = max(worst, (y_k.float() - y_p.float()).abs().max().item())
                if not torch.equal(y_k, y_p):
                    fail(f"{name} stacked {lname} E={e} Cp={cp} a_bits={a_bits}: kernel != "
                         f"plain version ({_unequal(y_k, y_p)})")
                alone = torch.stack([kern(x[i], wa.expert(i)) for i in range(e)])
                if not torch.equal(alone, y_k):
                    bad = int((alone != y_k).flatten(1).any(dim=1).sum())
                    fail(f"{name} stacked {lname} Cp={cp} a_bits={a_bits}: {bad} experts differ "
                         f"from one-expert launches")
                y_f = kern(x, _swap_experts(wa))
                torch.cuda.synchronize()
                caught = not torch.equal(y_f, y_p)
                print(f"kernel planted fault ({name} stacked {lname} Cp={cp} a_bits={a_bits}: "
                      f"experts 0 and 1 swap rp) -> {'caught' if caught else 'MISSED'}; experts "
                      f"0, 1 differ: {not torch.equal(y_f[:2], y_p[:2])}, experts 2.. equal: "
                      f"{torch.equal(y_f[2:], y_p[2:])}", flush=True)
                if not caught:
                    fail(f"{name} stacked: swapped experts' rp passes the equality check")
                if a_bits != 4:
                    continue
                t_k = graph_ms(lambda: kern(x, wa))
                t_h = host_us(lambda: kern(x, wa))
                t_p = cuda_ms(lambda: ref.dual_gemm_group_ref(x, gwa), iters=1, warmup=0)
                t_lib = cuda_ms(lambda: torch.bmm(x, wb), iters=20)
                t_b, by = _bound_stacked(e, cp, k, gw)
                print(f"kernel {name:16s} stacked {lname:8s} E={e} Cp={cp:4d} K={k:5d} N={n:5d} "
                      f"equal, experts == one-expert launches device_ms={t_k:.4f} "
                      f"host_us={t_h:.1f} plain_ms={t_p:.4f} bf16_bmm_ms={t_lib:.4f} "
                      f"bound_ms={t_b:.4f} ({by}) share={t_b / t_k:.3f} "
                      f"vs_bmm={t_k / t_lib:.2f}x", flush=True)
                if cp == MOE_TABLE_CP[name]:
                    table[name] = dict(ms=t_k, host_us=t_h, plain_ms=t_p, library_ms=t_lib,
                                       bound_ms=t_b, bound_by=by, cp=cp)
        print(f"kernel {name:16s} stacked {lname} E={e} a_bits=4,8 equal at Cp={list(cps)}",
              flush=True)
        table[name]["max_abs_err"] = worst
        del wb
    del cases, down, gate_up
    torch.cuda.empty_cache()
    return table


class MoEServed(Served):
    """An OLMoE model served as :class:`Served` does, its linears checked as
    one stacked launch per (layer, linear call): every model call (a decode,
    verify or ragged step, a prefill) runs q/k/v (fused), o, the experts'
    gate/up (fused) and down, each one dual launch for all experts."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.host_step_ms: dict = {}

    def _against_eager(self, mode, reqs, got, routes, eng) -> None:
        """No whole-run eager twin: the graph step is held to the eager step
        bit for bit (``_step_check``), and an eager run of each mode (~6 s on
        an H100 at 2.5k launches a step) would add ~25 s to a script held to
        1200 s."""

    def _linears(self, mode, eng, got, routes) -> None:
        L, cuda = self.cfg.n_layers, self.device.type == "cuda"
        name = f"{self.tag} {mode}"
        calls = eng.stats["decode_steps"] + eng.compile_stats()["prefill_calls"]
        want = 4 * L * calls
        n_routes = sum(v for key, v in routes.items() if key in (
            "dual/decode", "dual/prefill", "dual_fused/decode", "dual_fused/prefill"))
        n_launch = sum(got.get(kname, 0) for kname in MOE_KERNELS)
        if n_routes != want or any(not key.startswith(("dual", "paged_decode", "ragged"))
                                   for key in routes):
            fail(f"{name}: want {want} dual routes (4 x {L} layers x {calls} model calls), "
                 f"routes {routes}")
        if cuda and n_launch != want:
            fail(f"{name}: dual kernels launched {n_launch} times, want one stacked launch per "
                 f"(layer, linear call): {want} ({got})")
        if mode == "bucketed":
            for kname in MOE_KERNELS:
                if cuda and got.get(kname, 0) <= 0:
                    fail(f"kernel {kname} never launched on the {name} path")
                self.launches[kname] = got.get(kname, 0)
        mem = eng.memory()
        self.host_step_ms[mode] = _step_ms(eng, mode)
        print(f"serve {name} dual launches={n_launch} == 4 x {L} layers x {calls} model calls "
              f"(qkv, o, experts gate_up, experts down; one launch for all "
              f"{self.cfg.n_experts} experts) host_step_ms={_step_ms(eng, mode):.3f} "
              f"pages_peak={mem.get('pages_peak', 'dense cache')}", flush=True)


def _drops_run(served, device) -> None:
    """One paged run at the published capacity factor (eager steps: the
    layer records drops of eager calls only): the expert assignments
    dropped per model call, from the layer's own record
    (``moe_layer.record_drops``), read after the run and shown by the
    call's token rows T (decode steps and the prompts of bucket 8 share T =
    8). Not gated on tokens."""
    from repro_torch.models import moe_layer

    cfg, L = served.cfg, served.cfg.n_layers
    log: list = []
    eng = served.engine("paged", step_graphs=False)
    reqs = served.requests()
    moe_layer.record_drops(log)
    try:
        _drive(f"{served.tag} paged capacity_factor={cfg.capacity_factor}", eng, reqs, device, L)
    finally:
        moe_layer.record_drops(None)
    by_t: dict = {}
    for i in range(0, len(log), L):  # one model call: L MoE calls of one T
        t, cp = log[i][:2]
        by_t.setdefault((t, cp), []).append(int(sum(e[2] for e in log[i:i + L]).item()))
    same = sum(a.out == b.out for a, b in zip(reqs, served.outs["paged"]))
    shown = {f"T={t} Cp={cp}": dict(calls=len(v), dropped_max=max(v),
                                     dropped_mean=sum(v) / len(v), of=t * cfg.top_k * L)
             for (t, cp), v in sorted(by_t.items())}
    print(f"serve {served.tag} paged capacity_factor={cfg.capacity_factor}: assignments dropped "
          f"per model call (of T x {cfg.top_k} x {L} layers), by token rows: {json.dumps(shown)}; "
          f"decode_steps={eng.stats['decode_steps']}; requests with the drop-free run's tokens: "
          f"{same} of {len(reqs)} (not gated)", flush=True)


def olmoe_phase(device, card: str, cfg, prompt_lens=PROMPT_LENS, max_len: int = 2048,
                rank: int = 128) -> dict:
    """OLMoE-1B-7B at full width (``cfg``'s depth), random weights from seed
    0: the stacked dual kernels (``moe_kernel_phase``), the attention
    kernels at one query head per KV head, then W4A4 packs (quantized once,
    fused) served in the four modes at ``OLMOE_CF`` (drop-free) with the
    serve phase's checks (routes, one stacked launch per linear call, one
    capture, solo == interleaved, spec == paged, graph step == eager step),
    paged and ragged again under the sanitizers, and one paged run at the
    published capacity factor. Returns the kernel and attention tables."""
    import numpy as np
    import torch

    from repro_torch.configs import QuantSpec
    from repro_torch.core.twinquant import fuse_params, quantize_params
    from repro_torch.models import olmoe

    t0 = time.perf_counter()
    print(f"olmoe config {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} "
          f"head_dim={cfg.head_dim} experts={cfg.n_experts} top_k={cfg.top_k} "
          f"d_ff_expert={cfg.d_ff_expert} vocab={cfg.vocab} n_layers={cfg.n_layers} "
          f"card=\"{card}\"", flush=True)
    tables = {"stacked": moe_kernel_phase(device, cfg)}
    t1 = time.perf_counter()
    tables["attention"] = attention_phase(device, OLMOE_ATT)
    t2 = time.perf_counter()
    params = olmoe.init_params(cfg, seed=0, device=device)
    bf16_bytes = _param_bytes(params)
    _sync(device)
    t3 = time.perf_counter()
    qp = quantize_params(params, cfg, QuantSpec("w4a4", rank=rank, group_size=128))
    _sync(device)
    t4 = time.perf_counter()
    del params
    torch.cuda.empty_cache()
    qp = fuse_params(qp)
    total, active = olmoe.count_params(cfg)
    print(f"olmoe params total={total} active={active} param_bytes bf16={bf16_bytes} "
          f"w4a4={_param_bytes(qp)} ({bf16_bytes / _param_bytes(qp):.2f}x); init_s={t3 - t2:.2f} "
          f"w4a4_quantize_s={t4 - t3:.2f} ({(t4 - t3) / cfg.n_layers:.2f} s a layer: "
          f"{3 * cfg.n_experts} expert linears in 3 batched SVDs + 4 attention linears)",
          flush=True)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in prompt_lens]
    served = MoEServed("olmoe w4a4", cfg.replace(capacity_factor=OLMOE_CF), qp, "w4a4",
                       prompts, device, max_len)
    t5 = time.perf_counter()
    for mode in MODES:
        served.serve(mode, against_eager=True)
    for mode in ("paged", "ragged"):
        served.sanitized(mode)
    for mode, times in served.step_times.items():
        times["busy_share_graph"] = ((times["graph_kernel_ms"] or times["replay_events_ms"])
                                     / served.host_step_ms[mode])
        print(f"serve step times {json.dumps({'setting': served.tag, 'mode': mode, **times})}",
              flush=True)
    t6 = time.perf_counter()
    published = MoEServed("olmoe w4a4", cfg, qp, "w4a4", prompts, device, max_len)
    published.outs = served.outs
    _drops_run(published, device)
    t7 = time.perf_counter()
    launches = dict(served.launches)
    del served, published, qp
    torch.cuda.empty_cache()
    print(f"olmoe phase seconds: stacked kernels {t1 - t0:.1f} attention {t2 - t1:.1f} "
          f"init+quantize {t5 - t2:.1f} serve {t6 - t5:.1f} capacity_1.25 {t7 - t6:.1f}",
          flush=True)
    print(f"olmoe tables {json.dumps({**tables, 'launches': launches})}", flush=True)
    return tables


def main() -> None:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spec-probe", type=int, default=0, metavar="N",
                    help="repeat the paged run and every speculative variant N times")
    ap.add_argument("--dual-only", action="store_true",
                    help="build, then run the dual kernels' phase alone (no result line)")
    ap.add_argument("--timing-only", action="store_true",
                    help="build, then time the dual, w4a16 and paged wrappers at their "
                         "table cases alone")
    ap.add_argument("--ragged-serve", action="store_true",
                    help="build, then serve llama3-8b in ragged mode alone (W4A16, W4A4)")
    ap.add_argument("--lifecycle-only", action="store_true",
                    help="build, quantize llama3-8b W4A4, then run the lifecycle phase alone")
    ap.add_argument("--calib-only", action="store_true",
                    help="build, then run the calibration phase alone (no result line)")
    ap.add_argument("--olmoe-only", action="store_true",
                    help="build, then run the OLMoE phase alone (no result line)")
    ap.add_argument("--src", metavar="DIR",
                    help="import repro_torch from DIR (another tree's src) instead")
    args = ap.parse_args()
    if args.src:
        global SRC
        SRC = Path(args.src).resolve()
        sys.path.insert(0, str(SRC))

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    print(f"device name={name} count={count} torch={torch.__version__} "
          f"cuda={torch.version.cuda}", flush=True)
    print(card, flush=True)

    from repro_torch.kernels import build

    secs = build.build_all()
    print(f"build seconds={secs:.1f}", flush=True)
    for src, lines in build.ptxas_report().items():
        for ln in lines:
            print(f"build {src}: {ln}", flush=True)
    if args.timing_only:
        timing_phase(device)
        return
    if args.dual_only:
        kernel_phase(device)
        print("dual kernel phase ok", flush=True)
        return
    if args.ragged_serve:
        from repro_torch.configs import get_config

        ragged_serve_phase(device, card, get_config("llama3-8b").replace(n_layers=SERVE_LAYERS))
        return
    if args.calib_only:
        from repro_torch.configs import get_config

        t = time.perf_counter()
        calibration_phase(device, card, get_config("llama3-8b"))
        print(f"calib phase total seconds {time.perf_counter() - t:.1f}", flush=True)
        return
    if args.olmoe_only:
        from repro_torch.configs import get_config

        t = time.perf_counter()
        olmoe_phase(device, card, get_config("olmoe-1b-7b").replace(n_layers=OLMOE_LAYERS))
        print(f"olmoe phase total seconds {time.perf_counter() - t:.1f}", flush=True)
        return
    if args.lifecycle_only:
        from repro_torch.configs import QuantSpec, get_config
        from repro_torch.core.twinquant import fuse_params, quantize_params
        from repro_torch.models import dense

        cfg = get_config("llama3-8b").replace(n_layers=SERVE_LAYERS)
        qp = fuse_params(quantize_params(dense.init_params(cfg, seed=0, device=device), cfg,
                                         QuantSpec("w4a4", rank=128, group_size=128)))
        t = time.perf_counter()
        lifecycle_phase(device, card, cfg, qp)
        print(f"lifecycle phase seconds {time.perf_counter() - t:.1f}", flush=True)
        return

    secs = {}
    t = time.perf_counter()
    table = kernel_phase(device)
    table.update(w4a16_phase(device))
    table.update(attention_phase(device))
    secs["kernels"] = time.perf_counter() - t
    from repro_torch.configs import get_config

    t = time.perf_counter()
    launches = serve_phase(device, card, get_config("llama3-8b").replace(n_layers=SERVE_LAYERS),
                           spec_probe=args.spec_probe, secs=secs)
    secs["serve_llama3_8b"] = time.perf_counter() - t - secs["lifecycle"]
    t = time.perf_counter()
    qwen_phase(device, card, get_config("qwen3-8b").replace(n_layers=QWEN_LAYERS))
    secs["serve_qwen3_8b"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    calibration_phase(device, card, get_config("llama3-8b"))
    secs["calibration"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    olmoe_phase(device, card, get_config("olmoe-1b-7b").replace(n_layers=OLMOE_LAYERS))
    secs["olmoe_1b_7b"] = time.perf_counter() - t
    print(f"phase seconds {json.dumps({k: round(v, 1) for k, v in secs.items()})}", flush=True)

    rows = []
    for kname, (source, replaces) in KERNELS.items():
        rows.append(dict(name=kname, route="cuda", source=source, replaces=replaces,
                         launches=launches.get(kname, 0), **table[kname]))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
