"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--spec-probe N]
    python3 chip_smoke.py --dual-only      # build + the dual kernels' phase
    python3 chip_smoke.py --timing-only [--src OTHER_TREE/src]
    python3 chip_smoke.py --ragged-serve [--src OTHER_TREE/src]
    python3 chip_smoke.py --lifecycle-only  # build, W4A4 llama3-8b, the lifecycle phase
    python3 chip_smoke.py --calib-only      # build, then the calibration phase
    python3 chip_smoke.py --olmoe-only      # build, then the OLMoE phase
    python3 chip_smoke.py --dense-only      # build, then the other dense configs and the VLM
    python3 chip_smoke.py --deepseek-only   # build, then DeepSeek-V3 (mla_moe)
    python3 chip_smoke.py --whisper-only    # build, then Whisper-base (encdec)
    python3 chip_smoke.py --zamba2-only     # build, then Zamba2-1.2B (mamba_hybrid)
    python3 chip_smoke.py --xlstm-only      # build, the narrow-N tile, then xLSTM-1.3B
    python3 chip_smoke.py --train-only      # build, then the training stack (llama3-8b)
    python3 chip_smoke.py --train-sweep 3e-4,1e-4  # build, then the loss fall per lr
    python3 chip_smoke.py --shard-only      # build, then the sharded path at world size 1
    python3 chip_smoke.py --cost-only       # build, W4A4 llama3-8b, the cost model's phase

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
   take the kernels' masked paths; the narrow-N tile (``narrow_phase``, K 4096,
   N 8, rank 8 as xLSTM's gate linear, and a fused group whose narrow first
   segment puts the second off the 16-byte grid; M in {1, 8, 9, 64, 256}):
   the dual kernels ``torch.equal`` to their plain versions, ``w4a16_gemm``
   per row within ``W4A16_REL_MAX`` of the f32 plain version and each row
   equal to a one-row launch, every launch made again into a view of a
   longer buffer and each one-row launch into a row with canary columns past
   N (canaries untouched), and planted faults (rank lanes past r, a column
   read past N, a store past N) caught; the weight-only ``w4a16_gemm`` at every llama3-8b shape
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
4. serve   — llama3-8b at full width, depth ``SERVE_LAYERS`` (6 of 32),
   random weights from seed 0:
   first the bf16 model's ragged-step vs bucketed-prefill logits at several
   depths (gated at the served depth), then W4A4 TwinQuant packs (quantized once)
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
   ``rp`` caught, timed beside one bf16 ``torch.bmm`` and the bound; then
   ``w4a16_gemm`` on expert-stacked packs (gate/up and down, E = 64) at
   every Cp in ``W4A16_MOE_CPS`` and its column-split schedule at
   ``W4A16_COL_CASE``, rows at rel <= ``W4A16_REL_MAX`` against the f32
   plain version and within ``W4A16_TOL`` of the bf16 one, each expert's
   slice ``torch.equal`` to a one-expert launch, experts 0 and 1 with
   swapped packs caught, timed beside one bf16 ``torch.bmm`` and the bound;
   the attention kernels of phase 3 at H = KV = 16; W4A4 packs (rank 128,
   one batched SVD per expert linear) served in the four modes at
   ``capacity_factor`` ``OLMOE_CF`` (drop-free) with the serve phase's
   checks (every model call four dual launches a layer: q/k/v, o, the
   experts' gate/up and down), a graph step == eager step in each mode,
   paged and ragged again under the sanitizers, and one eager paged run at
   the published capacity factor 1.25 printing the expert assignments
   dropped per model call (``moe_layer.record_drops``); then the W4A16
   packs (experts stacked) served in the four modes at ``OLMOE_CF`` with
   the same checks, ``w4a16_gemm`` launched 7 x layers x model calls (q, k,
   v, o and the experts' gate, up, down, one launch each for all experts);
8. dense configs — ``qwen2-1.5b``, ``stablelm-12b``, ``phi4-mini-3.8b``,
   ``internlm2-1.8b`` and the ``vlm`` family's ``internvl2-2b`` at full
   width, depth ``DENSE_LAYERS``, random weights from seed 0, W4A4 packs
   (rank 128, group 128, fused) served in ``DENSE_MODES`` (paged with the
   prefix cache; qwen2-1.5b also ragged; internvl2-2b bucketed and paged,
   each request behind its own seeded 256-row patch set) with the serve
   phase's checks and four dual launches a layer a model call; for
   internvl2-2b also ``prefix_lookups == 0`` and two patch sets giving
   different first logits; before each new (H, KV, hd) the attention
   kernels of phase 3 at it ((12, 2, 128), (32, 8, 160), (24, 8, 128), (16,
   8, 128));
9. deepseek-v3-671b — the ``mla_moe`` family at full width (d_model 7168,
   128 heads, MLA q_lora 1536 / kv_lora 512 / nope 128 / rope 64 / v 128,
   256 experts top-8 at d_ff_expert 2048 plus one shared expert, dense d_ff
   18432, vocab 129280) and depth ``DEEPSEEK_LAYERS`` (one dense and one
   MoE layer) with the ``mtp`` block, random weights from seed 0: W4A4
   packs (rank 128, group 128, experts packed a chunk of batched SVDs at a
   time, fused; seconds per layer printed); the four dual kernels on the
   served experts (one launch for all 256) at Cp 8 and every Cp the served
   runs give a GEMM (``DS_GEMM_CPS``), every expert ``torch.equal`` to its
   one-expert launch and experts ``DS_EXPERTS`` to the plain version,
   experts 0 and 1 with swapped ``rp`` caught, timed beside bf16
   ``torch.bmm`` and the bound (``moe_kernel_phase`` as phase 7 runs it,
   with ``DS_KERNEL_RUN``); W4A16 packs; the 2-D linears of both
   (``wqkv_a`` group or ``wq_a`` and ``wkv_a``, ``wq_b``, ``o``, the dense
   MLP, the shared expert) at every M serving gives them
   (``DS_LINEAR_MS``), W4A4 ``torch.equal`` to their plain versions and
   W4A16 within phase 3a's limits; the
   W4A4 model served bucketed and paged (prefix cache on) at ``DEEPSEEK_CF``
   (drop-free) with the serve phase's checks (routes, one launch per linear
   call: 5 a dense and 7 a MoE layer, one capture, graph step == eager
   step, solo == interleaved), a prefix hit == its cold run, and one eager
   paged run at the published capacity factor 1.25 printing the drops and
   every dual launch's expert count (``gridDim.z``); then ``w4a16_gemm`` on
   random stacks at E = 256 (gate/up and down) at every Cp the served W4A16
   runs give (``DS_W4A16_CPS``), checked as phase 7 checks it with the
   plain version over ``DS_EXPERTS``; and the W4A16 packs served
   bucketed and paged (``w4a16_gemm`` 7 and 10 launches a layer);
10. whisper-base — the ``encdec`` family at full width and depth (6 + 6
   layers, d_model 512, 8 heads of 64, d_ff 2048, 1500 frames, vocab
   51865), random weights from seed 0 and each request's frames
   (``Request.frontend``) from seed 11, ``max_len`` 448 (the decoder
   context), prompts of 3 … 440 tokens (``WHISPER_PROMPTS``, each
   request's ``max_new`` cut to fit): the paged kernel at H = KV = 8, hd 64
   (phase 3's checks, its planted faults and the stacked-vs-sequential
   identity; no ragged kernel: neither family has a ragged step); W4A4
   (rank 128, fused) and W4A16 packs, every distinct linear through its
   kernel at every M the runs give (``WHISPER_LINEAR_MS``: decode 8, the
   buckets, the 1500-row encoder; the cross-attention k/v fused at call
   time), W4A4 ``torch.equal`` to the plain version, W4A16 within phase 3a's
   limits (``family_linears_phase``); W4A4 served bucketed and paged, W4A16
   paged (``FamilyServed``): kernel routes only, the linears' launches per
   model call as counted (6 a decoder layer a step; 4 an encoder and 7 a
   decoder layer a prefill; W4A16 8, 6 and 10), the paged kernel once a
   layer a step, one capture, a graph step == the eager step, solo ==
   interleaved for requests with different frames, no prefix-cache lookup
   (the paged engine warns), the paging invariant (``layouts_agree``: the
   requests served paged with the paged kernel's plain version in its
   place give the bucketed tokens; the kernel's own paged tokens printed
   against them), the paged kernel on the served state in each paged run
   (``kernel_step``: at a steady step, each paged launch of the step on
   its own inputs within ``ATT_REL_MAX`` per (row, head) of the f32 plain
   version, a slot reading one wrong page caught, and the step's logits
   within ``PAGED_STEP_REL`` of the same step with the plain version, W4A4
   0.5 and W4A16 0.05), the ragged and speculative engines warning and falling
   back with the paged run's tokens, W4A4 prefill logits kernel == plain,
   each prompt's prefill ms a bucket row;
11. zamba2-1.2b — the ``mamba_hybrid`` family at full width (d_model 2048,
   64 SSM heads of 64, state 64, conv 4, the shared block 32 heads of 64 on
   the 4096-wide concat, d_ff 8192, vocab 32000) and depth
   ``ZAMBA_LAYERS`` (7 of 38: one shared-block invocation and the 1 rest
   layer), random weights from seed 0, ``max_len`` 512, prompts
   ``ZAMBA_PROMPTS`` (3 … 200 tokens: the 200-token forward runs two SSD
   chunks): the paged kernel at H = KV = 32, hd
   64; W4A4 and W4A16 packs through their kernels at every served M
   (``ZAMBA_LINEAR_MS``: the prefill's per-token steps 1, decode 8, the
   forward's 128 and 256; ``in_proj`` N = 8384); then phase 10's serve checks (the
   linears 2 a Mamba block and 7 a shared-block invocation a model step, a
   prefill the forward plus one step a bucket row; W4A16 2 and 8; the paged
   kernel once an invocation a step), with each prompt's prefill ms a
   bucket row (the reference's per-token state fill);
12. xlstm-1.3b — the ``xlstm`` family at full width (d_model 2048, d_inner
   4096, 4 heads, dqk 512, dv 1024, vocab 50304) and depth ``XLSTM_LAYERS``
   (8 of 48: one segment of 7 mLSTM + 1 sLSTM blocks), random weights
   from seed 0, ``max_len`` 512, prompts ``XLSTM_PROMPTS`` (3 … 300 tokens:
   the 300-token prompt fills bucket 512, whose trunk runs two 256-row
   chunks); W4A4 and W4A16 packs through their kernels at every served M
   (``XLSTM_LINEAR_MS``: the prefill's per-token steps 1, decode 8, the
   trunk's 256 and 512; the gate linear ``wif`` N = 8 through the narrow
   tile); W4A4 served bucketed and paged, W4A16 paged, with phase 11's serve
   checks (the linears 6 an mLSTM and 3 an sLSTM block a model step, W4A16
   6 and 4; no attention), the paged run's layout the dense per-slot one (no
   pool, allocator or block table), paged == bucketed tokens bit for bit,
   every W4A4 bucketed request == its prompt served alone;
13. train — the training stack (``launch/train.py``, ``optim/``,
   ``checkpoint/manager.py``, ``data/pipeline.py``, the families'
   ``loss_fn``) on llama3-8b at full width, depth ``TRAIN_LAYERS`` (2 of
   32: 1.49 B parameters), trained on the repo's own text (``load_corpus``,
   ``TokenDataset`` of ``TRAIN_BATCH`` x ``TRAIN_SEQ`` = 4 x 2049: the
   chunked, rematerialised CE), ``AdamW(lr=TRAIN_LR)`` with the
   reference's other defaults (f32 moments), ``remat`` on, from seed 0:
   (1) the bf16 step's loss and gradients against the same step with the
   weights upcast to f32 on the card, on ``TRAIN_CHECK_BATCHES`` batches
   (loss finite and within ``TRAIN_INIT_BAND`` of ln V, each leaf within
   ``TRAIN_GRAD_REL_MAX``, the embedding's bf16 scatter-add within
   ``TRAIN_EMBED_REL_MAX``; a dropped leaf gradient, the embedding's
   dropped and labels one token off must fail), the decay flags on the
   reference's stacked shapes; (2) one ``TrainLoop`` of ``TRAIN_STEPS``
   steps under deterministic algorithms,
   async checkpoints into a temporary directory (removed after) at step
   ``TRAIN_CKPT_EVERY`` and an injected failure before step
   ``TRAIN_FAIL_AT``: every loss finite, the first less the last two's mean
   at least ``TRAIN_FALL_MIN`` (the run reversed must fail), one restart,
   the restored parameters and moments bit for bit the saved host copies
   (the state at the failure must differ), the replayed steps' losses equal
   to their first pass (one step off must differ); the step's device ms
   (CUDA events), tokens/s, ``max_memory_allocated``, the checkpoint's
   bytes, save, write and restore seconds and the free disk; (3) from the
   trained state, the int8 error-feedback identity ``deq + ef == g`` within
   ``TRAIN_EF_BOUND`` x scale per leaf (a dropped residual must fail), one
   compressed step (``AdamW()``'s defaults) whose parameters are bit for
   bit AdamW's update by the dequantized gradients (the state before it
   must differ), its update of
   each leaf within ``TRAIN_UPDATE_REL_MAX`` of the uncompressed step's (a
   step that applies no update must fail) and its next loss within
   ``TRAIN_COMPRESS_REL`` of the uncompressed step's; (4) the trained
   weights packed W4A4 (rank 128, fused), layer 0's four packs through the
   dual kernels at every served M (``TRAIN_SERVE_MS``) ``torch.equal`` to
   their plain versions (a pack with layer 1's ``rp`` must differ), served
   paged (``TRAIN_PROMPTS``, 4 slots, step graphs) with every dual kernel
   launched and finite prefill logits;
14. shard — the sharded path (``models/context.py``, ``launch/mesh.py``,
   ``launch/sharding.py``, the EP body of ``models/moe_layer.py``, the
   sharded train step, ZeRO-1 AdamW, the elastic restore) at world size 1
   over NCCL (a ``FileStore``, no address) on a (1, 1) ``("data",
   "model")`` mesh with the mesh context set, run one part after another
   so that no two training states live at once: (a) llama3-8b at phase
   13's width, depth and batch, two steps from the seeded init unsharded,
   then two sharded: the first sharded step ``torch.equal`` to the
   unsharded one (loss, every parameter and moment), every parameter,
   moment and batch leaf in the table's placements, both steps' device ms
   (CUDA events) and their ratio; (b) OLMoE-1B-7B's MoE block at full
   width (E 64, top-8; ``SHARD_MOE_LAYERS`` 1 layer's init), the experts in
   the table's placements, ``SHARD_MOE_BATCH`` tokens of the repo's text
   through ``_moe_ep`` over the NCCL ep group (which ``moe_ffn``'s switch
   takes only at ep size > 1) and through ``_moe_local``: output, aux, the
   input's and every parameter's gradient ``torch.equal``, the body with
   its local experts permuted must differ; (c) (b)'s parameters saved and
   restored replicated by ``restore_like(shardings=...)``: ``torch.equal``
   in the asked placements (a restore without them must be caught); (d) a
   table without the ``attn/o/w`` rule: the spec check must catch the
   leaves it lays out otherwise. No kernel of ``KERNELS`` runs on this
   path (the reference trains in plain ``jnp``).
15. cost — the cost model (``launch/roofline.py``, ``launch/op_cost.py``,
   ``launch/dryrun.py``): (a) every bound in the kernel table comes from
   ``roofline.kernel_cost`` / ``bound_ms`` (the ``cost (a)`` line repeats
   the seven table cases'); (b) inside phase 4, on its W4A4 packs: one
   eager paged decode step and one ragged step (budget 256) of llama3-8b
   at ``SERVE_LAYERS``, each at step ``CHECK_STEP`` of a graph engine,
   counted by ``op_cost.analyze_step`` through the kernels and again under
   ``set_force_ref(True)`` (the two counts equal key for key, every routed
   call counted), printed with flops by class, bytes, the roofline bound,
   what bounds it, the hand-written kernels' share of the count, and the
   bound's share of the same step's replay device ms (CUDA events); a
   count with one kernel's cost left out must fail that check; (c) the
   dry-run (``python -m repro_torch.launch.dryrun``) of llama3-8b
   ``decode_32k`` (W4A4) and ``train_4k`` (bf16) on (16, 16), each in a
   subprocess of its own (phase 14 owns an NCCL group; the fake process
   group of the dry-run lives apart), started with (b) and read after
   phase 14: each must print ``status ok`` and its roofline terms.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX or of ``repro``.

``--dual-only`` runs phases 1-2 and the dual kernels' part of phase 3 and
prints no result line, as do ``--ragged-serve`` (phases 1-2, then
llama3-8b's W4A16 and W4A4 ragged-mode runs of phase 4 alone) and
``--lifecycle-only`` (phases 1-2, then the lifecycle phase on llama3-8b's
W4A4 packs), ``--calib-only`` (phases 1-2, then phase 6) and
``--olmoe-only`` (phases 1-2, then phase 7), ``--dense-only`` (phases
1-2, then phase 8; with ``--olmoe-only``, 7 then 8), ``--deepseek-only``
(phases 1-2, then phase 9), ``--whisper-only`` (phases 1-2, then phase 10)
``--zamba2-only`` (phases 1-2, then phase 11) and ``--xlstm-only``
(phases 1-2, the narrow-N tile of phase 3, then phase 12; any of these
flags together run their phases in that order), ``--train-only`` (phases
1-2, then phase 13), ``--shard-only`` (phases 1-2, then phase 14),
``--cost-only`` (phases 1-2, llama3-8b's W4A4 packs, then phase 15);
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
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
sys.path.insert(0, str(SRC))

# llama3-8b's 32 layers cut to keep the whole script, DeepSeek-V3's and the
# training and sharding phases included, inside its limit (16 until the
# training phase came, 12 until the sharding phase; PERF.md section 4)
SERVE_LAYERS = 6
# qwen3-8b's 36 layers cut to keep the whole script under ~1100 s (8 until
# DeepSeek-V3's phase came, 4 until xLSTM-1.3B's, 2 until the training
# phase's; PERF.md section 4)
QWEN_LAYERS = 1

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
    """Least time (ms) of a dual launch of ``m`` rows an expert over the
    pack ``gw`` and what bounds it (``roofline.kernel_cost``: each input
    read once and the output written once over the memory rate, vs the
    int8 residual, H and V products over the int8 rate)."""
    from repro_torch.launch.roofline import bound_ms, kernel_cost

    return bound_ms(kernel_cost("dual_gemm", m=m, w=gw))


def w4a16_bound(m: int, k: int, n: int, experts: int = 1) -> tuple[float, str]:
    """``bound`` of a ``w4a16_gemm`` launch (``roofline.kernel_cost``)."""
    from repro_torch.launch.roofline import bound_ms, kernel_cost

    return bound_ms(kernel_cost("w4a16_gemm", m=m, k=k, n=n, experts=experts))


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
    from repro_torch.launch.step_graph import collector_off

    graph = torch.cuda.CUDAGraph()
    with collector_off(), torch.cuda.graph(graph):
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
            t_b, by = w4a16_bound(m, k, n)
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
# phase 3a: the narrow-N tile (xLSTM's gate linear wif: K 4096, N 8, rank 8)
# ---------------------------------------------------------------------------

NARROW = dict(k=4096, n=8, r=8)
NARROW_MS = (1, 8, 9, 64, 256)
# a fused group with a narrow segment first: segment 1 starts at column 8
# and rank lane 8, so its tiles, packed rows and Hq rows sit off the 16-byte grid
NARROW_GROUP = dict(k=4096, seg_n=(8, 64), seg_r=(8, 32))
CANARY_PAD = 64  # bf16 guard elements before and after each output (128 bytes)
CANARY = -7.5


def _launch_dual_into(name: str, x, w, out, h_planes: int) -> None:
    """The dual wrapper's launch (``cuda_launch.launch_dual``) with the
    output written into ``out``, a view the caller owns."""
    import torch

    from repro_torch.kernels import cuda_launch as CL

    lib = "twinquant_dual_gemv" if name.startswith("dual_gemv") else "twinquant_dual_gemm"
    fn = "tq_dual_gemv" if name.startswith("dual_gemv") else "tq_dual_gemm"
    pa = CL.pack_args(w, name)
    m, k = x.shape
    total, offs = CL.scratch_layout(m, k, pa, h_planes)
    scratch = torch.empty(total, dtype=torch.uint8, device=x.device)
    args = CL.dual_args(x.data_ptr(), m, k, pa, scratch.data_ptr(), offs, out.data_ptr(),
                        CL.expert_strides(m, k, pa, h_planes))
    CL.run_kernel(name, lib, fn, CL._DUAL_ARGS, args, x.device)


def _launch_w4a16_into(x, wp, ws, out) -> None:
    from repro_torch.kernels import cuda_launch as CL
    from repro_torch.kernels import w4a16_gemm as W

    m, k = x.shape
    CL.run_kernel("w4a16_gemm", "w4a16_gemm", "w4a16_gemm", W._ARGS,
                  [x.data_ptr(), wp.data_ptr(), ws.data_ptr(), out.data_ptr(), 1, m,
                   wp.shape[-1], k, 128, 0, 0, 0, 0], x.device)


def _canary_buffers(m: int, n: int, device):
    """(buf, out, rows): ``out`` (M, N) a view inside ``buf`` with
    ``CANARY_PAD`` guard elements before and after it; ``rows`` (M, 2N), each
    row's columns N.. a canary, the target of one-row launches."""
    import torch

    buf = torch.full((m * n + 2 * CANARY_PAD,), CANARY, dtype=torch.bfloat16, device=device)
    rows = torch.full((m, 2 * n), CANARY, dtype=torch.bfloat16, device=device)
    return buf, buf[CANARY_PAD:CANARY_PAD + m * n].view(m, n), rows


def _canaries_ok(buf, rows, m: int, n: int) -> bool:
    edge = [buf[:CANARY_PAD], buf[CANARY_PAD + m * n:], rows[:, n:]]
    return all(bool((t == CANARY).all()) for t in edge)


def narrow_phase(device) -> dict:
    """The narrow-N tile at xLSTM's gate linear (K 4096, N 8, rank 8 /
    rgroup 8) and at a fused group with a narrow first segment, M in
    ``NARROW_MS``: the dual kernels ``torch.equal`` to their plain versions,
    ``w4a16_gemm`` per row within ``W4A16_REL_MAX`` of the f32 plain version
    and each row ``torch.equal`` to a one-row launch. Each launch is made
    again into a view of a longer buffer (``CANARY_PAD`` guard elements on
    either side) and each one-row launch into a row of an (M, 2N) buffer
    whose columns N.. are canaries: the outputs equal, the canaries
    untouched. Planted faults, each caught: a rank lane read past the edge
    (the plain version with rank lanes 8..15 holding another pack's values),
    an N column read past the edge (``w4a16_gemm``'s plain version reading
    each packed row 8 bytes on) and a store past N (one canary written).
    At M = 8 and 256 each wrapper's device ms (CUDA graph) beside its
    plain version, one bf16 ``torch.matmul`` and its bound. Returns those
    readings."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.twinquant_dual_gemm import dual_gemm, dual_gemm_group
    from repro_torch.kernels.twinquant_dual_gemv import dual_gemv, dual_gemv_group
    from repro_torch.kernels.w4a16_gemm import w4a16_gemm

    cuda = device.type == "cuda"
    gen = torch.Generator(device=device).manual_seed(24)
    k, n, r = NARROW["k"], NARROW["n"], NARROW["r"]
    w = make_pack(gen, k, n, r, device)
    if (w.rank, w.rgroup) != (r, r):
        fail(f"narrow pack: rank {w.rank} rgroup {w.rgroup}, want {r} / {r}")
    other = make_pack(gen, k, n, r, device)
    # the fault: rank lanes r .. 2r read as another pack's lanes
    w_fault = ref.TwinQuantWeights(
        torch.cat([w.up, other.up], dim=1), torch.cat([w.us, other.us], dim=1),
        torch.cat([w.vp, other.vp]), torch.cat([w.vs, other.vs]), w.rp, w.rs, w.group, r,
        w.a_bits)
    gw = ref.fuse_twinquant_weights([make_pack(gen, NARROW_GROUP["k"], nj, rj, device)
                                     for nj, rj in zip(NARROW_GROUP["seg_n"],
                                                       NARROW_GROUP["seg_r"])])
    wp, ws = _w4a16_pack(gen, k, n, device)
    flat = wp.reshape(-1)
    wp_fault = torch.cat([flat[n:], flat[:n]]).view(wp.shape)  # each row read 8 bytes on
    out, worst = {}, 0.0
    for m in NARROW_MS:
        x = (torch.randn(m, k, generator=gen, device=device) * 2).to(torch.bfloat16)
        single, group = (dual_gemv, dual_gemv_group) if m <= 8 else (dual_gemm, dual_gemm_group)
        for name, kern, pack, plain in (
                (single.__name__, single, w, ref.dual_gemm_ref),
                (group.__name__, group, gw, ref.dual_gemm_group_ref)):
            y_k, y_p = kern(x, pack), plain(x, pack)
            _sync(device)
            if not torch.equal(y_k, y_p):
                fail(f"narrow {name} M={m} N={list(getattr(pack, 'seg_n', (n,)))}: kernel != "
                     f"plain version ({_unequal(y_k, y_p)})")
            if cuda:
                nn_ = y_k.shape[1]
                buf, into, rows = _canary_buffers(m, nn_, device)
                planes = k // 128 if m <= 8 else 1
                _launch_dual_into(name, x, pack, into, planes)
                for i in range(min(m, 8)):
                    gv = "dual_gemv_group" if pack is gw else "dual_gemv"
                    _launch_dual_into(gv, x[i:i + 1].contiguous(), pack, rows[i, :nn_], k // 128)
                _sync(device)
                if not torch.equal(into, y_k) or not torch.equal(rows[:min(m, 8), :nn_],
                                                                 y_k[:min(m, 8)]):
                    fail(f"narrow {name} M={m}: the launch into a canary buffer != the wrapper's")
                if not _canaries_ok(buf, rows, m, nn_):
                    fail(f"narrow {name} M={m}: a canary past the output was overwritten")
        y_f = ref.dual_gemm_ref(x, w_fault)
        if torch.equal(y_f, dual_gemv(x, w) if m <= 8 else dual_gemm(x, w)):
            fail(f"planted fault (narrow rank lanes {r}..{2 * r} read) not caught at M={m}")
        y_k = w4a16_gemm(x, wp, ws)
        y32 = ref.w4a16_gemm_f32(x, wp, ws)
        rel = _rel_rows(y_k, y32).max().item()
        worst = max(worst, rel)
        if not rel <= W4A16_REL_MAX:
            fail(f"narrow w4a16_gemm M={m}: kernel vs f32 plain version rel {rel} per row > "
                 f"{W4A16_REL_MAX}")
        one = torch.cat([w4a16_gemm(x[i:i + 1], wp, ws) for i in range(m)])
        if not torch.equal(one, y_k):
            fail(f"narrow w4a16_gemm M={m}: rows differ from one-row launches")
        rel_f = _rel_rows(ref.w4a16_gemm_f32(x, wp_fault, ws), y32).max().item()
        if not rel_f > W4A16_REL_MAX:
            fail(f"planted fault (narrow w4a16 column read past N) passes: rel {rel_f}")
        if cuda:
            buf, into, rows = _canary_buffers(m, n, device)
            _launch_w4a16_into(x, wp, ws, into)
            for i in range(min(m, 8)):
                _launch_w4a16_into(x[i:i + 1].contiguous(), wp, ws, rows[i, :n])
            _sync(device)
            if not torch.equal(into, y_k) or not torch.equal(rows[:min(m, 8), :n],
                                                             y_k[:min(m, 8)]):
                fail(f"narrow w4a16_gemm M={m}: the launch into a canary buffer != the wrapper's")
            if not _canaries_ok(buf, rows, m, n):
                fail(f"narrow w4a16_gemm M={m}: a canary past the output was overwritten")
            stray = buf.clone()
            stray[CANARY_PAD + m * n] = 0.0  # a store one column past N of the last row
            if _canaries_ok(stray, rows, m, n):
                fail("planted fault (a store past N) not caught by the canary check")
        if cuda and m in (8, 256):
            kern = dual_gemv if m <= 8 else dual_gemm
            wb = torch.randn(k, n, generator=gen, device=device).to(torch.bfloat16)
            lib = graph_ms(lambda: torch.matmul(x, wb))
            t_d, by_d = bound(m, k, ref.as_group(w))
            t_w, by_w = w4a16_bound(m, k, n)
            out[f"{kern.__name__} M={m}"] = dict(
                ms=graph_ms(lambda: kern(x, w)), library_ms=lib, bound_ms=t_d, bound_by=by_d,
                plain_ms=cuda_ms(lambda: ref.dual_gemm_ref(x, w), iters=3, warmup=1))
            out[f"w4a16_gemm M={m}"] = dict(
                ms=graph_ms(lambda: w4a16_gemm(x, wp, ws)), library_ms=lib,
                bound_ms=t_w, bound_by=by_w,
                plain_ms=cuda_ms(lambda: ref.w4a16_gemm_ref(x, wp, ws), iters=3, warmup=1))
        print(f"kernel narrow M={m:3d} K={k} N={n} r={r}: dual == plain, group N="
              f"{list(NARROW_GROUP['seg_n'])} r={list(NARROW_GROUP['seg_r'])} == plain; "
              f"w4a16 max rel per row {rel:.5f} (limit {W4A16_REL_MAX}), rows == one-row "
              f"launches; canaries untouched; planted faults (rank lanes past r, a column "
              f"read past N: rel {rel_f:.4f}, a store past N) caught", flush=True)
    print(f"kernel narrow times (device ms, CUDA graph) {json.dumps(out)}", flush=True)
    return out


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
    """The ragged table case's bound (``roofline.kernel_cost``: the
    committed keys and values of the slots with rows, the rows' q, k, v and
    output, the metadata, read or written once; the score and P.V
    operations of every real row)."""
    from repro_torch.launch.roofline import bound_ms, kernel_cost

    c = rc["att"]
    return bound_ms(kernel_cost("ragged_attention_kernel", t=rc["T"], h=c["H"], kv=c["KV"],
                                hd=c["hd"], b=c["B"], maxp=rc["bt"].shape[1],
                                slot=rc["slot_l"], pos=rc["pos_l"], ctx=rc["ctx_l"]))


def attention_phase(device, att: dict = ATT, ragged: bool = True) -> dict:
    """The paged-decode and ragged kernels against their plain versions at
    the heads and pools of ``att`` (llama3-8b's by default), timed beside
    the plain version and SDPA over a dense view; plus the
    stacked-vs-sequential identity of the paged kernel and the
    one-vs-two-launch identity of the ragged kernel. ``ragged=False``
    leaves the ragged kernel out (a family without a ragged step)."""
    import torch

    from repro_torch.kernels import build, contracts
    from repro_torch.kernels.paged_attention import paged_decode_kernel, paged_decode_ref
    from repro_torch.kernels.ragged_attention import ragged_attention_kernel, ragged_attention_ref
    from repro_torch.launch.roofline import bound_ms, kernel_cost

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
            t_b, by = bound_ms(kernel_cost("paged_decode_kernel", b=B, sq=sq, h=H, kv=KV, hd=hd,
                                           maxp=bt.shape[1], lens=DECODE_LENS, commit=commit))
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
    if not ragged:
        del pools
        torch.cuda.empty_cache()
        return table

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
# attention's rounding carried through the depth. Set at 1.25x the reading
# at the served depth, SERVE_LAYERS = 16: 0.0171 and 0.0168 on an H100
# (the f32 plain version alike: 0.0173, 0.0169; PERF.md section 4); it was
# 0.025 over 0.0200 at 32 layers. The argmax is not held: random weights
# leave the top two logits within that error.
RAGGED_BF16_REL_MAX = 0.0215
DEPTHS = (1, 2, 4, 8, 16, 32)


MODES = {
    "bucketed": {},
    "paged": dict(paged=True),
    "spec": dict(paged=True, speculation=True, spec_k=4),
    "ragged": dict(paged=True, ragged=True, token_budget=256),
}
# kernel-vs-plain prefill logits of the W4A16 model at the served depth (rel, one
# prompt): the kernel differs from the plain version only by the order of the
# sum inside a group, a bf16 ULP on some outputs of each linear, which random
# weights carry and grow through the depth. Set at about 1.5x the reading at
# SERVE_LAYERS = 16: 0.01500 and 0.01492 on an H100 (the plain version in
# the kernel's f32 order alike: 0.01466, 0.01494; PERF.md section 4); it
# was 0.03 over 0.0198 at 32 layers. qwen3-8b's 4 layers read 0.0102.
W4A16_LOGITS_REL_MAX = 0.023


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
              ("olmoe w4a4", "paged"), ("olmoe w4a16", "paged"), ("deepseek w4a4", "paged"),
              ("deepseek w4a16", "paged"), ("whisper w4a4", "paged"), ("whisper w4a16", "paged"),
              ("zamba2 w4a4", "paged"), ("zamba2 w4a16", "paged"), ("xlstm w4a4", "paged"),
              ("xlstm w4a16", "paged")}
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
        # the prompts a mode's run serves again alone (solo == interleaved)
        self.solo_held: dict = {}
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
        against the plain version; gated at the served depth."""
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
              + f" (limit at the served depth: kernel rel <= {W4A16_LOGITS_REL_MAX})",
              flush=True)
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
        held = ((len(self.prompts) - 1, 0) if cuda else (0,)) if mode == "ragged" else (
            self.solo_held.get(mode, (5,)))
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
# modes of RESUME_EQUAL (rows torch.equal): every mode, since readmission
# recomputes each row past the restored pages by the path that first wrote
# it (ragged: the unified step; paged and spec: the prompt rows by the
# prefill, the generated rows by decode steps, ContinuousBatchingEngine.
# _decode_rows); printed on the CPU. Every mode is gated on the copy-free
# restore itself (_RestoreCheck).
RESUME_REL_MAX = RAGGED_BF16_REL_MAX
RESUME_EQUAL = frozenset({"paged", "ragged", "spec"})
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
          f"prompt) {_depth_line(bf16_rows)} (limit at the served depth: ragged rel <= "
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

    # -- phase 15 (b): the cost model's count of a paged and a ragged step
    t_cost = time.perf_counter()
    cost_phase(device, card, cfg, qp, prompts[:8], max_len)
    cost_s = time.perf_counter() - t_cost
    if secs is not None:
        secs["cost"] = secs.get("cost", 0.0) + cost_s

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
    print(f"serve phase seconds: w4a4 {t5 - t4 - life_s - cost_s:.1f} "
          f"lifecycle {life_s:.1f} "
          f"w4a8 {t6 - t5:.1f} w4a16 {t7 - t6:.1f}", flush=True)
    return launches


# phase 15: the dry-run cells run in subprocesses (arch, shape, quant)
COST_DRYRUN = (("llama3-8b", "decode_32k", "w4a4"), ("llama3-8b", "train_4k", "bf16"))
COST_DRYRUN_TIMEOUT = 600


def start_dryrun(out_dir) -> list:
    """Start the ``COST_DRYRUN`` cells of ``python -m repro_torch.launch.dryrun``
    on (16, 16), one subprocess each (no collective check: the phase's time),
    writing under ``out_dir``; returns (cell, process) pairs."""
    import os

    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = []
    for arch, shape, quant in COST_DRYRUN:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
               shape, "--quant", quant, "--mesh", "single", "--out", str(out_dir),
               "--no-comm-check"]
        procs.append(((arch, shape, quant), subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    return procs


def finish_dryrun(procs) -> None:
    """Wait for the dry-run subprocesses (each stopped at
    ``COST_DRYRUN_TIMEOUT``); each must exit 0 and print ``status ok`` and
    its roofline terms."""
    try:
        for (arch, shape, quant), proc in procs:
            try:
                out, _ = proc.communicate(timeout=COST_DRYRUN_TIMEOUT)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, _ = proc.communicate()
                fail(f"cost (c) dry-run {arch} {shape} {quant}: past {COST_DRYRUN_TIMEOUT} s")
            lines = [ln for ln in out.splitlines() if "suboptimal" not in ln]
            for ln in lines:
                if ln.startswith(("[", "  roofline")):
                    print(f"cost (c) {ln.strip()}", flush=True)
            if proc.returncode != 0 or not any("status ok" in ln for ln in lines) \
                    or not any("roofline: compute=" in ln for ln in lines):
                fail(f"cost (c) dry-run {arch} {shape} {quant} exit {proc.returncode}: "
                     + " | ".join(lines[-8:]))
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _cost_table_line() -> None:
    """The seven table cases' bounds from ``roofline.kernel_cost``."""
    from repro_torch.launch.roofline import bound_ms, dual_pack_bytes, kernel_cost

    d, f, r = 4096, 14336, 128
    rows = {}
    for name, (lname, m) in DUAL_REP.items():
        k, seg_n = (f, (d,)) if lname == "down" else (d, (f, f))
        seg_r = (r,) * len(seg_n)
        rows[name] = bound_ms(kernel_cost(name, m=m, k=k, seg_n=seg_n, seg_r=seg_r,
                                          pack_bytes=dual_pack_bytes(k, seg_n, seg_r)))
    c = ATT
    rows["paged_decode_kernel"] = bound_ms(kernel_cost(
        "paged_decode_kernel", b=c["B"], sq=1, h=c["H"], kv=c["KV"], hd=c["hd"], maxp=c["maxp"],
        lens=DECODE_LENS, commit=False))
    slot_l, pos_l, _ = _ragged_rows(RAGGED_CTX, RAGGED_RUNS, 256)
    rows["ragged_attention_kernel"] = bound_ms(kernel_cost(
        "ragged_attention_kernel", t=256, h=c["H"], kv=c["KV"], hd=c["hd"], b=c["B"],
        maxp=c["maxp"], slot=slot_l, pos=pos_l, ctx=RAGGED_CTX))
    lname, m = W4A16_REP
    k, n = (f, d) if lname == "down" else (d, f)
    rows["w4a16_gemm"] = bound_ms(kernel_cost("w4a16_gemm", m=m, k=k, n=n))
    print("cost (a) kernel_cost bounds of the table cases: "
          + " ".join(f"{kname}={ms:.4f}({by})" for kname, (ms, by) in rows.items()), flush=True)


def _count_step(fn, buffers, restore, force_ref: bool) -> dict:
    from repro_torch.kernels import dispatch
    from repro_torch.launch.op_cost import analyze_step

    restore()
    prev = dispatch.set_force_ref(force_ref)
    try:
        return analyze_step(fn, **buffers)
    finally:
        dispatch.set_force_ref(prev)
        restore()


def cost_phase(device, card: str, cfg, qp, prompts, max_len: int = 2048) -> dict:
    """Phase 15 (b): one eager paged decode step and one ragged step of the
    served W4A4 model, counted through the kernels and under
    ``set_force_ref(True)`` from one state (equal key for key), beside the
    same step's replay device ms; a count with one kernel's cost left out
    must fail the equality. Returns {mode: (count, bound ms, replay ms)}."""
    import torch

    from repro_torch.kernels import cuda_launch, dispatch
    from repro_torch.launch.roofline import from_counts
    from repro_torch.launch.serve import ContinuousBatchingEngine, Request

    cuda = device.type == "cuda"
    out = {}
    launches, routes = cuda_launch.launch_counts(), dispatch.dispatch_counters()
    for mode, left_out in (("paged", "paged_decode_kernel"), ("ragged", "ragged_attention_kernel")):
        eng = ContinuousBatchingEngine(cfg, qp, batch_slots=8, max_len=max_len, device=device,
                                       **MODES[mode])
        for p in prompts:
            eng.submit(Request(p, max_new=32))
        for _ in range(CHECK_STEP):
            eng.step()
        _sync(device)
        sg = eng.step_graph
        snap = {"state": _clone_state(eng.state), "buffers": _clone_state(sg.buffers)}

        def restore():
            _restore_state(sg.buffers, snap["buffers"])
            _restore_state(eng.state, snap["state"])

        got = _count_step(sg.fn, sg.buffers, restore, False)
        forced = _count_step(sg.fn, sg.buffers, restore, True)
        differ = sorted(k for k in got if got[k] != forced[k])
        if differ or got["uncounted_calls"] or not got["kernels"]:
            fail(f"cost (b) {mode}: the count through the kernels != under set_force_ref(True) "
                 f"in {differ}, or {got['uncounted_calls']} routed calls uncounted")

        keep = dispatch._counted

        def without(name, cost, body):
            return body() if name == left_out else keep(name, cost, body)

        dispatch._counted = without
        try:
            planted = _count_step(sg.fn, sg.buffers, restore, False)
            planted_ref = _count_step(sg.fn, sg.buffers, restore, True)
        finally:
            dispatch._counted = keep
        caught = planted != planted_ref
        print(f"cost (b) planted fault ({mode}: {left_out}'s cost left out): counts equal "
              f"{not caught}, uncounted calls {planted['uncounted_calls']} -> "
              f"{'caught' if caught else 'MISSED'}", flush=True)
        if cuda and not caught:
            fail(f"cost (b) {mode}: a kernel cost left out passes the kernel == forced check")
        if not planted["uncounted_calls"]:
            fail(f"cost (b) {mode}: a kernel cost left out leaves no routed call uncounted")
        rf = from_counts(got, chips=1)
        bound = rf.bound_time * 1e3
        hw_flops = sum(sum(k["flops_by_class"].values()) for k in got["kernels"].values())
        hw_bytes = sum(k["bytes"] for k in got["kernels"].values())
        replay = _step_times(eng, snap)["replay_events_ms"] if cuda else float("nan")
        print(f"cost (b) {mode} step ({cfg.n_layers} layers, step {CHECK_STEP}): counts through "
              f"the kernels == under set_force_ref(True), key for key; flops by class "
              f"{json.dumps(got['flops_by_class'])} bytes={got['bytes']:.0f} ops={got['ops']} "
              f"kernel calls {json.dumps({k: v['calls'] for k, v in got['kernels'].items()})} "
              f"hand-written share flops={hw_flops / got['flops']:.4f} "
              f"bytes={hw_bytes / got['bytes']:.4f}; bound_ms={bound:.4f} "
              f"(t_compute_ms={rf.t_compute * 1e3:.4f} t_memory_ms={rf.t_memory * 1e3:.4f}, "
              f"{'operations' if rf.dominant == 'compute' else 'bytes'}) replay_ms={replay:.4f} "
              f"share_of_bound={bound / replay:.4f} card=\"{card}\"", flush=True)
        out[mode] = (got, bound, replay)
        del eng, snap, sg
    cuda_launch.reset_launch_counts()
    cuda_launch.add_launch_counts(launches)
    dispatch.reset_dispatch_counters()
    dispatch.add_dispatch_counts(routes)
    return out


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
# ms per step is the reading ((40, 40, 20) and (8, 8, 4) until the sharding
# phase came)
CALIB_STEPS_CUT = {"gate_up": (20, 20, 10), "down": (4, 4, 2)}
# twinquant in simulate_quantize_params (the phase's budget; (8, 8, 4)
# until the sharding phase came)
SIM_STEPS = (4, 4, 2)
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

# OLMoE-1B-7B's 16 layers cut to keep the whole script under ~1100 s (8
# until DeepSeek-V3's phase came, 4 until xLSTM-1.3B's, 2 until the sharding
# phase's; PERF.md section 4)
OLMOE_LAYERS = 1
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
# Cp of every stacked w4a16_gemm the served W4A16 runs launch (drop-free:
# decode 8, verify 32, ragged 256, the prefill buckets 8 .. 1024) and those of
# the dual kernels' panel beside them; the decode regime takes Cp <= 32, the
# 64 x 64 tile the rest
W4A16_MOE_CPS = MOE_GEMV_CPS + MOE_GEMM_CPS
W4A16_MOE_TABLE = ("down", 8)  # the stacked row for PERF.md: decode, the most launched
# no OLMoE width reaches the column-split schedule (N >= 8192): one case
# over a short expert axis takes it (E, K, N, Cps)
W4A16_COL_CASE = (4, 1024, 8192, (8, 32))


def _stacked_pack(gen, e, k, n, r, device):
    """An expert-stacked W4A4 pack: E experts' random (U, V, R), packed at once."""
    import torch

    from repro_torch.kernels.ref import pack_twinquant_weights

    def rnd(*shape, s):
        return torch.randn(*shape, generator=gen, device=device) * s

    return pack_twinquant_weights(rnd(e, k, r, s=0.1), rnd(e, r, n, s=0.1),
                                  rnd(e, k, n, s=0.05), a_bits=4, group=128)


def _swap_experts(w, a: int = 0, b: int = 1):
    """A copy of stacked pack ``w`` whose experts ``a`` and ``b`` swap their
    residual packs (``rp``): the planted fault of the expert axis."""
    rp = w.rp.clone()
    rp[[a, b]] = rp[[b, a]]
    return dataclasses.replace(w, rp=rp)


def _held_pack(gw, held):
    """The experts ``held`` (a list, or ``slice(None)`` for all) of stacked
    group pack ``gw``: the pack of the plain version's check."""
    if held == slice(None):
        return gw
    return dataclasses.replace(gw, **{f: getattr(gw, f)[held] for f in ("up", "us", "rp", "rs")},
                               vps=tuple(v[held] for v in gw.vps),
                               vss=tuple(v[held] for v in gw.vss))


def moe_kernel_phase(device, cfg, packs=None, lib=None, cps=(MOE_GEMV_CPS, MOE_GEMM_CPS),
                     sample=None, a_bits=(4, 8), table_cp=MOE_TABLE_CP,
                     time_all: bool = True) -> dict:
    """The four dual kernels on expert-stacked packs: ``packs`` (gate_up,
    down), or random ones at ``cfg``'s widths (OLMoE: E = 64, gate_up 2048
    -> 2 x 1024 fused, down 1024 -> 2048, rank 128, group 128). GEMV at Cp
    in ``cps[0]`` and GEMM at ``cps[1]``, at each of ``a_bits``: each
    stacked launch, expert by expert, ``torch.equal`` to one-expert
    launches, and for the experts ``sample`` (None: all) to the stacked
    plain version; experts 0 and 1 with their ``rp`` swapped must fail that
    check. Timed at ``a_bits[0]``, at every Cp or (``time_all`` false) at
    ``table_cp``'s: device ms from a CUDA graph, host µs, the plain version
    over the sampled experts, bf16 ``torch.bmm`` of the same (E, Cp, K) x
    (E, K, N) (``lib``: {"gate_up" | "down": the bf16 stacks}, else one
    random one), the bound. Returns each wrapper's row for the table (at
    ``table_cp``)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.twinquant_dual_gemm import dual_gemm, dual_gemm_group
    from repro_torch.kernels.twinquant_dual_gemv import dual_gemv, dual_gemv_group

    gen = torch.Generator(device=device).manual_seed(7)
    if packs is None:
        e, d, f, r = cfg.n_experts, cfg.d_model, cfg.d_ff_expert, 128
        down = _stacked_pack(gen, e, f, d, r, device)
        gate_up = ref.fuse_twinquant_weights([_stacked_pack(gen, e, d, f, r, device)
                                              for _ in range(2)])
    else:
        gate_up, down = packs
    cases = {"dual_gemv": (dual_gemv, "down", down, cps[0]),
             "dual_gemv_group": (dual_gemv_group, "gate_up", gate_up, cps[0]),
             "dual_gemm": (dual_gemm, "down", down, cps[1]),
             "dual_gemm_group": (dual_gemm_group, "gate_up", gate_up, cps[1])}
    table = {}
    for name, (kern, lname, w, kcps) in cases.items():
        gw = w if isinstance(w, ref.TwinQuantGroupWeights) else ref.as_group(w)
        e, k, n = gw.experts, gw.kdim, gw.ndim_out
        held = slice(None) if sample is None else [i % e for i in sample]
        n_held = e if sample is None else len(held)
        wbs = (lib[lname] if lib else
               [torch.randn(e, k, n, generator=gen, device=device, dtype=torch.bfloat16)])
        worst = 0.0
        for bits in a_bits:
            wa = dataclasses.replace(w, a_bits=bits)
            gsa = dataclasses.replace(_held_pack(gw, held), a_bits=bits)
            w_f = _swap_experts(wa)
            for cp in kcps:
                x = (torch.randn(e, cp, k, generator=gen, device=device) * 2).to(torch.bfloat16)
                xs = x[held].contiguous()
                y_k, y_p = kern(x, wa), ref.dual_gemm_group_ref(xs, gsa)
                _sync(device)
                worst = max(worst, (y_k[held].float() - y_p.float()).abs().max().item())
                what = f"{name} stacked {lname} E={e} Cp={cp} a_bits={bits}"
                if not torch.equal(y_k[held], y_p):
                    fail(f"{what}: kernel != plain version ({_unequal(y_k[held], y_p)})")
                alone = torch.stack([kern(x[i], wa.expert(i)) for i in range(e)])
                if not torch.equal(alone, y_k):
                    bad = int((alone != y_k).flatten(1).any(dim=1).sum())
                    fail(f"{what}: {bad} experts differ from one-expert launches")
                del alone
                y_f = kern(x, w_f)
                _sync(device)
                caught = not torch.equal(y_f[held], y_p)
                print(f"kernel planted fault ({what}: experts 0 and 1 swap rp) -> "
                      f"{'caught' if caught else 'MISSED'}; experts 0, 1 differ: "
                      f"{not torch.equal(y_f[:2], y_k[:2])}, experts 2.. equal: "
                      f"{torch.equal(y_f[2:], y_k[2:])}", flush=True)
                if not caught:
                    fail(f"{name} stacked E={e}: swapped experts' rp passes the equality check")
                del y_f, y_k, y_p
                if bits != a_bits[0] or not (time_all or cp == table_cp[name]):
                    continue
                t_k = graph_ms(lambda: kern(x, wa))
                t_h = host_us(lambda: kern(x, wa))
                t_p = cuda_ms(lambda: ref.dual_gemm_group_ref(xs, gsa), iters=1, warmup=0)
                t_lib = cuda_ms(lambda: [torch.bmm(x, wb) for wb in wbs], iters=20)
                t_b, by = bound(cp, k, gw)  # every expert's Cp rows, the whole stack
                print(f"kernel {name:16s} stacked {lname:8s} E={e} Cp={cp:4d} K={k:5d} N={n:5d} "
                      f"equal, experts == one-expert launches device_ms={t_k:.4f} "
                      f"host_us={t_h:.1f} plain_ms({n_held} experts)={t_p:.4f} "
                      f"bf16_bmm_ms={t_lib:.4f} bound_ms={t_b:.4f} ({by}) "
                      f"share={t_b / t_k:.3f} vs_bmm={t_k / t_lib:.2f}x", flush=True)
                if cp == table_cp[name]:
                    table[name] = dict(ms=t_k, host_us=t_h, plain_ms=t_p, plain_experts=n_held,
                                       library_ms=t_lib, bound_ms=t_b, bound_by=by, cp=cp,
                                       experts=e)
            del w_f
        print(f"kernel {name:16s} stacked {lname} E={e} a_bits={list(a_bits)} equal at "
              f"Cp={list(kcps)} (plain version: {n_held} experts)", flush=True)
        table[name]["max_abs_err"] = worst
        del wbs
        torch.cuda.empty_cache()
    return table


def _swap_expert_packs(wp, a: int = 0, b: int = 1):
    """A copy of stacked ``wp`` whose experts ``a`` and ``b`` trade packs:
    the planted fault of ``w4a16_gemm``'s expert axis."""
    out = wp.clone()
    out[[a, b]] = out[[b, a]]
    return out


def _stacked_w4a16_pack(gen, e: int, k: int, n: int, device, chunk: int = 16):
    """An expert-stacked W4A16 pack of E random (K, N) weights, made
    ``chunk`` experts at a time (a DeepSeek-V3 stack is 15 GB in f32)."""
    import torch

    from repro_torch.kernels import ref

    wps, wss = [], []
    for i in range(0, e, chunk):
        wq, ws = ref.quantize_rows_ref(
            torch.randn(min(chunk, e - i), k, n, generator=gen, device=device) * 0.05, 128, 4)
        wps.append(ref.pack_rows_groupsplit(wq, 128))
        wss.append(ws)
        del wq
    return torch.cat(wps), torch.cat(wss)


def stacked_w4a16_phase(device, cfg, cps=W4A16_MOE_CPS, col=W4A16_COL_CASE, sample=None,
                        time_all: bool = True) -> dict:
    """``w4a16_gemm`` on random expert-stacked packs at ``cfg``'s widths
    (OLMoE: E = 64, gate/up 2048 -> 1024, down 1024 -> 2048, group 128) at
    every Cp in ``cps`` (the decode schedule up to 32 rows, the 64 x 64
    tile above), and the column-split schedule at ``col`` (None: none):
    each stacked launch's rows, for the experts ``sample`` (None: all), at
    rel <= ``W4A16_REL_MAX`` against the f32 plain version and within
    ``W4A16_TOL`` of the bf16 one; every expert's slice ``torch.equal`` to
    that expert launched alone; experts 0 and 1 with their packs swapped
    must fail that check. Timed at every Cp or (``time_all`` false) at
    ``W4A16_MOE_TABLE``: device ms from a CUDA graph, host µs, the plain
    version over the sampled experts, one bf16 ``torch.bmm`` of the same
    (E, Cp, K) x (E, K, N), the bound. Returns the stacked row at
    ``W4A16_MOE_TABLE``."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.w4a16_gemm import w4a16_gemm

    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    gen = torch.Generator(device=device).manual_seed(11)
    row, worst_err, worst_rel = None, 0.0, 0.0
    cases = [("gate/up", e, d, f, cps), ("down", e, f, d, cps)]
    if col is not None:
        cases.append(("column", *col))
    for lname, ee, k, n, kcps in cases:
        held = slice(None) if sample is None else [i % ee for i in sample]
        n_held = ee if sample is None else len(held)
        wp, ws = _stacked_w4a16_pack(gen, ee, k, n, device)
        wp_h, ws_h = wp[held], ws[held]
        wp_f = _swap_expert_packs(wp)
        wb = torch.randn(ee, k, n, generator=gen, device=device, dtype=torch.bfloat16)
        for cp in kcps:
            x = (torch.randn(ee, cp, k, generator=gen, device=device) * 2).to(torch.bfloat16)
            xs = x[held]
            y_k = w4a16_gemm(x, wp, ws)
            y32 = ref.w4a16_gemm_f32(xs, wp_h, ws_h)
            y_p = y32.to(torch.bfloat16)  # the bf16 plain version
            _sync(device)
            err = (y_k[held].float() - y_p.float()).abs().max().item()
            rel = _rel_rows(y_k[held], y32).max().item()
            worst_err, worst_rel = max(worst_err, err), max(worst_rel, rel)
            name = f"w4a16_gemm stacked {lname} E={ee} Cp={cp}"
            if not torch.allclose(y_k[held].float(), y_p.float(), **W4A16_TOL):
                fail(f"{name}: kernel vs plain version beyond atol {W4A16_TOL['atol']} / rtol "
                     f"{W4A16_TOL['rtol']} (max |d| {err})")
            if not rel <= W4A16_REL_MAX:
                fail(f"{name}: kernel vs f32 plain version rel {rel} per row > {W4A16_REL_MAX}")
            alone = torch.stack([w4a16_gemm(x[i], wp[i], ws[i]) for i in range(ee)])
            if not torch.equal(alone, y_k):
                bad = int((alone != y_k).flatten(1).any(dim=1).sum())
                fail(f"{name}: {bad} experts differ from one-expert launches")
            y_f = w4a16_gemm(x, wp_f, ws)
            _sync(device)
            caught = not torch.equal(y_f, alone)
            print(f"kernel planted fault ({name}: experts 0 and 1 swap packs) -> "
                  f"{'caught' if caught else 'MISSED'}; experts 0, 1 differ: "
                  f"{not torch.equal(y_f[:2], alone[:2])}, experts 2.. equal: "
                  f"{torch.equal(y_f[2:], alone[2:])}", flush=True)
            if not caught:
                fail(f"{name}: swapped experts' packs pass the equality check")
            del alone, y_f
            if not (time_all or (lname, cp) == W4A16_MOE_TABLE):
                print(f"kernel w4a16_gemm        stacked {lname:8s} E={ee} Cp={cp:4d} K={k:5d} "
                      f"N={n:5d} close max_abs_err={err:.5f} max_rel={rel:.5f} (limit "
                      f"{W4A16_REL_MAX}; plain version: {n_held} experts) experts == "
                      f"one-expert launches", flush=True)
                continue
            t_k = graph_ms(lambda: w4a16_gemm(x, wp, ws))
            t_h = host_us(lambda: w4a16_gemm(x, wp, ws))
            t_p = cuda_ms(lambda: ref.w4a16_gemm_ref(xs, wp_h, ws_h), iters=1, warmup=0)
            t_lib = cuda_ms(lambda: torch.bmm(x, wb), iters=20)
            t_b, by = w4a16_bound(cp, k, n, experts=ee)
            print(f"kernel w4a16_gemm        stacked {lname:8s} E={ee} Cp={cp:4d} K={k:5d} "
                  f"N={n:5d} close max_abs_err={err:.5f} max_rel={rel:.5f} (limit "
                  f"{W4A16_REL_MAX}) experts == one-expert launches device_ms={t_k:.4f} "
                  f"host_us={t_h:.1f} plain_ms({n_held} experts)={t_p:.4f} "
                  f"bf16_bmm_ms={t_lib:.4f} bound_ms={t_b:.4f} ({by}) share={t_b / t_k:.3f} "
                  f"vs_bmm={t_k / t_lib:.2f}x", flush=True)
            if (lname, cp) == W4A16_MOE_TABLE:
                row = dict(ms=t_k, host_us=t_h, plain_ms=t_p, plain_experts=n_held,
                           library_ms=t_lib, bound_ms=t_b, bound_by=by, cp=cp, experts=ee)
        del wp, ws, wp_h, ws_h, wp_f, wb
        torch.cuda.empty_cache()
    print(f"kernel w4a16_gemm stacked E={e} close and experts == one-expert launches at "
          f"Cp={list(cps)}" + (f" (column schedule: E={col[0]} Cp={list(col[3])})" if col else "")
          + f"; max rel per row {worst_rel:.5f} (limit {W4A16_REL_MAX})", flush=True)
    return dict(max_abs_err=worst_err, **row)


class MoEServed(Served):
    """An OLMoE model served as :class:`Served` does, its linears checked as
    one stacked launch per (layer, linear call): every model call (a decode,
    verify or ragged step, a prefill) runs, W4A4, q/k/v (fused), o, the
    experts' gate/up (fused) and down, each one dual launch for all experts;
    W4A16, ``w4a16_gemm`` seven times a layer (q, k, v, o and the experts'
    stacked gate, up and down: W4A16 siblings are never fused)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.host_step_ms: dict = {}

    def _against_eager(self, mode, reqs, got, routes, eng) -> None:
        """No whole-run eager twin: the graph step is held to the eager step
        bit for bit (``_step_check``), and an eager run of each mode (~6 s on
        an H100 at 2.5k launches a step) would add ~25 s to a script held to
        1200 s."""

    def _linears(self, mode, eng, got, routes) -> None:
        self.host_step_ms[mode] = _step_ms(eng, mode)
        if self.kind == "w4a16":  # 7 launches a layer: q, k, v, o, experts gate, up, down
            super()._linears(mode, eng, got, routes)
            return
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

    cfg, L = served.cfg, served.cfg.n_layers - served.cfg.first_k_dense  # MoE layers a call
    log: list = []
    eng = served.engine("paged", step_graphs=False)
    reqs = served.requests()
    moe_layer.record_drops(log)
    try:
        _drive(f"{served.tag} paged capacity_factor={cfg.capacity_factor}", eng, reqs, device, L)
    finally:
        moe_layer.record_drops(None)
    by_t: dict = {}
    for i in range(0, len(log), L):  # one model call: one MoE call a MoE layer, of one T
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


def _chunked_pack_check(lin, packed, spec, experts: int = 8) -> None:
    """The expert stack ``lin`` packed ``experts`` at a time (the packer's
    chunk cut to that many experts' f32) must be ``packed``, the stack's
    pack made in one batch, bit for bit."""
    import torch

    from repro_torch.core import twinquant

    keep = twinquant.EXPERT_CHUNK_BYTES
    twinquant.EXPERT_CHUNK_BYTES = experts * lin.w.shape[-2] * lin.w.shape[-1] * 4
    try:
        chunked = twinquant._pack_one(lin, spec)
    finally:
        twinquant.EXPERT_CHUNK_BYTES = keep
    names = ("up", "us", "vp", "vs", "rp", "rs")
    differ = [n for n in names if not torch.equal(getattr(chunked, n), getattr(packed, n))]
    if differ:
        fail(f"expert stack packed {experts} experts at a time != one batch: {differ}")
    print(f"pack expert stack E={lin.w.shape[0]} K={lin.w.shape[1]} N={lin.w.shape[2]} packed "
          f"{experts} experts at a time == one batch: {', '.join(names)} equal", flush=True)


def olmoe_phase(device, card: str, cfg, prompt_lens=PROMPT_LENS, max_len: int = 2048,
                rank: int = 128) -> dict:
    """OLMoE-1B-7B at full width (``cfg``'s depth), random weights from seed
    0: the stacked dual kernels and ``w4a16_gemm`` (``moe_kernel_phase``),
    the attention kernels at one query head per KV head, then W4A4 packs
    (quantized once, fused) served in the four modes at ``OLMOE_CF``
    (drop-free) with the serve phase's checks (routes, one stacked launch
    per linear call, one capture, solo == interleaved, spec == paged, graph
    step == eager step), paged and ragged again under the sanitizers, one
    paged run at the published capacity factor, and the W4A16 packs (the
    experts stacked, every linear one ``w4a16_gemm`` launch) served in the
    four modes with the same checks. Returns the kernel and attention
    tables."""
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
    tables["stacked"]["w4a16_gemm"] = stacked_w4a16_phase(device, cfg)
    t1 = time.perf_counter()
    tables["attention"] = attention_phase(device, OLMOE_ATT)
    t2 = time.perf_counter()
    params = olmoe.init_params(cfg, seed=0, device=device)
    bf16_bytes = _param_bytes(params)
    qp16 = quantize_params(params, cfg, QuantSpec("w4a16"))
    _sync(device)
    t3 = time.perf_counter()
    qp = quantize_params(params, cfg, QuantSpec("w4a4", rank=rank, group_size=128))
    _sync(device)
    t4 = time.perf_counter()
    _chunked_pack_check(params.layers[0].moe.experts["down"], qp.layers[0].moe.experts["down"],
                        QuantSpec("w4a4", rank=rank, group_size=128))
    del params
    torch.cuda.empty_cache()
    qp = fuse_params(qp)
    total, active = olmoe.count_params(cfg)
    print(f"olmoe params total={total} active={active} param_bytes bf16={bf16_bytes} "
          f"w4a4={_param_bytes(qp)} ({bf16_bytes / _param_bytes(qp):.2f}x) "
          f"w4a16={_param_bytes(qp16)}; init+w4a16_quantize_s={t3 - t2:.2f} "
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
    w16 = MoEServed("olmoe w4a16", cfg.replace(capacity_factor=OLMOE_CF), qp16, "w4a16",
                    prompts, device, max_len)
    for mode in MODES:
        w16.serve(mode, against_eager=True)
    for mode, times in w16.step_times.items():
        times["busy_share_graph"] = ((times["graph_kernel_ms"] or times["replay_events_ms"])
                                     / w16.host_step_ms[mode])
        print(f"serve step times {json.dumps({'setting': w16.tag, 'mode': mode, **times})}",
              flush=True)
    launches.update(w16.launches)
    del w16, qp16
    torch.cuda.empty_cache()
    t8 = time.perf_counter()
    print(f"olmoe phase seconds: stacked kernels {t1 - t0:.1f} attention {t2 - t1:.1f} "
          f"init+quantize {t5 - t2:.1f} serve {t6 - t5:.1f} capacity_1.25 {t7 - t6:.1f} "
          f"w4a16_serve {t8 - t7:.1f}", flush=True)
    print(f"olmoe tables {json.dumps({**tables, 'launches': launches})}", flush=True)
    return tables


# ---------------------------------------------------------------------------
# phase 8: the other dense configs and the VLM family at full width
# ---------------------------------------------------------------------------

# depth of each config's run, cut to keep the whole script under ~1100 s
# (qwen2-1.5b whole until DeepSeek-V3's phase came, stablelm-12b 4 until
# xLSTM-1.3B's; qwen2-1.5b 14, phi4-mini-3.8b 6, internlm2-1.8b and
# internvl2-2b 8 until the training phase came; 7, 3, 4 and 4 until the
# sharding phase's; PERF.md section 4)
DENSE_LAYERS = {"qwen2-1.5b": 4, "stablelm-12b": 2, "phi4-mini-3.8b": 2,
                "internlm2-1.8b": 2, "internvl2-2b": 2}
# the engine modes each config is served in (paged, with the prefix cache,
# unless named here)
DENSE_MODES = {"qwen2-1.5b": ("paged", "ragged"), "internvl2-2b": ("bucketed", "paged")}


class DenseServed(Served):
    """A W4A4 dense model served as :class:`Served` does, with its dual
    launches counted in every mode: each model call runs qkv (fused), o,
    gate_up (fused) and down, four launches a layer."""

    def _linears(self, mode, eng, got, routes) -> None:
        super()._linears(mode, eng, got, routes)
        L, cuda = self.cfg.n_layers, self.device.type == "cuda"
        calls = eng.stats["decode_steps"] + eng.compile_stats()["prefill_calls"]
        want = 4 * L * calls
        n_routes = sum(v for key, v in routes.items() if key.startswith("dual"))
        n_launch = sum(got.get(kname, 0) for kname in MOE_KERNELS)
        if n_routes != want or (cuda and n_launch != want):
            fail(f"{self.tag} {mode}: {n_routes} dual routes and {n_launch} launches, want "
                 f"{want} (4 x {L} layers x {calls} model calls): {routes} {got}")
        print(f"serve {self.tag} {mode} dual launches={n_launch} == 4 x {L} layers x {calls} "
              f"model calls (qkv, o, gate_up, down)", flush=True)


class VLMServed(DenseServed):
    """The ``vlm`` family served as :class:`DenseServed` does, every request
    carrying its own seeded patch set (``Request.frontend``): checks that no
    engine looks up the prefix cache, and that the patches reach the model
    (two patch sets, two different first logits)."""

    def __init__(self, *args, patches, **kwargs):
        super().__init__(*args, **kwargs)
        self.patches = patches
        self.engines: list = []

    def request(self, i):
        req = super().request(i)
        req.frontend = {"patches": self.patches[i]}
        return req

    def engine(self, mode, **kw):
        import warnings

        with warnings.catch_warnings():  # paged vlm: no prefix cache, by design
            warnings.simplefilter("ignore")
            eng = super().engine(mode, **kw)
        self.engines.append(eng)
        return eng

    def prefill_logits(self) -> None:
        """Kernel vs plain logits (equal) of one prompt behind its patches,
        and the same prompt behind another patch set (must differ)."""
        import torch

        from repro_torch.kernels import dispatch
        from repro_torch.models import dense

        toks = torch.as_tensor(self.prompts[4][None, :], device=self.device, dtype=torch.long)

        def logits(patches, plain=False):
            state = dense.init_decode_state(self.cfg, 1, toks.shape[1] + self.cfg.n_patches,
                                            device=self.device)
            prev = dispatch.set_force_ref(plain)
            try:
                return dense.prefill(self.qp, self.cfg, toks, state, patches=patches)[0].float()
            finally:
                dispatch.set_force_ref(prev)

        lk, lp = logits(self.patches[4]), logits(self.patches[4], plain=True)
        if not torch.equal(lk, lp):
            fail(f"{self.tag}: prefill logits through the kernels != plain versions (max |d| "
                 f"{(lk - lp).abs().max().item()})")
        other = logits(self.patches[5])
        rel = (torch.linalg.norm(other - lk) / torch.linalg.norm(lk)).item()
        if torch.equal(other, lk):
            fail(f"{self.tag}: two patch sets give the same first logits")
        print(f"serve {self.tag} prefill logits kernel == plain: equal ({self.cfg.n_patches} "
              f"patch rows + {toks.shape[1]} tokens); another patch set: rel {rel:.4f} (differ)",
              flush=True)

    def serve(self, mode, against_eager: bool = False) -> list:
        reqs = super().serve(mode, against_eager)
        looked = [eng.stats["prefix_lookups"] for eng in self.engines]
        if any(looked) or any(eng.prefix_cache is not None for eng in self.engines):
            fail(f"{self.tag} {mode}: frontend requests looked up the prefix cache: {looked}")
        print(f"serve {self.tag} {mode} prefix_lookups == 0 in {len(self.engines)} engines "
              f"(frontend requests skip the prefix cache)", flush=True)
        return reqs


def dense_phase(device, card: str, prompt_lens=PROMPT_LENS, max_len: int = 2048,
                rank: int = 128) -> dict:
    """Each config of ``DENSE_LAYERS`` at full width and that depth, random
    weights from seed 0, W4A4 packs (rank 128, group 128, fused) served in
    its ``DENSE_MODES`` with the serve phase's checks (kernel-vs-plain
    logits, routes, four dual launches a layer a model call, the attention
    kernel once a layer a step, one capture, solo == interleaved, page
    invariants); ``internvl2-2b`` with a seeded patch set per request
    (``VLMServed``). Before each new (heads, KV heads, head_dim) the
    attention kernels at it (``attention_phase``). Returns the attention
    tables by head shape."""
    import numpy as np
    import torch

    from repro_torch.configs import QuantSpec, get_config
    from repro_torch.core.twinquant import fuse_params, quantize_params
    from repro_torch.models import dense

    tables, secs = {}, {}
    for name, layers in DENSE_LAYERS.items():
        t0 = time.perf_counter()
        full = get_config(name)
        cfg = full.replace(n_layers=layers)
        heads = f"H={cfg.n_heads},KV={cfg.n_kv_heads},hd={cfg.head_dim}"
        print(f"dense config {name} family={cfg.family} d_model={cfg.d_model} heads="
              f"{cfg.n_heads}/{cfg.n_kv_heads} (g={cfg.n_heads // cfg.n_kv_heads}) head_dim="
              f"{cfg.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab} padded_vocab={cfg.padded_vocab} "
              f"qkv_bias={cfg.qkv_bias} rope_fraction={cfg.rope_fraction} tied="
              f"{cfg.tie_embeddings} n_patches={cfg.n_patches} n_layers={layers} (of "
              f"{full.n_layers}) card=\"{card}\"", flush=True)
        if heads not in tables:
            tables[heads] = attention_phase(device, dict(B=8, H=cfg.n_heads, KV=cfg.n_kv_heads,
                                                         hd=cfg.head_dim, page=16, maxp=128))
        t1 = time.perf_counter()
        params = dense.init_params(cfg, seed=0, device=device)
        qp = fuse_params(quantize_params(params, cfg, QuantSpec("w4a4", rank=rank,
                                                                group_size=128)))
        del params
        _sync(device)
        t2 = time.perf_counter()
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in prompt_lens]
        tag = f"{name} w4a4"
        if cfg.family == "vlm":
            gen = torch.Generator(device=device).manual_seed(5)
            patches = [torch.randn(1, cfg.n_patches, cfg.d_model, generator=gen,
                                   device=device).to(torch.bfloat16) for _ in prompts]
            served = VLMServed(tag, cfg, qp, "w4a4", prompts, device, max_len, patches=patches)
        else:
            served = DenseServed(tag, cfg, qp, "w4a4", prompts, device, max_len)
        served.prefill_logits()
        for mode in DENSE_MODES.get(name, ("paged",)):
            served.serve(mode)
        del served, qp
        torch.cuda.empty_cache()
        t3 = time.perf_counter()
        secs[name] = dict(attention=round(t1 - t0, 1), init_quantize=round(t2 - t1, 1),
                          serve=round(t3 - t2, 1))
        print(f"dense {name} seconds {json.dumps(secs[name])}", flush=True)
    print(f"dense tables {json.dumps(tables)}", flush=True)
    return tables


# ---------------------------------------------------------------------------
# phase 9: DeepSeek-V3 at full width (MLA over latent page pools, 256 routed
# experts and a shared expert through the stacked dual kernels)
# ---------------------------------------------------------------------------

# DeepSeek-V3's 61 layers cut to one dense and one MoE layer (first_k_dense
# 1 of 2: the reference's REDUCED ratio); one MoE layer's experts are 11.3 G
# parameters, 22.5 GB in bf16
DEEPSEEK_LAYERS = 2
DEEPSEEK_CF = 32.0  # capacity_factor at which nothing drops: Cp >= T at E / top_k = 32
DEEPSEEK_MODES = ("bucketed", "paged")  # the reference serves mla_moe neither ragged nor spec
DS_EXPERTS = (0, 1, -1)  # experts held to the plain version (-1: the last)
# Cp of every stacked launch the served runs give the dual kernels: 8 (decode,
# the bucket 8, a prefix hit's suffix: GEMV); at DEEPSEEK_CF (Cp = T) the
# buckets 32, 64, 512, 1024; at the published 1.25 the buckets 512 and 1024
# give 24 and 40 (the others 8)
DS_GEMV_CPS = (8,)
DS_GEMM_CPS = (24, 32, 40, 64, 512, 1024)
DS_TABLE_CP = {"dual_gemv": 8, "dual_gemv_group": 8, "dual_gemm": 512, "dual_gemm_group": 512}
# the stacked dual kernels on the served W4A4 experts: a_bits 4 only, the
# plain version over DS_EXPERTS, timed at DS_TABLE_CP
DS_KERNEL_RUN = dict(cps=(DS_GEMV_CPS, DS_GEMM_CPS), sample=DS_EXPERTS, a_bits=(4,),
                     table_cp=DS_TABLE_CP, time_all=False)
# Cp of every stacked w4a16_gemm the served W4A16 runs launch (drop-free, no
# speculation or ragged steps: decode and the prefill buckets)
DS_W4A16_CPS = (8, 32, 64, 512, 1024)
# rows of the 2-D linears' checks: every M serving gives them (decode 8, the
# prefill buckets 8 .. 1024, a prefix hit's suffix in bucket 8)
DS_LINEAR_MS = (8, 32, 64, 512, 1024)


def ds_linears_phase(device, qp, qp16) -> None:
    """The 2-D linears of the served models through the kernels at M in
    ``DS_LINEAR_MS``: W4A4 (``qp``: the dense layer's ``wqkv_a`` group (K
    7168, N 1536 + 576), ``wq_b`` (K 1536), ``o`` (K 16384), ``gate_up`` (K
    7168) and ``down`` (K 18432); the MoE layer's shared expert) each
    ``torch.equal`` to its plain version; W4A16 (``qp16``: the same linears,
    ``wq_a``, ``wkv_a``, ``gate`` and ``up`` apart) each at rel <=
    ``W4A16_REL_MAX`` per row against the f32 plain version and within
    ``W4A16_TOL`` of the bf16 one."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.twinquant_dual_gemm import dual_gemm, dual_gemm_group
    from repro_torch.kernels.twinquant_dual_gemv import dual_gemv, dual_gemv_group
    from repro_torch.kernels.w4a16_gemm import w4a16_gemm

    def linears(model):
        dense, moe = model.layers[0], model.layers[-1]
        return {**{f"attn {k}": m for k, m in dense.attn.items() if k != "wkv_b"},
                **{f"mlp {k}": m for k, m in dense.mlp.items()},
                **{f"shared {k}": m for k, m in moe.moe.shared.items()}}

    gen = torch.Generator(device=device).manual_seed(17)
    for lname, mod in linears(qp).items():
        w = mod.weights()
        group = isinstance(w, ref.TwinQuantGroupWeights)
        gw = w if group else ref.as_group(w)
        for m in DS_LINEAR_MS:
            kern = ((dual_gemv_group if group else dual_gemv) if m <= 8 else
                    (dual_gemm_group if group else dual_gemm))
            x = (torch.randn(m, gw.kdim, generator=gen, device=device) * 2).to(torch.bfloat16)
            y_k, y_p = kern(x, w), ref.dual_gemm_group_ref(x, gw)
            _sync(device)
            if not torch.equal(y_k, y_p):
                fail(f"deepseek {lname} M={m}: kernel != plain version ({_unequal(y_k, y_p)})")
        print(f"kernel deepseek w4a4  {lname:14s} K={gw.kdim:5d} N={list(gw.seg_n)} r={gw.rank} "
              f"M={list(DS_LINEAR_MS)}: kernel == plain", flush=True)
    for lname, mod in linears(qp16).items():
        k, n = mod.wp.shape[0] * 2, mod.wp.shape[1]
        worst = 0.0
        for m in DS_LINEAR_MS:
            x = (torch.randn(m, k, generator=gen, device=device) * 2).to(torch.bfloat16)
            y_k, y32 = w4a16_gemm(x, mod.wp, mod.ws), ref.w4a16_gemm_f32(x, mod.wp, mod.ws)
            _sync(device)
            rel = _rel_rows(y_k, y32).max().item()
            worst = max(worst, rel)
            if not torch.allclose(y_k.float(), y32.to(torch.bfloat16).float(), **W4A16_TOL):
                fail(f"deepseek w4a16 {lname} M={m}: kernel vs plain version beyond atol "
                     f"{W4A16_TOL['atol']} / rtol {W4A16_TOL['rtol']}")
            if not rel <= W4A16_REL_MAX:
                fail(f"deepseek w4a16 {lname} M={m}: kernel vs f32 plain version rel {rel} per "
                     f"row > {W4A16_REL_MAX}")
        print(f"kernel deepseek w4a16 {lname:14s} K={k:5d} N={n:5d} M={list(DS_LINEAR_MS)}: "
              f"close, max rel per row {worst:.5f} (limit {W4A16_REL_MAX})", flush=True)


class DeepSeekServed(MoEServed):
    """A DeepSeek-V3 model served as :class:`MoEServed` does: W4A4, every
    model call five dual launches in a dense layer (``wqkv_a``, ``wq_b``,
    ``o``, ``gate_up``, ``down``) and seven in a MoE layer (the three MLA
    ones, the experts' ``gate_up`` and ``down``, one launch each for all
    experts, and the shared expert's ``gate_up`` and ``down``); W4A16
    ``w4a16_gemm`` seven and ten times (MLA's four: ``wq_a``, ``wkv_a``,
    ``wq_b``, ``o``; W4A16 siblings are never fused). MLA attends in plain
    PyTorch over its latent cache or pools: no attention kernel."""

    def _linears(self, mode, eng, got, routes) -> None:
        self.host_step_ms[mode] = _step_ms(eng, mode)
        cfg, cuda = self.cfg, self.device.type == "cuda"
        nd, nm = cfg.first_k_dense, cfg.n_layers - cfg.first_k_dense
        name = f"{self.tag} {mode}"
        calls = eng.stats["decode_steps"] + eng.compile_stats()["prefill_calls"]
        w16 = self.kind == "w4a16"
        per = (7 * nd + 10 * nm) if w16 else (5 * nd + 7 * nm)
        kinds = ("w4a16_gemm",) if w16 else MOE_KERNELS
        want = per * calls
        n_routes = sum(v for key, v in routes.items() if key.startswith("w4a16" if w16 else "dual"))
        n_launch = sum(got.get(k, 0) for k in kinds)
        if n_routes != want or any(not key.startswith("w4a16" if w16 else "dual")
                                   for key in routes):
            fail(f"{name}: want {want} routes ({per} a model call x {calls}), routes {routes}")
        if cuda and n_launch != want:
            fail(f"{name}: {kinds} launched {n_launch} times, want one per linear call: {want} "
                 f"({got})")
        if mode == "bucketed":
            for kname in kinds:
                if cuda and got.get(kname, 0) <= 0:
                    fail(f"kernel {kname} never launched on the {name} path")
                self.launches[kname] = got.get(kname, 0)
        print(f"serve {name} launches={n_launch} == ({per} a model call: {nd} dense + {nm} MoE "
              f"layers) x {calls} model calls; the experts' linears one launch for all "
              f"{cfg.n_experts} experts; host_step_ms={_step_ms(eng, mode):.3f} pages_peak="
              f"{eng.memory().get('pages_peak', 'dense cache')}", flush=True)

    def _attention(self, mode, eng, got, routes) -> None:
        """MLA launches no attention kernel (checked by ``_linears``' routes)."""

    def prefix_check(self) -> None:
        """A request whose first 256 tokens are another's prompt prefix hits
        the prefix cache (16 pages: the suffix prefill over the expanded
        latent prefix) and gets the tokens of a cold run of itself."""
        import numpy as np

        from repro_torch.launch.serve import Request

        first = self.prompts[8]
        second = np.concatenate([first[:256], self.prompts[1][:5]])
        outs = []
        for caching in (True, False):
            eng = self.engine("paged", prefix_caching=caching)
            eng.serve([Request(first, max_new=4)])
            r = Request(second, max_new=16)
            eng.serve([r])
            eng.check_page_invariants()
            outs.append((r.out, eng.stats["prefix_hits"], eng.stats["prefix_hit_tokens"]))
        (hit, n_hits, hit_tokens), (cold, _, _) = outs
        if n_hits != 1 or hit_tokens != 256 or hit != cold:
            fail(f"{self.tag}: prefix hit != cold run (hits {n_hits}, hit tokens {hit_tokens}, "
                 f"tokens equal {hit == cold})")
        print(f"serve {self.tag} paged prefix hit == cold run: equal ({len(hit)} tokens; "
              f"prefix_hits=1 prefix_hit_tokens=256, suffix {len(second) - 256} tokens)",
              flush=True)


def _grid_record(run) -> dict:
    """``run()`` with every dual launch's expert count (its ``gridDim.z``)
    recorded from the launch arguments: {experts: launches}."""
    from repro_torch.kernels import cuda_launch

    seen: dict = {}
    orig = cuda_launch.pack_args

    def rec(w, kind):
        pa = orig(w, kind)
        seen[pa.experts] = seen.get(pa.experts, 0) + 1
        return pa

    cuda_launch.pack_args = rec
    try:
        run()
    finally:
        cuda_launch.pack_args = orig
    return seen


def _deepseek_cfg():
    from repro_torch.configs import get_config

    return get_config("deepseek-v3-671b").replace(n_layers=DEEPSEEK_LAYERS, first_k_dense=1)


def deepseek_phase(device, card: str, cfg, prompt_lens=PROMPT_LENS, max_len: int = 2048,
                   rank: int = 128) -> dict:
    """DeepSeek-V3 at full width (``cfg``'s depth: ``DEEPSEEK_LAYERS``, one
    dense and one MoE layer, with the ``mtp`` block), random weights from
    seed 0: W4A4 (rank 128, group 128, experts packed in chunks) packs, the
    stacked dual kernels at E = 256 on the served experts
    (``moe_kernel_phase`` with ``DS_KERNEL_RUN``), W4A16 (group 128) packs,
    the 2-D linears of both through their kernels (``ds_linears_phase``);
    the W4A4 model served bucketed and paged (prefix cache on) at
    ``DEEPSEEK_CF`` (drop-free) with the serve phase's checks (routes, one
    launch per linear call, one capture, graph step == eager step, solo ==
    interleaved), a prefix hit == a cold run, one eager paged run at the
    published capacity factor printing the drops and each dual launch's
    expert count; then the stacked ``w4a16_gemm`` at E = 256 and every
    served Cp (``stacked_w4a16_phase``) and the W4A16 model served bucketed
    and paged. Returns the stacked table."""
    import numpy as np
    import torch

    from repro_torch.configs import QuantSpec
    from repro_torch.core.twinquant import fuse_params, quantize_params
    from repro_torch.models import deepseek

    t0 = time.perf_counter()
    print(f"deepseek config {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads} q_lora="
          f"{cfg.q_lora_rank} kv_lora={cfg.kv_lora_rank} nope/rope/v={cfg.qk_nope_dim}/"
          f"{cfg.qk_rope_dim}/{cfg.v_head_dim} experts={cfg.n_experts} top_k={cfg.top_k} "
          f"shared={cfg.n_shared_experts} d_ff_expert={cfg.d_ff_expert} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab} n_layers={cfg.n_layers} first_k_dense={cfg.first_k_dense} "
          f"mtp={cfg.mtp} card=\"{card}\"", flush=True)
    params = deepseek.init_params(cfg, seed=0, device=device)
    _sync(device)
    t1 = time.perf_counter()
    bf16_bytes = _param_bytes(params)
    spec = QuantSpec("w4a4", rank=rank, group_size=128)
    layers, pack_s = [], []
    for lp in params.layers:  # layer by layer, for the seconds each takes
        t = time.perf_counter()
        layers.append(quantize_params(lp, cfg, spec))
        _sync(device)
        pack_s.append(time.perf_counter() - t)
    t = time.perf_counter()
    # the whole model once more: the layers are packed, so this packs the
    # mtp block (its path names mtp/proj, which stays bf16)
    qp = quantize_params(deepseek.DeepSeekModel(params.embed, layers, params.ln_f, params.head,
                                                params.mtp), cfg, spec)
    _sync(device)
    pack_s.append(time.perf_counter() - t)
    qp = fuse_params(qp)
    t2 = time.perf_counter()
    ex, bf = qp.layers[-1].moe.experts, params.layers[-1].moe.experts
    tables = {"stacked": moe_kernel_phase(
        device, cfg, packs=(ex["gate_up"].weights(), ex["down"].weights()),
        lib={"gate_up": [bf["gate"].w, bf["up"].w], "down": [bf["down"].w]}, **DS_KERNEL_RUN)}
    t3 = time.perf_counter()
    qp16 = quantize_params(params, cfg, QuantSpec("w4a16"))
    _sync(device)
    t4 = time.perf_counter()
    ds_linears_phase(device, qp, qp16)
    t5 = time.perf_counter()
    total, active = deepseek.count_params(cfg)
    print(f"deepseek params total={total} active={active} (count_params at {cfg.n_layers} "
          f"layers) param_bytes bf16={bf16_bytes} w4a4={_param_bytes(qp)} "
          f"w4a16={_param_bytes(qp16)}; init_s={t1 - t0:.2f} w4a4_quantize_s={t2 - t1:.2f} "
          f"(dense layer {pack_s[0]:.2f} s, MoE layer {pack_s[1]:.2f} s: "
          f"{3 * cfg.n_experts} expert linears in chunks of batched SVDs, mtp "
          f"{pack_s[-1]:.2f} s) w4a16_quantize_s={t4 - t3:.2f}", flush=True)
    del params, layers, lp, ex, bf  # lp: the bf16 MoE layer, 23 GB at full width
    torch.cuda.empty_cache()
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in prompt_lens]
    served = DeepSeekServed("deepseek w4a4", cfg.replace(capacity_factor=DEEPSEEK_CF), qp,
                            "w4a4", prompts, device, max_len)
    for mode in DEEPSEEK_MODES:
        served.serve(mode, against_eager=True)
    served.prefix_check()
    for mode, times in served.step_times.items():
        times["busy_share_graph"] = ((times["graph_kernel_ms"] or times["replay_events_ms"])
                                     / served.host_step_ms[mode])
        print(f"serve step times {json.dumps({'setting': served.tag, 'mode': mode, **times})}",
              flush=True)
    t6 = time.perf_counter()
    published = DeepSeekServed("deepseek w4a4", cfg, qp, "w4a4", prompts, device, max_len)
    published.outs = served.outs
    grid = _grid_record(lambda: _drops_run(published, device))
    nm = cfg.n_layers - cfg.first_k_dense
    print(f"serve deepseek w4a4 dual launches by expert count (gridDim.z) in the eager run at "
          f"capacity_factor={cfg.capacity_factor}: {json.dumps(grid, sort_keys=True)}", flush=True)
    if device.type == "cuda" and set(grid) != {1, cfg.n_experts}:
        fail(f"deepseek: dual launches by expert count {grid}, want 1 and {cfg.n_experts}")
    if device.type == "cuda" and grid[cfg.n_experts] * (5 * cfg.first_k_dense + 7 * nm) != \
            2 * nm * sum(grid.values()):
        fail(f"deepseek: stacked launches {grid[cfg.n_experts]} are not 2 of every "
             f"{5 * cfg.first_k_dense + 7 * nm} launches (experts gate_up, down a MoE layer)")
    t7 = time.perf_counter()
    launches = dict(served.launches)
    del served, published, qp
    gc.collect()  # the engines' graphs and pools, should a cycle hold them
    torch.cuda.empty_cache()
    if device.type == "cuda":
        print(f"deepseek memory_allocated before the stacked w4a16_gemm="
              f"{torch.cuda.memory_allocated(device)} (the W4A16 packs: {_param_bytes(qp16)})",
              flush=True)
    # w4a16_gemm on random stacks at E = 256 once the W4A4 model is gone
    # (the packs are made 16 experts at a time)
    tables["stacked"]["w4a16_gemm"] = stacked_w4a16_phase(
        device, cfg, cps=DS_W4A16_CPS, col=None, sample=DS_EXPERTS, time_all=False)
    torch.cuda.empty_cache()
    t8 = time.perf_counter()
    w16 = DeepSeekServed("deepseek w4a16", cfg.replace(capacity_factor=DEEPSEEK_CF), qp16,
                         "w4a16", prompts, device, max_len)
    for mode in DEEPSEEK_MODES:
        w16.serve(mode, against_eager=True)
    for mode, times in w16.step_times.items():
        times["busy_share_graph"] = ((times["graph_kernel_ms"] or times["replay_events_ms"])
                                     / w16.host_step_ms[mode])
        print(f"serve step times {json.dumps({'setting': w16.tag, 'mode': mode, **times})}",
              flush=True)
    launches.update(w16.launches)
    del w16, qp16
    torch.cuda.empty_cache()
    t9 = time.perf_counter()
    print(f"deepseek phase seconds: init {t1 - t0:.1f} w4a4_quantize {t2 - t1:.1f} "
          f"stacked_dual {t3 - t2:.1f} w4a16_quantize {t4 - t3:.1f} linears {t5 - t4:.1f} "
          f"w4a4_serve {t6 - t5:.1f} capacity_1.25 {t7 - t6:.1f} stacked_w4a16 {t8 - t7:.1f} "
          f"w4a16_serve {t9 - t8:.1f}", flush=True)
    print(f"deepseek tables {json.dumps({**tables, 'launches': launches})}", flush=True)
    return tables


# ---------------------------------------------------------------------------
# phases 10-11: Whisper-base (encdec: cross-attention over per-slot encoder
# rows) and Zamba2-1.2B (mamba_hybrid: the Mamba2 recurrence beside the
# shared block's paged cache)
# ---------------------------------------------------------------------------

WHISPER_MAX_LEN = 448  # whisper's decoder context
# buckets 8 .. 448 (the cap); each request's max_new is cut to fit the context
WHISPER_PROMPTS = (3, 6, 8, 20, 40, 64, 100, 128, 200, 256, 300, 440)
WHISPER_ATT = dict(B=8, H=8, KV=8, hd=64, page=16, maxp=128)
# rows the served runs give the 2-D linears: decode (8 slots) and the
# prefill bucket 8, the buckets 32 .. 448, the 1500-row encoder and the
# cross-attention k/v
WHISPER_LINEAR_MS = (8, 32, 64, 128, 256, 448, 1500)
# zamba2's 38 layers cut to 7 (1 shared-block invocation + 1 rest layer):
# its prefill fills the state one eager decode step per bucket row, ~28-35 ms
# a row at 14 layers, so 38 layers would take the phase past its ~150 s, and
# 14 layers took the whole script to 1122.9 s, past its ~1100 s (8 until
# the training phase came; PERF.md section 4)
ZAMBA_LAYERS = 7
ZAMBA_MAX_LEN = 512
# buckets 8 .. 256; the 200-token prompt's forward runs two SSD chunks (the
# carried inter-chunk state) and the shared block's attention over both.
# The prefill costs one eager step a bucket row, so the rest stay short
# (480 bucket rows a served run)
ZAMBA_PROMPTS = (3, 6, 8, 12, 20, 30, 40, 200, 9, 16, 10, 5)
ZAMBA_ATT = dict(B=8, H=32, KV=32, hd=64, page=16, maxp=128)
# rows the served runs give the linears: the prefill's per-token steps (1),
# decode (8), the forward over prompts padded to CHUNKs (128, 256)
ZAMBA_LINEAR_MS = (1, 8, 128, 256)
FAMILY_MODES = ("bucketed", "paged")  # W4A4; W4A16 paged
# the paged kernel on the served state (``FamilyServed.kernel_step``): per
# slot, the relative L2 error of a step's logits with the kernel against
# the same step with its plain version in its place (teacher-forced, one
# state). The kernel folds the softmax in f32 and rounds once where the
# plain version rounds in bf16: the logits moved by rel ~0.008 in bf16 /
# W4A16 and 0.19-0.23 in W4A4 (Whisper at full size from one state, NVIDIA
# H100 80GB HBM3, 700 W), whose 4-bit activations carry last-bit
# differences on. The kernel's own outputs are
# held at ``ATT_REL_MAX`` on the same step
PAGED_STEP_REL = {"w4a4": 0.5, "w4a16": 0.05}
# neither family has a ragged_step or multi-row paged decode (the reference's
# gates): these fall back to bucketed prefill + one-token decode, warning
FALLBACKS = {"ragged=True": dict(paged=True, ragged=True, token_budget=256,
                                 prefix_caching=False),
             "speculation=True": dict(paged=True, speculation=True, spec_k=4,
                                      prefix_caching=False)}


def family_linears_phase(tag: str, device, qp, qp16, ms, extra=()) -> None:
    """Every distinct W4A4 linear shape of ``qp`` (and the call-time fused
    groups in ``extra``: (name, group weights)) through the dual kernels at
    each M of ``ms``, ``torch.equal`` to the plain version; every distinct
    W4A16 shape of ``qp16`` through ``w4a16_gemm``, per row within
    ``W4A16_REL_MAX`` of the f32 plain version and ``W4A16_TOL`` of the bf16
    one."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.twinquant_dual_gemm import dual_gemm, dual_gemm_group
    from repro_torch.kernels.twinquant_dual_gemv import dual_gemv, dual_gemv_group
    from repro_torch.kernels.w4a16_gemm import w4a16_gemm
    from repro_torch.models.common import TwinQuantLinear, TwinQuantLinearGroup, W4A16Linear

    gen = torch.Generator(device=device).manual_seed(19)
    seen = {}
    for name, mod in qp.named_modules():
        if isinstance(mod, (TwinQuantLinear, TwinQuantLinearGroup)):
            w = mod.weights()
            gw = w if isinstance(w, ref.TwinQuantGroupWeights) else ref.as_group(w)
            seen.setdefault((gw.kdim, gw.seg_n, gw.seg_r), (name, w))
    for name, w in extra:
        seen.setdefault((w.kdim, w.seg_n, w.seg_r), (name, w))
    for (k, seg_n, _), (name, w) in seen.items():
        group = isinstance(w, ref.TwinQuantGroupWeights)
        gw = w if group else ref.as_group(w)
        for m in ms:
            kern = ((dual_gemv_group if group else dual_gemv) if m <= 8 else
                    (dual_gemm_group if group else dual_gemm))
            x = (torch.randn(m, k, generator=gen, device=device) * 2).to(torch.bfloat16)
            y_k, y_p = kern(x, w), ref.dual_gemm_group_ref(x, gw)
            _sync(device)
            if not torch.equal(y_k, y_p):
                fail(f"{tag} {name} M={m}: kernel != plain version ({_unequal(y_k, y_p)})")
        print(f"kernel {tag} w4a4  {name:28s} K={k:5d} N={list(seg_n)} r={gw.rank} M={list(ms)}: "
              f"kernel == plain", flush=True)
    seen16 = {}
    for name, mod in qp16.named_modules():
        if isinstance(mod, W4A16Linear):
            seen16.setdefault(tuple(mod.wp.shape), (name, mod))
    for (_, n), (name, mod) in seen16.items():
        k, worst = mod.wp.shape[0] * 2, 0.0
        for m in ms:
            x = (torch.randn(m, k, generator=gen, device=device) * 2).to(torch.bfloat16)
            y_k, y32 = w4a16_gemm(x, mod.wp, mod.ws), ref.w4a16_gemm_f32(x, mod.wp, mod.ws)
            _sync(device)
            rel = _rel_rows(y_k, y32).max().item()
            worst = max(worst, rel)
            if not torch.allclose(y_k.float(), y32.to(torch.bfloat16).float(), **W4A16_TOL):
                fail(f"{tag} w4a16 {name} M={m}: kernel vs plain version beyond atol "
                     f"{W4A16_TOL['atol']} / rtol {W4A16_TOL['rtol']}")
            if not rel <= W4A16_REL_MAX:
                fail(f"{tag} w4a16 {name} M={m}: kernel vs f32 plain version rel {rel} per row "
                     f"> {W4A16_REL_MAX}")
        print(f"kernel {tag} w4a16 {name:28s} K={k:5d} N={n:5d} M={list(ms)}: close, max rel "
              f"per row {worst:.5f} (limit {W4A16_REL_MAX})", flush=True)


class FamilyServed(Served):
    """An ``encdec`` or ``mamba_hybrid`` model served as :class:`Served`
    does, with the families' own counts: each model call's quantized-linear
    launches (``per_step`` a decode step, ``per_prefill(bucket)`` a
    prefill), the paged kernel ``att_per_step`` times a decode step, no
    prefix-cache lookup; a graph step checked against the eager step (no
    eager run). ``frames`` (Whisper) gives each request its own frame
    embeddings; each request's ``max_new`` fits ``max_len``."""

    def __init__(self, *args, per_step: int, per_prefill, att_per_step: int, frames=None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.per_step, self.per_prefill, self.att_per_step = per_step, per_prefill, att_per_step
        self.frames = frames
        self.engines: list = []
        self.stepped: set = set()
        self.host_step_ms: dict = {}
        self.prefills: dict = {}

    def request(self, i):
        req = super().request(i)
        req.max_new = min(req.max_new, self.max_len - len(self.prompts[i]))
        if self.frames is not None:
            req.frontend = {"frames": self.frames[i]}
        return req

    def engine(self, mode, **kw):
        import warnings

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            eng = super().engine(mode, **kw)
        if mode != "bucketed" and not any("prefix_caching" in str(w.message) for w in caught):
            fail(f"{self.tag} {mode}: the paged engine did not warn that the family serves "
                 f"no prefix cache")
        self.engines.append(eng)
        # each admission's prefill, timed (it ends in the logits download)
        rec = self.prefills.setdefault(mode, [])
        run = eng._run_prefill

        def timed(tokens, *a, **k):
            t = time.perf_counter()
            out = run(tokens, *a, **k)
            rec.append((len(tokens), out[2], time.perf_counter() - t))
            return out

        eng._run_prefill = timed
        if mode == "paged" and not kw and mode not in self.stepped:  # the served run
            self.stepped.add(mode)
            _after_step(eng, CHECK_STEP, lambda: self.kernel_step(eng))
        return eng

    def kernel_step(self, eng) -> None:
        """The paged kernel held on the served state. From the state after
        a steady step, the engine's step runs eagerly (the same tokens)
        with the kernel, each of its launches checked on its own inputs:
        every active slot's output per (row, head) within ``ATT_REL_MAX``
        of the f32 plain version, while the control, the plain version
        with the longest slot reading another slot's first page, lands
        beyond it on that slot. Then the same step with the plain version
        in the kernel's place: every active slot's logits within
        ``PAGED_STEP_REL`` of the kernel step's. The state and the launch
        and route counts are put back."""
        from repro_torch.kernels import cuda_launch, dispatch
        from repro_torch.kernels.paged_attention import paged_decode_ref

        sg, limit, kernel = eng.step_graph, PAGED_STEP_REL[self.kind], dispatch.paged_decode_kernel
        launches, routes = cuda_launch.launch_counts(), dispatch.dispatch_counters()
        snap = _clone_state(eng.state)
        active = [i for i, r in enumerate(eng.slots) if r is not None]
        pos = snap["pos"].tolist()
        bad = max(active, key=lambda i: pos[i])
        other = next(i for i in active if i != bad)
        bt_bad = snap["bt"].clone()
        bt_bad[bad, 0] = snap["bt"][other, 0]
        calls = []

        def checked(q, kp, vp, kt, vt, bt, p, **kw):
            out = kernel(q, kp, vp, kt, vt, bt, p, **kw)
            y = out[0] if isinstance(out, tuple) else out
            f32 = _f32(q, kp, vp, kt, vt)
            y32 = paged_decode_ref(*f32, bt, p, commit=False)
            y_bad = paged_decode_ref(*f32, bt_bad, p, commit=False)
            calls.append((_rel_rows(y, y32)[active].max().item(),
                          _rel_rows(y_bad, y32)[bad].max().item()))
            return out

        def step(attn):
            _restore_state(eng.state, snap)
            dispatch.paged_decode_kernel = attn
            try:
                return sg.fn(**sg.buffers)[:, -1].float()
            finally:
                dispatch.paged_decode_kernel = kernel

        y_k, y_p = step(checked), step(paged_decode_ref)
        _restore_state(eng.state, snap)
        del snap
        cuda_launch.reset_launch_counts()
        cuda_launch.add_launch_counts(launches)
        dispatch.reset_dispatch_counters()
        dispatch.add_dispatch_counts(routes)
        if len(calls) != self.att_per_step:
            fail(f"{self.tag} paged: the step launched the paged kernel {len(calls)} times, "
                 f"want {self.att_per_step}")
        worst, caught = max(c[0] for c in calls), min(c[1] for c in calls)
        if not worst <= ATT_REL_MAX:
            fail(f"{self.tag} paged: the kernel on the served state: max rel per (row, head) "
                 f"{worst} vs the f32 plain version > {ATT_REL_MAX}")
        if not caught > ATT_REL_MAX:
            fail(f"{self.tag} paged: the control (slot {bad} reads slot {other}'s first page) "
                 f"gives rel {caught} <= {ATT_REL_MAX}: the check would not see it")
        rel = _rel_rows(y_k, y_p)[active]
        if not rel.max().item() <= limit:
            fail(f"{self.tag} paged: the kernel step's logits vs the plain step's: rel per slot "
                 f"{[round(v, 4) for v in rel.tolist()]} > {limit}")
        print(f"serve {self.tag} paged kernel on the served state (step "
              f"{eng.stats['decode_steps']}, {len(active)} slots at {[pos[i] for i in active]}, "
              f"{len(calls)} launches): max rel per (row, head) vs the f32 plain version "
              f"{worst:.5f} (limit {ATT_REL_MAX}); control (slot {bad} reads one wrong page) "
              f"min rel {caught:.5f} -> caught; the step's logits vs the plain step's: rel per "
              f"slot max {rel.max().item():.5f} (limit {limit})", flush=True)

    def prefill_logits(self) -> None:
        """Kernel vs plain logits of one prompt through the model entry
        point (Whisper's prefill behind its frames; Zamba2's forward):
        equal for the dual kernels."""
        import torch

        from repro_torch.kernels import dispatch
        from repro_torch.models.registry import get_model

        model = get_model(self.cfg)
        toks = torch.as_tensor(self.prompts[4][None, :], device=self.device, dtype=torch.long)

        def logits(plain):
            prev = dispatch.set_force_ref(plain)
            try:
                if self.frames is None:
                    return model.forward(self.qp, self.cfg, toks).float()
                st = model.init_decode_state(self.cfg, 1, self.max_len, device=self.device)
                return model.prefill(self.qp, self.cfg, toks, st, frames=self.frames[4])[0].float()
            finally:
                dispatch.set_force_ref(prev)

        lk, lp = logits(False), logits(True)
        if not torch.equal(lk, lp):
            fail(f"{self.tag}: prefill logits through the kernels != plain versions "
                 f"(max |d| {(lk - lp).abs().max().item()})")
        print(f"serve {self.tag} prefill logits kernel == plain: equal ({toks.shape[1]} tokens)",
              flush=True)

    def _linears(self, mode, eng, got, routes) -> None:
        cuda = self.device.type == "cuda"
        name = f"{self.tag} {mode}"
        self.host_step_ms[mode] = _step_ms(eng, mode)
        steps = eng.stats["decode_steps"]
        buckets = [b for (b, _, _), n in eng._prefill_shapes.items() for _ in range(n)]
        want = self.per_step * steps + sum(self.per_prefill(b) for b in buckets)
        w16 = self.kind == "w4a16"
        kinds = ("w4a16_gemm",) if w16 else MOE_KERNELS
        pre = "w4a16" if w16 else "dual"
        n_routes = sum(v for key, v in routes.items() if key.startswith(pre))
        n_launch = sum(got.get(k, 0) for k in kinds)
        if n_routes != want or any(not key.startswith((pre, "paged_decode")) for key in routes):
            fail(f"{name}: want {want} routes ({self.per_step} a decode step x {steps}, the "
                 f"prefills of buckets {sorted(set(buckets))}), routes {routes}")
        if cuda and n_launch != want:
            fail(f"{name}: {kinds} launched {n_launch} times, want one per linear call: {want} "
                 f"({got})")
        for kname in kinds:
            if cuda and got.get(kname, 0) <= 0:
                fail(f"kernel {kname} never launched on the {name} path")
            self.launches.setdefault(kname, got.get(kname, 0))
        print(f"serve {name} launches={n_launch} == {self.per_step} a decode step x {steps} + "
              f"the prefills ({len(buckets)} calls, buckets {sorted(set(buckets))}); "
              f"host_step_ms={self.host_step_ms[mode]:.3f}", flush=True)

    def _attention(self, mode, eng, got, routes) -> None:
        """The paged kernel launches ``att_per_step`` times a decode step."""
        cuda = self.device.type == "cuda"
        steps, want = eng.stats["decode_steps"], self.att_per_step * eng.stats["decode_steps"]
        routed = routes.get("paged_decode/kernel", 0)
        if routed != want:
            fail(f"{self.tag} {mode}: paged_decode/kernel routed {routed} times, want "
                 f"{self.att_per_step} x {steps} steps")
        if cuda and got.get("paged_decode_kernel", 0) != want:
            fail(f"{self.tag} {mode}: paged_decode_kernel launched "
                 f"{got.get('paged_decode_kernel')} times, want {want}")
        self.launches.setdefault("paged_decode_kernel", got.get("paged_decode_kernel", 0))

    def _against_eager(self, mode, reqs, got, routes, eng) -> None:
        """No eager run (the step check above holds a graph step to the eager
        one); the graph step's device time against its host step."""
        times = self.step_times.get(mode)
        if times is None:
            return
        ms_g = self.host_step_ms[mode]
        dev_g = times["graph_kernel_ms"] or times["replay_events_ms"]
        times.update(host_step_ms_graph=ms_g, busy_share_graph=dev_g / ms_g)
        print(f"serve {self.tag} {mode} step graph: host_step_ms={ms_g:.3f} device_ms_per_step "
              f"(profiler kernel sum)={times['graph_kernel_ms']:.3f}, of it hand-written "
              f"{times['graph_handwritten_ms']:.3f}; launches a step "
              f"{times['graph_launches']:.0f}; replay (CUDA events) ms="
              f"{times['replay_events_ms']:.3f}; busy_share={times['busy_share_graph']:.3f}",
              flush=True)

    def serve(self, mode, against_eager: bool = True) -> list:
        reqs = super().serve(mode, against_eager)
        looked = [e.stats["prefix_lookups"] for e in self.engines]
        if any(looked) or any(e.prefix_cache is not None for e in self.engines):
            fail(f"{self.tag} {mode}: the prefix cache was looked up: {looked}")
        self.engines.clear()
        pre = self.prefills.get(mode, [])
        print(f"serve {self.tag} {mode} prefix_lookups == 0; prefill ms per token (prompt "
              f"tokens, bucket: ms a bucket row) " + " ".join(
                  f"{n},{b}:{s / b * 1e3:.3f}" for n, b, s in pre[:len(self.prompts)]),
              flush=True)
        return reqs

    def fallbacks(self) -> None:
        """Ragged and speculative engines warn and serve bucketed prefill +
        one-token decode: the 3-token request gives the paged run's tokens."""
        import warnings

        for what, kw in FALLBACKS.items():
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                eng = super().engine("bucketed", **kw)
            if not any(what in str(w.message) for w in caught) or eng.ragged or eng.speculation:
                fail(f"{self.tag}: {what} did not warn and fall back")
            r = self.request(0)
            eng.serve([r])
            if r.out != self.outs["paged"][0].out:
                fail(f"{self.tag}: the {what} fallback's tokens != the paged run's")
            del eng
        print(f"serve {self.tag} ragged=True and speculation=True warn and fall back (the "
              f"{len(self.prompts[0])}-token request's tokens == the paged run's)", flush=True)

    def layouts_agree(self) -> None:
        """The paging invariant, as the reference holds it (its bucketed and
        paged decodes both attend in plain code): the 12 requests served
        paged with the paged kernel's plain version in its place (eager
        steps) give the bucketed run's tokens. The kernel's own paged
        tokens are printed against them, not gated (``kernel_step`` gates
        the kernel on the served state): the kernel folds in f32 and
        rounds once, the bucketed plain step rounds in bf16, and 4-bit
        activations carry that last-bit difference into the logits (rel
        ~0.2 from one state at W4A4, ~0.008 in bf16), where random weights
        leave top-2 margins near 0."""
        from repro_torch.kernels import dispatch
        from repro_torch.kernels.paged_attention import paged_decode_ref

        keep, dispatch.paged_decode_kernel = dispatch.paged_decode_kernel, paged_decode_ref
        try:
            eng = self.engine("paged", step_graphs=False)
            reqs = self.requests()
            eng.serve(reqs)
        finally:
            dispatch.paged_decode_kernel = keep
        want = self.outs["bucketed"]
        diff = [i for i, (a, b) in enumerate(zip(want, reqs)) if a.out != b.out]
        if diff:
            fail(f"{self.tag}: paged (plain attention) tokens != bucketed tokens for requests "
                 f"{diff}")
        first = [next((j for j, (x, y) in enumerate(zip(a.out, b.out)) if x != y), None)
                 for a, b in zip(want, self.outs["paged"])]
        print(f"serve {self.tag} paged with the plain attention == bucketed tokens: equal "
              f"({len(reqs)} requests); the kernel's paged run vs bucketed: "
              f"{sum(f is None for f in first)} of {len(first)} requests equal, first "
              f"differing token per request {first} (not gated)", flush=True)


def _family_step_times(served) -> None:
    for mode, times in served.step_times.items():
        print(f"serve step times {json.dumps({'setting': served.tag, 'mode': mode, **times})}",
              flush=True)


def whisper_phase(device, card: str, cfg, prompt_lens=WHISPER_PROMPTS,
                  max_len: int = WHISPER_MAX_LEN, rank: int = 128) -> dict:
    """Whisper-base at full width and depth (6 + 6 layers, 1500 frames),
    random weights and frames from seeds: the paged kernel at H = KV = 8, hd
    64 (``attention_phase``); W4A4 (rank 128, group 128, fused) and W4A16
    packs, every linear through its kernel at every served M
    (``family_linears_phase``); W4A4 served bucketed and paged, W4A16
    paged, each request behind its own frames, with the serve phase's
    checks (routes, launches per model call, one capture, graph step ==
    eager step, solo == interleaved), no prefix-cache lookup, the paging
    invariant (paged with the plain attention == bucketed tokens,
    ``layouts_agree``), the paged kernel on the served state
    (``kernel_step``, each paged run), and the ragged and speculative
    fallbacks. Returns the attention table."""
    import numpy as np
    import torch

    from repro_torch.configs import QuantSpec
    from repro_torch.core.twinquant import fuse_params, quantize_params
    from repro_torch.kernels.ref import fuse_twinquant_weights
    from repro_torch.models import encdec

    t0 = time.perf_counter()
    L, E = cfg.n_layers, cfg.n_enc_layers
    print(f"whisper config {cfg.name} family={cfg.family} d_model={cfg.d_model} heads="
          f"{cfg.n_heads} head_dim={cfg.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab} "
          f"n_frames={cfg.n_frames} n_layers={L} n_enc_layers={E} max_len={max_len} "
          f"card=\"{card}\"", flush=True)
    table = attention_phase(device, WHISPER_ATT, ragged=False)
    t1 = time.perf_counter()
    params = encdec.init_params(cfg, seed=0, device=device)
    qp = fuse_params(quantize_params(params, cfg, QuantSpec("w4a4", rank=rank, group_size=128)))
    qp16 = quantize_params(params, cfg, QuantSpec("w4a16"))
    _sync(device)
    total, _ = encdec.count_params(cfg)
    print(f"whisper params={total} param_bytes bf16={_param_bytes(params)} "
          f"w4a4={_param_bytes(qp)} w4a16={_param_bytes(qp16)}", flush=True)
    del params
    xa = qp.dec_layers[0].xattn
    family_linears_phase("whisper", device, qp, qp16, WHISPER_LINEAR_MS, extra=[
        ("dec_layers.0.xattn.kv (call time)",
         fuse_twinquant_weights([xa["k"].weights(), xa["v"].weights()]))])
    t2 = time.perf_counter()
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in prompt_lens]
    gen = torch.Generator(device=device).manual_seed(11)
    frames = [torch.randn(1, cfg.n_frames, cfg.d_model, generator=gen,
                          device=device).to(torch.bfloat16) for _ in prompts]
    # per decode step: qkv, o, xattn q, xattn o, up, down a layer; per
    # prefill: the encoder's qkv, o, up, down a layer and the decoder's six
    # and the cross-attention k/v (one launch, fused at call time) a layer
    w4 = FamilyServed("whisper w4a4", cfg, qp, "w4a4", prompts, device, max_len,
                      per_step=6 * L, per_prefill=lambda b: 4 * E + 7 * L, att_per_step=L,
                      frames=frames)
    w4.prefill_logits()
    for mode in FAMILY_MODES:
        w4.serve(mode)
    w4.layouts_agree()
    w4.fallbacks()
    _family_step_times(w4)
    launches = dict(w4.launches)
    del w4, qp
    t3 = time.perf_counter()
    # W4A16 never fuses: q, k, v, o, xattn q, xattn o, up, down a decode
    # layer; the encoder's six and the decoder's ten a prefill
    w16 = FamilyServed("whisper w4a16", cfg, qp16, "w4a16", prompts, device, max_len,
                       per_step=8 * L, per_prefill=lambda b: 6 * E + 10 * L, att_per_step=L,
                       frames=frames)
    w16.serve("paged")
    _family_step_times(w16)
    launches["w4a16_gemm"] = w16.launches["w4a16_gemm"]
    del w16, qp16
    torch.cuda.empty_cache()
    t4 = time.perf_counter()
    print(f"whisper phase seconds: attention {t1 - t0:.1f} init_quantize_linears {t2 - t1:.1f} "
          f"w4a4_serve {t3 - t2:.1f} w4a16_serve {t4 - t3:.1f}", flush=True)
    print(f"whisper tables {json.dumps({**table, 'launches': launches})}", flush=True)
    return table


def zamba2_phase(device, card: str, cfg, prompt_lens=ZAMBA_PROMPTS,
                 max_len: int = ZAMBA_MAX_LEN, rank: int = 128) -> dict:
    """Zamba2-1.2B at full width (d 2048, 64 SSM heads of 64, state 64, the
    shared block 32 x 64, d_ff 8192) and ``cfg``'s depth (``ZAMBA_LAYERS``),
    random weights from seed 0: the paged kernel at H = KV = 32, hd 64;
    W4A4 (fused: the shared block's gate/up) and W4A16 packs, every linear
    through its kernel at every served M; W4A4 served bucketed and paged,
    W4A16 paged, with the serve phase's checks, no prefix-cache lookup,
    the paging invariant (``layouts_agree``), the paged kernel on the served
    state (``kernel_step``) and the fallbacks; each prompt's prefill ms
    per bucket row (the reference's per-token state fill). Returns the
    attention table."""
    import numpy as np
    import torch

    from repro_torch.configs import QuantSpec
    from repro_torch.core.twinquant import fuse_params, quantize_params
    from repro_torch.models import mamba_hybrid

    t0 = time.perf_counter()
    n_seg, every, rest = mamba_hybrid._segments(cfg)
    print(f"zamba2 config {cfg.name} family={cfg.family} d_model={cfg.d_model} d_inner="
          f"{cfg.d_inner_ssm} ssm_heads={cfg.n_ssm_heads}x{cfg.ssm_head_dim} ssm_state="
          f"{cfg.ssm_state} conv={cfg.ssm_conv} shared heads={cfg.n_heads}x{cfg.head_dim} d_ff="
          f"{cfg.d_ff} vocab={cfg.vocab} n_layers={cfg.n_layers} (segments {n_seg} x {every} + "
          f"rest {rest}) max_len={max_len} card=\"{card}\"", flush=True)
    table = attention_phase(device, ZAMBA_ATT, ragged=False)
    t1 = time.perf_counter()
    params = mamba_hybrid.init_params(cfg, seed=0, device=device)
    _sync(device)
    ti = time.perf_counter()
    qp = fuse_params(quantize_params(params, cfg, QuantSpec("w4a4", rank=rank, group_size=128)))
    _sync(device)
    tq = time.perf_counter()
    qp16 = quantize_params(params, cfg, QuantSpec("w4a16"))
    _sync(device)
    total, _ = mamba_hybrid.count_params(cfg)
    print(f"zamba2 params={total} (count_params at {cfg.n_layers} layers) param_bytes bf16="
          f"{_param_bytes(params)} w4a4={_param_bytes(qp)} w4a16={_param_bytes(qp16)}; "
          f"init_s={ti - t1:.2f} w4a4_quantize_s={tq - ti:.2f} "
          f"w4a16_quantize_s={time.perf_counter() - tq:.2f}", flush=True)
    del params
    family_linears_phase("zamba2", device, qp, qp16, ZAMBA_LINEAR_MS)
    t2 = time.perf_counter()
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in prompt_lens]
    # per model step: in_proj and out_proj a block; q, k, v, o, gate_up,
    # down and the adapter an invocation of the shared block. A prefill is
    # the forward and one step per bucket row
    step4 = 2 * cfg.n_layers + 7 * n_seg
    w4 = FamilyServed("zamba2 w4a4", cfg, qp, "w4a4", prompts, device, max_len,
                      per_step=step4, per_prefill=lambda b: (1 + b) * step4, att_per_step=n_seg)
    w4.prefill_logits()
    for mode in FAMILY_MODES:
        w4.serve(mode)
    w4.layouts_agree()
    w4.fallbacks()
    _family_step_times(w4)
    launches = dict(w4.launches)
    del w4, qp
    t3 = time.perf_counter()
    step16 = 2 * cfg.n_layers + 8 * n_seg  # gate and up apart
    w16 = FamilyServed("zamba2 w4a16", cfg, qp16, "w4a16", prompts, device, max_len,
                       per_step=step16, per_prefill=lambda b: (1 + b) * step16,
                       att_per_step=n_seg)
    w16.serve("paged")
    _family_step_times(w16)
    launches["w4a16_gemm"] = w16.launches["w4a16_gemm"]
    del w16, qp16
    torch.cuda.empty_cache()
    t4 = time.perf_counter()
    print(f"zamba2 phase seconds: attention {t1 - t0:.1f} init_quantize_linears {t2 - t1:.1f} "
          f"w4a4_serve {t3 - t2:.1f} w4a16_serve {t4 - t3:.1f}", flush=True)
    print(f"zamba2 tables {json.dumps({**table, 'launches': launches})}", flush=True)
    return table


# ---------------------------------------------------------------------------
# phase 12: xlstm-1.3b (mLSTM blocks with periodic sLSTM blocks; purely
# recurrent state, so its paged mode is the dense per-slot layout)
# ---------------------------------------------------------------------------

# xlstm-1.3b's 48 layers cut to 8: one whole segment of 7 mLSTM + 1 sLSTM
# blocks. Its prefill fills the state one eager decode step per bucket row,
# 26-71 ms a row at 16 layers (two segments), which took the phase to
# 148.8 s and the whole script past ~1100 s (PERF.md section 4); the state
# crossing a segment boundary is held on the CPU (tests/test_torch_xlstm*.py)
XLSTM_LAYERS = 8
XLSTM_MAX_LEN = 512
# buckets 8 .. 512; the 300-token prompt fills bucket 512, whose trunk runs
# two 256-row chunks of the chunkwise mLSTM (the carried inter-chunk state)
XLSTM_PROMPTS = (3, 6, 8, 12, 20, 30, 40, 300, 9, 16, 10, 5)
# rows the served runs give the linears: the prefill's per-token steps (1),
# decode (8 slots), the trunk over prompts padded to 256 and 512 rows
XLSTM_LINEAR_MS = (1, 8, 256, 512)


class XLSTMServed(FamilyServed):
    """``xlstm-1.3b`` served as :class:`FamilyServed` does, with no
    attention: the paged run's layout is checked (no pool, allocator or
    block table: the dense per-slot state) where the other families check
    the paged kernel, and the paged tokens must equal the bucketed ones bit
    for bit (the same step on the same layout)."""

    def kernel_step(self, eng) -> None:
        import torch

        from repro_torch.models.registry import get_model

        want = get_model(self.cfg).init_decode_state(self.cfg, eng.batch, self.max_len,
                                                     device="meta")
        shapes = {k: tuple(v.shape) for k, v in eng.state.items()}
        if (eng.allocator is not None or eng.prefix_cache is not None or eng.n_pages
                or shapes != {k: tuple(v.shape) for k, v in want.items()}
                or any(not isinstance(v, torch.Tensor) for v in eng.state.values())):
            fail(f"{self.tag} paged: not the dense per-slot layout: allocator "
                 f"{eng.allocator}, n_pages {eng.n_pages}, state {shapes}")
        print(f"serve {self.tag} paged layout: no page pool, allocator or block table; the "
              f"state is the dense per-slot one ({len(shapes)} leaves, "
              f"{sum(v.numel() * v.element_size() for v in eng.state.values())} bytes)",
              flush=True)

    def layouts_agree(self) -> None:
        want, got = self.outs["bucketed"], self.outs["paged"]
        diff = [i for i, (a, b) in enumerate(zip(want, got)) if a.out != b.out]
        if diff:
            fail(f"{self.tag}: paged tokens != bucketed tokens for requests {diff}")
        print(f"serve {self.tag} paged == bucketed tokens: equal ({len(got)} requests, "
              f"bit for bit)", flush=True)


def xlstm_phase(device, card: str, cfg, prompt_lens=XLSTM_PROMPTS,
                max_len: int = XLSTM_MAX_LEN, rank: int = 128) -> dict:
    """xlstm-1.3b at full width (d 2048, d_inner 4096, 4 heads, dqk 512, dv
    1024, vocab 50304) and ``cfg``'s depth (``XLSTM_LAYERS``), random
    weights from seed 0: W4A4 (fused: the sLSTM ffn's gate/up) and W4A16
    packs, every linear (the gate linear ``wif``, N = 8, among them) through
    its kernel at every served M; W4A4 served bucketed and paged (the dense
    per-slot layout), W4A16 paged, with the serve phase's checks (routes, no
    plain-version route, launches per model call, one capture, graph step
    == eager step), no prefix-cache lookup, paged == bucketed tokens, every
    W4A4 bucketed request == the same prompt served alone, and the ragged
    and speculative fallbacks; each prompt's prefill ms per bucket row.
    Returns the launches."""
    import numpy as np
    import torch

    from repro_torch.configs import QuantSpec
    from repro_torch.core.twinquant import fuse_params, quantize_params
    from repro_torch.models import xlstm

    t0 = time.perf_counter()
    n_seg, m_per = xlstm._segments(cfg)
    d_inner, h, dh = xlstm._dims(cfg)
    print(f"xlstm config {cfg.name} family={cfg.family} d_model={cfg.d_model} d_inner={d_inner} "
          f"heads={h} dqk={xlstm._qk_dim(cfg)} dv={dh} vocab={cfg.vocab} n_layers={cfg.n_layers} "
          f"(segments {n_seg} x ({m_per} mLSTM + 1 sLSTM)) max_len={max_len} card=\"{card}\"",
          flush=True)
    params = xlstm.init_params(cfg, seed=0, device=device)
    _sync(device)
    ti = time.perf_counter()
    qp = fuse_params(quantize_params(params, cfg, QuantSpec("w4a4", rank=rank, group_size=128)))
    _sync(device)
    tq = time.perf_counter()
    qp16 = quantize_params(params, cfg, QuantSpec("w4a16"))
    _sync(device)
    total, _ = xlstm.count_params(cfg)
    wif = qp.m_layers[0][0].wif
    print(f"xlstm params={total} (count_params at {cfg.n_layers} layers) param_bytes bf16="
          f"{_param_bytes(params)} w4a4={_param_bytes(qp)} w4a16={_param_bytes(qp16)}; wif pack "
          f"K={wif.up.shape[0] * 2} N={wif.rp.shape[1]} rank={wif.up.shape[1]} rgroup="
          f"{wif.rgroup}; init_s={ti - t0:.2f} w4a4_quantize_s={tq - ti:.2f} "
          f"w4a16_quantize_s={time.perf_counter() - tq:.2f}", flush=True)
    del params
    family_linears_phase("xlstm", device, qp, qp16, XLSTM_LINEAR_MS)
    t2 = time.perf_counter()
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in prompt_lens]
    n_m = n_seg * m_per
    # per model step: up, wq, wk, wv, wif and down an mLSTM block; w, the
    # ffn's gate_up and down an sLSTM block. A prefill is the trunk and one
    # step per bucket row
    step4 = 6 * n_m + 3 * n_seg
    w4 = XLSTMServed("xlstm w4a4", cfg, qp, "w4a4", prompts, device, max_len,
                     per_step=step4, per_prefill=lambda b: (1 + b) * step4, att_per_step=0)
    w4.solo_held["bucketed"] = tuple(range(len(prompts)))
    w4.prefill_logits()
    for mode in FAMILY_MODES:
        w4.serve(mode)
    w4.layouts_agree()
    w4.fallbacks()
    _family_step_times(w4)
    launches = {k: v for k, v in w4.launches.items() if k != "paged_decode_kernel"}
    del w4, qp
    t3 = time.perf_counter()
    step16 = 6 * n_m + 4 * n_seg  # gate and up apart
    w16 = XLSTMServed("xlstm w4a16", cfg, qp16, "w4a16", prompts, device, max_len,
                      per_step=step16, per_prefill=lambda b: (1 + b) * step16, att_per_step=0)
    w16.serve("paged")
    _family_step_times(w16)
    launches["w4a16_gemm"] = w16.launches["w4a16_gemm"]
    del w16, qp16
    torch.cuda.empty_cache()
    t4 = time.perf_counter()
    print(f"xlstm phase seconds: init_quantize_linears {t2 - t0:.1f} w4a4_serve {t3 - t2:.1f} "
          f"w4a16_serve {t4 - t3:.1f}", flush=True)
    print(f"xlstm tables {json.dumps({'launches': launches})}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 13: the training stack at llama3-8b's full width, then the trained
# weights packed and served
# ---------------------------------------------------------------------------

TRAIN_LAYERS = 2  # llama3-8b's 32 layers cut to 2: ~1.49 B parameters
TRAIN_BATCH, TRAIN_SEQ = 4, 2049  # 2048 shifted rows: the chunked CE
# one TrainLoop run of 7 steps is both the loop check and the restart
# drill: a checkpoint at step 4, a failure before step 6, steps 4 and 5
# replayed from the restored state (and held to their first pass), then
# step 6 and the loop's closing checkpoint
TRAIN_STEPS = 7
TRAIN_CKPT_EVERY = 4
TRAIN_FAIL_AT = 6
# per leaf, the bf16 step's gradient against the same step with the weights
# in f32 (relative Frobenius error; bf16 against the JAX reference reads
# ~0.01 on the CPU). The embedding's own: its gradient is the reference's
# bf16 scatter-add, 8192 rows of the batch into at most 259 byte tokens'
# rows (0.186-0.237 on an H100 over five batches of two corpora; its dropped
# gradient reads 1.0; labels one token off read 0.300-0.333 there, a fault
# the other leaves catch; PERF.md section 6)
TRAIN_GRAD_REL_MAX = 0.05
TRAIN_EMBED_REL_MAX = 0.3
TRAIN_CHECK_BATCHES = 3  # the step check's batches (the stream's first)
TRAIN_INIT_BAND = 1.0  # |loss - ln V| at init (logits of about unit scale)
TRAIN_FALL_MIN = 0.5  # the first loss less the mean of the last two
# the loop's learning rate: the reference's default 3e-4 (no warm-up) swings
# the losses by up to 8 nats a step at this width, so the fall over 7 steps
# is chance: -0.74 on one corpus, 0.85-4.03 over eight data streams of
# another, against 6.05-7.09 at 1e-4 (``--train-sweep``, PERF.md section 6).
# The compression check's one step keeps the default: at 1e-4 a weight of
# |w| in [2^-6, 2^-5) moves by about one bf16 ulp, so its update comparison
# reads which elements round to a step and which to none (0.594, head.w)
TRAIN_LR = 1e-4
TRAIN_SWEEP_SEEDS = 8  # ``--train-sweep``: data streams per learning rate
# |deq + ef - g| <= scale / 512 per leaf: ef is the residual (<= scale / 2)
# rounded to bf16 (8 bits of mantissa), the rest f32 rounding
TRAIN_EF_BOUND = 2.0 ** -9
# the loss after one compressed step from the trained state against the
# loss after the uncompressed step, relative: read 1.2e-3 to 8.7e-3 on an
# H100 from states trained at 3e-4, 8.1e-4 to 1.3e-2 over eight data
# streams trained at ``TRAIN_LR`` (PERF.md section 6), 5e-4 in the CPU
# rehearsal. A step that applied no update can pass it (one step from a
# state trained at 3e-4 moved the loss by rel 0.013), so what the step did
# is held by the next bound
TRAIN_COMPRESS_REL = 0.02
# per leaf, the compressed step's update of the parameters (p_c - p0)
# against the uncompressed step's (p_u - p0), relative (Frobenius) over the
# leaves the uncompressed step moved: read 0.339 at most (head.w; median
# 0.113) on an H100 from states trained at 3e-4, 0.328-0.440 from eight
# trained at ``TRAIN_LR``, while a step that applied no update reads 1.0
# (the planted fault); the bound sits between them (PERF.md section 6)
TRAIN_UPDATE_REL_MAX = 0.6
TRAIN_PROMPTS = (5, 17, 40, 100)  # prefill buckets 8, 32, 64, 128
TRAIN_SERVE_SLOTS = 4  # the decode step's M
TRAIN_SERVE_MS = (4, 8, 32, 64, 128)


def _free() -> None:
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def train_loss_grads(params, cfg, batch) -> tuple:
    """(loss, {name: gradient}) of ``batch`` through the family's
    ``loss_fn``; the model's own gradients are cleared after."""
    from repro_torch.launch.train import batch_to_device
    from repro_torch.models.registry import get_model

    named = dict(params.named_parameters())
    dev = next(iter(named.values())).device
    for p in named.values():
        p.grad = None
    loss = get_model(cfg).loss_fn(params, cfg, batch_to_device(batch, dev))
    loss.backward()
    grads = {n: p.grad for n, p in named.items()}
    for p in named.values():
        p.grad = None
    return loss.detach(), grads


def train_eval_loss(params, cfg, batch) -> float:
    import torch

    from repro_torch.launch.train import batch_to_device
    from repro_torch.models.registry import get_model

    with torch.no_grad():
        dev = next(params.parameters()).device
        return float(get_model(cfg).loss_fn(params, cfg, batch_to_device(batch, dev)))


def grad_rels(grads: dict, ref: dict) -> list:
    """[(relative (Frobenius) error of ``grads`` against ``ref``, leaf)],
    largest first."""
    import torch

    rels = []
    for n, r in ref.items():
        r32 = r.float()
        rels.append((float(torch.linalg.vector_norm(grads[n].float() - r32)
                           / torch.linalg.vector_norm(r32).clamp_min(1e-30)), n))
    return sorted(rels, reverse=True)


def grads_over(rels: list) -> list:
    """The leaves past their bound (``TRAIN_EMBED_REL_MAX`` for the
    embedding, ``TRAIN_GRAD_REL_MAX`` for every other)."""
    return [(r, n) for r, n in rels
            if not r <= (TRAIN_EMBED_REL_MAX if n == "embed" else TRAIN_GRAD_REL_MAX)]


def update_rels(p0: dict, ref: dict, got: dict) -> tuple[list, int]:
    """([(relative (Frobenius) error of the update ``got - p0`` against
    ``ref - p0``, leaf)], largest first, over the leaves ``ref`` moved;
    the count of leaves it left as they were)."""
    import torch

    rels, still = [], 0
    for n, r in ref.items():
        d = torch.linalg.vector_norm(r.float() - p0[n].float())
        if not bool(d > 0):
            still += 1
            continue
        rels.append((float(torch.linalg.vector_norm(got[n].float() - r.float()) / d), n))
    return sorted(rels, reverse=True), still


def state_equal(saved: dict, state) -> tuple[bool, str]:
    """Every leaf of ``state`` bit for bit the host array of its key in
    ``saved`` (a save's ``host_copies``), compared on the leaf's device up
    to the first that differs; and that key."""
    import torch

    from repro_torch.checkpoint.manager import flatten

    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    flat = flatten(state)
    if set(flat) != set(saved):
        return False, f"keys {sorted(set(flat) ^ set(saved))[:3]}"
    for k, v in flat.items():
        want = torch.from_numpy(saved[k])
        got = v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(v)
        size = got.element_size()
        if tuple(got.shape) != tuple(want.shape) or size != want.element_size() or not torch.equal(
                got.contiguous().view(ints[size]), want.view(ints[size]).to(got.device)):
            return False, k
    return True, ""


def ef_worst(grads: dict, deq: dict, ef: dict, scales: dict) -> tuple[float, str]:
    """max |deq + ef - g| / scale over the leaves (the error-feedback
    identity), and its leaf."""
    worst = (-1.0, "")
    for n, g in grads.items():
        d = (deq[n] + ef[n].float() - g.float()).abs().max() / scales[n]
        worst = max(worst, (float(d), n))
    return worst


def _timed_step(step_fn, times: list, device):
    """``step_fn`` with each call's ms appended: device ms from CUDA events
    on the card, host ms on the CPU."""
    import torch

    def step(params, opt_state, batch):
        if device.type != "cuda":
            t = time.perf_counter()
            out = step_fn(params, opt_state, batch)
            times.append((time.perf_counter() - t) * 1e3)
            return out
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = step_fn(params, opt_state, batch)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
        return out
    return step


def drill_manager(directory, sync_device, keep_n: int = 1):
    """An async ``CheckpointManager`` that times its saves (host copies and
    the thread's start), its writer and its restores, keeps the host arrays
    of the last write (``saved``), and at a restore holds both the state it
    overwrites and the state it restores against them: ``held`` = (the
    state at the failure equal?, the restored state equal?, the first key
    that differs). A restore's seconds end with ``sync_device`` idle."""
    from repro_torch.checkpoint.manager import CheckpointManager

    class DrillManager(CheckpointManager):
        def __init__(self, directory, keep_n):
            super().__init__(directory, keep_n=keep_n, async_save=True)
            self.saved = self.held = None
            self.save_s, self.write_s, self.restore_s = [], [], []

        def save(self, step, state):
            t = time.perf_counter()
            super().save(step, state)
            self.save_s.append(time.perf_counter() - t)

        def _write(self, step, arrays, dtypes):
            t = time.perf_counter()
            super()._write(step, arrays, dtypes)
            self.saved = arrays
            self.write_s.append(time.perf_counter() - t)

        def restore_latest(self, like=None, device=None):
            self.wait()
            before = state_equal(self.saved, like)
            t = time.perf_counter()
            out = super().restore_latest(like, device)
            _sync(sync_device)
            self.restore_s.append(time.perf_counter() - t)
            after = state_equal(self.saved, out[1])
            self.held = (before[0], after[0], after[1] or before[1])
            return out

    return DrillManager(directory, keep_n)


def train_step_check(device, cfg, batches: list) -> float:
    """Check 1, on each of ``batches``: the bf16 step's gradients against
    the same step with the weights upcast to f32 on the same device, and
    labels one token off that must fail the bounds; on the first, the loss
    at init and two more planted faults (a dropped leaf gradient, the
    embedding's dropped); the reference's decay flags on the stacked
    shapes. Returns the first batch's loss."""
    import copy
    import math

    import numpy as np
    import torch

    from repro_torch.launch.train import init_train_state
    from repro_torch.optim import AdamW

    opt = AdamW()
    params, _ = init_train_state(cfg, opt, seed=0, device=device)
    decays = opt.decays(params)
    if not (decays["layers.0.ln1"] and decays["layers.1.attn.q.w"] and not decays["ln_f"]):
        fail(f"train decay flags: layers.0.ln1 {decays['layers.0.ln1']}, ln_f "
             f"{decays['ln_f']} (want True, False: the reference's stacked shapes)")
    p32 = copy.deepcopy(params).float()  # the same step with every weight in f32
    embeds = []  # (bf16 vs f32, labels one token off) of the embedding, a batch each
    for i, batch in enumerate(batches):
        loss, g16 = train_loss_grads(params, cfg, batch)
        loss32, g32 = train_loss_grads(p32, cfg, batch)
        rels = grad_rels(g16, g32)
        if grads_over(rels):
            fail(f"train step batch {i} bf16 vs f32 past the bounds ({TRAIN_GRAD_REL_MAX}, "
                 f"embed {TRAIN_EMBED_REL_MAX}): {grads_over(rels)}")
        # labels one token further ahead than the loss's own shift
        off_by_one = {**batch, "labels": np.roll(batch["labels"], -1, axis=1)}
        shift_rels = grad_rels(train_loss_grads(params, cfg, off_by_one)[1], g32)
        shift = grads_over(shift_rels)
        if not shift:
            fail(f"train step batch {i}: labels one token off not caught: {shift_rels[:3]}")
        embeds.append(tuple(round(next(r for r, n in rs if n == "embed"), 5)
                            for rs in (rels, shift_rels)))
        if i == 0:
            first = (float(loss), float(loss32), rels, shift)
            leaf = next(n for _, n in rels if n != "embed")
            dropped, dropped_embed = (
                grads_over(grad_rels({**g16, n: torch.zeros_like(g16[n])}, g32))
                for n in (leaf, "embed"))
            if not (dropped and dropped_embed):
                fail(f"train step planted faults not caught: dropped leaf {leaf} {dropped}, "
                     f"dropped embed {dropped_embed}")
        del g16, g32
        _free()
    del p32
    _free()
    loss, loss32, rels, shift = first
    ln_v = math.log(cfg.vocab)
    if not math.isfinite(loss) or abs(loss - ln_v) > TRAIN_INIT_BAND:
        fail(f"train step loss {loss} at init, want finite and within {TRAIN_INIT_BAND} of "
             f"ln(V) = {ln_v:.4f}")
    print(f"train step gradients bf16 vs f32 (batch 0), largest rel first: "
          f"{[(round(r, 5), n) for r, n in rels[:6]]}", flush=True)
    print(f"train step embed rel (bf16 vs f32, labels one token off) on batches 0-"
          f"{len(batches) - 1}: {embeds} (bound {TRAIN_EMBED_REL_MAX}; the label shift is "
          f"caught by the other leaves, the dropped embedding reads 1.0)", flush=True)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"train step params={n_params} loss bf16={loss:.6f} f32={loss32:.6f} "
          f"ln(V)={ln_v:.6f}; gradients bf16 vs f32 within {TRAIN_GRAD_REL_MAX} (embed "
          f"{TRAIN_EMBED_REL_MAX}) on {len(batches)} batches; planted faults caught: {leaf} "
          f"dropped {dropped[0]}, embed dropped {dropped_embed[0]}, labels one token off: "
          f"{len(shift)} leaves past, the worst {shift[0]}; decay flags: layers.i.ln1 True, "
          f"ln_f False ({sum(decays.values())} of {len(decays)} leaves decay)", flush=True)
    return loss


def _run_loop(cfg, step_fn, mgr, ds, device) -> tuple:
    """A ``TrainLoop`` from the seed-0 state over ``TRAIN_STEPS`` steps of
    ``ds``, checkpointing every ``TRAIN_CKPT_EVERY`` and failing once
    before step ``TRAIN_FAIL_AT``. Returns (params, opt_state, losses, end
    step, loop)."""
    from repro_torch.launch.train import TrainLoop, init_train_state
    from repro_torch.optim import AdamW

    params, opt_state = init_train_state(cfg, AdamW(lr=TRAIN_LR), seed=0, device=device)
    armed = [True]

    def injector(step):
        if armed[0] and step == TRAIN_FAIL_AT:
            armed[0] = False
            raise RuntimeError("injected node failure")

    loop = TrainLoop(cfg, step_fn, mgr, ds.iterate, ckpt_every=TRAIN_CKPT_EVERY)
    params, opt_state, losses, end = loop.run(params, opt_state, 0, TRAIN_STEPS,
                                              fail_injector=injector)
    return params, opt_state, losses, end, loop


def train_sweep(device, card: str, cfg, lrs, seeds, batch: int = TRAIN_BATCH,
                seq: int = TRAIN_SEQ) -> None:
    """``--train-sweep``: phase 13's loss fall (the first loss less the mean
    of the last two, over ``TRAIN_STEPS`` steps from the seed-0 state) for
    each learning rate in ``lrs`` on the data streams ``TokenDataset(seed=s)``
    for ``s`` in ``seeds``, under deterministic algorithms, and at
    ``TRAIN_LR`` the phase's compression check from each trained state. A
    stream's seed moves its windows over the corpus as an edit of the
    repo's text does."""
    import os

    import torch

    from repro_torch.data.pipeline import TokenDataset, load_corpus
    from repro_torch.launch.train import init_train_state, make_train_step
    from repro_torch.optim import AdamW

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev_det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    tokens = load_corpus()
    try:
        for lr in lrs:
            falls = []
            for s in seeds:
                ds = TokenDataset(tokens, batch=batch, seq=seq, seed=s)
                opt = AdamW(lr=lr)
                params, state = init_train_state(cfg, opt, seed=0, device=device)
                step = make_train_step(cfg, opt)
                losses = []
                for i in range(TRAIN_STEPS):
                    params, state, loss = step(params, state, ds.batch_at(i))
                    losses.append(float(loss))
                falls.append(losses[0] - sum(losses[-2:]) / 2)
                print(f"train sweep lr={lr} data seed={s} losses={json.dumps(losses)} "
                      f"fall={falls[-1]:.4f}", flush=True)
                if lr == TRAIN_LR:  # phase 13's compression check from this state
                    train_compress_check(cfg, params, state, ds.batch_at(TRAIN_STEPS))
                del params, state
                _free()
            passed = sum(f >= TRAIN_FALL_MIN for f in falls)
            print(f"train sweep lr={lr} falls={json.dumps([round(f, 4) for f in falls])} min="
                  f"{min(falls):.4f} at least {TRAIN_FALL_MIN}: {passed} of {len(falls)} "
                  f"corpus_tokens={len(tokens)} card=\"{card}\"", flush=True)
    finally:
        torch.use_deterministic_algorithms(prev_det)


def train_compress_check(cfg, params, opt_state, batch) -> None:
    """Check 4, from the trained state: the int8 error-feedback identity on
    the step's gradients (a dropped residual must fail it); one compressed
    step (``make_train_step(grad_compress=True)``, a zero residual) whose
    parameters are bit for bit AdamW's update by the dequantized gradients
    (the state before the step must differ), whose update of each leaf is
    within ``TRAIN_UPDATE_REL_MAX`` of the uncompressed step's (no update
    must fail it) and whose next loss is within ``TRAIN_COMPRESS_REL`` of
    the uncompressed step's. Runs under deterministic algorithms; the state
    is put back after each step."""
    import torch

    from repro_torch.launch.train import make_train_step
    from repro_torch.optim import AdamW
    from repro_torch.optim.grad_compression import compress_grads_int8, decompress_grads_int8

    opt = AdamW()
    named = dict(params.named_parameters())
    snap = {n: p.detach().clone() for n, p in named.items()}
    moments = {n: (opt_state.mu[n].clone(), opt_state.nu[n].clone()) for n in named}

    def put_back():
        with torch.no_grad():
            for n, p in named.items():
                p.copy_(snap[n])
                opt_state.mu[n].copy_(moments[n][0])
                opt_state.nu[n].copy_(moments[n][1])

    def after(step_fn, state) -> dict:
        """The parameters after one step from the snapshot, then put back."""
        step_fn(params, state, batch)
        out = {n: p.detach().clone() for n, p in named.items()}
        put_back()
        return out

    loss_before = train_eval_loss(params, cfg, batch)
    _, grads = train_loss_grads(params, cfg, batch)
    q, s, ef = compress_grads_int8(grads, cfg=cfg)
    deq = decompress_grads_int8(q, s)
    worst = ef_worst(grads, deq, ef, s)
    planted = ef_worst(grads, deq, {n: torch.zeros_like(e) for n, e in ef.items()}, s)
    if not worst[0] <= TRAIN_EF_BOUND or planted[0] <= TRAIN_EF_BOUND:
        fail(f"train compression: deq + ef vs g worst {worst} (bound {TRAIN_EF_BOUND}), "
             f"residual dropped {planted} (must exceed it)")
    del grads, q, s, ef
    p_m = after(lambda p, st, b: opt.update(deq, st, p), opt_state)  # AdamW by hand
    del deq
    _free()
    make_train_step(cfg, opt)(params, opt_state, batch)
    loss_u = train_eval_loss(params, cfg, batch)
    p_u = {n: p.detach().clone() for n, p in named.items()}
    put_back()
    zero_ef = {n: torch.zeros_like(p) for n, p in named.items()}
    make_train_step(cfg, opt, grad_compress=True)(params, (opt_state, zero_ef), batch)
    loss_c = train_eval_loss(params, cfg, batch)
    p_c = {n: p.detach().clone() for n, p in named.items()}
    put_back()
    del zero_ef, moments
    _free()
    unequal = [n for n in named if not torch.equal(p_c[n], p_m[n])]
    unmoved = all(torch.equal(snap[n], p_m[n]) for n in named)  # the control: no update
    moves, still = update_rels(snap, p_u, p_c)
    no_update, _ = update_rels(snap, p_u, snap)  # the planted fault: the step applied nothing
    del snap, p_u, p_c, p_m
    _free()
    if unequal or unmoved:
        fail(f"train compression: the compressed step != AdamW by the dequantized gradients "
             f"in {unequal[:3]} ({len(unequal)} leaves); the state before the step equal to "
             f"it {unmoved} (the control: must differ)")
    rel = abs(loss_c - loss_u) / abs(loss_u)
    if not moves or not moves[0][0] <= TRAIN_UPDATE_REL_MAX or not min(
            no_update)[0] > TRAIN_UPDATE_REL_MAX:
        fail(f"train compression: the compressed step's update vs the uncompressed one's, "
             f"worst {moves[:3]}, no update {min(no_update, default=None)} (bound "
             f"{TRAIN_UPDATE_REL_MAX}; the no-update control must exceed it)")
    if not rel <= TRAIN_COMPRESS_REL:
        fail(f"train compression: loss after the compressed step {loss_c} vs uncompressed "
             f"{loss_u}: rel {rel:.2e} (bound {TRAIN_COMPRESS_REL})")
    print(f"train compression from the trained state: deq + ef vs g worst "
          f"{worst[0] * 512:.4f} x scale/512 ({worst[1]}); residual dropped "
          f"{planted[0] * 512:.1f} x scale/512 (caught); the compressed step == AdamW by the "
          f"dequantized gradients: equal (the state before it: differs); its update against "
          f"the uncompressed step's, worst leaf first {[(round(r, 5), n) for r, n in moves[:4]]}"
          f", median {moves[len(moves) // 2][0]:.5f} over {len(moves)} leaves ({still} not "
          f"moved by it), no update {min(no_update)[0]:.5f} (caught), bound "
          f"{TRAIN_UPDATE_REL_MAX}; loss before the step {loss_before:.6f}, after it "
          f"uncompressed {loss_u:.6f}, compressed {loss_c:.6f}: rel {rel:.2e} <= "
          f"{TRAIN_COMPRESS_REL}", flush=True)


def train_serve_check(cfg, params, tokens, device) -> None:
    """Check 5: the trained weights packed W4A4 (rank 128, group 128,
    fused); layer 0's four packs through the dual kernels at every served
    M, each ``torch.equal`` to its plain version (a pack with another
    layer's ``rp`` must differ); then served paged through
    ``ContinuousBatchingEngine`` (step graphs) with every dual kernel
    launched, every request DONE, finite prefill logits."""
    import numpy as np
    import torch

    from repro_torch.configs import QuantSpec
    from repro_torch.core.twinquant import fuse_params, quantize_params
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.ref import dual_gemm_group_ref, dual_gemm_ref
    from repro_torch.launch.serve import ContinuousBatchingEngine, Request
    from repro_torch.models import common as C
    from repro_torch.models import dense

    t = time.perf_counter()
    qp = fuse_params(quantize_params(params, cfg, QuantSpec("w4a4", rank=128, group_size=128)))
    _sync(device)
    t_pack = time.perf_counter() - t
    lp0, lp1 = qp.layers[0], qp.layers[1]
    hhd = cfg.n_heads * cfg.head_dim
    packs = {"qkv": (lp0.attn["qkv"], cfg.d_model), "o": (lp0.attn["o"], hhd),
             "gate_up": (lp0.mlp["gate_up"], cfg.d_model), "down": (lp0.mlp["down"], cfg.d_ff)}
    gen = torch.Generator(device=device).manual_seed(21)
    for name, (mod, k) in packs.items():
        w = mod.weights()
        group = isinstance(mod, C.TwinQuantLinearGroup)
        for m in TRAIN_SERVE_MS:
            x = torch.randn(m, k, generator=gen, device=device).to(torch.bfloat16)
            before = _counts()
            y = torch.cat(dispatch.fused_linear(x, w), -1) if group else dispatch.quant_linear(x, w)
            launches, routes = _since(before)
            kern = ("dual_gemv" if m <= 8 else "dual_gemm") + ("_group" if group else "")
            if any("/ref" in r for r in routes) or (device.type == "cuda"
                                                     and launches != {kern: 1}):
                fail(f"train pack {name} M={m}: routes {routes} launches {launches}, want {kern}")
            y_p = dual_gemm_group_ref(x, w) if group else dual_gemm_ref(x, w)
            if not torch.equal(y, y_p):
                fail(f"train pack {name} M={m}: {kern} != plain version ({_unequal(y, y_p)})")
    o0, o1 = lp0.attn["o"].weights(), lp1.attn["o"].weights()
    swapped = dataclasses.replace(o0, rp=o1.rp)
    x = torch.randn(TRAIN_SERVE_SLOTS, hhd, generator=gen, device=device).to(torch.bfloat16)
    if torch.equal(dispatch.quant_linear(x, swapped), dual_gemm_ref(x, o0)):
        fail("train pack: a pack with layer 1's rp equals layer 0's plain version (planted "
             "fault missed)")
    print(f"train pack w4a4 quantize_fuse_s={t_pack:.2f}; layer 0 qkv, o, gate_up, down through "
          f"the dual kernels at M={list(TRAIN_SERVE_MS)} == plain versions: equal; o with layer "
          f"1's rp: differs (planted)", flush=True)
    step = 997
    prompts = [np.asarray(tokens[i * step:i * step + n], np.int32)
               for i, n in enumerate(TRAIN_PROMPTS)]
    state = dense.init_decode_state(cfg, 1, 128, device=device)
    logits = dense.prefill(qp, cfg, torch.as_tensor(prompts[1][None, :], device=device),
                           state)[0]
    if not bool(torch.isfinite(logits).all()):
        fail("train serve: non-finite prefill logits")
    eng = ContinuousBatchingEngine(cfg, qp, batch_slots=TRAIN_SERVE_SLOTS, max_len=256,
                                   device=device, paged=True)
    reqs = [Request(p, max_new=8) for p in prompts]
    launches, _ = _drive("train w4a4 paged", eng, reqs, device, cfg.n_layers)
    duals = ("dual_gemv", "dual_gemv_group", "dual_gemm", "dual_gemm_group")
    if device.type == "cuda" and not all(launches.get(k, 0) > 0 for k in duals):
        fail(f"train serve: a dual kernel never launched: {launches}")
    print(f"train serve trained w4a4 paged: {len(reqs)} requests DONE, prefill logits finite, "
          f"first outputs {[r.out[:4] for r in reqs]}", flush=True)
    del eng, qp


def train_phase(device, card: str, cfg, batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ) -> None:
    """Phase 13: llama3-8b at full width and ``cfg``'s depth trained on the
    repo's own text through the port's training stack, its checks and
    planted faults, then the trained weights packed and served (see the
    module docstring)."""
    import math
    import os
    import shutil
    import tempfile

    import torch

    from repro_torch.data.pipeline import TokenDataset, load_corpus
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import common as C
    from repro_torch.optim import AdamW

    t0 = time.perf_counter()
    cuda = device.type == "cuda"
    tokens = load_corpus()
    ds = TokenDataset(tokens, batch=batch, seq=seq, seed=0)
    print(f"train config {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab} n_layers={cfg.n_layers} (cut from 32) remat="
          f"{cfg.remat} batch={batch}x{seq} corpus_tokens={len(tokens)} card=\"{card}\"",
          flush=True)
    loss0 = train_step_check(device, cfg,
                             [ds.batch_at(i) for i in range(TRAIN_CHECK_BATCHES)])
    _free()
    t1 = time.perf_counter()
    # the loop and the drill run bit for bit under deterministic algorithms
    # (cuBLAS asks for a workspace setting then; one stream needs no other)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev_det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    tmp = Path(tempfile.mkdtemp(prefix="train_ckpt_"))
    try:
        times: list = []
        step_fn = _timed_step(make_train_step(cfg, AdamW(lr=TRAIN_LR)), times, device)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        mgr = drill_manager(tmp, device)
        params, opt_state, losses, end, loop = _run_loop(cfg, step_fn, mgr, ds, device)
        peak = torch.cuda.max_memory_allocated(device) if cuda else "not measured"
        n_re = TRAIN_FAIL_AT - TRAIN_CKPT_EVERY
        first, replay = losses[:TRAIN_FAIL_AT], losses[TRAIN_FAIL_AT:TRAIN_FAIL_AT + n_re]
        unique = first + losses[TRAIN_FAIL_AT + n_re:]  # one loss a step, in order
        fall = unique[0] - sum(unique[-2:]) / 2
        back = unique[-1] - sum(unique[:2]) / 2  # the planted fault: the run reversed
        if (len(unique) != TRAIN_STEPS or not all(math.isfinite(v) for v in losses)
                or not fall >= TRAIN_FALL_MIN):
            fail(f"train losses do not fall by {TRAIN_FALL_MIN}: {losses}")
        if back >= TRAIN_FALL_MIN:
            fail(f"train losses: the reversed run passes the fall check ({back})")
        ms = sorted(times[1:])[len(times[1:]) // 2]
        ntok = batch * (seq - 1)
        size = sum(f.stat().st_size for f in tmp.glob("step_*/*"))
        print(f"train loop steps={TRAIN_STEPS} losses={json.dumps(unique)} fall={fall:.4f} >= "
              f"{TRAIN_FALL_MIN} (reversed: {back:.4f}, caught); step device ms median={ms:.2f} "
              f"(first {times[0]:.2f}) tokens/s={ntok / ms * 1e3:.0f} ({ntok} trained tokens a "
              f"step) max_memory_allocated={peak}", flush=True)
        if loop.restarts != 1 or end != TRAIN_STEPS or mgr.held is None:
            fail(f"train drill: restarts {loop.restarts}, end {end}, restore seen "
                 f"{mgr.held is not None}")
        at_failure, restored, key = mgr.held
        if not restored or at_failure:
            fail(f"train drill: restored state == saved {restored}, state at the failure == "
                 f"saved {at_failure} (planted: must differ); key {key}")
        want = first[TRAIN_CKPT_EVERY:]
        off = first[TRAIN_CKPT_EVERY - 1:TRAIN_FAIL_AT - 1]  # the control: one step early
        if replay != want or replay == off:
            fail(f"train drill: replayed losses {replay}, first pass {want}, one step off {off}")
        print(f"train drill failure before step {TRAIN_FAIL_AT}, restored step "
              f"{TRAIN_CKPT_EVERY}: restarts=1, steps {TRAIN_CKPT_EVERY}-{TRAIN_FAIL_AT - 1} "
              f"replayed == their uninterrupted first pass: equal (bit for bit; one step off: "
              f"differs); restored parameters and moments == saved: equal; the state at the "
              f"failure == saved: differs (planted); checkpoint bytes={size} save_s="
              f"{[round(v, 2) for v in mgr.save_s]} write_s={[round(v, 2) for v in mgr.write_s]} "
              f"restore_s={mgr.restore_s[-1]:.2f} free_disk_bytes={shutil.disk_usage(tmp).free}",
              flush=True)
        del mgr, loop
        _free()
        t2 = time.perf_counter()
        train_compress_check(cfg, params, opt_state, ds.batch_at(TRAIN_STEPS))
        del opt_state
        _free()
        t3 = time.perf_counter()
    finally:
        torch.use_deterministic_algorithms(prev_det)
        shutil.rmtree(tmp)
    train_serve_check(cfg, C.frozen(params), tokens, device)
    del params
    _free()
    t5 = time.perf_counter()
    print(f"train phase seconds: step_check {t1 - t0:.1f} loop_and_drill {t2 - t1:.1f} "
          f"compress {t3 - t2:.1f} pack_serve {t5 - t3:.1f} total {t5 - t0:.1f} "
          f"loss0={loss0:.6f} card=\"{card_line() if cuda else card}\"", flush=True)


SHARD_MOE_LAYERS = 1  # OLMoE-1B-7B's 16 layers cut to the one MoE block (b) runs
SHARD_MOE_BATCH = (2, 1024)  # tokens through the MoE block: 2 sequences of the repo's text


def _shard_group(device):
    """A one-rank process group (NCCL on the card, gloo on the CPU) through a
    ``FileStore`` in a temporary directory: no address, no network. Returns
    the directory, for removal."""
    import tempfile

    import torch.distributed as dist

    tmp = Path(tempfile.mkdtemp(prefix="shard_"))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=dist.FileStore(str(tmp / "store"), 1), rank=0, world_size=1)
    return tmp


def _host_state(params, opt_state) -> dict:
    """Host copies of a train state's parameters and moments, by leaf."""
    from torch.distributed.tensor import DTensor

    def host(t):
        t = t.full_tensor() if isinstance(t, DTensor) else t
        return t.detach().to("cpu", copy=True)

    out = {f"params|{n}": host(p) for n, p in params.named_parameters()}
    out.update((f"mu|{n}", host(t)) for n, t in opt_state.mu.items())
    out.update((f"nu|{n}", host(t)) for n, t in opt_state.nu.items())
    return out


def _two_steps(cfg, batch, device, times: list, ctx=None):
    """(loss of step 1, host state after it) of two train steps from the
    seeded init, under ``ctx`` when given; each step's device ms appended
    to ``times``. The state is freed before returning."""
    import contextlib

    from repro_torch.launch.train import (
        distribute_batch,
        init_train_state,
        make_train_step,
        placement_mismatches,
    )
    from repro_torch.models.context import mesh_context
    from repro_torch.optim import AdamW

    with mesh_context(ctx) if ctx is not None else contextlib.nullcontext():
        opt = AdamW()
        params, state = init_train_state(cfg, opt, seed=0, device=device)
        step = _timed_step(make_train_step(cfg, opt), times, device)
        params, state, loss = step(params, state, batch)
        loss, host = loss.detach().cpu(), _host_state(params, state)
        extra = None
        if ctx is not None:  # the layout check, on the state after step 1
            extra = placement_mismatches(cfg, params, state,
                                         distribute_batch(cfg, batch, ctx, device), ctx)
        step(params, state, batch)
    del params, state
    _free()
    return loss, host, extra


def shard_phase(device, card: str, cfg_dense, cfg_moe, batch: int = TRAIN_BATCH,
                seq: int = TRAIN_SEQ, moe_batch: tuple = SHARD_MOE_BATCH) -> dict:
    """Phase 14: the sharded path (``models/context.py``, ``launch/mesh.py``,
    ``launch/sharding.py``, the EP body of ``models/moe_layer.py``, the
    sharded train step, ZeRO-1 AdamW, the elastic restore) at world size 1
    on a (1, 1) ``("data", "model")`` mesh, the mesh context set and every
    DTensor path taken (see the module docstring). Returns its figures."""
    import copy
    import os
    import shutil

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenDataset, load_corpus
    from repro_torch.launch import sharding as S
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import (
        distribute_batch,
        distribute_params,
        init_train_state,
        placement_mismatches,
    )
    from repro_torch.models import moe_layer as M
    from repro_torch.models.common import trainable
    from repro_torch.models.context import MeshContext, mesh_context
    from repro_torch.models.registry import get_model
    from repro_torch.optim import AdamW

    t0 = time.perf_counter()
    cuda = device.type == "cuda"
    tmp = _shard_group(device)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev_det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    out = {}
    try:
        mesh = make_debug_mesh((1, 1), device=device)
        ctx = MeshContext(mesh=mesh, dp_axes=("data",), tp_axis="model", ep_axis="model",
                          fsdp_axes=("data",))
        tokens = load_corpus()
        # (a) the sharded step against the unsharded one, from one init
        b = TokenDataset(tokens, batch=batch, seq=seq, seed=0).batch_at(0)
        plain_ms, shard_ms = [], []
        loss_p, host_p, _ = _two_steps(cfg_dense, b, device, plain_ms)
        loss_s, host_s, mism = _two_steps(cfg_dense, b, device, shard_ms, ctx)
        unequal = [k for k in host_p if not torch.equal(host_p[k], host_s[k])]
        if not torch.equal(loss_p, loss_s) or unequal or len(host_s) != len(host_p):
            fail(f"shard (a): the sharded step != the unsharded one: loss {float(loss_s)} vs "
                 f"{float(loss_p)}, {len(unequal)} leaves differ {unequal[:3]}")
        if mism:
            fail(f"shard (a): leaves not in the table's placements: {mism[:3]}")
        del host_p, host_s
        _free()
        out["step_ms"] = {"unsharded": plain_ms, "sharded": shard_ms,
                          "ratio": shard_ms[1] / plain_ms[1]}
        print(f"shard (a) {cfg_dense.name} d_model={cfg_dense.d_model} n_layers="
              f"{cfg_dense.n_layers} batch={batch}x{seq} mesh (1, 1) (data, model) world 1 "
              f"({dist.get_backend()}): sharded step == unsharded step (loss {float(loss_s):.6f} "
              f"and every parameter and moment torch.equal); every parameter, moment and batch "
              f"leaf in the table's placements; step device ms unsharded {plain_ms[0]:.2f} then "
              f"{plain_ms[1]:.2f}, sharded {shard_ms[0]:.2f} then {shard_ms[1]:.2f}, ratio "
              f"(second steps) {out['step_ms']['ratio']:.4f} card=\"{card}\"", flush=True)

        # (b) the EP body against the local path, forward and every gradient
        rows = TokenDataset(tokens, batch=moe_batch[0], seq=moe_batch[1], seed=1).batch_at(0)
        model = trainable(get_model(cfg_moe).init_params(cfg_moe, seed=0, device=device))
        x0 = model.embed[torch.as_tensor(rows["tokens"], device=device).reshape(-1)].detach()
        plain = copy.deepcopy(model.layers[0].moe)
        distribute_params(cfg_moe, model, ctx)  # the experts in the table's placements
        moe = model.layers[0].moe
        del model

        def run(fn, p):
            """(out, aux, dx, {name: grad}, device ms) of one forward and
            backward from zero gradients."""
            for q in p.parameters():
                q.grad = None
            x = x0.clone().requires_grad_(True)
            times = []
            y, aux = _timed_step(lambda *a: fn(p, x), times, device)(None, None, None)
            _timed_step(lambda *a: (y.float().square().mean() + aux).backward(), times,
                        device)(None, None, None)
            grads = {n: (q.grad.full_tensor() if hasattr(q.grad, "full_tensor") else q.grad)
                     for n, q in p.named_parameters()}
            return y.detach(), aux.detach(), x.grad, grads, sum(times)

        ep_fn = lambda p, x: M._moe_ep(p, x, cfg_moe)  # noqa: E731
        with mesh_context(ctx):
            run(ep_fn, moe)  # warm: the NCCL communicator starts at the first exchange
            ep = run(ep_fn, moe)
        run(lambda p, x: M._moe_local(p, x, cfg_moe), plain)
        loc = run(lambda p, x: M._moe_local(p, x, cfg_moe), plain)
        diff = [n for n in loc[3] if not torch.equal(loc[3][n], ep[3][n])]
        if not (torch.equal(ep[0], loc[0]) and torch.equal(ep[1], loc[1])
                and torch.equal(ep[2], loc[2])) or diff:
            fail(f"shard (b): _moe_ep != _moe_local: out {torch.equal(ep[0], loc[0])}, aux "
                 f"{torch.equal(ep[1], loc[1])}, dx {torch.equal(ep[2], loc[2])}, grads "
                 f"{diff}")
        # planted: the body's local experts permuted
        ws = {n: torch.roll(plain.experts[n].w.detach(), 1, dims=0) for n in ("gate", "up",
                                                                                "down")}
        with mesh_context(ctx), torch.no_grad():
            bad, _ = M._moe_shard_body(x0, plain.router, ws["gate"], ws["up"], ws["down"],
                                       cfg=cfg_moe, ctx=ctx, ep_axis="model", ep_size=1,
                                       all_axes=("data", "model"))
        if torch.equal(bad, loc[0]):
            fail("shard (b): the EP body with its local experts permuted was not caught")
        out["ep_ms"], out["local_ms"] = ep[4], loc[4]
        print(f"shard (b) {cfg_moe.name} one MoE block E={cfg_moe.n_experts} top-"
              f"{cfg_moe.top_k} d_model={cfg_moe.d_model} d_ff_expert={cfg_moe.d_ff_expert} "
              f"tokens={moe_batch[0]}x{moe_batch[1]}: _moe_ep over the {dist.get_backend()} ep "
              f"group (size 1) == _moe_local: output, aux, dx and every parameter's gradient "
              f"torch.equal; local experts permuted: differs (caught); forward+backward device "
              f"ms (second runs) EP {ep[4]:.2f}, local {loc[4]:.2f} card=\"{card}\"",
              flush=True)
        del loc, ep, plain, bad, ws
        _free()

        # (c) the elastic restore: (b)'s parameters saved, restored replicated
        ckpt = CheckpointManager(tmp / "ckpt", async_save=False)
        ckpt.save(1, {"params": moe})
        want = {n: p.full_tensor().detach().clone() for n, p in moe.named_parameters()}
        ask = (Replicate(), Replicate())
        like = copy.deepcopy(moe)
        with torch.no_grad():
            for p in like.parameters():
                p.to_local().zero_()
        got = ckpt.restore_like(1, {"params": like},
                                shardings={f"params|{n}": (mesh, ask) for n in want})
        bad = [n for n, p in got["params"].named_parameters()
               if not torch.equal(p.full_tensor(), want[n]) or tuple(p.placements) != ask]
        # planted: a restore that ignores the shardings keeps the template's layout
        ignored = CheckpointManager(tmp / "ckpt").restore_like(1, {"params": copy.deepcopy(moe)})
        caught = [n for n, p in ignored["params"].named_parameters()
                  if tuple(p.placements) != ask]
        if bad or not caught:
            fail(f"shard (c): restored leaves not equal or not in the asked placements: "
                 f"{bad[:3]}; a restore without shardings caught: {bool(caught)}")
        print(f"shard (c) elastic restore of (b)'s {len(want)} parameters saved in the table's "
              f"placements, restored replicated: torch.equal, placements as asked; a restore "
              f"ignoring the shardings: caught ({len(caught)} leaves)", flush=True)
        del moe, like, got, ignored, want
        _free()

        # (d) a parameter left out of the table, at the reduced config
        small = get_config("llama3-8b", reduced=True)
        rules = [(pat, fn) for pat, fn in S._rules(small, ctx) if pat.pattern != r"attn/o/w$"]
        with mesh_context(ctx):
            params, state = init_train_state(small, AdamW(), seed=0, device=device)
        planted = trainable(get_model(small).init_params(small, seed=0, device=device))
        distribute_params(small, planted, ctx, rules=rules)
        sb = distribute_batch(small, {k: v[:, :64] for k, v in b.items()}, ctx, device)
        found = placement_mismatches(small, planted, state, sb, ctx)
        clean = placement_mismatches(small, params, state, sb, ctx)
        if clean or sorted(k for k, *_ in found) != [f"params|layers.{i}.attn.o.w"
                                                      for i in range(small.n_layers)]:
            fail(f"shard (d): the spec check on a table without attn/o/w found {found[:3]}, "
                 f"on the table's layout {clean[:3]}")
        print(f"shard (d) a parameter left out of the table (attn/o/w): the spec check catches "
              f"{len(found)} leaves; the table's own layout: none", flush=True)
    finally:
        torch.use_deterministic_algorithms(prev_det)
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"shard phase seconds {out['seconds']:.1f} card=\"{card}\"", flush=True)
    return out


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
    ap.add_argument("--dense-only", action="store_true",
                    help="build, then run the other dense configs' and the VLM phase alone "
                         "(no result line)")
    ap.add_argument("--deepseek-only", action="store_true",
                    help="build, then run the DeepSeek-V3 phase alone (no result line)")
    ap.add_argument("--whisper-only", action="store_true",
                    help="build, then run the Whisper-base phase alone (no result line)")
    ap.add_argument("--zamba2-only", action="store_true",
                    help="build, then run the Zamba2-1.2B phase alone (no result line)")
    ap.add_argument("--xlstm-only", action="store_true",
                    help="build, then run the narrow-tile kernel checks and the xLSTM-1.3B "
                         "phase alone (no result line)")
    ap.add_argument("--train-only", action="store_true",
                    help="build, then run the training phase alone (no result line)")
    ap.add_argument("--train-sweep", metavar="LR,LR,...",
                    help="build, then the training loop's loss fall at each learning rate "
                         "over several data streams (no result line)")
    ap.add_argument("--shard-only", action="store_true",
                    help="build, then run the sharded path's phase alone (no result line)")
    ap.add_argument("--cost-only", action="store_true",
                    help="build, quantize llama3-8b W4A4, then run the cost model's phase alone "
                         "(no result line)")
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
        narrow_phase(device)
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
    if (args.olmoe_only or args.dense_only or args.deepseek_only or args.whisper_only
            or args.zamba2_only or args.xlstm_only):
        from repro_torch.configs import get_config

        if args.olmoe_only:
            t = time.perf_counter()
            olmoe_phase(device, card, get_config("olmoe-1b-7b").replace(n_layers=OLMOE_LAYERS))
            print(f"olmoe phase total seconds {time.perf_counter() - t:.1f}", flush=True)
        if args.dense_only:
            t = time.perf_counter()
            dense_phase(device, card)
            print(f"dense phase total seconds {time.perf_counter() - t:.1f}", flush=True)
        if args.deepseek_only:
            t = time.perf_counter()
            deepseek_phase(device, card, _deepseek_cfg())
            print(f"deepseek phase total seconds {time.perf_counter() - t:.1f}", flush=True)
        if args.whisper_only:
            t = time.perf_counter()
            whisper_phase(device, card, get_config("whisper-base"))
            print(f"whisper phase total seconds {time.perf_counter() - t:.1f}", flush=True)
        if args.zamba2_only:
            t = time.perf_counter()
            zamba2_phase(device, card, get_config("zamba2-1.2b").replace(n_layers=ZAMBA_LAYERS))
            print(f"zamba2 phase total seconds {time.perf_counter() - t:.1f}", flush=True)
        if args.xlstm_only:
            t = time.perf_counter()
            narrow_phase(device)
            xlstm_phase(device, card, get_config("xlstm-1.3b").replace(n_layers=XLSTM_LAYERS))
            print(f"xlstm phase total seconds {time.perf_counter() - t:.1f}", flush=True)
        return
    if args.train_only:
        from repro_torch.configs import get_config

        t = time.perf_counter()
        train_phase(device, card, get_config("llama3-8b").replace(n_layers=TRAIN_LAYERS))
        print(f"train phase total seconds {time.perf_counter() - t:.1f}", flush=True)
        return
    if args.train_sweep:
        from repro_torch.configs import get_config

        train_sweep(device, card, get_config("llama3-8b").replace(n_layers=TRAIN_LAYERS),
                    [float(v) for v in args.train_sweep.split(",")], range(TRAIN_SWEEP_SEEDS))
        return
    if args.shard_only:
        from repro_torch.configs import get_config

        shard_phase(device, card, get_config("llama3-8b").replace(n_layers=TRAIN_LAYERS),
                    get_config("olmoe-1b-7b").replace(n_layers=SHARD_MOE_LAYERS))
        return
    if args.cost_only:
        import tempfile

        import numpy as np

        from repro_torch.configs import QuantSpec, get_config
        from repro_torch.core.twinquant import fuse_params, quantize_params
        from repro_torch.models import dense

        cfg = get_config("llama3-8b").replace(n_layers=SERVE_LAYERS)
        qp = fuse_params(quantize_params(dense.init_params(cfg, seed=0, device=device), cfg,
                                         QuantSpec("w4a4", rank=128, group_size=128)))
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in PROMPT_LENS][:8]
        t = time.perf_counter()
        with tempfile.TemporaryDirectory() as out_dir:
            procs = start_dryrun(out_dir)
            _cost_table_line()
            cost_phase(device, card, cfg, qp, prompts)
            finish_dryrun(procs)
        print(f"cost phase seconds {time.perf_counter() - t:.1f}", flush=True)
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

    import tempfile

    secs = {}
    dryrun_dir = tempfile.TemporaryDirectory()
    t = time.perf_counter()
    table = kernel_phase(device)
    table.update(w4a16_phase(device))
    narrow_phase(device)
    table.update(attention_phase(device))
    secs["kernels"] = time.perf_counter() - t
    from repro_torch.configs import get_config

    t = time.perf_counter()
    procs = start_dryrun(dryrun_dir.name)  # phase 15 (c), read after phase 14
    _cost_table_line()
    secs["cost"] = time.perf_counter() - t
    t, before = time.perf_counter(), secs["cost"]
    launches = serve_phase(device, card, get_config("llama3-8b").replace(n_layers=SERVE_LAYERS),
                           spec_probe=args.spec_probe, secs=secs)
    secs["serve_llama3_8b"] = (time.perf_counter() - t - secs["lifecycle"]
                               - (secs["cost"] - before))
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
    torch.cuda.empty_cache()
    t = time.perf_counter()
    dense_phase(device, card)
    secs["dense_configs"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    deepseek_phase(device, card, _deepseek_cfg())
    secs["deepseek_v3"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    whisper_phase(device, card, get_config("whisper-base"))
    secs["whisper_base"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    zamba2_phase(device, card, get_config("zamba2-1.2b").replace(n_layers=ZAMBA_LAYERS))
    secs["zamba2_1_2b"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    xlstm_phase(device, card, get_config("xlstm-1.3b").replace(n_layers=XLSTM_LAYERS))
    secs["xlstm_1_3b"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    train_phase(device, card, get_config("llama3-8b").replace(n_layers=TRAIN_LAYERS))
    secs["train_llama3_8b"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    shard_phase(device, card, get_config("llama3-8b").replace(n_layers=TRAIN_LAYERS),
                get_config("olmoe-1b-7b").replace(n_layers=SHARD_MOE_LAYERS))
    secs["shard"] = time.perf_counter() - t
    t = time.perf_counter()
    finish_dryrun(procs)
    dryrun_dir.cleanup()
    secs["cost"] += time.perf_counter() - t
    print(f"phase seconds {json.dumps({k: round(v, 1) for k, v in secs.items()})}", flush=True)

    rows = []
    for kname, (source, replaces) in KERNELS.items():
        rows.append(dict(name=kname, route="cuda", source=source, replaces=replaces,
                         launches=launches.get(kname, 0), **table[kname]))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
