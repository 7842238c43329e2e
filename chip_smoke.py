"""Smoke run of the PyTorch port on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

Phases, each printing one JSON line and then one line of its seconds:
  1. device and build: the card, then every CUDA kernel of the port built
     from ``src/repro_torch/kernels/csrc`` with nvcc (one process each);
  2. each kernel against its plain PyTorch version on the card, at the
     shapes of the serving path and at every head dim the reference takes
     (16-256), the continuous path's paged views (B 8, 128-304 slots,
     null-page columns, rows 2-7 fully masked and finite), the served
     archs' shapes (Yi-9B's verify at G 8, hd 128, S 201 and 1024, bf16 and
     float32, and its drafter levels at G 2; Chameleon-34B's verify at G 8;
     MusicGen's verify and drafter levels at hd 64; Gemma-2-9B's verify at
     hd 256 and its drafter levels at hd 128, G 2, softcap 50, at S 201
     and on a paged view of 4,352 slots whose first ~250 the window cuts,
     with null-page columns and a split wholly under the window; the paged
     views within 1e-5 of the plain version's scale; granite-moe-3b-a800m's
     verify at G 3, hd 64 and drafter levels at G 2, hd 64, grok-1-314b's
     verify at G 6, hd 128 and drafter levels at G 2, both with softcap
     30), a second input set run twice for equal outputs, and its time at
     Llama's, Yi's, Gemma's, granite's and grok's verify shapes (Gemma's
     and granite's drafter level and Gemma's paged view too) beside its
     bound, the plain version's and one PyTorch library call's
     (scaled_dot_product_attention, GQA by the library, without a softcap:
     it has none); and the quantized matmul (int8) against its plain
     version at every (K, N) of granite's quantized pair (its lm heads at
     N 49155: an odd N) and of zamba2's (M 4, a recurrent verify's feed,
     and 512), timed at zamba2's target shapes at M 4 beside their bytes
     bound, the plain version's and torch._weight_int8pack_mm's;
  3. full-width tree-speculative serving: Llama-2-7B-Chat with the 115M
     drafter in bf16, random weights from fixed seeds, 4 requests, prompt
     128, 64 new tokens, tree (2, 2), temperature 0.7; the tree attention
     kernel must be launched (32 + 4 * 3) = 44 times per round;
  4. full-width chain serving (gamma 3) and the autoregressive baseline on
     the same weights;
  5. greedy exactness at full width with 2 target layers in float32: tree
     and chain tokens must equal the target's greedy tokens;
  6. each distill-loss kernel (row_logsumexp, loss_terms, loss_grad)
     against its plain version at the full-width chunk (N 2048, V 32000), a
     ragged one (N 37, V 32003, one input at an unaligned row stride) and a
     small one (N 16, V 1000), in all three modes with a masked-out row;
     then their times beside their bounds, the plain versions' and, for
     row_logsumexp, torch.logsumexp's;
  7. drafter training at full width: Llama-2-7B-Chat (bf16, frozen)
     generates the distillation data (8 seed prompts of 128 tokens at
     temperatures 0 and 0.7, 64 response tokens, packed into one 2048-token
     chunk); the 115M drafter (float32 master weights) takes 2 pretraining
     steps and 3 TVD++ steps on 4 x 2048 tokens through the kernels, with
     the launch counts asserted, and one step of the kernel route is held
     against the plain route;
  8. the same comparison in float32 with 2 target layers;
  9. the quantized matmul (int8, and int4 with group 64) against its plain
     version within 1e-4 of the output's scale, at every (K, N) of the
     quantized target and drafter and every M phase 10 gives it (4, 8, 16,
     28 and 512), x in bf16 and float32, with and without an AWQ
     pre-scale, and at a ragged shape; the rows of an M 28 batch must come
     out bit for bit the same inside M 4, 16 and 512 batches (greedy
     exactness rests on it); a copy of the kernel that rounds the int4
     weight q*s to bf16 must fail the tolerance; then its times at the
     target's shapes at M 16, 28 and 512 beside their bounds, the plain
     version's, the library call's that computes the same function with
     bf16 scales (torch._weight_int8pack_mm, torch._weight_int4pack_mm;
     held against the plain version first), and cuBLAS's bf16 matmul on
     the unquantized weight;
 10. full-width quantized serving: Llama-2-7B-Chat and its drafter drawn in
     float32, AWQ-calibrated on datagen batches of the target, quantized to
     int8 and then to int4 weights, with int8 KV caches; tree (2, 2) and
     chain (gamma 3) over 4 x (128 + 16) at temperature 0.7, the launch
     counts asserted (each
     forward pass of a quantized model launches the kernel 7 * layers + 1
     times);
 11. greedy exactness under int8 and int4 weights with 2 target layers in
     float32: tree and chain tokens must equal the quantized target's
     greedy tokens;
 12. flash decode (run after phase 4, on its models): the kernel against
     its plain version within 1e-5 of the output's scale, on the tensor
     cores (bf16 at hd 32-256) or the CUDA cores (fp32, hd 16), at the
     decode shapes of the pair (B 4, Hkv 32 and 8, G 1, hd 128, S of the
     chain cache, 1024 and 4096, bf16 and float32, K/V through an int8
     cache), of the pipeline configs (hd 32 G 3, hd 16 G 2) and of the
     reference's kernel benchmark (Hkv 4, G 2, S 1024, float32), of Yi-9B's
     decode (Hkv 4, G 8, S 1024 to 16384, bf16 and float32), Phi-4-mini's
     (Hkv 8, G 3, S 4096) and Chameleon-34B's (Hkv 8, G 8), with softcap,
     ragged S, empty ring slots, a fully masked row and G 17 (two row
     tiles); a second input set run twice must give equal outputs; a copy
     of the kernel with a bf16 accumulator (CUDA cores) and one that drops
     p's lo term (tensor cores) must each fail that tolerance on every case
     whose output it changes; the port's
     decode attention at full width (target layers 0 and 31, also with an
     int8 cache, drafter layers 0 and 3) against the route through
     ``ops.flash_decode_attention``, whose launches are counted; its times,
     with each shape's splits, cluster and route, beside
     the bound, the plain version's and scaled_dot_product_attention's.
     No serving phase launches it, as in the reference;
 13. the paper's pipeline (``repro_torch.experiments.run_pipeline``) at the
     reference's --quick sizes: pretraining, chat-SFT, datagen, KLD/TVD/
     TVD++ fine-tuning, tau and MBSU;
 14. the training CLI (``repro_torch.launch.train --reduced``), pretrain
     and TVD++ distill, 10 steps each, in subprocesses;
 15. tree serving of the reduced config (head dim 32) through the serving
     CLI in a subprocess, its tree_attention launches counted;
 16. continuous serving of the full-width pair (after phase 12, on phase
     3's models): 16 chat-mix requests (Poisson arrivals at 4/s, 48-64
     prompt tokens with a 40-token shared preamble, 8-16 new tokens)
     through ``ContinuousEngine`` with 8 slots, 16-slot pages and 32-token
     prefill chunks, at temperature 0.7: tree (2, 2) with the prefix
     cache, chain gamma 3 without it, and tree again with int8 KV pools;
     then tree and chain with all 16 requests at t = 0 (the engine's own
     throughput, not bounded by the arrival span); the script re-executes
     itself with PYTHONHASHSEED=0 so that the chat mix's preamble, seeded
     by hash(name), is the same in every run; every request must finish
     with its max_new tokens and tree_attention must be launched 44 times
     per tree round; tok/s beside the arrival span, tau, MBSU, TTFT/TPOT
     p50/p99 (over 16 requests p99 is their maximum), queue and pool
     telemetry, prefix hit rate, peak memory, and
     host and device ms per decode round of 8 active rows (torch.profiler);
 17. greedy exactness of the continuous engine with 2 target layers in
     float32: 4 requests of different lengths through 2 slots, chain and
     tree, must give the static chain and tree generation's tokens with fp
     KV, int8 KV and int8 weights on both models; the prefix cache on and
     off must give the same tokens, and so must every observability hook
     on (fenced phases included) and off, chain and tree;
 18. the serving CLI's --continuous branch at full width in subprocesses
     (the first 8 chat-mix requests through 4 slots, so that some queue
     and retired slots are reused): tree with the prefix cache, int8
     weights on both models and int8 KV and every observability flag (its
     trace, metrics, flight bundles, torch.profiler trace and printed
     reports checked), then chain in bf16; each must serve all 8, its
     printed kernel launches checked (44 tree_attention launches a round);
 19. self-speculative serving with draft heads on phase 3's target (after
     phase 16, no drafter model): an EAGLE head (one block with 32 heads,
     d_ff 16384, 302.0M parameters) and Medusa heads (K 4, 67.1M) from
     seeds, each by tree (2, 2) and chain gamma 3 over 4 x (128 + 64) at
     temperature 0.7, then the first 8 requests of phase 16's chat-mix
     stream through 4 slots of the continuous engine by tree with EAGLE
     heads and the prefix cache (some requests must queue);
     tree_attention must be launched exactly 32 times per tree round (the
     verify pass only) and never in a chain round, every request must
     finish with its max_new tokens, and the engine must hold no drafter
     pool; tau, MBSU, tok/s, TTFT/TPOT, peak memory, the eager draft time
     per level, and host and device ms per round (torch.profiler);
 20. greedy exactness with heads at full width with 2 float32 target
     layers: EAGLE and Medusa, chain and tree, static and continuous (4
     requests through 2 slots) must give the target's greedy tokens;
 21. head distillation at full width: EAGLE and Medusa heads (float32
     master weights) take 2 TVD++ steps each against the frozen bf16 target
     on 4 x 1024 tokens of its own datagen responses, with finite losses
     and moving parameters; a head checkpoint saved, loaded and served by
     tree; then the training CLI (--reduced --draft-head eagle --save), the
     serving CLI from that checkpoint by tree, and the --continuous --tree
     --draft-head eagle serving CLI at full width on 8 chat-mix requests
     through 4 slots (some must queue), in
     subprocesses, their printed launches checked;
 22. observability of the continuous engine at full width (after phase 19,
     on phase 3's models): the first 8 requests of phase 16's stream by
     tree (2, 2) with the prefix cache at temperature 0.7 in three
     passes: (a) every hook off,
     (b) tracer, metrics registry with JSONL snapshots, quality telemetry,
     flight recorder and an SLO of TTFT 1 ms that must breach, (c) (b)
     with the fenced draft/verify/commit/prefill phases inside
     torch_profile; each must finish all 8 requests with 44
     tree_attention launches a round; the trace must rebuild every TTFT
     within 1 ms, the registry count every committed token, the JSONL,
     Prometheus and breach bundle parse, the phase split sum to the step
     time; a round at 8 decode rows must make one device-to-host copy with
     quality on; prints the hook cost ((a) against (b): tau, tok/s, host
     and device ms per round; the passes a then b, one profiled window
     each, b then a), (c)'s phase split with each phase's device
     span (CUDA events) and busy time (the profiler's kernels), the
     roofline attribution at 3350 GB/s, the quality summary and the
     acceptance report;
 23. the architecture registry (after phase 22, once phase 3's models are
     freed): (a) Yi-9B at full width (48 layers, d 4096, 32 heads on 4 KV
     heads, V 64000; 8.83B parameters) with its drafter (4 layers, d 1024)
     in bf16 from seeds 0/1, tree (2, 2) and chain gamma 3 over 4 x (128 +
     32) at temperature 0.7: 48 + 4 * 3 = 60 tree_attention launches a tree
     round (tree_attention at G 8), tau, MBSU with c from param_count,
     tok/s, peak memory, host and device ms per round (torch.profiler);
     (b) the first 8 requests of phase 16's chat stream through 4 slots of
     the continuous engine by tree with the prefix cache (some must
     queue), every request
     finished at 60 launches a round; (c)
     greedy exactness with 2 float32 target layers at Yi's width: chain
     and tree, static and continuous (4 requests through 2 slots), equal
     to the target's greedy tokens; (d) the same by tree over 2 x (64 +
     16) for Phi-4-mini (G 3, V 200064), Minitron-4B (G 3, V 256000) and
     Chameleon-34B (qk-norm, d 8192, 64 heads on 8) at published widths,
     2 + 12 launches a tree round; (e) the serving CLI by tree at full
     width in subprocesses for Yi-9B and MusicGen-large (its single-
     codebook variant: the note must be printed), launches checked
     (run in the wide CliPool, read after phase 13);
 24. Gemma-2-9B (after phase 23, once Yi is freed): (a) at full width (42
     layers alternating local_attn and attn, window 4,096, 16 heads on 8
     KV heads at hd 256, softcaps 50/30, scaled embeddings, V 256000;
     10.16B parameters) with its drafter (4 layers, d 1024; 0.571B) in
     bf16 from seeds 0/1, tree (2, 2) and chain gamma 3 over 4 x (128 +
     32) at temperature 0.7, within the window: 42 + 4 * 3 = 54
     tree_attention launches a tree round and no other kernel, tau, MBSU
     with c from param_count, tok/s, peak memory, host and device ms per
     round; (b) the continuous engine by tree over 4 requests of 4,160
     seeded tokens + 64 new at t = 0 (8 slots, 16-slot pages, 512-token
     prefill chunks): every request decodes past position 4,096, launches
     checked; (c) greedy exactness with 2 float32 target layers (one of
     each kind) at published widths and the float32 drafter: within the
     window static and continuous, past it (4,160 tokens) and with
     long_context (8,256: the global layers window at 8,192) the static
     chain and tree and the continuous engine by chain and tree, each
     equal to static AR with the same long_context; (d) the serving CLI
     by tree at full width, launches checked (in the wide CliPool);
 25. mixture of experts (after phase 24, once Gemma is freed): (a)
     granite-moe-3b-a800m at full width (32 layers, d 1536, 24 heads on 8
     KV heads at hd 64, 40 experts top-8 of width 512, V 49155; 3.374B
     parameters) with its dense drafter (4 layers, d 512; 62.1M) in bf16
     from seeds 0/1, tree (2, 2) and chain gamma 3 over 4 x (128 + 32) at
     temperature 0.7: 32 + 4 * 3 = 44 tree_attention launches a tree round
     and no other kernel (the experts are batched matmuls, as the
     reference's einsums), tau, tok/s, host and device ms per round, the
     device shares of the expert matmuls and of the dispatch
     (torch.profiler), the (token, expert) assignments dropped per verify
     pass (counted here by a wrapper, at the config's capacity factor
     1.25), and one input through the full forward twice for equal bits;
     (b) the first 8 requests of phase 16's chat stream through 4 slots
     of the continuous engine by tree with the prefix cache; (c) int8
     weights on both models (granite's attention projections and lm head
     through quant_matmul, its experts and routers at full precision),
     launches asserted, stored bytes beside quant.roofline's model; (d)
     greedy exactness with 2 float32 target layers at published widths at
     capacity factor E / k (nothing drops): chain and tree equal to AR for
     granite (static and continuous) and grok-1-314b (d 6144, 8 experts
     top-2 of width 32768, softcap 30, V 131072; 46 GB), and at 1.25 the
     drops and the agreement with AR printed, asserted neither; (e) 2
     TVD++ steps of granite's drafter against the frozen bf16 target
     through the distill kernels at V 49155, launches asserted, one step's
     kernel route against the plain route as in phase 7; (f) the serving
     CLI by tree at full width, launches checked (in the wide CliPool);
 26. recurrent layers and hybrids (after phase 25): (a) zamba2-7b at
     full width (81 blocks: 70 Mamba2 of d_in 7168, 112 SSD heads of 64,
     N 64, chunk 128, and 11 applications of 2 shared attention+MLP sets,
     32 heads at hd 112, d_ff 14336; V 32000) with its drafter (7 blocks
     of (mamba, mamba, shared_attn), d 1024) in bf16 from seeds 0/1, chain
     gamma 3 and AR over 4 x (128 + 32) at temperature 0.7 (a recurrent
     model is fed one token a call and rewound by snapshots; no kernel is
     launched): tau, MBSU with c from param_count beside the init's
     count, tok/s, host and device ms a round, the device shares of the
     SSD scan, the conv, the matmuls and the snapshot rewind
     (torch.profiler), the snapshots' bytes, weights and peak GB, equal
     bits twice; (b) the same for xlstm-1.3b (48 blocks of alternating
     mLSTM and sLSTM, d 2048, 4 heads, V 50304) and its drafter (4
     blocks, d 512); (c) greedy exactness in float32: zamba2 cut to 7
     blocks with its drafter, itself and an untrained EAGLE head, xlstm
     cut to 2 blocks with its drafter and itself; (d) zamba2 at int8 with
     AWQ on (shared sets per set by plain absmax, lm heads with AWQ),
     int8 KV on its shared attention caches, chain over 4 x (128 + 16)
     with quant_matmul's launches asserted, stored against modeled
     bytes, and xlstm's int8 refused (ROADMAP §3 item 9); (e) 2 TVD++
     steps of zamba2's drafter against the full-width frozen target at 2
     x 1024, V 32000, through the distill kernels, launches asserted, the
     kernel route against the plain route; (f) the serving CLI for
     zamba2 by chain (exit 0, no kernel; in the wide CliPool) and with
     --tree (exit 1 with the reference's refusal, no traceback);
 27. MusicGen-large with its four codebooks (after phase 26): (a) at
     published width (48 layers, d 2048, 32 heads of 64, d_ff 8192, V
     2048; 3,254,978,560 parameters, held and by param_count) in bf16 from
     seed 0, prefill of 4 x (4, 128) ids and 64 greedy decode steps of 4
     ids a row, the logits of steps 0, 31 and 63 within 5e-2 relative L2
     of a full forward of the same ids; ms a step, frames/s, the device ms
     of a step (torch.profiler) against the dry run's H100 memory term for
     B 4 and a cache of 192 on one card, weights and peak GB; (b) one CE
     and AdamW step at K 4 and published width cut to 32 layers, float32
     master weights, remat, 1 x (4, 1024) tokens: ms, peak GB, a loss
     within 1 of ln V; (c) the dry-run CLI for musicgen-large x
     decode_32k and yi-9b x train_4k in subprocesses (exit 0, CUDA never
     initialised), and the dry run of (a)'s shape: its argument bytes
     within 1% of the memory the real params and cache took, its counted
     FLOPs equal to FlopCounterMode on the real decode step; no kernel
     launched in (a) or (b). The CLIs start before phase 27, run beside
     phases 27, 28, 7, 10 and 21 on the host's cores, and are read
     after phase 21;
 28. the sharded step (after phase 27) on a world of one over NCCL, a (1,
     1) mesh named data, model (NCCL refuses two ranks on one card): (a)
     granite's MoE layer at published width in bf16 at cf 1.25 and E/k
     through its mesh paths (baseline and optimized at 28 and 512 tokens,
     the weight-stationary path at 28 and 4) against the path without a
     mesh, within 1e-2 of its scale, with the collective bytes by kind,
     the NCCL kernels the profiler sees, and ms with and without the mesh;
     (b) phase 25d's set-up served greedily by tree with the mesh
     installed, in both profiles: tokens equal to those without it, 2 + 4
     x 3 tree_attention launches a round; (c) after phase 21, the dry-run
     CLIs' collective term and one rank's peak, and the one-card sharded
     trace of (27a)'s decode step: its peak within 1% of the growth of
     max_memory_allocated over the real step from before its params.
 29. the static analysis (``repro_torch.analysis``; after phase 22, on
     phase 3's models): (a) one chain round (gamma 3) and one tree round
     (2, 2) of the full-width pair, after a warm-up round, under
     ``torch.cuda.set_sync_debug_mode("error")``: no sync, every state
     leaf's shape, dtype and device unchanged, every cache leaf in its
     storage, 44 tree_attention launches in the tree round; (b) a warm
     continuous engine with 8 slots, chain and tree: one fetch and one
     ``Memcpy DtoH`` (the profiler) a decode round with no other sync,
     and over 16 more rounds no kernel build or load and no growth of the
     caching allocator's segments or device allocations; (c) the kernel
     lint on the card, every instance of the seven kernels (registers,
     static and dynamic shared memory, blocks an SM, spills) against
     Hopper's limits and the launch plans at the swept shapes, 0 errors,
     and ``python -m repro_torch.analysis --all --json`` in a subprocess
     beside phases 27 to 21 (read after phase 21), exit 0.
Phase 29 runs after phase 22, then phases 23-28, 7, 10, 21, 5, 17, 20, 8,
11 and 13; then the checks of the CLI runs (14, 15, 18, 21, 23e, 24d, 25f
and 26f), and phases 6 and 9 last. The CLI runs go in two pools of
subprocesses (``CliPool``) beside the phases: the reduced config's from
phase 28 to 21, those at full width from phase 5 to 13, within a budget of
the card's memory. Then the ``kernels`` line, the
card's name and power limit as nvidia-smi gives them, and last ``{"ok":
true, "device": ...}``. Any failure raises and ends the run with a
non-zero exit code and no result line.
"""
import atexit
import bisect
import contextlib
import dataclasses
import gc
import hashlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}   # dense, 700 W
# max abs error against the plain version: both sum fp32 products in
# another order; bf16 inputs carry 8 bits of mantissa, so their bound is
# set by the working type
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DISTILL_CU = "src/repro_torch/kernels/csrc/distill_loss.cu"
QUANT_CU = "src/repro_torch/kernels/csrc/quant_matmul.cu"
KERNEL_ROUTES = {   # name -> (route, source, TPU kernel it replaces)
    "tree_attention": ("cuda", "src/repro_torch/kernels/csrc/tree_attention.cu",
                       "src/repro/kernels/tree_attention.py:85"),
    "flash_decode": ("cuda", "src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:73"),
    "row_logsumexp": ("cuda", DISTILL_CU, "src/repro/kernels/distill_loss.py:78"),
    "loss_terms": ("cuda", DISTILL_CU, "src/repro/kernels/distill_loss.py:148"),
    "loss_grad": ("cuda", DISTILL_CU, "src/repro/kernels/distill_loss.py:185"),
    "quant_matmul_int8": ("cuda", QUANT_CU, "src/repro/kernels/quant_matmul.py:131"),
    "quant_matmul_int4": ("cuda", QUANT_CU, "src/repro/kernels/quant_matmul.py:131"),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters=50, warmup=5):
    """Mean time of ``fn`` on the card from CUDA events over ``iters``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=200):
    """Device time of ``fn``: ``iters`` calls captured in one CUDA graph and
    replayed between CUDA events, so the host's launch cost drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return cuda_ms(graph.replay, iters=5, warmup=1) / iters


def tree_inputs(gen, B, Hkv, N, G, hd, S, dtype):
    """Inputs of the tree attention kernel: a committed prefix every node
    sees, then the tree region under a random ancestor-like mask."""
    dev = "cuda"
    q = torch.randn((B, Hkv, N, G, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, S, Hkv, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, S, Hkv, hd), generator=gen, device=dev).to(dtype)
    mask = torch.rand((B, N, S), generator=gen, device=dev) < 0.5
    mask[:, :, : S // 2] = True
    mask[0, 0] = False           # one fully masked row: it averages V
    return q, k, v, mask


GEMMA_WINDOW = 4096              # gemma2_9b's sliding window
GEMMA_VIEW = 272 * 16            # 4,352 slots: a row 256 slots past it
GEMMA_SOFTCAP = 50.0
GEMMA_TREE_DEPTHS = (0, 1, 1, 2, 2, 2, 2)      # tree (2, 2)
# the tensor-core instance that bf16 at hd 256 (Gemma's verify) launches
HD256_INSTANCE = "tree_attention_mma_ring<256>"
# the paged cases' tolerance, relative to max |plain version|: the kernel
# and the plain version both compute in fp32 from the same inputs (a
# wholly masked split given any weight moves the output far more)
PAGED_TOL_REL = 1e-5


def paged_tree_inputs(gen, B, Hkv, N, hd, S, dtype, G=1, lens=None,
                      window=None, page=16, dev="cuda"):
    """Tree attention's inputs as ``paged_decode_attention`` builds them:
    K/V gathered through a page table (pages in random order) from a pool
    whose page 0, the null page, is zero. Active row b fills ``lens[b]``
    slots (default: rows 0 and 1 at S - page - 3 and S // 2 + 5), its N
    tree nodes last; its nodes see the committed prefix and a random subset
    of the tree region, table entries past it are 0, and row 1 shares row
    0's first two pages (a prefix-cache hit). Rows past ``len(lens)`` are
    inactive (table all 0, mask all False), as ``masked_page_table`` leaves
    them. With ``window``, a node at position p (its row's committed length
    plus its depth: the tree (2, 2)'s for N 7, else one level's) sees no
    slot at or below p - window, as a Gemma-2 local layer past its window."""
    lens = torch.tensor(lens or (S - page - 3, S // 2 + 5), device=dev)
    A, pages = len(lens), S // page
    P = A * pages + 1
    kpool = torch.randn((P, page, Hkv, hd), generator=gen, device=dev).to(dtype)
    vpool = torch.randn((P, page, Hkv, hd), generator=gen, device=dev).to(dtype)
    kpool[0], vpool[0] = 0, 0
    perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
    table = torch.zeros((B, pages), dtype=torch.long, device=dev)
    table[:A] = perm.reshape(A, pages)
    if A > 1:
        table[1, :2] = table[0, :2]
    table[:A][torch.arange(pages, device=dev)[None]
              >= -(-lens[:, None] // page)] = 0
    col = torch.arange(S, device=dev)
    valid = table.repeat_interleave(page, 1) != 0
    valid[:A] &= col[None] < lens[:, None]
    tree = torch.rand((B, N, S), generator=gen, device=dev) < 0.5
    tree[:A] |= col[None, None] < (lens - N)[:, None, None]  # the prefix
    mask = valid[:, None, :] & tree
    if window is not None:
        depths = torch.tensor(GEMMA_TREE_DEPTHS if N == 7 else (0,) * N,
                              device=dev)
        pos = (lens - N)[:, None] + depths[None]             # (A, N)
        mask[:A] &= col[None, None] > (pos - window)[:, :, None]
    q = torch.randn((B, Hkv, N, G, hd), generator=gen, device=dev).to(dtype)
    k = kpool[table].reshape(B, S, Hkv, hd)
    v = vpool[table].reshape(B, S, Hkv, hd)
    return q, k, v, mask


def masked_splits(mask, chunk):
    """Splits of ``chunk`` slots in which every node of some row is masked
    while the row sees some slot (the combine must give them weight 0)."""
    B, N, S = mask.shape
    seen = mask.any(1)                                       # (B, S)
    return sum(int(not seen[b, i:i + chunk].any())
               for b in range(B) if seen[b].any() for i in range(0, S, chunk))


def check_paged_tree_cases(gen):
    """Tree attention on the continuous path's paged views, within
    PAGED_TOL_REL of the plain version's scale, every row finite. Llama's
    shapes (B 8, target verify Hkv 32 N 7, drafter levels Hkv 8 N 1/2/4,
    views of 8, 13 and 19 pages of 16 slots, widths that are not multiples
    of the split sizes) with rows 2-7 fully masked: at least one shape must
    split its slots across blocks (the combine then merges fully masked
    partials). Gemma-2-9B's past its window on 272 pages, softcap 50: the
    verify pass (Hkv 8, N 7, G 2, hd 256) and the drafter levels (Hkv 4,
    N 1/2/4, G 2, hd 128) at B 4, and both at B 1, whose plan splits the
    slots finely enough that a whole split lies under the window: at least
    one split must be wholly masked there. granite-moe-3b-a800m's on views
    of 19 pages (phase 25b): the verify pass (Hkv 8, N 7, G 3, hd 64) and
    the drafter levels (Hkv 4, N 1/2/4, G 2, hd 64), at B 4 (rows 2-3
    inactive) and B 1, bf16 and fp32."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import tree_attention as tk
    bf, f32 = torch.bfloat16, torch.float32
    llama = [(label, 8, Hkv, N, 1, 128, S, dt, None, None)
             for label, Hkv, N in (("paged-target", 32, 7),
                                   ("paged-drafter", 8, 1),
                                   ("paged-drafter", 8, 2),
                                   ("paged-drafter", 8, 4))
             for S in (128, 208, 304) for dt in (bf, f32)]
    gemma = [(label, B, Hkv, N, 2, hd, GEMMA_VIEW, dt,
              [GEMMA_VIEW - 1 - 16 * b for b in range(B)], GEMMA_WINDOW)
             for label, B, Hkv, N, hd, dt in (
                 ("gemma-verify-paged", 4, 8, 7, 256, bf),
                 ("gemma-verify-paged", 4, 8, 7, 256, f32),
                 ("gemma-verify-paged", 1, 8, 7, 256, bf),
                 ("gemma-verify-paged", 1, 8, 7, 256, f32),
                 ("gemma-drafter-level-paged", 4, 4, 1, 128, bf),
                 ("gemma-drafter-level-paged", 4, 4, 2, 128, bf),
                 ("gemma-drafter-level-paged", 4, 4, 4, 128, bf),
                 ("gemma-drafter-level-paged", 4, 4, 4, 128, f32),
                 ("gemma-drafter-level-paged", 1, 4, 4, 128, bf),
                 ("gemma-drafter-level-paged", 1, 4, 4, 128, f32))]
    granite = [(label, B, Hkv, N, G, 64, 304, dt, None if B == 4 else [285],
                None)
               for label, Hkv, N, G in (("granite-verify-paged", 8, 7, 3),
                                        ("granite-drafter-level-paged", 4, 1, 2),
                                        ("granite-drafter-level-paged", 4, 2, 2),
                                        ("granite-drafter-level-paged", 4, 4, 2))
               for B in (4, 1) for dt in (bf, f32)]
    results = []
    for label, B, Hkv, N, G, hd, S, dtype, lens, window in llama + gemma + granite:
        q, k, v, mask = paged_tree_inputs(gen, B, Hkv, N, hd, S, dtype, G=G,
                                          lens=lens, window=window)
        cap = GEMMA_SOFTCAP if window else None
        got = tk.tree_attention(q, k, v, mask, softcap=cap)
        want = ref.ref_tree_attention(q, k, v, mask, softcap=cap)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        ok = (bool(torch.isfinite(got).all())
              and err <= PAGED_TOL_REL * scale)
        plan = tk.launch_plan(B, Hkv, N, G, hd, S, dtype, tk._sm_count(0))
        chunk, splits = plan.chunk, plan.splits
        results.append({"case": label, "B": B, "Hkv": Hkv, "N": N, "G": G,
                        "hd": hd, "S": S, "page": 16,
                        "dtype": str(dtype).split(".")[-1], "softcap": cap,
                        "window": window, "tensor_cores":
                            tk.on_tensor_cores(hd, q.element_size()),
                        "instance": plan.launches[0].symbol,
                        "chunk": chunk, "splits": splits,
                        "wholly_masked_splits": masked_splits(mask, chunk),
                        "max_abs_want": scale, "max_abs_err": err,
                        "tol": PAGED_TOL_REL * scale, "ok": ok})
        if not ok:
            emit({"phase": 2, "paged_cases": results})
            raise AssertionError(f"tree_attention disagrees with its plain "
                                 f"version on a paged view: {results[-1]}")
    assert any(r["splits"] > 1 for r in results[:len(llama)]), results
    assert any(r["wholly_masked_splits"] > 0
               for r in results[len(llama):len(llama) + len(gemma)]), results
    check_hd256_instance(results)
    return results


def check_hd256_instance(results):
    """Every bf16 case at hd 256 ran the tensor-core instance."""
    hd256 = [r for r in results if r["hd"] == 256 and r["dtype"] == "bfloat16"]
    assert hd256 and all(r["tensor_cores"] and r["instance"] == HD256_INSTANCE
                         for r in hd256), hd256


def tree_bound_ms(q, k, v, mask):
    """Least time for the card: each input read once, the fp32 output
    written once, against 4*hd flops per (query row, slot)."""
    B, Hkv, N, G, hd = q.shape
    S = k.shape[1]
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, mask))
    nbytes += q.numel() * 4
    flops = 4.0 * hd * B * Hkv * N * G * S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase1_device_and_build():
    from repro_torch.analysis.kernel_lint import ptxas_report
    from repro_torch.kernels import build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    start_kernel_copies()        # phase 12's controls, built alongside
    logs = build.build_all(sorted({Path(src).stem
                                   for _, src, _ in KERNEL_ROUTES.values()}))
    ptxas = {name: ptxas_report(log) for name, log in logs.items()}
    emit({"phase": 1, "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "build_s": round(time.perf_counter() - t0, 3), "ptxas": ptxas})
    return smi


def phase2_kernels():
    """Every kernel against its plain version at the serving shapes: target
    verify (Hkv 32, N 7), drafter levels (Hkv 8, N 1/2/4), G 3, a ragged
    cache width (201 = 128 + 64 + 7 + 2) and a tiled one (1024), bf16 and
    f32, once with softcap; every other head dim the reference takes (the
    reduced config's 32, the pipeline drafter's 16, gemma2_9b's 256) and a
    tree of 13 nodes at G 3; at hd 256 in bf16 the tensor-core instance
    (``HD256_INSTANCE``, asserted for every such case) at two row tiles, at
    G 1 and at S 197, with more than one split at Gemma's verify. A second
    input set run twice must give equal outputs (the split combine is in a
    fixed order; hd 128 and 256 on the tensor cores, fp32 on the CUDA
    cores). Then the continuous
    path's paged views with whole batches of fully masked rows, and the
    shapes of the registry's served archs (Yi-9B's verify at G 8, S 201 and
    1024, and its drafter levels at G 2; Chameleon's verify at G 8;
    MusicGen's at hd 64). Times at Llama's and Yi's verify shapes."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import tree_attention as tk
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    cases = [  # (label, B, Hkv, N, G, hd, S, dtype, softcap)
        ("target-verify", 4, 32, 7, 1, 128, 201, bf, None),
        ("target-verify", 4, 32, 7, 1, 128, 201, f32, None),
        ("target-verify", 4, 32, 7, 1, 128, 1024, bf, None),
        ("target-verify", 4, 32, 7, 1, 128, 1024, f32, None),
        ("drafter-level", 4, 8, 1, 1, 128, 201, bf, None),
        ("drafter-level", 4, 8, 2, 1, 128, 201, bf, None),
        ("drafter-level", 4, 8, 4, 1, 128, 201, f32, None),
        ("gqa", 4, 8, 7, 3, 128, 201, bf, None),
        ("gqa", 2, 4, 7, 3, 64, 1024, f32, None),
        ("softcap", 4, 32, 7, 1, 128, 201, bf, 50.0),
        *[(f"hd{hd}", 4, hkv, 7, G, hd, 201, dt, None)
          for hd, hkv, G in ((16, 2, 2), (32, 4, 1), (256, 8, 2))
          for dt in (bf, f32)],
        ("N13-G3", 2, 4, 13, 3, 128, 201, bf, None),
        # the registry's served archs (phase 23): Yi-9B's verify pass (32
        # heads on 4 KV heads: G 8, 56 query rows a KV head) and drafter
        # levels (8 on 4: G 2), Chameleon-34B's verify (64 on 8), and
        # MusicGen's (MHA at hd 64) verify and drafter levels
        *[("yi-verify", 4, 4, 7, 8, 128, S, dt, None)
          for S in (201, 1024) for dt in (bf, f32)],
        *[("yi-drafter-level", 4, 4, N, 2, 128, 201, dt, None)
          for N, dt in ((1, bf), (2, bf), (4, bf), (4, f32))],
        ("chameleon-verify", 4, 8, 7, 8, 128, 201, bf, None),
        ("musicgen-verify", 4, 32, 7, 1, 64, 201, bf, None),
        ("musicgen-drafter-level", 4, 8, 4, 1, 64, 201, bf, None),
        # Gemma-2-9B (phase 24): the verify pass at hd 256 (16 heads on 8,
        # G 2) and the drafter levels at hd 128 (8 on 4), softcap 50
        *[("gemma-verify", 4, 8, 7, 2, 256, 201, dt, GEMMA_SOFTCAP)
          for dt in (bf, f32)],
        *[("gemma-drafter-level", 4, 4, N, 2, 128, 201, dt, GEMMA_SOFTCAP)
          for N, dt in ((1, bf), (2, bf), (4, bf), (4, f32))],
        # the edges of the tensor-core instance at hd 256: two row tiles
        # (N 13, G 2: 26 rows), 7 of a tile's 16 rows (N 7, G 1), and an S
        # that is no multiple of its 64-slot step
        *[(label, 4, 8, N, G, 256, S, bf, GEMMA_SOFTCAP)
          for label, N, G, S in (("hd256-N13-G2", 13, 2, 201),
                                 ("hd256-N7-G1", 7, 1, 201),
                                 ("hd256-S197", 7, 2, 197))],
        # the MoE archs (phase 25): granite-moe-3b-a800m's verify (24 heads
        # on 8, G 3, hd 64) and drafter levels (8 on 4, G 2), grok-1-314b's
        # verify (48 on 8, G 6, hd 128, softcap 30) and drafter levels (16
        # on 8, G 2; the drafter keeps the softcap)
        *[("granite-verify", 4, 8, 7, 3, 64, 201, dt, None) for dt in (bf, f32)],
        *[("granite-drafter-level", 4, 4, N, 2, 64, 201, dt, None)
          for N, dt in ((1, bf), (2, bf), (4, bf), (4, f32))],
        *[("grok-verify", 4, 8, 7, 6, 128, 201, dt, GROK_SOFTCAP)
          for dt in (bf, f32)],
        *[("grok-drafter-level", 4, 8, N, 2, 128, 201, dt, GROK_SOFTCAP)
          for N, dt in ((1, bf), (2, bf), (4, bf), (4, f32))],
    ]
    results = []
    for label, B, Hkv, N, G, hd, S, dtype, cap in cases:
        q, k, v, mask = tree_inputs(gen, B, Hkv, N, G, hd, S, dtype)
        got = tk.tree_attention(q, k, v, mask, softcap=cap)
        want = ref.ref_tree_attention(q, k, v, mask, softcap=cap)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ok = bool(torch.isfinite(got).all()) and err <= TOL[dtype]
        plan = tk.launch_plan(B, Hkv, N, G, hd, S, dtype, tk._sm_count(0))
        results.append({"case": label, "B": B, "Hkv": Hkv, "N": N, "G": G,
                        "hd": hd, "S": S, "dtype": str(dtype).split(".")[-1],
                        "softcap": cap, "tensor_cores":
                            tk.on_tensor_cores(hd, q.element_size()),
                        "instance": plan.launches[0].symbol,
                        "splits": plan.splits, "max_abs_err": err,
                        "tol": TOL[dtype], "ok": ok})
        if not ok:
            emit({"phase": 2, "cases": results})
            raise AssertionError(f"tree_attention disagrees with its plain "
                                 f"version: {results[-1]}")
    check_hd256_instance(results)
    assert any(r["splits"] > 1 for r in results
               if r["case"] == "gemma-verify" and r["dtype"] == "bfloat16")
    # a second input set, run twice, on shapes whose slots are split
    # across blocks (tensor cores at hd 128 and 256, CUDA cores)
    deterministic = True
    for B, Hkv, N, G, hd, S, dtype in ((4, 8, 2, 1, 128, 1024, bf),
                                        (4, 8, 7, 2, 256, GEMMA_VIEW, bf),
                                        (4, 32, 7, 1, 128, 1024, f32)):
        second = tree_inputs(gen, B, Hkv, N, G, hd, S, dtype)
        assert tk.plan(B, Hkv, N, G, hd, S, second[0].element_size(),
                       tk._sm_count(0))[1] > 1
        deterministic &= torch.equal(tk.tree_attention(*second),
                                     tk.tree_attention(*second))
    assert deterministic, "tree_attention differs between two runs"
    paged = check_paged_tree_cases(gen)
    granite_quant = check_granite_quant_cases(gen)
    zamba_quant, zamba_timing = zamba_quant_cases(gen)

    # timing at the main path's shape (Llama's verify, bf16, S 201), at
    # Yi-9B's (G 8) and at Gemma-2-9B's (hd 256 and its drafter's levels,
    # softcap 50; S 201 and the paged view past the window)
    llama = time_tree(gen, 4, 32, 7, 1, 128, 201)
    yi = time_tree(gen, 4, 4, 7, 8, 128, 201)
    gemma = {}
    for name, B, Hkv, N, hd in (("verify", 4, 8, 7, 256),
                                ("drafter_level", 4, 4, 4, 128)):
        gemma[f"{name}_S201"] = time_tree(gen, B, Hkv, N, 2, hd, 201,
                                          softcap=GEMMA_SOFTCAP)
        gemma[f"{name}_paged4352"] = time_tree(
            gen, B, Hkv, N, 2, hd, GEMMA_VIEW, softcap=GEMMA_SOFTCAP,
            iters=50, make=lambda: paged_tree_inputs(
                gen, B, Hkv, N, hd, GEMMA_VIEW, torch.bfloat16, G=2,
                lens=[GEMMA_VIEW - 1 - 16 * b for b in range(B)],
                window=GEMMA_WINDOW))
    moe = {name: time_tree(gen, 4, Hkv, N, G, hd, 201, softcap=cap)
           for name, Hkv, N, G, hd, cap in MOE_TREE_TIMING}
    emit({"phase": 2, "cases": results, "paged_cases": paged,
          "deterministic": deterministic,
          "timing_shape": "B4 Hkv32 N7 G1 hd128 S201 bf16, 8 input sets",
          **llama, "yi_verify_timing": {
              "shape": "B4 Hkv4 N7 G8 hd128 S201 bf16, 8 input sets", **yi},
          "gemma_timing": {
              "shapes": "B4 G2 bf16 softcap 50, 8 input sets: verify Hkv8 N7 "
                        "hd256, drafter level Hkv4 N4 hd128; S 201 (random "
                        "masks) and the paged view of 4,352 slots past the "
                        "window; library: SDPA without the softcap (it has "
                        "none)", **gemma},
          "moe_timing": {
              "shapes": "B4 S201 bf16, 8 input sets: granite verify Hkv8 N7 "
                        "G3 hd64, granite drafter level Hkv4 N4 G2 hd64, grok "
                        "verify Hkv8 N7 G6 hd128 softcap 30; library: SDPA "
                        "without the softcap", **moe},
          "quant_matmul_granite": granite_quant,
          "quant_matmul_zamba2": zamba_quant,
          "quant_matmul_zamba2_timing": {
              "note": "device ms per call, CUDA graph of 50 calls rotating "
                      "over 150 MB of weights, x bf16 (M 4)",
              **{name: t[4] for name, t in zamba_timing.items()}}})
    zamba_m4 = {name: {"ms": t[4]["device_ms"]["kernel"],
                       "plain_ms": t[4]["device_ms"]["plain"],
                       "bound_ms": t[4]["bound_ms"],
                       "bound_by": t[4]["bound_by"],
                       "library_ms": t[4]["device_ms"]["library"],
                       "cublas_bf16_ms": t[4]["device_ms"]["cublas_bf16"]}
                for name, t in zamba_timing.items()}
    return {"quant_matmul_int8_zamba2_m4": {
                "max_rel_err": max(zamba_quant["worst_rel_err"].values()),
                **zamba_m4},
            "tree_attention": {"max_abs_err": results[0]["max_abs_err"],
                               "ms": llama["device_ms"]["kernel"],
                               "plain_ms": llama["device_ms"]["plain"],
                               "bound_ms": llama["bound_ms"],
                               "bound_by": llama["bound_by"],
                               "library_ms": llama["device_ms"]["library"],
                               "yi_verify": {
                                   "max_abs_err": next(
                                       r["max_abs_err"] for r in results
                                       if r["case"] == "yi-verify"),
                                   "ms": yi["device_ms"]["kernel"],
                                   "plain_ms": yi["device_ms"]["plain"],
                                   "bound_ms": yi["bound_ms"],
                                   "bound_by": yi["bound_by"],
                                   "library_ms": yi["device_ms"]["library"]},
                               "gemma": {
                                   k: {"instance": t["instance"],
                                       "ms": t["device_ms"]["kernel"],
                                       "plain_ms": t["device_ms"]["plain"],
                                       "bound_ms": t["bound_ms"],
                                       "bound_by": t["bound_by"],
                                       "library_ms": t["device_ms"]["library"]}
                                   for k, t in gemma.items()},
                               "moe": {
                                   k: {"max_abs_err": next(
                                           r["max_abs_err"] for r in results
                                           if r["case"] == k.replace("_", "-")),
                                       "ms": t["device_ms"]["kernel"],
                                       "plain_ms": t["device_ms"]["plain"],
                                       "bound_ms": t["bound_ms"],
                                       "bound_by": t["bound_by"],
                                       "library_ms": t["device_ms"]["library"]}
                                   for k, t in moe.items()}}}


GROK_SOFTCAP = 30.0
MOE_TREE_TIMING = (  # (name, Hkv, N, G, hd, softcap) timed at B 4, S 201
    ("granite_verify", 8, 7, 3, 64, None),
    ("granite_drafter_level", 4, 4, 2, 64, None),
    ("grok_verify", 8, 7, 6, 128, GROK_SOFTCAP))
GRANITE_QUANT_SHAPES = {   # (label, K, N) of every quantized matmul of 25c
    "target": [("wq/wo", 1536, 1536), ("wk/wv", 1536, 512),
               ("lm_head", 1536, 49155)],
    "drafter": [("wq/wo", 512, 512), ("wk/wv", 512, 256),
                ("w_gate/w_up", 512, 1408), ("w_down", 1408, 512),
                ("lm_head", 512, 49155)]}


def check_granite_quant_cases(gen):
    """``quant_matmul`` int8 against its plain version at every (K, N) of
    phase 25c's quantized granite target and drafter (``granite_int8``
    holds the models' weights to this table; the lm heads are the first
    quantized weights of a served path with an odd N), at the M of every
    pass 25c runs (``quant_pass_rows``: drafter levels and chain steps 4,
    8, 16, chain verify 16, tree verify 28, prefill 512), with and without
    an AWQ pre-scale, x in bf16 and float32."""
    return check_quant_table(gen, GRANITE_QUANT_SHAPES, quant_pass_rows(),
                             "granite")


def check_quant_table(gen, shapes, rows, arch):
    """``quant_matmul`` int8 against its plain version at every (K, N) of
    ``shapes`` and every M of ``rows``, with and without an AWQ pre-scale,
    x in bf16 and float32, within ``QUANT_TOL`` of the output's scale."""
    worst, n_cases = {}, 0
    for model, lst in shapes.items():
        for name, K, N in lst:
            for awq in (False, True):
                qw = quant_weight(gen, K, N, 8, awq)
                for M in rows:
                    x = torch.randn((M, K), generator=gen, device="cuda")
                    for dtype in (torch.bfloat16, torch.float32):
                        err, tol, ok = check_quant_case(x.to(dtype), qw)
                        n_cases += 1
                        key = f"{model}:{name}"
                        worst[key] = max(worst.get(key, 0.0),
                                         err / tol * QUANT_TOL)
                        assert ok, ("quant_matmul disagrees with its plain "
                                    f"version at a {arch} shape", model, name,
                                    K, N, M, awq, str(dtype), err, tol)
                del qw
    return {"cases": n_cases, "M": list(rows), "awq": [False, True],
            "x": ["bfloat16", "float32"], "tolerance_rel": QUANT_TOL,
            "worst_rel_err": worst}


def zamba_quant_cases(gen):
    """``quant_matmul`` int8 at every (K, N) of phase 26d's quantized
    zamba2 target and drafter, at M 4 (a recurrent verify feeds one token
    a call: every pass of a chain round) and 512 (prefill), within
    ``QUANT_TOL``; then its device times at the target's four shapes at M
    4 beside their bytes bound, the plain version's and
    torch._weight_int8pack_mm's (``time_quant_shape``)."""
    checks = check_quant_table(gen, ZAMBA_QUANT_SHAPES, ZAMBA_QUANT_ROWS,
                               "zamba2")
    timing = {name: time_quant_shape(gen, K, N, 8, Ms=(4,))
              for name, K, N in ZAMBA_QUANT_SHAPES["target"]}
    torch.cuda.empty_cache()
    return checks, timing


def sdpa_tree(q, k, v, mask):
    """The one PyTorch call that computes tree attention (a yardstick
    only): scaled_dot_product_attention on (B, H, N, hd) queries, head h
    = kv * G + g as the model lays them out, GQA by the library."""
    B, Hkv, N, G, hd = q.shape
    out = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(2, 3).reshape(B, Hkv * G, N, hd), k.transpose(1, 2),
        v.transpose(1, 2), attn_mask=mask[:, None], enable_gqa=G > 1)
    return out.reshape(B, Hkv, G, N, hd).transpose(2, 3)


def time_tree(gen, B, Hkv, N, G, hd, S, softcap=None, make=None, iters=200):
    """Device ms of the kernel, its plain version and SDPA at one bf16
    shape (graph replay, in turns kernel, plain, library, kernel), rotating
    over 8 input sets from ``make`` (default: ``tree_inputs``; more than
    the 50 MB L2 at the 7B verify shape, as the serving loop finds it);
    then the time per eager call as the serving loop pays it (host launch
    cost included), the bound, and SDPA's agreement with the plain version
    on the rows that see a slot. With ``softcap`` the kernel and the plain
    version apply it; SDPA has none, so it is held to the plain version
    without it."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import tree_attention as tk
    make = make or (lambda: tree_inputs(gen, B, Hkv, N, G, hd, S,
                                        torch.bfloat16))
    sets = [make() for _ in range(8)]
    want = ref.ref_tree_attention(*sets[0])
    lib = sdpa_tree(*sets[0]).float()
    seen = sets[0][3].any(-1)[:, None, :, None, None].expand_as(want)
    lib_err = (lib - want)[seen].abs().max().item()
    assert lib_err <= LIBRARY_TOL * want.abs().max().item(), \
        ("SDPA disagrees with the plain version", lib_err)
    it = iter(range(10 ** 9))

    def rotate(fn):
        return lambda: fn(*sets[next(it) % len(sets)])

    fns = {"kernel": lambda *a: tk.tree_attention(*a, softcap=softcap),
           "plain": lambda *a: ref.ref_tree_attention(*a, softcap=softcap),
           "library": sdpa_tree}
    dev = {name: graph_ms(rotate(fn), iters) for name, fn in fns.items()}
    dev["kernel_repeat"] = graph_ms(rotate(fns["kernel"]), iters)
    eager = {name: cuda_ms(rotate(fn), iters=200) for name, fn in fns.items()}
    bound_ms, bound_by = tree_bound_ms(*sets[0])
    plan = tk.launch_plan(B, Hkv, N, G, hd, S, torch.bfloat16, tk._sm_count(0))
    return {"instance": plan.launches[0].symbol, "splits": plan.splits,
            "chunk": plan.chunk, "device_ms": dev,
            "eager_call_ms": eager, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_max_abs_err": lib_err}


def phase3_tree_serving(models, smi, phase=3, max_new=64):
    """Tree serving of 4 x (128 + ``max_new``) at 0.7, the launches
    asserted. Returns (the launches, ``profile_tree``'s breakdown)."""
    from repro_torch.core.metrics import mbsu
    from repro_torch.core.speculative import SDConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.spectree.tree import TreeSpec
    target, t_params, draft, d_params, c = models
    spec = TreeSpec((2, 2))
    sdc = SDConfig(gamma=3, temperature=0.7)
    prompts = serve.make_prompts(4, 128, target.cfg.vocab_size)
    # warm-up (cuBLAS handles, allocator): a short run, not counted
    serve.serve_tree(target, t_params, draft, d_params, prompts, 8, sdc, spec,
                     seed=1)
    torch.cuda.synchronize()
    ops.reset_launches()
    toks, stats = serve.serve_tree(target, t_params, draft, d_params, prompts,
                                   max_new, sdc, spec)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    per_round = target.cfg.num_layers + draft.cfg.num_layers * (spec.depth + 1)
    new = toks[:, 128:128 + max_new]
    assert stats.rounds > 0 and launches["tree_attention"] == stats.rounds * per_round, \
        (launches, stats.rounds, per_round)
    assert bool(((new >= 0) & (new < target.cfg.vocab_size)).all()), "token out of vocab"
    assert stats.tau >= 1.0 and math.isfinite(stats.tau), stats.tau
    breakdown = profile_tree(models, prompts, sdc, spec,
                             stats.wall_time_s * 1e3 / stats.rounds)
    emit({"phase": phase, "path": "tree", "arch": target.cfg.name,
          "drafter": draft.cfg.name, "dtype": target.cfg.dtype,
          "requests": 4, "prompt_len": 128, "max_new": max_new,
          "tree": spec.branching,
          "temperature": 0.7, "rounds": stats.rounds, "launches": launches,
          "launches_per_round": per_round, "tau": stats.tau,
          "mbsu": mbsu(stats.tau, c, spec.depth), "c": c,
          "tok_s": stats.tokens_per_s(), "wall_s": stats.wall_time_s,
          "depth_acceptance": stats.depth_acceptance(),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "where_the_time_goes": breakdown, "nvidia_smi": smi})
    return launches, breakdown


def profile_tree(models, prompts, sdc, spec, wall_ms_per_round):
    """Where a tree round's time goes: device time by kernel over a short
    tree run (8 new tokens, about 6 rounds) under torch.profiler, against
    the unprofiled host time of a round. The profiler records the
    device's activity only: with the host's ops recorded too it took 2.5
    to 4 times as long for the same device times. An MoE target is the
    exception: the host's ops and the ranges of ``moe_ranges`` are
    recorded too, so that the same trace gives ``moe_shares``. Prints
    None where the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve
    target, t_params, draft, d_params, _ = models
    moe = target.cfg.is_moe
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if moe else [])
    torch.cuda.synchronize()
    with (moe_ranges() if moe else contextlib.nullcontext()), \
            profile(activities=acts) as prof:
        _, stats = serve.serve_tree(target, t_params, draft, d_params, prompts,
                                    8, sdc, spec, seed=2)
        torch.cuda.synchronize()
    out = kernel_breakdown(prof, stats.rounds, wall_ms_per_round)
    if moe and out.get("profiled", True) is not None:
        out["moe"] = moe_shares(prof, stats.rounds,
                                out["device_ms_per_round"] * 1e3 * stats.rounds)
    return out


def device_kernels(prof, averages=None):
    """The profile's device events by name, without the device-side copies
    of ``record_function`` ranges (they span kernels already counted).
    ``averages``: the profile's ``key_averages()`` if already taken (it
    walks every event: seconds for a long profile)."""
    from torch.autograd import DeviceType
    averages = prof.key_averages() if averages is None else averages
    return [e for e in averages if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def kernel_breakdown(prof, rounds, wall_ms_per_round):
    """Device time by kernel of ``rounds`` profiled rounds against the
    unprofiled host time of a round. None where the profiler saw no device
    activity."""
    averages = prof.key_averages()
    kernels = device_kernels(prof, averages)
    total_us = sum(e.self_device_time_total for e in kernels)
    if not kernels or total_us <= 0:
        return {"profiled": None}
    per_round_ms = total_us / 1e3 / rounds
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]

    def share(pred):
        return sum(e.self_device_time_total for e in kernels if pred(e.key)) / total_us

    # device-to-host copies (the device-side memcpy records, whatever
    # device type the profiler files them under)
    dtoh = sum(e.count for e in averages if "Memcpy DtoH" in e.key)
    return {"profiled_rounds": rounds,
            "device_ms_per_round": per_round_ms,
            "dtoh_copies_per_round": dtoh / rounds,
            "wall_ms_per_round_unprofiled": wall_ms_per_round,
            "device_busy_share": per_round_ms / wall_ms_per_round,
            "share_tree_attention": share(lambda k: "tree_attention" in k),
            # its instances at hd 256 (Gemma-2-9B's verify pass)
            "share_tree_attention_hd256": share(
                lambda k: "tree_attention" in k
                and ("<256>" in k or ", 256," in k)),
            "share_quant_matmul": share(lambda k: "quant_matmul" in k),
            # cuBLAS matmuls: nvjet_* (its JIT kernels), *gemm*, *xmma*
            "share_matmul": share(lambda k: any(w in k.lower() for w in
                                                ("nvjet", "gemm", "xmma"))),
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def phase4_chain_serving(models, smi, phase=4, ar=True, max_new=64):
    """Chain serving (gamma 3, temperature 0.7) of 4 x (128 + ``max_new``),
    and with ``ar`` the autoregressive baseline on the same weights."""
    from repro_torch.core.metrics import mbsu
    from repro_torch.core.speculative import SDConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    target, t_params, draft, d_params, c = models
    sdc = SDConfig(gamma=3, temperature=0.7)
    prompts = serve.make_prompts(4, 128, target.cfg.vocab_size)
    serve.serve_static(target, t_params, draft, d_params, prompts, 8, sdc, seed=1)
    ops.reset_launches()
    results, tau, tok_s = serve.serve_static(target, t_params, draft, d_params,
                                             prompts, max_new, sdc)
    chain_launches = dict(ops.LAUNCHES)
    ar_tok_s = (serve.serve_static(target, t_params, None, None, prompts,
                                   max_new, sdc)[2] if ar else None)
    for r in results:
        assert len(r.tokens) == max_new and ((r.tokens >= 0)
                                        & (r.tokens < target.cfg.vocab_size)).all()
    assert tau >= 1.0 and math.isfinite(tau), tau
    emit({"phase": phase, "path": "chain", "arch": target.cfg.name,
          "gamma": 3, "temperature": 0.7, "max_new": max_new,
          "tau": tau, "mbsu": mbsu(tau, c, 3), "tok_s": tok_s,
          "ar_tok_s": ar_tok_s, "launches": chain_launches,
          "note": "tok/s over each batch's wall time, prefill included",
          "nvidia_smi": smi})
    return chain_launches


def greedy_exactness(arch, P, M, chain=True, continuous=False, over=None,
                     probe=None):
    """Temperature 0 with the arch's target cut to 2 layers in float32 and
    its drafter (float32) at published widths: tree (2, 2) and, with
    ``chain``, chain gamma 3 tokens over 2 prompts of P tokens must equal
    the target's greedy tokens, with tree_attention launched (2 + drafter
    layers * 3) times a tree round, and so must tree tokens with the
    target as its own drafter (every path accepted, tau above 2); with
    ``continuous`` also the
    continuous engine, chain and tree, 4 requests of different lengths
    through 2 slots, against each request's greedy tokens. ``over``
    replaces fields of the target's config; ``probe(target, t_params,
    draft, d_params, prompt, M)`` adds its dict to the result before the
    models are freed."""
    from repro_torch.configs import get_config
    from repro_torch.core.speculative import (SDConfig, autoregressive_generate,
                                              speculative_generate)
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.launch import serve
    from repro_torch.serving import ContinuousEngine, ServeRequest
    from repro_torch.spectree.round import tree_speculative_generate
    from repro_torch.spectree.tree import TreeSpec
    cfg = get_config(arch).replace(num_layers=2, dtype="float32",
                                   **(over or {}))
    target = Model(cfg, "cuda")
    t_params = target.init(0)
    draft = Model(cfg.drafter(), "cuda")
    d_params = draft.init(1)
    prompt = torch.as_tensor(serve.make_prompts(2, P, cfg.vocab_size, seed=5),
                             device=target.device)
    sdc = SDConfig(gamma=3, temperature=0.0)
    spec = TreeSpec((2, 2))
    ar, _ = autoregressive_generate(target, t_params, prompt, M, temperature=0.0)
    out = {"arch": cfg.name, "drafter": draft.cfg.name, "target_layers": 2,
           "dtype": "float32", "temperature": 0.0, "prompt": [2, P], "max_new": M}
    if chain:
        toks, _ = speculative_generate(draft, target, d_params, t_params,
                                       prompt, M, sdc)
        out["chain_equals_ar"] = torch.equal(toks[:, :P + M], ar)
    ops.reset_launches()
    toks, tstats = tree_speculative_generate(draft, target, d_params, t_params,
                                             prompt, M, sdc, spec)
    launches = dict(ops.LAUNCHES)
    per_round = cfg.num_layers + draft.cfg.num_layers * (spec.depth + 1)
    out.update(tree_equals_ar=torch.equal(toks[:, :P + M], ar),
               tree_launches=launches["tree_attention"],
               tree_rounds=tstats.rounds, tree_launches_per_round=per_round,
               tree_tau=tstats.tau)
    ok = launches == {**{k: 0 for k in launches},
                      "tree_attention": tstats.rounds * per_round}
    # random drafters are never accepted at temperature 0 (tau 1); the
    # target as its own drafter is, so its tree rounds commit whole paths
    toks, sstats = tree_speculative_generate(target, target, t_params,
                                             t_params, prompt, M, sdc, spec)
    out.update(self_draft_tree_equals_ar=torch.equal(toks[:, :P + M], ar),
               self_draft_tree_tau=sstats.tau)
    ok &= sstats.tau > 2.0
    if continuous:
        rng = np.random.default_rng(17)
        lens, news = (40, 64, 50, 57), (16, 12, 20, 14)
        prompts = [rng.integers(3, cfg.vocab_size, L).astype(np.int64)
                   for L in lens]
        greedy = {i: autoregressive_generate(
            target, t_params, torch.as_tensor(p[None], device=target.device), m,
            temperature=0.0)[0][0, len(p):].cpu().numpy()
            for i, (p, m) in enumerate(zip(prompts, news))}
        for name, tree in (("continuous_chain", None), ("continuous_tree", spec)):
            engine = ContinuousEngine(
                target=target, target_params=t_params, draft=draft,
                draft_params=d_params, sd=sdc, tree=tree, max_batch=2,
                page_size=16, prefill_chunk=32,
                max_seq_len=max(lens) + max(news))
            got = {r.request_id: r.tokens for r in engine.serve(
                [ServeRequest(prompt=p, max_new_tokens=m, request_id=i)
                 for i, (p, m) in enumerate(zip(prompts, news))])}
            out[f"{name}_equals_ar"] = all(np.array_equal(got[i], greedy[i])
                                           for i in greedy)
            ok &= engine.telemetry.max_queue_depth >= 1   # staggered admission
    if probe is not None:
        out.update(probe(target, t_params, draft, d_params, prompt, M))
    del target, draft, t_params, d_params
    torch.cuda.empty_cache()
    return out, ok and all(v for k, v in out.items() if k.endswith("_equals_ar"))


def phase5_greedy_exactness():
    out, ok = greedy_exactness("llama2-7b-chat", 64, 32)
    emit({"phase": 5, **out})
    assert ok, ("speculative greedy tokens differ from AR, or tree launches "
                "are off", out)

# ------------------------------------------------ distillation loss (6-8)

DISTILL_MODES = ("kld", "tvd", "tvdpp")
# distill-loss tolerances against the plain version on the same inputs and
# the same row logsumexps (so p and q are the same numbers on both sides):
# lse 1e-5 absolute; row sums 1e-5 relative (floor 1, times inv_sigma for
# the tvdpp weights), since both sum fp32 terms in another order; gradient
# entries, of order p (about 1/V), 1e-6 absolute. Where q and p are within
# rounding of each other, r = 1{q > p} may flip between the two: that moves
# a row's c by at most p * inv_sigma (tvd: by p) and its sum p*r by p, and
# the gradient entry by g * p * inv_sigma; each near tie adds that to the
# tolerance, and the count of near ties is printed.
LSE_TOL, ROW_RTOL, GRAD_TOL = 1e-5, 1e-5, 1e-6
# fp32 operations per (row, vocab) element, an exp counted as one
FLOPS_PER_ELEM = {"row_logsumexp": 4, "loss_terms": 14, "loss_grad": 11}


def distill_inputs(gen, N, V, s_stride=None):
    """Student logits (std 2) at row stride ``s_stride`` (default V),
    teacher logits (std 3) contiguous, and a mask with row 0 masked out."""
    dev = "cuda"
    width = s_stride or V
    s = (torch.randn((N, width), generator=gen, device=dev) * 2)[:, :V]
    t = torch.randn((N, V), generator=gen, device=dev) * 3
    mask = torch.ones((N,), device=dev)
    mask[0] = 0.0
    return s, t, mask


def check_distill_case(label, s, t, mask, mode):
    """Each kernel against its plain version on the same inputs; returns
    the case's record (raises on disagreement)."""
    from repro_torch.kernels import distill_loss as dk
    from repro_torch.kernels import ref
    N, V = s.shape
    dev = s.device
    lse_s, lse_t = dk.row_logsumexp(s), dk.row_logsumexp(t)
    err_lse = max((lse_s - ref.ref_logsumexp(s)).abs().max().item(),
                  (lse_t - ref.ref_logsumexp(t)).abs().max().item())
    mu = torch.tensor([0.3 if mode == "tvdpp" else 0.0], device=dev)
    isg = torch.tensor([2.0 if mode == "tvdpp" else 1.0], device=dev)
    got = dk.loss_terms(s, t, lse_s, lse_t, mu, isg, mode)
    want = ref.ref_loss_terms(s, t, lse_s, lse_t, mu, isg, mode)
    p = torch.exp(s - lse_s[:, None])
    q = torch.exp(t - lse_t[:, None])
    near = (q - p).abs() <= 1e-6 * torch.maximum(p, q)
    w_flip = float(isg.item()) if mode == "tvdpp" else 1.0
    slack = (p * near).sum(-1)
    row_err, row_ok = [], True
    for k, (a, b) in enumerate(zip(got, want)):
        tol = ROW_RTOL * (1.0 + b.abs()) * max(1.0, w_flip) + slack * w_flip
        row_err.append((a - b).abs().max().item())
        row_ok &= bool(((a - b).abs() <= tol).all())
    g_rows = (torch.rand((N,), generator=torch.Generator(device=dev)
                         .manual_seed(N), device=dev) + 0.5) * mask
    c = got[1]
    gk = dk.loss_grad(s, t, lse_s, lse_t, c, g_rows, mu, isg, mode)
    gp = ref.ref_loss_grad(s, t, lse_s, lse_t, c, g_rows, mu, isg, mode)
    torch.cuda.synchronize()
    gtol = GRAD_TOL + near * (g_rows[:, None] * p * w_flip)
    err_grad = (gk - gp).abs().max().item()
    ok = (err_lse <= LSE_TOL and row_ok and bool(((gk - gp).abs() <= gtol).all())
          and not gk[0].any().item()
          and all(bool(torch.isfinite(x).all()) for x in (lse_s, *got, gk)))
    rec = {"case": label, "N": N, "V": V, "s_row_stride": s.stride(0),
           "mode": mode, "err_lse": err_lse, "err_rows": row_err,
           "err_grad": err_grad, "near_ties": int(near.sum().item()), "ok": ok}
    if not ok:
        emit({"phase": 6, "failed_case": rec})
        raise AssertionError(f"distill-loss kernels disagree with their plain "
                             f"versions: {rec}")
    return rec


def distill_bound_ms(name, N, V):
    """Least time for the card: each input read once, each output written
    once, against FLOPS_PER_ELEM fp32 operations per element."""
    rows_in = {"row_logsumexp": 0, "loss_terms": 2, "loss_grad": 4}[name]
    rows_out = {"row_logsumexp": 1, "loss_terms": 4, "loss_grad": 0}[name]
    mats_in = 1 if name == "row_logsumexp" else 2
    mats_out = 1 if name == "loss_grad" else 0
    nbytes = 4 * (N * V * (mats_in + mats_out) + N * (rows_in + rows_out))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = FLOPS_PER_ELEM[name] * N * V / PEAK_FLOPS[torch.float32] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase6_distill_kernels():
    """The three distill-loss kernels against their plain versions, then
    their device times at the full-width chunk (tvdpp, the path's mode)."""
    from repro_torch.kernels import distill_loss as dk
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = [("full-width", 2048, 32000, None),
             ("ragged", 37, 32003, 32005),     # s rows off 16-byte boundaries
             ("small", 16, 1000, None)]
    results, worst = [], {}
    for label, N, V, stride in cases:
        s, t, mask = distill_inputs(gen, N, V, stride)
        for mode in DISTILL_MODES:
            rec = check_distill_case(label, s, t, mask, mode)
            results.append(rec)
            if label == "full-width":
                for name, err in (("row_logsumexp", rec["err_lse"]),
                                  ("loss_terms", max(rec["err_rows"])),
                                  ("loss_grad", rec["err_grad"])):
                    worst[name] = max(worst.get(name, 0.0), err)
        del s, t, mask

    # timing at the full-width chunk, rotating two input sets (each 524 MB,
    # beyond the 50 MB L2)
    N, V = 2048, 32000
    sets = []
    for _ in range(2):
        s, t, mask = distill_inputs(gen, N, V)
        lse_s, lse_t = dk.row_logsumexp(s), dk.row_logsumexp(t)
        mu = torch.tensor([0.3], device="cuda")
        isg = torch.tensor([2.0], device="cuda")
        c = dk.loss_terms(s, t, lse_s, lse_t, mu, isg, "tvdpp")[1]
        sets.append((s, t, lse_s, lse_t, c, mask / mask.sum(), mu, isg))
    it = iter(range(10 ** 9))

    def rotate(fn):
        return lambda: fn(*sets[next(it) % len(sets)])

    fns = {
        "row_logsumexp": {
            "kernel": lambda s, *_: dk.row_logsumexp(s),
            "plain": lambda s, *_: ref.ref_logsumexp(s),
            "library": lambda s, *_: torch.logsumexp(s, -1)},
        "loss_terms": {
            "kernel": lambda s, t, ls, lt, c, g, mu, isg:
                dk.loss_terms(s, t, ls, lt, mu, isg, "tvdpp"),
            "plain": lambda s, t, ls, lt, c, g, mu, isg:
                ref.ref_loss_terms(s, t, ls, lt, mu, isg, "tvdpp")},
        "loss_grad": {
            "kernel": lambda s, t, ls, lt, c, g, mu, isg:
                dk.loss_grad(s, t, ls, lt, c, g, mu, isg, "tvdpp"),
            "plain": lambda s, t, ls, lt, c, g, mu, isg:
                ref.ref_loss_grad(s, t, ls, lt, c, g, mu, isg, "tvdpp")},
    }
    timings, report = {}, {}
    for name, variants in fns.items():
        # device time (graph replay) in turns kernel, plain, library, kernel
        dev = {v: graph_ms(rotate(fn), iters=50) for v, fn in variants.items()}
        dev["kernel_repeat"] = graph_ms(rotate(variants["kernel"]), iters=50)
        bound_ms, bound_by = distill_bound_ms(name, N, V)
        report[name] = {"device_ms": dev, "bound_ms": bound_ms,
                        "bound_by": bound_by}
        timings[name] = {"max_abs_err": worst[name], "ms": dev["kernel"],
                         "plain_ms": dev["plain"], "bound_ms": bound_ms,
                         "bound_by": bound_by,
                         "library_ms": dev.get("library")}
    emit({"phase": 6, "cases": results, "tolerances": {
        "lse_abs": LSE_TOL, "rows_rel": ROW_RTOL, "grad_abs": GRAD_TOL},
        "timing_shape": "N2048 V32000 fp32 tvdpp, 2 input sets",
        "timing": report})
    del sets
    torch.cuda.empty_cache()
    return timings


def param_checksum(params):
    from repro_torch.optim import tree_leaves
    return sum(float(p.double().sum()) for p in tree_leaves(params))


def rel_l2_errors(got, want):
    from repro_torch.optim import tree_leaves
    return [((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30)).item()
            for a, b in zip(tree_leaves(got), tree_leaves(want))]


@contextlib.contextmanager
def plain_versions():
    """The kernel route with each kernel's plain version in its place."""
    from repro_torch.kernels import ops, ref
    saved = {n: getattr(ops, n) for n in ("row_logsumexp", "loss_terms", "loss_grad")}
    ops.row_logsumexp = ref.ref_logsumexp
    ops.loss_terms = ref.ref_loss_terms
    ops.loss_grad = ref.ref_loss_grad
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


def compare_routes(draft, target, params, t_params, tokens, loss_rtol, grad_rtol):
    """One TVD++ step's loss and gradients through the kernels against the
    plain route (softmax, the reference's arithmetic), from the same state
    and batch.

    The TVD++ surrogate's value is 0 up to rounding by construction (its
    advantage is centred on the p-weighted mean), so the loss is compared on
    a scale of at least 1. The gradient is compared in relative L2 norm per
    parameter. Beside the order of sums, two float computations of p and q
    differ at near ties of q and p, where r = 1{q > p} flips and moves that
    logit's gradient by g * p * inv_sigma. The size of that effect on this
    batch is measured as the floor: the plain route against the kernel route
    run with the plain versions (p = exp(x - lse) in place of a softmax),
    two plain computations that differ only in rounding. The kernels must
    come within grad_rtol plus three times that floor."""
    from repro_torch.training.finetune import distill_loss_and_grads
    mask = torch.ones(tokens.shape, device=tokens.device)

    def run(kernels):
        return distill_loss_and_grads(draft, target, params, t_params, tokens,
                                      mask, "tvdpp", use_kernels=kernels)

    lk, gk = run(True)
    lp, gp = run(False)
    with plain_versions():
        _, gr = run(True)
    errs = rel_l2_errors(gk, gp)
    floor = max(rel_l2_errors(gr, gp))
    loss_err = abs(lk.item() - lp.item())
    out = {"loss_kernels": lk.item(), "loss_plain": lp.item(),
           "loss_abs_err": loss_err,
           "loss_tol": loss_rtol * max(1.0, abs(lp.item())),
           "grad_rel_l2_max": max(errs),
           "grad_rel_l2_kernels_vs_plain_versions": max(rel_l2_errors(gk, gr)),
           "grad_rel_l2_floor": floor,
           "grad_rel_l2_tol": grad_rtol + 3 * floor}
    out["ok"] = (math.isfinite(lk.item()) and loss_err <= out["loss_tol"]
                 and max(errs) <= out["grad_rel_l2_tol"])
    return out


def profile_step(step_fn, state, t_params, tokens, wall_ms):
    """Where one distill step's device time goes (torch.profiler), against
    the unprofiled wall time of a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    mask = torch.ones(tokens.shape, device=tokens.device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step_fn(state, t_params, tokens, mask)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in kernels)
    if not kernels or total_us <= 0:
        return {"profiled": None}

    def share(pred):
        return sum(e.self_device_time_total for e in kernels if pred(e.key)) / total_us

    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    return {"device_ms_per_step": total_us / 1e3,
            "wall_ms_per_step_unprofiled": wall_ms,
            "device_busy_share": total_us / 1e3 / wall_ms,
            "share_distill_kernels": {
                n: share(lambda k, n=n: f"{n}_kernel" in k)
                for n in ("row_logsumexp", "loss_terms", "loss_grad")},
            "share_matmul": share(lambda k: any(w in k.lower() for w in
                                                ("nvjet", "gemm", "xmma"))),
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def phase7_training(smi):
    """Datagen, 2 pretraining steps and 3 TVD++ steps at full width."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.datagen import DatagenConfig, generate_distillation_dataset
    from repro_torch.data import mixed_batches, pack_documents, simple_batches
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    from repro_torch.training import finetune, make_train_state, train
    from repro_torch.training.finetune import make_distill_step
    B, S, steps = 4, 2048, 3
    cfg = get_config("llama2-7b-chat")
    target = Model(cfg, "cuda")
    t_params = target.init(0)                            # bf16, frozen
    draft = Model(cfg.drafter().replace(vocab_size=cfg.vocab_size), "cuda")
    tc = TrainConfig(warmup_steps=2, total_steps=100)
    state = make_train_state(draft, 1, tc)               # float32 master weights
    V = cfg.vocab_size

    t0 = time.perf_counter()
    seeds = serve.make_prompts(8, 128, V, seed=7)
    data = generate_distillation_dataset(
        target, t_params, seeds,
        DatagenConfig(temperatures=(0.0, 0.7), max_response_tokens=64),
        gen=torch.Generator(device="cuda").manual_seed(0))
    datagen_s = time.perf_counter() - t0
    assert data.shape == (16, 128 + 64) and ((data >= 0) & (data < V)).all()
    assert (data[:, :128] == np.tile(seeds, (2, 1))).all()
    distill = pack_documents(data, S)
    assert distill.shape == (1, S), distill.shape
    pretrain = serve.make_prompts(8, S, V, seed=8)

    t0 = time.perf_counter()
    state, pre_hist = train(draft, state, simple_batches(pretrain, B, seed=0),
                            tc, 2, log_every=1)
    pretrain_s = time.perf_counter() - t0
    assert all(math.isfinite(h["loss"]) for h in pre_hist), pre_hist

    batches = mixed_batches(distill, pretrain, B, tc.distill_mix, seed=0)
    t_sum = param_checksum(t_params)
    d_before = param_checksum(state["params"])
    marks = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    state, hist = finetune(draft, target, state, t_params, batches, tc, steps,
                           "tvdpp", log_every=1, use_kernels=True,
                           callback=lambda i, m: marks.append(time.perf_counter()))
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = [1e3 * (b - a) for a, b in zip([t0] + marks[:-1], marks)]
    steady_ms = sum(step_ms[1:]) / len(step_ms[1:])      # step 1 warms up
    n = S // 512                                         # loss chunks per step
    per_step = {"tree_attention": 0, "flash_decode": 0, "row_logsumexp": 6 * n,
                "loss_terms": 3 * n, "loss_grad": n, "quant_matmul_int8": 0,
                "quant_matmul_int4": 0}
    assert launches == {k: v * steps for k, v in per_step.items()}, launches
    assert all(math.isfinite(h["loss"]) for h in hist), hist
    assert param_checksum(t_params) == t_sum, "target parameters changed"
    assert param_checksum(state["params"]) != d_before, "drafter did not move"

    tokens = torch.as_tensor(next(batches), dtype=torch.long, device="cuda")
    routes = compare_routes(draft, target, state["params"], t_params, tokens,
                            loss_rtol=1e-4, grad_rtol=2e-2)
    breakdown = profile_step(make_distill_step(draft, target, tc, "tvdpp",
                                               use_kernels=True),
                             state, t_params, tokens, steady_ms)
    emit({"phase": 7, "arch": cfg.name, "drafter": draft.cfg.name,
          "target_dtype": cfg.dtype, "drafter_param_dtype": draft.cfg.param_dtype,
          "datagen": {"seeds": 8, "prompt_len": 128, "max_new": 64,
                      "temperatures": [0.0, 0.7], "rows": int(data.shape[0]),
                      "distill_chunks": int(distill.shape[0]), "s": datagen_s},
          "pretrain": {"steps": 2, "batch": [B, S], "s": pretrain_s,
                       "loss": [h["loss"] for h in pre_hist]},
          "finetune": {"steps": steps, "batch": [B, S], "loss_kind": "tvdpp",
                       "mix": tc.distill_mix, "step_ms": step_ms,
                       "ms_per_step": steady_ms,
                       "tokens_per_s": B * S / (steady_ms / 1e3),
                       "peak_mem_gb": peak_gb,
                       "loss": [h["loss"] for h in hist],
                       "grad_norm": [h["grad_norm"] for h in hist]},
          "launches": launches, "launches_per_step": per_step,
          "kernel_vs_plain": routes, "where_the_time_goes": breakdown,
          "nvidia_smi": smi})
    assert routes["ok"], routes
    return launches


def phase8_float32_routes():
    """One TVD++ step, kernel route against plain route, in float32 with
    the target cut to 2 layers."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    from repro_torch.training import make_train_state
    cfg = get_config("llama2-7b-chat").replace(num_layers=2, dtype="float32")
    target = Model(cfg, "cuda")
    t_params = target.init(0)
    draft = Model(cfg.drafter().replace(vocab_size=cfg.vocab_size), "cuda")
    state = make_train_state(draft, 1, TrainConfig())
    tokens = torch.as_tensor(serve.make_prompts(4, 2048, cfg.vocab_size, seed=9),
                             device="cuda")
    routes = compare_routes(draft, target, state["params"], t_params, tokens,
                            loss_rtol=1e-5, grad_rtol=1e-4)
    emit({"phase": 8, "arch": cfg.name, "target_layers": 2, "dtype": "float32",
          "batch": [4, 2048], "kernel_vs_plain": routes})
    assert routes["ok"], routes


# ------------------------------------------------ quantized serving (9-11)

QUANT_SHAPES = {    # (label, K, N) of every quantized matmul of the path
    "target": [("wq/wk/wv/wo", 4096, 4096), ("w_gate/w_up", 4096, 11008),
               ("w_down", 11008, 4096), ("lm_head", 4096, 32000)],
    "drafter": [("wq/wk/wv/wo", 1024, 1024), ("w_gate/w_up", 1024, 2816),
                ("w_down", 2816, 1024), ("lm_head", 1024, 32000)]}
QUANT_B, QUANT_P, QUANT_TREE, QUANT_GAMMA = 4, 128, (2, 2), 3   # phase 10
# the target shapes phase 9 times (the others were cut to pay for phase 24)
QUANT_TIMED = ("wq/wk/wv/wo", "w_down")


def quant_pass_rows(B=QUANT_B, P=QUANT_P, branching=QUANT_TREE, gamma=QUANT_GAMMA):
    """The M of every quantized matmul phase 10 runs: the drafter's tree
    levels (B x 1, 2, 4 nodes) and chain steps (B), the chain verify
    (B x (gamma + 1)), the tree verify (B x 7 nodes) and both prefills
    (B x P)."""
    from repro_torch.spectree.tree import TreeSpec
    spec = TreeSpec(branching)
    return tuple(sorted({B * n for n in spec.level_sizes}
                        | {B, B * (gamma + 1), B * spec.num_nodes, B * P}))


QUANT_GROUP = 64
# kernel vs plain version, relative to the output's scale, for x in either
# dtype: both widen x to fp32 and sum fp32 products, so they differ only in
# the order of the sums (4.1e-6 at most on an H100); a kernel that formed
# its products in bf16 would be off by about 1e-3
QUANT_TOL = 1e-4
# a library call against the plain version: it rounds the scales and its
# output to bf16
LIBRARY_TOL = 2e-2
QUANT_TIMING_SET_BYTES = 150e6      # weights per timed rotation, > 50 MB L2


def quant_weight(gen, K, N, bits, awq):
    """A random (K, N) weight quantized on the card (group 64 for int4),
    with an AWQ pre-scale from random activation magnitudes if ``awq``."""
    from repro_torch.quant import quantize_weight
    w = torch.randn((K, N), generator=gen, device="cuda") / math.sqrt(K)
    amax = None
    if awq:
        amax = (torch.rand((K,), generator=gen, device="cuda") * 4 + 0.1).cpu().numpy()
    return quantize_weight(w, bits=bits, group=QUANT_GROUP, act_amax=amax)


def check_quant_case(x, qw):
    """The kernel against its plain version on the same (pre-scaled) x;
    returns (max abs error, tolerance, ok): QUANT_TOL relative to the
    output's scale."""
    from repro_torch.kernels import quant_matmul as qk
    from repro_torch.kernels import ref
    xm = x if qw.pre is None else x * qw.pre[None, :].to(x.dtype)
    got = qk.quant_matmul(xm, qw.q, qw.scale, qw.bits, qw.group)
    want = ref.ref_quant_matmul(xm, qw.q, qw.scale, qw.bits, qw.group)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = QUANT_TOL * max(1.0, want.abs().max().item())
    return err, tol, bool(torch.isfinite(got).all()) and err <= tol


def int4pack_weight(q, inner_k_tiles=8):
    """The port's int4 layout, q (K/2, N) with two's-complement nibbles,
    in torch._weight_int4pack_mm's: unsigned nibbles u = s + 8 (the nibble
    with its top bit flipped) of w (N, K), even K in the high nibble, then
    tiled by torch._convert_weight_to_int4pack."""
    even = (q & 0xF) ^ 8
    odd = (q >> 4) ^ 8
    packed = ((even << 4) | odd).t().contiguous()
    return torch._convert_weight_to_int4pack(packed, inner_k_tiles)


def int4pack_scales(scale):
    """(K/group, N) fp32 scales as _weight_int4pack_mm's (K/group, N, 2)
    bf16 scales and zero points; with zero points 0 it computes
    x @ ((u - 8) * scale) per group, the port's s * scale."""
    return torch.stack([scale, torch.zeros_like(scale)], -1).bfloat16().contiguous()


def library_call(bits, q, scale):
    """(weights in the library's layout, fn(x, weights)) of the one PyTorch
    call that computes x @ dequant(q, scale) on bf16 x with bf16 scales."""
    if bits == 8:
        # x (M, K) @ (w (N, K) int8 * scales (N,))
        wts = (q.t().contiguous(), scale[0].bfloat16())
        return wts, lambda x, w: torch._weight_int8pack_mm(x, *w)
    wts = (int4pack_weight(q), int4pack_scales(scale))
    return wts, lambda x, w: torch._weight_int4pack_mm(x, w[0], QUANT_GROUP, w[1])


def quant_bound_ms(M, K, N, bits, x_dtype=torch.bfloat16):
    """Least time for the card: x, q and the scales read once, the fp32
    output written once, against 2*M*K*N operations at x's type's peak."""
    x_bytes = M * K * torch.tensor([], dtype=x_dtype).element_size()
    if bits == 8:
        w_bytes = K * N + N * 4
    else:
        w_bytes = K * N // 2 + (K // QUANT_GROUP) * N * 4
    t_bytes = (x_bytes + w_bytes + M * N * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * M * K * N / PEAK_FLOPS[x_dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_quant_shape(gen, K, N, bits, Ms=(16, 28, 512)):
    """Device times at one target shape: the kernel, its plain version, the
    library call that computes the same function
    (torch._weight_int8pack_mm or torch._weight_int4pack_mm, bf16 scales),
    and cuBLAS's bf16 matmul on an unquantized weight of the same shape,
    each over enough weight sets to exceed the L2. The library call is first held against
    the plain version. M 512 (prefill): 10 calls a graph (the int8 library
    call takes up to 0.15 s there)."""
    from repro_torch.kernels import quant_matmul as qk
    from repro_torch.kernels import ref
    qbytes = K * N if bits == 8 else K * N // 2
    n_q = max(2, math.ceil(QUANT_TIMING_SET_BYTES / qbytes))
    n_w = max(2, math.ceil(QUANT_TIMING_SET_BYTES / (2 * K * N)))
    if bits == 8:
        qs = [torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                            dtype=torch.int8) for _ in range(n_q)]
        scales = [torch.rand((1, N), generator=gen, device="cuda") / 127
                  for _ in range(n_q)]
    else:
        qs = [torch.randint(0, 256, (K // 2, N), generator=gen, device="cuda",
                            dtype=torch.uint8) for _ in range(n_q)]
        scales = [torch.rand((K // QUANT_GROUP, N), generator=gen, device="cuda") / 7
                  for _ in range(n_q)]
    ws = [torch.randn((K, N), generator=gen, device="cuda").bfloat16()
          for _ in range(n_w)]
    lib = [library_call(bits, q, s) for q, s in zip(qs, scales)]
    lib_fn = lib[0][1]
    x = torch.randn((28, K), generator=gen, device="cuda").bfloat16()
    want = ref.ref_quant_matmul(x, qs[0], scales[0], bits, QUANT_GROUP)
    lib_err = (lib_fn(x, lib[0][0]).float() - want).abs().max().item()
    lib_tol = LIBRARY_TOL * want.abs().max().item()
    assert lib_err <= lib_tol, (f"int{bits} library call disagrees with the "
                                f"plain version", K, N, lib_err, lib_tol)
    out = {}
    for M in Ms:
        xs = [torch.randn((M, K), generator=gen, device="cuda").bfloat16()
              for _ in range(max(n_q, n_w))]
        it = iter(range(10 ** 9))

        def rotate(fn, n):
            return lambda: fn(next(it) % n)

        fns = {"kernel": (lambda i: qk.quant_matmul(xs[i], qs[i], scales[i], bits,
                                                    QUANT_GROUP), n_q),
               "plain": (lambda i: ref.ref_quant_matmul(xs[i], qs[i], scales[i],
                                                        bits, QUANT_GROUP), n_q),
               "cublas_bf16": (lambda i: xs[i] @ ws[i], n_w)}
        fns["library"] = (lambda i: lib_fn(xs[i], lib[i][0]), n_q)
        iters = 10 if M > 28 else 50
        dev = {name: graph_ms(rotate(fn, n), iters=iters)
               for name, (fn, n) in fns.items()}
        dev["kernel_repeat"] = graph_ms(rotate(*fns["kernel"]), iters=iters)
        bound_ms, bound_by = quant_bound_ms(M, K, N, bits)
        out[M] = {"device_ms": dev, "bound_ms": bound_ms, "bound_by": bound_by,
                  "weight_sets": n_q}
    out["library"] = {"call": f"torch._weight_int{bits}pack_mm",
                      "max_abs_err_vs_plain": lib_err, "tol": lib_tol,
                      "timed_at": list(Ms)}
    return out


def phase9_quant_kernels():
    """The quantized matmul against its plain version in every case (every
    (K, N) of both models at every M of phase 10), then its device times at
    the target's shapes at M 16, 28 and 512."""
    from repro_torch.kernels import quant_matmul as qk
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = quant_pass_rows()
    shapes = [("ragged", 192, 1001, (5,))] + [
        (f"{model}:{name}", K, N, rows)
        for model, lst in QUANT_SHAPES.items() for name, K, N in lst]
    worst, worst_m, errs, n_cases = {}, {}, {}, 0
    for label, K, N, Ms in shapes:
        for bits in (8, 4):
            for awq in (False, True):
                qw = quant_weight(gen, K, N, bits, awq)
                for M in Ms:
                    x = torch.randn((M, K), generator=gen, device="cuda")
                    for dtype in (torch.bfloat16, torch.float32):
                        err, tol, ok = check_quant_case(x.to(dtype), qw)
                        n_cases += 1
                        key = (bits, str(dtype).split(".")[-1])
                        rel = err / tol * QUANT_TOL
                        worst[key] = max(worst.get(key, 0.0), rel)
                        worst_m[M] = max(worst_m.get(M, 0.0), rel)
                        errs[(label, bits, awq, M, dtype)] = err
                        if not ok:
                            emit({"phase": 9, "failed_case": {
                                "shape": label, "M": M, "K": K, "N": N, "bits": bits,
                                "awq": awq, "dtype": str(dtype), "max_abs_err": err,
                                "tol": tol}})
                            raise AssertionError("quant_matmul disagrees with its "
                                                 "plain version")
                del qw
    row_checks = check_rows_independent_of_m(gen)
    rows_ok = all(r["M4"] and r["M16"] and r["M512"] for r in row_checks)
    copy_checks = check_bf16_weight_copy(gen)
    copy_caught = not any(r["passes"] for r in copy_checks)
    if not (rows_ok and copy_caught):
        emit({"phase": 9, "row_checks": row_checks, "bf16_weight_copy": copy_checks})
    assert rows_ok, "a row's result depends on M"
    assert copy_caught, "the tolerance passes an int4 kernel with bf16 weights"
    timing = {f"int{bits}:{name}": time_quant_shape(gen, K, N, bits)
              for name, K, N in QUANT_SHAPES["target"] for bits in (8, 4)
              if name in QUANT_TIMED}
    emit({"phase": 9, "cases": n_cases, "all_ok": True, "M": rows,
          "worst_rel_err": {f"int{b}/{d}": e for (b, d), e in worst.items()},
          "worst_rel_err_by_M": worst_m, "tolerance_rel": QUANT_TOL,
          "rows_independent_of_M": {"checks": len(row_checks), "all_equal": rows_ok},
          "bf16_weight_copy": {
              "rel_err": {f"{r['shape']}/{r['dtype']}": r["rel_err"] for r in copy_checks},
              "fails_tolerance": sum(not r["passes"] for r in copy_checks),
              "of": len(copy_checks)},
          "slices": {f"{m}:{name}": qk.plan(K, N, 8)[1]
                     for m, lst in QUANT_SHAPES.items() for name, K, N in lst},
          "timing_note": "device ms per call, CUDA graph of 50 calls (M 512: 10), "
                         "x bf16; library and cuBLAS give bf16 outputs",
          "timing": timing})
    torch.cuda.empty_cache()
    out = {}
    for bits in (8, 4):       # the kernels line: wq at M 28 (the tree verify)
        t = timing[f"int{bits}:wq/wk/wv/wo"][28]
        dev = t["device_ms"]
        out[f"quant_matmul_int{bits}"] = {
            "max_abs_err": errs[("target:wq/wk/wv/wo", bits, True, 28, torch.bfloat16)],
            "ms": dev["kernel"], "plain_ms": dev["plain"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": dev.get("library")}
    return out


def check_rows_independent_of_m(gen):
    """For every (K, N) of the target and the drafter, both bit widths and
    both x dtypes: the rows of an M 28 batch (the tree verify pass) must
    come out bit for bit the same when they run in M 4 batches (the AR
    pass), M 16 batches (the chain verify pass) and scattered through an
    M 512 batch (the prefill). Greedy exactness (phases 5 and 11) rests on
    this."""
    from repro_torch.kernels import quant_matmul as qk
    records = []
    for model, lst in QUANT_SHAPES.items():
        for name, K, N in lst:
            for bits in (8, 4):
                qw = quant_weight(gen, K, N, bits, awq=False)
                for dtype in (torch.bfloat16, torch.float32):
                    def run(x):
                        return qk.quant_matmul(x.contiguous(), qw.q, qw.scale,
                                               bits, qw.group)
                    x28 = torch.randn((28, K), generator=gen, device="cuda").to(dtype)
                    want = run(x28)
                    in4 = all(torch.equal(run(x28[i:i + 4]), want[i:i + 4])
                              for i in range(0, 28, 4))
                    in16 = (torch.equal(run(x28[:16]), want[:16])
                            and torch.equal(run(x28[12:]), want[12:]))
                    big = torch.randn((512, K), generator=gen, device="cuda").to(dtype)
                    pos = torch.randperm(512, generator=torch.Generator().manual_seed(K + N),
                                         device="cpu")[:28].cuda()
                    big[pos] = x28
                    in512 = torch.equal(run(big)[pos], want)
                    records.append({"shape": f"{model}:{name}", "bits": bits,
                                    "dtype": str(dtype).split(".")[-1],
                                    "M4": in4, "M16": in16, "M512": in512})
                del qw
    return records


QM_WIDEN_INT4 = re.compile(r"s4pair\((p[ab]), p[ab]4, (2 \* i(?: \+ 1)?)\)")
QM_SCALE_INT4 = re.compile(r"fmaf\((p\[i\]\[\d\]), s_(?:lo|hi), (acc\[i\]\[j\]\[\d\])\)")
QM_BF16_WEIGHT = """
__device__ __forceinline__ uint32_t s4scaled(uint32_t u, int c, float4 s) {
  const float sv = c == 0 ? s.x : c == 1 ? s.y : c == 2 ? s.z : s.w;
  const uint32_t b = u >> (8 * c);
  return pack_bf16((float)((int)(b & 0xFu) - 8) * sv,
                   (float)((int)((b >> 4) & 0xFu) - 8) * sv);
}
"""


def bf16_weight_copy():
    """A copy of the kernel that forms the int4 weight q*s and rounds it to
    bf16 before the product (and skips the exact per-group scaling), built
    beside the real one from a text substitution: the tolerance must see
    the error that shortcut makes."""
    import ctypes
    from repro_torch.kernels import build
    src = (ROOT / QUANT_CU).read_text()
    anchor = "// x, transposed, as the B fragment"
    src, n_widen = QM_WIDEN_INT4.subn(r"s4scaled(\1, \2, sc[st])", src)
    src, n_scale = QM_SCALE_INT4.subn(r"(\1 + \2)", src)
    assert n_widen == 4 and n_scale == 4 and src.count(anchor) == 1, \
        ("the int4 widening or scaling lines moved", n_widen, n_scale)
    src = src.replace(anchor, QM_BF16_WEIGHT + anchor)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD_DIR / "quant_matmul_bf16_weight.cu"
    so = build.BUILD_DIR / "libquant_matmul_bf16_weight.so"
    cu.write_text(src)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                   check=True, capture_output=True, timeout=build.BUILD_TIMEOUT_S)
    fn = ctypes.CDLL(str(so)).quant_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_bf16_weight_copy(gen):
    """The bf16-weight copy against the plain version at every (K, N) of
    the target and drafter, M 28, both x dtypes: it must fail QUANT_TOL in
    every case."""
    from unittest import mock
    from repro_torch.kernels import quant_matmul as qk
    copy_fn = bf16_weight_copy()
    records = []
    with mock.patch.object(qk, "_launcher", lambda: copy_fn):
        for model, lst in QUANT_SHAPES.items():
            for name, K, N in lst:
                qw = quant_weight(gen, K, N, 4, awq=True)
                x = torch.randn((28, K), generator=gen, device="cuda")
                for dtype in (torch.bfloat16, torch.float32):
                    err, tol, ok = check_quant_case(x.to(dtype), qw)
                    records.append({"shape": f"{model}:{name}",
                                    "dtype": str(dtype).split(".")[-1],
                                    "rel_err": err / tol * QUANT_TOL, "passes": ok})
                del qw
    return records


def quant_passes(cfg) -> int:
    """Quantized matmul launches per forward pass: 7 per layer (4 in an MoE
    layer: its experts and router stay full precision) + lm head."""
    return (4 if cfg.is_moe else 7) * cfg.num_layers + 1


def phase10_quant_serving(smi, weights):
    """Full-width serving with quantized target and drafter and int8 KV
    caches: tree (2, 2), then chain gamma 3, temperature 0.7."""
    from repro_torch.configs import QuantConfig
    from repro_torch.core import speculative as tspec
    from repro_torch.core.metrics import mbsu
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.quant import decode_step_bytes, params_nbytes
    from repro_torch.spectree.tree import TreeSpec
    bits = {"int8": 8, "int4": 4}[weights]
    key = f"quant_matmul_int{bits}"
    B, P, NEW = QUANT_B, QUANT_P, 16       # cut from 64, then 32 (PERF.md)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    models = serve.build_models("llama2-7b-chat", False, "cuda",
                                QuantConfig(weights=weights, group_size=QUANT_GROUP),
                                quant_target=True, calib_seqs=4, calib_len=P)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    target, t_params, draft, d_params, c = models
    stored = {"target": params_nbytes(t_params), "drafter": params_nbytes(d_params)}
    modeled = {name: dict(zip(("weight", "scale", "kv", "total"),
                              decode_step_bytes(m.cfg, B, P + NEW, weights, "int8",
                                                QUANT_GROUP).row()))
               for name, m in (("target", target), ("drafter", draft))}
    spec = TreeSpec(QUANT_TREE)
    sdc = tspec.SDConfig(gamma=QUANT_GAMMA, temperature=0.7, kv_quant=True)
    prompts = serve.make_prompts(B, P, target.cfg.vocab_size)
    prompt = torch.as_tensor(prompts, device="cuda")
    st = tspec._prefill_state(draft, target, d_params, t_params, prompt,
                              P + NEW + 9, sdc, torch.Generator(device="cuda"))
    kv_dtypes = sorted({str(layer[n].dtype) for c_ in (st["t_cache"], st["d_cache"])
                        for layer in c_ for n in ("k", "v")})
    assert kv_dtypes == ["torch.int8"], kv_dtypes
    del st
    pt, pd = quant_passes(target.cfg), quant_passes(draft.cfg)

    serve.serve_tree(target, t_params, draft, d_params, prompts, 8, sdc, spec, seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    toks, stats = serve.serve_tree(target, t_params, draft, d_params, prompts,
                                   NEW, sdc, spec)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tree_launches = dict(ops.LAUNCHES)
    R = stats.rounds
    want = {k: 0 for k in ops.LAUNCHES}
    want["tree_attention"] = R * (target.cfg.num_layers
                                  + draft.cfg.num_layers * (spec.depth + 1))
    want[key] = (1 + R) * pt + (1 + (spec.depth + 1) * R) * pd
    assert R > 0 and tree_launches == want, (tree_launches, want)
    new = toks[:, P:P + NEW]
    assert bool(((new >= 0) & (new < target.cfg.vocab_size)).all()), "token out of vocab"
    assert stats.tau >= 1.0 and math.isfinite(stats.tau), stats.tau
    breakdown = profile_tree(models, prompts, sdc, spec, stats.wall_time_s * 1e3 / R)
    # the profiled run holds one prefill of each model (M 512 through the
    # kernel): its device time apart, and the rounds' without it
    prefill_ms = {name: cuda_ms(lambda m=m, p=p: m.prefill(p, prompt, cache_len=P + NEW + 9),
                                iters=3, warmup=1)
                  for name, m, p in (("target", target, t_params),
                                     ("drafter", draft, d_params))}
    if breakdown.get("profiled_rounds"):
        breakdown["device_ms_per_round_without_prefill"] = (
            breakdown["device_ms_per_round"]
            - sum(prefill_ms.values()) / breakdown["profiled_rounds"])

    serve.serve_static(target, t_params, draft, d_params, prompts, 8, sdc, seed=1)
    ops.reset_launches()
    results, tau, tok_s = serve.serve_static(target, t_params, draft, d_params,
                                             prompts, NEW, sdc)
    chain_launches = dict(ops.LAUNCHES)
    Rc = results[0].rounds
    want_c = {k: 0 for k in ops.LAUNCHES}
    want_c[key] = (1 + Rc) * pt + (1 + (sdc.gamma + 1) * Rc) * pd
    assert Rc > 0 and chain_launches == want_c, (chain_launches, want_c)
    for r in results:
        assert len(r.tokens) == NEW and ((r.tokens >= 0)
                                         & (r.tokens < target.cfg.vocab_size)).all()
    assert tau >= 1.0 and math.isfinite(tau), tau
    emit({"phase": 10, "weights": weights, "group": QUANT_GROUP, "kv": "int8",
          "quantized": ["target", "drafter"], "awq_calib": {"seqs": 4, "prompt_len": P,
                                                            "temperatures": [0.0, 0.7],
                                                            "response": 16},
          "build_s": build_s, "build_peak_gb": build_peak_gb,
          "prefill_ms": prefill_ms,
          "stored_bytes": stored, "modeled_decode_step_bytes": modeled,
          "tree": {"branching": spec.branching, "rounds": R, "tau": stats.tau,
                   "mbsu": mbsu(stats.tau, c, spec.depth), "tok_s": stats.tokens_per_s(),
                   "wall_s": stats.wall_time_s, "launches": tree_launches,
                   "peak_mem_gb": peak_gb, "where_the_time_goes": breakdown},
          "chain": {"gamma": sdc.gamma, "rounds": Rc, "tau": tau,
                    "mbsu": mbsu(tau, c, sdc.gamma), "tok_s": tok_s,
                    "launches": chain_launches,
                    "note": "tok/s over each batch's wall time, prefill included"},
          "launches_per_pass": {"target": pt, "drafter": pd},
          "c": c, "requests": B, "prompt_len": P, "max_new": NEW,
          "temperature": 0.7, "nvidia_smi": smi})
    return tree_launches[key] + chain_launches[key]


def phase11_quant_greedy_exactness():
    """Temperature 0 with quantized weights (target cut to 2 layers, float32,
    KV in float): tree and chain tokens must equal the quantized target's
    greedy tokens."""
    from repro_torch.configs import QuantConfig, get_config
    from repro_torch.core.speculative import (SDConfig, autoregressive_generate,
                                              speculative_generate)
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    from repro_torch.quant import quantize_params
    from repro_torch.spectree.round import tree_speculative_generate
    from repro_torch.spectree.tree import TreeSpec
    cfg = get_config("llama2-7b-chat").replace(num_layers=2, dtype="float32")
    P, M = 64, 32
    prompt = torch.as_tensor(serve.make_prompts(2, P, cfg.vocab_size, seed=5),
                             device="cuda")
    sdc = SDConfig(gamma=3, temperature=0.0)
    spec = TreeSpec((2, 2))
    out = {}
    for weights in ("int8", "int4"):
        target = Model(cfg, "cuda")
        draft = Model(cfg.drafter(), "cuda")
        t_fp = target.init(0, dtype=torch.float32)
        d_fp = draft.init(1, dtype=torch.float32)
        calib = serve.calibration_tokens(target, t_fp, 2, 32)
        qcfg = QuantConfig(weights=weights, group_size=QUANT_GROUP)
        t_params = quantize_params(target, t_fp, qcfg, calib_tokens=calib)
        d_params = quantize_params(draft, d_fp, qcfg, calib_tokens=calib)
        del t_fp, d_fp
        ops.reset_launches()
        ar, _ = autoregressive_generate(target, t_params, prompt, M, temperature=0.0)
        chain, _ = speculative_generate(draft, target, d_params, t_params, prompt,
                                        M, sdc)
        tree, tstats = tree_speculative_generate(draft, target, d_params, t_params,
                                                 prompt, M, sdc, spec)
        launches = dict(ops.LAUNCHES)
        ok_chain = torch.equal(chain[:, :P + M], ar)
        ok_tree = torch.equal(tree[:, :P + M], ar)
        out[weights] = {"chain_equals_ar": ok_chain, "tree_equals_ar": ok_tree,
                        "tree_rounds": tstats.rounds, "tree_tau": tstats.tau,
                        "launches": launches}
        assert ok_chain and ok_tree, (weights, "speculative greedy tokens differ from AR")
        assert launches[f"quant_matmul_int{4 if weights == 'int4' else 8}"] > 0
    emit({"phase": 11, "arch": cfg.name, "target_layers": 2, "dtype": "float32",
          "kv": "float", "temperature": 0.0, "results": out})


# ------------------------------------------------ flash decode (12)

# kernel vs plain version, relative to the output's scale (max |plain|):
# both widen K/V to fp32 and sum fp32 products, so they differ only in the
# order of the sums and, on the tensor cores, in p's 16 bits (hi + lo
# bf16 terms): at most 2.3e-6 of scale on the CUDA cores and 2.5e-6 on the
# tensor cores on an H100; a copy whose accumulator is rounded to bf16
# (CUDA cores) or whose p keeps only its hi term (tensor cores) is off by
# about 1e-3
FD_TOL = 1e-5
# the port's decode attention (bf16 scores, probabilities and output)
# against the kernel route (fp32 inside, its output rounded to bf16 before
# wo), relative L2 norm of the layer's output: bf16 rounding of the scores
# and probabilities moves it by about 5e-3
FD_MODEL_TOL = 2e-2
FD_CHAIN_S = 128 + 64 + 3 + 2    # chain serving cache length of phase 4
FD_ACC_LINE = "acc[i][e] = fmaf(p[u], to_float(vt[e]), acc[i][e]);"
FD_LO_LINE = "pl[i] = pack_bf16(p0 - h0, p1 - h1);"
# the negative control of each route: a copy of the kernel with one line
# replaced, which must fail FD_TOL on every case whose output it changes
FD_COPIES = {
    "simt": (FD_ACC_LINE, "acc[i][e] = __bfloat162float(__float2bfloat16("
                          "fmaf(p[u], to_float(vt[e]), acc[i][e])));"),
    "mma": (FD_LO_LINE, "pl[i] = 0u;"),
}


def decode_inputs(gen, B, Hkv, G, hd, S, dtype, kv="float", masked_row=False):
    """Inputs of the flash decode kernel: q/k/v drawn on the card (K/V
    through an int8 cache and back with ``kv="int8"``) and the validity mask
    of a ring cache decoding past its last slot: a tenth of each row's
    slots empty (position -1), the rest valid; row 0 fully masked if
    asked."""
    from repro_torch.quant.kvcache import dequantize_kv_entry, quantize_kv_entry
    dev = "cuda"
    q = torch.randn((B, Hkv, G, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, S, Hkv, hd), generator=gen, device=dev)
    v = torch.randn((B, S, Hkv, hd), generator=gen, device=dev)
    if kv == "int8":
        k = dequantize_kv_entry(*quantize_kv_entry(k), dtype)
        v = dequantize_kv_entry(*quantize_kv_entry(v), dtype)
    k, v = k.to(dtype), v.to(dtype)
    mask = torch.rand((B, S), generator=gen, device=dev) >= 0.1
    if masked_row:
        mask[0] = False
    return q, k, v, mask


def sdpa_decode(q, k, v, mask):
    """The one PyTorch call that computes flash decode (a yardstick only):
    scaled_dot_product_attention on (B, H, 1, hd) queries and (B, Hkv, S,
    hd) views of the cache, the (B, S) mask broadcast, GQA by the library."""
    B, Hkv, G, hd = q.shape
    out = torch.nn.functional.scaled_dot_product_attention(
        q.reshape(B, Hkv * G, 1, hd), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask[:, None, None, :], enable_gqa=True)
    return out.reshape(B, Hkv, G, hd)


BF16, F32 = torch.bfloat16, torch.float32
FD_CASES = [  # (label, B, Hkv, G, hd, S, dtype, softcap, kv, masked_row)
    ("bench", 4, 4, 2, 128, 1024, F32, None, "float", False),
    *[(f"{who}-S{S}", 4, hkv, 1, 128, S, dt, None, "float", False)
      for who, hkv in (("target", 32), ("drafter", 8))
      for S in (FD_CHAIN_S, 1024, 4096)
      for dt in (BF16, F32)],
    ("target-int8kv", 4, 32, 1, 128, FD_CHAIN_S, BF16, None, "int8", False),
    ("drafter-int8kv", 4, 8, 1, 128, 1024, BF16, None, "int8", False),
    ("pipeline-target", 4, 2, 3, 32, FD_CHAIN_S, BF16, None, "float", False),
    ("pipeline-target", 4, 2, 3, 32, FD_CHAIN_S, F32, None, "float", False),
    ("pipeline-drafter", 4, 2, 2, 16, FD_CHAIN_S, BF16, None, "float", False),
    ("pipeline-drafter", 4, 2, 2, 16, FD_CHAIN_S, F32, None, "float", False),
    ("pipeline-drafter-S4096", 4, 2, 2, 16, 4096, BF16, None, "float", False),
    ("hd64-G3", 2, 4, 3, 64, 1024, BF16, None, "float", False),
    ("hd256", 2, 2, 2, 256, 512, F32, None, "float", False),
    ("hd256", 2, 2, 2, 256, 512, BF16, None, "float", False),
    ("G5", 2, 3, 5, 64, 201, F32, None, "float", False),
    *[("G17", 2, 3, 17, 64, 201, dt, None, "float", False) for dt in (BF16, F32)],
    ("softcap", 4, 32, 1, 128, FD_CHAIN_S, BF16, 50.0, "float", False),
    ("ragged", 4, 32, 1, 128, 201, BF16, None, "float", False),
    ("fully-masked-row", 4, 8, 1, 128, 1024, BF16, None, "float", True),
    ("S1", 1, 2, 1, 128, 1, F32, None, "float", False),
    # Yi-9B's decode (32 heads on 4 KV heads: G 8), up to a 16K cache
    *[("yi-S1024", 4, 4, 8, 128, 1024, dt, None, "float", False)
      for dt in (BF16, F32)],
    ("yi-S16384", 4, 4, 8, 128, 16384, BF16, None, "float", False),
    ("yi-S16381", 4, 4, 8, 128, 16381, BF16, None, "float", False),
    ("yi-softcap", 4, 4, 8, 128, 1024, BF16, 50.0, "float", False),
    ("yi-fully-masked-row", 4, 4, 8, 128, 1024, BF16, None, "float", True),
    ("yi-drafter-S1024", 4, 4, 2, 128, 1024, BF16, None, "float", False),
    # Phi-4-mini and Minitron-4B (24 heads on 8: G 3), Chameleon-34B (64
    # heads on 8: G 8)
    ("g3-S4096", 4, 8, 3, 128, 4096, BF16, None, "float", False),
    ("chameleon-S1024", 4, 8, 8, 128, 1024, BF16, None, "float", False),
]


def fd_plan(B, Hkv, G, hd, S, dtype):
    """The launch plan of a case: its route, chunk, splits (the cluster's
    size), row tiles, and how many such clusters the card holds at once."""
    from repro_torch.kernels import flash_decode as fk
    chunk, splits = fk.device_plan(B, Hkv, G, hd, S, dtype, 0)
    return {"route": fk.route(hd, dtype), "chunk": chunk, "splits": splits,
            "cluster": splits, "row_tiles": fk.row_tiles(G),
            "resident_clusters": fk._max_clusters(
                0, min(G, fk.ROW_TILE), hd, fk._DTYPE_CODES[dtype], splits)}


def check_decode_cases():
    """Every case of FD_CASES through the kernel (``kernels.flash_decode``,
    not counted) against the plain version; then a second input set of
    every case run twice, which must give equal outputs (every combine runs
    in a fixed order). Returns the records and the kernel's outputs."""
    from repro_torch.kernels import flash_decode as fk
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(12)
    again = torch.Generator(device="cuda").manual_seed(14)
    records, outs = [], []
    for label, B, Hkv, G, hd, S, dtype, cap, kv, masked in FD_CASES:
        q, k, v, mask = decode_inputs(gen, B, Hkv, G, hd, S, dtype, kv, masked)
        want = ref.ref_flash_decode(q, k, v, mask, softcap=cap)
        second = decode_inputs(again, B, Hkv, G, hd, S, dtype, kv, masked)
        got = fk.flash_decode(q, k, v, mask, softcap=cap)
        one = fk.flash_decode(*second, softcap=cap)
        two = fk.flash_decode(*second, softcap=cap)
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        records.append({"case": label, "B": B, "Hkv": Hkv, "G": G, "hd": hd,
                        "S": S, "dtype": str(dtype).split(".")[-1],
                        "softcap": cap, "kv": kv, "fully_masked_row": masked,
                        **fd_plan(B, Hkv, G, hd, S, dtype),
                        "max_abs_err": err, "rel_err": err / scale,
                        "repeat_equal": bool(torch.equal(one, two)),
                        "ok": bool(torch.isfinite(got).all())
                        and err <= FD_TOL * scale})
        outs.append(got)
        del q, k, v, mask, want, second
    return records, outs


FD_COPY_BUILDS = {}   # route -> (library, nvcc process or None), phase 1


def start_kernel_copies():
    """Start building the negative controls of FD_COPIES (text substitution
    into ``build/kernels``, one nvcc each, each library named by a hash of
    its text, so a later run reuses it), beside phase 1's builds."""
    from repro_torch.kernels import build
    src = (ROOT / "src/repro_torch/kernels/csrc/flash_decode.cu").read_text()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for via, (line, copy) in FD_COPIES.items():
        assert src.count(line) == 1, ("the copied line moved", line)
        text = src.replace(line, copy)
        tag = hashlib.sha256(text.encode()).hexdigest()[:16]
        so = build.BUILD_DIR / f"libflash_decode_{via}_control-{tag}.so"
        if so.exists():
            FD_COPY_BUILDS[via] = (so, None)
            continue
        cu = build.BUILD_DIR / f"flash_decode_{via}_control-{tag}.cu"
        cu.write_text(text)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        FD_COPY_BUILDS[via] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(tmp), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))


@atexit.register
def stop_kernel_copies():
    for _, proc in FD_COPY_BUILDS.values():
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()


def kernel_copies():
    """Each route's C entry point of its negative-control copy, once its
    build (started in phase 1, or here) has finished."""
    import ctypes
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_decode as fk
    if not FD_COPY_BUILDS:
        start_kernel_copies()
    fns = {}
    for via, (so, proc) in FD_COPY_BUILDS.items():
        if proc is not None:
            log, _ = proc.communicate(timeout=build.BUILD_TIMEOUT_S)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            assert proc.returncode == 0, log
            os.replace(tmp, so)
            FD_COPY_BUILDS[via] = (so, None)
        fns[via] = fk.typed_launch(ctypes.CDLL(str(so)).flash_decode_launch)
    return fns


def model_decode_check(models):
    """The port's decode attention for one decode position after a prefill
    of 4 x 128, at full width, against the kernel route on the same layer:
    ``_project_qkv``, the new entry written into a copy of the cache, the
    validity mask, ``ops.flash_decode_attention`` and ``wo``. The kernel's
    fp32 output is also held to ``_sdpa`` in float32 on the same q/k/v.
    Target layers 0 and 31 (bf16 cache, then layer 31 of the int8 cache) and
    drafter layers 0 and 3."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import attention
    from repro_torch.models.layers import embed_tokens, matmul_param, rms_norm
    from repro_torch.quant.kvcache import (dequantize_kv_entry, quantize_kv_cache,
                                           quantize_kv_entry)
    target, t_params, draft, d_params, _ = models
    B, P = 4, 128
    prompt = torch.as_tensor(serve.make_prompts(B, P, target.cfg.vocab_size),
                             device="cuda")
    nxt = prompt[:, -1:]
    pos = torch.full((B, 1), P, dtype=torch.long, device="cuda")
    records = []
    for who, model, params in (("target", target, t_params),
                               ("drafter", draft, d_params)):
        cfg = model.cfg
        _, caches = model.prefill(params, prompt, cache_len=FD_CHAIN_S)
        last = cfg.num_layers - 1
        layers = [(0, caches), (last, caches)]
        if who == "target":
            layers.append((last, quantize_kv_cache(caches)))
        for i, cs in layers:
            lp = params["layers"][i]
            x = embed_tokens(params["embed"], nxt).to(cfg.compute_dtype)
            h = rms_norm(x, lp["norm1"], cfg.norm_eps)
            c_ref = {n: t.clone() for n, t in cs[i].items()}
            out_ref, _ = attention.decode_attention(lp["attn"], h, c_ref, pos, cfg)

            c = {n: t.clone() for n, t in cs[i].items()}
            q, k, v = attention._project_qkv(lp["attn"], h, cfg, pos)
            bidx = torch.arange(B, device="cuda")[:, None]
            slot = (pos % FD_CHAIN_S).long()
            if "k_scale" in c:
                (kq, ks), (vq, vs) = quantize_kv_entry(k), quantize_kv_entry(v)
                c["k"][bidx, slot], c["k_scale"][bidx, slot] = kq, ks
                c["v"][bidx, slot], c["v_scale"][bidx, slot] = vq, vs
                kc = dequantize_kv_entry(c["k"], c["k_scale"], q.dtype)
                vc = dequantize_kv_entry(c["v"], c["v_scale"], q.dtype)
            else:
                c["k"][bidx, slot], c["v"][bidx, slot] = k, v
                kc, vc = c["k"], c["v"]
            c["pos"][bidx, slot] = pos.to(torch.int32)
            mask = (c["pos"] >= 0) & (c["pos"] <= pos)
            Hkv, hd = cfg.num_kv_heads, cfg.head_dim_
            qg = q.reshape(B, Hkv, cfg.q_per_kv, hd)        # kv-major heads
            att = ops.flash_decode_attention(qg, kc, vc, mask, cfg.attn_softcap)
            out_k = matmul_param(att.reshape(B, 1, -1).to(q.dtype), lp["attn"]["wo"])
            f32 = attention._sdpa(q.float(), kc.float(), vc.float(),
                                  mask[:, None, :], cfg)
            torch.cuda.synchronize()
            rel_l2 = ((out_k.float() - out_ref.float()).norm()
                      / out_ref.float().norm()).item()
            att_err = (att.reshape(f32.shape) - f32).abs().max().item()
            att_scale = f32.abs().max().item()
            rec = {"model": who, "layer": i,
                   "kv": "int8" if "k_scale" in c else str(kc.dtype).split(".")[-1],
                   "S": FD_CHAIN_S, "valid_slots": int(mask[0].sum()),
                   "out_rel_l2_vs_decode_attention": rel_l2,
                   "out_tol": FD_MODEL_TOL,
                   "attn_max_abs_err_vs_fp32_sdpa": att_err,
                   "attn_tol": FD_TOL * att_scale,
                   "cache_written_alike": bool(torch.equal(c["pos"], c_ref["pos"])
                                               and torch.equal(c["k"], c_ref["k"]))}
            rec["ok"] = (rel_l2 <= FD_MODEL_TOL and att_err <= rec["attn_tol"]
                         and rec["cache_written_alike"])
            records.append(rec)
            if not rec["ok"]:
                emit({"phase": 12, "failed_model_check": rec})
                raise AssertionError("flash decode route disagrees with decode "
                                     "attention")
    return records


FD_TIMING = (  # (label, B, Hkv, G, S, dtype), hd 128
    ("target-S1024", 4, 32, 1, 1024, BF16), ("target-S4096", 4, 32, 1, 4096, BF16),
    ("drafter-S1024", 4, 8, 1, 1024, BF16), ("yi-S1024", 4, 4, 8, 1024, BF16),
    ("yi-S4096", 4, 4, 8, 4096, BF16), ("yi-S16384", 4, 4, 8, 16384, BF16),
    ("g3-S4096", 4, 8, 3, 4096, BF16), ("bench", 4, 4, 2, 1024, F32))


def phase12_flash_decode(models, smi):
    """flash_decode against its plain version at every decode shape of the
    pair, of the pipeline configs and of the registry's GQA targets, a
    second input set run twice for equal outputs; each route's
    negative-control copy must fail the same tolerance on every case whose
    output it changes; the full-width decode-attention check through
    ``ops.flash_decode_attention`` (the launches counted); device times
    beside the bound, the plain version's and SDPA's."""
    from unittest import mock
    from repro_torch.kernels import flash_decode as fk
    from repro_torch.kernels import ops, ref
    cases, outs = check_decode_cases()
    bad = [c for c in cases if not (c["ok"] and c["repeat_equal"])]
    if bad:
        emit({"phase": 12, "cases": cases})
        raise AssertionError(f"flash_decode disagrees with its plain version "
                             f"or with itself: {bad}")

    # a copy acts on a case where its output differs from the kernel's
    # (the kernel is bit for bit repeatable); it must change some case of
    # its own route, none of the other's, and fail every case it changes
    controls = {}
    for via, fn in kernel_copies().items():
        with mock.patch.object(fk, "_launcher", lambda fn=fn: fn):
            copied, copy_outs = check_decode_cases()
        acted = [c for c, a, b in zip(copied, copy_outs, outs)
                 if not torch.equal(a, b)]
        controls[via] = {"line": FD_COPIES[via][0], "cases": len(acted),
                         "routes": sorted({c["route"] for c in acted}),
                         "passed": [c["case"] for c in acted if c["ok"]],
                         "min_rel_err": min((c["rel_err"] for c in acted),
                                            default=None)}
        assert controls[via]["routes"] == [via] and not controls[via]["passed"], (
            "the tolerance passes a broken copy of the kernel", via, controls[via])
        del copy_outs
    del outs

    # clusters of 1-8 blocks the card holds at once, for the instances
    # of hd 128 and G 8 (the plan keeps a grid within one such wave)
    occupancy = {f"{fk.route(128, dt)}/{str(dt).split('.')[-1]}": {
        s: fk._max_clusters(0, 8, 128, fk._DTYPE_CODES[dt], s)
        for s in range(1, fk.MAX_SPLITS + 1)}
        for dt in (BF16, F32)}

    ops.reset_launches()
    model_checks = model_decode_check(models)
    launches = dict(ops.LAUNCHES)
    assert launches == {**{n: 0 for n in launches}, "flash_decode": len(model_checks)}, \
        launches

    # device times at the decode shapes (one position, ring masks without
    # empty rows), rotating over enough input sets to exceed the L2
    gen = torch.Generator(device="cuda").manual_seed(13)
    timing, lib_err = {}, {}
    for label, B, Hkv, G, S, dtype in FD_TIMING:
        one = decode_inputs(gen, B, Hkv, G, 128, S, dtype)
        set_bytes = sum(t.numel() * t.element_size() for t in one)
        sets = [one] + [decode_inputs(gen, B, Hkv, G, 128, S, dtype)
                        for _ in range(max(1, math.ceil(150e6 / set_bytes)) - 1)]
        want = ref.ref_flash_decode(*one)
        lib = sdpa_decode(*one).float()
        lib_err[label] = {"max_abs_err": (lib - want).abs().max().item(),
                          "tol": LIBRARY_TOL * want.abs().max().item()}
        assert lib_err[label]["max_abs_err"] <= lib_err[label]["tol"], \
            ("SDPA disagrees with the plain version", label, lib_err[label])
        it = iter(range(10 ** 9))

        def rotate(fn):
            return lambda: fn(*sets[next(it) % len(sets)])

        fns = {"kernel": fk.flash_decode, "plain": ref.ref_flash_decode,
               "library": sdpa_decode}
        dev = {name: graph_ms(rotate(fn)) for name, fn in fns.items()}
        dev["kernel_repeat"] = graph_ms(rotate(fk.flash_decode))
        eager = cuda_ms(rotate(fk.flash_decode), iters=200)
        q, k, v, mask = one       # one decode row: a tree of one node
        bound_ms, bound_by = tree_bound_ms(q[:, :, None], k, v, mask)
        timing[label] = {"B": B, "Hkv": Hkv, "G": G, "hd": 128, "S": S,
                         "dtype": str(dtype).split(".")[-1],
                         **fd_plan(B, Hkv, G, 128, S, dtype),
                         "input_sets": len(sets), "device_ms": dev,
                         "kernel_eager_call_ms": eager, "bound_ms": bound_ms,
                         "bound_by": bound_by,
                         "share_of_bound": bound_ms / dev["kernel"]}
        del sets, one
    emit({"phase": 12, "cases": cases, "tolerance_rel": FD_TOL,
          "worst_rel_err": {via: max(c["rel_err"] for c in cases
                                     if c["route"] == via)
                            for via in FD_COPIES},
          "negative_controls": controls, "resident_clusters_hd128_G8": occupancy,
          "model_checks": model_checks, "launches": launches,
          "library_vs_plain": lib_err,
          "timing_note": "device ms per call, CUDA graph of 200 calls, q/k/v "
                         "bf16 (bench: fp32), hd 128",
          "timing": timing, "nvidia_smi": smi})
    t = timing["target-S1024"]
    err = next(c["max_abs_err"] for c in cases if c["case"] == "target-S1024"
               and c["dtype"] == "bfloat16")
    torch.cuda.empty_cache()
    return launches["flash_decode"], {
        "flash_decode": {"max_abs_err": err, "ms": t["device_ms"]["kernel"],
                         "plain_ms": t["device_ms"]["plain"],
                         "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                         "library_ms": t["device_ms"]["library"]}}


# ------------------------------------------------ the paper's pipeline (13-14)

def phase13_pipeline(smi):
    """The paper's pipeline on the card at the reference's --quick sizes."""
    from repro_torch.experiments import pipeline
    t0 = time.perf_counter()
    res = pipeline.run_pipeline(device="cuda", verbose=False, **pipeline.QUICK)
    wall_s = time.perf_counter() - t0
    c = pipeline.draft_config().param_count() / pipeline.target_config().param_count()
    gammas = (3, 5)
    taus = [(g, res.tau[v][t][str(g)]) for v in res.tau for t in res.tau[v]
            for g in gammas]
    taus += [(3, tau) for v in res.tau_by_ckpt for t in res.tau_by_ckpt[v]
             for _, tau in res.tau_by_ckpt[v][t]]
    taus += [(3, tau) for tau in res.ood.values()]
    emit({"phase": 13, "sizes": pipeline.QUICK, "result": dataclasses.asdict(res),
          "wall_s": wall_s, "c_from_configs": c, "nvidia_smi": smi})
    assert res.c_ratio == c, (res.c_ratio, c)
    assert len(taus) == 4 * 3 * 2 + 3 * 3 * 3 + 4, len(taus)
    assert all(1.0 <= tau <= g + 1 for g, tau in taus), taus
    assert all(math.isfinite(m) for v in res.mbsu.values() for t in v.values()
               for m in t.values()), res.mbsu
    assert all(math.isfinite(r) and r > 0 for r in res.token_rate_ratio.values())


STEP_LOSS = re.compile(r"^step (\d+): .*'loss': ([^,}]+)", re.M)


class CliPool:
    """The CLI runs of the phases in subprocesses, in the background while
    the script goes on with other phases: ``jobs`` is {name: (command, GB
    of the card it may take, the job it must follow or None)}. At most
    ``slots`` run at once, their GB within ``budget_gb`` (a job alone may
    exceed it); one past 600 s is killed. ``wait(names)``
    gives {name: (``CompletedProcess``, seconds from its start to its
    exit)}."""

    TIMEOUT_S = 600

    def __init__(self, jobs, slots, budget_gb):
        self.jobs, self.slots, self.budget_gb = dict(jobs), slots, budget_gb
        self.running, self.done = {}, {}
        self.stopped = False
        self.lock = threading.Lock()
        atexit.register(self.stop)
        self.thread = threading.Thread(target=self._schedule, daemon=True)
        self.thread.start()

    def _schedule(self):
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        pending = list(self.jobs)
        while (pending or self.running) and not self.stopped:
            for name in list(self.running):
                cmd, proc, out, err, t0 = self.running[name]
                if proc.poll() is None and time.perf_counter() - t0 < self.TIMEOUT_S:
                    continue
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                out.seek(0)
                err.seek(0)
                result = (subprocess.CompletedProcess(
                    cmd, proc.returncode, out.read(), err.read()),
                    time.perf_counter() - t0)
                out.close()
                err.close()
                with self.lock:
                    del self.running[name]
                    self.done[name] = result
            for name in list(pending):
                cmd, gb, after = self.jobs[name]
                used = sum(self.jobs[n][1] for n in self.running)
                if (after is not None and after not in self.done
                        or len(self.running) >= self.slots
                        or self.running and used + gb > self.budget_gb):
                    continue
                out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
                with self.lock:
                    self.running[name] = (cmd, subprocess.Popen(
                        cmd, stdout=out, stderr=err, text=True, cwd=ROOT,
                        env=env), out, err, time.perf_counter())
                pending.remove(name)
            time.sleep(0.2)

    def wait(self, names):
        while not all(n in self.done for n in names):
            if not self.thread.is_alive():
                assert all(n in self.done for n in names), (
                    "the CLI pool stopped", names, sorted(self.done))
            time.sleep(0.2)
        return {n: self.done[n] for n in names}

    def stop(self):
        """Kill what still runs (a phase that fails first must not leave
        the pool's processes behind)."""
        self.stopped = True
        with self.lock:
            for _, proc, *_ in self.running.values():
                if proc.poll() is None:
                    proc.kill()


def train_cli_jobs():
    """Phase 14's CLI runs for a ``CliPool``: --phase pretrain and --phase
    distill --loss tvdpp, 10 steps each of the reduced config."""
    return {f"14-{name}": ([sys.executable, "-m", "repro_torch.launch.train",
                           "--arch", "llama2-7b-chat", "--reduced", "--steps",
                           "10", *extra], 2, None)
            for name, extra in (
                ("pretrain", ["--phase", "pretrain", "--save",
                              str(ROOT / "build" / "train_cli.npz")]),
                ("distill", ["--phase", "distill", "--loss", "tvdpp"]))}


def phase14_train_cli(smi, pool):
    """The training CLI in subprocesses (``train_cli_jobs``): the pretrain
    loss must fall below its first logged value, and the TVD++ surrogate
    is 0 up to rounding: finite."""
    runs = {}
    for name, (proc, s) in pool.wait(list(train_cli_jobs())).items():
        losses = [float(x) for _, x in STEP_LOSS.findall(proc.stdout)]
        runs[name[3:]] = {"cmd": " ".join(proc.args[1:]), "rc": proc.returncode,
                          "s": s, "loss": losses,
                          "tail": proc.stdout.strip().splitlines()[-2:],
                          "stderr": proc.stderr.strip().splitlines()[-3:]}
    emit({"phase": 14, "runs": runs, "nvidia_smi": smi})
    for name, r in runs.items():
        assert r["rc"] == 0 and len(r["loss"]) == 5, (name, r)
        assert all(math.isfinite(x) for x in r["loss"]), (name, r)
    assert min(runs["pretrain"]["loss"][1:]) < runs["pretrain"]["loss"][0], \
        runs["pretrain"]


LAUNCH_LINE = re.compile(r"^kernel launches: (\{.*\})$", re.M)


REDUCED_TREE_CLI = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                    "llama2-7b-chat", "--reduced", "--tree", "--tree-depth",
                    "2", "--tree-branch", "2", "--temperature", "0.7"]


def phase15_reduced_tree_cli(smi, pool):
    """Tree serving of the reduced config (head dim 32) through the serving
    CLI in a subprocess (job "15" of a ``CliPool``): it must exit 0 with
    tree_attention launches counted (its printed counts) and no other
    kernel launched."""
    proc, s = pool.wait(["15"])["15"]
    found = LAUNCH_LINE.search(proc.stdout)
    launches = json.loads(found[1]) if found else None
    run = {"cmd": " ".join(REDUCED_TREE_CLI[1:]), "rc": proc.returncode,
           "s": s, "launches": launches,
           "stdout": proc.stdout.strip().splitlines()[-6:],
           "stderr": proc.stderr.strip().splitlines()[-3:]}
    emit({"phase": 15, "head_dim": 32, "run": run, "nvidia_smi": smi})
    assert proc.returncode == 0 and launches is not None, run
    assert launches["tree_attention"] > 0, run
    assert all(n == 0 for k, n in launches.items() if k != "tree_attention"), run


# ------------------------------------------------ continuous serving (16-17)

CONT_MIX, CONT_N, CONT_RATE = "chat", 16, 4.0     # phase 16's request stream
# the first SHORT_N requests of that stream serve phases 18, 19, 21, 22 and
# 23b, cut from 16 to pay for phase 24 (PERF.md lists each cut); at t = 0
# they would all be admitted before any prompt reaches the prefix cache.
# Phases 18, 19, 21 and 23b serve them through SHORT_BATCH slots, so that
# requests queue and retired slots and their pages are reused.
SHORT_N, SHORT_BATCH = 8, 4
CONT_ENGINE = dict(max_batch=8, page_size=16, prefill_chunk=32)


def chat_requests(n, rate, vocab, seed=0):
    from repro_torch.traffic import make_mix
    return make_mix(CONT_MIX).build(n, rate, vocab, seed=seed)


def check_served(results, reqs, vocab):
    """Every request finished with exactly its max_new tokens, in vocab."""
    want = {r.request_id: r.max_new_tokens for r in reqs}
    assert sorted(r.request_id for r in results) == sorted(want), results
    for r in results:
        assert len(r.tokens) == want[r.request_id], (r.request_id, len(r.tokens))
        assert ((r.tokens >= 0) & (r.tokens < vocab)).all(), r.request_id


def tree_launches_per_round(target, draft, spec):
    """tree_attention launches of one round: the target's verify pass and,
    with a drafter model, its depth + 1 levels (draft heads attend in plain
    torch); none in a chain round."""
    from repro_torch.draftheads import is_head_drafter
    if spec is None:
        return 0
    n = target.cfg.num_layers
    if not is_head_drafter(draft):
        n += draft.cfg.num_layers * (spec.depth + 1)
    return n


def continuous_pass(models, sdc, spec, prefix, kv_quant, rate=CONT_RATE,
                    profile_dir=None, n=CONT_N, warm=True,
                    max_batch=CONT_ENGINE["max_batch"], **engine_kw):
    """One measured pass over the first ``n`` of the chat stream arriving at
    ``rate`` requests/s (0: all at t = 0, the engine's own throughput),
    launch counts set to 0 just before it and read just after. ``models``'
    drafter is a drafter model or a head drafter (whose engine must then
    hold no drafter pool). ``engine_kw`` (observability hooks) go to the
    measured pass's engine, which ``profile_dir`` wraps in
    ``obs.torch_profile``. ``warm`` runs a warm-up on two other requests
    first (a pass right after another on the same models skips it). With
    fewer ``max_batch`` slots than requests, some request must queue.
    Returns (summary, engine)."""
    from repro_torch.draftheads import is_head_drafter
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.obs import torch_profile
    target, t_params, draft, d_params, c = models
    V = target.cfg.vocab_size
    if warm:        # on two other requests, not counted
        serve.serve_continuous(target, t_params, draft, d_params,
                               chat_requests(2, 0.0, V, seed=1), sdc, spec,
                               prefix_cache=prefix, kv_quant=kv_quant,
                               **CONT_ENGINE)
    reqs = chat_requests(n, rate, V)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with torch_profile(profile_dir):
        engine, results = serve.serve_continuous(
            target, t_params, draft, d_params, reqs, sdc, spec,
            prefix_cache=prefix, kv_quant=kv_quant,
            **{**CONT_ENGINE, "max_batch": max_batch}, **engine_kw)
        torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    check_served(results, reqs, V)
    depth = spec.depth if spec is not None else sdc.gamma
    summary = serve.continuous_summary(engine, results, c, depth)
    R = engine.telemetry.decode_rounds
    per_round = tree_launches_per_round(target, draft, spec)
    if is_head_drafter(draft):
        assert "d_cache" not in engine._state and len(engine._caches()) == 1
    want = {k: 0 for k in launches}
    want["tree_attention"] = R * per_round
    assert R > 0 and launches == want, (launches, want)
    assert summary["tau"] >= 1.0 and math.isfinite(summary["tau"]), summary
    if prefix:
        assert summary["prefix"]["hits"] > 0, summary["prefix"]
    if n > max_batch:
        assert summary["max_queue"] >= 1, summary
    summary.update(arrival_rate=rate, max_batch=max_batch,
                   arrival_span_s=max(r.arrival_time_s for r in reqs),
                   launches=launches, tree_attention_per_round=per_round,
                   num_pages=engine.num_pages, view_slots=engine.pool.max_pages_per_seq
                   * engine.page_size,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return summary, engine


def profile_continuous(models, sdc, spec, rounds=4, **engine_kw):
    """Where a continuous decode round's time goes with all 8 slots in
    decode: 8 chat-mix requests (max_new raised to 96 so that no row
    retires in the window) admitted at t = 0 and prefilled, then ``rounds``
    engine steps (each one decode round) on the host clock, synchronised,
    and ``rounds`` more under torch.profiler. ``engine_kw``: observability
    hooks of the engine."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serving import ContinuousEngine
    target, t_params, draft, d_params, _ = models
    reqs = chat_requests(8, 0.0, target.cfg.vocab_size, seed=2)
    for r in reqs:
        r.max_new_tokens = 96
    engine = ContinuousEngine(target=target, target_params=t_params, sd=sdc,
                              tree=spec,
                              max_seq_len=max(len(r.prompt) + 96 for r in reqs),
                              **serve.drafter_kw(draft, d_params), **CONT_ENGINE,
                              **engine_kw)
    for r in reqs:
        engine.submit(r)
    while any(s.state != "decode" for s in engine._slots):
        engine.step()
    engine.step()
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    for _ in range(rounds):
        engine.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / rounds
    launches_per_round = ops.LAUNCHES["tree_attention"] / rounds
    with profile(activities=[ProfilerActivity.CUDA]) as prof:   # as profile_tree
        for _ in range(rounds):
            engine.step()
        torch.cuda.synchronize()
    assert all(s.state == "decode" for s in engine._slots)
    out = kernel_breakdown(prof, rounds, wall_ms)
    out.update(active_rows=8, tree_attention_launches_per_round=launches_per_round)
    return out


def phase16_continuous_serving(models, smi):
    """Continuous serving of the full-width pair at temperature 0.7: tree
    (2, 2) with the prefix cache, chain gamma 3 without it, and tree with
    int8 KV pools and the prefix cache, on Poisson arrivals; then tree and
    chain again with all 16 requests at t = 0, where tok/s is the engine's
    own rather than bounded by the arrival span. Latency p99 over 16
    requests is their maximum."""
    from repro_torch.core.speculative import SDConfig
    from repro_torch.spectree.tree import TreeSpec
    assert os.environ.get("PYTHONHASHSEED") == "0"   # the chat mix's preamble
    spec = TreeSpec((2, 2))
    t0 = time.perf_counter()
    out = {}
    # the passes at t = 0 follow the same path's pass: no warm-up of their own
    for name, sdc, tree, prefix, rate, warm in (
            ("tree", SDConfig(gamma=3, temperature=0.7), spec, True, CONT_RATE,
             True),
            ("chain", SDConfig(gamma=3, temperature=0.7), None, False,
             CONT_RATE, True),
            ("tree_int8kv", SDConfig(gamma=3, temperature=0.7, kv_quant=True),
             spec, True, CONT_RATE, True),
            ("tree_rate0", SDConfig(gamma=3, temperature=0.7), spec, True, 0.0,
             False),
            ("chain_rate0", SDConfig(gamma=3, temperature=0.7), None, False,
             0.0, False)):
        out[name], _ = continuous_pass(models, sdc, tree, prefix, sdc.kv_quant,
                                       rate, warm=warm)
    out["tree"]["where_the_time_goes"] = profile_continuous(
        models, SDConfig(gamma=3, temperature=0.7), spec)
    emit({"phase": 16, "mix": CONT_MIX, "requests": CONT_N,
          "arrival_rate": CONT_RATE, "engine": CONT_ENGINE, "temperature": 0.7,
          "p99_is_max_of": CONT_N,
          "arch": models[0].cfg.name, "drafter": models[2].cfg.name,
          "dtype": models[0].cfg.dtype, "passes": out,
          "wall_s": time.perf_counter() - t0, "nvidia_smi": smi})
    return out


def phase17_continuous_greedy_exactness():
    """Temperature 0 with 2 target layers in float32: the continuous
    engine (4 requests of different lengths through 2 slots) must give the
    static chain and tree generation's tokens, with fp KV, int8 KV, and
    int8 weights on both models; prefix cache on and off must agree."""
    from repro_torch.configs import QuantConfig, get_config
    from repro_torch.core.speculative import SDConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    from repro_torch.quant import quantize_params
    from repro_torch.serving import (ContinuousEngine, Request, ServeRequest,
                                     ServingEngine)
    from repro_torch.spectree.round import tree_speculative_generate
    from repro_torch.spectree.tree import TreeSpec
    cfg = get_config("llama2-7b-chat").replace(num_layers=2, dtype="float32")
    V = cfg.vocab_size
    rng = np.random.default_rng(17)
    lens, news = (40, 64, 50, 57), (16, 12, 20, 14)
    prompts = [rng.integers(3, V, L).astype(np.int64) for L in lens]
    spec = TreeSpec((2, 2))

    def continuous(target, tp, draft, dp, sdc, tree, reqs, **kw):
        engine = ContinuousEngine(
            target=target, target_params=tp, draft=draft, draft_params=dp,
            sd=sdc, tree=tree, max_batch=2, page_size=16, prefill_chunk=32,
            max_seq_len=max(len(r.prompt) + r.max_new_tokens for r in reqs),
            kv_quant=sdc.kv_quant, **kw)
        res = engine.serve(reqs)
        assert engine.telemetry.max_queue_depth >= 1    # staggered admission
        return {r.request_id: r.tokens for r in res}, engine

    out, launches = {}, {}
    for weights in ("fp", "int8"):
        target, draft = Model(cfg, "cuda"), Model(cfg.drafter(), "cuda")
        t_params, d_params = target.init(0), draft.init(1)
        if weights == "int8":
            calib = serve.calibration_tokens(target, t_params, 2, 32)
            qcfg = QuantConfig(weights="int8")
            t_params = quantize_params(target, t_params, qcfg, calib_tokens=calib)
            d_params = quantize_params(draft, d_params, qcfg, calib_tokens=calib)
        for kv in ((False, True) if weights == "fp" else (False,)):
            sdc = SDConfig(gamma=3, temperature=0.0, kv_quant=kv)
            static = {r.request_id: r.tokens for r in ServingEngine(
                target=target, target_params=t_params, draft=draft,
                draft_params=d_params, sd=sdc).serve(
                    [Request(prompt=p, max_new_tokens=m, request_id=i)
                     for i, (p, m) in enumerate(zip(prompts, news))])}
            static_tree = {}
            for i, (p, m) in enumerate(zip(prompts, news)):
                toks, _ = tree_speculative_generate(
                    draft, target, d_params, t_params,
                    torch.as_tensor(p[None], device=target.device), m, sdc, spec)
                static_tree[i] = toks[0, len(p):len(p) + m].cpu().numpy()
            ops.reset_launches()
            reqs = [ServeRequest(prompt=p, max_new_tokens=m, request_id=i)
                    for i, (p, m) in enumerate(zip(prompts, news))]
            chain, _ = continuous(target, t_params, draft, d_params, sdc, None, reqs)
            tree, _ = continuous(target, t_params, draft, d_params, sdc, spec, reqs)
            label = f"{weights}_weights_{'int8' if kv else 'fp'}_kv"
            launches[label] = dict(ops.LAUNCHES)
            ok = {name: all(np.array_equal(got[i], static[i]) for i in static)
                  for name, got in (("static_tree", static_tree),
                                    ("continuous_chain", chain),
                                    ("continuous_tree", tree))}
            if label == "fp_weights_fp_kv":
                # every observability hook on, fenced phases included: the
                # same tokens as with none, chain and tree
                with tempfile.TemporaryDirectory() as tmp:
                    for name, tspec_, plain in (("chain", None, chain),
                                                ("tree", spec, tree)):
                        hooked, _ = continuous(
                            target, t_params, draft, d_params, sdc, tspec_,
                            reqs, **obs_engine_kw(tmp, name, True))
                        ok[f"hooks_on_equals_off_{name}"] = all(
                            np.array_equal(hooked[i], plain[i]) for i in plain)
            out[label] = ok
            emit({"phase": 17, "config": label, "equals_static_chain": ok})
            assert all(ok.values()), (label, ok)
            assert launches[label]["tree_attention"] > 0, launches[label]
            if weights == "int8":
                assert launches[label]["quant_matmul_int8"] > 0, launches[label]
        if weights == "fp":
            # prefix cache on against off, chain and tree, chat-mix prompts
            reqs = chat_requests(6, 0.0, V)
            sdc = SDConfig(gamma=3, temperature=0.0)
            for tree_spec in (None, spec):
                runs = [continuous(target, t_params, draft, d_params, sdc,
                                   tree_spec, reqs, prefix_cache=on)
                        for on in (False, True)]
                hits = runs[1][1].prefix.tel.hits
                same = all(np.array_equal(runs[0][0][i], runs[1][0][i])
                           for i in runs[0][0])
                label = f"prefix_{'tree' if tree_spec else 'chain'}"
                out[label] = {"on_equals_off": same, "hits": hits,
                              "hit_tokens": runs[1][1].prefix.tel.hit_tokens}
                assert same and hits > 0, (label, out[label])
        del target, draft, t_params, d_params
        torch.cuda.empty_cache()
    emit({"phase": 17, "arch": cfg.name, "target_layers": 2, "dtype": "float32",
          "temperature": 0.0, "requests": len(prompts), "max_batch": 2,
          "results": out, "launches": launches})
    return launches


CONT_LINE = re.compile(r"^continuous: (\d+) requests, (\d+) tokens", re.M)
MAX_QUEUE_FIELD = re.compile(r"\bmax_queue=(\d+)")


OBS_REPORT_LINES = ("quality over", "accept-vs-entropy:", "tenant chat:",
                    "acceptance attribution over", "slo: ttft<1ms",
                    "flight recorder:", "phase time over",
                    "phase device span (CUDA events):",
                    "roofline-vs-measured over", "MBU", "metrics:", "trace:",
                    "torch.profiler trace:")


def obs_cli_flags(d):
    """Every observability flag of the serving CLI, its files under d."""
    return ["--trace-out", str(d / "trace.json"),
            "--metrics-out", str(d / "metrics.jsonl"), "--time-phases",
            "--peak-gbps", str(HBM_BYTES_PER_S / 1e9), "--quality-telemetry",
            "--flight-record", str(d / "flight"),
            "--slo-ttft-ms", str(OBS_SLO["ttft_ms"]),
            "--slo-tpot-ms", str(OBS_SLO["tpot_ms"]),
            "--torch-profile", str(d / "torch_profile")]


def check_obs_cli(d, stdout):
    """The files an every-flag CLI run wrote, and its report lines."""
    from repro_torch.obs.phases import TRACE_FILE
    missing = [line for line in OBS_REPORT_LINES if line not in stdout]
    assert not missing, missing
    names = {e["name"] for e in
             json.loads((d / "trace.json").read_text())["traceEvents"]}
    assert OBS_SPANS <= names, OBS_SPANS - names
    snaps = [json.loads(ln) for ln in
             (d / "metrics.jsonl").read_text().splitlines()]
    assert snaps[-1]["metrics"]["serve_completed_total"] == SHORT_N
    prom = (d / "metrics.jsonl.prom").read_text()
    assert "sd_pooled_tokens_total" in prom and "quality_rounds_total" in prom
    bundles = sorted((d / "flight").glob("flight_*_slo_breach.json"))
    assert bundles and json.loads(bundles[0].read_text())["reason"] == "slo_breach"
    prof = d / "torch_profile" / TRACE_FILE
    assert prof.stat().st_size > 0
    return {"trace_spans": sorted(names), "jsonl_snapshots": len(snaps),
            "slo_breach_bundles": len(bundles),
            "torch_trace_mb": prof.stat().st_size / 1e6,
            "report": [ln for ln in stdout.splitlines()
                       if any(k in ln for k in OBS_REPORT_LINES)]}


CONT_CLI_BASE = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                 "llama2-7b-chat", "--continuous", "--traffic-mix", CONT_MIX,
                 "--requests", str(SHORT_N), "--arrival-rate", str(CONT_RATE),
                 "--max-batch", str(SHORT_BATCH), "--temperature", "0.7"]
# (name, flags, kernels it must launch, GB of the card for a CliPool)
CONT_CLI_VARIANTS = (("tree_int8", ["--tree", "--prefix-cache", "--quant-weights",
                                    "int8", "--quant-target", "--quant-kv"],
                      {"tree_attention", "quant_matmul_int8"}, 38),
                     ("chain_bf16", [], set(), 18))


def continuous_cli_jobs(d):
    """Phase 18's CLI runs for a ``CliPool``, the first's files under d."""
    return {f"18-{name}": (CONT_CLI_BASE + extra
                           + (obs_cli_flags(d) if name == "tree_int8" else []),
                           gb, None)
            for name, extra, _, gb in CONT_CLI_VARIANTS}


def phase18_continuous_cli(smi, pool, tmp):
    """The full-width pair through the serving CLI's --continuous branch in
    subprocesses (``continuous_cli_jobs``, files under the directory
    ``tmp``), on the chat mix (8 requests at 4/s through 4 slots,
    temperature 0.7):
    tree with the prefix cache, int8 weights on both models and int8 KV
    pools, with every observability flag; then chain in bf16. Each must
    exit 0 having served 8 requests, some of them queued, with its printed
    kernel launches:
    tree attention (44 a round) and the int8 matmul for the first, no
    kernel for the chain; the first's files and reports are checked."""
    d = Path(tmp.name)
    runs = {}
    done = pool.wait(list(continuous_cli_jobs(d)))
    for name, _, used, _ in CONT_CLI_VARIANTS:
        proc, s = done[f"18-{name}"]
        found = LAUNCH_LINE.search(proc.stdout)
        served, rounds = CONT_LINE.search(proc.stdout), ROUNDS_FIELD.search(
            proc.stdout)
        queued = MAX_QUEUE_FIELD.search(proc.stdout)
        run = runs[name] = {
            "cmd": " ".join(proc.args[1:]), "rc": proc.returncode,
            "s": s,
            "launches": json.loads(found[1]) if found else None,
            "requests": int(served[1]) if served else None,
            "rounds": int(rounds[1]) if rounds else None,
            "max_queue": int(queued[1]) if queued else None,
            "stdout": proc.stdout.strip().splitlines()[-10:],
            "stderr": proc.stderr.strip().splitlines()[-3:]}
        ok = (proc.returncode == 0 and run["launches"] is not None
              and run["requests"] == SHORT_N
              and (run["max_queue"] or 0) >= 1
              and all((n > 0) == (k in used)
                      for k, n in run["launches"].items()))
        if ok and "tree_attention" in used:
            ok = run["rounds"] is not None and (
                run["launches"]["tree_attention"] == 44 * run["rounds"])
        if ok and name == "tree_int8":
            try:
                run["observability"] = check_obs_cli(d, proc.stdout)
            except (AssertionError, OSError, ValueError, KeyError) as e:
                run["observability"] = f"{type(e).__name__}: {e}"
                ok = False
        if not ok:
            emit({"phase": 18, "runs": runs, "nvidia_smi": smi})
            raise AssertionError(f"continuous CLI run {name} failed: {run}")
    tmp.cleanup()
    emit({"phase": 18, "runs": runs, "nvidia_smi": smi})


# ------------------------------------------------ draft heads (19-21)

HEAD_KINDS = ("eagle", "medusa")
HEAD_PARAMS_M = {"eagle": 302.0, "medusa": 67.1}   # at Llama-2-7B's widths


def head_drafters(target, dtype):
    """EAGLE (32 heads, d_ff 16384) and Medusa (K 4) heads for ``target``,
    drawn from seeds 1 and 2 with their matmul weights in ``dtype``."""
    from repro_torch.draftheads import HeadConfig, HeadDrafter
    out = {}
    for seed, kind in enumerate(HEAD_KINDS, start=1):
        drafter = HeadDrafter(HeadConfig.for_target(kind, target.cfg))
        assert round(drafter.hc.param_count() / 1e6, 1) == HEAD_PARAMS_M[kind]
        out[kind] = (drafter, drafter.init(seed, target.device, dtype))
    return out


def head_draft_ms(target, t_params, drafter, hp, sdc, spec, B=4):
    """One head draft as a round runs it, eager (host launches included),
    timed with CUDA events at B 4 from a random feature: a chain of gamma
    tokens and a tree expansion, and their time per step and per level."""
    from repro_torch.draftheads import head_draft_chain, head_draft_tree
    dev, cfg = target.device, target.cfg
    gen = torch.Generator(device=dev).manual_seed(3)
    h = torch.randn((B, cfg.d_model), generator=gen, device=dev,
                    dtype=cfg.compute_dtype)
    pending = torch.randint(3, cfg.vocab_size, (B,), generator=gen, device=dev)
    chain = cuda_ms(lambda: head_draft_chain(drafter, hp, t_params, cfg, sdc, h,
                                             pending, gen), iters=20)
    tree = cuda_ms(lambda: head_draft_tree(drafter, hp, t_params, cfg, sdc,
                                           spec, h, pending, gen), iters=20)
    return {"chain_ms": chain, "chain_ms_per_token": chain / sdc.gamma,
            "tree_ms": tree, "tree_ms_per_level": tree / (spec.depth + 1)}


def phase19_head_serving(models, smi):
    """Static tree and chain serving with EAGLE and Medusa heads on phase
    3's target, then the continuous engine by tree with EAGLE heads on
    phase 16's stream. Returns the tree passes' tree_attention launches."""
    from repro_torch.core.metrics import mbsu
    from repro_torch.core.speculative import SDConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.spectree.tree import TreeSpec
    target, t_params = models[:2]
    V = target.cfg.vocab_size
    spec, sdc = TreeSpec((2, 2)), SDConfig(gamma=3, temperature=0.7)
    prompts = serve.make_prompts(4, 128, V)
    n_target = serve.count_params(t_params)
    t0 = time.perf_counter()
    heads = head_drafters(target, target.cfg.compute_dtype)
    out, tree_launches = {}, {}
    for kind, (drafter, hp) in heads.items():
        c = drafter.hc.param_count() / n_target
        per_round = tree_launches_per_round(target, drafter, spec)
        assert per_round == target.cfg.num_layers, per_round    # 32 at 7B
        res = out[kind] = {"param_count": drafter.hc.param_count(), "c": c}
        # tree (2, 2); warm-up on 8 new tokens, not counted
        serve.serve_tree(target, t_params, drafter, hp, prompts, 8, sdc, spec,
                         seed=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        toks, stats = serve.serve_tree(target, t_params, drafter, hp, prompts,
                                       64, sdc, spec)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        want = {k: 0 for k in launches}
        want["tree_attention"] = stats.rounds * per_round
        assert stats.rounds > 0 and launches == want, (kind, launches, want)
        new = toks[:, 128:128 + 64]
        assert bool(((new >= 0) & (new < V)).all()), "token out of vocab"
        assert stats.tau >= 1.0 and math.isfinite(stats.tau), stats.tau
        tree_launches[f"static_tree_{kind}"] = launches["tree_attention"]
        res["tree"] = {
            "rounds": stats.rounds, "launches": launches,
            "launches_per_round": per_round, "tau": stats.tau,
            "mbsu": mbsu(stats.tau, c, spec.depth),
            "tok_s": stats.tokens_per_s(), "wall_s": stats.wall_time_s,
            "depth_acceptance": stats.depth_acceptance(),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "where_the_time_goes": profile_tree(
                (target, t_params, drafter, hp, c), prompts, sdc, spec,
                stats.wall_time_s * 1e3 / stats.rounds)}
        # chain gamma 3 through the static engine
        serve.serve_static(target, t_params, drafter, hp, prompts, 8, sdc, seed=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        results, tau, tok_s = serve.serve_static(target, t_params, drafter, hp,
                                                 prompts, 64, sdc)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        assert all(n == 0 for n in launches.values()), (kind, launches)
        check_served(results, [serve.Request(prompt=p, max_new_tokens=64,
                                             request_id=i)
                               for i, p in enumerate(prompts)], V)
        assert tau >= 1.0 and math.isfinite(tau), tau
        res["chain"] = {"gamma": 3, "tau": tau, "mbsu": mbsu(tau, c, 3),
                        "tok_s": tok_s, "launches": launches,
                        "rounds": results[0].rounds,
                        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                        "note": "tok/s over the batch's wall time, prefill "
                                "included"}
        res["draft_eager"] = head_draft_ms(target, t_params, drafter, hp, sdc,
                                           spec)
    eagle, ehp = heads["eagle"]
    hmodels = (target, t_params, eagle, ehp, out["eagle"]["c"])
    cont, _ = continuous_pass(hmodels, sdc, spec, prefix=True, kv_quant=False,
                              n=SHORT_N, max_batch=SHORT_BATCH)
    tree_launches["continuous_tree_eagle"] = cont["launches"]["tree_attention"]
    cont["where_the_time_goes"] = profile_continuous(hmodels, sdc, spec)
    out["continuous_eagle_tree"] = cont
    emit({"phase": 19, "arch": target.cfg.name, "dtype": target.cfg.dtype,
          "drafter": "draft heads (no drafter model)", "requests": 4,
          "prompt_len": 128, "max_new": 64, "tree": spec.branching,
          "temperature": 0.7, "mix": CONT_MIX, "engine": CONT_ENGINE,
          "results": out, "tree_attention_launches": tree_launches,
          "wall_s": time.perf_counter() - t0, "nvidia_smi": smi})
    return sum(tree_launches.values())


def phase20_head_greedy_exactness():
    """Temperature 0 with 2 float32 target layers: EAGLE and Medusa heads,
    chain and tree, static and through the continuous engine (4 requests of
    different lengths through 2 slots), must give the target's greedy
    tokens."""
    from repro_torch.configs import get_config
    from repro_torch.core.speculative import (SDConfig, autoregressive_generate,
                                              speculative_generate)
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    from repro_torch.serving import ContinuousEngine, ServeRequest
    from repro_torch.spectree.round import tree_speculative_generate
    from repro_torch.spectree.tree import TreeSpec
    cfg = get_config("llama2-7b-chat").replace(num_layers=2, dtype="float32")
    target = Model(cfg, "cuda")
    t_params = target.init(0)
    dev, V = target.device, cfg.vocab_size
    P, M = 64, 32
    prompt = torch.as_tensor(serve.make_prompts(2, P, V, seed=5), device=dev)
    sdc, spec = SDConfig(gamma=3, temperature=0.0), TreeSpec((2, 2))
    ar, _ = autoregressive_generate(target, t_params, prompt, M, temperature=0.0)
    rng = np.random.default_rng(20)
    lens, news = (40, 64, 50, 57), (16, 12, 20, 14)
    prompts = [rng.integers(3, V, n).astype(np.int64) for n in lens]
    ar_req = [autoregressive_generate(target, t_params,
                                      torch.as_tensor(p[None], device=dev), m,
                                      temperature=0.0)[0][0, len(p):].cpu().numpy()
              for p, m in zip(prompts, news)]
    out = {}
    for kind, (drafter, hp) in head_drafters(target, torch.float32).items():
        chain, cstats = speculative_generate(drafter, target, hp, t_params,
                                             prompt, M, sdc)
        ops.reset_launches()
        tree, tstats = tree_speculative_generate(drafter, target, hp, t_params,
                                                 prompt, M, sdc, spec)
        launches = ops.LAUNCHES["tree_attention"]
        res = out[kind] = {
            "static_chain": torch.equal(chain[:, :P + M], ar),
            "static_tree": torch.equal(tree[:, :P + M], ar),
            "chain_tau": cstats.tau, "tree_tau": tstats.tau,
            "tree_launches": launches, "tree_rounds": tstats.rounds}
        assert launches == tstats.rounds * cfg.num_layers, res
        for name, tree_spec in (("continuous_chain", None),
                                ("continuous_tree", spec)):
            engine = ContinuousEngine(
                target=target, target_params=t_params, draft_heads=drafter,
                draft_head_params=hp, sd=sdc, tree=tree_spec, max_batch=2,
                page_size=16, prefill_chunk=32,
                max_seq_len=max(n + m for n, m in zip(lens, news)))
            assert "d_cache" not in engine._state
            got = engine.serve([ServeRequest(prompt=p, max_new_tokens=m,
                                             request_id=i)
                                for i, (p, m) in enumerate(zip(prompts, news))])
            assert engine.telemetry.max_queue_depth >= 1   # staggered admission
            res[name] = all(np.array_equal(r.tokens, ar_req[r.request_id])
                            for r in got) and len(got) == len(prompts)
        emit({"phase": 20, "heads": kind, "equals_greedy": res})
        assert all(v for k, v in res.items() if k.startswith(("static", "cont"))), \
            (kind, res)
    emit({"phase": 20, "arch": cfg.name, "target_layers": 2, "dtype": "float32",
          "temperature": 0.0, "results": out})


HEAD_TRAIN_B, HEAD_TRAIN_S, HEAD_TRAIN_STEPS = 4, 1024, 2


def phase21_head_training(smi):
    """Head distillation at full width against the frozen bf16 target on
    its own datagen responses, and a head checkpoint round trip served by
    tree (the head flags of the CLIs: ``head_cli_jobs``)."""
    import itertools
    from repro_torch.checkpoint.io import load_draft_heads, save_draft_heads
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.datagen import DatagenConfig, generate_distillation_dataset
    from repro_torch.core.speculative import SDConfig
    from repro_torch.data import pack_documents
    from repro_torch.draftheads import (HeadConfig, HeadDrafter, finetune_heads,
                                        make_head_train_state)
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    from repro_torch.spectree.tree import TreeSpec
    B, S, steps = HEAD_TRAIN_B, HEAD_TRAIN_S, HEAD_TRAIN_STEPS
    cfg = get_config("llama2-7b-chat")
    target = Model(cfg, "cuda")
    t_params = target.init(0)                            # bf16, frozen
    V = cfg.vocab_size
    t0 = time.perf_counter()
    seeds = serve.make_prompts(16, 128, V, seed=7)
    data = generate_distillation_dataset(
        target, t_params, seeds,
        DatagenConfig(temperatures=(0.0, 0.7), max_response_tokens=64),
        gen=torch.Generator(device=target.device).manual_seed(0))
    datagen_s = time.perf_counter() - t0
    batch = pack_documents(data, S)[:B]
    assert batch.shape == (B, S) and ((batch >= 0) & (batch < V)).all()
    tc = TrainConfig(warmup_steps=1, total_steps=100)
    t_sum = param_checksum(t_params)
    runs, trained = {}, {}
    for kind in HEAD_KINDS:
        drafter = HeadDrafter(HeadConfig.for_target(kind, cfg))
        state = make_head_train_state(drafter, 1, target.device)
        before = param_checksum(state["params"])
        marks = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t1 = time.perf_counter()
        state, hist = finetune_heads(drafter, target, state, t_params,
                                     itertools.repeat(batch), tc, steps,
                                     "tvdpp", log_every=1,
                                     callback=lambda i, m: marks.append(
                                         time.perf_counter()))
        torch.cuda.synchronize()
        step_ms = [1e3 * (b - a) for a, b in zip([t1] + marks[:-1], marks)]
        runs[kind] = {"steps": steps, "batch": [B, S], "loss_kind": "tvdpp",
                      "param_count": drafter.hc.param_count(),
                      "step_ms": step_ms,
                      "ms_per_step": sum(step_ms[1:]) / len(step_ms[1:]),
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "launches": dict(ops.LAUNCHES),
                      **{k: [h[k] for h in hist]
                         for k in ("loss", "distill_loss", "feat_l2", "grad_norm")}}
        assert all(math.isfinite(h[k]) for h in hist
                   for k in ("loss", "distill_loss", "feat_l2")), hist
        assert all(p.dtype == torch.float32 for p in _leaves(state["params"]))
        assert param_checksum(state["params"]) != before, f"{kind} did not move"
        trained[kind] = (drafter, state["params"])
        del state
        torch.cuda.empty_cache()
    assert param_checksum(t_params) == t_sum, "target parameters changed"

    # checkpoint round trip, served by tree with the loaded (bf16) heads
    drafter, params = trained["eagle"]
    ckpt = ROOT / "build" / "heads_phase21.npz"
    save_draft_heads(str(ckpt), drafter, params)
    loaded = load_draft_heads(str(ckpt), drafter, target.device, cfg.compute_dtype)
    assert all(torch.equal(a.to(b.dtype), b)
               for a, b in zip(_leaves(params), _leaves(loaded)))
    spec, sdc = TreeSpec((2, 2)), SDConfig(temperature=0.7)
    ops.reset_launches()
    toks, stats = serve.serve_tree(target, t_params, drafter, loaded,
                                   serve.make_prompts(4, 128, V), 16, sdc, spec)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["tree_attention"] == stats.rounds * cfg.num_layers
    served = {"rounds": stats.rounds, "tau": stats.tau,
              "tree_attention": ops.LAUNCHES["tree_attention"]}
    del target, t_params, trained, params, loaded
    torch.cuda.empty_cache()
    emit({"phase": 21, "arch": cfg.name, "target_dtype": cfg.dtype,
          "head_param_dtype": "float32",
          "datagen": {"seeds": 16, "prompt_len": 128, "max_new": 64,
                      "temperatures": [0.0, 0.7], "rows": int(data.shape[0]),
                      "s": datagen_s},
          "training": runs, "checkpoint_tree_pass": served, "nvidia_smi": smi})


def _leaves(tree):
    from repro_torch.optim import tree_leaves
    return tree_leaves(tree)


ROUNDS_FIELD = re.compile(r"\brounds=(\d+)")


def head_cli_jobs():
    """Phase 21's CLI runs for a ``CliPool``, with the target layers a
    round of each serving run (None for the training): the training CLI
    distills EAGLE heads of the reduced config and saves them; the serving
    CLI serves that checkpoint by tree; the continuous serving CLI serves
    the chat mix at full width by tree with EAGLE heads."""
    ckpt = str(ROOT / "build" / "heads_cli.npz")
    mod = [sys.executable, "-m"]
    return {
        "21-train": (mod + ["repro_torch.launch.train", "--arch",
                            "llama2-7b-chat", "--reduced", "--draft-head",
                            "eagle", "--steps", "10", "--save", ckpt],
                     2, None, None),
        "21-serve_tree": (mod + ["repro_torch.launch.serve", "--arch",
                                 "llama2-7b-chat", "--reduced", "--draft-head",
                                 "eagle", "--head-ckpt", ckpt, "--tree",
                                 "--temperature", "0.7"], 2, "21-train", 2),
        "21-serve_continuous_tree": (
            mod + ["repro_torch.launch.serve", "--arch", "llama2-7b-chat",
                   "--continuous", "--tree", "--draft-head", "eagle",
                   "--traffic-mix", CONT_MIX, "--requests", str(SHORT_N),
                   "--arrival-rate", str(CONT_RATE), "--max-batch",
                   str(SHORT_BATCH), "--temperature", "0.7"], 18, None, 32),
    }


def check_head_clis(smi, done):
    """Phase 21's CLI runs (``head_cli_jobs``), {name: (``CompletedProcess``,
    seconds)} from their pools: each must exit 0; tree_attention launches
    are checked against the target's layers (per round where the CLI
    prints its rounds), and no other kernel may launch."""
    out = {}
    for name, (cmd, _, _, layers) in head_cli_jobs().items():
        proc, s = done[name]
        name = name[3:]
        found = LAUNCH_LINE.search(proc.stdout)
        rounds = ROUNDS_FIELD.search(proc.stdout)
        run = out[name] = {
            "cmd": " ".join(cmd[2:]), "rc": proc.returncode,
            "s": s,
            "launches": json.loads(found[1]) if found else None,
            "rounds": int(rounds[1]) if rounds else None,
            "loss": [float(x) for _, x in STEP_LOSS.findall(proc.stdout)],
            "stdout": proc.stdout.strip().splitlines()[-8:],
            "stderr": proc.stderr.strip().splitlines()[-3:]}
        if layers is None:
            ok = (proc.returncode == 0 and len(run["loss"]) == 5
                  and all(math.isfinite(x) for x in run["loss"])
                  and "saved eagle head params" in proc.stdout)
        else:
            la = run["launches"] or {}
            n = la.get("tree_attention", 0)
            ok = (proc.returncode == 0 and n > 0 and n % layers == 0
                  and all(v == 0 for k, v in la.items() if k != "tree_attention")
                  and (run["rounds"] is None or n == layers * run["rounds"]))
            if name == "serve_continuous_tree":
                served = CONT_LINE.search(proc.stdout)
                queued = MAX_QUEUE_FIELD.search(proc.stdout)
                ok = ok and run["rounds"] is not None and served is not None \
                    and int(served[1]) == SHORT_N \
                    and queued is not None and int(queued[1]) >= 1
        if not ok:
            emit({"phase": 21, "cli": out})
            raise AssertionError(f"head CLI run {name} failed: {run}")
    emit({"phase": 21, "cli": out, "nvidia_smi": smi})


# ------------------------------------------------ observability (22)

OBS_SLO = dict(ttft_ms=1.0, tpot_ms=1000.0)   # TTFT must breach, TPOT not
OBS_SPANS = {"request", "admit", "first_token", "decode_round", "draft",
             "verify", "commit", "queue_depth"}


def obs_engine_kw(tmp, label, phases):
    """Every observability hook of ``ContinuousEngine``, fences
    (``time_phases``) only with ``phases``; its files under tmp/label."""
    from repro_torch.obs import MetricsRegistry, SLOConfig, Tracer
    d = Path(tmp) / label
    d.mkdir(parents=True, exist_ok=True)
    return dict(tracer=Tracer(), registry=MetricsRegistry(),
                metrics_out=str(d / "metrics.jsonl"), quality=True,
                flight_record=True, flight_dir=str(d / "flight"),
                slo=SLOConfig(**OBS_SLO), time_phases=phases)


def check_obs_files(engine, out_dir, spans):
    """An instrumented engine's outputs after a run: the trace parses, holds
    ``spans`` and rebuilds every request's TTFT within 1 ms; the registry
    counts every committed token; the JSONL snapshots and the Prometheus
    text parse; an slo_breach bundle exists and parses. Returns sizes and
    counts for the phase's line."""
    out_dir = Path(out_dir)
    trace_path = out_dir / "trace.json"
    engine.tracer.write(str(trace_path))
    events = json.loads(trace_path.read_text())["traceEvents"]
    names = {e["name"] for e in events}
    assert spans <= names, spans - names
    begin = {e["id"]: e["ts"] for e in events if e["ph"] == "b"}
    first = {e["id"]: e["ts"] for e in events
             if e["ph"] == "n" and e["name"] == "first_token"}
    assert set(begin) == set(first) == set(engine.stats), (begin, first)
    ttft_err = max(abs((first[r] - begin[r]) / 1e6 - s.ttft_s)
                   for r, s in engine.stats.items())
    assert ttft_err < 1e-3, ttft_err
    reg = engine.registry
    committed = sum(s.sd.total_tokens for s in engine.stats.values())
    blocks = sum(s.sd.num_blocks for s in engine.stats.values())
    assert reg.counter("sd_tokens_total").value == committed, committed
    assert reg.counter("sd_blocks_total").value == blocks, blocks
    assert reg.histogram("sd_accepted_per_round").count == blocks
    snaps = [json.loads(ln) for ln in
             Path(engine.metrics_out).read_text().splitlines()]
    assert snaps and snaps[-1]["metrics"]["serve_completed_total"] == SHORT_N
    prom = reg.to_prometheus()
    (out_dir / "metrics.prom").write_text(prom)
    for line in prom.splitlines():
        if not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            float(value)
            assert re.fullmatch(r'[a-zA-Z_:][a-zA-Z0-9_:]*(\{le="[^"]+"\})?',
                                name), line
    bundles = sorted(Path(engine.flight_dir).glob("flight_*_slo_breach.json"))
    assert bundles, "no slo_breach bundle"
    bundle = json.loads(bundles[0].read_text())
    assert bundle["reason"] == "slo_breach" and "ttft" in bundle["context"]["metrics"]
    return {"trace_events": len(events), "ttft_max_err_ms": ttft_err * 1e3,
            "sd_tokens_total": committed,
            "tokens_streamed": sum(s.new_tokens for s in engine.stats.values()),
            "jsonl_snapshots": len(snaps), "prom_lines": len(prom.splitlines()),
            "slo_breach_bundles": len(bundles),
            "flight_bundles": len(engine.recorder.dumped_paths),
            "slo": engine.slo_tracker.snapshot()}


def phase_busy_ms(trace_path):
    """Device busy ms inside each fenced phase of a torch.profiler trace:
    the kernels, copies and fills that start and end within the phase's
    ``phase_<name>`` CPU range (each phase waits for its device work before
    the range closes), and the trace's device-to-host copies."""
    doc = json.loads(Path(trace_path).read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    ranges = [(e["name"][len("phase_"):], e["ts"], e["ts"] + e["dur"])
              for e in events if e.get("cat") == "user_annotation"
              and e.get("name", "").startswith("phase_")]
    device = sorted((e["ts"], e["ts"] + e.get("dur", 0.0)) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    starts = [s for s, _ in device]
    busy = {}
    for name, lo, hi in ranges:
        i = bisect.bisect_left(starts, lo)
        us = 0.0
        while i < len(device) and device[i][0] <= hi:
            if device[i][1] <= hi:
                us += device[i][1] - device[i][0]
            i += 1
        busy[name] = busy.get(name, 0.0) + us / 1e3
    dtoh = sum(1 for e in events if e.get("cat") == "gpu_memcpy"
               and "DtoH" in e.get("name", ""))
    return busy, dtoh, len(events)


def phase22_observability(models, smi):
    """The continuous engine's observability at full width on the first 8
    requests of phase 16's stream (tree (2, 2), prefix cache, temperature
    0.7) in three passes: (a) every hook off; (b) tracer, registry with
    JSONL snapshots, quality telemetry, flight recorder and an SLO of TTFT
    1 ms that must breach; (c) (b) with the fenced phases, inside
    torch_profile. Each pass must finish all 8 requests with 44
    tree_attention launches a round; (b)'s engine must make one
    device-to-host copy per decode round (profiled windows of 8 decode
    rows); the trace, metrics, bundles and phase split are checked; the
    hook cost is (a) against (b) in this call (the passes, a then b, and
    one window each, b then a, so that a drift of the host's speed over
    the phase moves the two comparisons in opposite directions)."""
    from repro_torch.core.speculative import SDConfig
    from repro_torch.obs import (acceptance_report, attribution_report,
                                 format_acceptance_report, format_attribution)
    from repro_torch.obs.phases import TRACE_FILE
    from repro_torch.spectree.tree import TreeSpec
    assert os.environ.get("PYTHONHASHSEED") == "0"   # the chat mix's preamble
    target, draft = models[0], models[2]
    spec, sdc = TreeSpec((2, 2)), SDConfig(gamma=3, temperature=0.7)
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        out["a_hooks_off"], _ = continuous_pass(models, sdc, spec, True, False,
                                                n=SHORT_N, warm=False)
        out["b_hooks_on"], eng_b = continuous_pass(
            models, sdc, spec, True, False, n=SHORT_N, warm=False,
            **obs_engine_kw(tmp, "b", False))
        out["b_hooks_on"]["files"] = check_obs_files(
            eng_b, tmp / "b", OBS_SPANS - {"draft", "verify", "commit"})
        prof_dir = tmp / "c" / "torch_profile"
        out["c_phased_profiled"], eng_c = continuous_pass(
            models, sdc, spec, True, False, profile_dir=str(prof_dir), n=SHORT_N,
            warm=False,
            **obs_engine_kw(tmp, "c", True))
        out["c_phased_profiled"]["files"] = check_obs_files(eng_c, tmp / "c",
                                                            OBS_SPANS)
        prof_trace = prof_dir / TRACE_FILE
        assert prof_trace.stat().st_size > 0, prof_trace
        busy, dtoh_c, n_events = phase_busy_ms(prof_trace)
        # the cost of the hooks on a round at 8 active rows: (a) and (b) in
        # this call, b then a (the passes ran a then b), each window its
        # own engine
        windows = {"b_hooks_on": [], "a_hooks_off": []}
        for i, name in enumerate(windows):
            kw = obs_engine_kw(tmp, f"w{i}", False) if name[0] == "b" else {}
            windows[name].append(profile_continuous(models, sdc, spec, **kw))
        assert all(w["dtoh_copies_per_round"] == 1.0
                   for w in windows["b_hooks_on"]), windows
        timer = eng_c.phases
        bd = timer.breakdown()
        assert timer.total_s > 0 and {"draft", "verify", "commit", "prefill"} <= set(bd)
        assert abs(sum(bd.values()) - timer.total_s) <= 1e-6 * timer.total_s, bd
        rounds = eng_c.telemetry.decode_rounds
        assert timer.counts["verify"] == rounds
        assert set(eng_c.phase_device_ms) == {"draft", "verify", "commit", "prefill"}
        att = attribution_report(
            timer, target.cfg, draft.cfg,
            batch=max(int(round(eng_c.telemetry.mean_active_rows)), 1),
            ctx=eng_c.max_seq_len // 2, gamma=spec.depth, weights="bfloat16",
            kv="bfloat16", peak_gbps=HBM_BYTES_PER_S / 1e9)
        q = eng_b.quality_stats
        assert q.rounds == eng_b.telemetry.decode_rounds and q.attempted.sum() > 0
        n_phase = {k: timer.counts.get(k, 0) for k in bd if k != "host"}
        out["c_phased_profiled"]["phases"] = {
            "steps": timer.steps, "total_s": timer.total_s,
            "breakdown_s": bd, "fractions": timer.fractions(),
            "counts": n_phase,
            "wall_ms_per_call": {k: bd[k] * 1e3 / n for k, n in n_phase.items() if n},
            "device_span_ms_per_call": {
                k: v / n_phase[k] for k, v in eng_c.phase_device_ms.items()},
            "device_busy_ms_per_call": {
                k: v / n_phase[k] for k, v in busy.items() if n_phase.get(k)},
            "summary": timer.summary(),
            "attribution": att, "attribution_text": format_attribution(att)}
        out["c_phased_profiled"]["torch_profile"] = {
            "trace_mb": prof_trace.stat().st_size / 1e6, "events": n_events,
            "dtoh_copies": dtoh_c,
            "dtoh_per_round_and_first_token": dtoh_c / (rounds + SHORT_N)}
        out["quality"] = {
            "summary": q.summary(), "snapshot": q.snapshot(),
            "accept_vs_entropy": q.acceptance_entropy_curve(),
            "tenants": {k: v.snapshot() for k, v in eng_b.tenant_quality.items()},
            "acceptance_report": format_acceptance_report(
                acceptance_report(q, spec.depth))}
    out["windows"] = windows
    out["hook_cost"] = {   # (a), (b); the windows in the order run
        "tok_s": [out[k]["tok_s"] for k in ("a_hooks_off", "b_hooks_on")],
        "tau": [out[k]["tau"] for k in ("a_hooks_off", "b_hooks_on")],
        "host_ms_per_round": {k: [w["wall_ms_per_round_unprofiled"] for w in v]
                              for k, v in windows.items()},
        "device_ms_per_round": {k: [w.get("device_ms_per_round") for w in v]
                                for k, v in windows.items()},
        "dtoh_copies_per_round": {k: [w["dtoh_copies_per_round"] for w in v]
                                  for k, v in windows.items()}}
    emit({"phase": 22, "mix": CONT_MIX, "requests": SHORT_N,
          "arrival_rate": CONT_RATE, "engine": CONT_ENGINE, "temperature": 0.7,
          "tree": spec.branching, "slo": OBS_SLO, "passes": out,
          "wall_s": time.perf_counter() - t0, "nvidia_smi": smi})
    return out


# ------------------------------------------------ the architecture registry (23)

# new tokens a row of 23a's, 24a's and 25a's tree and chain runs: cut from
# 64 to pay for phase 26 (PERF.md)
ARCH_NEW = 32
ARCH_CLI_RUNS = (   # (arch, note printed) served by tree through the CLI
    ("yi-9b", False), ("musicgen-large", True))
GREEDY_ARCHS = ("phi4-mini-3.8b", "minitron-4b", "chameleon-34b")
GEMMA = "gemma2-9b"
NOTE = "note: serving single-codebook variant of musicgen-large"


# GB of the card a serving CLI run at full width may take (its models, its
# caches and the allocator's slack), for a CliPool
CLI_GB = {"yi-9b": 21, "musicgen-large": 9, "gemma2-9b": 27,
          "granite-moe-3b-a800m": 9, "zamba2-7b": 19}


def arch_cli_jobs(runs=ARCH_CLI_RUNS, phase="23e"):
    """The serving CLI by tree at full width for each (arch, note) of
    ``runs``, as jobs of a ``CliPool``."""
    return {f"{phase}-{arch}": (
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--tree", "--temperature", "0.7", "--requests", "4"],
        CLI_GB[arch], None) for arch, _ in runs}


def check_arch_clis(smi, pool, runs=ARCH_CLI_RUNS, phase="23e"):
    """The serving CLI by tree at full width in subprocesses
    (``arch_cli_jobs``; 4 requests, 16 + 32 tokens, temperature 0.7), for
    each (arch, note printed) of ``runs``: Yi-9B, and MusicGen-large,
    which must print the reference's single-codebook note. Each must exit
    0 with tree_attention launched (target + drafter layers * 3) times a
    round of its printed rounds, and no other kernel."""
    from repro_torch.configs import get_config
    out = {}
    done = pool.wait(list(arch_cli_jobs(runs, phase)))
    for arch, note in runs:
        cfg = get_config(arch)
        per_round = cfg.num_layers + cfg.drafter().num_layers * 3
        proc, s = done[f"{phase}-{arch}"]
        cmd = proc.args
        found = LAUNCH_LINE.search(proc.stdout)
        rounds = ROUNDS_FIELD.search(proc.stdout)
        run = out[arch] = {
            "cmd": " ".join(cmd[2:]), "rc": proc.returncode,
            "s": s,
            "launches": json.loads(found[1]) if found else None,
            "rounds": int(rounds[1]) if rounds else None,
            "launches_per_round": per_round, "note_printed": NOTE in proc.stdout,
            "stdout": proc.stdout.strip().splitlines()[-6:],
            "stderr": proc.stderr.strip().splitlines()[-3:]}
        la = run["launches"] or {}
        ok = (proc.returncode == 0 and run["rounds"] is not None
              and la.get("tree_attention") == per_round * run["rounds"] > 0
              and all(v == 0 for k, v in la.items() if k != "tree_attention")
              and run["note_printed"] == note)
        if not ok:
            emit({"phase": phase, "cli": out})
            raise AssertionError(f"serving CLI run of {arch} failed: {run}")
    emit({"phase": phase, "cli": out, "nvidia_smi": smi})


def phase23_archs(smi):
    """The registry's served archs on the card. (a) Yi-9B at full width in
    bf16 with its drafter (seeds 0/1): tree (2, 2) and chain gamma 3 over 4
    x (128 + 32) at temperature 0.7, 48 + 4 * 3 = 60 tree_attention
    launches a tree round, MBSU with c from ``param_count``; (b) the first
    8 requests of phase 16's chat stream through the continuous engine by
    tree with the prefix cache; (c) greedy exactness with 2 float32 target layers, chain and
    tree, static and continuous; (d) greedy exactness by tree for
    Phi-4-mini, Minitron-4B and Chameleon-34B (qk-norm) at published widths
    with 2 float32 target layers; (e), the serving CLI by tree at full
    width for Yi-9B and MusicGen-large, runs in a CliPool
    (``arch_cli_jobs``, ``check_arch_clis``). Returns the tree_attention
    launches of (a) and (b)."""
    from repro_torch.core.speculative import SDConfig
    from repro_torch.launch import serve
    from repro_torch.spectree.tree import TreeSpec
    spec = TreeSpec((2, 2))
    resident_gb = torch.cuda.memory_allocated() / 1e9     # before Yi
    torch.cuda.reset_peak_memory_stats()
    models = serve.build_models("yi-9b", False, "cuda")
    target, _, draft, _, c = models
    c_cfg = draft.cfg.param_count() / target.cfg.param_count()
    assert c == c_cfg, (c, c_cfg)          # param_count matches the init
    per_round = tree_launches_per_round(target, draft, spec)
    assert per_round == 60, per_round
    emit({"phase": "23a", "arch": target.cfg.name, "drafter": draft.cfg.name,
          "params": target.cfg.param_count(), "drafter_params":
          draft.cfg.param_count(), "c": c, "heads": target.cfg.num_heads,
          "kv_heads": target.cfg.num_kv_heads, "G": target.cfg.q_per_kv,
          "resident_before_gb": resident_gb,
          "weights_gb": torch.cuda.memory_allocated() / 1e9 - resident_gb})
    tree, _ = phase3_tree_serving(models, smi, phase="23a",
                                         max_new=ARCH_NEW)
    chain = phase4_chain_serving(models, smi, phase="23a", ar=False,
                                 max_new=ARCH_NEW)
    assert all(n == 0 for k, n in tree.items() if k != "tree_attention"), tree
    assert not any(chain.values()), chain
    cont, _ = continuous_pass(models, SDConfig(gamma=3, temperature=0.7), spec,
                              prefix=True, kv_quant=False, n=SHORT_N,
                              max_batch=SHORT_BATCH)
    emit({"phase": "23b", "arch": target.cfg.name, "mix": CONT_MIX,
          "requests": SHORT_N, "arrival_rate": CONT_RATE,
          "engine": {**CONT_ENGINE, "max_batch": SHORT_BATCH},
          "temperature": 0.7, "pass": cont, "nvidia_smi": smi})
    del models, target, draft
    torch.cuda.empty_cache()
    results = {}
    for arch, P, M, chain_too, continuous in (
            ("yi-9b", 64, 32, True, True),
            *[(a, 64, 16, False, False) for a in GREEDY_ARCHS]):
        out, ok = greedy_exactness(arch, P, M, chain_too, continuous)
        results[arch] = out
        emit({"phase": "23c" if arch == "yi-9b" else "23d", **out})
        assert ok, ("greedy tokens differ, or tree launches are off", out)
    return tree["tree_attention"] + cont["launches"]["tree_attention"]


# ------------------------------------------------ Gemma-2-9B (24)

GEMMA_LONG = dict(requests=4, prompt=4160, max_new=64)   # 24b, past 4,096
GEMMA_LONG_ENGINE = dict(max_batch=8, page_size=16, prefill_chunk=512)
GEMMA_EXACT = (("past_window", 4160, False),     # 24c: (name, prompt, long
               ("long_context", 8256, True))     # context) past each window


def long_requests(n, prompt_len, max_new, vocab, seed=0, spread=0):
    """``n`` requests of seeded random prompts of ``prompt_len`` (+ i *
    ``spread`` for the i-th) tokens, all arriving at t = 0."""
    from repro_torch.serving import ServeRequest
    rng = np.random.default_rng(seed)
    return [ServeRequest(prompt=rng.integers(3, vocab, prompt_len + i * spread)
                         .astype(np.int64), max_new_tokens=max_new,
                         request_id=i)
            for i in range(n)]


def gemma_past_the_window(models, smi):
    """24b: the continuous engine by tree (2, 2) at 0.7 over 4 requests of
    4,160 seeded tokens + 64 new, all at t = 0, 512-token prefill chunks, 8
    slots, 16-slot pages: every request decodes past position 4,096, where
    the local layers mask by the window and the global ones do not; 54
    tree_attention launches a round and no other kernel."""
    from repro_torch.core.speculative import SDConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.spectree.tree import TreeSpec
    target, t_params, draft, d_params, c = models
    spec, sdc = TreeSpec((2, 2)), SDConfig(gamma=3, temperature=0.7)
    V = target.cfg.vocab_size
    g = GEMMA_LONG
    # warm-up at the same widths on a short request, not counted
    serve.serve_continuous(target, t_params, draft, d_params,
                           long_requests(1, 512, 8, V, seed=1), sdc, spec,
                           **GEMMA_LONG_ENGINE)
    reqs = long_requests(g["requests"], g["prompt"], g["max_new"], V)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    engine, results = serve.serve_continuous(target, t_params, draft, d_params,
                                             reqs, sdc, spec,
                                             **GEMMA_LONG_ENGINE)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    check_served(results, reqs, V)
    R = engine.telemetry.decode_rounds
    per_round = tree_launches_per_round(target, draft, spec)
    want = {k: 0 for k in launches}
    want["tree_attention"] = R * per_round
    assert R > 0 and launches == want, (launches, want)
    first_decode_pos = min(len(r.prompt) for r in reqs)
    assert first_decode_pos > target.cfg.sliding_window, first_decode_pos
    view = engine.pool.max_pages_per_seq * engine.page_size
    summary = serve.continuous_summary(engine, results, c, spec.depth)
    assert summary["tau"] >= 1.0 and math.isfinite(summary["tau"]), summary
    summary.update(launches=launches, tree_attention_per_round=per_round,
                   first_decode_position=first_decode_pos,
                   window=target.cfg.sliding_window, view_slots=view,
                   num_pages=engine.num_pages,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit({"phase": "24b", "arch": target.cfg.name, **g,
          "engine": GEMMA_LONG_ENGINE, "temperature": 0.7, "tree": [2, 2],
          "pass": summary, "nvidia_smi": smi})
    return launches["tree_attention"]


def gemma_greedy_exactness():
    """24c: temperature 0 with Gemma-2-9B's target cut to 2 float32 layers
    (one local_attn, one attn) at published widths and its float32
    drafter: (i) within the window (P 64), static chain and tree and the
    continuous engine, as ``greedy_exactness``; (ii) past the window (2
    requests of 4,160 and 4,167 tokens, 16 new) and (iii) with
    long_context (8,256 and 8,263 tokens: the global layers window at
    8,192), the continuous engine by chain and tree (2 slots, 512-token
    chunks) and the static chain and tree, each request's tokens equal to
    its static AR tokens with the same long_context."""
    from repro_torch.configs import get_config
    from repro_torch.core.speculative import (SDConfig, autoregressive_generate,
                                              speculative_generate)
    from repro_torch.models.model import Model
    from repro_torch.serving import ContinuousEngine
    from repro_torch.spectree.round import tree_speculative_generate
    from repro_torch.spectree.tree import TreeSpec
    out, ok = greedy_exactness(GEMMA, 64, 16, chain=True, continuous=True)
    cfg = get_config(GEMMA).replace(num_layers=2, dtype="float32")
    target, draft = Model(cfg, "cuda"), Model(cfg.drafter(), "cuda")
    t_params, d_params = target.init(0), draft.init(1)
    spec, M = TreeSpec((2, 2)), 16
    for name, P, lc in GEMMA_EXACT:
        assert P > (cfg.long_context_window if lc else cfg.sliding_window)
        sdc = SDConfig(gamma=3, temperature=0.0, long_context=lc)
        reqs = long_requests(2, P, M, cfg.vocab_size, seed=7, spread=7)
        res = out[name] = {"prompts": [len(r.prompt) for r in reqs],
                           "max_new": M, "long_context": lc}
        greedy, chain, tree = {}, {}, {}
        for r in reqs:
            prompt = torch.as_tensor(r.prompt[None], device=target.device)
            L = len(r.prompt)
            greedy[r.request_id] = autoregressive_generate(
                target, t_params, prompt, M, temperature=0.0,
                long_context=lc)[0][0, L:].cpu().numpy()
            chain[r.request_id] = speculative_generate(
                draft, target, d_params, t_params, prompt, M,
                sdc)[0][0, L:L + M].cpu().numpy()
            tree[r.request_id] = tree_speculative_generate(
                draft, target, d_params, t_params, prompt, M, sdc,
                spec)[0][0, L:L + M].cpu().numpy()
        if lc:      # does the 8,192 window change this model's tokens?
            res["ar_differs_without_long_context"] = any(
                not np.array_equal(autoregressive_generate(
                    target, t_params,
                    torch.as_tensor(r.prompt[None], device=target.device), M,
                    temperature=0.0)[0][0, len(r.prompt):].cpu().numpy(),
                    greedy[r.request_id]) for r in reqs)
        res["static_chain_equals_ar"] = all(
            np.array_equal(chain[i], greedy[i]) for i in greedy)
        res["static_tree_equals_ar"] = all(
            np.array_equal(tree[i], greedy[i]) for i in greedy)
        for kind, tr in (("chain", None), ("tree", spec)):
            engine = ContinuousEngine(
                target=target, target_params=t_params, draft=draft,
                draft_params=d_params, sd=sdc, tree=tr, max_batch=2,
                page_size=16, prefill_chunk=512, max_seq_len=P + 7 + M)
            got = {r.request_id: r.tokens for r in engine.serve(
                long_requests(2, P, M, cfg.vocab_size, seed=7, spread=7))}
            res[f"continuous_{kind}_equals_ar"] = all(
                np.array_equal(got[i], greedy[i]) for i in greedy)
        ok &= all(v for k, v in res.items() if k.endswith("_equals_ar"))
    del target, draft, t_params, d_params
    torch.cuda.empty_cache()
    return out, ok


def phase24_gemma(smi):
    """Gemma-2-9B on the card (after phase 23, once Yi is freed). (a)
    Full width (42 layers alternating local_attn and attn, window 4,096, d
    3584, 16 heads on 8 KV heads at hd 256, softcaps 50/30, scaled
    embeddings, V 256000; 10.16B parameters) with its drafter (4 layers, d
    1024, hd 128; 0.571B) in bf16 from seeds 0/1: tree (2, 2) and chain
    gamma 3 over 4 x (128 + 32) at temperature 0.7, within the window:
    42 + 4 * 3 = 54 tree_attention launches a tree round and no other
    kernel; (b) the continuous engine past the window
    (``gemma_past_the_window``); (c) greedy exactness within and past the
    window and with long_context (``gemma_greedy_exactness``); (d), the
    serving CLI by tree at full width, runs in a CliPool. Returns the
    tree_attention launches of (a) and (b)."""
    from repro_torch.launch import serve
    from repro_torch.spectree.tree import TreeSpec
    spec = TreeSpec((2, 2))
    resident_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    models = serve.build_models(GEMMA, False, "cuda")
    target, _, draft, _, c = models
    cfg = target.cfg
    c_cfg = draft.cfg.param_count() / cfg.param_count()
    assert c == c_cfg, (c, c_cfg)          # param_count matches the init
    per_round = tree_launches_per_round(target, draft, spec)
    assert per_round == 54, per_round
    assert cfg.scale_embed and 128 + 64 + 7 + 2 < cfg.sliding_window
    emit({"phase": "24a", "arch": cfg.name, "drafter": draft.cfg.name,
          "params": cfg.param_count(), "drafter_params":
          draft.cfg.param_count(), "c": c, "layer_pattern": cfg.layer_pattern,
          "window": cfg.sliding_window, "head_dim": cfg.head_dim_,
          "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
          "softcaps": [cfg.attn_softcap, cfg.final_softcap],
          "resident_before_gb": resident_gb,
          "weights_gb": torch.cuda.memory_allocated() / 1e9 - resident_gb})
    tree, _ = phase3_tree_serving(models, smi, phase="24a",
                                         max_new=ARCH_NEW)
    chain = phase4_chain_serving(models, smi, phase="24a", ar=False,
                                 max_new=ARCH_NEW)
    assert all(n == 0 for k, n in tree.items() if k != "tree_attention"), tree
    assert not any(chain.values()), chain
    long_launches = gemma_past_the_window(models, smi)
    del models, target, draft
    gc.collect()
    torch.cuda.empty_cache()
    exact, ok = gemma_greedy_exactness()
    emit({"phase": "24c", **exact})
    assert ok, ("Gemma-2 greedy tokens differ from AR, or tree launches are "
                "off", exact)
    return tree["tree_attention"] + long_launches


# ------------------------------------------------ mixture of experts (25)

GRANITE, GROK = "granite-moe-3b-a800m", "grok-1-314b"
MOE_TVD = dict(batch=2, seq=1024, steps=2)        # 25e, 2 loss chunks a row


@contextlib.contextmanager
def moe_drops():
    """The MoE layers' dropped (token, expert) assignments, counted by a
    wrapper around ``models.moe._dispatch``: a list of (tokens of the
    call, dropped assignments as a device tensor) per layer call."""
    from repro_torch.models import moe
    calls, dispatch = [], moe._dispatch

    def spy(experts, E, C):
        slot = dispatch(experts, E, C)
        calls.append((experts.shape[0], (slot == E * C).sum()))
        return slot

    moe._dispatch = spy
    try:
        yield calls
    finally:
        moe._dispatch = dispatch


MOE_RANGES = {"_moe_local": "moe_layer", "_route": "moe_route",
              "_expert_ffn": "moe_expert_matmuls"}


@contextlib.contextmanager
def moe_ranges():
    """Every call of ``models.moe``'s ``_moe_local``, ``_route`` and
    ``_expert_ffn`` inside a torch.profiler range named as in
    ``MOE_RANGES``, by wrappers installed here for the run (not a feature
    of the package)."""
    from torch.profiler import record_function
    from repro_torch.models import moe
    saved = {name: getattr(moe, name) for name in MOE_RANGES}

    def ranged(name, fn):
        def call(*args, **kw):
            with record_function(MOE_RANGES[name]):
                return fn(*args, **kw)
        return call

    for name, fn in saved.items():
        setattr(moe, name, ranged(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(moe, name, fn)


def moe_shares(prof, rounds, total_us):
    """Device ms a round of the kernels launched under each range of
    ``moe_ranges`` and their share of the profile's device time: the
    expert matmuls (``_expert_ffn``'s three bmm), the routing (``_route``:
    the router matmul, softmax, top-k, renormalisation) and the dispatch
    (the rest of ``_moe_local``: sort, searchsorted, slot numbering, the
    buffer's copy, the gather and the combine)."""
    from torch.autograd import DeviceType
    us = {r: sum(e.device_time_total for e in prof.events()
                 if e.name == r and e.device_type == DeviceType.CPU)
          for r in MOE_RANGES.values()}
    parts = {"expert_matmuls": us["moe_expert_matmuls"],
             "routing": us["moe_route"],
             "dispatch": us["moe_layer"] - us["moe_expert_matmuls"]
                         - us["moe_route"],
             "moe_layers": us["moe_layer"]}
    calls = sum(1 for e in prof.events()
                if e.name == "moe_layer" and e.device_type == DeviceType.CPU)
    return {"layer_calls_per_round": calls / rounds,
            **{f"{k}_ms_per_round": v / 1e3 / rounds for k, v in parts.items()},
            **{f"share_{k}": v / total_us for k, v in parts.items()}}


def drops_per_pass(calls, cfg):
    """{tokens of a pass: {passes, the (token, expert) assignments of a
    pass over all its MoE layers, those dropped, their share}} from
    ``moe_drops``' calls."""
    out = {}
    for n, dropped in calls:
        row = out.setdefault(int(n), [0, 0])
        row[0] += 1
        row[1] += int(dropped)
    L, k = cfg.num_layers, cfg.num_experts_per_tok
    return {n: {"passes": c // L, "assignments": n * k * L,
                "dropped": d / (c // L), "dropped_share": d / (c * n * k)}
            for n, (c, d) in sorted(out.items())}


def moe_layer_ms(models, tokens=28):
    """A per-layer reading, apart from the profiled round: device ms of one
    MoE layer (``_moe_local``) at the tree verify's shape (4 rows x 7
    nodes, random inputs), and of its expert matmuls alone
    (``_expert_ffn`` on an (E, C, d) buffer of that call's capacity), in
    CUDA graphs of 64 calls rotating over the target's layers (6 GB of
    experts: every call reads its weights from memory) and 8 inputs; the
    rest of the layer (routing, sort, copies, gathers, combine) is the
    difference."""
    from repro_torch.models import moe
    target, t_params = models[:2]
    cfg, dev = target.cfg, target.device
    gen = torch.Generator(device=dev).manual_seed(11)
    layers = [lp["moe"] for lp in t_params["layers"]]
    C = moe.capacity(tokens, cfg)
    xs = [torch.randn((tokens, cfg.d_model), generator=gen, device=dev)
          .to(cfg.compute_dtype) for _ in range(8)]
    bufs = [torch.randn((cfg.num_experts, C, cfg.d_model), generator=gen,
                        device=dev).to(cfg.compute_dtype) for _ in range(8)]
    it = iter(range(10 ** 9))

    def layer_call():
        i = next(it)
        return moe._moe_local(layers[i % len(layers)], xs[i % 8], cfg)

    def experts_call():
        i = next(it)
        p = layers[i % len(layers)]
        return moe._expert_ffn(p["w_gate"], p["w_up"], p["w_down"], bufs[i % 8])

    layer_ms = graph_ms(layer_call, iters=64)
    expert_ms = graph_ms(experts_call, iters=64)
    expert_bytes = 3 * cfg.num_experts * cfg.d_model * cfg.d_ff * 2
    return {"tokens": tokens, "capacity": C, "layer_ms": layer_ms,
            "expert_matmuls_ms": expert_ms,
            "routing_and_dispatch_ms": layer_ms - expert_ms,
            "expert_bytes_bound_ms": expert_bytes / HBM_BYTES_PER_S * 1e3}


def granite_int8(smi):
    """25c: granite and its drafter drawn in float32, AWQ-calibrated and
    quantized to int8 weights (the attention projections and lm heads;
    experts and routers stay full precision, routers in float32), KV in
    bf16; tree (2, 2) over 4 x (128 + 32) at 0.7 with the launches
    asserted: tree_attention 44 a round, quant_matmul 4 * 32 + 1 a target
    pass and 7 * 4 + 1 a drafter pass, no other kernel."""
    from repro_torch.configs import QuantConfig
    from repro_torch.core.speculative import SDConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.quant import decode_step_bytes, params_nbytes
    from repro_torch.quant.qweight import QWeight
    from repro_torch.spectree.tree import TreeSpec
    B, P, NEW = 4, 128, 32
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    models = serve.build_models(GRANITE, False, "cuda",
                                QuantConfig(weights="int8"), quant_target=True,
                                calib_seqs=4, calib_len=P)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    target, t_params, draft, d_params, c = models
    layer = t_params["layers"][0]
    assert all(isinstance(layer["attn"][n], QWeight) for n in ("wq", "wk", "wv", "wo"))
    assert isinstance(t_params["lm_head"], QWeight)
    assert layer["moe"]["router"].dtype == torch.float32
    for name, m, p in (("target", target, t_params), ("drafter", draft, d_params)):
        have = {(w.in_dim, w.out_dim) for w in _leaves(p) if isinstance(w, QWeight)}
        want = {(K, N) for _, K, N in GRANITE_QUANT_SHAPES[name]}
        assert have == want, (name, have, want)    # phase 2 held every shape
    assert all(layer["moe"][n].dtype == torch.bfloat16
               for n in ("w_gate", "w_up", "w_down"))
    stored = {"target": params_nbytes(t_params), "drafter": params_nbytes(d_params)}
    modeled = {name: dict(zip(("weight", "scale", "kv", "total"),
                              decode_step_bytes(m.cfg, B, P + NEW, "int8",
                                                "bfloat16").row()))
               for name, m in (("target", target), ("drafter", draft))}
    spec = TreeSpec((2, 2))
    sdc = SDConfig(gamma=3, temperature=0.7)
    prompts = serve.make_prompts(B, P, target.cfg.vocab_size)
    serve.serve_tree(target, t_params, draft, d_params, prompts, 8, sdc, spec,
                     seed=1)
    torch.cuda.synchronize()
    ops.reset_launches()
    toks, stats = serve.serve_tree(target, t_params, draft, d_params, prompts,
                                   NEW, sdc, spec)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    R = stats.rounds
    pt, pd = quant_passes(target.cfg), quant_passes(draft.cfg)
    want = {k: 0 for k in launches}
    want["tree_attention"] = R * tree_launches_per_round(target, draft, spec)
    want["quant_matmul_int8"] = (1 + R) * pt + (1 + (spec.depth + 1) * R) * pd
    assert R > 0 and launches == want, (launches, want)
    new = toks[:, P:P + NEW]
    assert bool(((new >= 0) & (new < target.cfg.vocab_size)).all())
    assert stats.tau >= 1.0 and math.isfinite(stats.tau), stats.tau
    emit({"phase": "25c", "arch": target.cfg.name, "weights": "int8",
          "quantized": ["target", "drafter"], "build_s": build_s,
          "build_peak_gb": build_peak_gb, "stored_bytes": stored,
          "modeled_decode_step_bytes": modeled,
          "note": "the model bills experts and embeddings at param_dtype "
                  "(float32), as the reference's does; they are stored in bf16",
          "tree": {"rounds": R, "tau": stats.tau, "tok_s": stats.tokens_per_s(),
                   "wall_s": stats.wall_time_s, "launches": launches,
                   "quant_matmul_per_round": (launches["quant_matmul_int8"]
                                              - pt - pd) / R},
          "launches_per_pass": {"target": pt, "drafter": pd},
          "requests": B, "prompt_len": P, "max_new": NEW, "temperature": 0.7,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "nvidia_smi": smi})
    return launches["quant_matmul_int8"]


def drops_probe(cf):
    """A ``greedy_exactness`` probe: on the same weights at capacity factor
    ``cf``, greedy AR, chain (gamma 3) and tree (2, 2) tokens, the
    assignments dropped per pass and the share of the speculative tokens
    equal to AR's (reported, not asserted: drops make a token depend on
    its batchmates)."""
    def probe(target, t_params, draft, d_params, prompt, M):
        from repro_torch.core.speculative import (SDConfig,
                                                  autoregressive_generate,
                                                  speculative_generate)
        from repro_torch.models.model import Model
        from repro_torch.spectree.round import tree_speculative_generate
        from repro_torch.spectree.tree import TreeSpec
        tm = Model(target.cfg.replace(moe_capacity_factor=cf), target.device)
        P = prompt.shape[1]
        sdc = SDConfig(gamma=3, temperature=0.0)
        out = {"cf": cf}
        with moe_drops() as calls:
            ar, _ = autoregressive_generate(tm, t_params, prompt, M,
                                            temperature=0.0)
        out["ar_drops"] = drops_per_pass(calls, tm.cfg)
        for name, run in (
                ("chain", lambda: speculative_generate(
                    draft, tm, d_params, t_params, prompt, M, sdc)),
                ("tree", lambda: tree_speculative_generate(
                    draft, tm, d_params, t_params, prompt, M, sdc,
                    TreeSpec((2, 2))))):
            with moe_drops() as calls:
                toks, _ = run()
            out[f"{name}_drops"] = drops_per_pass(calls, tm.cfg)
            out[f"{name}_agreement_with_ar"] = (
                toks[:, P:P + M] == ar[:, P:P + M]).float().mean().item()
        return {f"at_cf_{cf}": out}
    return probe


def moe_tvdpp(smi):
    """25e: ``tvdpp_steps`` for granite at V 49155 (rows of 196,620
    bytes: the kernels' unaligned route)."""
    return tvdpp_steps(GRANITE, "25e", smi, unaligned=True)


def tvdpp_steps(arch, phase, smi, unaligned=False):
    """TVD++ steps of ``arch``'s drafter (float32 master weights) against
    the frozen bf16 full-width target through the distill kernels, launch
    counts asserted, then one step's kernel route against the plain route
    as phase 7 compares them."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    from repro_torch.training import finetune, make_train_state
    B, S, steps = MOE_TVD["batch"], MOE_TVD["seq"], MOE_TVD["steps"]
    cfg = get_config(arch)
    target = Model(cfg, "cuda")
    t_params = target.init(0)                               # bf16, frozen
    draft = Model(cfg.drafter().replace(vocab_size=cfg.vocab_size), "cuda")
    tc = TrainConfig(warmup_steps=2, total_steps=100)
    state = make_train_state(draft, 1, tc)
    V = cfg.vocab_size
    assert ((V * 4) % 16 != 0) == unaligned, V
    data = serve.make_prompts(4, S, V, seed=10)
    batches = iter([data[i:i + B] for i in range(0, 4, B)])
    t_sum, d_before = param_checksum(t_params), param_checksum(state["params"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    state, hist = finetune(draft, target, state, t_params, batches, tc, steps,
                           "tvdpp", log_every=1, use_kernels=True)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    n = S // 512                                # loss chunks per step
    per_step = {k: 0 for k in launches}
    per_step.update(row_logsumexp=6 * n, loss_terms=3 * n, loss_grad=n)
    assert launches == {k: v * steps for k, v in per_step.items()}, launches
    assert all(math.isfinite(h["loss"]) for h in hist), hist
    assert param_checksum(t_params) == t_sum, "target parameters changed"
    assert param_checksum(state["params"]) != d_before, "drafter did not move"
    tokens = torch.as_tensor(data[:B], dtype=torch.long, device=target.device)
    routes = compare_routes(draft, target, state["params"], t_params, tokens,
                            loss_rtol=1e-4, grad_rtol=2e-2)
    emit({"phase": phase, "arch": cfg.name, "drafter": draft.cfg.name,
          "vocab": V, "batch": [B, S], "steps": steps,
          "loss": [h["loss"] for h in hist], "wall_s": wall_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": launches, "launches_per_step": per_step,
          "kernel_vs_plain": routes, "nvidia_smi": smi})
    assert routes["ok"], routes
    del target, draft, t_params, state
    torch.cuda.empty_cache()
    return launches


def phase25_moe(smi):
    """Mixture of experts on the card (after phase 24, once Gemma is
    freed). (a) granite-moe-3b-a800m at full width (32 layers, d 1536, 24
    heads on 8 KV heads at hd 64, 40 experts top-8 of width 512, V 49155;
    3.374B parameters) with its dense drafter (4 layers, d 512; 62.1M) in
    bf16 from seeds 0/1: tree (2, 2) and chain gamma 3 over 4 x (128 + 32)
    at 0.7, 32 + 4 * 3 = 44 tree_attention launches a tree round and no
    other kernel, where the time goes (torch.profiler: the expert matmuls'
    and the dispatch's shares), the assignments dropped per verify pass
    (counted here), and one input run twice through a full-width forward
    for equal bits; (b) the first 8 requests of phase 16's chat stream
    through 4 slots of the continuous engine by tree with the prefix cache;
    (c) int8 weights (``granite_int8``); (d) greedy exactness with 2
    float32 target layers at published widths at capacity factor E / k,
    where nothing drops, for granite (static and continuous) and
    grok-1-314b (static; d 6144, 8 experts top-2 of width 32768, softcap
    30, V 131072: 46 GB), and at 1.25 the drops and the agreement with AR
    printed, asserted neither; (e) TVD++ steps of granite's drafter
    (``moe_tvdpp``); (f), the serving CLI by tree at full width, runs in
    a CliPool. Returns
    (the tree_attention launches of (a) and (b), the launches of (c) and
    (e))."""
    from repro_torch.configs import get_config
    from repro_torch.core.speculative import SDConfig
    from repro_torch.launch import serve
    from repro_torch.spectree.tree import TreeSpec
    spec, sdc = TreeSpec((2, 2)), SDConfig(gamma=3, temperature=0.7)
    resident_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    models = serve.build_models(GRANITE, False, "cuda")
    target, t_params, draft, d_params, c = models
    cfg = target.cfg
    c_cfg = draft.cfg.param_count() / cfg.param_count()
    assert c == c_cfg, (c, c_cfg)          # param_count matches the init
    per_round = tree_launches_per_round(target, draft, spec)
    assert per_round == 44, per_round
    emit({"phase": "25a", "arch": cfg.name, "drafter": draft.cfg.name,
          "params": cfg.param_count(), "drafter_params":
          draft.cfg.param_count(), "c": c, "experts": cfg.num_experts,
          "top_k": cfg.num_experts_per_tok, "expert_d_ff": cfg.d_ff,
          "capacity_factor": cfg.moe_capacity_factor,
          "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
          "G": cfg.q_per_kv, "head_dim": cfg.head_dim_,
          "router_dtype": str(t_params["layers"][0]["moe"]["router"].dtype),
          "resident_before_gb": resident_gb,
          "weights_gb": torch.cuda.memory_allocated() / 1e9 - resident_gb})
    tree, breakdown = phase3_tree_serving(models, smi, phase="25a",
                                         max_new=ARCH_NEW)
    chain = phase4_chain_serving(models, smi, phase="25a", ar=False,
                                 max_new=ARCH_NEW)
    assert all(n == 0 for k, n in tree.items() if k != "tree_attention"), tree
    assert not any(chain.values()), chain
    prompts = serve.make_prompts(4, 128, cfg.vocab_size)
    with moe_drops() as calls:
        serve.serve_tree(target, t_params, draft, d_params, prompts, 16, sdc,
                         spec, seed=4)
    tree_drops = drops_per_pass(calls, cfg)
    with moe_drops() as calls:
        serve.serve_static(target, t_params, draft, d_params, prompts, 16,
                           sdc, seed=4)
    chain_drops = drops_per_pass(calls, cfg)
    x = torch.as_tensor(prompts[:, :64], device=target.device)
    first = target.logits(t_params, x)
    again = target.logits(t_params, x)
    same_bits = torch.equal(first, again)
    emit({"phase": "25a", "arch": cfg.name,
          "moe_shares_of_the_profiled_tree_round": breakdown.get("moe"),
          "moe_layer_alone_in_graphs": moe_layer_ms(models),
          "dropped_per_pass": {
              "note": "by the tokens of a pass: 28 = the tree verify (4 x "
                      "7), 16 = the chain verify (4 x 4), 512 = the "
                      "prefill, 4 = AR steps; over its 32 layers",
              "tree": tree_drops, "chain": chain_drops},
          "forward_twice_equal_bits": same_bits, "nvidia_smi": smi})
    assert same_bits, "one input run twice gave different logits"
    cont, _ = continuous_pass(models, sdc, spec, prefix=True, kv_quant=False,
                              n=SHORT_N, max_batch=SHORT_BATCH)
    emit({"phase": "25b", "arch": cfg.name, "mix": CONT_MIX,
          "requests": SHORT_N, "arrival_rate": CONT_RATE,
          "engine": {**CONT_ENGINE, "max_batch": SHORT_BATCH},
          "temperature": 0.7, "pass": cont, "nvidia_smi": smi})
    del models, target, draft, t_params, d_params
    gc.collect()
    torch.cuda.empty_cache()
    quant_launches = granite_int8(smi)
    gc.collect()
    torch.cuda.empty_cache()
    for arch, continuous in ((GRANITE, True), (GROK, False)):
        full = get_config(arch)
        no_drops = full.num_experts / full.num_experts_per_tok
        out, ok = greedy_exactness(
            arch, 64, 16, chain=True, continuous=continuous,
            over={"moe_capacity_factor": no_drops},
            probe=drops_probe(full.moe_capacity_factor))
        emit({"phase": "25d", "capacity_factor": no_drops, **out})
        assert ok, ("MoE greedy tokens differ from AR where nothing drops, "
                    "or tree launches are off", out)
        gc.collect()
        torch.cuda.empty_cache()
    distill_launches = moe_tvdpp(smi)
    moe_launches = {**distill_launches, "quant_matmul_int8": quant_launches}
    return tree["tree_attention"] + cont["launches"]["tree_attention"], \
        moe_launches


# ------------------------------------------------ recurrent layers (26)

ZAMBA, XLSTM = "zamba2-7b", "xlstm-1.3b"
REC_B, REC_P, REC_NEW = 4, 128, 32          # 26a, 26b: 4 x (128 + 32)
ZAMBA_QUANT_SHAPES = {   # (label, K, N) of every quantized matmul of 26d
    "target": [("wq/wk/wv/wo", 3584, 3584), ("w_gate/w_up", 3584, 14336),
               ("w_down", 14336, 3584), ("lm_head", 3584, 32000)],
    "drafter": [("wq/wk/wv/wo", 1024, 1024), ("w_gate/w_up", 1024, 2816),
                ("w_down", 2816, 1024), ("lm_head", 1024, 32000)]}
ZAMBA_QUANT_ROWS = (4, 512)   # a recurrent verify feeds one token a call
SERVED_LINE = re.compile(r"^served 4 requests; tau=", re.M)
PROFILED_ROUNDS = 1         # 26a, 26b: chain rounds under torch.profiler
REC_RANGES = {   # (module, function) -> torch.profiler range
    ("repro_torch.models.ssm", "_causal_conv"): "ssm_conv",
    ("repro_torch.models.ssm", "chunked_ssd"): "ssd_scan",
    ("repro_torch.models.ssm", "ssd_steps"): "ssd_scan",
    ("repro_torch.models.xlstm", "chunked_gla"): "mlstm_scan",
    ("repro_torch.models.xlstm", "gla_steps"): "mlstm_scan",
    ("repro_torch.models.xlstm", "_slstm_scan"): "slstm_scan",
    ("repro_torch.core.speculative", "select_snapshot"): "snapshot_rewind"}


@contextlib.contextmanager
def recurrent_ranges():
    """Every call of the functions of ``REC_RANGES`` inside a
    torch.profiler range of its name, by wrappers installed here for the
    run (not a feature of the package)."""
    import importlib
    from torch.profiler import record_function
    saved = {(m, f): getattr(importlib.import_module(m), f) for m, f in REC_RANGES}

    def ranged(name, fn):
        def call(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return call

    for (m, f), fn in saved.items():
        setattr(importlib.import_module(m), f, ranged(REC_RANGES[(m, f)], fn))
    try:
        yield
    finally:
        for (m, f), fn in saved.items():
            setattr(importlib.import_module(m), f, fn)


def recurrent_shares(prof, rounds, total_us):
    """Device ms a round of the kernels launched under each range of
    ``recurrent_ranges`` and their share of the profile's ``total_us`` of
    device time."""
    from torch.autograd import DeviceType
    us = dict.fromkeys(sorted(set(REC_RANGES.values())), 0.0)
    for e in prof.events():
        if e.name in us and e.device_type == DeviceType.CPU:
            us[e.name] += e.device_time_total
    out = {}
    for name, t in us.items():
        out[f"{name}_ms_per_round"] = t / 1e3 / rounds
        out[f"share_{name}"] = t / total_us
    return out


def snapshot_bytes(model, cache, gamma, long_context=False):
    """Bytes of the state a chain round's rewind keeps per snapshot (the
    recurrent layers' leaves and the attention rings'), the snapshots held
    a round (gamma; holding a recurrent layer's new dict moves no bytes),
    and the bytes the rewind moves (``select_snapshot``: a stack of the
    gamma + 1 versions written and read, then the selected rows)."""
    from repro_torch.core.speculative import ring_layers
    rings = ring_layers(model, cache, long_context)
    kept = sum(t.numel() * t.element_size() for c, ring in zip(cache, rings)
               if "pos" not in c or ring for t in c.values())
    return {"state_bytes_per_snapshot": kept,
            "snapshots_held_bytes": gamma * kept,
            "rewind_bytes_per_round": (2 * (gamma + 1) + 2) * kept}


def reference_init_params(cfg, params):
    """The parameters the reference's init draws: the port's, plus the
    block it draws at every shared position of every group, which its
    forward never reads (ROADMAP §3 item 10)."""
    from repro_torch.launch import serve
    from repro_torch.models.transformer import layer_kinds
    if "shared_attn" not in params:
        return serve.count_params(params)
    per_set = serve.count_params(params["shared_attn"][0])
    shared = sum(k == "shared_attn" for k in layer_kinds(cfg))
    return serve.count_params(params) + shared * per_set


def recurrent_serving(arch, phase, smi):
    """26a / 26b: ``arch`` at full width with its drafter in bf16 from
    seeds 0/1, chain gamma 3 and AR over 4 x (128 + 64) at 0.7: tau, MBSU
    with c from ``param_count`` (printed beside the init's), tok/s, host
    and device ms a round, the device shares of the scans, the conv and
    the matmuls and the rewind's ms (torch.profiler), the snapshots'
    bytes, weights and peak GB; no kernel launched; one input through the
    full forward twice and one short chain run twice for equal bits."""
    from repro_torch.core.metrics import mbsu
    from repro_torch.core.speculative import (SDConfig, _prefill_state,
                                              autoregressive_generate,
                                              sd_round, speculative_generate)
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from torch.profiler import ProfilerActivity, profile

    resident_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    models = serve.build_models(arch, False, "cuda")
    target, t_params, draft, d_params, c_init = models

    def gen(seed):
        return torch.Generator(device=target.device).manual_seed(seed)

    weights_gb = torch.cuda.memory_allocated() / 1e9 - resident_gb
    cfg = target.cfg
    c = draft.cfg.param_count() / cfg.param_count()
    emit({"phase": phase, "arch": cfg.name, "drafter": draft.cfg.name,
          "layers": cfg.num_layers, "pattern": cfg.layer_pattern,
          "d_model": cfg.d_model, "vocab": cfg.vocab_size,
          "param_count": {"target": cfg.param_count(),
                          "drafter": draft.cfg.param_count()},
          "params_held": {"target": serve.count_params(t_params),
                          "drafter": serve.count_params(d_params)},
          "reference_init_params": {
              "target": reference_init_params(cfg, t_params),
              "drafter": reference_init_params(draft.cfg, d_params)},
          "c_param_count": c, "c_held": c_init,
          "resident_before_gb": resident_gb, "weights_gb": weights_gb})
    sdc = SDConfig(gamma=3, temperature=0.7)
    prompt = torch.as_tensor(serve.make_prompts(REC_B, REC_P, cfg.vocab_size),
                             device=target.device)
    steps_s = {}
    t0 = time.perf_counter()
    speculative_generate(draft, target, d_params, t_params, prompt, 4, sdc,
                         gen=gen(1))                       # warm-up
    torch.cuda.synchronize()
    steps_s["warm_up"] = time.perf_counter() - t0
    ops.reset_launches()
    t0 = time.perf_counter()
    toks, stats = speculative_generate(draft, target, d_params, t_params,
                                       prompt, REC_NEW, sdc, gen=gen(0))
    torch.cuda.synchronize()
    steps_s["chain"] = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    t0 = time.perf_counter()
    _, ar_s = autoregressive_generate(target, t_params, prompt, REC_NEW,
                                      temperature=0.7, gen=gen(0))
    steps_s["ar"] = time.perf_counter() - t0
    new = toks[:, REC_P:REC_P + REC_NEW]
    assert not any(launches.values()), launches        # no kernel on this path
    assert bool(((new >= 0) & (new < cfg.vocab_size)).all()), "token out of vocab"
    assert stats.rounds > 0 and stats.tau >= 1.0 and math.isfinite(stats.tau)
    wall_ms = stats.wall_time_s * 1e3 / stats.rounds
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # one round after a prefill outside the profile; the host's ops are
    # recorded too (the ranges need them), and a zamba2 round of some
    # 30,000 ops took about 20 s to record and parse
    g2 = gen(2)
    state = _prefill_state(draft, target, d_params, t_params, prompt,
                           REC_P + 16, sdc, g2)
    torch.cuda.synchronize()
    with recurrent_ranges(), profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_ROUNDS):
            state, _ = sd_round(draft, target, sdc, d_params, t_params, state,
                                g2)
        torch.cuda.synchronize()
    del state
    breakdown = kernel_breakdown(prof, PROFILED_ROUNDS, wall_ms)
    if breakdown.get("profiled", True) is not None:
        breakdown["recurrent"] = recurrent_shares(
            prof, PROFILED_ROUNDS,
            breakdown["device_ms_per_round"] * 1e3 * PROFILED_ROUNDS)
    steps_s["profile"] = time.perf_counter() - t0
    snaps = {name: snapshot_bytes(m, m.init_cache(REC_B, REC_P + REC_NEW), 3)
             for name, m in (("target", target), ("drafter", draft))}
    t0 = time.perf_counter()
    x = prompt[:, :64]
    same_logits = torch.equal(target.logits(t_params, x),
                              target.logits(t_params, x))
    runs = [speculative_generate(draft, target, d_params, t_params, prompt, 2,
                                 sdc, gen=gen(3))[0] for _ in range(2)]
    same_tokens = torch.equal(*runs)
    steps_s["equal_bits"] = time.perf_counter() - t0
    emit({"phase": phase, "arch": cfg.name, "path": "chain", "gamma": 3,
          "temperature": 0.7, "requests": REC_B, "prompt_len": REC_P,
          "max_new": REC_NEW, "rounds": stats.rounds, "tau": stats.tau,
          "mbsu": mbsu(stats.tau, c, 3), "mbsu_c_held": mbsu(stats.tau, c_init, 3),
          "tok_s": stats.tokens_per_s(), "wall_s": stats.wall_time_s,
          "host_ms_per_round": wall_ms,
          "ar_tok_s": REC_B * REC_NEW / ar_s, "ar_wall_s": ar_s,
          "ar_host_ms_per_token": ar_s * 1e3 / REC_NEW,
          "launches": launches, "where_the_time_goes": breakdown,
          "snapshots": snaps,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "forward_twice_equal_bits": same_logits,
          "chain_twice_equal_tokens": same_tokens, "steps_s": steps_s,
          "nvidia_smi": smi})
    assert same_logits and same_tokens, "the same seeds gave different bits"
    del models, target, draft, t_params, d_params
    gc.collect()
    torch.cuda.empty_cache()
    return {"tau": stats.tau, "tok_s": stats.tokens_per_s()}


def recurrent_greedy_exactness():
    """26c: temperature 0 in float32 at published widths: zamba2 cut to 7
    blocks (one group of six Mamba blocks and a shared block) with its
    float32 drafter, with itself as its drafter and with an untrained
    EAGLE head; xlstm cut to 2 blocks with its drafter and with itself;
    chain gamma 3 over 2 x (64 + 16) must give the target's greedy tokens,
    and the self-drafted runs must accept every draft."""
    from repro_torch.configs import get_config
    from repro_torch.core.speculative import (SDConfig,
                                              autoregressive_generate,
                                              speculative_generate)
    from repro_torch.draftheads import HeadConfig, HeadDrafter
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    P, M = 64, 16
    sdc = SDConfig(gamma=3, temperature=0.0)
    out, ok = [], True
    for arch, layers, head in ((ZAMBA, 7, True), (XLSTM, 2, False)):
        cfg = get_config(arch).replace(num_layers=layers, dtype="float32")
        target = Model(cfg, "cuda")
        t_params = target.init(0)
        draft = Model(cfg.drafter(), "cuda")
        d_params = draft.init(1)
        prompt = torch.as_tensor(serve.make_prompts(2, P, cfg.vocab_size,
                                                    seed=5), device=target.device)
        ar, _ = autoregressive_generate(target, t_params, prompt, M,
                                        temperature=0.0)
        res = {"arch": cfg.name, "target_layers": layers, "dtype": "float32",
               "drafter": draft.cfg.name, "prompt": [2, P], "max_new": M}
        drafters = [("chain", draft, d_params), ("self_draft", target, t_params)]
        if head:
            hd = HeadDrafter(HeadConfig.for_target("eagle", cfg))
            drafters.append(("eagle", hd, hd.init(1, target.device,
                                                  torch.float32)))
        for name, dm, dp in drafters:
            toks, st = speculative_generate(dm, target, dp, t_params, prompt,
                                            M, sdc)
            res[f"{name}_equals_ar"] = torch.equal(toks[:, :P + M], ar)
            res[f"{name}_tau"] = st.tau
        ok &= all(v for k, v in res.items() if k.endswith("_equals_ar"))
        ok &= res["self_draft_tau"] == 4.0
        out.append(res)
        del target, draft, t_params, d_params, drafters
        gc.collect()
        torch.cuda.empty_cache()
    return out, ok


def quant_passes_of(model, params) -> int:
    """quant_matmul launches of one forward pass of a quantized model: the
    QWeights every layer runs (a shared attention layer its set's), and
    the lm head once."""
    from repro_torch.models.transformer import layer_params
    from repro_torch.quant.qweight import QWeight
    per_layer = sum(isinstance(w, QWeight) for lp in layer_params(params, model.cfg)
                    for w in _leaves(lp))
    return per_layer + isinstance(params["lm_head"], QWeight)


def zamba_int8(smi):
    """26d: zamba2 and its drafter drawn in float32, AWQ-calibrated and
    quantized to int8 weights (the shared sets per set with plain absmax,
    as the reference; the lm heads with AWQ; Mamba blocks unquantized),
    int8 KV on the shared attention caches; chain gamma 3 over 4 x (128 +
    16) at 0.7 with quant_matmul's launches asserted against the quantized
    matmuls a pass runs times the passes; stored against modeled bytes;
    then xlstm's int8 refused (ROADMAP §3 item 9)."""
    from repro_torch.configs import QuantConfig, get_config
    from repro_torch.core.speculative import (SDConfig, _prefill_state,
                                              speculative_generate)
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    from repro_torch.quant import decode_step_bytes, params_nbytes, quantize_params
    from repro_torch.quant.qweight import QWeight
    B, P, NEW = 4, 128, 16
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    models = serve.build_models(ZAMBA, False, "cuda",
                                QuantConfig(weights="int8"), quant_target=True,
                                calib_seqs=4, calib_len=P)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    target, t_params, draft, d_params, _ = models
    for name, m, p in (("target", target, t_params), ("drafter", draft, d_params)):
        qs = [w for w in _leaves(p) if isinstance(w, QWeight)]
        have = {(w.in_dim, w.out_dim) for w in qs}
        want = {(K, N) for _, K, N in ZAMBA_QUANT_SHAPES[name]}
        assert have == want, (name, have, want)    # phase 2 held every shape
        assert all(w.pre is None for s in p["shared_attn"] for w in _leaves(s)
                   if isinstance(w, QWeight)), "a shared set has an AWQ pre-scale"
        assert p["lm_head"].pre is not None, "the lm head is not AWQ-calibrated"
        assert not any(isinstance(w, QWeight) for lp in p["layers"]
                       for w in _leaves(lp.get("mamba", {})))
    stored = {"target": params_nbytes(t_params), "drafter": params_nbytes(d_params)}
    modeled = {name: dict(zip(("weight", "scale", "kv", "total"),
                              decode_step_bytes(m.cfg, B, P + NEW, "int8",
                                                "int8").row()))
               for name, m in (("target", target), ("drafter", draft))}
    sdc = SDConfig(gamma=3, temperature=0.7, kv_quant=True)
    prompt = torch.as_tensor(serve.make_prompts(B, P, target.cfg.vocab_size),
                             device=target.device)
    g = torch.Generator(device=target.device).manual_seed(0)
    st = _prefill_state(draft, target, d_params, t_params, prompt, P + 16, sdc, g)
    kv = {name: sorted({str(layer["k"].dtype) if "k" in layer else
                        str(layer["state"].dtype) for layer in st[name]})
          for name in ("t_cache", "d_cache")}
    assert all(layer["k"].dtype == torch.int8 for name in ("t_cache", "d_cache")
               for layer in st[name] if "k" in layer), kv
    del st
    speculative_generate(draft, target, d_params, t_params, prompt, 4, sdc,
                         gen=torch.Generator(device=target.device).manual_seed(1))
    torch.cuda.synchronize()
    ops.reset_launches()
    toks, stats = speculative_generate(
        draft, target, d_params, t_params, prompt, NEW, sdc,
        gen=torch.Generator(device=target.device).manual_seed(0))
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    R = stats.rounds
    pt, pd = quant_passes_of(target, t_params), quant_passes_of(draft, d_params)
    want = {k: 0 for k in launches}
    want["quant_matmul_int8"] = (1 + 4 * R) * (pt + pd)   # prefill, 4 feeds
    assert R > 0 and launches == want, (launches, want)
    new = toks[:, P:P + NEW]
    assert bool(((new >= 0) & (new < target.cfg.vocab_size)).all())
    assert stats.tau >= 1.0 and math.isfinite(stats.tau), stats.tau
    try:
        quantize_params(Model(get_config(XLSTM), target.device), {},
                        QuantConfig(weights="int8"))
        refusal = None
    except ValueError as e:
        refusal = str(e)
    emit({"phase": "26d", "arch": target.cfg.name, "weights": "int8",
          "awq": True, "quantized": ["target", "drafter"], "build_s": build_s,
          "build_peak_gb": build_peak_gb, "stored_bytes": stored,
          "modeled_decode_step_bytes": modeled, "kv_dtypes": kv,
          "note": "the model bills the Mamba blocks and embeddings at "
                  "param_dtype (float32), as the reference's does; they are "
                  "stored in bf16 (the recurrent gates and convs in float32)",
          "chain": {"rounds": R, "tau": stats.tau, "tok_s": stats.tokens_per_s(),
                    "wall_s": stats.wall_time_s, "launches": launches,
                    "quant_matmul_per_round": 4 * (pt + pd)},
          "launches_per_pass": {"target": pt, "drafter": pd},
          "requests": B, "prompt_len": P, "max_new": NEW, "temperature": 0.7,
          "xlstm_int8_refusal": refusal,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "nvidia_smi": smi})
    assert refusal is not None and "ROADMAP §3 item 9" in refusal, refusal
    del models, target, draft, t_params, d_params
    gc.collect()
    torch.cuda.empty_cache()
    return launches["quant_matmul_int8"]


RECURRENT_CLI = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                 "zamba2-7b", "--temperature", "0.7", "--requests", "4",
                 "--max-new", "8"]


def recurrent_tree_refusal():
    """26f: the serving CLI for zamba2 with --tree (in this process: the
    CPU test runs it as a subprocess) must exit with the reference's
    refusal, before building a model."""
    from repro_torch.launch import serve
    from repro_torch.spectree.round import TREE_REFUSAL
    t0 = time.perf_counter()
    try:
        serve.main(["--arch", ZAMBA, "--tree", "--temperature", "0.7"])
        code = 0
    except SystemExit as e:
        code = e.code
    return {"cmd": f"serve.main --arch {ZAMBA} --tree", "exit": code,
            "s": time.perf_counter() - t0, "refused": code == TREE_REFUSAL}


def check_recurrent_cli(smi, pool):
    """26f: the serving CLI for zamba2 at full width by chain in a
    subprocess (job "26f-chain" of a ``CliPool``; 4 requests, 16 + 8
    tokens, 0.7): it must exit 0 having served them with no kernel
    launched."""
    proc, s = pool.wait(["26f-chain"])["26f-chain"]
    found = LAUNCH_LINE.search(proc.stdout)
    chain = {"cmd": " ".join(RECURRENT_CLI[2:]), "rc": proc.returncode,
             "s": s, "launches": json.loads(found[1]) if found else None,
             "served": SERVED_LINE.search(proc.stdout) is not None,
             "stdout": proc.stdout.strip().splitlines()[-4:],
             "stderr": proc.stderr.strip().splitlines()[-3:]}
    emit({"phase": "26f", "cli": {"chain": chain}, "nvidia_smi": smi})
    assert (chain["rc"] == 0 and chain["launches"] is not None
            and not any(chain["launches"].values()) and chain["served"]), \
        ("zamba2's serving CLI run by chain failed", chain)


def phase26_recurrent(smi):
    """Recurrent layers and hybrids (after phase 25): (a) zamba2-7b and
    (b) xlstm-1.3b served by chain at full width (``recurrent_serving``);
    (c) greedy exactness (``recurrent_greedy_exactness``); (d) zamba2 at
    int8 (``zamba_int8``); (e) 2 TVD++ steps of zamba2's drafter against
    the full-width target at 2 x 1024, V 32000 (``tvdpp_steps``); (f) the
    serving CLI's --tree refusal (``recurrent_tree_refusal``; its chain
    run goes in a CliPool, ``check_recurrent_cli``). Returns the launches
    of (d) and (e)."""
    serving = {arch: recurrent_serving(arch, phase, smi)
               for arch, phase in ((ZAMBA, "26a"), (XLSTM, "26b"))}
    out, ok = recurrent_greedy_exactness()
    emit({"phase": "26c", "temperature": 0.0, "gamma": 3, "runs": out})
    assert ok, ("recurrent greedy tokens differ from AR", out)
    quant = zamba_int8(smi)
    distill = tvdpp_steps(ZAMBA, "26e", smi)
    tree = recurrent_tree_refusal()
    emit({"phase": "26f", "cli": {"tree": tree}, "serving": serving,
          "nvidia_smi": smi})
    assert tree["refused"], ("zamba2's serving CLI did not refuse --tree", tree)
    return {**distill, "quant_matmul_int8": quant}


MG = "musicgen-large"
MG_B, MG_P, MG_NEW = 4, 128, 64       # 27a: 4 x (4, 128) + 64 frames
MG_CHECKED = (0, 31, 63)              # 27a: decode steps held to the forward
MG_PROFILED = 4                       # 27a: decode steps under the profiler
# 27a: logits of a decode step against the full forward, both bf16 through
# 48 layers whose matmuls differ in shape (M 4 against M 768) and so in
# their sums' order: relative L2 of a step's (B, K, V) logits
MG_TOL_REL = 5e-2
# 27b: float32 weights, gradients and two AdamW moments are 16 B a
# parameter, and the functional update builds new moments and weights
# (12 B more) beside the clipped gradients (4 B) before the old state is
# freed: 32 B a parameter, 104 GB at 48 layers. At 32 layers (2.18B
# parameters) 70 GB, plus remat activations of 1 x (4, 1024) tokens.
MG_TRAIN = dict(batch=1, seq=1024, layers=32)
MG_ARG_TOL = 1e-2                     # 27c: argument bytes against the card
DRYRUN_CLI = ((MG, "decode_32k"), ("yi-9b", "train_4k"))


def start_cli_procs():
    """27c: the dry-run CLI for each of ``DRYRUN_CLI`` in a subprocess of
    its own."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return {f"{arch} x {shape}": subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=ROOT, env=env) for arch, shape in DRYRUN_CLI}


# 28c: the dry run's sharded trace of 27a's decode step on a (1, 1) mesh over
# the fake backend, in a process of its own (one default group a process:
# phase 28's NCCL group is this one's)
ONE_CARD_TRACE = """
import json, sys
sys.path.insert(0, "src")
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
B, L = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("fake", rank=0, world_size=1, store=FakeStore())
r = dryrun.run_cfg(get_config("musicgen-large"),
                   ShapeConfig(f"decode_{L}", L, B, "decode"),
                   make_mesh((1, 1), ("data", "model")), profile="optimized")
print(json.dumps({k: r[k] for k in ("memory", "collectives",
                 "collective_bytes_per_chip", "t_collective_s",
                 "argument_bytes_per_rank", "sharded_trace_s")}))
"""


def start_dryrun_clis():
    """27c's dry-run CLIs and 28c's one-card sharded trace, each in a
    subprocess of its own (no card: they run on the host's cores beside
    phases 27, 28, 7, 10 and 21, which assert no host timing)."""
    procs = start_cli_procs()
    procs["one_card_trace"] = subprocess.Popen(
        [sys.executable, "-c", ONE_CARD_TRACE, str(MG_B), str(MG_P + MG_NEW)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    # a phase that fails before 27 collects them must not leave them running
    atexit.register(lambda: [p.kill() for p in list(procs.values())
                             if p.poll() is None])
    return procs


def finish_one_card_trace(proc, timeout=300):
    """28c's trace result (None, with its error printed, if it failed)."""
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, stderr = proc.communicate()
    lines = stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        emit({"phase": "28c", "one_card_trace_rc": proc.returncode,
              "stderr": stderr[-1500:]})
        return None
    return json.loads(lines[-1])


def finish_dryrun_clis(procs, timeout=300):
    """Each CLI's exit code and the numbers of its JSON line; every one
    must exit 0 without initialising CUDA."""
    out, ok = {}, True
    for name, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        lines = stdout.strip().splitlines()
        rec = json.loads(lines[-1]) if proc.returncode == 0 and lines else {}
        # 28c: the sharded trace's collective term and one rank's memory
        good = proc.returncode == 0 and rec.get("ok") and \
            rec.get("cuda_initialized") is False and \
            rec.get("t_collective_s") is not None and \
            (rec.get("memory") or {}).get("peak_bytes", 0) > 0
        ok &= bool(good)
        out[name] = {"rc": proc.returncode, **{k: rec.get(k) for k in (
            "chips", "flops_per_chip", "counted_flops_per_chip",
            "counted_over_analytic", "hbm_bytes_per_chip", "t_compute_s",
            "t_memory_s", "t_collective_s", "collective_bytes_per_chip",
            "collectives", "memory", "bottleneck", "useful_flops_ratio",
            "argument_bytes_per_rank", "fits_one_card", "trace_s",
            "sharded_trace_s", "host_peak_rss_gb", "cuda_initialized")}}
        if not good:
            out[name]["stderr"] = stderr[-1500:]
    return out, ok


def codebook_decode(smi):
    """27a and the in-process half of 27c: MusicGen-large with its four
    codebooks at published width in bf16 from seed 0; prefill of 4 x (4,
    128), 64 greedy decode steps of 4 ids a row, the checked steps' logits
    against a full forward of the same ids; ms a step, frames/s, the
    device ms of a step (torch.profiler) against the dry run's memory term
    for B 4 and a cache of 192 on one card; then the dry run's argument
    bytes against the memory the params and cache took, and its counted
    FLOPs against FlopCounterMode on the real step."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, serve
    from repro_torch.models.model import Model
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode
    cfg = get_config(MG)
    K, V, L = cfg.num_codebooks, cfg.vocab_size, MG_P + MG_NEW
    model = Model(cfg, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = model.init(0)                                   # bf16
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated() - base
    cache = model.init_cache(MG_B, L)
    grown = torch.cuda.memory_allocated() - base
    shape = ShapeConfig(f"decode_{L}", L, MG_B, "decode")
    dry = dryrun.run_cfg(cfg, shape, dryrun.OneCard, profile="optimized")
    prompt = torch.as_tensor(
        np.random.default_rng(0).integers(0, V, (MG_B, K, MG_P)),
        device=model.device)
    steps_s = {}
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, prompt, cache_len=L)
    torch.cuda.synchronize()
    steps_s["prefill"] = time.perf_counter() - t0
    nxt = logits[:, -1].argmax(-1)[..., None]                # (B, K, 1)
    frames, checked = [], {}
    pos = torch.full((MG_B, 1), MG_P, dtype=torch.int32, device=model.device)
    t0 = time.perf_counter()
    for t in range(MG_NEW):
        frames.append(nxt)
        logits, cache = model.decode_step(params, nxt, pos + t, cache)
        if t in MG_CHECKED:
            checked[t] = logits[:, 0]
        nxt = logits[:, -1].argmax(-1)[..., None]
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    # 28c: the memory of one more step (the last slot rewritten in place)
    torch.cuda.reset_peak_memory_stats()
    before_step = torch.cuda.memory_allocated()
    model.decode_step(params, frames[-1], pos + MG_NEW - 1, cache)
    torch.cuda.synchronize()
    step_mem = {"before_step_over_base": before_step - base,
                "peak_over_base": torch.cuda.max_memory_allocated() - base,
                "step_growth": torch.cuda.max_memory_allocated() - before_step}
    ids = torch.cat([prompt] + frames, dim=-1)               # (B, K, 192)
    with FlopCounterMode(display=False) as fc:
        model.decode_step(params, frames[0], pos, cache)
    real_flops = fc.get_total_flops()
    full = model.logits(params, ids)                         # (B, 192, K, V)
    errs = {}
    for t, got in checked.items():
        want = full[:, MG_P + t]
        errs[t] = {"rel_l2": float((got - want).norm() / want.norm()),
                   "max_abs": float((got - want).abs().max()),
                   "scale": float(want.abs().max()),
                   "argmax_equal": float((got.argmax(-1) == want.argmax(-1))
                                         .float().mean())}
    ms_step = decode_s * 1e3 / MG_NEW
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for t in range(MG_PROFILED):      # rewrite the last slots in place
            model.decode_step(params, frames[-1], pos + MG_NEW - 1 - t, cache)
        torch.cuda.synchronize()
    breakdown = kernel_breakdown(prof, MG_PROFILED, ms_step)
    device_ms = breakdown.get("device_ms_per_round") or 0.0
    mem_term_ms = dry["t_memory_s"] * 1e3
    held = serve.count_params(params)
    out = {"phase": "27a", "arch": cfg.name, "codebooks": K,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": [cfg.num_heads, cfg.head_dim_], "d_ff": cfg.d_ff,
           "vocab": V, "param_count": cfg.param_count(), "params_held": held,
           "batch": [MG_B, K, MG_P], "decode_steps": MG_NEW,
           "prefill_s": steps_s["prefill"], "ms_per_step": ms_step,
           "frames_per_s": MG_B * MG_NEW / decode_s,
           "device_ms_per_step": device_ms,
           "where_the_time_goes": breakdown,
           "dryrun_memory_term_ms": mem_term_ms,
           "device_over_memory_term": device_ms / mem_term_ms,
           "dryrun_hbm_bytes": dry["hbm_bytes_per_chip"],
           "checked_steps": errs, "tol_rel_l2": MG_TOL_REL,
           "weights_gb": weights / 1e9,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "nvidia_smi": smi}
    emit(out)
    c = {"phase": "27c", "shape": shape.name,
         "dryrun_argument_bytes": dry["argument_bytes_per_rank"],
         "memory_allocated_growth": grown,
         "argument_rel_diff": abs(dry["argument_bytes_per_rank"] - grown) / grown,
         "dryrun_counted_flops": dry["counted_flops_total"],
         "flop_counter_real": real_flops,
         "dryrun_analytic_flops": dry["flops_per_chip"],
         "dryrun_trace_s": dry["trace_s"], "real_step_memory": step_mem}
    assert held == cfg.param_count(), (held, cfg.param_count())
    assert all(torch.isfinite(x).all() for x in checked.values())
    assert all(e["rel_l2"] <= MG_TOL_REL for e in errs.values()), errs
    del params, cache, logits, full, checked, frames
    gc.collect()
    torch.cuda.empty_cache()
    return c


def codebook_train_step(smi):
    """27b: one CE and AdamW step of MusicGen-large at K 4 and published
    width, cut to ``MG_TRAIN["layers"]`` layers, float32 master weights
    and moments, remat, 1 x (4, 1024) tokens from seed 0: ms a step, peak
    GB and the loss (near ln V at init)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models.model import Model
    from repro_torch.training import make_train_state, make_train_step
    cfg = get_config(MG).replace(num_layers=MG_TRAIN["layers"])
    B, S, K, V = MG_TRAIN["batch"], MG_TRAIN["seq"], cfg.num_codebooks, cfg.vocab_size
    model = Model(cfg, "cuda")
    tc = TrainConfig(warmup_steps=1, total_steps=10)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = make_train_state(model, 0, tc)
    state_gb = torch.cuda.memory_allocated() / 1e9
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, V, (B, K, S)),
                           device=model.device)
    labels = torch.full_like(toks, -1)
    labels[..., :-1] = toks[..., 1:]
    before = param_checksum(state["params"]["layers"][0])
    step = make_train_step(model, tc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = step(state, toks, labels)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    loss = float(metrics["loss"])
    moved = param_checksum(state["params"]["layers"][0]) != before
    out = {"phase": "27b", "arch": cfg.name, "layers": cfg.num_layers,
           "params": cfg.param_count(), "tokens": [B, K, S], "remat": cfg.remat,
           "param_dtype": cfg.param_dtype, "ms_per_step": step_s * 1e3,
           "loss": loss, "ln_vocab": math.log(V),
           "grad_norm": float(metrics["grad_norm"]), "moved": moved,
           "state_gb": state_gb,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "nvidia_smi": smi}
    emit(out)
    assert math.isfinite(loss) and abs(loss - math.log(V)) < 1.0, loss
    assert moved, "the parameters did not move"
    del state, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase27_codebooks(smi):
    """MusicGen-large with its four codebooks (after phase 26): (a)
    prefill and greedy decode at published width (``codebook_decode``);
    (b) a training step (``codebook_train_step``); (c) the dry run of (a)'s
    shape against the real params, cache and step (the dry-run CLIs of
    27c run beside, ``finish_dry_runs``). No kernel runs on this path: the
    launches of (a) and (b) must be 0. Returns (c)'s numbers, the real
    step's memory among them for 28c."""
    from repro_torch.kernels import ops
    ops.reset_launches()
    c = codebook_decode(smi)
    codebook_train_step(smi)
    launches = dict(ops.LAUNCHES)
    emit({**c, "launches": launches, "nvidia_smi": smi})
    assert c["argument_rel_diff"] <= MG_ARG_TOL, c
    assert c["dryrun_counted_flops"] == c["flop_counter_real"], c
    assert not any(launches.values()), launches
    return c


def finish_dry_runs(procs, c27, smi):
    """27c's dry-run CLIs (exit 0, CUDA untouched, the collective term and
    a rank's peak printed) and 28c: the one-card sharded trace of 27a's
    decode step held against the growth of max_memory_allocated over the
    real step from before its params."""
    try:
        traced = finish_one_card_trace(procs.pop("one_card_trace"))
    finally:
        clis, ok = finish_dryrun_clis(procs)
    emit({"phase": "27c", "cli": clis, "nvidia_smi": smi})
    assert ok, ("the dry-run CLI failed", clis)
    real = c27["real_step_memory"]
    c = {"phase": "28c", "one_card_trace": traced, "real_step_memory": real,
         "tol_rel": MG_PEAK_TOL}
    if traced:
        mem = traced["memory"]
        c["trace_peak_over_real"] = mem["peak_bytes"] / real["peak_over_base"]
        c["trace_step_over_arguments"] = mem["peak_bytes"] - \
            mem["argument_bytes"]
    emit({**c, "nvidia_smi": smi})
    assert traced is not None, "the one-card sharded trace failed"
    assert abs(c["trace_peak_over_real"] - 1) <= MG_PEAK_TOL, c
    assert traced["collectives"] is not None and \
        traced["t_collective_s"] is not None, traced


# ------------------------------------------------ the sharded step (28)

MESH_MOE_SHAPES = {"verify": (4, 7), "prefill": (1, 512), "decode": (4, 1)}
# 28a: the mesh path against the path without a mesh on the same bf16
# inputs, relative to the latter's max |y|: on a world of one every
# collective is a copy and the local math is the same, so it should be 0
MESH_TOL_REL = 1e-2
MESH_TIMED_ITERS = 20
MESH_DEVICE = "cuda"
# 28c: the one-card sharded trace's peak (arguments included) against the
# growth of max_memory_allocated over the real step from before its
# params, relative
MG_PEAK_TOL = 1e-2


def nccl_world_of_one():
    """An NCCL process group of one rank on this card at a free local
    port, and the (1, 1) mesh named data, model over it."""
    import socket
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    return make_mesh((1, 1), ("data", "model"), "cuda")


def moe_mesh_layer(mesh, smi):
    """28a: granite's MoE layer at published width (d 1536, 40 experts
    top-8 of width 512) in bf16 at cf 1.25 and E/k, through ``moe_ffn``
    with the mesh installed, in the baseline profile at a verify's 28
    tokens and a prefill's 512 (the ZeRO-gather region), in the optimized
    profile at the same (the weight-stationary path at 28, ZeRO-gather at
    512) and at 4 (weight-stationary): y and aux against the path without
    a mesh on the same inputs, the recorder's collective bytes by kind,
    ms with and without the mesh (CUDA events), and the NCCL kernels the
    profiler sees in one call."""
    from repro_torch.configs import get_config
    from repro_torch.launch.collectives import StepRecorder
    from repro_torch.models import moe
    from repro_torch.sharding import context
    from torch.profiler import ProfilerActivity, profile
    full = get_config(GRANITE)
    gen = torch.Generator(device=MESH_DEVICE).manual_seed(28)
    rows, ok = [], True
    for cf in (full.moe_capacity_factor,
               full.num_experts / full.num_experts_per_tok):
        cfg = full.replace(moe_capacity_factor=cf)
        p = moe.init_moe(gen, cfg, torch.bfloat16, MESH_DEVICE)
        for label, (B, S) in MESH_MOE_SHAPES.items():
            x = torch.randn((B, S, cfg.d_model), generator=gen,
                            device=MESH_DEVICE).to(torch.bfloat16)
            want, want_aux = moe.moe_ffn(p, x, cfg)
            plain_ms = cuda_ms(lambda: moe.moe_ffn(p, x, cfg, with_aux=False),
                               iters=MESH_TIMED_ITERS)
            profiles = ("optimized",) if label == "decode" else \
                ("baseline", "optimized")
            for prof in profiles:
                context.set_profile(prof)
                try:
                    with context.use_mesh(mesh, ("data",), "model"):
                        with StepRecorder() as rec:
                            got, aux = moe.moe_ffn(p, x, cfg)
                        mesh_ms = cuda_ms(lambda: moe.moe_ffn(
                            p, x, cfg, with_aux=False), iters=MESH_TIMED_ITERS)
                finally:
                    context.set_profile("baseline")
                scale = float(want.float().abs().max())
                err = float((got.float() - want.float()).abs().max())
                path = ("weight_stationary" if prof == "optimized"
                        and B * S <= 64 else "zero_gather")
                row = {"cf": cf, "tokens": B * S, "shape": [B, S],
                       "profile": prof, "path": path, "max_abs_err": err,
                       "scale": scale, "tol_rel": MESH_TOL_REL,
                       "equal_bits": torch.equal(got, want),
                       "aux_err": abs(float(aux) - float(want_aux)),
                       "collective_bytes": rec.collectives(),
                       "collective_calls": dict(rec.calls),
                       "ms_mesh": mesh_ms, "ms_no_mesh": plain_ms}
                rows.append(row)
                ok &= err <= MESH_TOL_REL * scale and row["aux_err"] <= 1e-5 \
                    and bool(row["collective_bytes"])
        del p
    context.set_profile("baseline")
    x = torch.randn((1, 512, full.d_model), generator=gen,
                    device=MESH_DEVICE).to(torch.bfloat16)
    p = moe.init_moe(gen, full, torch.bfloat16, MESH_DEVICE)
    with context.use_mesh(mesh, ("data",), "model"):
        moe.moe_ffn(p, x, full)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            moe.moe_ffn(p, x, full)
            torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if "nccl" in e.key.lower() or "memcpy" in e.key.lower()})
    out = {"phase": "28a", "arch": full.name, "d_model": full.d_model,
           "experts": full.num_experts, "top_k": full.num_experts_per_tok,
           "expert_d_ff": full.d_ff, "mesh": {"data": 1, "model": 1},
           "backend": "nccl", "rows": rows,
           "nccl_and_copy_kernels_one_call": names, "nvidia_smi": smi}
    emit(out)
    assert ok, ("a mesh path of the MoE layer diverged from the path "
                "without a mesh, or recorded no collective", rows)
    paths = {(r["profile"], r["path"]) for r in rows}
    assert ("optimized", "weight_stationary") in paths and \
        ("baseline", "zero_gather") in paths, paths
    del p, x
    torch.cuda.empty_cache()
    return out


def moe_mesh_serving(mesh):
    """28b: phase 25d's set-up (granite with 2 float32 target layers at cf
    E/k and its drafter at published widths, 2 prompts of 64, 16 greedy
    tokens by tree (2, 2)) served with the mesh installed, in both
    profiles: tokens equal to those without the mesh, and 2 + 4 * 3
    tree_attention launches a round. Returns (the launches, the line)."""
    from repro_torch.configs import get_config
    from repro_torch.core.speculative import SDConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    from repro_torch.sharding import context
    from repro_torch.spectree.round import tree_speculative_generate
    from repro_torch.spectree.tree import TreeSpec
    full = get_config(GRANITE)
    cfg = full.replace(num_layers=2, dtype="float32", moe_capacity_factor=
                       full.num_experts / full.num_experts_per_tok)
    target = Model(cfg, MESH_DEVICE)
    t_params = target.init(0)
    draft = Model(cfg.drafter(), MESH_DEVICE)
    d_params = draft.init(1)
    prompt = torch.as_tensor(serve.make_prompts(2, 64, cfg.vocab_size, seed=5),
                             device=target.device)
    sdc, spec = SDConfig(gamma=3, temperature=0.0), TreeSpec((2, 2))
    plain, _ = tree_speculative_generate(draft, target, d_params, t_params,
                                         prompt, 16, sdc, spec)
    per_round = tree_launches_per_round(target, draft, spec)
    out, launches = {"phase": "28b", "arch": cfg.name, "target_layers": 2,
                     "capacity_factor": cfg.moe_capacity_factor,
                     "per_round": per_round}, 0
    for prof in ("baseline", "optimized"):
        context.set_profile(prof)
        ops.reset_launches()
        try:
            with context.use_mesh(mesh, ("data",), "model"):
                toks, st = tree_speculative_generate(
                    draft, target, d_params, t_params, prompt, 16, sdc, spec)
        finally:
            context.set_profile("baseline")
        got = dict(ops.LAUNCHES)
        out[prof] = {"tokens_equal": torch.equal(toks, plain),
                     "rounds": st.rounds, "launches": got}
        launches += got["tree_attention"]
        assert out[prof]["tokens_equal"], ("tokens with the mesh differ", out)
        assert got == {**{k: 0 for k in got},
                       "tree_attention": st.rounds * per_round}, out
    del target, draft, t_params, d_params
    torch.cuda.empty_cache()
    return launches, out


def phase28_sharded(smi):
    """The sharded step on the card (after phase 27): NCCL refuses two
    ranks on one device, so the mesh paths run on a world of one over
    NCCL, a (1, 1) mesh named data, model: (a) ``moe_mesh_layer``; (b)
    ``moe_mesh_serving``; the group is destroyed at the end. (c) runs in
    ``finish_dry_runs`` once its subprocesses are done. Returns (b)'s
    tree_attention launches."""
    import torch.distributed as dist
    mesh = nccl_world_of_one()
    try:
        moe_mesh_layer(mesh, smi)
        launches, serving = moe_mesh_serving(mesh)
    finally:
        dist.destroy_process_group()
    emit({**serving, "nvidia_smi": smi})
    return launches


ANALYSIS_ENGINE = dict(max_batch=8, prompt_len=32, max_new=96,
                       page_size=16)    # 29b: 8 rows decoding for 19+ rounds


def start_analysis_cli():
    """29c's CLI, every checker on the card, in a process of its own beside
    phases 27 to 7 (started with the dry-run CLIs: those phases assert no
    host timing); one CPU thread (its CPU work is the round audit's fake
    tensors and the tiny engines, on tiny shapes)."""
    out = ROOT / "build" / "analysis.json"
    out.parent.mkdir(exist_ok=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.analysis", "--all", "--json",
         str(out)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, out


def finish_analysis_cli(cli, smi, timeout=600):
    """29c's CLI: exit 0, no error, every checker run on the card."""
    proc, path = cli
    out, _ = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, out[-4000:]
    doc = json.loads(path.read_text())
    assert doc["num_errors"] == 0 and set(doc["checkers"]) == {
        "ast", "rounds", "kernels", "recompile"}, doc["checkers"].keys()
    assert doc["device"] != "cpu", doc["device"]
    emit({"phase": "29c", "cli": {
        "num_errors": doc["num_errors"], "num_warnings": doc["num_warnings"],
        "seconds": {k: v["seconds"] for k, v in doc["checkers"].items()},
        "tail": out.strip().splitlines()[-1]}, "nvidia_smi": smi})


def phase29_analysis(models, smi):
    """The static analysis on the card, on phase 3's models: (a) one chain
    round (gamma 3) and one tree round (2, 2) of the full-width pair after
    a warm-up round, each under the sync debug mode "error": no sync, every
    state leaf's shape, dtype and device unchanged, every cache leaf in its
    storage, 44 tree_attention launches in the tree round; (b) the
    continuous engine with 8 slots, chain and tree, warm: a decode round
    makes one fetch and the profiler one Memcpy DtoH, with no other sync,
    and 16 more rounds build and load nothing and grow no allocator
    segment; (c) the kernel lint on the card (every instance's registers,
    shared memory, blocks an SM and spills against Hopper's limits, and
    the launch plans at the swept shapes), 0 errors; the CLI ``python -m
    repro_torch.analysis --all --json`` runs in a subprocess beside phases
    27 to 21 (``start_analysis_cli``, ``finish_analysis_cli``), exit 0."""
    from repro_torch.analysis import round_audit as ra
    from repro_torch.analysis.kernel_lint import run_kernel_lint
    from repro_torch.analysis.recompile import run_sentinel
    from repro_torch.core.speculative import SDConfig
    from repro_torch.launch import serve
    from repro_torch.spectree.tree import TreeSpec
    target, t_params, draft, d_params, _ = models
    sdc = SDConfig(gamma=3, temperature=0.7)
    spec = TreeSpec((2, 2))
    prompts = torch.as_tensor(serve.make_prompts(4, 128, target.cfg.vocab_size),
                              device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(29)
    rounds = {}
    t0 = time.perf_counter()
    for name, s in (("chain", None), ("tree", spec)):
        fs, launches = ra.run_live_audit(draft, target, d_params, t_params,
                                         prompts, sdc, s, gen)
        assert fs.findings == [], fs.format()
        rounds[name] = launches
    per_round = tree_launches_per_round(target, draft, spec)
    assert per_round == 44 and rounds["tree"]["tree_attention"] == 44, rounds
    assert rounds["chain"]["tree_attention"] == 0, rounds
    t_a = time.perf_counter() - t0

    t0 = time.perf_counter()
    engines = {name: ra.warm_engine(target, t_params, draft, d_params, s,
                                    sdc, **ANALYSIS_ENGINE)
               for name, s in (("chain", None), ("tree", spec))}
    sentinel = run_sentinel("cuda", engines)
    assert sentinel.findings == [], sentinel.format()
    for name in engines:
        tr = sentinel.stats[f"{name}_transfers"]
        assert tr["fetches"] == 1 and tr["dtoh_copies"] == 1, tr
        st = sentinel.stats[f"{name}_sentinel"]
        assert st["allocator_after"] == st["allocator_before"], st
        assert st["warm_builds"] == st["warm_loads"] == 0, st
    del engines
    t_b = time.perf_counter() - t0

    t0 = time.perf_counter()
    lint = run_kernel_lint("cuda")
    assert lint.errors == [], lint.format()
    instances = lint.stats["instances"]
    assert len(instances) >= 80, len(instances)
    ring = [r for r in instances if r["symbol"] == HD256_INSTANCE]
    assert len(ring) == 1 and ring[0]["spill_stores"] == 0 \
        and ring[0]["spill_loads"] == 0, ring
    for r in instances:
        print(f"29c {r['library']}: {r['symbol']}: {r['registers']} regs x "
              f"{r['threads']} threads, smem {r['static_smem']} static + "
              f"{r['dynamic_smem']} dynamic B, {r['blocks_per_sm']} blocks/SM, "
              f"local {r['local_bytes']} B, spills {r['spill_stores']}/"
              f"{r['spill_loads']} B", flush=True)
    t_c = time.perf_counter() - t0
    emit({"phase": 29, "live_rounds": {"launches": rounds,
                                        "tree_attention_per_round": per_round},
          "continuous": {k: v for k, v in sentinel.stats.items()},
          "kernel_lint": {"instances": len(instances),
                          "warnings": len(lint.warnings),
                          "max_registers": max(r["registers"]
                                               for r in instances),
                          "max_smem": max(r["static_smem"] + r["dynamic_smem"]
                                          for r in instances),
                          "min_blocks_per_sm": min(r["blocks_per_sm"]
                                                   for r in instances),
                          "spilling": [r["symbol"] for r in instances
                                       if r["spill_stores"]
                                       or r["spill_loads"]]},
          "seconds": {"29a": round(t_a, 3), "29b": round(t_b, 3),
                      "29c": round(t_c, 3)},
          "nvidia_smi": smi})


# the GB of the card each CliPool's runs may hold together: the light
# pool's run beside phases 28 to 21 (phase 27b's 70 GB freed; phase 10's
# build peaks at 35 GB), the wide pool's beside phases 5 to 13 (a few GB;
# 16 GB of the card's 85 left for the slack of estimates and contexts)
LIGHT_CLI_GB, WIDE_CLI_GB = 8, 64


def light_cli_jobs():
    """The CLI runs of the reduced config: phases 14, 15 and 21's training
    CLI and its checkpoint served."""
    return {**train_cli_jobs(), "15": (REDUCED_TREE_CLI, 2, None),
            **{n: job[:3] for n, job in head_cli_jobs().items()
               if n != "21-serve_continuous_tree"}}


def wide_cli_jobs(obs_dir):
    """The CLI runs at full width, the longest first: phase 18's (the
    first's files under obs_dir), 21's continuous run, 23e, 24d, 25f and
    26f's."""
    return {**continuous_cli_jobs(obs_dir),
            "21-serve_continuous_tree":
                head_cli_jobs()["21-serve_continuous_tree"][:3],
            **arch_cli_jobs(((GEMMA, False),), "24d"), **arch_cli_jobs(),
            **arch_cli_jobs(((GRANITE, False),), "25f"),
            "26f-chain": (RECURRENT_CLI, CLI_GB[ZAMBA], None)}


PHASE_SECONDS = {}


def timed(label, fn, *args, **kw):
    """Run one phase and print its seconds on the host clock (the last
    phase's line then says where a failed run stopped)."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    PHASE_SECONDS[label] = round(time.perf_counter() - t0, 3)
    emit({"phase": label, "seconds": PHASE_SECONDS[label]})
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    if os.environ.get("PYTHONHASHSEED") != "0":
        # the chat mix seeds its shared preamble with hash(name) (copied
        # from the reference): fix the hash seed so every run serves the
        # same request stream
        os.execve(sys.executable, [sys.executable, str(Path(__file__).resolve()),
                                   *sys.argv[1:]],
                  {**os.environ, "PYTHONHASHSEED": "0"})
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import serve

    t_start = time.perf_counter()
    smi = timed(1, phase1_device_and_build)
    timings = timed(2, phase2_kernels)
    zamba_m4 = timings.pop("quant_matmul_int8_zamba2_m4")
    models = timed("build", serve.build_models, "llama2-7b-chat", False, "cuda")
    launches, _ = timed(3, phase3_tree_serving, models, smi)
    chain_launches = timed(4, phase4_chain_serving, models, smi)
    # the reference never dispatches flash decode on its serving path
    serving_fd = launches["flash_decode"] + chain_launches["flash_decode"]
    assert serving_fd == 0, serving_fd
    launches["flash_decode"], fd_timing = timed(12, phase12_flash_decode,
                                                models, smi)
    timings.update(fd_timing)
    continuous = timed(16, phase16_continuous_serving, models, smi)
    head_launches = timed(19, phase19_head_serving, models, smi)
    timed(22, phase22_observability, models, smi)
    timed(29, phase29_analysis, models, smi)
    del models
    gc.collect()        # the engines' reference cycles still hold the pair
    torch.cuda.empty_cache()
    arch_launches = timed(23, phase23_archs, smi)
    gc.collect()
    torch.cuda.empty_cache()
    arch_launches += timed(24, phase24_gemma, smi)
    gc.collect()
    torch.cuda.empty_cache()
    moe_tree, moe_launches = timed(25, phase25_moe, smi)
    arch_launches += moe_tree
    gc.collect()
    torch.cuda.empty_cache()
    rec_launches = timed(26, phase26_recurrent, smi)
    torch.cuda.empty_cache()
    dry_procs = start_dryrun_clis()     # 27c/28c: beside phases 27 to 21
    analysis_cli = start_analysis_cli()     # 29c: likewise
    c27 = timed(27, phase27_codebooks, smi)
    torch.cuda.empty_cache()
    # the reduced config's CLI runs (phases 14, 15, 21) beside phases 28 to
    # 21, after 27's 70 GB; they are read after phase 13
    light = CliPool(light_cli_jobs(), slots=2, budget_gb=LIGHT_CLI_GB)
    sharded_tree = timed(28, phase28_sharded, smi)
    torch.cuda.empty_cache()
    launches.update({k: v for k, v in timed(7, phase7_training, smi).items()
                     if k in ("row_logsumexp", "loss_terms", "loss_grad")})
    torch.cuda.empty_cache()
    for weights in ("int8", "int4"):
        launches[f"quant_matmul_{weights}"] = timed(
            f"10-{weights}", phase10_quant_serving, smi, weights)
        torch.cuda.empty_cache()
    timed(21, phase21_head_training, smi)
    torch.cuda.empty_cache()
    timed("27c-28c", finish_dry_runs, dry_procs, c27, smi)
    timed("29c", finish_analysis_cli, analysis_cli, smi)
    # the full-width CLI runs (phases 18, 21, 23e, 24d, 25f, 26f) beside
    # phases 5 to 13, which hold a few GB of the card and assert no host
    # timing; phases 6 and 9 time kernels after both pools have ended
    obs_dir = tempfile.TemporaryDirectory()
    wide = CliPool(wide_cli_jobs(Path(obs_dir.name)), slots=3,
                   budget_gb=WIDE_CLI_GB)
    timed(5, phase5_greedy_exactness)
    torch.cuda.empty_cache()
    cont_exact = timed(17, phase17_continuous_greedy_exactness)
    torch.cuda.empty_cache()
    timed(20, phase20_head_greedy_exactness)
    torch.cuda.empty_cache()
    timed(8, phase8_float32_routes)
    torch.cuda.empty_cache()
    timed(11, phase11_quant_greedy_exactness)
    torch.cuda.empty_cache()
    timed(13, phase13_pipeline, smi)
    torch.cuda.empty_cache()
    timed(14, phase14_train_cli, smi, light)
    timed(15, phase15_reduced_tree_cli, smi, light)
    timed("21-cli", check_head_clis, smi, {
        **light.wait(["21-train", "21-serve_tree"]),
        **wide.wait(["21-serve_continuous_tree"])})
    timed(18, phase18_continuous_cli, smi, wide, obs_dir)
    timed("23e", check_arch_clis, smi, wide)
    timed("24d", check_arch_clis, smi, wide, ((GEMMA, False),), "24d")
    timed("25f", check_arch_clis, smi, wide, ((GRANITE, False),), "25f")
    timed("26f", check_recurrent_cli, smi, wide)
    timings.update(timed(6, phase6_distill_kernels))
    # phase 9 runs last: after its M 512 timings the host dispatched phase
    # 10's rounds 1.7 times slower on an H100 host (PERF.md)
    timings.update(timed(9, phase9_quant_kernels))
    kernels = []
    for name, (route, source, replaces) in KERNEL_ROUTES.items():
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": launches[name],
                        **timings[name]})
        if name == "flash_decode":      # phase 12's launches; on serving: 0
            kernels[-1]["serving_path_launches"] = serving_fd
        # launches on the continuous path: phase 16's tree pass (tree
        # attention), phase 17's int8-weight engines (quantized matmul)
        kernels[-1]["continuous_path_launches"] = (
            continuous["tree"]["launches"][name] if name == "tree_attention"
            else cont_exact["int8_weights_fp_kv"][name])
        # launches on the draft-head path: phase 19's tree passes (static
        # EAGLE and Medusa, continuous EAGLE); no other kernel runs there
        kernels[-1]["head_path_launches"] = (
            head_launches if name == "tree_attention" else 0)
        # launches on the registry's path: phase 23's Yi-9B, phase 24's
        # Gemma-2-9B and phase 25's granite tree passes (static and
        # continuous); no other kernel runs there
        kernels[-1]["arch_path_launches"] = (
            arch_launches if name == "tree_attention" else 0)
        # launches on the MoE path (phase 25): granite's tree passes
        # (tree attention), its int8 pass (quantized matmul) and its TVD++
        # steps (the distill kernels)
        kernels[-1]["moe_path_launches"] = (
            moe_tree if name == "tree_attention" else moe_launches[name])
        # launches on the recurrent path (phase 26): zamba2's int8 chain
        # (quantized matmul) and TVD++ steps (the distill kernels); its
        # chain and AR rounds in bf16 launch none
        kernels[-1]["recurrent_path_launches"] = rec_launches.get(name, 0)
        # launches on the sharded path (phase 28b): granite's tree passes
        # with the mesh of one installed; no other kernel runs there
        kernels[-1]["sharded_path_launches"] = (
            sharded_tree if name == "tree_attention" else 0)
        if name == "quant_matmul_int8":
            kernels[-1]["zamba2_m4"] = zamba_m4
    emit({"phase": "done", "wall_s": time.perf_counter() - t_start,
          "phase_seconds": PHASE_SECONDS})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
