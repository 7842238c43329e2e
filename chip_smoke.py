"""Smoke run of the PyTorch port on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device and build: the card, then every CUDA kernel of the port built
     from ``src/repro_torch/kernels/csrc`` with nvcc (one process each);
  2. each kernel against its plain PyTorch version on the card, at the
     shapes of the serving path, and its time beside its bound, the plain
     version's and one PyTorch library call's;
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
     pre-scale, and at a ragged shape; then its times at the target's
     shapes at M 16, 28 and 512 beside their bounds, the plain version's,
     the library call's that computes the same function with bf16 scales
     (torch._weight_int8pack_mm, torch._weight_int4pack_mm; held against
     the plain version first), and cuBLAS's bf16 matmul on the unquantized
     weight;
 10. full-width quantized serving: Llama-2-7B-Chat and its drafter drawn in
     float32, AWQ-calibrated on datagen batches of the target, quantized to
     int8 and then to int4 weights, with int8 KV caches; tree (2, 2) and
     chain (gamma 3) at temperature 0.7, the launch counts asserted (each
     forward pass of a quantized model launches the kernel 7 * layers + 1
     times);
 11. greedy exactness under int8 and int4 weights with 2 target layers in
     float32: tree and chain tokens must equal the quantized target's
     greedy tokens.
Phases 10 and 11 run before phase 9. Then the ``kernels`` line, the
card's name and power limit as nvidia-smi gives them, and last ``{"ok":
true, "device": ...}``. Any failure raises and ends the run with a
non-zero exit code and no result line.
"""
import contextlib
import json
import math
import subprocess
import sys
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
    from repro_torch.kernels import build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    logs = build.build_all(sorted({Path(src).stem
                                   for _, src, _ in KERNEL_ROUTES.values()}))
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    emit({"phase": 1, "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "build_s": round(time.perf_counter() - t0, 3), "ptxas": ptxas})
    return smi


def phase2_kernels():
    """Every kernel against its plain version at the serving shapes: target
    verify (Hkv 32, N 7), drafter levels (Hkv 8, N 1/2/4), G 3, a ragged
    cache width (201 = 128 + 64 + 7 + 2) and a tiled one (1024), bf16 and
    f32, once with softcap."""
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
    ]
    results = []
    for label, B, Hkv, N, G, hd, S, dtype, cap in cases:
        q, k, v, mask = tree_inputs(gen, B, Hkv, N, G, hd, S, dtype)
        got = tk.tree_attention(q, k, v, mask, softcap=cap)
        want = ref.ref_tree_attention(q, k, v, mask, softcap=cap)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ok = bool(torch.isfinite(got).all()) and err <= TOL[dtype]
        results.append({"case": label, "B": B, "Hkv": Hkv, "N": N, "G": G,
                        "hd": hd, "S": S, "dtype": str(dtype).split(".")[-1],
                        "softcap": cap, "max_abs_err": err,
                        "tol": TOL[dtype], "ok": ok})
        if not ok:
            emit({"phase": 2, "cases": results})
            raise AssertionError(f"tree_attention disagrees with its plain "
                                 f"version: {results[-1]}")

    # timing at the main path's shape (target verify, bf16, S 201), rotating
    # over enough input sets to exceed the 50 MB L2 as the serving loop does
    sets = [tree_inputs(gen, 4, 32, 7, 1, 128, 201, bf) for _ in range(8)]
    it = iter(range(10 ** 9))

    def rotate(fn):
        return lambda: fn(*sets[next(it) % len(sets)])

    def library(q, k, v, mask):
        B, Hkv, N, G, hd = q.shape
        return torch.nn.functional.scaled_dot_product_attention(
            q.reshape(B, Hkv, N, hd), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask[:, None])

    # device time (graph replay) in turns kernel, plain, library, kernel;
    # then the time per eager call as the serving loop pays it (host
    # launch cost included)
    fns = {"kernel": tk.tree_attention, "plain": ref.ref_tree_attention,
           "library": library}
    dev = {name: graph_ms(rotate(fn)) for name, fn in fns.items()}
    dev["kernel_repeat"] = graph_ms(rotate(tk.tree_attention))
    eager = {name: cuda_ms(rotate(fn), iters=200) for name, fn in fns.items()}
    bound_ms, bound_by = tree_bound_ms(*sets[0])
    emit({"phase": 2, "cases": results,
          "timing_shape": "B4 Hkv32 N7 G1 hd128 S201 bf16, 8 input sets",
          "device_ms": dev, "eager_call_ms": eager,
          "bound_ms": bound_ms, "bound_by": bound_by})
    return {"tree_attention": {"max_abs_err": results[0]["max_abs_err"],
                               "ms": dev["kernel"], "plain_ms": dev["plain"],
                               "bound_ms": bound_ms, "bound_by": bound_by,
                               "library_ms": dev["library"]}}


def phase3_tree_serving(models, smi):
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
                                   64, sdc, spec)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    per_round = target.cfg.num_layers + draft.cfg.num_layers * (spec.depth + 1)
    new = toks[:, 128:128 + 64]
    assert stats.rounds > 0 and launches["tree_attention"] == stats.rounds * per_round, \
        (launches, stats.rounds, per_round)
    assert bool(((new >= 0) & (new < target.cfg.vocab_size)).all()), "token out of vocab"
    assert stats.tau >= 1.0 and math.isfinite(stats.tau), stats.tau
    breakdown = profile_tree(models, prompts, sdc, spec,
                             stats.wall_time_s * 1e3 / stats.rounds)
    emit({"phase": 3, "path": "tree", "arch": target.cfg.name,
          "drafter": draft.cfg.name, "dtype": target.cfg.dtype,
          "requests": 4, "prompt_len": 128, "max_new": 64, "tree": spec.branching,
          "temperature": 0.7, "rounds": stats.rounds, "launches": launches,
          "launches_per_round": per_round, "tau": stats.tau,
          "mbsu": mbsu(stats.tau, c, spec.depth), "c": c,
          "tok_s": stats.tokens_per_s(), "wall_s": stats.wall_time_s,
          "depth_acceptance": stats.depth_acceptance(),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "where_the_time_goes": breakdown, "nvidia_smi": smi})
    return launches


def profile_tree(models, prompts, sdc, spec, wall_ms_per_round):
    """Where a tree round's time goes: device time by kernel over a short
    tree run under torch.profiler, against the unprofiled host time of a
    round. Prints None where the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve
    target, t_params, draft, d_params, _ = models
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, stats = serve.serve_tree(target, t_params, draft, d_params, prompts,
                                    16, sdc, spec, seed=2)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in kernels)
    if not kernels or total_us <= 0:
        return {"profiled": None}
    per_round_ms = total_us / 1e3 / stats.rounds
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]

    def share(pred):
        return sum(e.self_device_time_total for e in kernels if pred(e.key)) / total_us

    return {"profiled_rounds": stats.rounds,
            "device_ms_per_round": per_round_ms,
            "wall_ms_per_round_unprofiled": wall_ms_per_round,
            "device_busy_share": per_round_ms / wall_ms_per_round,
            "share_tree_attention": share(lambda k: "tree_attention" in k),
            "share_quant_matmul": share(lambda k: "quant_matmul" in k),
            # cuBLAS matmuls: nvjet_* (its JIT kernels), *gemm*, *xmma*
            "share_matmul": share(lambda k: any(w in k.lower() for w in
                                                ("nvjet", "gemm", "xmma"))),
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def phase4_chain_serving(models, smi):
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
                                             prompts, 64, sdc)
    chain_launches = dict(ops.LAUNCHES)
    _, _, ar_tok_s = serve.serve_static(target, t_params, None, None, prompts,
                                        64, sdc)
    for r in results:
        assert len(r.tokens) == 64 and ((r.tokens >= 0)
                                        & (r.tokens < target.cfg.vocab_size)).all()
    assert tau >= 1.0 and math.isfinite(tau), tau
    emit({"phase": 4, "path": "chain", "gamma": 3, "temperature": 0.7,
          "tau": tau, "mbsu": mbsu(tau, c, 3), "tok_s": tok_s,
          "ar_tok_s": ar_tok_s, "launches": chain_launches,
          "note": "tok/s over each batch's wall time, prefill included",
          "nvidia_smi": smi})


def phase5_greedy_exactness():
    from repro_torch.configs import get_config
    from repro_torch.core.speculative import (SDConfig, autoregressive_generate,
                                              speculative_generate)
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.launch import serve
    from repro_torch.spectree.round import tree_speculative_generate
    from repro_torch.spectree.tree import TreeSpec
    cfg = get_config("llama2-7b-chat").replace(num_layers=2, dtype="float32")
    target = Model(cfg, "cuda")
    t_params = target.init(0)
    draft = Model(cfg.drafter(), "cuda")
    d_params = draft.init(1)
    P, M = 64, 32
    prompt = torch.as_tensor(serve.make_prompts(2, P, cfg.vocab_size, seed=5),
                             device="cuda")
    sdc = SDConfig(gamma=3, temperature=0.0)
    ar, _ = autoregressive_generate(target, t_params, prompt, M, temperature=0.0)
    chain, _ = speculative_generate(draft, target, d_params, t_params, prompt,
                                    M, sdc)
    spec = TreeSpec((2, 2))
    ops.reset_launches()
    tree, tstats = tree_speculative_generate(draft, target, d_params, t_params,
                                             prompt, M, sdc, spec)
    launches = ops.LAUNCHES["tree_attention"]
    per_round = cfg.num_layers + draft.cfg.num_layers * (spec.depth + 1)
    ok_chain = torch.equal(chain[:, :P + M], ar)
    ok_tree = torch.equal(tree[:, :P + M], ar)
    emit({"phase": 5, "arch": cfg.name, "target_layers": 2, "dtype": "float32",
          "temperature": 0.0, "chain_equals_ar": ok_chain,
          "tree_equals_ar": ok_tree, "tree_launches": launches,
          "tree_rounds": tstats.rounds, "tree_tau": tstats.tau})
    assert ok_chain and ok_tree, "speculative greedy tokens differ from AR"
    assert launches == tstats.rounds * per_round, (launches, tstats.rounds)

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
    per_step = {"tree_attention": 0, "row_logsumexp": 6 * n,
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
    library call that computes the same function (at the decode shapes;
    torch._weight_int8pack_mm or torch._weight_int4pack_mm, bf16 scales),
    and cuBLAS's bf16 matmul on an unquantized weight of the same shape,
    each over enough weight sets to exceed the L2. The library call is
    first held against the plain version. M 512 (prefill) is bound by
    operations and slow on the CUDA cores: 10 calls a graph."""
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
        if M <= 28:
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
                      "timed_at": [M for M in Ms if M <= 28]}
    return out


def phase9_quant_kernels():
    """The quantized matmul against its plain version in every case (every
    (K, N) of both models at every M of phase 10), then its device times at
    the target's shapes at M 16, 28 and 512."""
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
    timing = {f"int{bits}:{name}": time_quant_shape(gen, K, N, bits)
              for name, K, N in QUANT_SHAPES["target"] for bits in (8, 4)}
    emit({"phase": 9, "cases": n_cases, "all_ok": True, "M": rows,
          "worst_rel_err": {f"int{b}/{d}": e for (b, d), e in worst.items()},
          "worst_rel_err_by_M": worst_m, "tolerance_rel": QUANT_TOL,
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


def quant_passes(cfg) -> int:
    """Quantized matmul launches per forward pass: 7 per layer + lm head."""
    return 7 * cfg.num_layers + 1


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
    B, P, NEW = QUANT_B, QUANT_P, 64
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import serve

    t_start = time.perf_counter()
    smi = phase1_device_and_build()
    timings = phase2_kernels()
    models = serve.build_models("llama2-7b-chat", False, "cuda")
    launches = phase3_tree_serving(models, smi)
    phase4_chain_serving(models, smi)
    del models
    torch.cuda.empty_cache()
    phase5_greedy_exactness()
    torch.cuda.empty_cache()
    timings.update(phase6_distill_kernels())
    launches.update({k: v for k, v in phase7_training(smi).items()
                     if k != "tree_attention"})
    torch.cuda.empty_cache()
    phase8_float32_routes()
    torch.cuda.empty_cache()
    # phase 9 runs last: after its M 512 timings the host dispatched phase
    # 10's rounds 1.7 times slower on an H100 host (PERF.md)
    for weights in ("int8", "int4"):
        launches[f"quant_matmul_{weights}"] = phase10_quant_serving(smi, weights)
        torch.cuda.empty_cache()
    phase11_quant_greedy_exactness()
    torch.cuda.empty_cache()
    timings.update(phase9_quant_kernels())
    kernels = []
    for name, (route, source, replaces) in KERNEL_ROUTES.items():
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": launches[name],
                        **timings[name]})
    emit({"phase": "done", "wall_s": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
