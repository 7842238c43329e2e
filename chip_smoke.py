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
     and chain tokens must equal the target's greedy tokens.
Then the ``kernels`` line, the card's name and power limit as nvidia-smi
gives them, and last ``{"ok": true, "device": ...}``. Any failure raises
and ends the run with a non-zero exit code and no result line.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}   # dense, 700 W
# max abs error against the plain version: both sum fp32 products in
# another order; bf16 inputs carry 8 bits of mantissa, so their bound is
# set by the working type
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
KERNEL_ROUTES = {   # name -> (route, source, TPU kernel it replaces)
    "tree_attention": ("cuda", "src/repro_torch/kernels/csrc/tree_attention.cu",
                       "src/repro/kernels/tree_attention.py:85"),
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
    logs = build.build_all(list(KERNEL_ROUTES))
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
