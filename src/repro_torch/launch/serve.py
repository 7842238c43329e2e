"""Serving launcher of the port: speculative decoding of the arch with its
drafter, on the card unless ``--device cpu`` is given.

Chain speculation through the static-batching engine (the default), or
its autoregressive baseline with ``--no-draft``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b-chat \
      --gamma 3 --requests 4 --prompt-len 128 --max-new 64

Tree speculation (``--tree-depth d --tree-branch k`` builds a uniform
(k,)*d tree; its verify and draft levels run the tree attention kernel):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b-chat \
      --tree --tree-depth 2 --tree-branch 2 --temperature 0.7

Quantized serving (``repro_torch.quant``): ``--quant-weights {int8,int4}``
post-training-quantizes the drafter (AWQ-lite, calibrated on datagen
batches from the target; ``--quant-target`` quantizes the target too), and
every matmul of a quantized model runs the quantized matmul kernel;
``--quant-kv`` turns both KV caches into int8 with per-slot scales:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b-chat \
      --quant-weights int8 --quant-target --quant-kv --tree

Continuous batching (``serving.continuous``): requests arrive over time
(``--arrival-rate``, Poisson; or a ``--traffic-mix`` scenario) and share a
paged KV pool; ``--prefix-cache`` maps shared prompt prefixes read-only
into each request's page table. It composes with ``--tree``,
``--quant-weights`` and ``--quant-kv``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b-chat \
      --continuous --tree --prefix-cache --traffic-mix chat --requests 16 \
      --arrival-rate 4 --max-batch 8 --temperature 0.7

Weights are random, drawn from fixed seeds (target 0, drafter 1); a model to
be quantized is drawn in float32, as the reference's parameters are, and its
unquantized leaves are then cast to the compute dtype. ``--reduced`` serves
the small same-family variant (CPU smoke runs).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..configs import ARCHS, QuantConfig, get_config, reduced
from ..core.datagen import DatagenConfig, generate_distillation_dataset
from ..core.metrics import SDStats, latency_percentiles, mbsu
from ..core.speculative import SDConfig
from ..kernels import ops
from ..models.model import Model
from ..quant import cast_unquantized, params_nbytes, quantize_params
from ..serving.continuous import ContinuousEngine
from ..serving.engine import Request, ServingEngine
from ..serving.scheduler import ServeRequest
from ..traffic import MIXES, make_mix
from ..spectree.round import tree_speculative_generate
from ..spectree.tree import TreeSpec


def count_params(params) -> int:
    if isinstance(params, torch.Tensor):
        return params.numel()
    if isinstance(params, dict):
        params = params.values()
    return sum(count_params(p) for p in params)


def calibration_tokens(target, t_params, n: int, prompt_len: int,
                       seed: int = 0) -> np.ndarray:
    """AWQ calibration batches from the distillation datagen pipeline: the
    target answers ``n`` seed prompts greedily and at temperature 0.7, 16
    response tokens each (the drafter's serving distribution)."""
    seeds = make_prompts(n, prompt_len, target.cfg.vocab_size, seed)
    return generate_distillation_dataset(
        target, t_params, seeds,
        DatagenConfig(temperatures=(0.0, 0.7), max_response_tokens=16,
                      batch_size=n),
        gen=torch.Generator(device=target.device).manual_seed(seed))


def build_models(arch: str, small: bool, device, quant: QuantConfig = None,
                 quant_target: bool = False, calib_seqs: int = 4,
                 calib_len: int = 16):
    """(target, target params, drafter, drafter params, c) with seeded
    random weights; c is the drafter/target parameter ratio of MBSU.

    With ``quant`` (int8 or int4) both models are drawn in float32, the
    target generates ``calib_seqs`` calibration prompts of ``calib_len``
    tokens, and the drafter (and with ``quant_target`` the target) is
    quantized from its float32 weights; the float32 copies are dropped."""
    cfg = get_config(arch)
    if small:
        cfg = reduced(cfg)
    target = Model(cfg, device)
    draft = Model(cfg.drafter().replace(vocab_size=cfg.vocab_size), device)
    if quant is None or quant.bits == 0:
        t_params, d_params = target.init(0), draft.init(1)
        c = count_params(d_params) / count_params(t_params)
        return target, t_params, draft, d_params, c
    t_params = target.init(0, dtype=torch.float32)
    d_params = draft.init(1, dtype=torch.float32)
    c = count_params(d_params) / count_params(t_params)
    calib = calibration_tokens(target, t_params, calib_seqs, calib_len)
    d_params = cast_unquantized(
        quantize_params(draft, d_params, quant, calib_tokens=calib),
        cfg.compute_dtype)
    if quant_target:
        t_params = quantize_params(target, t_params, quant, calib_tokens=calib)
    t_params = cast_unquantized(t_params, cfg.compute_dtype)
    if target.device.type == "cuda":
        torch.cuda.empty_cache()        # the float32 weights are gone
    return target, t_params, draft, d_params, c


def make_prompts(n: int, prompt_len: int, vocab: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return rng.integers(3, vocab, (n, prompt_len)).astype(np.int64)


def serve_tree(target, t_params, draft, d_params, prompts, max_new: int,
               sdc: SDConfig, spec: TreeSpec, seed: int = 0):
    """Batched tree-speculative generation; returns (tokens, SDStats)."""
    gen = torch.Generator(device=target.device).manual_seed(seed)
    prompt = torch.as_tensor(prompts, device=target.device)
    return tree_speculative_generate(draft, target, d_params, t_params, prompt,
                                     max_new, sdc, spec, gen=gen)


def serve_static(target, t_params, draft, d_params, prompts, max_new: int,
                 sdc: SDConfig, seed: int = 0):
    """Chain speculation (or AR when ``draft`` is None) through the
    static-batching engine. Returns (results, tau, tok/s over the wall time
    of the batches, prefill included)."""
    engine = ServingEngine(target=target, target_params=t_params, draft=draft,
                           draft_params=d_params, sd=sdc)
    reqs = [Request(prompt=p, max_new_tokens=max_new, request_id=i)
            for i, p in enumerate(prompts)]
    gen = torch.Generator(device=target.device).manual_seed(seed)
    results = engine.serve(reqs, gen=gen)
    tau = float(np.mean([r.tau for r in results]))
    tok_s = (sum(len(r.tokens) for r in results)
             / max(sum(r.wall_time_s for r in results), 1e-9))
    return results, tau, tok_s


def continuous_requests(n: int, prompt_len: int, max_new: int, vocab: int,
                        arrival_rate: float = 0.0, mixed_lens: bool = False,
                        traffic_mix=None, seed: int = 0):
    """The continuous engine's request stream: a ``traffic`` mix, or random
    prompts of ``prompt_len`` tokens (``mixed_lens``: uniform in
    [prompt_len/2, 2*prompt_len]) arriving as a Poisson process at
    ``arrival_rate`` requests/s (0: all at t = 0)."""
    if traffic_mix is not None:
        return make_mix(traffic_mix).build(n, arrival_rate, vocab, seed=seed)
    rng = np.random.default_rng(seed)
    lens = (rng.integers(max(prompt_len // 2, 1), 2 * prompt_len + 1, n)
            if mixed_lens else np.full(n, prompt_len))
    arrivals = (np.cumsum(rng.exponential(1.0 / arrival_rate, n))
                if arrival_rate > 0 else np.zeros(n))
    return [ServeRequest(prompt=rng.integers(3, vocab, lens[i]).astype(np.int32),
                         max_new_tokens=max_new, request_id=i,
                         arrival_time_s=float(arrivals[i]))
            for i in range(n)]


def serve_continuous(target, t_params, draft, d_params, requests,
                     sdc: SDConfig, tree=None, **engine_kw):
    """Serve ``requests`` through a ``ContinuousEngine`` sized for their
    longest prompt + max_new. Returns (engine, results)."""
    max_seq = max(len(r.prompt) + r.max_new_tokens for r in requests)
    engine = ContinuousEngine(target=target, target_params=t_params,
                              draft=draft, draft_params=d_params, sd=sdc,
                              tree=tree, max_seq_len=max_seq, **engine_kw)
    for r in requests:
        engine.submit(r)
    return engine, engine.run()


def continuous_summary(engine, results, c: float, depth: int) -> dict:
    """The reference CLI's end-of-run numbers: throughput over the span
    from the engine's start to the last finish, tau and MBSU (mean over
    requests), TTFT/TPOT p50/p99, queue and pool telemetry, prefix-cache
    counters and the pooled per-depth acceptance."""
    tel = engine.telemetry
    stats = [engine.stats[r.request_id] for r in results]
    total_new = sum(s.new_tokens for s in stats)
    span = max(s.finish_time_s for s in stats)
    tau = float(np.mean([s.sd.tau for s in stats]))
    pooled = SDStats()
    for s in stats:
        pooled.merge(s.sd)
    free = np.asarray(tel.free_pages, np.float64)
    out = {"requests": len(results), "tokens": total_new, "span_s": span,
           "tok_s": total_new / span, "tau": tau,
           "mbsu": mbsu(tau, c, depth),
           "ttft_ms": latency_percentiles([s.ttft_s for s in stats]),
           "tpot_ms": latency_percentiles([s.tpot_s for s in stats]),
           "steps": tel.steps, "rounds": tel.decode_rounds,
           "prefill_chunks": tel.prefill_chunks,
           "max_queue": tel.max_queue_depth,
           "mean_active": tel.mean_active_rows,
           "pool_util": (1.0 - float(free.mean()) / (engine.num_pages - 1)
                         if free.size else 0.0),
           "pooled_tau": pooled.tau,
           "depth_acceptance": pooled.depth_acceptance(),
           "accept_hist": dict(sorted(pooled.accept_hist.items()))}
    if engine.prefix is not None:
        ptel = engine.prefix.tel
        out["prefix"] = {"hit_rate": ptel.hit_rate,
                         "tokens_saved_rate": ptel.tokens_saved_rate,
                         "hits": ptel.hits, "lookups": ptel.lookups,
                         "hit_tokens": ptel.hit_tokens,
                         "prompt_tokens": ptel.prompt_tokens,
                         "cow_copies": ptel.cow_copies,
                         "evictions": ptel.evictions,
                         "shared_page_frac": tel.mean_shared_frac}
    return out


def print_continuous(engine, summary: dict):
    s = summary
    print(f"continuous: {s['requests']} requests, {s['tokens']} tokens "
          f"in {s['span_s']:.2f}s -> {s['tok_s']:.1f} tok/s")
    print(f"  tau={s['tau']:.3f} MBSU={s['mbsu']:.3f} "
          f"TTFT p50={s['ttft_ms']['p50_ms']:.0f}ms "
          f"p99={s['ttft_ms']['p99_ms']:.0f}ms "
          f"TPOT p50={s['tpot_ms']['p50_ms']:.0f}ms "
          f"p99={s['tpot_ms']['p99_ms']:.0f}ms")
    print(f"  steps={s['steps']} rounds={s['rounds']} "
          f"prefill_chunks={s['prefill_chunks']} max_queue={s['max_queue']} "
          f"mean_active={s['mean_active']:.2f} pool_util={s['pool_util']:.2f}")
    if engine.prefix is not None:
        print(f"  prefix cache: {engine.prefix.tel.summary()} "
              f"shared_page_frac={s['prefix']['shared_page_frac']:.2f}")
    depth_acc = ", ".join(f"d{d}={r:.2f}"
                          for d, r in s["depth_acceptance"].items())
    print(f"  pooled tau={s['pooled_tau']:.3f} "
          f"per-depth acceptance: {depth_acc or 'none'}")
    hist = " ".join(f"{h}:{n}" for h, n in s["accept_hist"].items())
    print(f"  tokens-per-round histogram: {hist or 'none'}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--gamma", type=int, default=3)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--no-draft", action="store_true", help="AR baseline")
    ap.add_argument("--tree", action="store_true",
                    help="tree-structured speculation")
    ap.add_argument("--tree-depth", type=int, default=2,
                    help="tree levels below the root (chain-gamma analogue)")
    ap.add_argument("--tree-branch", type=int, default=2,
                    help="children per node at every level")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    ap.add_argument("--quant-weights", choices=("int8", "int4"), default=None,
                    help="PTQ the drafter weights (AWQ-lite calibrated)")
    ap.add_argument("--quant-target", action="store_true",
                    help="also quantize the target's weights")
    ap.add_argument("--quant-kv", action="store_true",
                    help="int8 KV caches with per-slot scales")
    ap.add_argument("--quant-group", type=int, default=64,
                    help="int4 scale group along the input dim")
    ap.add_argument("--calib-seqs", type=int, default=4,
                    help="datagen seed sequences for AWQ calibration")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching engine (paged KV + scheduler)")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="Poisson arrivals, requests/sec (0 = all at t=0)")
    ap.add_argument("--mixed-lens", action="store_true",
                    help="sample prompt lengths in [prompt_len/2, 2*prompt_len]")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--policy", choices=("fcfs", "priority"), default="fcfs")
    ap.add_argument("--aging-s", type=float, default=None,
                    help="priority aging: a queued request gains one priority "
                         "class per this many seconds waited")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix prefix cache over the paged KV pool: shared "
                         "prompt prefixes prefill once")
    ap.add_argument("--traffic-mix", choices=sorted(MIXES), default=None,
                    help="replay a traffic scenario mix instead of random "
                         "prompts (continuous only)")
    args = ap.parse_args(argv)
    for flag, val in (("--traffic-mix", args.traffic_mix),
                      ("--prefix-cache", args.prefix_cache),
                      ("--mixed-lens", args.mixed_lens)):
        if val and not args.continuous:
            ap.error(f"{flag} requires --continuous")
    if args.continuous and args.no_draft:
        ap.error("--continuous is speculative-only")
    if args.tree and args.no_draft:
        ap.error("--tree is speculative-only")
    if args.quant_target and args.quant_weights is None:
        ap.error("--quant-target requires --quant-weights {int8,int4}")
    if args.quant_weights is not None and args.no_draft:
        raise SystemExit("--quant-weights applies to the drafter")

    quant = (QuantConfig(weights=args.quant_weights,
                         group_size=args.quant_group)
             if args.quant_weights else None)
    target, t_params, draft, d_params, c = build_models(
        args.arch, args.reduced, args.device, quant, args.quant_target,
        args.calib_seqs, args.prompt_len)
    print(f"arch={target.cfg.name} draft={draft.cfg.name} c={c:.4f} "
          f"device={target.device}")
    if quant is not None:
        print(f"quantized weights={args.quant_weights} "
              f"target={'yes' if args.quant_target else 'no'} "
              f"kv={'int8' if args.quant_kv else 'fp'}; stored bytes: "
              f"target {params_nbytes(t_params)}, "
              f"drafter {params_nbytes(d_params)}")
    sdc = SDConfig(gamma=args.gamma, temperature=args.temperature,
                   kv_quant=args.quant_kv)
    prompts = make_prompts(args.requests, args.prompt_len, target.cfg.vocab_size)
    spec = (TreeSpec((args.tree_branch,) * args.tree_depth) if args.tree
            else None)
    if spec is not None:
        print(f"tree: branching={spec.branching} nodes={spec.num_nodes} "
              f"(chain-equivalent gamma={spec.num_draft_nodes})")

    if args.continuous:
        reqs = continuous_requests(args.requests, args.prompt_len,
                                   args.max_new, target.cfg.vocab_size,
                                   args.arrival_rate, args.mixed_lens,
                                   args.traffic_mix)
        ops.reset_launches()
        engine, results = serve_continuous(
            target, t_params, draft, d_params, reqs, sdc, spec,
            max_batch=args.max_batch, page_size=args.page_size,
            prefill_chunk=args.prefill_chunk, policy=args.policy,
            aging_s=args.aging_s, kv_quant=args.quant_kv,
            prefix_cache=args.prefix_cache)
        launches = dict(ops.LAUNCHES)
        summary = continuous_summary(engine, results, c,
                                     spec.depth if spec else args.gamma)
        print_continuous(engine, summary)
        print(f"kernel launches: {json.dumps(launches)}")
        return

    if spec is not None:
        ops.reset_launches()
        toks, stats = serve_tree(target, t_params, draft, d_params, prompts,
                                 args.max_new, sdc, spec)
        launches = dict(ops.LAUNCHES)
        # MBSU's draft-cost term counts sequential draft passes: a tree
        # round runs depth+1 batched level passes (chain analogue: gamma)
        print(f"tree SD: tau={stats.tau:.3f} "
              f"MBSU={mbsu(stats.tau, c, spec.depth):.3f} "
              f"{stats.tokens_per_s():.1f} tok/s")
        depth_acc = ", ".join(f"d{d}={r:.2f}"
                              for d, r in stats.depth_acceptance().items())
        print(f"  per-depth acceptance: {depth_acc or 'none'}")
        P = args.prompt_len
        for b in range(min(args.requests, 2)):
            row = toks[b, P:P + min(args.max_new, 16)].cpu().numpy()
            print(f"  row {b}: {row} ...")
        print(f"kernel launches: {json.dumps(launches)}")
        return

    ops.reset_launches()
    results, tau, tok_s = serve_static(
        target, t_params, None if args.no_draft else draft,
        None if args.no_draft else d_params, prompts, args.max_new, sdc)
    launches = dict(ops.LAUNCHES)
    print(f"served {len(results)} requests; tau={tau:.3f} "
          f"MBSU={mbsu(tau, c, args.gamma):.3f} {tok_s:.1f} tok/s")
    for r in results[:2]:
        print(f"  req {r.request_id}: {r.tokens[:16]} ... {r.wall_time_s:.2f}s")
    print(f"kernel launches: {json.dumps(launches)}")


if __name__ == "__main__":
    main()
