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

Self-speculative draft heads (``repro_torch.draftheads``) in place of the
drafter model: ``--draft-head {eagle,medusa}`` drafts from the target's own
hidden states, with no second model and no drafter KV cache or pages. It
composes with ``--tree`` and ``--continuous``; ``--head-ckpt`` loads heads
trained by ``launch.train --draft-head`` (or written by the reference),
and without it the heads are drawn from seed 1 (exact at any temperature
by rejection sampling, only with lower acceptance):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b-chat \
      --draft-head eagle --tree --temperature 0.7 [--head-ckpt heads.npz]

Observability of the continuous engine (``obs``; each flag needs
``--continuous``): ``--trace-out`` writes a Chrome/Perfetto trace of the
engine's spans and per-request tracks, ``--metrics-out`` JSONL registry
snapshots and a Prometheus file beside them, ``--time-phases`` the fenced
draft/verify/commit/host split and the roofline-vs-measured report (at
``--peak-gbps``), ``--quality-telemetry`` per-depth TVD and acceptance
with drift detection, ``--flight-record`` post-mortem bundles,
``--slo-ttft-ms``/``--slo-tpot-ms`` burn-rate SLO tracking, and
``--torch-profile DIR`` a torch.profiler trace of the serve loop:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b-chat \
      --reduced --device cpu --continuous --tree --temperature 0.7 \
      --trace-out t.json --metrics-out m.jsonl --time-phases \
      --quality-telemetry --flight-record fr --slo-ttft-ms 500 \
      --slo-tpot-ms 100

Weights are random, drawn from fixed seeds (target 0, drafter 1); a model to
be quantized is drawn in float32, as the reference's parameters are, and its
unquantized leaves are then cast to the compute dtype. ``--reduced`` serves
the small same-family variant (CPU smoke runs).

``--arch`` takes every key of ``configs.ARCHS``. The dense ones are served
(``yi-9b``, ``phi4-mini-3.8b``, ``minitron-4b``, ``chameleon-34b`` with
qk-norm, ``gemma2-9b`` with its sliding-window layers, softcaps and scaled
embeddings, the Llama pair), the mixture-of-experts ones
(``granite-moe-3b-a800m``, ``grok-1-314b``; their drafters are dense, and
``--quant-weights`` leaves the routers and expert banks at full
precision), and ``musicgen-large`` as its single-codebook variant, as the
reference's launcher serves it. The recurrent archs are served by chain
speculation and AR (``zamba2-7b``, Mamba2 with shared attention, and
``xlstm-1.3b``; a recurrent drafter or target is fed one token a call
and rewound by snapshots): ``--tree`` and ``--continuous`` exit with the
reference's refusals (a tree needs a cache slot per node, the paged pool
pages attention only), and ``--quant-weights`` with an mLSTM drafter
exits with the refusal of ROADMAP §3 item 9. As in the reference's
launcher,
there is no long-context flag (``SDConfig.long_context`` is the library's
switch):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b --tree \
      --temperature 0.7 --requests 4 --prompt-len 128 --max-new 64

An MoE layer drops the (token, expert) assignments past its capacity,
which depends on the number of tokens in the call, as in the reference: a
token's output can then depend on its batchmates, so greedy speculative
tokens equal the autoregressive ones only where nothing drops
(``moe_capacity_factor`` = experts / experts per token):

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch granite-moe-3b-a800m --tree --temperature 0.7
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
      --temperature 0.7 --requests 4 --prompt-len 128 --max-new 64
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..checkpoint.io import load_draft_heads
from ..configs import ARCHS, QuantConfig, get_config, reduced
from ..core.datagen import DatagenConfig, generate_distillation_dataset
from ..core.metrics import SDStats, latency_percentiles, mbsu
from ..core.speculative import SDConfig, attention_only
from ..draftheads import HeadConfig, HeadDrafter, is_head_drafter
from ..kernels import ops
from ..models.model import Model
from ..models.transformer import check_config
from ..obs import (MetricsRegistry, SLOConfig, Tracer, acceptance_report,
                   attribution_report, format_acceptance_report,
                   format_attribution, torch_profile)
from ..configs.base import MLSTM
from ..quant import cast_unquantized, params_nbytes, quantize_params
from ..quant.calib import MLSTM_REFUSAL
from ..serving.continuous import ContinuousEngine, check_pageable
from ..serving.engine import Request, ServingEngine
from ..serving.scheduler import ServeRequest
from ..traffic import MIXES, make_mix
from ..spectree.round import TREE_REFUSAL, tree_speculative_generate
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


def serving_config(arch: str, small: bool, note: bool = False):
    """The config the launcher serves for ``arch``: the reduced variant
    with ``small``; a multi-codebook config as its single-codebook variant,
    as the reference's launcher serves it (the engines stream one token id
    per step), printing the reference's note with ``note``."""
    cfg = get_config(arch)
    if small:
        cfg = reduced(cfg)
    if cfg.num_codebooks > 1:
        if note:
            print(f"note: serving single-codebook variant of {cfg.name}")
        cfg = cfg.replace(num_codebooks=1)
    return cfg


def check_paths(cfg, args) -> None:
    """Refuse, before any model is built, what the reference refuses for
    ``cfg``'s target and drafter (``ValueError``): a recurrent model on
    the paged pool (``--continuous``) or in a tree round (``--tree``), and
    quantized mLSTM weights."""
    drafter = None if args.draft_head or args.no_draft else cfg.drafter()
    models = [(cfg, "target")] + ([(drafter, "draft")] if drafter else [])
    if args.continuous:
        for m, name in models:
            check_pageable(m, name)
    if args.tree and not all(attention_only(m) for m, _ in models):
        raise ValueError(TREE_REFUSAL)
    quantized = [drafter] if args.quant_weights and drafter else []
    if args.quant_target:
        quantized.append(cfg)
    for m in quantized:
        if MLSTM in m.layer_pattern:
            raise ValueError(f"{m.name}: {MLSTM_REFUSAL}")


def build_models(arch: str, small: bool, device, quant: QuantConfig = None,
                 quant_target: bool = False, calib_seqs: int = 4,
                 calib_len: int = 16):
    """(target, target params, drafter, drafter params, c) with seeded
    random weights; c is the drafter/target parameter ratio of MBSU.

    With ``quant`` (int8 or int4) both models are drawn in float32, the
    target generates ``calib_seqs`` calibration prompts of ``calib_len``
    tokens, and the drafter (and with ``quant_target`` the target) is
    quantized from its float32 weights; the float32 copies are dropped."""
    cfg = serving_config(arch, small)
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


def build_heads(arch: str, small: bool, device, kind: str,
                medusa_heads: int = 4, ckpt: str = None):
    """(target, target params, head drafter, head params, c) for
    self-speculative serving: the target from seed 0, the heads from seed 1
    or ``ckpt``, matmul weights in the target's compute dtype; c is the
    heads' parameter count over the target's (the embedding and LM head
    are the target's own and not counted)."""
    cfg = serving_config(arch, small)
    target = Model(cfg, device)
    t_params = target.init(0)
    draft = HeadDrafter(HeadConfig.for_target(kind, cfg,
                                              num_medusa_heads=medusa_heads))
    if ckpt:
        d_params = load_draft_heads(ckpt, draft, target.device, cfg.compute_dtype)
    else:
        d_params = draft.init(1, target.device, cfg.compute_dtype)
    return (target, t_params, draft, d_params,
            draft.hc.param_count() / count_params(t_params))


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


def drafter_kw(draft, d_params) -> dict:
    """``ContinuousEngine`` arguments for a drafter model or a head
    drafter."""
    if is_head_drafter(draft):
        return {"draft_heads": draft, "draft_head_params": d_params}
    return {"draft": draft, "draft_params": d_params}


def serve_continuous(target, t_params, draft, d_params, requests,
                     sdc: SDConfig, tree=None, **engine_kw):
    """Serve ``requests`` through a ``ContinuousEngine`` sized for their
    longest prompt + max_new; ``draft`` is a drafter model or a head
    drafter. Returns (engine, results)."""
    max_seq = max(len(r.prompt) + r.max_new_tokens for r in requests)
    engine = ContinuousEngine(target=target, target_params=t_params, sd=sdc,
                              tree=tree, max_seq_len=max_seq,
                              **drafter_kw(draft, d_params), **engine_kw)
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


def print_observability(engine, results, depth: int, drafter_cfg,
                        args) -> None:
    """The reference CLI's observability reports of a continuous run:
    quality summary, accept-vs-entropy curve, per-tenant lines, acceptance
    report, SLO summary, flight recorder, phase split and roofline
    attribution (with the per-phase device ms on the card), then the
    metrics and trace files."""
    if engine.quality_stats is not None:
        q = engine.quality_stats
        print("  " + q.summary().replace("\n", "\n  "))
        curve = " ".join(
            f"H<={hi:g}:{rate:.2f}(tvd {tv:.2f})" if np.isfinite(hi)
            else f"H>4:{rate:.2f}(tvd {tv:.2f})"
            for hi, _, rate, tv in q.acceptance_entropy_curve())
        print(f"  accept-vs-entropy: {curve or 'none'}")
        for tenant, ts in sorted(engine.tenant_quality.items()):
            if tenant:
                print(f"  tenant {tenant}: accept={ts.accept_rate:.3f} "
                      f"mean_tvd={ts.mean_tvd:.3f} "
                      f"alarms={ts.drift_alarms}")
        print("  " + format_acceptance_report(
            acceptance_report(q, depth)).replace("\n", "\n  "))
    if engine.slo_tracker is not None:
        print("  " + engine.slo_tracker.summary().replace("\n", "\n  "))
    if engine.recorder is not None:
        rc = engine.recorder
        print(f"  flight recorder: {rc.rounds_seen} rounds ringed "
              f"(cap {rc.capacity}), {len(rc.triggers)} triggers, "
              f"{len(rc.dumped_paths)} bundles in {rc.out_dir}/")
    if args.time_phases:
        print(f"  {engine.phases.summary()}")
        if engine.phase_device_ms:
            dev = " ".join(f"{k}={v:.1f}ms"
                           for k, v in engine.phase_device_ms.items())
            print(f"  phase device span (CUDA events): {dev}")
        rep = attribution_report(
            engine.phases, engine.target.cfg, drafter_cfg,
            batch=max(int(round(engine.telemetry.mean_active_rows)), 1),
            ctx=engine.max_seq_len // 2, gamma=depth,
            weights=args.quant_weights or engine.target.cfg.dtype,
            kv="int8" if args.quant_kv else engine.target.cfg.dtype,
            peak_gbps=args.peak_gbps)
        print("  " + format_attribution(rep).replace("\n", "\n  "))
    registry = engine.registry
    if registry is not None:
        pooled = SDStats()
        for r in results:
            pooled.merge(engine.stats[r.request_id].sd)
        pooled.emit(registry, prefix="sd_pooled")
    if args.metrics_out:
        engine.finalize_metrics()
        prom = args.metrics_out + ".prom"
        with open(prom, "w") as f:
            f.write(registry.to_prometheus())
        print(f"  metrics: {args.metrics_out} (JSONL) + {prom} "
              "(Prometheus exposition)")
    if engine.tracer is not None:
        engine.tracer.write(args.trace_out)
        print(f"  trace: {args.trace_out} ({len(engine.tracer.events())} "
              "events — load at https://ui.perfetto.dev)")
    if args.torch_profile:
        print(f"  torch.profiler trace: {args.torch_profile}/")


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
    ap.add_argument("--draft-head", choices=("eagle", "medusa"), default=None,
                    help="self-speculative draft heads in place of the "
                         "drafter model")
    ap.add_argument("--medusa-heads", type=int, default=4,
                    help="number of parallel Medusa heads (offsets +1..+K)")
    ap.add_argument("--head-ckpt", default=None,
                    help="head checkpoint from launch.train --draft-head")
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
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace-event JSON of the "
                         "run (per-request lifecycle + engine spans)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="append periodic metrics-registry JSONL snapshots; "
                         "final Prometheus exposition goes to PATH.prom")
    ap.add_argument("--time-phases", action="store_true",
                    help="fenced round phases: print the draft/verify/"
                         "commit/host wall-time split and the "
                         "roofline-vs-measured report (serializes host and "
                         "card; measurement mode, not serving mode)")
    ap.add_argument("--peak-gbps", type=float, default=None,
                    help="peak memory bandwidth for the achieved-MBU "
                         "estimate in the --time-phases report")
    ap.add_argument("--torch-profile", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the serve loop "
                         "into DIR (Chrome/Perfetto viewable)")
    ap.add_argument("--quality-telemetry", action="store_true",
                    help="per-depth TVD/entropy/acceptance analytics + "
                         "drafter-drift detection (draws no random numbers; "
                         "rides the round's one device-to-host copy)")
    ap.add_argument("--flight-record", nargs="?", const="flight",
                    default=None, metavar="DIR",
                    help="bounded per-round flight recorder; dumps a JSON "
                         "post-mortem bundle into DIR (default ./flight) on "
                         "drift alarm, SLO breach, or crash")
    ap.add_argument("--slo-ttft-ms", type=float, default=None,
                    help="TTFT SLO threshold; arms multi-window burn-rate "
                         "alerting (needs --slo-tpot-ms too)")
    ap.add_argument("--slo-tpot-ms", type=float, default=None,
                    help="TPOT SLO threshold; arms multi-window burn-rate "
                         "alerting (needs --slo-ttft-ms too)")
    args = ap.parse_args(argv)
    for flag, val in (("--trace-out", args.trace_out),
                      ("--metrics-out", args.metrics_out),
                      ("--time-phases", args.time_phases),
                      ("--peak-gbps", args.peak_gbps),
                      ("--torch-profile", args.torch_profile),
                      ("--quality-telemetry", args.quality_telemetry),
                      ("--flight-record", args.flight_record),
                      ("--slo-ttft-ms", args.slo_ttft_ms),
                      ("--slo-tpot-ms", args.slo_tpot_ms)):
        if val and not args.continuous:
            ap.error(f"{flag} instruments the continuous engine; add "
                     "--continuous")
    if (args.slo_ttft_ms is None) != (args.slo_tpot_ms is None):
        ap.error("--slo-ttft-ms and --slo-tpot-ms come as a pair (burn "
                 "rates are tracked per metric over the same windows)")
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
    if args.draft_head is not None:
        if args.no_draft:
            raise SystemExit("--draft-head and --no-draft are exclusive")
        if args.quant_weights is not None:
            raise SystemExit("--quant-weights applies to the separate "
                             "drafter model; not supported with --draft-head")
    elif args.head_ckpt is not None:
        ap.error("--head-ckpt requires --draft-head")

    try:        # what the port or the reference refuses exits with its reason
        cfg = serving_config(args.arch, args.reduced, note=True)
        check_config(cfg)
        check_paths(cfg, args)
    except ValueError as e:
        raise SystemExit(str(e))
    quant = (QuantConfig(weights=args.quant_weights,
                         group_size=args.quant_group)
             if args.quant_weights else None)
    if args.draft_head is not None:
        target, t_params, draft, d_params, c = build_heads(
            args.arch, args.reduced, args.device, args.draft_head,
            args.medusa_heads, args.head_ckpt)
        draft_name = f"{args.draft_head}-head"
    else:
        target, t_params, draft, d_params, c = build_models(
            args.arch, args.reduced, args.device, quant, args.quant_target,
            args.calib_seqs, args.prompt_len)
        draft_name = draft.cfg.name
    print(f"arch={target.cfg.name} draft={draft_name} c={c:.4f} "
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
        with torch_profile(args.torch_profile):
            engine, results = serve_continuous(
                target, t_params, draft, d_params, reqs, sdc, spec,
                max_batch=args.max_batch, page_size=args.page_size,
                prefill_chunk=args.prefill_chunk, policy=args.policy,
                aging_s=args.aging_s, kv_quant=args.quant_kv,
                prefix_cache=args.prefix_cache,
                tracer=Tracer() if args.trace_out else None,
                registry=(MetricsRegistry()
                          if args.metrics_out or args.time_phases else None),
                time_phases=args.time_phases, metrics_out=args.metrics_out,
                quality=args.quality_telemetry,
                flight_record=args.flight_record is not None,
                flight_dir=args.flight_record or "flight",
                slo=(SLOConfig(ttft_ms=args.slo_ttft_ms,
                               tpot_ms=args.slo_tpot_ms)
                     if args.slo_ttft_ms is not None else None))
        launches = dict(ops.LAUNCHES)
        depth = spec.depth if spec else args.gamma
        summary = continuous_summary(engine, results, c, depth)
        print_continuous(engine, summary)
        print_observability(engine, results, depth,
                            draft.hc if is_head_drafter(draft) else draft.cfg,
                            args)
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
              f"{stats.tokens_per_s():.1f} tok/s rounds={stats.rounds}")
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
