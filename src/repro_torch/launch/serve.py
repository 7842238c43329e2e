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
from ..core.metrics import mbsu
from ..core.speculative import SDConfig
from ..kernels import ops
from ..models.model import Model
from ..quant import cast_unquantized, params_nbytes, quantize_params
from ..serving.engine import Request, ServingEngine
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
    args = ap.parse_args(argv)
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

    if args.tree:
        spec = TreeSpec((args.tree_branch,) * args.tree_depth)
        print(f"tree: branching={spec.branching} nodes={spec.num_nodes} "
              f"(chain-equivalent gamma={spec.num_draft_nodes})")
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
