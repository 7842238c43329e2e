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

Weights are random, drawn from fixed seeds (target 0, drafter 1).
``--reduced`` serves the small same-family variant (CPU smoke runs).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import ARCHS, get_config, reduced
from ..core.metrics import mbsu
from ..core.speculative import SDConfig
from ..models.model import Model
from ..serving.engine import Request, ServingEngine
from ..spectree.round import tree_speculative_generate
from ..spectree.tree import TreeSpec


def count_params(params) -> int:
    if isinstance(params, torch.Tensor):
        return params.numel()
    if isinstance(params, dict):
        params = params.values()
    return sum(count_params(p) for p in params)


def build_models(arch: str, small: bool, device):
    """(target, target params, drafter, drafter params, c) with seeded
    random weights; c is the drafter/target parameter ratio of MBSU."""
    cfg = get_config(arch)
    if small:
        cfg = reduced(cfg)
    target = Model(cfg, device)
    t_params = target.init(0)
    draft = Model(cfg.drafter().replace(vocab_size=cfg.vocab_size), device)
    d_params = draft.init(1)
    c = count_params(d_params) / count_params(t_params)
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
    args = ap.parse_args(argv)
    if args.tree and args.no_draft:
        ap.error("--tree is speculative-only")

    target, t_params, draft, d_params, c = build_models(
        args.arch, args.reduced, args.device)
    print(f"arch={target.cfg.name} draft={draft.cfg.name} c={c:.4f} "
          f"device={target.device}")
    sdc = SDConfig(gamma=args.gamma, temperature=args.temperature)
    prompts = make_prompts(args.requests, args.prompt_len, target.cfg.vocab_size)

    if args.tree:
        spec = TreeSpec((args.tree_branch,) * args.tree_depth)
        print(f"tree: branching={spec.branching} nodes={spec.num_nodes} "
              f"(chain-equivalent gamma={spec.num_draft_nodes})")
        toks, stats = serve_tree(target, t_params, draft, d_params, prompts,
                                 args.max_new, sdc, spec)
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
        return

    results, tau, tok_s = serve_static(
        target, t_params, None if args.no_draft else draft,
        None if args.no_draft else d_params, prompts, args.max_new, sdc)
    print(f"served {len(results)} requests; tau={tau:.3f} "
          f"MBSU={mbsu(tau, c, args.gamma):.3f} {tok_s:.1f} tok/s")
    for r in results[:2]:
        print(f"  req {r.request_id}: {r.tokens[:16]} ... {r.wall_time_s:.2f}s")


if __name__ == "__main__":
    main()
