"""Run the port's static-analysis checkers from the command line (the
counterpart of the reference's ``tools/repro_lint.py``).

Usage (from the repo root, PYTHONPATH=src):

    python -m repro_torch.analysis --all --json findings.json
    python -m repro_torch.analysis --all --device cpu     # no card
    python -m repro_torch.analysis --ast --rounds         # subset
    python -m repro_torch.analysis --explain RC002        # rule rationale

Checkers (see src/repro_torch/analysis/):
    --ast        repo-rule AST linter (no model is built)
    --rounds     round auditor on fake CUDA tensors; on the card also the
                 tiny pair's chain and tree rounds under the sync debug mode
    --kernels    launch plans across swept shapes; on the card every
                 kernel instance's registers and shared memory
    --recompile  build/allocation sentinel and the one-fetch-a-round audit
                 over the tiny pair's continuous engine

It runs on the card unless given ``--device cpu``; without a card it
exits with an error rather than fall back. On the CPU the checks that need
the card are left out and named in the output. Exit status is the number
of ERROR-severity findings (0 = clean; warnings never gate). ``--json
PATH`` writes the findings document (the reference's schema) with each
checker's stats.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

CHECKERS = ("ast", "rounds", "kernels", "recompile")


def run_checker(name: str, device: str):
    from . import (run_kernel_lint, run_repolint, run_round_audit,
                   run_sentinel)
    if name == "ast":
        return run_repolint()
    if name == "rounds":
        fs = run_round_audit()
        if device == "cuda":
            from .round_audit import run_tiny_live_audit
            live = run_tiny_live_audit()
            fs.extend(live)
            fs.stats.update(live.stats)
        else:
            fs.stats["left_out"] = [
                "the rounds on the card under the sync debug mode (needs "
                "the card)"]
        return fs
    if name == "kernels":
        return run_kernel_lint(device)
    return run_sentinel(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    for name, help_ in (("ast", "repo-rule AST linter"),
                        ("rounds", "round auditor"),
                        ("kernels", "kernel lint"),
                        ("recompile", "build/allocation sentinel and "
                                      "transfer audit")):
        ap.add_argument(f"--{name}", action="store_true", help=help_)
    ap.add_argument("--all", action="store_true", help="every checker")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default): the card's checks too; cpu: leave "
                         "them out")
    ap.add_argument("--json", metavar="PATH",
                    help="write machine-readable findings JSON")
    ap.add_argument("--explain", metavar="RULE",
                    help="print the rationale for one rule id and exit")
    args = ap.parse_args(argv)

    if args.explain:
        from . import explain
        print(explain(args.explain))
        return 0
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("repro_torch.analysis: no CUDA device; pass --device cpu to "
              "run the checks that need no card", file=sys.stderr)
        return 2
    selected = [n for n in CHECKERS if args.all or getattr(args, n)]
    selected = selected or list(CHECKERS)

    from . import FindingSet
    all_findings = FindingSet()
    stats = {}
    for name in selected:
        t0 = time.perf_counter()
        fs = run_checker(name, args.device)
        dt = time.perf_counter() - t0
        stats[name] = dict(getattr(fs, "stats", {}), findings=len(fs),
                           seconds=round(dt, 2))
        left = stats[name].get("left_out", [])
        print(f"[{name}] {len(fs.errors)} errors, {len(fs.warnings)} "
              f"warnings in {dt:.1f}s"
              + (f"; left out: {'; '.join(left)}" if left else ""))
        all_findings.extend(fs)

    if len(all_findings):
        print()
        print(all_findings.format())
    device = (torch.cuda.get_device_name(0) if args.device == "cuda"
              else "cpu")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        all_findings.write_json(args.json, extra={"checkers": stats,
                                                  "device": device})
        print(f"\nwrote {args.json}")
    n_err = len(all_findings.errors)
    print(f"\n{n_err} error(s), {len(all_findings.warnings)} warning(s) "
          f"across {len(selected)} checker(s) on {device}")
    return n_err


if __name__ == "__main__":
    sys.exit(main())
