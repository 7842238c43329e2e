"""Times this tree's tree attention kernel against other copies of it on one card.

At Gemma-2-9B's verify shape (B 4, Hkv 8, N 7, G 2, hd 256, bf16, softcap
50), S 201 with random masks and the paged 4,352-slot view past the
window as ``chip_smoke.py`` phase 2 times them, this tree's kernel, each
other copy and SDPA (the yardstick, without the softcap: it has none) run
in turns (forward, then backward), each as a CUDA graph of 200 calls over
8 input sets. Every copy is first held to the plain version (``TOL`` at S
201, ``PAGED_TOL_REL`` of its scale on the paged view). A copy is another
commit's kernels package, or an edited one, with its own wrapper and plan,
as

    git archive <commit> src/repro_torch/kernels | tar -x -C build/parent

leaves it. Prints one JSON line per shape (device ms of each, the bound,
each copy's instance and splits) and the card's name and power limit.
Needs the card:

    PYTHONPATH=src python compare_tree_attention.py --copy parent=build/parent
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent


def load_copy(index, path):
    """A copy's kernels package under the name ``tacopy<index>``: its
    ``tree_attention`` module, its library built."""
    kdir = Path(path) / "src/repro_torch/kernels"
    name = f"tacopy{index}"
    spec = importlib.util.spec_from_file_location(
        name, kdir / "__init__.py", submodule_search_locations=[str(kdir)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    importlib.import_module(f"{name}.build").build_all(["tree_attention"])
    return importlib.import_module(f"{name}.tree_attention")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--copy", action="append", default=[], metavar="LABEL=DIR",
                    help="a directory holding another src/repro_torch/kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_tree_attention: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import tree_attention as tk
    copies = [c.split("=", 1) for c in args.copy]
    with ThreadPoolExecutor(len(copies) + 1) as pool:     # nvcc in parallel
        jobs = [pool.submit(build.build_all, ["tree_attention"])]
        jobs += [pool.submit(load_copy, i, path)
                 for i, (_, path) in enumerate(copies)]
        mods = [job.result() for job in jobs][1:]
    builds = {"change": tk, **{label: m for (label, _), m in zip(copies, mods)}}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"nvidia_smi": smi, "builds": list(builds)}), flush=True)
    order = [*builds, "library"]
    order += order[::-1]
    gen = torch.Generator(device="cuda").manual_seed(30)
    B, Hkv, N, G, hd, cap = 4, 8, 7, 2, 256, cs.GEMMA_SOFTCAP
    for label, S in (("S201", 201), ("paged4352", cs.GEMMA_VIEW)):
        if S == 201:
            def make():
                return cs.tree_inputs(gen, B, Hkv, N, G, hd, S, torch.bfloat16)
        else:
            def make():
                return cs.paged_tree_inputs(
                    gen, B, Hkv, N, hd, S, torch.bfloat16, G=G,
                    lens=[S - 1 - 16 * b for b in range(B)],
                    window=cs.GEMMA_WINDOW)
        sets = [make() for _ in range(8)]
        want = ref.ref_tree_attention(*sets[0], softcap=cap)
        scale = want.abs().max().item()
        tol = cs.TOL[torch.bfloat16] if S == 201 else cs.PAGED_TOL_REL * scale
        fns, plans, errs = {}, {}, {}
        for name, mod in builds.items():
            got = mod.tree_attention(*sets[0], softcap=cap)
            errs[name] = (got - want).abs().max().item()
            assert bool(torch.isfinite(got).all()) and errs[name] <= tol, \
                (label, name, errs[name], tol)
            p = mod.launch_plan(B, Hkv, N, G, hd, S, torch.bfloat16,
                                mod._sm_count(0))
            plans[name] = {"instance": p.launches[0].symbol,
                           "splits": p.splits, "chunk": p.chunk}
            fns[name] = (lambda *a, m=mod: m.tree_attention(*a, softcap=cap))
        fns["library"] = cs.sdpa_tree
        it = iter(range(10 ** 9))
        ms = {name: [] for name in fns}
        for name in order:
            ms[name].append(cs.graph_ms(
                lambda fn=fns[name]: fn(*sets[next(it) % len(sets)])))
        bound_ms, bound_by = cs.tree_bound_ms(*sets[0])
        print(json.dumps({"shape": label, "B": B, "Hkv": Hkv, "N": N, "G": G,
                          "hd": hd, "S": S, "softcap": cap, "plans": plans,
                          "max_abs_err": errs, "tol": tol, "device_ms": ms,
                          "bound_ms": bound_ms, "bound_by": bound_by}),
              flush=True)
        del sets
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
