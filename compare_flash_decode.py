"""Times this tree's flash decode kernel against another commit's on one card.

At each timing shape of ``chip_smoke.py`` phase 12 (``FD_TIMING``) the two
kernels run in turns (parent, change, change, parent), each as a CUDA graph
of 200 calls over input sets rotated past the L2, and each is held to the
plain version within phase 12's tolerance first. The parent is another
commit's kernels package, with its own wrapper and plan, as

    git archive <commit> src/repro_torch/kernels | tar -x -C build/parent

leaves it. Prints one JSON line per shape (device ms of each, the bound,
this tree's plan) and the card's name and power limit. Needs the card:

    PYTHONPATH=src python compare_flash_decode.py --parent build/parent
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent


def load_parent(path):
    """Another commit's kernels package under the name ``fdparent``."""
    kdir = Path(path) / "src/repro_torch/kernels"
    spec = importlib.util.spec_from_file_location(
        "fdparent", kdir / "__init__.py", submodule_search_locations=[str(kdir)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules["fdparent"] = pkg
    spec.loader.exec_module(pkg)
    importlib.import_module("fdparent.build").build_all(["flash_decode"])
    return importlib.import_module("fdparent.flash_decode").flash_decode


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, help="directory of another "
                    "commit's src/repro_torch/kernels (git archive)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_flash_decode: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_decode as fk
    build.build_all(["flash_decode"])
    builds = {"parent": load_parent(args.parent), "change": fk.flash_decode}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"nvidia_smi": smi, "builds": list(builds)}), flush=True)
    order = ["parent", "change", "change", "parent"]
    gen = torch.Generator(device="cuda").manual_seed(13)
    for label, B, Hkv, G, S, dtype in cs.FD_TIMING:
        one = cs.decode_inputs(gen, B, Hkv, G, 128, S, dtype)
        set_bytes = sum(t.numel() * t.element_size() for t in one)
        sets = [one] + [cs.decode_inputs(gen, B, Hkv, G, 128, S, dtype)
                        for _ in range(max(1, -(-int(150e6) // set_bytes)) - 1)]
        want = ref.ref_flash_decode(*one)
        scale = want.abs().max().item()
        for name, fn in builds.items():
            err = (fn(*one) - want).abs().max().item()
            assert err <= cs.FD_TOL * scale, (label, name, err / scale)
        it = iter(range(10 ** 9))
        ms = {name: [] for name in builds}
        for name in order:
            ms[name].append(cs.graph_ms(
                lambda fn=builds[name]: fn(*sets[next(it) % len(sets)])))
        q, k, v, mask = one
        bound_ms, bound_by = cs.tree_bound_ms(q[:, :, None], k, v, mask)
        print(json.dumps({"shape": label, "B": B, "Hkv": Hkv, "G": G, "S": S,
                          "dtype": str(dtype).split(".")[-1],
                          "plan": cs.fd_plan(B, Hkv, G, 128, S, dtype),
                          "device_ms": ms, "bound_ms": bound_ms,
                          "bound_by": bound_by}), flush=True)
        del sets, one
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
