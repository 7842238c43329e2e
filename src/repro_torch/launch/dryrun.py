"""Dry run of every (arch x input shape) step on the production meshes,
with no device and no allocation (``repro.launch.dryrun``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \
      --shape decode_32k [--multi-pod] [--profile optimized]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dir

For one (arch, shape) the step the reference lowers (``make_train_step``'s
loss, backward and AdamW update; ``Model.prefill``; one
``Model.decode_step`` against a cache of ``seq_len`` slots) is traced at
the global shape on fake tensors (``FakeTensorMode``) under
``FlopCounterMode``. Every input is built on the meta device
(``launch.specs``): nothing is allocated and no card is read, so this is
the one entry point of the port that runs without a device, by design.
The step is traced unsharded: the mesh (``launch.mesh``, a ``DeviceMesh``
over torch's fake process-group backend) decides each input's shard and so
one rank's argument bytes, but not the trace (the sharded trace and its
collective bytes are ROADMAP §1 item 6b).

One JSON line per run: the analytic flops and HBM bytes per chip and the
roofline terms at the H100's rates (``launch.roofline``), the FLOPs counted
in the trace (every call counted, unlike XLA's ``cost_analysis``, which
counts a loop body once), one rank's argument bytes and whether one 80 GB
card holds them. ``--all`` runs each combination in a subprocess with a
time limit (``--timeout``) and names the ones that hit it; ``--arch`` and
``--shape`` narrow it.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCHS, ASSIGNED, INPUT_SHAPES, get_config
from ..configs.base import ModelConfig, ShapeConfig, TrainConfig
from ..models.model import Model
from ..sharding import context
from ..sharding.rules import mesh_sizes
from ..training.pretrain import make_train_step
from . import roofline
from .mesh import make_production_mesh, mesh_axes
from .specs import argument_bytes, input_specs


class OneCard:
    """A mesh of one card: every axis of size 1, so every input is whole."""
    shape = {"data": 1, "model": 1}


def trace_step(cfg: ModelConfig, shape: ShapeConfig, inputs, mode,
               tc: TrainConfig = None, long_context: bool = False) -> float:
    """FLOPs of the step of ``shape.kind`` on the fake ``inputs``
    (``specs.input_specs``), every call counted."""
    model = Model(cfg, device="meta")
    x = {k: v[0] for k, v in inputs.items()}
    with mode, FlopCounterMode(display=False) as fc:
        if shape.kind == "train":
            make_train_step(model, tc or TrainConfig())(
                x["state"], x["tokens"], x["labels"])
        elif shape.kind == "prefill":
            model.prefill(x["params"], x["tokens"], cache_len=shape.seq_len)
        else:
            model.decode_step(x["params"], x["tokens"], x["positions"],
                              x["cache"], long_context=long_context)
    return float(fc.get_total_flops())


def run_cfg(cfg: ModelConfig, shape: ShapeConfig, mesh, tc=None,
            profile: str = "baseline") -> dict:
    """The dry run of ``cfg`` at ``shape`` on ``mesh`` (a ``DeviceMesh`` or
    a stand-in such as ``OneCard``): the reference's roofline keys where
    they apply, the counted FLOPs and one rank's argument bytes."""
    long_ctx = shape.name == "long_500k"
    daxes, maxis = mesh_axes(mesh)
    context.set_mesh(mesh, daxes, maxis, profile=profile)
    sizes = {a: int(n) for a, n in mesh_sizes(mesh).items()}
    chips = math.prod(sizes.values())
    mode = FakeTensorMode()
    t0 = time.perf_counter()
    inputs = input_specs(cfg, shape, mesh, mode, tc, long_context=long_ctx,
                         profile=profile)
    arg_bytes = argument_bytes(inputs, mesh)
    counted = trace_step(cfg, shape, inputs, mode, tc, long_ctx)
    t_trace = time.perf_counter() - t0
    result = roofline.analyze(cfg, shape, chips, long_context=long_ctx,
                              profile=profile, msize=sizes[maxis])
    analytic = roofline.flops_model(cfg, shape, long_ctx)
    result.update({
        "counted_flops_total": counted,
        "counted_flops_per_chip": counted / chips,
        "counted_over_analytic": counted / analytic if analytic else None,
        "argument_bytes_per_rank": arg_bytes,
        "fits_one_card": arg_bytes <= roofline.HBM_BYTES,
        "profile": profile, "mesh": sizes, "trace_s": t_trace,
        "card": "NVIDIA H100 SXM (data-sheet rates; no card read)",
        "ok": True})
    return result


def run_one(arch: str, shape_name: str, multi_pod: bool, tc=None,
            profile: str = "baseline") -> dict:
    """The CLI's run of one combination on the production mesh."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    result = run_cfg(get_config(arch), INPUT_SHAPES[shape_name], mesh, tc,
                     profile)
    result.update({"multi_pod": multi_pod,
                   "host_peak_rss_gb": _peak_rss_gb(),
                   "cuda_initialized": torch.cuda.is_initialized()})
    return result


def _peak_rss_gb():
    """This process's peak resident memory since it started: Linux's
    VmHWM, which starts afresh at exec (``ru_maxrss`` carries over the
    resident size of the process that forked it); None where the kernel
    does not report it."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) * 1024 / 1e9
    except OSError:
        pass
    return None


def run_all(archs, shapes, multi_pod: bool, profile: str, timeout: float):
    """Each combination in a subprocess limited to ``timeout`` seconds:
    [result record], a record with ``"ok": false`` and its error or
    ``"timed_out": true`` for each that failed."""
    results = []
    for arch in archs:
        for shape in shapes:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--profile", profile]
            if multi_pod:
                cmd.append("--multi-pod")
            t0 = time.time()
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=timeout)
            except subprocess.TimeoutExpired:
                rec = {"arch": arch, "shape": shape, "ok": False,
                       "timed_out": True, "multi_pod": multi_pod,
                       "error": f"no result within {timeout:g} s"}
            else:
                lines = proc.stdout.strip().splitlines()
                try:
                    rec = json.loads(lines[-1]) if lines else {}
                except json.JSONDecodeError:
                    rec = {}
                if proc.returncode != 0 or not rec:
                    rec = {"arch": arch, "shape": shape, "ok": False,
                           "multi_pod": multi_pod,
                           "error": proc.stderr[-2000:]}
            rec.setdefault("wall_s", round(time.time() - t0, 1))
            results.append(rec)
            status = ("TIME" if rec.get("timed_out")
                      else "OK " if rec.get("ok") else "FAIL")
            print(f"[{status}] {arch:>22s} x {shape:<12s} "
                  f"{rec.get('trace_s', '?')}s trace "
                  f"bottleneck={rec.get('bottleneck', '-')}", file=sys.stderr)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(INPUT_SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every assigned arch x shape (narrowed by "
                         "--arch/--shape) in subprocesses")
    ap.add_argument("--profile", choices=("baseline", "optimized"),
                    default="baseline")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds each --all combination may take")
    ap.add_argument("--out", default=None, help="write JSON result(s) here")
    ap.add_argument("--hlo-out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.hlo_out:
        raise SystemExit("--hlo-out has no counterpart: the port lowers no "
                         "HLO (its sharded trace is ROADMAP §1 item 6b)")

    if args.all:
        archs = [args.arch] if args.arch else list(ASSIGNED)
        shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
        results = run_all(archs, shapes, args.multi_pod, args.profile,
                          args.timeout)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            suffix = "multipod" if args.multi_pod else "singlepod"
            if args.profile != "baseline":
                suffix += "_" + args.profile
            with open(os.path.join(args.out, f"dryrun_{suffix}.json"), "w") as f:
                json.dump(results, f, indent=1)
        n_ok = sum(1 for r in results if r.get("ok"))
        timed_out = [f"{r['arch']} x {r['shape']}" for r in results
                     if r.get("timed_out")]
        print(f"{n_ok}/{len(results)} combos traced"
              + (f"; hit the {args.timeout:g} s limit: {', '.join(timed_out)}"
                 if timed_out else ""), file=sys.stderr)
        sys.exit(0 if n_ok == len(results) else 1)

    if not (args.arch and args.shape):
        raise SystemExit("pass --arch and --shape, or --all")
    result = run_one(args.arch, args.shape, args.multi_pod,
                     profile=args.profile)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
