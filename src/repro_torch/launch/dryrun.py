"""Dry run of every (arch x input shape) step on the production meshes,
with no device and no allocation (``repro.launch.dryrun``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \
      --shape decode_32k [--multi-pod] [--profile optimized]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dir

For one (arch, shape) the step the reference lowers (``make_train_step``'s
loss, backward and AdamW update; ``Model.prefill``; one
``Model.decode_step`` against a cache of ``seq_len`` slots) is traced
twice on fake tensors (``FakeTensorMode``), whose inputs are built on the
meta device (``launch.specs``): nothing is allocated and no card is read,
so this is the one entry point of the port that runs without a device, by
design.

- Unsharded, at the global shape under ``FlopCounterMode``, with no mesh
  installed: the counted FLOPs (every call counted, unlike XLA's
  ``cost_analysis``, which counts a loop body once). The sharded trace
  cannot give them: its MoE regions run on local shards, whose FLOPs are
  one rank's.
- Sharded (``trace_sharded``): every input one rank's shard as a DTensor
  with its placements (``specs.dtensor_inputs``) on the mesh
  (``launch.mesh``, a ``DeviceMesh`` over torch's fake process-group
  backend), with the mesh installed in ``sharding.context`` so that MoE
  runs its mesh paths and the optimized profile its constraints. DTensor
  inserts the collectives the placements need, and
  ``launch.collectives.StepRecorder`` records one rank's collectives by
  kind with their result bytes, and its live local storage: the argument,
  output, temporary and peak bytes of the reference's ``memory_analysis``.

One JSON line per run: the analytic flops and HBM bytes per chip and the
roofline terms at the H100's rates with the counted collective term
(``launch.roofline``), the counted FLOPs, one rank's argument bytes and
whether one 80 GB card holds them, and one rank's ``memory``. ``--all``
runs each combination in a subprocess (``--jobs`` at a time) with a time
limit (``--timeout``), names the ones that hit it, and names the op where
one failed; ``--arch`` and ``--shape`` narrow it.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import DeviceMesh
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCHS, ASSIGNED, INPUT_SHAPES, get_config
from ..configs.base import ModelConfig, ShapeConfig, TrainConfig
from ..models.model import Model
from ..sharding import context
from ..sharding.rules import mesh_sizes
from ..training.pretrain import make_train_step
from . import roofline
from .collectives import StepRecorder
from .mesh import make_production_mesh, mesh_axes
from .specs import argument_bytes, dtensor_inputs, input_specs


class OneCard:
    """A mesh of one card: every axis of size 1, so every input is whole."""
    shape = {"data": 1, "model": 1}


def _run_step(model, shape: ShapeConfig, x, tc, long_context: bool):
    """The step of ``shape.kind`` on the inputs ``x``: its outputs."""
    if shape.kind == "train":
        return make_train_step(model, tc or TrainConfig())(
            x["state"], x["tokens"], x["labels"])
    if shape.kind == "prefill":
        return model.prefill(x["params"], x["tokens"],
                             cache_len=shape.seq_len)
    return model.decode_step(x["params"], x["tokens"], x["positions"],
                             x["cache"], long_context=long_context)


def trace_step(cfg: ModelConfig, shape: ShapeConfig, inputs, mode,
               tc: TrainConfig = None, long_context: bool = False) -> float:
    """FLOPs of the step of ``shape.kind`` on the fake ``inputs``
    (``specs.input_specs``), every call counted."""
    model = Model(cfg, device="meta")
    x = {k: v[0] for k, v in inputs.items()}
    with mode, FlopCounterMode(display=False) as fc:
        _run_step(model, shape, x, tc, long_context)
    return float(fc.get_total_flops())


@functools.lru_cache(maxsize=None)
def register_strategies():
    """Sharding strategies DTensor lacks for ops the port's step runs
    (``torch.distributed.tensor.experimental.register_sharding``), once a
    process: ``log_sigmoid`` (mLSTM's forget gate) and its backward are
    pointwise, so any sharding of the input is the output's."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    aten = torch.ops.aten

    def pointwise(ndim, n_out, n_in):
        out = [([Replicate()] * n_out, [Replicate()] * n_in)]
        out += [([Shard(d)] * n_out, [Shard(d)] * n_in) for d in range(ndim)]
        return out

    @register_sharding(aten.log_sigmoid_forward.default)
    def _log_sigmoid(x):
        return pointwise(x.ndim, 2, 1)

    @register_sharding(aten.log_sigmoid_backward.default)
    def _log_sigmoid_backward(grad, x, buffer):
        return pointwise(x.ndim, 1, 3)


def trace_sharded(cfg: ModelConfig, shape: ShapeConfig, inputs, mesh, mode,
                  tc: TrainConfig = None, long_context: bool = False) -> dict:
    """One rank's view of the step of ``shape.kind`` traced on DTensors:
    each fake input of ``inputs`` (``specs.input_specs``) as this rank's
    shard on the ``DeviceMesh`` ``mesh`` (which ``sharding.context`` must
    hold). Tensors the step makes join the DTensors as replicated
    (``implicit_replication``). -> {"collectives": {kind: result bytes},
    "collective_calls": {kind: calls}, "memory": one rank's argument,
    output, temporary and peak bytes}: the arguments are the local shards'
    storages (labels alias tokens, so counted once), the outputs the
    storages the step returns that no argument holds (a decode step
    writes its cache in place), the peak the most bytes of local storage
    alive at once, and the temporaries the peak less both."""
    from torch.distributed.tensor.experimental import implicit_replication
    register_strategies()
    model = Model(cfg, device="meta")
    x = dtensor_inputs(inputs, mesh, mode)
    rec = StepRecorder()
    with mode, implicit_replication(), rec:
        rec.track(x)
        args = rec.live
        out = _run_step(model, shape, x, tc, long_context)
        outs = _new_bytes(rec, out, x)
        peak = rec.peak
    return {"collectives": rec.collectives(),
            "collective_calls": {k: int(v) for k, v in rec.calls.items()},
            "memory": {"argument_bytes": args, "output_bytes": outs,
                       "temp_bytes": max(peak - args - outs, 0),
                       "peak_bytes": peak}}


def _new_bytes(rec, out, args) -> int:
    """Bytes of the storages of ``out`` that ``args`` does not hold."""
    return rec.live_bytes((out, args)) - rec.live_bytes(args)


def run_cfg(cfg: ModelConfig, shape: ShapeConfig, mesh, tc=None,
            profile: str = "baseline") -> dict:
    """The dry run of ``cfg`` at ``shape`` on ``mesh``: the reference's
    roofline keys, the counted FLOPs, one rank's argument bytes and, on a
    ``DeviceMesh``, the sharded trace's collective term and one rank's
    memory. A stand-in mesh (``OneCard``, the tests' sizes-only meshes)
    has no process group to trace on: one card has no collectives (an
    empty ``collectives``, and its whole step's memory is the device's
    own), a larger stand-in leaves the collective fields None."""
    long_ctx = shape.name == "long_500k"
    daxes, maxis = mesh_axes(mesh)
    sizes = {a: int(n) for a, n in mesh_sizes(mesh).items()}
    chips = math.prod(sizes.values())
    mode = FakeTensorMode()
    old_profile = context.profile()
    context.set_profile(profile)
    try:
        t0 = time.perf_counter()
        inputs = input_specs(cfg, shape, mesh, mode, tc,
                             long_context=long_ctx, profile=profile)
        arg_bytes = argument_bytes(inputs, mesh)
        with context.use_mesh(None):
            counted = trace_step(cfg, shape, inputs, mode, tc, long_ctx)
        t_trace = time.perf_counter() - t0
        sharded, t_sharded = None, None
        if isinstance(mesh, DeviceMesh):
            t0 = time.perf_counter()
            with context.use_mesh(mesh, daxes, maxis):
                sharded = trace_sharded(cfg, shape, inputs, mesh, mode, tc,
                                        long_ctx)
            t_sharded = time.perf_counter() - t0
    finally:
        context.set_profile(old_profile)
    coll = sharded["collectives"] if sharded else ({} if chips == 1 else None)
    result = roofline.analyze(cfg, shape, chips, long_context=long_ctx,
                              profile=profile, msize=sizes[maxis],
                              collectives=coll)
    analytic = roofline.flops_model(cfg, shape, long_ctx)
    result.update({
        "counted_flops_total": counted,
        "counted_flops_per_chip": counted / chips,
        "counted_over_analytic": counted / analytic if analytic else None,
        "argument_bytes_per_rank": arg_bytes,
        "fits_one_card": arg_bytes <= roofline.HBM_BYTES,
        "collective_calls": sharded["collective_calls"] if sharded else None,
        "memory": sharded["memory"] if sharded else None,
        "profile": profile, "mesh": sizes, "trace_s": t_trace,
        "sharded_trace_s": t_sharded,
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


def failed_op(stderr: str):
    """The op a failed trace names last (DTensor's and the fake tensors'
    errors name it as ``aten.<op>.<overload>``), or None."""
    ops = re.findall(r"aten\.\w+\.\w+", stderr)
    return ops[-1] if ops else None


def run_all(archs, shapes, multi_pod: bool, profile: str, timeout: float,
            jobs: int = 1):
    """Each combination in a subprocess limited to ``timeout`` seconds,
    ``jobs`` at a time: [result record] in (arch, shape) order, a record
    with ``"ok": false`` and its error (and the op it names) or
    ``"timed_out": true`` for each that failed."""
    combos = [(a, s) for a in archs for s in shapes]
    running, results = {}, {}

    def start(arch, shape):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--profile", profile]
        if multi_pod:
            cmd.append("--multi-pod")
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        proc = subprocess.Popen(cmd, stdout=out, stderr=err, text=True)
        running[(arch, shape)] = (proc, out, err, time.time())

    def finish(arch, shape, proc, out, err, t0):
        if proc.poll() is None:
            proc.kill()
            proc.wait()
            rec = {"arch": arch, "shape": shape, "ok": False,
                   "timed_out": True, "multi_pod": multi_pod,
                   "error": f"no result within {timeout:g} s"}
        else:
            out.seek(0)
            err.seek(0)
            lines, stderr = out.read().strip().splitlines(), err.read()
            try:
                rec = json.loads(lines[-1]) if lines else {}
            except json.JSONDecodeError:
                rec = {}
            if proc.returncode != 0 or not rec:
                rec = {"arch": arch, "shape": shape, "ok": False,
                       "multi_pod": multi_pod, "op": failed_op(stderr),
                       "error": stderr[-2000:]}
        out.close()
        err.close()
        rec.setdefault("wall_s", round(time.time() - t0, 1))
        results[(arch, shape)] = rec
        status = ("TIME" if rec.get("timed_out")
                  else "OK " if rec.get("ok") else "FAIL")
        print(f"[{status}] {arch:>22s} x {shape:<12s} "
              f"{rec.get('trace_s', '?')}s trace, "
              f"{rec.get('sharded_trace_s', '?')}s sharded "
              f"bottleneck={rec.get('bottleneck', '-')}"
              + (f" op={rec['op']}" if rec.get("op") else ""),
              file=sys.stderr)

    todo = list(combos)
    while todo or running:
        while todo and len(running) < max(jobs, 1):
            start(*todo.pop(0))
        done = [k for k, (proc, _, _, t0) in running.items()
                if proc.poll() is not None or time.time() - t0 >= timeout]
        if not done:
            time.sleep(0.2)
        for key in done:
            finish(*key, *running.pop(key))
    return [results[c] for c in combos]


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
    ap.add_argument("--jobs", type=int, default=1,
                    help="--all combinations traced at a time")
    ap.add_argument("--out", default=None, help="write JSON result(s) here")
    ap.add_argument("--hlo-out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.hlo_out:
        raise SystemExit("--hlo-out has no counterpart: the port lowers no "
                         "HLO (its sharded trace runs on DTensors)")

    if args.all:
        archs = [args.arch] if args.arch else list(ASSIGNED)
        shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
        results = run_all(archs, shapes, args.multi_pod, args.profile,
                          args.timeout, args.jobs)
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
