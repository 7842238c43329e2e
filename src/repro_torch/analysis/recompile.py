"""Recompile sentinel: prove that a warm continuous engine builds nothing,
allocates nothing and syncs once a decode round (the port of
``repro.analysis.recompile``).

The reference watched XLA compiles: a forked jit cache turns every round
into a compile. Eager PyTorch has no jit cache; what plays its part here
is the kernels' build and load (``kernels/build.py``: nvcc, then a dlopen)
and the caching allocator: a ``cudaMalloc`` in the middle of serving is a
hidden sync, and a round that allocates device memory in steady state
cannot be captured in a CUDA graph. The engine's whole design is that
every shape is fixed at construction, so after warm-up its rounds reuse
what the first ones built and allocated.

  * ``KernelBuildWatcher`` records, while open, each library nvcc compiled
    and each one loaded (dlopen) by ``kernels.build``.
  * ``run_recompile_sentinel`` warms an engine and runs further decode
    rounds under a watcher, with the allocator's counts before and after.
  * ``count_fetches`` / ``audit_round_transfers``: the one-fetch-a-round
    contract. One steady-state decode round calls
    ``serving.continuous.fetch_to_host`` exactly once; on the card the
    round runs under ``torch.cuda.set_sync_debug_mode("error")`` with only
    that fetch exempted, and the profiler counts its device-to-host
    copies.

Rules
  RC001  a kernel library built or loaded twice in one process (while
         watched): a second build or dlopen of the same source
  RC002  a warm engine built or loaded a kernel library, or grew the
         caching allocator (its segment count or its device allocations,
         ``torch.cuda.memory_stats``), over its further decode rounds
  RC003  a steady-state decode round fetched != 1 time, or (on the card)
         made != 1 device-to-host copy
  RC004  another host sync inside the decode round (on the card: the sync
         debug mode raised; on the CPU the round audit's engine subjects
         stand in, on fake CUDA tensors)
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

import torch

from .findings import Finding, FindingSet
from .repolint import Rule

RULES: Dict[str, Rule] = {r.rule_id: r for r in [
    Rule("RC001", "kernel library built or loaded twice",
         "Eager PyTorch has no jit cache; the port's counterpart is the "
         "kernel libraries: kernels.build compiles a source with nvcc once "
         "(its library named by a hash of the sources) and dlopens it once "
         "a process. A second build or load of the same source in one "
         "process means a cache keyed on something that changes (a source "
         "edited under a running process, a cleared _loaded) and costs "
         "seconds of nvcc or a new copy of the library."),
    Rule("RC002", "a warm engine builds, loads or allocates",
         "After warm-up a continuous engine's decode rounds reuse what the "
         "first rounds built and allocated: every shape is fixed when the "
         "engine is made. Over further decode rounds no kernel library may "
         "be built or loaded and the caching allocator may not grow (its "
         "segment count and device allocations in torch.cuda.memory_stats). "
         "A cudaMalloc in the middle of serving is a hidden sync, and a "
         "round that allocates device memory cannot be captured in a CUDA "
         "graph."),
    Rule("RC003", "not exactly one fetch a decode round",
         "The continuous engine's decode round brings its results to the "
         "host in one copy (serving.continuous.fetch_to_host: lengths, "
         "windows, pending tokens, quality buffers). A second fetch, or a "
         "second device-to-host copy in the profiler, doubles the round's "
         "waits on the card."),
    Rule("RC004", "another host sync inside a decode round",
         "On the card a decode round runs under "
         "torch.cuda.set_sync_debug_mode('error') with only the fetch "
         "exempted: any other synchronising CUDA call raises. On the CPU "
         "the round audit's engine subjects (JX001 on fake CUDA tensors) "
         "stand in."),
]}

ALLOCATOR_COUNTS = ("segment.all.allocated", "num_device_alloc")
STEADY_ROUNDS = 16
CARD_ONLY = ["RC002 allocator counts (torch.cuda.memory_stats: needs the "
             "card)",
             "RC003 device-to-host copies counted by the profiler (needs the "
             "card)",
             "RC004 sync debug mode (needs the card; the round audit's "
             "engine subjects stand in)"]


class KernelBuildWatcher:
    """While open, records each ``kernels.build`` library that nvcc
    compiled (``builds``) and each one loaded with a dlopen (``loads``),
    by source name."""

    def __init__(self):
        self.builds: List[str] = []
        self.loads: List[str] = []

    def __enter__(self):
        from ..kernels import build
        self._build_all, self._load = build.build_all, build.load

        def build_all(names):
            names = list(names)
            fresh = [n for n in names if not build.library_path(n).exists()]
            logs = self._build_all(names)
            self.builds.extend(fresh)
            return logs

        def load(name):
            fresh = name not in build._loaded
            lib = self._load(name)
            if fresh:
                self.loads.append(name)
            return lib

        build.build_all, build.load = build_all, load
        return self

    def __exit__(self, *exc):
        from ..kernels import build
        build.build_all, build.load = self._build_all, self._load
        return False


def repeated_builds(watch: KernelBuildWatcher) -> FindingSet:
    """RC001: a library compiled or loaded more than once while watched."""
    fs = FindingSet()
    for what, names in (("built", watch.builds), ("loaded", watch.loads)):
        for name in sorted(set(names)):
            n = names.count(name)
            if n > 1:
                fs.add(Finding(
                    checker="recompile", rule="RC001", location=name,
                    message=f"kernel library {name} {what} {n}x in one "
                            f"process",
                    data={"library": name, "what": what, "count": n}))
    return fs


@contextlib.contextmanager
def count_fetches():
    """Count the engine's round fetches (``serving.continuous
    .fetch_to_host``) in the block; each runs outside any sync debug mode,
    the one sync a round may make. Yields a one-element list holding the
    count."""
    from ..serving import continuous
    counter = [0]
    real = continuous.fetch_to_host

    def counted(t):
        counter[0] += 1
        if t.device.type != "cuda":
            return real(t)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            return real(t)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    continuous.fetch_to_host = counted
    try:
        yield counter
    finally:
        continuous.fetch_to_host = real


def _allocator_counts() -> Dict[str, int]:
    stats = torch.cuda.memory_stats()
    return {k: int(stats.get(k, 0)) for k in ALLOCATOR_COUNTS}


def _dtoh_copies(prof) -> int:
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "Memcpy DtoH" in e.name)


def audit_round_transfers(engine=None, tree=None) -> FindingSet:
    """One steady-state decode round of a warm ``engine`` (by default the
    tiny CPU one): exactly one fetch (RC003); on the card also one
    device-to-host copy in the profiler and no other sync (RC004, the
    round under ``set_sync_debug_mode("error")``)."""
    fs = FindingSet()
    engine = engine or tiny_engine("cpu", tree)
    name = "tree_round" if engine.tree is not None else "chain_round"
    on_card = engine.device.type == "cuda"
    stats = {"round": name, "device": str(engine.device)}
    with count_fetches() as fetches:
        if on_card:
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    engine._decode_round()
                except RuntimeError as e:
                    fs.add(Finding(
                        checker="recompile", rule="RC004", location=name,
                        message=f"host sync inside a decode round "
                                f"({str(e)[:200]})",
                        data={"round": name, "error": str(e)}))
                    fs.stats = stats   # type: ignore[attr-defined]
                    return fs
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
        else:
            engine._decode_round()
    stats["fetches"] = fetches[0]
    if fetches[0] != 1:
        fs.add(Finding(
            checker="recompile", rule="RC003", location=name,
            message=f"decode round fetched {fetches[0]} times; the contract "
                    f"is exactly one host sync a round",
            data={"round": name, "fetches": fetches[0]}))
    if on_card:
        stats["dtoh_copies"] = n = _dtoh_copies(prof)
        if n != 1:
            fs.add(Finding(
                checker="recompile", rule="RC003", location=name,
                message=f"decode round made {n} device-to-host copies; the "
                        f"contract is the one fetch",
                data={"round": name, "dtoh_copies": n}))
    fs.stats = stats   # type: ignore[attr-defined]
    return fs


def run_recompile_sentinel(engine=None, tree=None,
                           rounds: int = STEADY_ROUNDS) -> FindingSet:
    """``rounds`` further decode rounds of a warm ``engine`` (by default
    the tiny CPU one): nothing built or loaded, and on the card the
    caching allocator's counts unchanged (RC002)."""
    engine = engine or tiny_engine("cpu", tree)
    name = "tree" if engine.tree is not None else "chain"
    on_card = engine.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        before = _allocator_counts()
    with KernelBuildWatcher() as warm:
        for _ in range(rounds):
            engine._decode_round()
    if on_card:
        torch.cuda.synchronize()
        after = _allocator_counts()
    fs = FindingSet()
    for what, names in (("built", warm.builds), ("loaded", warm.loads)):
        for lib in names:
            fs.add(Finding(
                checker="recompile", rule="RC002", location=lib,
                message=f"kernel library {lib} {what} by a warm engine's "
                        f"decode rounds",
                data={"library": lib, "what": what, "engine": name}))
    stats = {"engine": name, "rounds": rounds, "device": str(engine.device),
             "warm_builds": len(warm.builds), "warm_loads": len(warm.loads)}
    if on_card:
        stats["allocator_before"], stats["allocator_after"] = before, after
        for key in ALLOCATOR_COUNTS:
            if after[key] > before[key]:
                fs.add(Finding(
                    checker="recompile", rule="RC002", location=key,
                    message=f"the caching allocator grew over {rounds} warm "
                            f"decode rounds: {key} {before[key]} -> "
                            f"{after[key]} (a cudaMalloc mid-serve is a "
                            f"hidden sync)",
                    data={"counter": key, "before": before[key],
                          "after": after[key], "engine": name}))
    fs.stats = stats   # type: ignore[attr-defined]
    return fs


def run_sentinel(device: str = "cuda", engines=None) -> FindingSet:
    """Under one ``KernelBuildWatcher`` (RC001): the transfer audit and the
    sentinel for a chain and a tree (2, 1) engine, ``engines`` ({name:
    warm engine}) or, made inside the watcher, the tiny pair's on
    ``device``."""
    from ..spectree.tree import TreeSpec
    fs = FindingSet()
    stats: Dict[str, object] = {}
    with KernelBuildWatcher() as watch:
        if engines is None:
            engines = {name: tiny_engine(device, spec)
                       for name, spec in (("chain", None),
                                          ("tree", TreeSpec((2, 1))))}
        for name, eng in engines.items():
            got = audit_round_transfers(eng)
            fs.extend(got)
            stats[f"{name}_transfers"] = got.stats
            got = run_recompile_sentinel(eng)
            fs.extend(got)
            stats[f"{name}_sentinel"] = got.stats
    fs.extend(repeated_builds(watch))
    stats["builds"], stats["loads"] = watch.builds, watch.loads
    if device != "cuda":
        stats["left_out"] = CARD_ONLY
    fs.stats = stats   # type: ignore[attr-defined]
    return fs


def tiny_engine(device: str, tree=None):
    """The tiny pair's continuous engine (``round_audit.tiny_models``) on
    ``device``, stepped into its decode phase."""
    from .round_audit import tiny_models, warm_engine
    t, d = tiny_models()
    if device == "cuda":
        from ..models.model import Model
        t, d = Model(t.cfg, device="cuda"), Model(d.cfg, device="cuda")
    return warm_engine(t, t.init(0), d, d.init(1), tree=tree)
