"""Round auditor: run the speculative rounds as the card would, and check
the invariants the port's speed rests on (the port of
``repro.analysis.jaxpr_audit``).

A round that waits for the card, reallocates its caches or changes the
shape or dtype of its state costs every round, and none of that shows in
a test of its tokens. The reference traced its jitted rounds to jaxprs.
Eager PyTorch has no trace to read, so this module runs each round on fake
CUDA tensors (``FakeTensorMode``: shapes, dtypes, devices and storage
identity, no data, no card) and records what it does:

  JX001  host re-entry inside a round: an op whose output depends on the
         data (``.item()``, ``nonzero``, boolean-mask indexing), a host
         conversion (``float()``, ``.tolist()``, ``.numpy()``), or a copy
         between a CUDA tensor and the host. Each waits for the card, and
         a round that does cannot be captured in a CUDA graph.
  JX002  a state leaf's (shape, dtype, device) out of the round differs
         from the same leaf's going in, or a leaf is dropped or added.
  JX003  a state leaf comes out of the round in other storage than it went
         in with: the caches are updated in place (``core/speculative.py``
         ``sd_round``), the counterpart of the reference's donation. The
         small leaves a round reallocates by design are named in
         ``REALLOCATED`` with their reasons.
  JX004  same-named state leaves disagree on dtype across the round
         variants (chain, tree, head drafter, engine); the int8-KV variant
         is a group of its own, as in the reference.

The fake tensors are on ``device="cuda"`` so that every device test in the
port takes the card's branch: the kernel wrappers' (their launches are
recorded by ``kernel_lint.capture_kernel_calls``, never run) and PyTorch's
own (``F.one_hot`` validates the indices of a CPU tensor on the host, not
those of a CUDA one). A CPU build of PyTorch has no CUDA device guard, so
while a round runs, Python indexing of a fake CUDA tensor is done on it as
a meta tensor (``_FakeCuda``); no other op changes.

``run_live_round`` is the same audit on the card: real tensors, the round
under ``torch.cuda.set_sync_debug_mode("error")``.
"""
from __future__ import annotations

import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                           DynamicOutputShapeException,
                                           FakeTensor, FakeTensorMode)
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten_with_path, tree_map_only, keystr

from .findings import Finding, FindingSet
from .repolint import Rule

CUDA = torch.device("cuda", 0)

RULES: Dict[str, Rule] = {r.rule_id: r for r in [
    Rule("JX001", "host re-entry inside a round",
         "A speculative round must run on the card from its first launch to "
         "the engine's one fetch. .item(), float()/int()/bool() of a "
         "tensor, .tolist()/.numpy(), a copy between a CUDA tensor and the "
         "host (from pageable memory even host-to-device waits for the "
         "stream), and ops whose output size depends on the data "
         "(nonzero, boolean-mask indexing) each wait for the card: the "
         "launch queue drains every round and the round cannot be captured "
         "in a CUDA graph. The audit runs each round on fake CUDA tensors "
         "and records these; on the card the round runs under "
         "torch.cuda.set_sync_debug_mode('error'). Keep the value on the "
         "device, or make a constant once (TreeSpec.on) instead of copying "
         "it every round."),
    Rule("JX002", "round state drifts",
         "The drivers feed each round's output state into the next round. "
         "A leaf whose shape, dtype or device changes, or a leaf dropped or "
         "added, changes what the next round allocates and launches, and "
         "breaks the fixed shapes the engine and a captured graph rely on."),
    Rule("JX003", "state reallocated instead of updated in place",
         "sd_round and tree_round update the caches (k, v, pos, int8 "
         "scales, paged pools) and the token buffer in place: the engine's "
         "pool exists once. A leaf that comes out in new storage was "
         "copied or reallocated every round, so it briefly exists twice and "
         "costs a full write. The small leaves a round replaces by design "
         "are named in REALLOCATED with their reasons."),
    Rule("JX004", "dtype drift across round variants",
         "Chain, tree, head-drafter and engine rounds build their states by "
         "different code paths; a same-named leaf must have one dtype in "
         "all of them, or host code that reads the leaves and the kernels "
         "that take them see a flip when a config changes. The int8-KV "
         "variant stores int8 caches by design and is a group of its own."),
]}
_META = torch.device("meta")

#: state leaves (top-level keys) a round returns in new storage by design
REALLOCATED = {
    "lengths": "a new (B,) tensor each round: the continuous engine keeps "
               "the pre-round one for its window gather "
               "(serving/continuous.py _decode_round)",
    "pending": "the round's new pending token, (B,), sampled in the commit",
    "h_feat": "the head drafter's next feature, (B, D), taken from the "
              "verify pass's hidden states",
    "qual": "the quality buffers, written whole by each round's commit",
}

# Python-level conversions that bring a tensor's value to the host
_HOST_METHODS = {
    torch.Tensor.item: "item", torch.Tensor.tolist: "tolist",
    torch.Tensor.numpy: "numpy", torch.Tensor.__float__: "float",
    torch.Tensor.__int__: "int", torch.Tensor.__bool__: "bool",
    torch.Tensor.__index__: "index",
}
_INDEXING = (torch.Tensor.__getitem__, torch.Tensor.__setitem__)
_NO_CUDA = "not linked with support for cuda"


def _dummy(t: torch.Tensor, how: str):
    """A stand-in value for a host conversion of fake ``t``, so that the
    round runs on and later events are recorded too."""
    zeros = np.zeros(tuple(t.shape), dtype=np.float32)
    if how == "tolist":
        return zeros.tolist()
    if how == "numpy":
        return zeros
    if how == "float":
        return 0.0
    if how == "bool":
        return False
    if how == "item":
        return False if t.dtype == torch.bool else \
            0.0 if t.dtype.is_floating_point else 0
    return 0


class _FakeCuda(TorchFunctionMode):
    """Python-level tensor methods that a CPU build refuses on a fake CUDA
    tensor (indexing, ``contiguous``: their bindings enter a CUDA device
    guard, which the build lacks) done on the fakes as meta tensors, and
    host conversions of fake tensors recorded and answered with zeros."""

    def __init__(self, events: List[Tuple[str, str]]):
        super().__init__()
        self.events = events

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        how = _HOST_METHODS.get(func)
        if how is not None and isinstance(args[0], FakeTensor):
            if _on_cuda(args[0]):
                self.events.append(("host conversion", f".{how}()"))
            return _dummy(args[0], how)
        if func not in _INDEXING:
            try:
                return func(*args, **kwargs)
            except RuntimeError as e:
                if _NO_CUDA not in str(e):
                    raise
        elif _on_cuda(args[0]):
            self._check_index(func, args)
        flipped = []

        def to_meta(t):
            if _on_cuda(t):
                flipped.append((t, t.fake_device))
                t.fake_device = _META
            return t

        def back(t):
            if isinstance(t, FakeTensor) and t.fake_device == _META:
                t.fake_device = flipped[0][1]
            return t

        tree_map_only(torch.Tensor, to_meta, (args, kwargs))
        try:
            out = func(*args, **kwargs)
        finally:
            for t, dev in flipped:
                t.fake_device = dev
        return tree_map_only(torch.Tensor, back, out) if flipped else out

    def _check_index(self, func, args):
        """What Python indexing of a CUDA tensor copies from the host, which
        the meta stand-in cannot show: an index given as a list (made into
        a host tensor), and a Python number or host tensor written through
        tensor indices (``index_put_`` copies it to the card first)."""
        index = args[1] if isinstance(args[1], tuple) else (args[1],)
        if any(isinstance(i, (list, np.ndarray)) for i in index):
            self.events.append(("host-to-device copy",
                                "an index built on the host"))
        if func is not torch.Tensor.__setitem__ or \
                not any(isinstance(i, torch.Tensor) for i in index):
            return
        value = args[2]
        if isinstance(value, (bool, int, float)) or (
                isinstance(value, torch.Tensor) and value.device.type == "cpu"):
            self.events.append(("host-to-device copy", "a host value "
                                "written through tensor indices"))


def _on_cuda(t) -> bool:
    return isinstance(t, FakeTensor) and t.fake_device.type == "cuda"


class _Transfers(TorchDispatchMode):
    """Records copies between a CUDA tensor and the host, and the ops whose
    output depends on the data, which fake tensors refuse (the round stops
    there)."""

    def __init__(self, events: List[Tuple[str, str]]):
        super().__init__()
        self.events = events

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        src = dst = None
        if func is torch.ops.aten._to_copy.default and \
                kwargs.get("device") is not None:
            src, dst = args[0].device, torch.device(kwargs["device"])
        elif func is torch.ops.aten.copy_.default:
            src, dst = args[1].device, args[0].device
        if src is not None and {src.type, dst.type} == {"cuda", "cpu"}:
            kind = "device-to-host" if src.type == "cuda" else "host-to-device"
            self.events.append((f"{kind} copy", str(func)))
        try:
            return func(*args, **kwargs)
        except (DataDependentOutputException,
                DynamicOutputShapeException):
            self.events.append(("data-dependent op", str(func)))
            raise


@dataclass
class AuditSubject:
    """One round variant on fake CUDA tensors: ``fn(state)`` runs the round
    (models, parameters, config and generator closed over) and returns
    ``(new_state, n_acc)``; ``state`` is its input state, made by ``mode``."""

    name: str
    fn: Callable
    state: Dict
    mode: FakeTensorMode
    dtype_group: str = "fp"
    _result: Optional["RoundTrace"] = field(default=None, repr=False)


@dataclass
class RoundTrace:
    """What a round did: its host re-entries, the state's leaves going in
    and coming out (None where the round stopped), the error that stopped
    it, and the kernel launches it would have made."""

    events: List[Tuple[str, str]]
    leaves_in: Dict[str, Tuple]
    leaves_out: Optional[Dict[str, Tuple]]
    error: Optional[str]
    kernel_calls: Dict[str, int]


def state_leaves(state) -> Dict[str, Tuple]:
    """Leaf path -> (shape, dtype, device, storage) of a state's tensors."""
    out = {}
    for path, leaf in tree_flatten_with_path(state)[0]:
        if isinstance(leaf, torch.Tensor):
            out[keystr(path)] = (tuple(leaf.shape), leaf.dtype,
                                 str(leaf.device),
                                 leaf.untyped_storage()._cdata)
    return out


def trace_round(subj: AuditSubject) -> RoundTrace:
    """Run the subject's round once on its fake tensors (cached)."""
    if subj._result is not None:
        return subj._result
    from .kernel_lint import capture_kernel_calls
    events: List[Tuple[str, str]] = []
    leaves_in = state_leaves(subj.state)
    out, error = None, None
    with capture_kernel_calls() as calls, subj.mode, _FakeCuda(events), \
            _Transfers(events):
        try:
            new_state, _ = subj.fn(subj.state)
            out = state_leaves(new_state)
        except (DataDependentOutputException,
                DynamicOutputShapeException) as e:
            error = f"{type(e).__name__}: {e}"
    counts: Dict[str, int] = {}
    for plan in calls:
        counts[plan.kernel] = counts.get(plan.kernel, 0) + 1
    subj._result = RoundTrace(events, leaves_in, out, error, counts)
    return subj._result


# ------------------------------------------------------------------ rules

def audit_host_reentry(name: str, trace: RoundTrace) -> List[Finding]:
    """JX001: no host re-entry anywhere in the round."""
    found: Dict[Tuple[str, str], int] = {}
    for ev in trace.events:
        found[ev] = found.get(ev, 0) + 1
    out = [Finding(checker="rounds", rule="JX001", location=name,
                   message=f"{kind} {op} x{n} inside the round: it waits for "
                           f"the card every round",
                   data={"subject": name, "kind": kind, "op": op, "count": n})
           for (kind, op), n in sorted(found.items())]
    if trace.error is not None:
        out.append(Finding(
            checker="rounds", rule="JX001", location=name,
            message=f"the round stopped at a data-dependent op "
                    f"({trace.error[:200]})",
            data={"subject": name, "error": trace.error}))
    return out


def audit_state_stability(name: str, trace: RoundTrace) -> List[Finding]:
    """JX002: output state (shape, dtype, device) == input, leaf for leaf."""
    if trace.leaves_out is None:
        return []
    want, got = trace.leaves_in, trace.leaves_out
    findings = []
    for key in sorted(set(want) | set(got)):
        if key not in got or key not in want:
            kind, what = (("missing", "consumed but not returned")
                          if key not in got else
                          ("extra", "returned but never consumed"))
            findings.append(Finding(
                checker="rounds", rule="JX002", location=f"{name}{key}",
                message=f"state leaf {key} {what} — the output state's "
                        f"structure differs from the input's",
                data={"subject": name, "leaf": key, "kind": kind}))
        elif want[key][:3] != got[key][:3]:
            w, g = want[key], got[key]
            findings.append(Finding(
                checker="rounds", rule="JX002", location=f"{name}{key}",
                message=f"state leaf {key} drifts across the round: in "
                        f"shape={w[0]} dtype={w[1]} device={w[2]} vs out "
                        f"shape={g[0]} dtype={g[1]} device={g[2]}",
                data={"subject": name, "leaf": key,
                      "in": {"shape": list(w[0]), "dtype": str(w[1]),
                             "device": w[2]},
                      "out": {"shape": list(g[0]), "dtype": str(g[1]),
                              "device": g[2]}}))
    return findings


def audit_in_place(name: str, trace: RoundTrace) -> List[Finding]:
    """JX003: every leaf but ``REALLOCATED``'s comes out in the storage it
    went in with."""
    if trace.leaves_out is None:
        return []
    moved = [key for key, v in trace.leaves_in.items()
             if key in trace.leaves_out
             and trace.leaves_out[key][3] != v[3]
             and key.split("'")[1] not in REALLOCATED]
    if not moved:
        return []
    return [Finding(
        checker="rounds", rule="JX003", location=name,
        message=f"{len(moved)} state leaves come out of the round in new "
                f"storage ({', '.join(moved[:6])}"
                f"{', ...' if len(moved) > 6 else ''}): a cache is "
                f"reallocated every round instead of updated in place",
        data={"subject": name, "leaves": moved})]


def audit_cross_variant_dtypes(subjects: Sequence[AuditSubject]
                               ) -> List[Finding]:
    """JX004: same-named state leaves agree on dtype across the variants of
    a ``dtype_group``."""
    seen: Dict[Tuple[str, str], Dict[str, str]] = {}
    for subj in subjects:
        trace = trace_round(subj)
        leaves = trace.leaves_out or trace.leaves_in
        for key, (_, dtype, _, _) in leaves.items():
            seen.setdefault((subj.dtype_group, key), {})[subj.name] = str(dtype)
    findings = []
    for (group, key), per in sorted(seen.items()):
        if len(set(per.values())) > 1:
            detail = ", ".join(f"{s}: {dt}" for s, dt in sorted(per.items()))
            findings.append(Finding(
                checker="rounds", rule="JX004", location=key,
                message=f"state leaf {key} dtype drifts across round "
                        f"variants ({detail})",
                data={"leaf": key, "group": group, "variants": per}))
    return findings


# ------------------------------------------------------------- subjects

TINY = dict(d_model=32, num_heads=2, num_kv_heads=1, d_ff=64, vocab_size=64,
            attn_chunk=8, remat=False)


def tiny_models():
    """The reference audit's tiny pair (``_tiny_models``): target 2 layers,
    drafter 1, d 32, bf16, on the CPU."""
    from ..configs.base import ModelConfig
    from ..models.model import Model
    t = Model(ModelConfig(name="t", arch_type="dense", num_layers=2, **TINY),
              device="cpu")
    d = Model(ModelConfig(name="d", arch_type="dense", num_layers=1, **TINY),
              device="cpu")
    return t, d


def to_fake_cuda(tree, mode: FakeTensorMode):
    """``tree``'s tensors as fake tensors of ``mode`` on the CUDA device,
    with the same shapes, dtypes and aliasing (tensors that share storage
    share it as fakes too)."""
    def conv(t):
        f = mode.from_tensor(t)
        f.fake_device = CUDA
        return f
    return tree_map_only(torch.Tensor, conv, tree)


def build_audit_subjects(include_engine: bool = True) -> List[AuditSubject]:
    """Round variants on the tiny pair, their parameters and states fake
    CUDA tensors: chain (gamma 2), the same with int8 KV caches and with
    the quality buffers, tree (2, 1), an EAGLE head drafter's chain and
    tree rounds, and the continuous engine's chain and tree rounds over its
    paged state. The prefill states come from the port's own
    ``_prefill_state`` run on the fake tensors; the engine's from a real
    tiny engine on the CPU, stepped into its decode phase. Each round is
    audited in its steady state: the tree's tables are on the card
    already, as after a first round."""
    from ..core.speculative import (SDConfig, _prefill_state,
                                    init_quality_buffer, sd_round)
    from ..draftheads.drafter import HeadDrafter
    from ..draftheads.heads import HeadConfig
    from ..spectree.round import tree_round
    from ..spectree.tree import TreeSpec

    t, d = tiny_models()
    mode = FakeTensorMode()
    tp = to_fake_cuda(t.init(0), mode)
    dp = to_fake_cuda(d.init(1), mode)
    head = HeadDrafter(HeadConfig.for_target("eagle", t.cfg))
    hp = to_fake_cuda(head.init(2, device="cpu"), mode)
    gen = torch.Generator().manual_seed(0)
    prompt = to_fake_cuda(torch.randint(0, 64, (2, 8)), mode)
    chain = SDConfig(gamma=2, temperature=0.0)
    tree = TreeSpec((2, 1))

    def state_for(draft, dparams, sdc, max_total=32):
        with mode, _FakeCuda([]):
            return _prefill_state(draft, t, dparams, tp, prompt, max_total,
                                  sdc, gen)

    def chain_fn(draft, dparams, sdc):
        return lambda st: sd_round(draft, t, sdc, dparams, tp, st, gen)

    def tree_fn(draft, dparams, sdc, spec):
        return lambda st: tree_round(draft, t, sdc, spec, dparams, tp, st, gen)

    with mode:
        tree.on(CUDA)        # the tables a first round copies to the card
    quant = SDConfig(gamma=2, temperature=0.0, kv_quant=True)
    qual = SDConfig(gamma=2, temperature=0.0, quality=True)
    st_q = state_for(d, dp, qual)
    with mode:
        st_q["qual"] = init_quality_buffer(2, qual.gamma, CUDA)
    subjects = [
        AuditSubject("chain_round", chain_fn(d, dp, chain),
                     state_for(d, dp, chain), mode),
        AuditSubject("chain_round_kv_quant", chain_fn(d, dp, quant),
                     state_for(d, dp, quant), mode, dtype_group="kv_int8"),
        AuditSubject("chain_round_quality", chain_fn(d, dp, qual), st_q, mode),
        AuditSubject("tree_round", tree_fn(d, dp, chain, tree),
                     state_for(d, dp, chain, max_total=40), mode),
        AuditSubject("head_chain_round", chain_fn(head, hp, chain),
                     state_for(head, hp, chain), mode),
        AuditSubject("head_tree_round", tree_fn(head, hp, chain, tree),
                     state_for(head, hp, chain, max_total=40), mode),
    ]
    if include_engine:
        subjects.extend(build_engine_subjects(mode))
    return subjects


def warm_engine(t, tp, d, dp, tree=None, sdc=None, max_batch=2,
                prompt_len=12, max_new=64, page_size=8):
    """A continuous engine over (t, d) with a request of ``prompt_len``
    random tokens and ``max_new`` new ones in each of its ``max_batch``
    slots, stepped until every slot decodes and two decode rounds have run:
    its state is then the steady one a decode round sees."""
    from ..core.speculative import SDConfig
    from ..serving.continuous import ContinuousEngine
    from ..serving.scheduler import ServeRequest
    eng = ContinuousEngine(target=t, target_params=tp, draft=d,
                           draft_params=dp,
                           sd=sdc or SDConfig(gamma=2, temperature=0.0),
                           tree=tree, max_batch=max_batch,
                           max_seq_len=prompt_len + max_new,
                           page_size=page_size)
    rng = np.random.default_rng(0)
    V = t.cfg.vocab_size
    for rid in range(max_batch):
        eng.submit(ServeRequest(
            prompt=rng.integers(0, V, prompt_len).astype(np.int32),
            max_new_tokens=max_new, request_id=rid))
    for _ in range(64 + 4 * max_batch):
        eng.step()
        if eng.telemetry.decode_rounds >= 2 and \
                all(s.state == "decode" for s in eng._slots):
            return eng
    raise RuntimeError("engine never reached its steady decode state")


def build_engine_subjects(mode: Optional[FakeTensorMode] = None
                          ) -> List[AuditSubject]:
    """The decode round over the paged state the continuous engine feeds it
    (active mask, page table, pooled caches), chain and tree (2, 1): a real
    tiny engine on the CPU is stepped into decode, then its state and the
    parameters become fake CUDA tensors, so the layout cannot drift from
    the engine's."""
    from ..core.speculative import sd_round
    from ..spectree.round import tree_round
    from ..spectree.tree import TreeSpec

    mode = mode or FakeTensorMode()
    t, d = tiny_models()
    tp, dp = t.init(0), d.init(1)
    gen = torch.Generator().manual_seed(2)
    ftp, fdp = to_fake_cuda(tp, mode), to_fake_cuda(dp, mode)
    subjects = []
    for name, spec in (("engine_chain_round", None),
                       ("engine_tree_round", TreeSpec((2, 1)))):
        eng = warm_engine(t, tp, d, dp, tree=spec)
        sdc = eng.sd
        if spec is not None:
            with mode:
                spec.on(CUDA)
        if spec is None:
            def fn(st, sdc=sdc):
                return sd_round(d, t, sdc, fdp, ftp, st, gen)
        else:
            def fn(st, sdc=sdc, spec=spec):
                return tree_round(d, t, sdc, spec, fdp, ftp, st, gen)
        subjects.append(AuditSubject(name, fn, to_fake_cuda(eng._state, mode),
                                     mode))
    return subjects


# --------------------------------------------------------------- driver

def run_round_audit(subjects: Optional[Sequence[AuditSubject]] = None
                    ) -> FindingSet:
    """Every rule on every subject; returns all findings, with each
    subject's kernel launches (as recorded) in the stats."""
    if subjects is None:
        subjects = build_audit_subjects()
    fs = FindingSet()
    launches = {}
    for subj in subjects:
        trace = trace_round(subj)
        launches[subj.name] = trace.kernel_calls
        fs.extend(audit_host_reentry(subj.name, trace))
        fs.extend(audit_state_stability(subj.name, trace))
        fs.extend(audit_in_place(subj.name, trace))
    fs.extend(audit_cross_variant_dtypes(subjects))
    fs.stats = {"subjects": [s.name for s in subjects],   # type: ignore[attr-defined]
                "kernel_calls": launches, "device": "fake cuda"}
    return fs


def run_live_round(name: str, fn: Callable, state) -> Tuple[FindingSet, Dict]:
    """One round on the card: ``fn(state) -> (new_state, n_acc)`` under
    ``torch.cuda.set_sync_debug_mode("error")`` (a sync raises: JX001),
    then JX002 and JX003 on its real tensors. Returns the findings and the
    new state (the input's where the round failed)."""
    fs = FindingSet()
    leaves_in = state_leaves(state)
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        new_state, _ = fn(state)
    except RuntimeError as e:
        where = [f"{f.filename.split('/src/')[-1]}:{f.lineno}"
                 for f in traceback.extract_tb(e.__traceback__)
                 if "repro_torch" in f.filename]
        fs.add(Finding(checker="rounds", rule="JX001", location=name,
                       message=f"the round synchronised with the host at "
                               f"{where[-1] if where else '?'}: "
                               f"{str(e)[:200]}",
                       data={"subject": name, "error": str(e),
                             "stack": where}))
        return fs, state
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    trace = RoundTrace([], leaves_in, state_leaves(new_state), None, {})
    fs.extend(audit_state_stability(name, trace))
    fs.extend(audit_in_place(name, trace))
    return fs, new_state


def run_live_audit(draft, target, d_params, t_params, prompt, sdc, spec,
                   gen) -> Tuple[FindingSet, Dict]:
    """``run_live_round`` on the card for a chain round (``spec`` None) or a
    tree round of ``spec``, after a prefill of ``prompt`` and one warm-up
    round (the tree's tables are then on the card, as in serving). Returns
    the findings and what the audited round launched."""
    from ..core.speculative import _prefill_state, sd_round
    from ..kernels import ops
    from ..spectree.round import tree_round
    S = prompt.shape[1]
    slack = sdc.gamma if spec is None else spec.num_nodes
    state = _prefill_state(draft, target, d_params, t_params, prompt,
                           S + 4 * (slack + 2), sdc, gen)

    def fn(st):
        if spec is None:
            return sd_round(draft, target, sdc, d_params, t_params, st, gen)
        return tree_round(draft, target, sdc, spec, d_params, t_params, st,
                          gen)

    state, _ = fn(state)
    torch.cuda.synchronize()
    ops.reset_launches()
    name = "chain_round" if spec is None else "tree_round"
    fs, _ = run_live_round(name, fn, state)
    torch.cuda.synchronize()
    return fs, dict(ops.LAUNCHES)


def run_tiny_live_audit() -> FindingSet:
    """``run_live_audit`` of the tiny pair on the card: a chain round
    (gamma 2) and a tree round (2, 1)."""
    from ..core.speculative import SDConfig
    from ..models.model import Model
    from ..spectree.tree import TreeSpec
    t, d = tiny_models()
    t, d = Model(t.cfg, device="cuda"), Model(d.cfg, device="cuda")
    tp, dp = t.init(0), d.init(1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    prompt = torch.randint(0, t.cfg.vocab_size, (2, 8), device="cuda",
                           generator=gen)
    fs = FindingSet()
    launches = {}
    for spec in (None, TreeSpec((2, 1))):
        got, n = run_live_audit(d, t, dp, tp, prompt,
                                SDConfig(gamma=2, temperature=0.0), spec, gen)
        fs.extend(got)
        launches["chain" if spec is None else "tree"] = n
    fs.stats = {"live_launches": launches}   # type: ignore[attr-defined]
    return fs
