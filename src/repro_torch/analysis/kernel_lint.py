"""Kernel lint: every CUDA kernel instance against Hopper's limits, and the
wrappers' launch plans across swept shapes (the port of
``repro.analysis.kernel_lint``, whose subject was the Pallas BlockSpecs).

The wrappers (``kernels/tree_attention.py``, ``flash_decode.py``,
``quant_matmul.py``, ``distill_loss.py``) build a ``kernels.launch.
LaunchPlan`` from shapes alone and launch from it. This linter recovers
the plan each wrapper would launch for a problem shape by calling it on
fake CUDA tensors with the wrapper's launching function replaced by a
recorder (``capture_kernel_calls``: the real checks and planning run, no
kernel does), and asks the card, through each library's query entry, for
the resources of every instance the launchers can pick:

  KN001  residency (on the card): registers a thread <= 255, registers x
         threads <= 65,536, static + dynamic shared memory <= 232,448 B,
         the dynamic bytes the launcher asks for accepted, and at least
         one block an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
         ptxas spill bytes are a warning.
  KN002  launch plan: chunk x splits covers the slots (or K rows) in
         whole steps, no split empty; grid y and z <= 65,535; a cluster
         <= 8 blocks. A wrapper that refuses a swept shape is a finding.
  KN003  dtype rule: partial-sum and output buffers a wrapper allocates
         are float32.
  KN004  alignment (warning): a K/V, weight or logits row whose bytes are
         not a multiple of 128 starts rows off a cache line.

Shapes are the reference's sweep: its tiny CI config and 7B-class serving
shapes. On the CPU the plans use the H100's 132 SMs, and one block an SM
stands in for the card's answer on flash decode's clusters; KN001 needs
the card and is left out by name.
"""
from __future__ import annotations

import contextlib
import ctypes
import re
import shutil
import subprocess
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .findings import ERROR, WARN, Finding, FindingSet
from .repolint import Rule

# Hopper's limits (the hopper-kernels guide's table)
SMEM_PER_BLOCK = 232_448
REGS_PER_SM = 65_536
REGS_PER_THREAD = 255
GRID_YZ = 65_535
MAX_CLUSTER = 8                 # the portable cluster size
ROW_ALIGN = 128                 # bytes: one cache line
H100_SMS = 132                  # the SXM part's SMs: the CPU stand-in
INFO_INTS = 8                   # csrc/kernel_info.cuh's KERNEL_INFO_INTS
CARD_ONLY = "KN001 (registers, shared memory and occupancy from the CUDA " \
            "runtime: needs the card)"

RULES: Dict[str, Rule] = {r.rule_id: r for r in [
    Rule("KN001", "kernel instance not resident on Hopper",
         "Every instance a launcher can pick must fit an SM of the H100: at "
         "most 255 registers a thread and 65,536 an SM for its block, at "
         "most 232,448 B of static plus dynamic shared memory a block, the "
         "dynamic bytes the launcher asks for accepted by "
         "cudaFuncSetAttribute, and at least one block an SM "
         "(cudaOccupancyMaxActiveBlocksPerMultiprocessor). An instance "
         "that fails never launches, and only its first real call would "
         "say so. Each library's <name>_query entry picks the instance "
         "with its launcher's own code and reports the runtime's numbers; "
         "ptxas spills are a warning."),
    Rule("KN002", "launch plan does not cover the work",
         "A wrapper's plan splits the slots (or K rows) of a problem into "
         "splits chunks, each a whole number of the block's loop steps, "
         "none empty; the grid's y and z stay within 65,535 and a cluster "
         "within 8 blocks. A wrapper that refuses a swept shape, or "
         "launches nothing at it, breaks the shape contract the callers "
         "rely on."),
    Rule("KN003", "partial sums or outputs not float32",
         "Split-KV partial states, K-slice partial sums and the kernels' "
         "outputs are float32: a bf16 buffer would round every partial "
         "result before the combine adds them."),
    Rule("KN004", "row not a multiple of 128 bytes",
         "A K/V, weight or logits row whose bytes are not a multiple of "
         "128 starts rows off a cache line, so a row's reads touch one "
         "more line. A warning: small heads and tiny test shapes have such "
         "rows by nature."),
]}

PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
PTXAS_USE = re.compile(r"Used (\d+) registers")
PTXAS_SMEM = re.compile(r"(\d+) bytes smem")
PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def ptxas_records(log: str) -> List[Dict]:
    """Each kernel instance of nvcc's -Xptxas -v output: its name
    (demangled, without namespace and parameters, where c++filt exists),
    registers, static shared memory and spill bytes."""
    names, rows, spill = [], [], (0, 0)
    for ln in log.splitlines():
        if m := PTXAS_ENTRY.search(ln):
            names.append(m[1])
            spill = (0, 0)
        elif m := PTXAS_SPILL.search(ln):
            spill = (int(m[1]), int(m[2]))
        elif (m := PTXAS_USE.search(ln)) and names:
            smem = PTXAS_SMEM.search(ln)
            rows.append({"name": names[-1], "registers": int(m[1]),
                         "smem": int(smem[1]) if smem else 0,
                         "spill_stores": spill[0], "spill_loads": spill[1]})
    if rows and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"],
                             input="\n".join(r["name"] for r in rows),
                             capture_output=True, text=True,
                             timeout=60).stdout
        for r, name in zip(rows, out.splitlines()):
            name = name.replace("(anonymous namespace)::", "").split("(")[0]
            r["name"] = name.removeprefix("void ")
    return rows


def ptxas_report(log: str) -> List[str]:
    """``ptxas_records`` as one line each."""
    return [f"{r['name']}: {r['registers']} registers, {r['smem']} B static "
            f"smem, spills {r['spill_stores']}/{r['spill_loads']} B"
            for r in ptxas_records(log)]


# ------------------------------------------------------------ the recorder

def _stand_in_clusters(sms):
    """Flash decode's occupancy answer off the card: one block an SM."""
    return lambda G, hd, dtype: (lambda splits: sms // splits)


@contextlib.contextmanager
def capture_kernel_calls(sms: int = H100_SMS,
                         clusters: Optional[Callable] = None):
    """Replace each wrapper's launching function (``tree_attention``,
    ``flash_decode``, ``quant_matmul``, and the three distill-loss entries)
    by a recorder for the block: the wrapper's checks and ``launch_plan``
    run, the outputs are new tensors of the plan's shape on the input's
    device (fake ones under a ``FakeTensorMode``), no kernel is built or
    launched, and ``kernels.ops.LAUNCHES`` is left as it was. ``clusters``
    gives flash decode's occupancy answer for an instance, ``(G, hd,
    dtype) -> (splits -> clusters)``, by default one block an SM. Yields
    the list of the calls' ``LaunchPlan``s, in call order."""
    from ..kernels import distill_loss as dk
    from ..kernels import flash_decode as fk
    from ..kernels import ops
    from ..kernels import quant_matmul as qk
    from ..kernels import tree_attention as tk

    calls = []
    clusters = clusters or _stand_in_clusters(sms)

    def record(plan, x):
        calls.append(plan)
        return plan.allocate(x.device)["out"]

    def tree(q, k, v, mask, softcap=None):
        tk._check(q, k, v, mask)
        return record(tk.launch_plan(*q.shape, k.shape[1], q.dtype, sms), q)

    def flash(q, k, v, mask, softcap=None):
        fk._check(q, k, v, mask)
        G, hd = q.shape[2], q.shape[3]
        return record(fk.launch_plan(*q.shape, k.shape[1], q.dtype, sms,
                                     clusters(G, hd, q.dtype)), q)

    def quant(x, q, scale, bits, group=0):
        qk._check(x, q, scale, bits, group)
        return record(qk.launch_plan(x.shape[0], x.shape[1], q.shape[1],
                                     bits, group, x.dtype), x)

    def lse(x):
        dk._check_logits("x", x)
        return record(dk.launch_plan("row_logsumexp", *x.shape), x)

    def terms(s, t, lse_s, lse_t, mu, inv_sigma, mode="tvdpp"):
        dk._check_logits("s", s)
        dk._check_logits("t", t, like=s)
        return tuple(record(dk.launch_plan("loss_terms", *s.shape, mode), s))

    def grad(s, t, lse_s, lse_t, c, g_rows, mu, inv_sigma, mode="tvdpp"):
        dk._check_logits("s", s)
        dk._check_logits("t", t, like=s)
        return record(dk.launch_plan("loss_grad", *s.shape, mode), s)

    patches = [(tk, "tree_attention", tree), (fk, "flash_decode", flash),
               (qk, "quant_matmul", quant), (dk, "row_logsumexp", lse),
               (dk, "loss_terms", terms), (dk, "loss_grad", grad)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    launches = dict(ops.LAUNCHES)
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        ops.LAUNCHES.update(launches)


# ------------------------------------------------------------------ rules

def lint_plan(plan, case: str) -> List[Finding]:
    """KN002-KN004 over one launch plan."""
    findings = []
    loc = f"{plan.kernel}[{case}]"

    def add(rule, message, severity=ERROR, **data):
        findings.append(Finding(checker="kernel", rule=rule, location=loc,
                                message=message, severity=severity,
                                data={"kernel": plan.kernel, "case": case,
                                      **data}))

    if plan.chunk % plan.step or plan.splits < 1 or \
            not (plan.splits - 1) * plan.chunk < plan.extent \
            <= plan.splits * plan.chunk:
        add("KN002", f"{plan.splits} splits of {plan.chunk} (step "
                     f"{plan.step}) do not cover {plan.extent} in whole steps "
                     f"with no split empty",
            chunk=plan.chunk, splits=plan.splits, step=plan.step,
            extent=plan.extent)
    for launch in plan.launches:
        if max(launch.grid[1:]) > GRID_YZ:
            add("KN002", f"{launch.symbol}: grid {launch.grid} exceeds "
                         f"{GRID_YZ} in y or z", grid=list(launch.grid))
        if launch.cluster > MAX_CLUSTER:
            add("KN002", f"{launch.symbol}: a cluster of {launch.cluster} "
                         f"blocks exceeds the portable {MAX_CLUSTER}",
                cluster=launch.cluster)
    for name, shape, dtype in plan.buffers:
        if dtype.is_floating_point and dtype != torch.float32:
            add("KN003", f"buffer {name} {tuple(shape)} is {dtype}; partial "
                         f"sums and outputs must be float32",
                buffer=name, dtype=str(dtype))
    for operand, nbytes in plan.rows:
        if nbytes % ROW_ALIGN:
            add("KN004", f"a row of {operand} is {nbytes} B, not a multiple "
                         f"of {ROW_ALIGN}: rows start off a cache line",
                severity=WARN, operand=operand, row_bytes=nbytes)
    return findings


@dataclass
class InstanceRecord:
    """One compiled kernel instance's resources as the CUDA runtime reports
    them (``kernel_info.cuh``), with ptxas's spill bytes."""

    symbol: str
    library: str
    registers: int
    static_smem: int
    dynamic_smem: int
    local_bytes: int
    max_threads: int
    threads: int
    blocks_per_sm: int
    smem_error: int = 0
    spill_stores: Optional[int] = None
    spill_loads: Optional[int] = None

    def to_dict(self) -> Dict:
        return dict(self.__dict__)


def lint_instance(rec: InstanceRecord) -> List[Finding]:
    """KN001 over one instance: errors for what keeps it from being
    resident, a warning for spills."""
    out = []

    def add(message, severity=ERROR):
        out.append(Finding(checker="kernel", rule="KN001",
                           location=f"{rec.library}:{rec.symbol}",
                           message=message, severity=severity,
                           data=rec.to_dict()))

    smem = rec.static_smem + rec.dynamic_smem
    if rec.registers > REGS_PER_THREAD:
        add(f"{rec.registers} registers a thread exceed {REGS_PER_THREAD}")
    if rec.registers * rec.threads > REGS_PER_SM:
        add(f"{rec.registers} registers x {rec.threads} threads = "
            f"{rec.registers * rec.threads} exceed the SM's {REGS_PER_SM}")
    if rec.threads > rec.max_threads:
        add(f"{rec.threads} threads a block exceed the instance's "
            f"{rec.max_threads}")
    if smem > SMEM_PER_BLOCK:
        add(f"{rec.static_smem} B static + {rec.dynamic_smem} B dynamic "
            f"shared memory exceed {SMEM_PER_BLOCK} B")
    if rec.smem_error:
        add(f"the runtime refused {rec.dynamic_smem} B of dynamic shared "
            f"memory (CUDA error {rec.smem_error})")
    if rec.blocks_per_sm < 1:
        add("no block of the instance fits an SM at the launcher's threads "
            "and dynamic shared memory")
    if rec.spill_stores or rec.spill_loads:
        add(f"ptxas spills {rec.spill_stores} B stores / {rec.spill_loads} "
            f"B loads", severity=WARN)
    return out


# ------------------------------------------------------------------ sweep

@dataclass
class KernelCase:
    """One (wrapper, shapes) lint case: ``fn`` is called with tensors of
    ``args`` (shape, dtype) made on the fake CUDA device, plus
    ``kwargs``."""

    name: str
    fn: Callable
    args: Tuple
    kwargs: Dict = field(default_factory=dict)


def build_kernel_cases() -> List[KernelCase]:
    """The reference's sweep (``repro.analysis.kernel_lint
    .build_kernel_cases``): its tiny CI config (d 32, 2 heads, 1 KV head,
    ff 64, vocab 64) and 7B-class serving shapes (head dim 128, d 4096, ff
    11008, vocab 32000), each attention case in bf16 and float32 (the
    port's kernels take both; q shares the cache's dtype)."""
    from ..kernels import distill_loss as dk
    from ..kernels import flash_decode as fk
    from ..kernels import quant_matmul as qk
    from ..kernels import tree_attention as tk

    d_model, heads, kv, d_ff, vocab = 32, 2, 1, 64, 64
    hd_small, hd_big = d_model // heads, 128
    f32, bf16, i8, u8, b = (torch.float32, torch.bfloat16, torch.int8,
                            torch.uint8, torch.bool)
    cases: List[KernelCase] = []

    def call(mod, name):
        return lambda *a, **kw: getattr(mod, name)(*a, **kw)

    for tag, (M, K, N) in [("tiny", (8, d_model, d_ff)),
                           ("7b_qkv", (16, 4096, 4096)),
                           ("7b_ffn", (16, 4096, 11008))]:
        for bits in (8, 4):
            group = 0 if bits == 8 else (128 if K >= 128 else 16)
            q = ((K // 2, N), u8) if bits == 4 else ((K, N), i8)
            s = ((K // group, N), f32) if bits == 4 else ((1, N), f32)
            for xdt in (bf16, f32):
                cases.append(KernelCase(
                    f"quant_matmul_int{bits}_{tag}_{str(xdt)[6:]}",
                    call(qk, "quant_matmul"), (((M, K), xdt), q, s),
                    {"bits": bits, "group": group}))
    for tag, (B, Hkv, G, hd, S) in [
            ("tiny", (4, kv, heads // kv, hd_small, 256)),
            ("7b_gqa", (8, 8, 4, hd_big, 4096))]:
        for dt in (bf16, f32):
            cases.append(KernelCase(
                f"flash_decode_{tag}_{str(dt)[6:]}", call(fk, "flash_decode"),
                (((B, Hkv, G, hd), dt), ((B, S, Hkv, hd), dt),
                 ((B, S, Hkv, hd), dt), ((B, S), b))))
    for tag, (B, Hkv, N, G, hd, S) in [
            ("tiny", (4, kv, 7, heads // kv, hd_small, 256)),
            ("7b_gqa", (8, 8, 15, 4, hd_big, 4096))]:
        for dt in (bf16, f32):
            cases.append(KernelCase(
                f"tree_attention_{tag}_{str(dt)[6:]}",
                call(tk, "tree_attention"),
                (((B, Hkv, N, G, hd), dt), ((B, S, Hkv, hd), dt),
                 ((B, S, Hkv, hd), dt), ((B, N, S), b))))
    for tag, (R, V) in [("tiny", (64, vocab)), ("7b_vocab", (256, 32000))]:
        lg, row, one = ((R, V), f32), ((R,), f32), ((1,), f32)
        cases.append(KernelCase(f"row_logsumexp_{tag}",
                                call(dk, "row_logsumexp"), (lg,)))
        cases.append(KernelCase(
            f"loss_terms_{tag}", call(dk, "loss_terms"),
            (lg, lg, row, row, one, one), {"mode": "tvdpp"}))
        cases.append(KernelCase(
            f"loss_grad_{tag}", call(dk, "loss_grad"),
            (lg, lg, row, row, row, row, one, one), {"mode": "tvdpp"}))
    return cases


def plan_cases(cases: Sequence[KernelCase], sms: int = H100_SMS,
               clusters: Optional[Callable] = None):
    """Each case's recorded plans, or the exception its wrapper raised:
    [(case, [LaunchPlan] or exception)], the tensors fake, on "cuda"."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    out = []
    mode = FakeTensorMode()
    for case in cases:
        with capture_kernel_calls(sms, clusters) as calls, mode:
            try:
                args = [torch.empty(shape, dtype=dt, device="cuda")
                        for shape, dt in case.args]
                case.fn(*args, **case.kwargs)
            except (ValueError, RuntimeError) as e:
                out.append((case, e))
                continue
        out.append((case, list(calls)))
    return out


def all_instance_plans():
    """One plan for every kernel instance the launchers can pick (by dtype,
    head dim, rows a block, bits, mode), the split-combining kernel of tree
    attention included; the card's query answers each plan's instances."""
    from ..kernels import distill_loss as dk
    from ..kernels import flash_decode as fk
    from ..kernels import quant_matmul as qk
    from ..kernels import tree_attention as tk
    plans = []
    for dt in (torch.float32, torch.bfloat16):
        for hd in tk.HEAD_DIMS:
            for rows in (1, 2, 4, 8):
                plans.append(tk.launch_plan(1, 1, rows, 1, hd, 65536, dt,
                                            H100_SMS))
            for G in (1, 2, 4, 8, 16):
                plans.append(fk.launch_plan(
                    1, 1, G, hd, 4096, dt, H100_SMS,
                    _stand_in_clusters(H100_SMS)(G, hd, dt)))
        for bits in (8, 4):
            for M in (8, 16, 32, 64):
                plans.append(qk.launch_plan(M, 1024, 1024, bits,
                                            0 if bits == 8 else 128, dt))
    for name in dk.KERNELS:
        for mode in (("tvdpp",) if name == "row_logsumexp" else dk.MODES):
            plans.append(dk.launch_plan(name, 1, 1024, mode))
    seen, unique = set(), []
    for p in plans:
        key = tuple(launch.symbol for launch in p.launches)
        if key not in seen:
            seen.add(key)
            unique.append(p)
    return unique


def query_instances(plans) -> List[InstanceRecord]:
    """Each plan's instances, asked of the card through the library's
    ``<library>_query`` (one ctypes call a plan; the library is built
    first where needed), with ptxas's spills from the build log."""
    from ..kernels import build
    logs = build.build_all(sorted({p.library for p in plans}))
    spills = {r["name"]: r for log in logs.values()
              for r in ptxas_records(log)}
    records, seen = [], set()
    for p in plans:
        fn = getattr(build.load(p.library), f"{p.library}_query")
        fn.restype = ctypes.c_int
        info = (ctypes.c_int * (INFO_INTS * len(p.launches)))()
        err = fn(*(ctypes.c_int(v) for v in p.query), info)
        if err != 0:
            raise RuntimeError(f"{p.library}_query{p.query} failed with CUDA "
                               f"error {err}")
        for i, launch in enumerate(p.launches):
            if launch.symbol in seen:
                continue
            seen.add(launch.symbol)
            v = info[INFO_INTS * i:INFO_INTS * (i + 1)]
            ptx = spills.get(launch.symbol, {})
            records.append(InstanceRecord(
                launch.symbol, p.library, *v,
                spill_stores=ptx.get("spill_stores"),
                spill_loads=ptx.get("spill_loads")))
    return records


def run_kernel_lint(device: str = "cuda",
                    cases: Optional[Sequence[KernelCase]] = None
                    ) -> FindingSet:
    """The plans of every swept case (KN002-KN004) and, on the card, every
    instance's resources (KN001); a wrapper that refuses a swept shape is a
    KN002 finding, one that launches nothing a KN002 warning. On the CPU
    KN001 is left out and named in the stats."""
    if cases is None:
        cases = build_kernel_cases()
    sms, clusters = H100_SMS, None
    if device == "cuda":
        from ..kernels import flash_decode as fk
        sms = torch.cuda.get_device_properties(0).multi_processor_count

        def clusters(G, hd, dtype):
            return fk.device_clusters(0, G, hd, dtype)
    fs = FindingSet()
    n_plans = 0
    for case, got in plan_cases(cases, sms, clusters):
        if isinstance(got, Exception):
            fs.add(Finding(
                checker="kernel", rule="KN002", location=case.name,
                message=f"kernel wrapper refused the swept shape: "
                        f"{type(got).__name__}: {str(got)[:200]}",
                data={"case": case.name, "error": str(got)}))
            continue
        if not got:
            fs.add(Finding(
                checker="kernel", rule="KN002", severity=WARN,
                location=case.name,
                message="no kernel launch observed (the wrapper bypassed "
                        "its kernel at this shape)", data={"case": case.name}))
        for plan in got:
            n_plans += 1
            fs.extend(lint_plan(plan, case.name))
    stats = {"cases": len(cases), "plans": n_plans, "sms": sms,
             "smem_per_block": SMEM_PER_BLOCK, "regs_per_sm": REGS_PER_SM}
    if device == "cuda":
        records = query_instances(all_instance_plans())
        for rec in records:
            fs.extend(lint_instance(rec))
        stats["instances"] = [r.to_dict() for r in records]
        stats["flash_decode_clusters"] = "asked of the card"
    else:
        stats["left_out"] = [CARD_ONLY]
        stats["flash_decode_clusters"] = "stand-in: one block an SM"
    fs.stats = stats   # type: ignore[attr-defined]
    return fs
