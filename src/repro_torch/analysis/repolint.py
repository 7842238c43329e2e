"""Repo-rule AST linter: project-specific invariants ruff cannot express
(the port of ``repro.analysis.repolint``, over ``src/repro_torch``).

Five rules, each encoding a contract the port's design states in prose:

  RL001 host conversion in a *round module*: ``.item()`` / ``.tolist()``
        / ``.cpu()`` / ``.numpy()``, ``float()`` / ``int()`` / ``bool()``
        of a value, ``np.asarray()`` / ``np.array()``. On a CUDA tensor each
        waits for the card and copies to the host: inside a speculative
        round it stalls the launch queue every round and makes the round
        impossible to capture in a CUDA graph. Scope is the modules whose
        functions a round runs (``ROUND_MODULES``); host drivers living in
        those modules are allowlisted by function.
  RL002 unbudgeted host sync: ``.item()`` / ``.cpu()`` / ``.tolist()`` /
        ``.numpy()`` outside the round modules, or ``torch.cuda.synchronize``
        / an event's ``.synchronize()`` anywhere, outside the allowlist of
        modules that are entitled to wait for the card: the engines' one
        fetch a round, the generate drivers, offline quantization,
        observability, the launchers, experiments and training loops, and
        the analysis that counts the fetches.
  RL003 mutable module-level state: a module-level list/dict/set that the
        module itself mutates (process-global state that survives across
        engines and tests); the sanctioned registries carry per-line
        justifications.
  RL004 non-frozen Config dataclass: ``*Config`` classes key
        ``lru_cache`` factories and are shared by engines, so they must be
        ``frozen=True``.

Allowlists are per-rule and structural (module or module::function).
Per-line suppressions use ``# repolint: ignore[RLxxx] <reason>`` — the
reason is mandatory; a bare suppression is itself reported (RL000).
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from .findings import Finding, FindingSet

SUPPRESS_RE = re.compile(r"#\s*repolint:\s*ignore\[(RL\d{3})\]\s*(.*)")

# modules whose functions a speculative round runs (RL001 scope); paths
# are relative to the lint root (src/); an entry ending in "/" covers its
# package
ROUND_MODULES = (
    "repro_torch/core/speculative.py",
    "repro_torch/core/sampling.py",
    "repro_torch/spectree/round.py",
    "repro_torch/models/",
    "repro_torch/kernels/",
    "repro_torch/quant/kvcache.py",
    "repro_torch/draftheads/drafter.py",
    "repro_torch/draftheads/heads.py",
)

# host drivers in round modules: they call the rounds and own the per-round
# host mirror, or wait for the card to time it (reason after each entry)
RL001_FUNCTION_ALLOWLIST = {
    # the one fetch a round of the static drivers: lengths and n_acc
    "repro_torch/core/speculative.py::run_rounds",
    # AR baseline driver: one decode call a token, timed after a sync
    "repro_torch/core/speculative.py::autoregressive_generate",
}

# modules allowed to wait for the card (RL002), each with its reason
RL002_MODULE_ALLOWLIST = {
    "repro_torch/serving/continuous.py":
        "the one fetch a decode round (fetch_to_host) and the fenced "
        "phase timing (_fence) of time_phases",
    "repro_torch/serving/engine.py":
        "the static engine's drivers: the finished tokens and the round "
        "statistics, once a request batch",
    "repro_torch/core/speculative.py::sync":
        "the drivers' wait before a host clock read",
    "repro_torch/quant/":
        "offline weight quantization and calibration, before serving",
    "repro_torch/obs/":
        "observability: profiles and reports read the card once a window",
    "repro_torch/launch/":
        "the command-line launchers and the dry run, outside the rounds",
    "repro_torch/experiments/":
        "the paper's pipeline: host-side metrics between phases",
    "repro_torch/training/":
        "training loops: the loss read back once a logged step",
    "repro_torch/draftheads/train.py":
        "head training: the loss read back once a logged step",
    "repro_torch/checkpoint/":
        "checkpoint files: parameters copied to the host once a save",
    "repro_torch/core/datagen.py":
        "distillation data: the generated tokens go to the host once a "
        "batch",
    "repro_torch/analysis/":
        "the checkers: they count and compare fetches and syncs",
}

_HOST_CALLS = {"float", "int", "bool"}
_HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
_NP_LEAK_ATTRS = {"asarray", "array"}
_MUTATOR_METHODS = {"append", "extend", "add", "update", "pop", "remove",
                    "clear", "insert", "setdefault", "popitem",
                    "appendleft", "discard"}


@dataclass(frozen=True)
class Rule:
    rule_id: str
    title: str
    explain: str


RULES: Dict[str, Rule] = {r.rule_id: r for r in [
    Rule("RL000", "suppression without reason",
         "A `# repolint: ignore[RLxxx]` comment must carry a reason after "
         "the bracket — the allowlist policy is *justified* per-line "
         "entries, not blanket mutes. Write why this specific line is "
         "exempt from the rule it suppresses."),
    Rule("RL001", "host conversion in a round module",
         ".item()/.tolist()/.cpu()/.numpy(), float()/int()/bool() of a "
         "value and np.asarray()/np.array() bring a value to the host. On "
         "a CUDA tensor each waits for the card: inside a speculative round "
         "that stalls the launch queue every round, and a round that syncs "
         "cannot be captured in a CUDA graph (the remedy for host-bound "
         "serving). Round modules (see ROUND_MODULES) keep all math on the "
         "device; host drivers in those files are allowlisted by function "
         "name. If a line is genuinely host-side static-shape math (e.g. "
         "int(...) of a config or shape value), suppress it with a reason."),
    Rule("RL002", "host sync outside the allowlist",
         "The decode round's one fetch (serving/continuous.py "
         "fetch_to_host) is the port's budgeted host sync: exactly one per "
         "round, checked dynamically by analysis.recompile."
         "audit_round_transfers. .item()/.cpu()/.tolist()/.numpy() or a "
         "torch.cuda/event synchronize in a module outside the allowlist "
         "(RL002_MODULE_ALLOWLIST, each entry with its reason) adds a "
         "device round-trip that every benchmark counts as model time. "
         "Route data through the existing fetch, or argue the case in a "
         "per-line suppression."),
    Rule("RL003", "mutated module-level container",
         "A module-level list/dict/set that the module itself mutates is "
         "process-global hidden state: it survives across engines and "
         "tests, so one run's leftovers change the next (a counter a test "
         "forgot to reset, a cache keyed on a freed device), and it is a "
         "data race once serving goes multi-threaded. Pass state through "
         "constructors, or justify the registry per-line (the kernel "
         "launch counters, the loaded-library and scratch-buffer caches "
         "and the hidden-state tap list are the sanctioned cases)."),
    Rule("RL004", "non-frozen Config dataclass",
         "*Config dataclasses are lru_cache keys and are shared by every "
         "engine and round built from them (SDConfig, ModelConfig, TreeSpec "
         "are all frozen for this reason). A non-frozen config is "
         "unhashable where it matters and, worse, mutable: changing a field "
         "after an engine is built does not rebuild what was derived from "
         "it, so the running system silently keeps the old value. Declare "
         "@dataclass(frozen=True); derive variants with "
         "dataclasses.replace()."),
]}


def in_scope(module: str, scopes) -> bool:
    """``module`` is a listed module, or lies in a listed package."""
    return any(module == s or (s.endswith("/") and module.startswith(s))
               for s in scopes)


def _qual(module: str, funcstack: Sequence[str]) -> str:
    return f"{module}::{funcstack[-1]}" if funcstack else module


class _Visitor(ast.NodeVisitor):
    def __init__(self, module: str, source_lines: List[str]):
        self.module = module
        self.lines = source_lines
        self.findings: List[Tuple[str, int, str, Dict]] = []
        self.func_stack: List[str] = []
        self.class_stack: List[str] = []
        # RL003 bookkeeping: module-level container names -> def line;
        # mutations recorded anywhere in the module
        self.module_containers: Dict[str, int] = {}
        self.mutated: Dict[str, int] = {}
        self.round_module = in_scope(module, ROUND_MODULES)

    # ------------------------------------------------------------ helpers
    def _emit(self, rule: str, line: int, message: str, **data):
        self.findings.append((rule, line, message, data))

    def _in_module_scope(self) -> bool:
        return not self.func_stack and not self.class_stack

    @staticmethod
    def _is_container_value(value: ast.AST) -> bool:
        if isinstance(value, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                              ast.DictComp, ast.SetComp)):
            return True
        if isinstance(value, ast.Call) and isinstance(value.func, ast.Name):
            return value.func.id in {"list", "dict", "set", "defaultdict",
                                     "deque"}
        return False

    # ------------------------------------------------------------ visits
    def visit_FunctionDef(self, node):
        self.func_stack.append(node.name)
        self.generic_visit(node)
        self.func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        self._check_config_dataclass(node)
        self.class_stack.append(node.name)
        self.generic_visit(node)
        self.class_stack.pop()

    def visit_Assign(self, node):
        if self._in_module_scope() and self._is_container_value(node.value):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    self.module_containers[tgt.id] = node.lineno
        self._check_subscript_mutation(node)
        self.generic_visit(node)

    def visit_AnnAssign(self, node):
        if self._in_module_scope() and node.value is not None and \
                self._is_container_value(node.value) and \
                isinstance(node.target, ast.Name):
            self.module_containers[node.target.id] = node.lineno
        self._check_subscript_mutation(node)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        tgt = node.target
        if isinstance(tgt, ast.Name):
            self.mutated.setdefault(tgt.id, node.lineno)
        elif isinstance(tgt, ast.Subscript) and \
                isinstance(tgt.value, ast.Name):
            self.mutated.setdefault(tgt.value.id, node.lineno)
        self.generic_visit(node)

    def visit_Delete(self, node):
        for tgt in node.targets:
            if isinstance(tgt, ast.Subscript) and \
                    isinstance(tgt.value, ast.Name):
                self.mutated.setdefault(tgt.value.id, node.lineno)
        self.generic_visit(node)

    def _check_subscript_mutation(self, assign_node):
        targets = (assign_node.targets
                   if isinstance(assign_node, ast.Assign)
                   else [assign_node.target])
        for tgt in targets:
            if isinstance(tgt, ast.Subscript) and \
                    isinstance(tgt.value, ast.Name):
                self.mutated.setdefault(tgt.value.id, tgt.value.lineno)

    def visit_Call(self, node):
        self._check_host_conversion(node)
        self._check_host_sync(node)
        self._check_mutator_call(node)
        self.generic_visit(node)

    # ------------------------------------------------------------ rules
    def _check_host_conversion(self, node: ast.Call):
        if not self.round_module:
            return
        if _qual(self.module, self.func_stack) in RL001_FUNCTION_ALLOWLIST:
            return
        f = node.func
        leak = None
        if isinstance(f, ast.Name) and f.id in _HOST_CALLS and node.args \
                and not isinstance(node.args[0], ast.Constant):
            leak = f"{f.id}()"
        elif isinstance(f, ast.Attribute):
            if f.attr in _HOST_METHODS:
                leak = f".{f.attr}()"
            elif f.attr in _NP_LEAK_ATTRS and \
                    isinstance(f.value, ast.Name) and \
                    f.value.id in {"np", "numpy"}:
                leak = f"np.{f.attr}()"
        if leak:
            self._emit("RL001", node.lineno,
                       f"{leak} in round module {self.module} — a host "
                       f"conversion waits for the card",
                       call=leak)

    def _check_host_sync(self, node: ast.Call):
        f = node.func
        if not isinstance(f, ast.Attribute):
            return
        if f.attr == "synchronize":
            call = ".synchronize()"
        elif f.attr in _HOST_METHODS and not self.round_module:
            call = f".{f.attr}()"
        else:
            return
        qual = _qual(self.module, self.func_stack)
        if in_scope(self.module, RL002_MODULE_ALLOWLIST) or \
                qual in RL002_MODULE_ALLOWLIST:
            return
        self._emit("RL002", node.lineno,
                   f"{call} in {self.module}: host syncs are budgeted to "
                   f"the allowlisted modules",
                   module=self.module, call=call)

    def _check_mutator_call(self, node: ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _MUTATOR_METHODS and \
                isinstance(f.value, ast.Name):
            self.mutated.setdefault(f.value.id, node.lineno)

    def _check_config_dataclass(self, node: ast.ClassDef):
        if not node.name.endswith("Config"):
            return
        for dec in node.decorator_list:
            frozen = None
            if isinstance(dec, ast.Name) and dec.id == "dataclass":
                frozen = False
            elif isinstance(dec, ast.Call) and (
                    (isinstance(dec.func, ast.Name) and
                     dec.func.id == "dataclass") or
                    (isinstance(dec.func, ast.Attribute) and
                     dec.func.attr == "dataclass")):
                frozen = any(kw.arg == "frozen" and
                             isinstance(kw.value, ast.Constant) and
                             kw.value.value is True
                             for kw in dec.keywords)
            if frozen is False:
                self._emit("RL004", node.lineno,
                           f"dataclass {node.name} is not frozen=True — "
                           f"config objects key jit caches and must be "
                           f"hashable and immutable",
                           cls=node.name)

    # ------------------------------------------------------------ finish
    def finalize(self):
        for name, mline in sorted(self.mutated.items()):
            if name in self.module_containers:
                self._emit("RL003", self.module_containers[name],
                           f"module-level container {name} is mutated at "
                           f"line {mline} — process-global mutable state",
                           name=name, mutated_at=mline)


def _suppression(lines: List[str], lineno: int) -> Optional[Tuple[str, str]]:
    """(rule, reason) if the physical line carries a repolint suppression."""
    if 1 <= lineno <= len(lines):
        m = SUPPRESS_RE.search(lines[lineno - 1])
        if m:
            return m.group(1), m.group(2).strip()
    return None


def lint_file(path: Path, root: Path) -> List[Finding]:
    module = path.relative_to(root).as_posix()
    source = path.read_text()
    lines = source.splitlines()
    tree = ast.parse(source, filename=str(path))
    v = _Visitor(module, lines)
    v.visit(tree)
    v.finalize()
    out: List[Finding] = []
    for rule, lineno, message, data in v.findings:
        sup = _suppression(lines, lineno)
        if sup is not None and sup[0] == rule:
            if sup[1]:
                continue                      # justified per-line allowlist
            out.append(Finding(
                checker="repolint", rule="RL000",
                location=f"{module}:{lineno}",
                message=f"suppression of {rule} carries no reason",
                data={"suppressed_rule": rule}))
            continue
        out.append(Finding(checker="repolint", rule=rule,
                           location=f"{module}:{lineno}", message=message,
                           data=data))
    return out


def run_repolint(root: Optional[Path] = None,
                 paths: Optional[Sequence[Path]] = None) -> FindingSet:
    """Lint ``src/repro_torch`` (or an explicit file list, for
    fixtures)."""
    if root is None:
        root = Path(__file__).resolve().parents[2]   # src/
    if paths is None:
        paths = sorted((root / "repro_torch").rglob("*.py"))
    fs = FindingSet()
    for p in paths:
        fs.extend(lint_file(Path(p), Path(root)))
    fs.stats = {"files": len(list(paths))}   # type: ignore[attr-defined]
    return fs


def explain(rule_id: str) -> str:
    r = RULES.get(rule_id)
    if r is None:
        known = ", ".join(sorted(RULES))
        return f"unknown rule {rule_id!r}; known rules: {known}"
    return f"{r.rule_id}: {r.title}\n\n{r.explain}"
