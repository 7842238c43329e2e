"""Static analysis for the port's speculative-decoding engine (the port of
``repro.analysis``).

Four checkers, one finding model, one CLI (``python -m
repro_torch.analysis``):

  - ``round_audit``  — run the round variants on fake CUDA tensors: no
    host re-entry, stable state (shape, dtype, device), caches updated in
    place, cross-variant dtype coherence; on the card, a round under the
    sync debug mode.
  - ``recompile``    — a warm engine builds, loads and allocates nothing
    over further decode rounds, and makes one fetch a round.
  - ``kernel_lint``  — every CUDA kernel instance against Hopper's
    registers and shared memory (on the card), and the wrappers' launch
    plans, buffer dtypes and row alignment across swept shapes.
  - ``repolint``     — repo-specific AST rules (host conversions in round
    modules, unbudgeted host syncs, mutable module state, non-frozen
    configs).

Everything but the card-only parts runs on the CPU: the round audit never
touches data, and the sentinel runs the tiny pair's engine.
"""
from . import kernel_lint, recompile, repolint, round_audit
from .findings import ERROR, WARN, Finding, FindingSet
from .kernel_lint import (InstanceRecord, KernelCase, build_kernel_cases,
                          capture_kernel_calls,
                          lint_instance, lint_plan, ptxas_report,
                          run_kernel_lint)
from .recompile import (KernelBuildWatcher, audit_round_transfers,
                        count_fetches, run_recompile_sentinel, run_sentinel)
from .repolint import lint_file, run_repolint
from .round_audit import (AuditSubject, build_audit_subjects,
                          run_live_round, run_round_audit)

RULES = {**repolint.RULES, **round_audit.RULES, **recompile.RULES,
         **kernel_lint.RULES}


def explain(rule_id: str) -> str:
    """The rationale of one rule id, of any checker."""
    r = RULES.get(rule_id)
    if r is None:
        known = ", ".join(sorted(RULES))
        return f"unknown rule {rule_id!r}; known rules: {known}"
    return f"{r.rule_id}: {r.title}\n\n{r.explain}"

__all__ = [
    "ERROR", "WARN", "Finding", "FindingSet",
    "AuditSubject", "build_audit_subjects", "run_round_audit",
    "run_live_round",
    "InstanceRecord", "KernelCase", "build_kernel_cases",
    "capture_kernel_calls", "lint_instance", "lint_plan", "ptxas_report",
    "run_kernel_lint",
    "KernelBuildWatcher", "audit_round_transfers", "count_fetches",
    "run_recompile_sentinel", "run_sentinel",
    "RULES", "explain", "lint_file", "run_repolint",
]
