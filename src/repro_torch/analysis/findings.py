"""Shared finding model for the static-analysis subsystem.

Every checker (round auditor, recompile sentinel, kernel lint, repo-rule
AST linter) reports the same ``Finding`` record so one CLI
(``python -m repro_torch.analysis``) and one artifact schema cover all
four. The module is the reference's (``repro.analysis.findings``), so a
findings document reads the same from either package.
Findings carry a machine-readable payload (``data``) next to the human
message: the CI job uploads the JSON, humans read the formatted table.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

ERROR = "error"      # gates CI: the invariant is violated
WARN = "warning"     # reported, never gates


@dataclass(frozen=True)
class Finding:
    checker: str                 # "rounds" | "recompile" | "kernel" | "repolint"
    rule: str                    # stable rule id, e.g. "JX001", "RL003"
    message: str                 # one-line human statement of the violation
    severity: str = ERROR
    location: str = ""           # "path:line" for AST rules, symbolic otherwise
    data: Dict = field(default_factory=dict)   # machine-readable payload

    def format(self) -> str:
        loc = f" [{self.location}]" if self.location else ""
        return f"{self.severity.upper():7s} {self.rule} ({self.checker}){loc}: " \
               f"{self.message}"

    def to_dict(self) -> Dict:
        return {"checker": self.checker, "rule": self.rule,
                "severity": self.severity, "location": self.location,
                "message": self.message, "data": self.data}


class FindingSet:
    """Ordered collection of findings with JSON/pretty output."""

    def __init__(self, findings: Optional[List[Finding]] = None):
        self.findings: List[Finding] = list(findings or [])

    def add(self, finding: Finding):
        self.findings.append(finding)

    def extend(self, other):
        self.findings.extend(
            other.findings if isinstance(other, FindingSet) else other)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == ERROR]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == WARN]

    def __len__(self) -> int:
        return len(self.findings)

    def __iter__(self):
        return iter(self.findings)

    def by_rule(self, rule: str) -> List[Finding]:
        return [f for f in self.findings if f.rule == rule]

    def format(self) -> str:
        if not self.findings:
            return "no findings"
        return "\n".join(f.format() for f in self.findings)

    def to_json(self, extra: Optional[Dict] = None) -> str:
        doc = {"findings": [f.to_dict() for f in self.findings],
               "num_errors": len(self.errors),
               "num_warnings": len(self.warnings)}
        if extra:
            doc.update(extra)
        return json.dumps(doc, indent=2, default=str)

    def write_json(self, path: str, extra: Optional[Dict] = None):
        with open(path, "w") as f:
            f.write(self.to_json(extra))
