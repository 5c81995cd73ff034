"""The one finding type every analysis half emits (the reference's
``repro/analysis/findings.py``, kept here so the two packages' reports read
alike).

A finding is a violated invariant with enough context to act on: which
named check fired (``check``), where (a closure name for the step audit,
``file:line`` for the lint), and what was measured. ``level`` separates
gating errors from informational records ("check skipped on this route"
must be VISIBLE, never silent: a skipped check that looks like a pass is
the failure mode this subsystem exists to kill). ``allowlisted`` findings
stay in the report but do not gate.
"""
from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass
class Finding:
    check: str              # named rule/checker, e.g. "in-place-cache", "time-read"
    where: str              # closure name or file:line
    detail: str             # what was measured vs what the contract says
    level: str = "error"    # "error" gates; "info" records a skipped check
    allowlisted: bool = False

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Finding":
        return cls(check=str(d.get("check", "?")),
                   where=str(d.get("where", "?")),
                   detail=str(d.get("detail", "")),
                   level=str(d.get("level", "error")),
                   allowlisted=bool(d.get("allowlisted", False)))


def gating(findings: List[Finding]) -> List[Finding]:
    """The findings that should fail a gate: errors not allowlisted."""
    return [f for f in findings if f.level == "error" and not f.allowlisted]


def format_findings(findings: List[Finding]) -> str:
    if not findings:
        return "no findings"
    lines = []
    for f in findings:
        tag = ("allow" if f.allowlisted else f.level)
        lines.append(f"[{tag}] {f.check}: {f.where} — {f.detail}")
    return "\n".join(lines)
