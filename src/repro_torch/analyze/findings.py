"""Structured findings shared by every analysis pass (a copy of
``repro/analyze/findings.py``).

A ``Finding`` is one located defect: where (``path:line``), which rule
fired (``rule``), what is wrong (``message``), and how to fix it
(``hint``).  Schedule findings locate into the schedule instead of a
source file (``path`` carries the schedule label + rank, ``line`` the op
index); lint findings locate into source.  ``severity`` separates hard
protocol errors from determinism warnings the caller may tolerate.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List

ERROR = "error"
WARNING = "warning"


@dataclass(frozen=True)
class Finding:
    rule: str                    # rule id, e.g. "wallclock", "deadlock"
    path: str                    # source file, or "<label> rank r"
    line: int                    # 1-based source line; op index for schedules
    message: str
    hint: str = ""
    severity: str = ERROR

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        out = f"{loc}: [{self.rule}] {self.message}"
        if self.hint:
            out += f"  (fix: {self.hint})"
        return out


def errors(findings: Iterable[Finding]) -> List[Finding]:
    return [f for f in findings if f.severity == ERROR]


def warnings(findings: Iterable[Finding]) -> List[Finding]:
    return [f for f in findings if f.severity == WARNING]


def format_report(findings: Iterable[Finding]) -> str:
    """One finding per line, errors first, stable order within severity."""
    fs = sorted(findings, key=lambda f: (f.severity != ERROR, f.path,
                                         f.line, f.rule))
    return "\n".join(f.format() for f in fs)
