"""Correctness analysis for the replicated simulator (the port of
``repro.analyze``).

  schedule   static ISP/MUST-style match verification of per-rank op
             schedules (declared, or traced from live apps): unmatched
             sends/recvs, wait-for deadlock cycles, collective
             mismatches, reserved-tag abuse, wildcard match ambiguity
  divergence runtime cmp-vs-rep payload CRC comparison per send-ID —
             the first-divergence SDC tripwire
             (``SimRuntime(detect_divergence=True)``)
  lint       AST rules over src/repro_torch enforcing the determinism/FT
             invariants replication rests on (wall clock, unseeded RNG,
             set iteration order, unpriced transports, tag bands), with
             ``# repro: allow[rule]`` suppression
  tags       the reserved message-tag registry

CLI: ``python -m repro_torch.analyze [lint|schedule|divergence|all]``
(``--device``: where the apps run, default the card); exit status 1 on
any error finding.
"""
from repro_torch.analyze.divergence import (DivergenceDetector,
                                            DivergenceRecord,
                                            ReplicaDivergence, payload_crc)
from repro_torch.analyze.findings import (ERROR, WARNING, Finding, errors,
                                          format_report, warnings)
from repro_torch.analyze.lint import (RULES, lint_paths, lint_source,
                                      parse_allows)
from repro_torch.analyze.schedule import (Schedule, trace_app, verify_app,
                                          verify_schedule)
from repro_torch.analyze.tags import (RESERVED_BANDS, RESERVED_MAX,
                                      RESERVED_MIN, band_owner,
                                      reserved_tags)

__all__ = [
    "ERROR", "WARNING", "Finding", "errors", "warnings", "format_report",
    "RULES", "lint_paths", "lint_source", "parse_allows",
    "Schedule", "trace_app", "verify_app", "verify_schedule",
    "RESERVED_BANDS", "RESERVED_MIN", "RESERVED_MAX", "band_owner",
    "reserved_tags",
    "DivergenceDetector", "DivergenceRecord", "ReplicaDivergence",
    "payload_crc",
]
