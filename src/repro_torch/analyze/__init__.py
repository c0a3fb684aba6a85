"""Correctness analysis for the replicated simulator (the port of
``repro.analyze``).

  schedule   static ISP/MUST-style match verification of per-rank op
             schedules (declared, or traced from live apps): unmatched
             sends/recvs, wait-for deadlock cycles, collective
             mismatches, reserved-tag abuse, wildcard match ambiguity
  divergence runtime cmp-vs-rep payload CRC comparison per send-ID —
             the first-divergence SDC tripwire
             (``SimRuntime(detect_divergence=True)``)
  tags       the reserved message-tag registry

The lint pass and the CLI wait for the next slice (ROADMAP.md, Queue 1
item 9b).
"""
from repro_torch.analyze.divergence import (DivergenceDetector,
                                            DivergenceRecord,
                                            ReplicaDivergence, payload_crc)
from repro_torch.analyze.findings import (ERROR, WARNING, Finding, errors,
                                          format_report, warnings)
from repro_torch.analyze.schedule import (Schedule, trace_app, verify_app,
                                          verify_schedule)
from repro_torch.analyze.tags import (RESERVED_BANDS, band_owner,
                                      reserved_tags)

__all__ = [
    "ERROR", "WARNING", "Finding", "errors", "warnings", "format_report",
    "Schedule", "trace_app", "verify_app", "verify_schedule",
    "RESERVED_BANDS", "band_owner", "reserved_tags",
    "DivergenceDetector", "DivergenceRecord", "ReplicaDivergence",
    "payload_crc",
]
