"""Static verification over compiler artifacts (port of
``repro.core.analysis``, single-device part).

* :func:`verify_ir` — dataflow/dim/vocabulary/channel checks on an
  :class:`~repro_torch.core.ir.IRProgram` (codes ``ZA0xx``);
* :func:`verify_schedule` — lowering legality on a
  :class:`~repro_torch.core.schedule.ScheduledProgram`, including
  independent re-derivation of every kernel tag's preconditions and the
  published-before-read contract (codes ``ZS1xx``).

``compile_gnn`` runs both by default (``verify=True``).  The task-graph
hazard and exchange-census passes belong to the sharded runner and are not
part of this package yet.
"""
from __future__ import annotations

from .diagnostics import (CODES, ERROR, INFO, SEVERITIES, WARN, Diagnostic,
                          VerificationError, errors, find_cycle, format_cycle,
                          format_report, sort_diags, worst_severity)
from .ir_verifier import verify_ir
from .schedule_verifier import explain_scan_fallback, verify_schedule

__all__ = [
    "CODES", "ERROR", "WARN", "INFO", "SEVERITIES", "Diagnostic",
    "VerificationError",
    "errors", "find_cycle", "format_cycle", "format_report", "sort_diags",
    "worst_severity", "verify_ir", "verify_schedule", "explain_scan_fallback",
]
