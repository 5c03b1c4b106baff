"""Static analysis & verification over compiler artifacts (ISSUE 6).

Three passes, each pure (no execution, no JAX tracing):

* :func:`verify_ir` — dataflow/dim/vocabulary/channel checks on an
  :class:`~repro.core.ir.IRProgram` (codes ``ZA0xx``);
* :func:`verify_schedule` — lowering legality on a
  :class:`~repro.core.schedule.ScheduledProgram`, including independent
  re-derivation of every Pallas kernel's preconditions and the
  published-before-read contract (codes ``ZS1xx``);
* :func:`analyze_task_graph` / :func:`verify_exchange` — drain-ordering
  race detection over the stream-task DAG and the static collective
  census for sharded execution (codes ``ZH2xx``).

:func:`analyze` dispatches on the artifact type; ``compile_gnn`` calls the
first pass by default (``verify=True``).
"""
from __future__ import annotations

from typing import List, Sequence, Union

from .diagnostics import (CODES, ERROR, INFO, SEVERITIES, WARN, Diagnostic,
                          VerificationError, errors, find_cycle, format_cycle,
                          format_report, sort_diags, worst_severity)
from .hazards import (ExchangeCensus, analyze_task_graph, exchange_census,
                      verify_exchange)
from .ir_verifier import verify_ir
from .schedule_verifier import explain_scan_fallback, verify_schedule

__all__ = [
    "CODES", "ERROR", "WARN", "INFO", "SEVERITIES", "Diagnostic",
    "VerificationError",
    "errors", "find_cycle", "format_cycle", "format_report", "sort_diags",
    "worst_severity", "verify_ir", "verify_schedule", "explain_scan_fallback",
    "analyze_task_graph", "exchange_census", "verify_exchange",
    "ExchangeCensus", "analyze",
]


def analyze(obj, **kw) -> List[Diagnostic]:
    """Run every analysis pass that applies to ``obj``.

    ``obj`` may be an :class:`~repro.core.ir.IRProgram`, a
    :class:`~repro.core.schedule.ScheduledProgram`, a
    :class:`~repro.core.compiler.CompiledGNN`, or a stream-task list from
    :func:`~repro.core.streams.build_task_graph` (keyword arguments
    ``sde=``, ``tiles=``, ``inter_layer=``, ``parts=`` are forwarded there).
    """
    from .. import compiler as C
    from .. import ir as IR
    from .. import schedule as S

    if isinstance(obj, IR.IRProgram):
        return verify_ir(obj)
    if isinstance(obj, S.ScheduledProgram):
        return (verify_ir(obj.prog) + verify_schedule(obj)
                + verify_exchange(obj))
    if isinstance(obj, C.CompiledGNN):
        diags = verify_ir(obj.ir)
        for dispatch in (True, False):
            sp = obj.schedule(kernel_dispatch=dispatch)
            diags += verify_schedule(sp)
            if dispatch:            # census is dispatch-invariant
                diags += verify_exchange(sp)
        return diags
    if isinstance(obj, (list, tuple)) and (not obj or hasattr(obj[0], "tid")):
        return analyze_task_graph(obj, **kw)
    raise TypeError(f"analyze() cannot handle {type(obj).__name__}")
