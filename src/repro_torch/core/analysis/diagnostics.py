"""Structured compiler diagnostics (ISSUE 6).

Every analysis pass reports :class:`Diagnostic` records instead of raising:
a stable code (``ZAxxx`` IR, ``ZSxxx`` schedule, ``ZHxxx`` hazards/census),
a severity, a human-readable message, and a source *anchor* naming the
segment / node / phase / block the finding points at.  Callers decide policy
(the ``compile_gnn(verify=True)`` hook raises on error severity; the CLI
pretty-prints and exits by ``--fail-on``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

ERROR = "error"
WARN = "warn"
INFO = "info"

SEVERITIES = (ERROR, WARN, INFO)
_SEV_RANK = {ERROR: 0, WARN: 1, INFO: 2}

#: stable code -> (default severity, one-line meaning).  Codes are append-only:
#: tests and downstream tooling key on them, so never renumber.
CODES: Dict[str, tuple] = {
    # --- IR verifier (ZA0xx) ----------------------------------------------
    "ZA001": (ERROR, "op not in the IR vocabulary"),
    "ZA002": (ERROR, "def-use: input references an undefined node"),
    "ZA003": (ERROR, "cycle in segment dataflow"),
    "ZA004": (ERROR, "element-wise broadcast dim mismatch"),
    "ZA005": (ERROR, "GEMM contraction/output dim mismatch"),
    "ZA006": (ERROR, "send paired with the wrong recv op"),
    "ZA007": (ERROR, "channel crosses segments in the wrong direction"),
    "ZA008": (ERROR, "channel send/recv dim mismatch"),
    "ZA009": (ERROR, "orphaned recv: comm id has no send"),
    "ZA010": (ERROR, "orphaned send: comm id has no recv"),
    "ZA011": (ERROR, "duplicate comm id on multiple sends/recvs"),
    "ZA012": (ERROR, "layer tag not monotone along dataflow"),
    "ZA013": (WARN, "dead node: not reachable from any output"),
    "ZA014": (WARN, "unused channel: recv value has no consumer"),
    "ZA015": (ERROR, "recv node must not have intra-segment inputs"),
    "ZA016": (ERROR, "node arity wrong for its op"),
    # --- ScheduledProgram verifier (ZS1xx) --------------------------------
    "ZS101": (ERROR, "gather channel not owned by exactly one GatherBlock"),
    "ZS102": (ERROR, "covered sets of two gather blocks overlap"),
    "ZS103": (ERROR, "fused_levels inconsistent with phase levels"),
    "ZS104": (ERROR, "pallas_spmm preconditions not met by the IR"),
    "ZS105": (ERROR, "pallas_spmm_weighted preconditions not met by the IR"),
    "ZS106": (ERROR, "pallas_segment_softmax motif not present in the IR"),
    "ZS107": (ERROR, "value read before any phase publishes it"),
    "ZS108": (ERROR, "phase layer tags not monotone across levels"),
    "ZS109": (ERROR, "kernel-covered node still scheduled in a block"),
    "ZS110": (INFO, "missed kernel: gather fell back to the scan path"),
    "ZS111": (ERROR, "accumulator spec inconsistent with its send node"),
    # --- schedule hazards & exchange census (ZH2xx) -----------------------
    "ZH201": (ERROR, "drain-ordering race: read not ordered after producer"),
    "ZH202": (ERROR, "task dependency references an unknown/forward task"),
    "ZH203": (ERROR, "gather barrier does not cover its partition's tiles"),
    "ZH204": (ERROR, "static exchange census disagrees with layer count"),
    "ZH205": (WARN, "exchanged value is not gather-tainted"),
    "ZH206": (INFO, "cross-chip boundary reads covered by the exchange"),
    "ZH207": (ERROR, "restricted exchange misses a cross-shard source read"),
    "ZH208": (ERROR, "recvDst read is not device-local under the shard plan"),
    "ZH209": (ERROR, "exchange send set holds rows the shard does not own"),
    "ZH210": (INFO, "restricted-exchange coverage proven (cut vs all-gather)"),
}


@dataclasses.dataclass
class Diagnostic:
    """One finding of a static analysis pass."""

    code: str
    message: str
    severity: str = ""                 # defaults from the CODES table
    # -- source anchor (all optional; whatever the pass can name) ----------
    segment: Optional[str] = None      # IR segment label, e.g. "IR.e.0"
    node: Optional[int] = None         # IR node id
    phase: Optional[int] = None        # scheduled phase level
    block: Optional[str] = None        # "src" | "edge" | "gather" | "dst" | task label
    #: which pass emitted it ("ir" | "schedule" | "hazard" | "census")
    origin: str = ""

    def __post_init__(self):
        if self.code not in CODES:
            raise ValueError(f"unknown diagnostic code {self.code!r}")
        if not self.severity:
            self.severity = CODES[self.code][0]
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    @property
    def anchor(self) -> str:
        parts = []
        if self.segment is not None:
            parts.append(self.segment)
        if self.node is not None:
            parts.append(f"%{self.node}")
        if self.phase is not None:
            parts.append(f"phase {self.phase}")
        if self.block:
            parts.append(self.block)
        return ":".join(parts) if parts else "<program>"

    def format(self) -> str:
        return f"{self.code} [{self.severity:5s}] {self.anchor}: {self.message}"

    def to_dict(self) -> Dict:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v not in (None, "")}


def errors(diags: Sequence[Diagnostic]) -> List[Diagnostic]:
    return [d for d in diags if d.severity == ERROR]


def worst_severity(diags: Sequence[Diagnostic]) -> Optional[str]:
    return min((d.severity for d in diags), key=_SEV_RANK.get, default=None)


def sort_diags(diags: Sequence[Diagnostic]) -> List[Diagnostic]:
    return sorted(diags, key=lambda d: (_SEV_RANK[d.severity], d.code,
                                        d.node if d.node is not None else -1))


def format_report(diags: Sequence[Diagnostic], title: str = "") -> str:
    lines = []
    if title:
        n_err = len(errors(diags))
        n_warn = sum(1 for d in diags if d.severity == WARN)
        lines.append(f"{title}: {len(diags)} finding(s)"
                     f" ({n_err} error, {n_warn} warn)")
    lines += ["  " + d.format() for d in sort_diags(diags)]
    return "\n".join(lines) if lines else f"{title}: clean"


class VerificationError(ValueError):
    """Raised by ``verify=True`` hooks when error-severity findings exist."""

    def __init__(self, diags: Sequence[Diagnostic], context: str = ""):
        self.diagnostics = list(diags)
        errs = errors(self.diagnostics)
        head = (f"{context}: " if context else "") + \
            f"{len(errs)} error-severity diagnostic(s)"
        super().__init__("\n".join([head] + ["  " + d.format() for d in errs]))


def find_cycle(succs: Dict[int, List[int]]) -> List[int]:
    """One directed cycle in ``succs`` (adjacency: id -> successor ids), or
    ``[]`` if acyclic.  Shared by :meth:`Segment.toposort`'s error message
    and the IR verifier's ZA003 diagnostic so the two never diverge."""
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {nid: WHITE for nid in succs}
    for root in sorted(succs):
        if color[root] != WHITE:
            continue
        stack = [(root, iter(sorted(succs[root])))]
        path = [root]
        color[root] = GRAY
        while stack:
            nid, it = stack[-1]
            advanced = False
            for s in it:
                if s not in color:
                    continue
                if color[s] == GRAY:
                    return path[path.index(s):] + [s]
                if color[s] == WHITE:
                    color[s] = GRAY
                    path.append(s)
                    stack.append((s, iter(sorted(succs[s]))))
                    advanced = True
                    break
            if not advanced:
                color[nid] = BLACK
                path.pop()
                stack.pop()
    return []


def format_cycle(label: str, cycle: Sequence[int]) -> str:
    chain = " -> ".join(f"%{n}" for n in cycle)
    return f"cycle in segment {label}: {chain}"
