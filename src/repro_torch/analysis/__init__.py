"""Static backend auditor of the port: stages every registered backend core
at corpus geometries (``audit_trace``), runs it once on the CPU under the
copy-event recorder, and checks seven things — the byte models against one
staged step and the launches' shared memory against a block (``smem``),
copy-event flow equality against the declared traffic models and the
executors' ChunkStats (``traffic``), one static geometry per envelope
(``retrace``), dtypes, index widths and choosers of the staged launch
(``preflight``), and, for the backends with a copy ring, each ring's op log
against its schedule (``dma``) and every completion order of its copies and
reads (``interleave``), and the hash launches' probe bounds against the
planner's (``while``). ``python -m repro_torch.analysis`` is the command
line."""

from repro_torch.analysis.dma import (
    check_ring_structure, check_while_bounds, simulate_schedule,
)
from repro_torch.analysis.interleave import (
    Counterexample, Op, build_program, check_interleave, explore,
)
from repro_torch.analysis.preflight import LintDiagnostic, check_preflight
from repro_torch.analysis.report import (
    ANALYSES, Violation, audit_all, audit_backend_case, normalize_analyses,
)
from repro_torch.analysis.retrace import check_retrace, diff_summary, trace_text
from repro_torch.analysis.smem import SmemAudit, audit_smem, check_smem
from repro_torch.analysis.traffic import check_traffic, traced_flows

__all__ = [
    "ANALYSES",
    "Counterexample",
    "LintDiagnostic",
    "Op",
    "SmemAudit",
    "Violation",
    "audit_all",
    "audit_backend_case",
    "audit_smem",
    "build_program",
    "check_interleave",
    "check_preflight",
    "check_retrace",
    "check_ring_structure",
    "check_while_bounds",
    "check_smem",
    "check_traffic",
    "diff_summary",
    "explore",
    "normalize_analyses",
    "simulate_schedule",
    "trace_text",
    "traced_flows",
]
