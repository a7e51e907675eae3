"""Audit orchestration: every registered backend x algorithm x geometry.

One :func:`audit_all` call drives the static auditor. Per (backend,
algorithm, corpus case) the spec's ``audit_trace`` stages the instance at its
envelope; its core runs once on the CPU under the copy-event recorder
(:func:`~repro_torch.analysis.traffic.traced_flows`), and the selected
analyses read it:

* ``smem`` — the byte model dominates one staged step, and every launch's
  shared-memory request fits a block (on the card, with the static bytes of
  the build log) (:mod:`repro_torch.analysis.smem`);
* ``traffic`` — the recorded copy events equal the spec's ``traffic_model``
  event for event and tie to the executors' ``ChunkStats``
  (:mod:`repro_torch.analysis.traffic`);
* ``retrace`` — the case and its structural-subset twin, staged at the
  shared (union) envelope, give one static geometry and one compile
  (:mod:`repro_torch.analysis.retrace`);
* ``preflight`` — dtypes, index-table widths and shared memory of the
  staged launch, and the choosers' paths (:mod:`repro_torch.analysis.preflight`);
* ``dma`` — the backends with a copy ring (``sparse``, ``hash``) run the
  case with every operand in slow memory, and each ring's recorded op log
  must be the schedule's program, op for op, with the schedule's host
  replay clean (:mod:`repro_torch.analysis.dma`);
* ``while`` — the hash backend's probe loops carry the planner's bound:
  the table size each of its launches is given (the staged core's, the
  ring's, the in-place call's one a strip and a batched in-place call's)
  bounds the probe at ``probe_step_bound`` of the envelope's
  ``hash_table_slots`` (:func:`~repro_torch.analysis.dma.check_while_bounds`);
* ``interleave`` — every completion order of each such ring's copies and
  reads is hazard-free (:mod:`repro_torch.analysis.interleave`).

When ``dma`` or ``interleave`` is selected the schedule's host replay also
runs once over the JAX package's sweep of stream lengths. The rings inside
the CUDA kernels (their N-stage ``cp.async`` pipelines) have no slot model
yet.

The output is a JSON-able report dict; ``python -m repro_torch.analysis``
is the command line.
"""

from __future__ import annotations

import dataclasses

from repro_torch.analysis import corpus
from repro_torch.analysis.dma import (
    check_ring_structure, check_while_bounds, simulate_schedule,
)
from repro_torch.analysis.interleave import check_interleave
from repro_torch.analysis.preflight import check_preflight
from repro_torch.analysis.retrace import check_retrace
from repro_torch.analysis.smem import audit_smem, check_smem, launch_requests
from repro_torch.analysis.traffic import check_traffic, traced_flows
from repro_torch.core import backend_registry

# every per-case analysis audit_backend_case can run, in run order
ANALYSES = ("smem", "traffic", "retrace", "preflight", "dma", "while", "interleave")
# stream lengths the schedule's host replay sweeps (the JAX package's)
SCHEDULE_SWEEP = tuple(range(1, 13))


@dataclasses.dataclass(frozen=True)
class Violation:
    """One auditor finding, locatable to (analysis, backend, algorithm,
    case)."""

    analysis: str      # one of ANALYSES
    backend: str
    algorithm: str
    case: str
    message: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _case_envelope(spec, A, B, plan):
    from repro_torch.core.chunking import instance_envelope

    block = spec.block_size if spec.needs_block_caps else None
    return instance_envelope(A, B, plan, block_size=block)


def normalize_analyses(analyses) -> tuple:
    """Validate/default an analysis subset (``None`` = all)."""
    if analyses is None:
        return ANALYSES
    selected = tuple(analyses)
    unknown = [a for a in selected if a not in ANALYSES]
    if unknown:
        raise ValueError(f"unknown analyses {unknown}; available: {list(ANALYSES)}")
    return selected


def normalize_cases(cases) -> list:
    """``None`` or "all" = the whole corpus, "fast" = ``FAST_CASES``, else
    the named cases."""
    if cases is None or cases == "all":
        return list(corpus.CASES)
    if cases == "fast":
        return list(corpus.FAST_CASES)
    names = [cases] if isinstance(cases, str) else list(cases)
    unknown = [c for c in names if c not in corpus.CASES]
    if unknown:
        raise ValueError(f"unknown cases {unknown}; available: {list(corpus.CASES)}")
    return names


def _ring_records(spec, A, B, plan):
    """The rings of one all-slow call of ``spec`` on the case, on the
    operands' device (pinned host memory on the card, host memory on the
    CPU); None for a backend without a ring."""
    if not spec.supports_placement:
        return None
    from repro_torch.core.chunking import chunked_spgemm
    from repro_torch.core.copy_ring import RingLog
    from repro_torch.core.placement import ALL_SLOW, place

    device = A.device
    if device.type == "cuda":
        A, B = place((A, B), "slow")
    with RingLog() as log:
        chunked_spgemm(A, B, plan, backend=spec.name, placement=ALL_SLOW, device=device)
    return log.rings


def _expected_while_bound(spec, env) -> int | None:
    """The hash backend's probe loops must be bounded by the planner-derived
    table of the audited envelope (the row width its staging takes); other
    backends carry no expectation."""
    if spec.name != "hash":
        return None
    from repro_torch.core.planner import hash_table_slots
    from repro_torch.kernels.hash_accum_spgemm import probe_step_bound

    row_cap = env.c_max_row_nnz if env.c_nnz_cap else env.b_shape[1]
    return probe_step_bound(hash_table_slots(row_cap))


def _hash_tables(spec, target, A, B, plan) -> list:
    """The table sizes of every hash launch of the case: the staged core,
    then an all-slow call through the ring, the same read in place and a
    width-2 batch read in place, on the operands' device (pinned host
    memory for the slow operands on the card)."""
    from repro_torch.core.chunk_stream import chunked_spgemm_batched
    from repro_torch.core.chunking import chunked_spgemm
    from repro_torch.core.placement import ALL_SLOW, place
    from repro_torch.kernels.hash_accum_spgemm import TableLog

    device = A.device
    slow = place((A, B), "slow") if device.type == "cuda" else (A, B)
    with TableLog() as log:
        target.fn(*target.args)
        for slow_reads in ("ring", "in_place"):
            chunked_spgemm(*slow, plan, backend=spec.name, placement=ALL_SLOW, device=device,
                           slow_reads=slow_reads)
        chunked_spgemm_batched([slow[0]] * 2, [slow[1]] * 2, plan, backend=spec.name,
                               placement=ALL_SLOW, device=device, slow_reads="in_place")
    return log.tables


def audit_backend_case(spec, algorithm: str, case_name: str, A, B,
                       retrace: bool = True, analyses=None, build_log=None):
    """All selected analyses for one (backend, algorithm, instance).
    Returns ``(record, violations)``: a JSON-able measurement record and the
    list of :class:`Violation`. ``retrace=False`` is shorthand for dropping
    ``"retrace"`` from the selection; ``build_log`` is the kernels' build
    log (``kernels._build.BUILD_LOG``) where the card built them."""
    analyses = normalize_analyses(analyses)
    plan = corpus.make_plan(algorithm, A, B)
    env = _case_envelope(spec, A, B, plan)
    target = spec.audit_trace(A, B, plan, env.c_pad, env)
    violations = []

    def flag(analysis, messages):
        violations.extend(Violation(analysis, spec.name, algorithm, case_name, m)
                          for m in messages)

    record = {"backend": spec.name, "algorithm": algorithm, "case": case_name,
              "analyses": list(analyses)}
    launches = (traced_flows(target)
                if {"smem", "traffic", "preflight"} & set(analyses) else [])
    requests = launch_requests(target, launches, build_log)

    if "smem" in analyses:
        model = spec.byte_model(plan, env) if spec.byte_model is not None else None
        audit = audit_smem(target, launches, model, build_log)
        flag("smem", check_smem(audit))
        record["smem"] = dataclasses.asdict(audit)
        record["dominated"] = audit.dominated
        record["n_launches"] = audit.n_launches

    if "traffic" in analyses:
        if spec.supports_traffic:
            expected = spec.traffic_model(A, B, plan, env.c_pad, env, target.meta)
            tv, tinfo = check_traffic(launches, expected)
            flag("traffic", tv)
            record["traffic"] = tinfo
        else:
            record["traffic"] = {
                "checked": False,
                "reason": "no traffic_model registered (the scan backend launches no "
                          "kernel: its stats are a replay oracle by design)"}

    if "preflight" in analyses:
        pv, pinfo = check_preflight(spec.name, target, requests)
        flag("preflight", pv)
        record["preflight"] = pinfo

    if {"dma", "interleave"} & set(analyses):
        rings = _ring_records(spec, A, B, plan)
        for analysis in ("dma", "interleave"):
            if analysis not in analyses:
                continue
            if rings is None:
                record[analysis] = {
                    "checked": False,
                    "reason": "no copy ring: the backend raises on an operand in "
                              "slow memory"}
                continue
            infos = []
            for ring in rings:
                if analysis == "dma":
                    flag("dma", check_ring_structure(ring.ops, ring.total, ring.n_fields)
                         + simulate_schedule(ring.total))
                    info = {"ops": len(ring.ops)}
                else:
                    iv, info = check_interleave(ring.total, ring.n_fields)
                    flag("interleave", iv)
                infos.append({"operand": ring.operand, "role": ring.role,
                              "total": ring.total, **info})
            record[analysis] = {"checked": True, "rings": infos}

    if "while" in analyses:
        expected = _expected_while_bound(spec, env)
        if expected is None:
            record["while"] = {"checked": False,
                               "reason": "no probe loop: only the hash kernel probes"}
        else:
            tables = _hash_tables(spec, target, A, B, plan)
            flag("while", check_while_bounds(tables, expected_bound=expected))
            record["while"] = {"checked": True, "expected_bound": expected,
                               "launches": len(tables)}

    if retrace and "retrace" in analyses:
        A2, B2 = corpus.retrace_pair(A, B)
        plan2 = corpus.make_plan(algorithm, A2, B2)
        env_shared = env.union(_case_envelope(spec, A2, B2, plan2))
        t1 = spec.audit_trace(A, B, plan, env_shared.c_pad, env_shared)
        t2 = spec.audit_trace(A2, B2, plan, env_shared.c_pad, env_shared)
        flag("retrace", check_retrace(t1, t2))

    record["n_violations"] = len(violations)
    return record, violations


def audit_all(backends=None, algorithms=None, cases=None, retrace: bool = True,
              analyses=None, device: str = "cuda") -> dict:
    """Run the static audit on ``device`` (the corpus is built there; on
    ``cuda`` the kernels are built first and ``smem`` reads their build
    log). ``cases`` is "fast", "all"/None or a list of corpus cases.
    Returns a JSON-able report with ``records`` (per backend x algorithm x
    case), ``violations``, ``skipped`` (non-auditable backends), and
    ``ok``."""
    from repro_torch.kernels import _build

    backend_registry.ensure_registered()
    names = list(backends) if backends else list(backend_registry.all_backends())
    algorithms = list(algorithms) if algorithms else list(backend_registry.ALGORITHMS)
    case_names = normalize_cases(cases)
    analyses = normalize_analyses(analyses)
    build_log = _build.build() if str(device).startswith("cuda") else {}

    violations, records, skipped = [], [], []
    if {"dma", "interleave"} & set(analyses):
        for total in SCHEDULE_SWEEP:
            violations.extend(Violation("schedule", "*", "*", f"total={total}", m)
                              for m in simulate_schedule(total))
    for name in names:
        spec = backend_registry.get(name)
        if not spec.supports_audit:
            skipped.append({"backend": name,
                            "reason": "no audit_trace (the host-loop oracle has no core)"})
            continue
        for case_name in case_names:
            A, B = corpus.build_case(case_name, device=device)
            for algorithm in algorithms:
                record, v = audit_backend_case(spec, algorithm, case_name, A, B,
                                               retrace=retrace, analyses=analyses,
                                               build_log=build_log)
                records.append(record)
                violations.extend(v)

    return {
        "device": str(device),
        "backends": names,
        "algorithms": algorithms,
        "cases": case_names,
        "analyses": list(analyses),
        "records": records,
        "skipped": skipped,
        "violations": [v.to_dict() for v in violations],
        "ok": not violations,
    }
