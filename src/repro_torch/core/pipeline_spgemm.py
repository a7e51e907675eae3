"""Fused two-hop sparse pipelines: the Galerkin triple product ``R x (A x P)``.

The multigrid setup phase (paper §4.1.1) is a product of products: a first
SpGEMM whose output is immediately consumed by a second. This module is the
two-hop planner+executor:

* the **composed symbolic phase** (``repro_torch.core.symbolic.
  pipeline_output_caps``) pre-sizes both hops in one pass — hop 1's exact
  output structure is hop 2's streamed-operand input, so one
  :class:`PipelineEnvelope` (a hop-1 + hop-2 envelope pair) covers the whole
  triple product;
* the **planner** (``repro_torch.core.planner.plan_pipeline``) budgets fast
  memory for the *resident intermediate*: T's CSR triple stays staged
  between the hops when both hops' peaks fit with it, and spills to slow
  memory otherwise;
* the **executor** (:func:`pipeline_spgemm`) runs both hops through any
  registered backend (or ``auto``), with the pre-sized caps, so neither hop
  re-expands the symbolic structure. It runs on the card by default and
  takes A, P and R where they lie (a :class:`PipelinePlacement`): a slow
  operand, in pinned host memory, streams through its hop's copy ring
  (``repro_torch.core.copy_ring``), or with ``slow_reads="in_place"`` is
  read where it lies by its hop's streaming kernel, and C goes to R's
  space. On the spill path T is slow (pinned host memory on the card, a
  host copy on the CPU) and stays there: hop 2 streams it as its B operand
  through the ring, under every registered backend, or reads it in place;
* the composed byte model (:func:`pipeline_fast_model`) counts the resident
  intermediate exactly once (:func:`check_pipeline_model`);
* the static-audit hooks (:func:`pipeline_audit_traces`,
  :func:`audit_pipeline`) stage both hops' cores as the executor would and
  hold the per-hop and composed byte models to the staged steps, with the
  port's auditor (``repro_torch.analysis``) in place of the reference's
  jaxpr tracing.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import backend_registry
from repro_torch.core.chunking import (
    SLOW_READS, ChunkStats, in_place_refusal, instance_envelope, whole_fast,
)
from repro_torch.core.placement import (
    ALL_FAST, PipelinePlacement, resolve_pipeline_placement,
)
from repro_torch.core.planner import (
    BackendFastModel, PipelinePlan, plan_pipeline, select_accumulator_backend,
)
from repro_torch.core.symbolic import PipelineCaps, pipeline_output_caps
from repro_torch.sparse.csr import CSR, GeometryEnvelope, csr_pin


@dataclasses.dataclass(frozen=True)
class PipelineEnvelope:
    """Both hops' padded geometries, pre-sized together by the composed
    symbolic phase (``hop2.b_max_row_nnz`` is the densest row of ``T``)."""

    hop1: GeometryEnvelope   # T = A x P
    hop2: GeometryEnvelope   # C = R x T


def pipeline_envelope(A: CSR, P: CSR, R: CSR, plan: PipelinePlan,
                      caps: PipelineCaps, block_size: int | None = None) -> PipelineEnvelope:
    """Both hop envelopes from one composed symbolic pass; hop 2's is built
    against the intermediate's exact *pattern*, before hop 1 runs.
    ``block_size`` folds the block caps in (``instance_envelope``), as a
    block backend's staging needs."""
    return PipelineEnvelope(
        hop1=instance_envelope(A, P, plan.plan1, caps=caps.hop1, block_size=block_size),
        hop2=instance_envelope(R, caps.t_pattern, plan.plan2, caps=caps.hop2,
                               block_size=block_size),
    )


@dataclasses.dataclass
class PipelineStats:
    """Observed staging traffic of one pipeline run. ``spill_bytes`` is the
    *extra* slow-memory round trip of the intermediate when the plan spilled
    it (one write-out after hop 1 plus one read per hop-2 streamed pass) —
    zero on the resident path."""

    plan: PipelinePlan
    hop1: ChunkStats
    hop2: ChunkStats
    spilled: bool
    spill_bytes: float

    @property
    def copy_bytes(self) -> float:
        return self.hop1.copy_bytes + self.hop2.copy_bytes + self.spill_bytes


def _run_hop(X: CSR, Y: CSR, plan, caps, backend: str, placement, device,
             slow_reads: str = "ring"):
    """One hop through a registered backend (or ``auto``, resolved on the
    hop's envelope) at pre-sized caps, on ``device``. A whole_fast hop's
    output carries the exact densest-row bound (the reference's carries
    ``c_pad``), which hop 2 reads as its streamed ``b_max_row_nnz``.
    Operands that ``placement`` puts in slow memory cross whole in a
    whole_fast hop and through the backend's copy ring (``run_placed``) in
    a chunked one, where a slow output goes to slow memory; with
    ``slow_reads="in_place"`` the backend's kernel reads them where they lie
    (``run_in_place``) and writes a slow output there, and a whole_fast hop
    or a backend without such a kernel raises."""
    in_place = slow_reads == "in_place"
    if plan.algorithm == "whole_fast":
        if in_place:
            raise in_place_refusal("a whole_fast hop copies its operands whole")
        return whole_fast(X, Y, caps.c_pad, placement, device, caps.c_max_row_nnz)
    resolved = backend
    if backend == "auto":
        resolved = select_accumulator_backend(plan, instance_envelope(X, Y, plan, caps=caps))
    spec = backend_registry.get(resolved)
    if in_place and not spec.supports_in_place:
        what = (f"backend 'auto' resolves to {resolved!r}, which has" if backend == "auto"
                else f"backend {backend!r} has")
        raise in_place_refusal(f"{what} no such kernel")
    fn = spec.executors.get(plan.algorithm)
    if fn is None:
        raise ValueError(f"unknown algorithm {plan.algorithm!r}")
    if placement != ALL_FAST:
        run = spec.run_in_place if in_place else spec.run_placed
        return run(X, Y, plan, caps.c_pad, caps, placement, device)
    kwargs = {"caps": caps} if spec.needs_output_caps else {}
    return fn(X, Y, plan, caps.c_pad, **kwargs)


def _spill_to_slow(T: CSR) -> CSR:
    """The intermediate written to slow memory, where it stays: pinned host
    memory on the card, a host copy on the CPU."""
    if T.device.type != "cuda":
        return CSR(T.indptr.clone(), T.indices.clone(), T.data.clone(),
                   T.shape, T.max_row_nnz)
    return csr_pin(T)


def pipeline_spgemm(A: CSR, P: CSR, R: CSR, plan: PipelinePlan | None = None,
                    *, system=None, fast_limit_bytes: float | None = None,
                    backend: str = "sparse", caps: PipelineCaps | None = None,
                    placement: PipelinePlacement | None = None, device=None,
                    slow_reads: str = "ring"):
    """Execute ``C = R x (A x P)`` as a fused two-hop pipeline.

    Returns ``(C, PipelineStats)``. ``plan`` defaults to
    ``planner.plan_pipeline(A, P, R, system, fast_limit_bytes)`` (``system``
    is then required); ``caps`` defaults to the composed symbolic phase at
    the plan's partitions. ``backend`` names any registered backend, or
    ``auto`` (each hop's accumulator resolved on its own envelope); both
    hops run through it.

    ``placement`` (a :class:`repro_torch.core.placement.PipelinePlacement`)
    and ``device`` say where A, P, R and C live and where the call runs
    (``placement.resolve_pipeline_placement``): ``device=None`` is the
    card, where a pinned operand is slow, one on the card fast, C takes R's
    space, and a pageable host operand raises; ``device="cpu"`` runs the
    plain versions with the spaces given (all fast by default). The
    intermediate T is fast on the resident path and slow (pinned on the
    card) on the spill path. Hop 1 runs ``A x P`` under (A, P, T) and hop 2
    ``R x T`` under (R, T, C): a hop with a slow operand streams it through
    its backend's copy ring, and a slow output goes to slow memory. With A
    and P fast, hop 1 writes T on the run device and a spilled T is copied
    to slow memory after it (the all-fast pipeline's path). The stats
    carry each hop's events; ``spill_bytes`` counts T's extra round trip.

    ``slow_reads="in_place"`` (``chunked_spgemm``'s) reads a hop's slow
    operands where they lie instead of through the ring: the hop's
    streaming kernel (``run_in_place``) launches once a strip, a spilled T
    is written in place into pinned memory by hop 1 and read there by hop
    2. A backend without an in-place kernel, ``auto`` resolving to one on a
    hop, and a whole_fast hop raise. The stats stay the plan's modelled
    events.
    """
    if slow_reads not in SLOW_READS:
        raise ValueError(f"slow_reads must be one of {SLOW_READS}, not {slow_reads!r}")
    if slow_reads == "in_place" and backend != "auto" and not backend_registry.get(
            backend).supports_in_place:
        raise in_place_refusal(f"backend {backend!r} has no such kernel")
    where, run = resolve_pipeline_placement({"A": A, "P": P, "R": R}, placement, device)
    if plan is None:
        if system is None:
            raise ValueError(
                "pipeline_spgemm needs either a PipelinePlan or a "
                "MemorySystem to plan against")
        plan = plan_pipeline(A, P, R, system, fast_limit_bytes=fast_limit_bytes)
    if caps is None:
        caps = pipeline_output_caps(A, P, R, plan.plan1.p_ac, plan.plan2.p_ac)
    spilled = not plan.t_resident
    t_space = "slow" if spilled else "fast"
    if where.hop1("fast") == ALL_FAST:
        T, stats1 = _run_hop(A, P, plan.plan1, caps.hop1, backend, ALL_FAST, run, slow_reads)
        if spilled:
            T = _spill_to_slow(T)
    else:
        T, stats1 = _run_hop(A, P, plan.plan1, caps.hop1, backend, where.hop1(t_space), run,
                             slow_reads)
    spill_bytes = 0.0
    if spilled:
        t_reads = plan.plan2.n_ac if plan.plan2.algorithm == "chunk1" else 1
        spill_bytes = float(T.nbytes()) * (1 + t_reads)
    C, stats2 = _run_hop(R, T, plan.plan2, caps.hop2, backend, where.hop2(t_space), run,
                         slow_reads)
    return C, PipelineStats(plan=plan, hop1=stats1, hop2=stats2,
                            spilled=spilled, spill_bytes=spill_bytes)


@dataclasses.dataclass(frozen=True)
class PipelineFastModel:
    """Composed peak-resident claim of one pipeline under one backend: each
    hop's registered byte model, plus the resident intermediate counted
    **exactly once** on top of whichever hop peaks."""

    backend: str
    hop1: BackendFastModel
    hop2: BackendFastModel
    t_bytes: float           # staged footprint of the resident intermediate
    t_resident: bool
    fast_bytes_needed: float  # max(hop peaks) + (t_bytes if resident)


def pipeline_fast_model(plan: PipelinePlan, penv: PipelineEnvelope,
                        backend: str) -> PipelineFastModel:
    """Compose the backend's per-hop byte models into the pipeline claim."""
    spec = backend_registry.get(backend)
    if spec.byte_model is None:
        raise ValueError(f"backend {backend!r} registers no byte model")
    m1 = spec.byte_model(plan.plan1, penv.hop1)
    m2 = spec.byte_model(plan.plan2, penv.hop2)
    extra = plan.t_bytes if plan.t_resident else 0.0
    return PipelineFastModel(
        backend=spec.name, hop1=m1, hop2=m2, t_bytes=plan.t_bytes,
        t_resident=plan.t_resident,
        fast_bytes_needed=max(m1.fast_bytes_needed, m2.fast_bytes_needed)
        + extra,
    )


def check_pipeline_model(model: PipelineFastModel) -> list:
    """The composed model's consistency invariant: its claim must equal
    max(hop peaks) plus the resident intermediate counted exactly once.
    Returns the violations (empty when consistent)."""
    extra = model.t_bytes if model.t_resident else 0.0
    want = (max(model.hop1.fast_bytes_needed, model.hop2.fast_bytes_needed)
            + extra)
    if model.fast_bytes_needed != want:
        return [
            f"composed pipeline byte model is inconsistent: claims "
            f"{model.fast_bytes_needed:.0f} B but max(hop1 "
            f"{model.hop1.fast_bytes_needed:.0f}, hop2 "
            f"{model.hop2.fast_bytes_needed:.0f}) + resident intermediate "
            f"{extra:.0f} = {want:.0f} B — the intermediate persists across "
            f"both hops and must be counted exactly once"]
    return []


def pipeline_audit_traces(A: CSR, P: CSR, R: CSR, plan: PipelinePlan, backend: str,
                          caps: PipelineCaps | None = None) -> list:
    """Stage both hops' cores for the static auditor, exactly as the
    executor would: ``[(hop_label, TraceTarget, hop_plan, hop_envelope),
    ...]``, each hop through the backend's ``audit_trace`` at its
    :func:`pipeline_envelope` (block-capped for a block backend). Hop 2 is
    staged against the intermediate's exact pattern (``caps.t_pattern``:
    the audit needs no values). ``whole_fast`` hops have no chunked core
    and are left out."""
    spec = backend_registry.get(backend)
    if not spec.supports_audit:
        raise ValueError(f"backend {backend!r} registers no audit_trace")
    if caps is None:
        caps = pipeline_output_caps(A, P, R, plan.plan1.p_ac, plan.plan2.p_ac)
    penv = pipeline_envelope(A, P, R, plan, caps,
                             spec.block_size if spec.needs_block_caps else None)
    out = []
    for label, X, Y, hplan, henv in (
            ("hop1", A, P, plan.plan1, penv.hop1),
            ("hop2", R, caps.t_pattern, plan.plan2, penv.hop2)):
        if hplan.algorithm == "whole_fast":
            continue
        out.append((label, spec.audit_trace(X, Y, hplan, henv.c_pad, henv), hplan, henv))
    return out


def audit_pipeline(A: CSR, P: CSR, R: CSR, plan: PipelinePlan, backend: str = "sparse",
                   caps: PipelineCaps | None = None):
    """Static audit of one pipeline: each hop's staged core runs once under
    the copy-event recorder (``analysis.traffic.traced_flows``), the
    backend's per-hop byte model must dominate the hop's staged step
    (``analysis.smem.audit_smem``: its ``step_bytes`` is the reference's
    traced bytes), and the composed :class:`PipelineFastModel` must count
    the resident intermediate exactly once (:func:`check_pipeline_model`)
    and cover the two-hop peak plus the resident T. Returns ``(record,
    violations)``; a hop's record is its ``SmemAudit``. A backend without a
    byte model (``scan``) is staged and recorded with no model to hold
    (``fast_bytes_needed`` None), where the reference raises."""
    from repro_torch.analysis.smem import audit_smem
    from repro_torch.analysis.traffic import traced_flows

    spec = backend_registry.get(backend)
    if caps is None:
        caps = pipeline_output_caps(A, P, R, plan.plan1.p_ac, plan.plan2.p_ac)
    model, violations = None, []
    if spec.byte_model is not None:
        penv = pipeline_envelope(A, P, R, plan, caps,
                                 spec.block_size if spec.needs_block_caps else None)
        model = pipeline_fast_model(plan, penv, backend)
        violations = list(check_pipeline_model(model))
    record = {"backend": backend, "t_resident": plan.t_resident,
              "t_bytes": plan.t_bytes, "hops": {}}
    traced_peak = 0.0
    for label, target, hplan, henv in pipeline_audit_traces(A, P, R, plan, backend,
                                                            caps=caps):
        hmodel = spec.byte_model(hplan, henv) if spec.byte_model is not None else None
        audit = audit_smem(target, traced_flows(target), hmodel)
        if audit.dominated is False:
            violations.append(
                f"{label}: byte model undercounts the staged step (model "
                f"{audit.model_bytes:.0f} B < staged {audit.step_bytes:.0f} B)")
        traced_peak = max(traced_peak, audit.step_bytes)
        record["hops"][label] = dataclasses.asdict(audit)
    resident_extra = plan.t_bytes if plan.t_resident else 0.0
    if (model is not None and traced_peak
            and model.fast_bytes_needed < traced_peak + resident_extra):
        violations.append(
            f"composed model {model.fast_bytes_needed:.0f} B does not cover the "
            f"staged two-hop peak {traced_peak:.0f} B plus the resident "
            f"intermediate {resident_extra:.0f} B")
    record["fast_bytes_needed"] = None if model is None else model.fast_bytes_needed
    record["traced_peak"] = traced_peak
    record["n_violations"] = len(violations)
    return record, violations
