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
  registered backend, with the pre-sized caps, so neither hop re-expands the
  symbolic structure. On the spill path T is written to slow memory
  (pinned host memory on the card, a host copy on the CPU) and stays
  there: hop 2 streams it as its B operand through the backend's copy ring
  (``repro_torch.core.copy_ring``), under every registered backend;
* the composed byte model (:func:`pipeline_fast_model`) counts the resident
  intermediate exactly once (:func:`check_pipeline_model`).

The JAX package's static-audit hooks (``pipeline_audit_traces``,
``audit_pipeline``) need the static auditor and are not ported yet.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import backend_registry
from repro_torch.core.chunking import ChunkStats, instance_envelope, whole_fast
from repro_torch.core.placement import ALL_FAST, Placement
from repro_torch.core.planner import BackendFastModel, PipelinePlan, plan_pipeline
from repro_torch.core.symbolic import PipelineCaps, pipeline_output_caps
from repro_torch.sparse.csr import CSR, GeometryEnvelope, csr_pin, refuse_pinned


@dataclasses.dataclass(frozen=True)
class PipelineEnvelope:
    """Both hops' padded geometries, pre-sized together by the composed
    symbolic phase (``hop2.b_max_row_nnz`` is the densest row of ``T``)."""

    hop1: GeometryEnvelope   # T = A x P
    hop2: GeometryEnvelope   # C = R x T


def pipeline_envelope(A: CSR, P: CSR, R: CSR, plan: PipelinePlan,
                      caps: PipelineCaps) -> PipelineEnvelope:
    """Both hop envelopes from one composed symbolic pass; hop 2's is built
    against the intermediate's exact *pattern*, before hop 1 runs."""
    return PipelineEnvelope(
        hop1=instance_envelope(A, P, plan.plan1, caps=caps.hop1),
        hop2=instance_envelope(R, caps.t_pattern, plan.plan2, caps=caps.hop2),
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


def _run_hop(X: CSR, Y: CSR, plan, caps, backend: str, placement=ALL_FAST,
             device=None):
    """One hop through a registered backend at pre-sized caps, on ``device``
    (``X``'s by default). A whole_fast hop's output carries the exact
    densest-row bound (the reference's carries ``c_pad``), which hop 2 reads
    as its streamed ``b_max_row_nnz``. Operands that ``placement`` puts in
    slow memory cross whole in a whole_fast hop and through the backend's
    copy ring (``run_placed``) in a chunked one."""
    if plan.algorithm == "whole_fast":
        return whole_fast(X, Y, caps.c_pad, placement, device or X.device,
                          caps.c_max_row_nnz)
    spec = backend_registry.get(backend)
    fn = spec.executors.get(plan.algorithm)
    if fn is None:
        raise ValueError(f"unknown algorithm {plan.algorithm!r}")
    if placement != ALL_FAST:
        return spec.run_placed(X, Y, plan, caps.c_pad, caps, placement, device)
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
                    backend: str = "sparse", caps: PipelineCaps | None = None):
    """Execute ``C = R x (A x P)`` as a fused two-hop pipeline.

    Returns ``(C, PipelineStats)``. ``plan`` defaults to
    ``planner.plan_pipeline(A, P, R, system, fast_limit_bytes)`` (``system``
    is then required); ``caps`` defaults to the composed symbolic phase at
    the plan's partitions. ``backend`` names any registered backend; both
    hops run through it. On the resident path the intermediate's device CSR
    flows straight into hop 2; on the spill path it is written to slow
    memory and hop 2 streams it through the copy ring as its B operand (R
    and C stay on the run device), and the stats carry the extra copy
    events. Its inputs must be on the run device: placed inputs are ROADMAP
    Queue 1 item 7c.
    """
    refuse_pinned("pipeline_spgemm", A, P, R)
    if plan is None:
        if system is None:
            raise ValueError(
                "pipeline_spgemm needs either a PipelinePlan or a "
                "MemorySystem to plan against")
        plan = plan_pipeline(A, P, R, system, fast_limit_bytes=fast_limit_bytes)
    if caps is None:
        caps = pipeline_output_caps(A, P, R, plan.plan1.p_ac, plan.plan2.p_ac)
    T, stats1 = _run_hop(A, P, plan.plan1, caps.hop1, backend)
    spilled = not plan.t_resident
    spill_bytes = 0.0
    placement, device = ALL_FAST, None
    if spilled:
        device = T.device
        T = _spill_to_slow(T)
        t_reads = plan.plan2.n_ac if plan.plan2.algorithm == "chunk1" else 1
        spill_bytes = float(T.nbytes()) * (1 + t_reads)
        placement = Placement("fast", "slow", "fast")
    C, stats2 = _run_hop(R, T, plan.plan2, caps.hop2, backend, placement, device)
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
