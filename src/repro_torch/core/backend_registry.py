"""Backend registry: one `BackendSpec` per chunked-SpGEMM backend.

A backend ships its executors plus a :class:`BackendSpec`; the dispatchers
(``chunked_spgemm``, ``chunked_spgemm_batched``, ``SpGEMMService``) and the
planner's ``auto`` resolve derive from ``specs()`` / ``all_backends()``.
Registrations live at the bottom of ``repro_torch.core.chunk_stream`` (the
module that owns the executors and their cores); :func:`ensure_registered`
imports it on first use, so this module imports nothing from the rest of
the package at module scope.

Contracts a spec must honor:

* ``executors`` maps every plan algorithm (``knl``/``chunk1``/``chunk2``)
  to an executor ``fn(A, B, plan, c_pad, ...) -> (C, ChunkStats)``.
  Executors with ``needs_output_caps`` additionally receive the symbolic
  phase's ``StripOutputCaps`` as ``caps=``.
* ``run_batched(As, Bs, plan, envelope, *, caps_list, validate_caps,
  cores)`` runs the whole microbatch under a shared
  :class:`~repro_torch.sparse.csr.GeometryEnvelope`; ``None`` means the
  backend is unbatched-only (the host-loop oracle).
* ``trace_key`` / ``trace_key_batched`` are ``"{alg}"``-templates naming
  the backend's ``chunk_stream.TRACE_COUNTS`` keys: one count each time a
  core meets a static geometry it has not run before (the port's analogue
  of a jit trace), the compile accounting the serving layer reads.
* ``make_batched_cores(donate=False) -> dict`` builds a fresh set of the
  batched cores (algorithm -> core), passed back as ``run_batched(...,
  cores=...)``. The module-level cores remember every geometry for the life
  of the process; a serving bucket that owns its set forgets its geometries
  with the set when it is evicted, so a refault counts again.
* ``byte_model(plan, envelope) -> BackendFastModel`` is the planner-side
  peak-resident model ``backend="auto"`` argmins over; accumulator
  backends (``is_accumulator``) must provide one.
* ``needs_block_caps`` backends (``bsr``) read the envelope's block caps
  and must register a default ``block_size``.
* ``run_masked(A, B, mask, plan, c_pad, caps=...) -> (C, ChunkStats)``
  computes ``(A x B) ∘ mask`` with the mask applied inside the kernel; the
  fused triangle count (``repro_torch.core.triangle``) resolves through it,
  and through ``run_masked_placed(A, B, mask, plan, c_pad, caps, placement,
  device, on_strip=None)`` with operands in slow memory.
* ``run_placed(A, B, plan, c_pad, caps, placement, device)`` is the
  executor with operands in slow memory (the copy ring); every registered
  backend has one, and ``chunked_spgemm`` raises for a spec without.
  ``run_batched_placed`` is the batched entry's (``run_batched``'s
  arguments plus ``placement`` and ``device``): the envelope-padded stacks
  of a slow operand in slow memory, one ring for the whole batch.
* ``audit_trace(A, B, plan, c_pad, envelope) -> TraceTarget`` stages one
  instance at an envelope exactly as the executors do, for the static
  auditor (``repro_torch.analysis``); ``traffic_model(A, B, plan, c_pad,
  envelope, meta) -> ExpectedTraffic`` declares the copy events of that
  staged launch (a spec with one needs an ``audit_trace``);
  ``stats_exempt`` names why a backend's ChunkStats are not tied to its
  events.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

ALGORITHMS = ("knl", "chunk1", "chunk2")


@dataclasses.dataclass(frozen=True)
class OpFlow:
    """Per-operand copy-event model: the ordered byte sizes of every
    slow->fast (or fast->slow) copy one kernel operand performs across the
    whole launch. ``key`` names the logical operand (the three field
    operands of one CSR piece share one key — their per-event bytes then sum
    into the single ``ChunkStats`` event the executor logs)."""

    key: str
    events: tuple     # ordered per-copy byte sizes, one float per copy event


@dataclasses.dataclass(frozen=True)
class ExpectedTraffic:
    """A backend's declared data-movement model for one staged core: the
    per-operand copy-event lists the recorded launch must reproduce
    *exactly* (``analysis/traffic.py`` checks equality, not domination),
    plus the ``ChunkStats``-granularity event lists the executors report
    (same-key operand flows merged event-wise). ``stats_exempt`` names a
    documented reason the stats tie is skipped; the per-operand flow check
    still applies."""

    in_ops: tuple                  # tuple[OpFlow, ...], slow->fast
    out_ops: tuple                 # tuple[OpFlow, ...], fast->slow
    stats_in: tuple = ()           # ChunkStats.per_copy_in the executor logs
    stats_out: tuple = ()          # ChunkStats.per_copy_out the executor logs
    stats_exempt: str | None = None


@dataclasses.dataclass(frozen=True)
class TraceTarget:
    """One backend core as the executors launch it, for the static
    auditor: ``fn(*args)`` runs it, ``fn`` being the core
    (``chunk_stream._Core``) with its keyword statics bound
    (``functools.partial``), ``args`` its staged envelope-shaped operands.
    The port has no tracer: the core's static geometry (``_Core.geometry``:
    the operands' shapes, dtypes and CSR metadata, and the statics) is its
    trace, and ``meta`` carries the statics both sides were staged from
    (``scalar_args``: r0s/r1s or the BSR slot tables; ``table_size``,
    ``row_cap``). Kept here so the analysis package and the executor module
    never import each other."""

    fn: Callable
    args: tuple
    meta: Mapping[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """Everything the dispatch, planning and serving layers need to run a
    backend."""

    name: str
    executors: Mapping[str, Callable]           # algorithm -> executor
    run_batched: Callable | None = None         # batched entry; None = unbatched-only
    byte_model: Callable | None = None          # (plan, envelope) -> BackendFastModel
    trace_key: str | None = None                # "{alg}"-template, unbatched cores
    trace_key_batched: str | None = None        # "{alg}"-template, batched cores
    needs_output_caps: bool = False             # executor takes caps=StripOutputCaps
    needs_block_caps: bool = False              # envelope must carry bsr_caps
    is_accumulator: bool = False                # participates in backend="auto"
    block_size: int | None = None               # default block edge (block backends)
    run_masked: Callable | None = None          # fused-mask executor, or None
    run_masked_placed: Callable | None = None   # the same with operands in slow memory
    make_batched_cores: Callable | None = None  # (donate=False) -> fresh batched cores
    audit_trace: Callable | None = None         # (A, B, plan, c_pad, env) -> TraceTarget
    traffic_model: Callable | None = None       # (A, B, plan, c_pad, env, meta) -> ExpectedTraffic
    stats_exempt: str | None = None             # why the ChunkStats tie is not checked
    # (A, B, plan, c_pad, caps, placement, device) -> (C, ChunkStats): the
    # executor with operands in slow memory (the copy ring)
    run_placed: Callable | None = None
    # run_batched's signature plus placement= and device=: the batched
    # entry with operands in slow memory (one ring for the batch)
    run_batched_placed: Callable | None = None
    # run_placed's signature: slow operands read in place by the kernel
    # from pinned host memory, one launch a strip
    run_in_place: Callable | None = None
    run_masked_in_place: Callable | None = None   # run_masked_placed's, in place
    run_batched_in_place: Callable | None = None  # run_batched_placed's, in place

    @property
    def supports_batched(self) -> bool:
        return self.run_batched is not None

    @property
    def supports_audit(self) -> bool:
        return self.audit_trace is not None

    @property
    def supports_traffic(self) -> bool:
        return self.traffic_model is not None

    @property
    def supports_mask(self) -> bool:
        return self.run_masked is not None

    @property
    def supports_placement(self) -> bool:
        return self.run_placed is not None

    @property
    def supports_in_place(self) -> bool:
        return self.run_in_place is not None


_REGISTRY: dict[str, BackendSpec] = {}


def register(spec: BackendSpec) -> BackendSpec:
    """Register a backend. Name collisions fail loudly — a duplicate
    registration is always a wiring bug."""
    if spec.name in _REGISTRY:
        raise ValueError(f"backend {spec.name!r} already registered")
    if spec.name == "auto":
        raise ValueError("'auto' is the dispatch mode, not a registrable backend")
    missing = [alg for alg in ALGORITHMS if alg not in spec.executors]
    if missing:
        raise ValueError(f"backend {spec.name!r} missing executors for {missing}")
    if spec.is_accumulator and spec.byte_model is None:
        raise ValueError(
            f"accumulator backend {spec.name!r} needs a planner byte model")
    # one TRACE_COUNTS key per algorithm: a template without the "{alg}" slot
    # would fold the three algorithms onto one counter
    for field in ("trace_key", "trace_key_batched"):
        template = getattr(spec, field)
        if template is not None and "{alg}" not in template:
            raise ValueError(
                f"backend {spec.name!r}: {field}={template!r} must contain "
                "the '{alg}' placeholder (one TRACE_COUNTS key per algorithm)")
    if spec.traffic_model is not None and spec.audit_trace is None:
        raise ValueError(
            f"backend {spec.name!r} registers a traffic_model without an "
            "audit_trace: the flow-equality analysis has no staged launch "
            "to hold the model to")
    if spec.needs_block_caps and spec.block_size is None:
        raise ValueError(
            f"backend {spec.name!r} needs_block_caps but registers no "
            "block_size: the dispatch could not build its default "
            "block-capped envelope")
    _REGISTRY[spec.name] = spec
    return spec


def ensure_registered() -> None:
    """Import the module that owns the executors (and therefore the
    registrations). Idempotent: module bodies run once."""
    import repro_torch.core.chunk_stream  # noqa: F401  (registrations at module bottom)


def get(name: str) -> BackendSpec:
    """Resolve a backend name; unknown names raise the dispatcher's
    canonical error."""
    ensure_registered()
    spec = _REGISTRY.get(name)
    if spec is None:
        raise ValueError(f"unknown backend {name!r}")
    return spec


def specs() -> tuple:
    """All registered specs, in registration order (the order is the
    planner's tie-break priority for accumulators)."""
    ensure_registered()
    return tuple(_REGISTRY.values())


def all_backends() -> tuple:
    """Registered backend names, registration order (excludes ``auto``)."""
    return tuple(s.name for s in specs())


def batched_backends() -> tuple:
    """Names of backends with a batched entry point."""
    return tuple(s.name for s in specs() if s.supports_batched)


def accumulator_specs() -> tuple:
    """Specs participating in the planner's ``auto`` resolve, priority order."""
    return tuple(s for s in specs() if s.is_accumulator)


def in_place_backends() -> tuple:
    """Names of backends whose kernel reads slow operands in place."""
    return tuple(s.name for s in specs() if s.supports_in_place)


def masked_backends() -> tuple:
    """Names of backends that can fuse an output mask into their kernel."""
    return tuple(s.name for s in specs() if s.supports_mask)
