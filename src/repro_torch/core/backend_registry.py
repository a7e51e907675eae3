"""Backend registry: one `BackendSpec` per chunked-SpGEMM backend.

A backend ships its executors plus a :class:`BackendSpec`; the dispatcher
(``chunked_spgemm``) and the planner's ``auto`` resolve derive from
``specs()``. Registrations live at the bottom of
``repro_torch.core.chunk_stream`` (the module that owns the executors);
:func:`ensure_registered` imports it on first use, so this module imports
nothing from the rest of the package at module scope.

Contracts a spec must honor:

* ``executors`` maps every plan algorithm (``knl``/``chunk1``/``chunk2``)
  to an executor ``fn(A, B, plan, c_pad, ...) -> (C, ChunkStats)``.
  Executors with ``needs_output_caps`` additionally receive the symbolic
  phase's ``StripOutputCaps`` as ``caps=``.
* ``byte_model(plan, envelope) -> BackendFastModel`` is the planner-side
  peak-resident model ``backend="auto"`` argmins over; accumulator
  backends (``is_accumulator``) must provide one.
* ``needs_block_caps`` backends (``bsr``) read the envelope's block caps
  and must register a default ``block_size``.
* ``run_masked(A, B, mask, plan, c_pad, caps=...) -> (C, ChunkStats)``
  computes ``(A x B) ∘ mask`` with the mask applied inside the kernel; the
  fused triangle count (``repro_torch.core.triangle``) resolves through it.

The JAX package's specs carry more fields (batched entry points, trace
keys, audit and traffic models); they arrive with the slices that port
those features.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

ALGORITHMS = ("knl", "chunk1", "chunk2")


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """Everything the dispatch and planning layers need to run a backend."""

    name: str
    executors: Mapping[str, Callable]           # algorithm -> executor
    byte_model: Callable | None = None          # (plan, envelope) -> BackendFastModel
    needs_output_caps: bool = False             # executor takes caps=StripOutputCaps
    needs_block_caps: bool = False              # envelope must carry bsr_caps
    is_accumulator: bool = False                # participates in backend="auto"
    block_size: int | None = None               # default block edge (block backends)
    run_masked: Callable | None = None          # fused-mask executor, or None

    @property
    def supports_mask(self) -> bool:
        return self.run_masked is not None


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


def accumulator_specs() -> tuple:
    """Specs participating in the planner's ``auto`` resolve, priority order."""
    return tuple(s for s in specs() if s.is_accumulator)


def masked_backends() -> tuple:
    """Names of backends that can fuse an output mask into their kernel."""
    return tuple(s.name for s in specs() if s.supports_mask)
