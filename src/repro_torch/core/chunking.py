"""Chunked SpGEMM executors: the paper's Algorithms 1 (KNL), 2 (Chunk1), 3 (Chunk2).

All three share the ranged fused-multiply-add (repro_torch.core.kkmem.spgemm_ranged):
a row-partition of B induces a column-partition of A that is realized by *skipping*
(masking) out-of-range A columns, never by physically repartitioning A.

Uniform padding: every B chunk is padded to the largest chunk's nnz and every
A/C row-strip to the largest strip, so the staged pieces stack into one tensor
per operand and every kernel launch of a plan sees one geometry.

Executors return (C, ChunkStats); ChunkStats carries the fast<->slow traffic
(what `copy2Fast`/`copy2Slow` would have moved), which tests compare against the
planner's modeled copy cost.

This module holds the host-driven loop executors (the oracle path) and the
dispatcher; the other backends live in repro_torch.core.chunk_stream and
register there.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.kkmem import spgemm, spgemm_ranged
from repro_torch.core.planner import ChunkPlan
from repro_torch.core.symbolic import strip_output_caps
from repro_torch.sparse.csr import (
    CSR, GeometryEnvelope, _csr_from_tensors, _np, csr_pad_to,
    csr_select_rows_host, dtype_name,
)


@dataclasses.dataclass(frozen=True)
class ChunkStats:
    """Copy events and multiply calls of one chunked run.

    ``per_copy_in``/``per_copy_out`` are the ordered per-copy event logs (one
    entry per staged transfer, in issue order); the byte totals are their
    running sums, in issue order."""

    algorithm: str
    n_ac: int
    n_b: int
    kernel_calls: int = 0
    per_copy_in: tuple = ()    # slow -> fast
    per_copy_out: tuple = ()   # fast -> slow

    @property
    def copy_in_bytes(self) -> float:
        return _running_sum(self.per_copy_in)

    @property
    def copy_out_bytes(self) -> float:
        return _running_sum(self.per_copy_out)

    @property
    def copy_bytes(self) -> float:
        return self.copy_in_bytes + self.copy_out_bytes


def _running_sum(events) -> float:
    # left to right like the reference's `+=` (the builtin sum() compensates)
    total = 0.0
    for v in events:
        total += v
    return total


class StatsLog:
    """Mutable event log an executor fills while it runs; :meth:`freeze`
    returns the :class:`ChunkStats`."""

    def __init__(self, algorithm: str, n_ac: int, n_b: int):
        self.algorithm, self.n_ac, self.n_b = algorithm, n_ac, n_b
        self.kernel_calls = 0
        self.per_copy_in: list = []
        self.per_copy_out: list = []

    def add_in(self, nbytes: float) -> None:
        self.per_copy_in.append(float(nbytes))

    def add_out(self, nbytes: float) -> None:
        self.per_copy_out.append(float(nbytes))

    def freeze(self) -> ChunkStats:
        return ChunkStats(self.algorithm, self.n_ac, self.n_b, self.kernel_calls,
                          tuple(self.per_copy_in), tuple(self.per_copy_out))


def _partition_caps(m: CSR, bounds: tuple) -> tuple:
    """(nnz cap, row cap) of the largest piece of a contiguous row partition."""
    ptr = _np(m.indptr)
    cap = max(int(ptr[e] - ptr[s]) for s, e in zip(bounds[:-1], bounds[1:]))
    rows = max(e - s for s, e in zip(bounds[:-1], bounds[1:]))
    return max(cap, 1), rows


def _row_pieces(m: CSR, bounds: tuple, caps: tuple | None = None) -> list:
    """Row pieces of ``m`` padded to ``caps = (nnz cap, rows, max_row_nnz)``,
    or to the largest piece's nnz and rows and ``m``'s own row bound."""
    if caps is None:
        cap, rows = _partition_caps(m, bounds)
        caps = (cap, rows, m.max_row_nnz)
    cap, rows, mrn = caps
    return [
        csr_pad_to(csr_select_rows_host(m, s, e, pad_to=cap),
                   rows=rows, max_row_nnz=mrn)
        for s, e in zip(bounds[:-1], bounds[1:])
    ]


def b_chunks(B: CSR, p_b: tuple, envelope: GeometryEnvelope | None = None) -> list:
    """Row chunks of B, uniformly padded (rows and nnz).

    Without an envelope the caps come from this instance's largest chunk (the
    single-problem case); with one, every chunk is padded to the envelope's
    ``chunk_nnz_cap``/``chunk_rows``/``b_max_row_nnz``, so chunks from
    *different* instances stack into one batch."""
    return _row_pieces(B, p_b, None if envelope is None else (
        envelope.chunk_nnz_cap, envelope.chunk_rows, envelope.b_max_row_nnz))


def a_strips(A: CSR, p_ac: tuple, envelope: GeometryEnvelope | None = None) -> list:
    """Row strips of A, uniformly padded (rows and nnz); with an envelope the
    caps are the batch-wide ``strip_nnz_cap``/``strip_rows``/``a_max_row_nnz``."""
    return _row_pieces(A, p_ac, None if envelope is None else (
        envelope.strip_nnz_cap, envelope.strip_rows, envelope.a_max_row_nnz))


def instance_envelope(A: CSR, B: CSR, plan: ChunkPlan,
                      c_pad: int | None = None, caps=None,
                      block_size: int | None = None) -> GeometryEnvelope:
    """The padded geometry one (A, B) instance needs under ``plan``.

    The symbolic phase (repro_torch.core.symbolic) runs once here unless the
    caller passes its ``StripOutputCaps`` as ``caps``; its output caps fold
    into the envelope. ``c_pad`` only overrides the *capacity* field.

    ``block_size`` opts into the block-level symbolic phase
    (``symbolic.bsr_plan_caps``): the envelope then carries ``bsr_caps``,
    which makes the ``bsr`` backend dispatchable and priceable."""
    if caps is None:
        caps = strip_output_caps(A, B, plan.p_ac)
    if c_pad is None:
        c_pad = caps.c_pad
    bsr_caps = ()
    if block_size is not None:
        from repro_torch.core.symbolic import bsr_plan_caps

        bsr_caps = bsr_plan_caps(A, B, plan, block_size).as_tuple()
    chunk_cap, chunk_rows = _partition_caps(B, plan.p_b)
    strip_cap, strip_rows = _partition_caps(A, plan.p_ac)
    return GeometryEnvelope(
        a_shape=A.shape, b_shape=B.shape,
        a_nnz_cap=A.nnz_pad, a_max_row_nnz=A.max_row_nnz,
        b_max_row_nnz=B.max_row_nnz,
        chunk_rows=chunk_rows, chunk_nnz_cap=chunk_cap,
        strip_rows=strip_rows, strip_nnz_cap=strip_cap,
        c_pad=int(c_pad), dtype=dtype_name(A.dtype),
        c_nnz_cap=caps.c_nnz_cap, c_max_row_nnz=caps.c_max_row_nnz,
        bsr_caps=bsr_caps,
    )


def batch_envelope(As, Bs, plan: ChunkPlan, c_pad: int | None = None,
                   caps_list=None, block_size: int | None = None) -> GeometryEnvelope:
    """Union of per-instance envelopes: the smallest shared padded geometry a
    heterogeneous batch can be repadded to (``c_pad`` overrides the symbolic
    default for every instance when given). Callers that already ran the
    symbolic phase per instance pass its ``StripOutputCaps`` as ``caps_list``;
    ``block_size`` folds block caps into every instance envelope (see
    :func:`instance_envelope`) so the union is block-capped too."""
    As, Bs = list(As), list(Bs)
    if caps_list is None:
        caps_list = [None] * len(As)
    return GeometryEnvelope.batch(
        instance_envelope(A, B, plan, c_pad=c_pad, caps=caps,
                          block_size=block_size)
        for A, B, caps in zip(As, Bs, caps_list)
    )


def _empty_like_c(n_rows: int, n_cols: int, c_pad: int, dtype, device) -> CSR:
    return CSR(
        indptr=torch.zeros(n_rows + 1, dtype=torch.int32, device=device),
        indices=torch.zeros(c_pad, dtype=torch.int32, device=device),
        data=torch.zeros(c_pad, dtype=dtype, device=device),
        shape=(n_rows, n_cols),
        max_row_nnz=0,
    )


def _assemble(strips, p_ac: tuple, n_cols: int) -> CSR:
    """Concatenate per-strip C results into one CSR over all rows."""
    bounds = list(zip(p_ac[:-1], p_ac[1:]))
    ends = torch.stack([c.indptr[e - s] for (s, e), c in zip(bounds, strips)])
    nnzs = [int(v) for v in ends.tolist()]
    ptrs, idxs, vals = [], [], []
    base = 0
    for (s, e), c, nnz in zip(bounds, strips, nnzs):
        ptrs.append(c.indptr[: e - s] + base)
        idxs.append(c.indices[:nnz])
        vals.append(c.data[:nnz])
        base += nnz
    ptrs.append(torch.full((1,), base, dtype=torch.int32, device=ends.device))
    return _csr_from_tensors(torch.cat(ptrs), torch.cat(idxs), torch.cat(vals),
                             (p_ac[-1] - p_ac[0], n_cols), base, None)


# ---------------------------------------------------------------------------
# Algorithm 1: KNL chunking — A, C in slow memory; stream B chunks through fast
# ---------------------------------------------------------------------------


def chunk_knl(A: CSR, B: CSR, plan: ChunkPlan, c_pad: int):
    stats = StatsLog("knl", 1, plan.n_b)
    chunks = b_chunks(B, plan.p_b)
    C = _empty_like_c(A.n_rows, B.n_cols, c_pad, A.dtype, A.device)
    for (r0, r1), Bc in zip(zip(plan.p_b[:-1], plan.p_b[1:]), chunks):
        stats.add_in(Bc.nbytes())                       # copy2Fast(B, B_rp)
        C = spgemm_ranged(A, Bc, r0, r1, C, c_pad)      # kkmem(A, FastB, C, B_rp)
        stats.kernel_calls += 1
    return C, stats.freeze()


# ---------------------------------------------------------------------------
# Algorithms 2 & 3: GPU chunking — 2-D partitions, two streaming orders
# ---------------------------------------------------------------------------


def chunk_gpu1(A: CSR, B: CSR, plan: ChunkPlan, c_pad: int):
    """Alg. 2 — A,C strips stationary in fast memory; B chunks streamed (inner)."""
    stats = StatsLog("chunk1", plan.n_ac, plan.n_b)
    strips = a_strips(A, plan.p_ac)
    chunks = b_chunks(B, plan.p_b)
    out = []
    for (a0, a1), Ai in zip(zip(plan.p_ac[:-1], plan.p_ac[1:]), strips):
        stats.add_in(Ai.nbytes())                        # FA = copy2Fast(A)
        stats.add_in((a1 - a0 + 1) * 4)                  # FC row pointers only
        Ci = _empty_like_c(Ai.n_rows, B.n_cols, c_pad, A.dtype, A.device)
        for (r0, r1), Bc in zip(zip(plan.p_b[:-1], plan.p_b[1:]), chunks):
            stats.add_in(Bc.nbytes())                    # FB = copy2Fast(B)
            Ci = spgemm_ranged(Ai, Bc, r0, r1, Ci, c_pad)
            stats.kernel_calls += 1
        stats.add_out(Ci.nbytes())                       # copy2Slow(FC)
        out.append(Ci)
    return _assemble(out, plan.p_ac, B.n_cols), stats.freeze()


def chunk_gpu2(A: CSR, B: CSR, plan: ChunkPlan, c_pad: int):
    """Alg. 3 — B chunk stationary in fast memory; A,C strips streamed (inner)."""
    stats = StatsLog("chunk2", plan.n_ac, plan.n_b)
    strips = a_strips(A, plan.p_ac)
    chunks = b_chunks(B, plan.p_b)
    partials = [
        _empty_like_c(s.n_rows, B.n_cols, c_pad, A.dtype, A.device) for s in strips
    ]
    n_b = plan.n_b
    for jb, ((r0, r1), Bc) in enumerate(zip(zip(plan.p_b[:-1], plan.p_b[1:]), chunks)):
        stats.add_in(Bc.nbytes())                        # FB = copy2Fast(B)
        for ia, Ai in enumerate(strips):
            stats.add_in(Ai.nbytes())                    # FA = copy2Fast(A)
            if jb > 0:
                stats.add_in(partials[ia].nbytes())      # FC partial back in
            partials[ia] = spgemm_ranged(Ai, Bc, r0, r1, partials[ia], c_pad)
            stats.kernel_calls += 1
            if jb < n_b - 1:
                stats.add_out(partials[ia].nbytes())     # partial out
        if jb == n_b - 1:
            for ia in range(len(strips)):
                stats.add_out(partials[ia].nbytes())     # final copy2Slow
    return _assemble(partials, plan.p_ac, B.n_cols), stats.freeze()


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------


def default_c_pad(A: CSR, B: CSR, plan: ChunkPlan) -> int:
    """Exact symbolic capacity of the largest row strip (whole C for 1-strip
    plans)."""
    return strip_output_caps(A, B, plan.p_ac).c_pad


def whole_fast(A: CSR, B: CSR, c_pad: int, placement, device,
               c_max_row_nnz: int = 0):
    """The ``whole_fast`` plan: one multiply of the whole operands, its one
    in-event and one out-event. A slow operand (``placement``) crosses to
    ``device`` whole, and a slow C goes back whole."""
    from repro_torch.core import copy_ring

    stats = StatsLog("whole_fast", 1, 1)
    stats.add_in(A.nbytes() + B.nbytes())
    link = copy_ring.Link(device)
    fast = [link.copy_in(k, m) if getattr(placement, k) == "slow" else m
            for k, m in (("A", A), ("B", B))]
    C = spgemm(*fast, c_pad, c_max_row_nnz)
    stats.add_out(C.nbytes())
    if placement.C == "slow":
        host = copy_ring.slow_stack(C, 1, device.type == "cuda")
        link.copy_out("C", [C], host)
        C = copy_ring.piece(host, 0)
    link.finish()
    stats.kernel_calls = 1
    return C, stats.freeze()


def chunked_spgemm(A: CSR, B: CSR, plan: ChunkPlan, c_pad: int | None = None,
                   backend: str = "scan", block_size: int | None = None, *,
                   placement=None, device=None):
    """Execute a ChunkPlan. ``c_pad`` defaults to the exact symbolic capacity of the
    largest row strip (whole C for 1-strip plans).

    ``backend`` names a registered :class:`repro_torch.core.backend_registry.
    BackendSpec` (``"loop"``, ``"scan"``, ``"pallas"``, ``"sparse"``,
    ``"hash"``, ``"bsr"``) or ``"auto"``, which lets the planner pick the
    accumulator backend whose peak-resident byte model is smallest under
    this instance's envelope (``planner.select_accumulator_backend``).
    ``needs_output_caps`` backends receive the symbolic phase's
    ``StripOutputCaps`` (one expansion amortized across the default
    ``c_pad``, the auto resolve, and the executor's overflow check).

    ``block_size`` opts the block symbolic phase into the envelope: under
    ``backend="auto"`` the planner can then price (and select) ``bsr``;
    under an explicit block backend it overrides the default block edge.

    ``placement`` (a :class:`repro_torch.core.placement.Placement`) and
    ``device`` say where the operands live and where the call runs
    (``placement.resolve_placement``): ``device=None`` is the card, and
    ``device="cpu"`` runs the plain versions. On the card a pinned operand
    is slow and one on the card fast, read from the operands when
    ``placement`` is ``None``. With a slow operand the ``sparse`` and ``hash`` backends stage
    every counted piece across the link through the copy ring, and the
    result is in pinned host memory when C is slow; ``whole_fast`` copies
    the slow operands whole. Any other backend raises on a slow operand, as
    does an ``auto`` that resolves to one: nothing substitutes another
    backend or runs on the host.
    """
    from repro_torch.core import backend_registry
    from repro_torch.core.placement import ALL_FAST, resolve_placement

    placement, run_device = resolve_placement({"A": A, "B": B}, placement, device)
    spec = None if backend == "auto" else backend_registry.get(backend)
    caps = None
    if c_pad is None or backend == "auto" or (spec is not None
                                              and spec.needs_output_caps):
        caps = strip_output_caps(A, B, plan.p_ac)
    if c_pad is None:
        c_pad = caps.c_pad
    if plan.algorithm == "whole_fast":
        return whole_fast(A, B, c_pad, placement, run_device)
    if backend == "auto":
        from repro_torch.core.planner import select_accumulator_backend

        env = instance_envelope(A, B, plan, c_pad=c_pad, caps=caps,
                                block_size=block_size)
        spec = backend_registry.get(select_accumulator_backend(plan, env))
    if placement != ALL_FAST:
        if not spec.supports_placement:
            raise ValueError(
                f"backend {spec.name!r} has no copy ring for operands in slow "
                f"memory ({placement}; ROADMAP Queue 1): use backend 'sparse' or "
                "'hash', or put the operands on the card with place(x, 'fast')")
        if plan.algorithm not in spec.executors:
            raise ValueError(f"unknown algorithm {plan.algorithm!r}")
        return spec.run_placed(A, B, plan, c_pad, caps, placement, run_device)
    fn = spec.executors.get(plan.algorithm)
    if fn is None:
        raise ValueError(f"unknown algorithm {plan.algorithm!r}")
    kwargs = {"caps": caps} if spec.needs_output_caps else {}
    if block_size is not None and spec.needs_block_caps:
        kwargs["block_size"] = block_size
    return fn(A, B, plan, c_pad, **kwargs)
