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
# Algorithms 1-3 and their copy events
# ---------------------------------------------------------------------------


def planned_events_ranged(plan: ChunkPlan, chunk_nbytes: int, strip_nbytes: int,
                          c_strip_nbytes: int) -> list:
    """The copy events of Algorithms 1-3 as written (their ``copy2Fast`` /
    ``copy2Slow``), each tagged with its operand: ``[(operand, "in" |
    "out", bytes), ...]`` in issue order.

    Uniform padding makes every B chunk / A strip / C partial the same size,
    so the event stream is fully determined by (algorithm, n_ac, n_b) plus the
    three footprints. Algorithm 1 counts only the streamed B chunks; in
    Chunk1 a strip's C comes in as its row pointers (``(a1 - a0 + 1) * 4``
    bytes) and goes out whole; in Chunk2 every strip's partial goes out after
    its step and comes back for the next chunk's.
    """
    if plan.algorithm == "knl":
        return [("B", "in", chunk_nbytes)] * plan.n_b
    events = []
    if plan.algorithm == "chunk1":
        for a0, a1 in zip(plan.p_ac[:-1], plan.p_ac[1:]):
            events += [("A", "in", strip_nbytes), ("C", "in", (a1 - a0 + 1) * 4)]
            events += [("B", "in", chunk_nbytes)] * plan.n_b
            events.append(("C", "out", c_strip_nbytes))
        return events
    if plan.algorithm == "chunk2":
        for jb in range(plan.n_b):
            events.append(("B", "in", chunk_nbytes))
            for _ in range(plan.n_ac):
                events.append(("A", "in", strip_nbytes))
                if jb > 0:
                    events.append(("C", "in", c_strip_nbytes))      # partial back in
                if jb < plan.n_b - 1:
                    events.append(("C", "out", c_strip_nbytes))     # partial out
        events += [("C", "out", c_strip_nbytes)] * plan.n_ac       # final copy2Slow
        return events
    raise ValueError(f"unknown algorithm {plan.algorithm!r}")


def _stats_of(plan: ChunkPlan, events: list) -> ChunkStats:
    """The :class:`ChunkStats` of tagged ``events``, one kernel call a
    (strip, chunk) step."""
    stats = StatsLog(plan.algorithm, plan.n_ac, plan.n_b)
    for _, direction, nbytes in events:
        (stats.add_in if direction == "in" else stats.add_out)(nbytes)
    stats.kernel_calls = plan.n_ac * plan.n_b
    return stats.freeze()


def planned_stats(plan: ChunkPlan, chunk_nbytes: int, strip_nbytes: int,
                  c_strip_nbytes: int) -> ChunkStats:
    """The ChunkStats of Algorithms 1-3 (:func:`planned_events_ranged`)."""
    return _stats_of(plan, planned_events_ranged(plan, chunk_nbytes, strip_nbytes,
                                                 c_strip_nbytes))


def _c_strip_nbytes(strip_rows: int, c_pad: int, dtype) -> int:
    return (strip_rows + 1) * 4 + c_pad * (4 + dtype.itemsize)


def _step_elements(plan: ChunkPlan) -> tuple:
    """(stationary, streamed) element of every step: A strips stationary and
    B chunks streamed in the chunk1 orders, the other way in Chunk2."""
    n_ac, n_b = plan.n_ac, plan.n_b
    if plan.algorithm == "chunk2":
        return list(range(n_b)), [i for _ in range(n_b) for i in range(n_ac)]
    return list(range(n_ac)), [j for _ in range(n_ac) for j in range(n_b)]


def run_ranged(A: CSR, B: CSR, plan: ChunkPlan, c_pad: int, placement, device,
               step):
    """Algorithms 1 (KNL), 2 (Chunk1) and 3 (Chunk2): one ranged
    multiply-add ``step(A_i, B_j, j, C_i) -> C_i`` a (strip, chunk) step.

    Each operand's pieces are read through the copy ring when ``placement``
    puts it slow (``copy_ring.source``; built in slow memory, pinned on the
    card) and straight from the pieces when it is fast, so an all-fast call
    opens no ring. The crossings are the paper's own
    (:func:`planned_events_ranged`): A strips stationary and B chunks
    streamed in Chunk1, the other way in Chunk2; a slow C comes in as a
    strip's row pointers and goes out whole in Chunk1, and in Chunk2 every
    partial goes out after its step and comes back before the next chunk's.
    Algorithm 1 counts only B's chunks, so a slow A crosses whole before the
    first step and a slow C whole after the last, each one transfer logged
    apart from the events (``Transfer.apart``), as :func:`whole_fast` moves
    its operands. Returns C (in pinned host memory on the card when C is
    slow) and :func:`planned_stats` of the plan."""
    from repro_torch.core import copy_ring
    from repro_torch.sparse.csr import csr_pin

    card = device.type == "cuda"
    n_ac, n_b, n_cols = plan.n_ac, plan.n_b, B.n_cols
    c_slow = placement.C == "slow"
    link = copy_ring.Link(device)

    def pieces(parts, space):
        return copy_ring.staged(parts, space, card) if space == "slow" else parts

    def launch(Ai, Bj, j, Ci):
        with link.step():
            return step(Ai, Bj, j, Ci)

    chunks = b_chunks(B, plan.p_b)
    chunk_nbytes = chunks[0].nbytes()
    Bs = pieces(chunks, placement.B)
    del chunks
    if plan.algorithm == "knl":
        get_b, put_b = copy_ring.source(link, "B", Bs, placement.B, "streamed", range(n_b))
        A_fast = link.copy_in("A", A, apart=True) if placement.A == "slow" else A
        C = _empty_like_c(A.n_rows, n_cols, c_pad, A.dtype, device)
        for j in range(n_b):
            C = launch(A_fast, get_b(j), j, C)          # kkmem(A, copy2Fast(B, B_rp), C)
            put_b(j)
        del A_fast
        if c_slow:
            host = copy_ring.slow_stack(C, 1, card)
            link.copy_out("C", [C], host, apart=True)
            C = copy_ring.piece(host, 0)
        link.finish()
        return C, planned_stats(plan, chunk_nbytes, 0, 0)

    strips = a_strips(A, plan.p_ac)
    strip_nbytes, strip_rows = strips[0].nbytes(), strips[0].n_rows
    As = pieces(strips, placement.A)
    del strips

    def empty_c(where):
        return _empty_like_c(strip_rows, n_cols, c_pad, A.dtype, where)

    c_out = copy_ring.slow_stack(empty_c("cpu"), n_ac, card) if c_slow else None
    stationary, streamed = _step_elements(plan)
    if plan.algorithm == "chunk1":
        get_a, put_a = copy_ring.source(link, "A", As, placement.A, "stationary", stationary)
        get_b, put_b = copy_ring.source(link, "B", Bs, placement.B, "streamed", streamed)
        if c_slow:
            # a strip's C starts empty: its row pointers (zeros) come in
            ptrs = torch.zeros(n_ac, strip_rows + 1, dtype=torch.int32, pin_memory=card)
            rows = [a1 - a0 for a0, a1 in zip(plan.p_ac[:-1], plan.p_ac[1:])]
            get_c, put_c = copy_ring.source(
                link, "C", [ptrs[i, :r + 1] for i, r in enumerate(rows)], "slow",
                "stationary", range(n_ac))
        out = []
        for i in range(n_ac):
            Ai, Ci = get_a(i), empty_c(device)          # FA = copy2Fast(A)
            if c_slow:                                  # FC row pointers only
                ptr = get_c(i)
                Ci.indptr[:ptr.numel()].copy_(ptr)
                put_c(i)
            for j in range(n_b):
                lin = i * n_b + j
                Ci = launch(Ai, get_b(lin), j, Ci)      # FB = copy2Fast(B)
                put_b(lin)
            put_a(i)
            if c_slow:
                link.copy_out("C", [Ci], c_out, first=i)   # copy2Slow(FC)
            else:
                out.append(Ci)
    else:
        get_b, put_b = copy_ring.source(link, "B", Bs, placement.B, "stationary", stationary)
        get_a, put_a = copy_ring.source(link, "A", As, placement.A, "streamed", streamed)
        out = [None] * n_ac
        for jb in range(n_b):
            Bj = get_b(jb)                              # FB = copy2Fast(B)
            for i in range(n_ac):
                lin = jb * n_ac + i
                if jb == 0:
                    out[i] = empty_c(device)
                elif c_slow:
                    out[i] = link.copy_in("C", copy_ring.piece(c_out, i))   # partial back in
                out[i] = launch(get_a(lin), Bj, jb, out[i])             # FA = copy2Fast(A)
                put_a(lin)
                if c_slow and jb < n_b - 1:
                    link.copy_out("C", [out[i]], c_out, first=i)           # partial out
                    out[i] = None
            put_b(jb)
        if c_slow:
            for i in range(n_ac):
                link.copy_out("C", [out[i]], c_out, first=i)               # final copy2Slow
    link.finish()
    if c_slow:
        out = [copy_ring.piece(c_out, i) for i in range(n_ac)]
    C = _assemble(out, plan.p_ac, n_cols)
    if c_slow and card:
        C = csr_pin(C)
    return C, planned_stats(plan, chunk_nbytes, strip_nbytes,
                            _c_strip_nbytes(strip_rows, c_pad, A.dtype))


def chunk_loop(A: CSR, B: CSR, plan: ChunkPlan, c_pad: int, caps=None,
               placement=None, device=None):
    """The ``loop`` executor of every algorithm (the oracle path):
    :func:`run_ranged` with ``spgemm_ranged`` a step, on ``device`` (A's
    by default) with the operands where ``placement`` puts them (all fast
    by default). ``caps`` is unused: the ranged merge cannot overflow
    ``c_pad``."""
    from repro_torch.core.placement import ALL_FAST

    del caps
    r0s, r1s = plan.b_ranges()

    def step(Ai, Bj, j, Ci):
        return spgemm_ranged(Ai, Bj, int(r0s[j]), int(r1s[j]), Ci, c_pad)

    return run_ranged(A, B, plan, c_pad, placement or ALL_FAST,
                      A.device if device is None else device, step)


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


SLOW_READS = ("ring", "in_place")


def in_place_refusal(what: str) -> ValueError:
    """The error of a call that cannot read its slow operands in place."""
    from repro_torch.core import backend_registry

    names = ", ".join(backend_registry.in_place_backends())
    return ValueError(
        f"slow_reads='in_place': {what}; only the streaming kernels read a slow "
        f"operand in place ({names}, and auto where it resolves to one of them): "
        "use slow_reads='ring', whose copy ring stages slow operands onto the card")


def chunked_spgemm(A: CSR, B: CSR, plan: ChunkPlan, c_pad: int | None = None,
                   backend: str = "scan", block_size: int | None = None, *,
                   placement=None, device=None, slow_reads: str = "ring", caps=None):
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

    ``caps`` is the symbolic phase's ``StripOutputCaps`` of (A, B) at the
    plan's strips when the caller already holds it (a timing path hoists
    the host expansion out of the call, as ``count_triangles``'s ``caps``);
    it is computed here otherwise.

    ``block_size`` opts the block symbolic phase into the envelope: under
    ``backend="auto"`` the planner can then price (and select) ``bsr``;
    under an explicit block backend it overrides the default block edge.

    ``placement`` (a :class:`repro_torch.core.placement.Placement`) and
    ``device`` say where the operands live and where the call runs
    (``placement.resolve_placement``): ``device=None`` is the card, and
    ``device="cpu"`` runs the plain versions. On the card a pinned operand
    is slow and one on the card fast, read from the operands when
    ``placement`` is ``None``. With a slow operand every backend (and the
    one ``auto`` resolves to) streams its pieces across the link through
    the copy ring (its spec's ``run_placed``), one launch a step, and the
    result is in pinned host memory when C is slow; ``whole_fast`` copies
    the slow operands whole. Nothing substitutes another backend or runs a
    slow operand's step on the host; a spec registered without
    ``run_placed`` raises.

    ``slow_reads="in_place"`` reads slow operands where they lie instead, as
    the reference's ``memory_space=ANY`` operands are read: the backend's
    streaming kernel launches once a strip of the plan (its spec's
    ``run_in_place``) on every slow operand's stacks in pinned host memory,
    fast operands and one strip's kernel workspace on the card, a slow C
    written in place; nothing crosses the copy ring. Only ``pallas``, ``sparse`` and ``hash`` (and
    ``auto`` resolving to one of them) take it; another backend, or a
    ``whole_fast`` plan, raises a ``ValueError``.
    """
    from repro_torch.core import backend_registry
    from repro_torch.core.placement import ALL_FAST, resolve_placement

    if slow_reads not in SLOW_READS:
        raise ValueError(f"slow_reads must be one of {SLOW_READS}, not {slow_reads!r}")
    in_place = slow_reads == "in_place"
    if in_place and plan.algorithm == "whole_fast":
        raise in_place_refusal("a whole_fast plan copies its operands whole")
    placement, run_device = resolve_placement({"A": A, "B": B}, placement, device)
    spec = None if backend == "auto" else backend_registry.get(backend)
    if in_place and spec is not None and not spec.supports_in_place:
        raise in_place_refusal(f"backend {backend!r} has no such kernel")
    if caps is not None and len(caps.strip_nnz) != len(plan.p_ac) - 1:
        raise ValueError(f"caps hold {len(caps.strip_nnz)} strips, the plan "
                         f"{len(plan.p_ac) - 1}")
    if caps is None and (c_pad is None or backend == "auto"
                         or (spec is not None and spec.needs_output_caps)):
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
    if in_place:
        if not spec.supports_in_place:
            raise in_place_refusal(f"backend 'auto' resolves to {spec.name!r}, which "
                                   "has no such kernel")
        if plan.algorithm not in spec.executors:
            raise ValueError(f"unknown algorithm {plan.algorithm!r}")
        return spec.run_in_place(A, B, plan, c_pad, caps, placement, run_device)
    if placement != ALL_FAST:
        if not spec.supports_placement:
            raise ValueError(
                f"backend {spec.name!r} registers no copy ring (run_placed) for "
                f"operands in slow memory ({placement}): put the operands on the "
                "card with place(x, 'fast')")
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
