"""Chunk planning: the paper's Algorithm 4 decision heuristic + binary-search
row partitioner.

Copy-cost model (paper §3.3.1):
  Chunk1 (A,C stationary, stream B):  cost1 = |A| + |C| + |B| * ||P_AC||
  Chunk2 (B stationary, stream A,C):  cost2 = |B| + |A| * ||P_B|| + |C| * (||P_B|| - 1)

Heuristic (Alg. 4): give 75% of fast memory to the operand streamed in the OUTER
loop (stationary), >=25% to the inner streamed operand so compute stays utilized;
prefer whole-residency when an operand set fits; otherwise minimize modeled copy
cost over both loop orders.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.memory_model import MemorySystem
from repro_torch.sparse.csr import CSR, _np


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """Everything the chunk executors need, all host-static."""

    algorithm: str            # "whole_fast" | "knl" | "chunk1" | "chunk2"
    p_ac: tuple               # row boundaries of the A/C partition, len = n_ac + 1
    p_b: tuple                # row boundaries of the B partition,   len = n_b + 1
    copy_bytes: float         # modeled total fast<->slow traffic
    fast_bytes_needed: float  # peak fast-memory footprint

    @property
    def n_ac(self) -> int:
        return len(self.p_ac) - 1

    @property
    def n_b(self) -> int:
        return len(self.p_b) - 1

    def b_ranges(self) -> tuple:
        """(r0s, r1s) of the B partition as int32 arrays — scan per-step inputs."""
        b = np.asarray(self.p_b, np.int32)
        return b[:-1], b[1:]


def row_bytes_csr(m: CSR, value_bytes: int = 8, index_bytes: int = 4) -> np.ndarray:
    """Per-row byte footprint (values + column indices; indptr amortized)."""
    ptr = _np(m.indptr)
    lens = ptr[1:] - ptr[:-1]
    return lens * (value_bytes + index_bytes)


def binary_search_partition(row_bytes: np.ndarray, target_bytes: float) -> tuple:
    """Paper's BinarySearch: split rows into contiguous chunks each <= target bytes.

    Uses searchsorted over the prefix-sum (true binary search, O(p log n)). A single
    row larger than the target gets its own chunk (cannot split a row).
    """
    n = int(row_bytes.size)
    if n == 0:
        return (0,)
    prefix = np.concatenate([[0.0], np.cumsum(row_bytes, dtype=np.float64)])
    bounds = [0]
    while bounds[-1] < n:
        lo = bounds[-1]
        # furthest row end with cumulative bytes <= prefix[lo] + target
        hi = int(np.searchsorted(prefix, prefix[lo] + target_bytes, side="right") - 1)
        hi = max(hi, lo + 1)  # always make progress (oversized single row)
        bounds.append(min(hi, n))
    return tuple(bounds)


def partition_cost(bytes_a: float, bytes_b: float, bytes_c: float,
                   n_ac: int, n_b: int, algorithm: str) -> float:
    """The paper's copy-cost formulas."""
    if algorithm == "chunk1":
        return bytes_a + bytes_c + bytes_b * n_ac
    if algorithm == "chunk2":
        return bytes_b + bytes_a * n_b + bytes_c * max(n_b - 1, 0)
    raise ValueError(algorithm)


def staged_row_bytes(row_bytes: np.ndarray, bounds: tuple,
                     index_bytes: int = 4) -> float:
    """Padded-envelope fast footprint of one staged piece of a row partition,
    in the planner's per-row byte units.

    The executors pad every piece to the largest piece's capacity and row
    count, so what fast memory holds is ``max_rows`` row pointers plus the
    byte envelope ``max_piece_bytes`` — the partition-level analogue of
    :func:`staged_chunk_bytes` for operands the planner only knows as a
    per-row byte vector (the symbolic C estimate)."""
    rb = np.asarray(row_bytes, np.float64)
    cap = max(float(rb[s:e].sum()) for s, e in zip(bounds[:-1], bounds[1:]))
    rows = max(e - s for s, e in zip(bounds[:-1], bounds[1:]))
    return float((rows + 1) * index_bytes) + max(cap, 1.0)


def plan_chunks(A: CSR, B: CSR, c_row_bytes: np.ndarray, system: MemorySystem,
                fast_limit_bytes: float | None = None,
                big_portion: float = 0.75) -> ChunkPlan:
    """Algorithm 4. ``c_row_bytes`` is the symbolic-phase estimate of C's per-row
    footprint (A and C are always co-partitioned: same row boundaries).

    ``fast_bytes_needed`` models the *staged* peak footprint the executors
    actually allocate: resident operands at their full size plus the padded
    envelope of every streamed piece (every chunk/strip is padded to the
    largest one's rows and capacity). Modeling the streamed term as the
    densest single row — the pre-fix behavior — undercounts whenever the row
    distribution is skewed, exactly the staging overhead Nagasaka & Azad
    (1804.01698) flag on KNL."""
    fast = float(fast_limit_bytes or system.fast.capacity_bytes)
    small_portion = 1.0 - big_portion
    a_rows = row_bytes_csr(A)
    b_rows = row_bytes_csr(B)
    c_rows = np.asarray(c_row_bytes, np.float64)
    ac_rows = a_rows + c_rows
    size_a, size_b, size_c = float(a_rows.sum()), float(b_rows.sum()), float(c_rows.sum())

    whole = size_a + size_b + size_c
    if whole <= fast:
        return ChunkPlan("whole_fast", (0, A.n_rows), (0, B.n_rows),
                         copy_bytes=whole, fast_bytes_needed=whole)

    def staged_ac(p_ac: tuple) -> float:
        # the executors stage the padded A strip and the C partial separately
        return staged_chunk_bytes(A, p_ac) + staged_row_bytes(c_rows, p_ac)

    if size_b <= big_portion * fast:
        # B resident; stream A, C through the leftover (paper: "Add left over from
        # big to small portion").
        leftover = fast - size_b
        p_ac = binary_search_partition(ac_rows, leftover)
        return ChunkPlan("chunk2", p_ac, (0, B.n_rows),
                         copy_bytes=partition_cost(size_a, size_b, size_c,
                                                   len(p_ac) - 1, 1, "chunk2"),
                         fast_bytes_needed=size_b + staged_ac(p_ac))

    if size_a + size_c <= big_portion * fast:
        leftover = fast - (size_a + size_c)
        p_b = binary_search_partition(b_rows, leftover)
        return ChunkPlan("chunk1", (0, A.n_rows), p_b,
                         copy_bytes=partition_cost(size_a, size_b, size_c,
                                                   1, len(p_b) - 1, "chunk1"),
                         fast_bytes_needed=size_a + size_c
                         + staged_chunk_bytes(B, p_b))

    # Neither fits: 2-D chunking. Give the big portion to the costlier operand set
    # (paper: "if size(A) + 2*size(C) > size(B)" -> A,C get the big portion).
    if size_a + 2.0 * size_c > size_b:
        p_ac = binary_search_partition(ac_rows, big_portion * fast)
        p_b = binary_search_partition(b_rows, small_portion * fast)
    else:
        p_b = binary_search_partition(b_rows, big_portion * fast)
        p_ac = binary_search_partition(ac_rows, small_portion * fast)
    n_ac, n_b = len(p_ac) - 1, len(p_b) - 1
    cost1 = partition_cost(size_a, size_b, size_c, n_ac, n_b, "chunk1")
    cost2 = partition_cost(size_a, size_b, size_c, n_ac, n_b, "chunk2")
    algorithm = "chunk1" if cost1 <= cost2 else "chunk2"
    # peak staged footprint is one padded A strip + C partial + one padded B
    # chunk resident together, in either streaming order — the actual
    # requirement, not the limit the partitions were searched against
    return ChunkPlan(algorithm, p_ac, p_b,
                     copy_bytes=min(cost1, cost2),
                     fast_bytes_needed=staged_ac(p_ac)
                     + staged_chunk_bytes(B, p_b))


def staged_chunk_bytes(m: CSR, bounds: tuple, value_bytes: int = 8,
                       index_bytes: int = 4) -> float:
    """Modeled fast-memory footprint of one *staged* chunk of a row partition.

    The executors pad every chunk to the largest chunk's nnz and row count
    (static shapes), so what fast memory must hold is the padded envelope —
    ``cap`` entries plus the padded row pointers — not the unpadded bytes of
    whichever chunk is resident. Summing unpadded per-chunk bytes undercounts
    exactly when the row distribution is skewed."""
    ptr = _np(m.indptr)
    lens = ptr[1:] - ptr[:-1]
    cap = max(int(lens[s:e].sum()) for s, e in zip(bounds[:-1], bounds[1:]))
    rows = max(e - s for s, e in zip(bounds[:-1], bounds[1:]))
    return float((rows + 1) * index_bytes
                 + max(cap, 1) * (value_bytes + index_bytes))


# ---------------------------------------------------------------------------
# backend fast-memory models: what each executor actually keeps resident
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BackendFastModel:
    """Peak resident fast-memory footprint of one streaming backend
    under a plan + envelope: both double-buffer slots of the streamed
    operand, the stationary operand's staged block, the persistent C
    accumulator (all ``n_ac`` strips for the Chunk2 order, whose partials
    stay in fast memory), and the backend's per-step compute workspace.

    The models are the JAX package's, kept equal so that ``backend="auto"``
    chooses what the reference chooses; they price the reference's staging
    (two-slot streaming through a fast scratch), not the CUDA kernels'
    shared-memory use.

    This is deliberately *not* :class:`ChunkPlan.fast_bytes_needed` (the
    paper-level staged model the planner searches partitions against): it is
    the backend-specific answer to "does this plan's strip sizing actually
    fit the fast memory", which for the dense-slab backend is bounded
    by ``strip_rows * n_cols`` and for the sparse-output backend by the
    symbolic phase's ``nnz(C)`` caps — the reason plans can admit larger
    strips when C is sparse.
    """

    backend: str                 # "pallas" (dense slab) | "sparse" (CSR)
    fast_bytes_needed: float     # peak resident footprint, bytes
    streamed_bytes: float        # one streamed element (held x2: double buffer)
    stationary_bytes: float      # stationary operand's staged block
    c_accum_bytes: float         # persistent accumulator block(s)
    workspace_bytes: float       # per-step compute scratch (ESC expansion)


def _csr_staged_bytes(rows: int, nnz_cap: int, itemsize: int) -> float:
    """Padded CSR triple footprint: row pointers + (index, value) per slot."""
    return float((rows + 1) * 4 + max(nnz_cap, 1) * (4 + itemsize))


def csr_field_nbytes(rows: int, nnz_cap: int, itemsize: int) -> tuple:
    """Per-field ``(indptr, indices, data)`` byte sizes of one staged padded
    CSR triple, whose sum is exactly the staged ``CSR.nbytes()``. Unlike
    :func:`_csr_staged_bytes` (the planner's model, floored at one slot) a
    zero-capacity piece moves zero bytes for its index and data fields."""
    return (float((rows + 1) * 4), float(nnz_cap * 4),
            float(nnz_cap * itemsize))


def planned_stats_dense_slab(plan: ChunkPlan, envelope) -> BackendFastModel:
    """The dense-accumulator (``backend="pallas"``) resident footprint: the
    streamed/stationary pieces are dense f32 slabs and the C accumulator is a
    dense ``[strip_rows, n_cols]`` block per resident strip."""
    k, n = envelope.a_shape[1], envelope.b_shape[1]
    span, strip_rows = envelope.chunk_rows, envelope.strip_rows
    slab = float(span * n * 4)                       # streamed B chunk
    a_stage = float(strip_rows * (k + span) * 4)     # column-padded A strip
    c_block = float(strip_rows * n * 4)
    if plan.algorithm == "chunk2":
        streamed, stationary = a_stage, slab
        c_accum = plan.n_ac * c_block                # all partials persist
    else:                                            # knl / chunk1
        streamed, stationary = slab, a_stage
        c_accum = c_block
    return BackendFastModel(
        backend="pallas",
        fast_bytes_needed=2 * streamed + stationary + c_accum,
        streamed_bytes=streamed, stationary_bytes=stationary,
        c_accum_bytes=c_accum, workspace_bytes=0.0,
    )


def _csr_accum_model(plan: ChunkPlan, envelope, backend: str,
                     workspace: float) -> BackendFastModel:
    """Shared resident-footprint shape of the CSR-scratch accumulators (ESC
    and hash): staged pieces are padded CSR triples, the C accumulator is
    the fixed-capacity scratch at the symbolic ``c_pad`` (all ``n_ac``
    strips resident in the Chunk2 order), and only the per-step
    ``workspace`` term differs between the backends. One definition, so the
    models ``select_accumulator_backend`` compares cannot drift apart."""
    itemsize = int(np.dtype(envelope.dtype).itemsize)
    chunk_csr = _csr_staged_bytes(envelope.chunk_rows, envelope.chunk_nnz_cap,
                                  itemsize)
    strip_csr = _csr_staged_bytes(envelope.strip_rows, envelope.strip_nnz_cap,
                                  itemsize)
    c_csr = _csr_staged_bytes(envelope.strip_rows, envelope.c_pad, itemsize)
    if plan.algorithm == "chunk2":
        streamed, stationary = strip_csr, chunk_csr
        c_accum = plan.n_ac * c_csr
    else:                                            # knl / chunk1
        streamed, stationary = chunk_csr, strip_csr
        c_accum = c_csr
    return BackendFastModel(
        backend=backend,
        fast_bytes_needed=2 * streamed + stationary + c_accum + workspace,
        streamed_bytes=streamed, stationary_bytes=stationary,
        c_accum_bytes=c_accum, workspace_bytes=workspace,
    )


def planned_stats_sparse(plan: ChunkPlan, envelope) -> BackendFastModel:
    """The sparse-output (``backend="sparse"``) resident footprint: every
    staged piece is a padded CSR triple and the C accumulator is the
    fixed-capacity CSR scratch at the symbolic ``c_pad`` — so the model
    scales with the envelope's nnz caps, never with ``n_cols``. The ESC
    workspace term is the expand-sort-compress product buffer
    (``strip_nnz_cap * b_max_row_nnz + c_pad`` slots of row, column, value),
    the price of compressed accumulation against the dense slab and the
    hash tables."""
    itemsize = int(np.dtype(envelope.dtype).itemsize)
    esc_slots = (max(envelope.strip_nnz_cap, 1)
                 * max(envelope.b_max_row_nnz, 1) + envelope.c_pad)
    workspace = float(esc_slots * (4 + 4 + itemsize))
    return _csr_accum_model(plan, envelope, "sparse", workspace)


def hash_table_slots(c_max_row_nnz: int) -> int:
    """Per-row hash-table capacity of the hash-probe backend: the smallest
    power of two holding the densest C row. Power-of-two so the probe wrap is
    a mask (``slot & (T - 1)``); >= ``c_max_row_nnz`` so — the symbolic bound
    being exact — insertion can never fail to find its key or a free slot.

    The single source of truth: the kernel (``kernels/hash_accum_spgemm``),
    the byte model (:func:`planned_stats_hash`) and the executors all size
    the table through this function, so the planner's workspace term is the
    table the kernel actually allocates."""
    v = max(int(c_max_row_nnz), 1)
    return 1 << (v - 1).bit_length()


def planned_stats_hash(plan: ChunkPlan, envelope) -> BackendFastModel:
    """The hash-probe (``backend="hash"``) resident footprint: staged CSR
    triples and the CSR accumulator scratch exactly as in
    :func:`planned_stats_sparse` — the two backends share the streaming
    schedule — but the per-step workspace is the per-row hash table
    (``strip_rows x hash_table_slots(c_max_row_nnz)`` key/value pairs,
    Nagasaka & Azad's compressed accumulator) instead of the ESC
    expand-sort-compress buffer. The workspace therefore scales with the
    densest *output* row, not with ``strip_nnz_cap * b_max_row_nnz`` — the
    term that erodes the ESC backend's fast-memory win as outputs densify."""
    itemsize = int(np.dtype(envelope.dtype).itemsize)
    # c_max_row_nnz == 0 is *exact* (empty output, 1-slot tables) whenever
    # the symbolic phase ran, which c_nnz_cap witnesses (its rounding floor
    # makes it nonzero when computed); only a legacy both-zero envelope
    # falls back to the always-valid n_cols bound — keeping this model equal
    # to the table the executors actually allocate
    slots = hash_table_slots(
        envelope.c_max_row_nnz if envelope.c_nnz_cap else envelope.b_shape[1])
    workspace = float(envelope.strip_rows * slots * (4 + itemsize))
    return _csr_accum_model(plan, envelope, "hash", workspace)


def planned_stats_bsr(plan: ChunkPlan, envelope) -> BackendFastModel:
    """The BSR (``backend="bsr"``) resident footprint: every staged piece is
    a padded BSR triple — block pointers + block-column indices + dense
    ``bs x bs`` f32 tiles, plus the appended zero-sentinel block — sized by
    the envelope's block caps (``repro_torch.core.symbolic.bsr_plan_caps``),
    and the C accumulator holds ``nc_cap`` output tiles. The workspace term
    is the slot tables (``2 x nc x u`` int32) plus one ``bs x bs`` f32
    accumulator tile.

    An envelope without block caps (the default — block analysis is opt-in)
    prices at infinity, which removes ``bsr`` from that ``auto`` resolve
    without special-casing the dispatch."""
    if not envelope.bsr_caps:
        inf = float("inf")
        return BackendFastModel(backend="bsr", fast_bytes_needed=inf,
                                streamed_bytes=inf, stationary_bytes=inf,
                                c_accum_bytes=inf, workspace_bytes=inf)
    bs, nbl_a, nbl_b, nc, u = envelope.bsr_caps
    block_bytes = bs * bs * 4                        # staged tiles are f32
    k = envelope.a_shape[1]
    srb = -(-envelope.strip_rows // bs)              # strip block rows
    kb = -(-k // bs)                                 # contraction block rows
    # BSR triple + appended zero-sentinel block (the slot tables' padding target)
    slab = float((kb + 1) * 4 + nbl_b * (4 + block_bytes) + block_bytes)
    a_stage = float((srb + 1) * 4 + nbl_a * (4 + block_bytes) + block_bytes)
    c_block = float(nc * block_bytes)
    if plan.algorithm == "chunk2":
        streamed, stationary = a_stage, slab
        c_accum = plan.n_ac * c_block
    else:                                            # knl / chunk1
        streamed, stationary = slab, a_stage
        c_accum = c_block
    workspace = float(2 * nc * u * 4 + block_bytes)
    return BackendFastModel(
        backend="bsr",
        fast_bytes_needed=2 * streamed + stationary + c_accum + workspace,
        streamed_bytes=streamed, stationary_bytes=stationary,
        c_accum_bytes=c_accum, workspace_bytes=workspace,
    )


def accumulator_backends() -> tuple:
    """Deterministic evaluation (and tie-break) order of the auto dispatch:
    the registry's accumulator specs in registration order."""
    from repro_torch.core import backend_registry

    return tuple(s.name for s in backend_registry.accumulator_specs())


def backend_fast_models(plan: ChunkPlan, envelope) -> dict:
    """Every registered accumulator's byte model under one plan + envelope,
    in the registry's priority order."""
    from repro_torch.core import backend_registry

    return {s.name: s.byte_model(plan, envelope)
            for s in backend_registry.accumulator_specs()}


def select_accumulator_backend(plan: ChunkPlan, envelope) -> str:
    """The ``backend="auto"`` rule: run the accumulator whose modeled peak
    resident fast-memory footprint is smallest under this plan + envelope —
    dense slab (``pallas``) vs ESC CSR scratch (``sparse``) vs hash probe
    (``hash``) vs blocked tiles (``bsr``, only under block-capped envelopes —
    uncapped ones price it at infinity). Ties break toward the earlier
    registry entry (dense slab first), as in the reference."""
    models = backend_fast_models(plan, envelope)
    return min(models, key=lambda b: models[b].fast_bytes_needed)


def check_output_caps(strip_nnz, c_max_row_nnz: int, c_pad: int,
                      row_cap: int | None, *, backend: str, a_shape: tuple,
                      b_shape: tuple, instance: int | None = None) -> None:
    """Fail loudly when a realized output structure exceeds the capacities a
    sparse-output kernel was sized with.

    The ESC and hash kernels silently *drop or misplace* entries past their
    fixed capacities (the scatter's overflow bucket, a full hash table), so
    an under-capped launch must be a planner-level :class:`ValueError` naming
    the offending geometry, not wrong values. ``strip_nnz``/``c_max_row_nnz``
    are the exact realized structure (symbolic phase); ``c_pad`` is the CSR
    scratch capacity and ``row_cap`` (hash only, ``None`` otherwise) the
    per-row hash-table slot count."""
    where = (f"batch instance {instance} of " if instance is not None else "")
    geom = f"{where}A{a_shape} x B{b_shape}"
    worst = max(strip_nnz) if strip_nnz else 0
    if worst > c_pad:
        raise ValueError(
            f"backend={backend!r}: realized strip output nnz {worst} exceeds "
            f"the accumulator capacity c_pad={c_pad} for {geom}; the kernel "
            f"would silently drop entries — raise c_pad (the symbolic default "
            f"from strip_output_caps is always sufficient)"
        )
    if row_cap is not None and c_max_row_nnz > row_cap:
        raise ValueError(
            f"backend={backend!r}: densest realized C row "
            f"({c_max_row_nnz} nnz) exceeds the hash-table capacity "
            f"{row_cap} slots for {geom}; insertion would overflow — size "
            f"the table from the exact symbolic c_max_row_nnz"
        )


def plan_knl(A: CSR, B: CSR, fast_limit_bytes: float,
             system: MemorySystem | None = None) -> ChunkPlan:
    """Algorithm 1 planning: np = ceil(size(B)/FastSize), equal-byte row partition of
    B via binary search. A and C stay in slow memory (never copied)."""
    del system   # accepted for signature parity with plan_chunks; sizing is byte-only
    b_rows = row_bytes_csr(B)
    size_b = float(b_rows.sum())
    n_p = max(1, int(np.ceil(size_b / fast_limit_bytes)))
    p_size = size_b / n_p
    p_b = binary_search_partition(b_rows, p_size)
    return ChunkPlan("knl", (0, A.n_rows), p_b, copy_bytes=size_b,
                     fast_bytes_needed=staged_chunk_bytes(B, p_b))


# ---------------------------------------------------------------------------
# two-hop pipeline planning: resident intermediate vs spill-to-slow
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PipelinePlan:
    """Plan for the fused triple product ``C = R x (A x P)``: one
    :class:`ChunkPlan` per hop plus the resident-intermediate decision.

    ``t_resident=True`` means the intermediate ``T = A x P`` stays staged in
    fast memory between the hops — its CSR triple (``t_bytes``) is budgeted
    on top of each hop's own staged peak, and the modeled copy cost drops
    the slow-memory round trip. Otherwise T round-trips through slow memory
    exactly as two independent products would."""

    plan1: ChunkPlan          # hop 1: T = A x P
    plan2: ChunkPlan          # hop 2: C = R x T
    t_resident: bool          # T's CSR triple stays in fast between hops
    t_bytes: float            # staged footprint of the full intermediate
    copy_bytes: float         # modeled fast<->slow traffic for both hops
    fast_bytes_needed: float  # peak staged footprint across both hops


def plan_pipeline(A: CSR, P: CSR, R: CSR, system: MemorySystem,
                  fast_limit_bytes: float | None = None,
                  big_portion: float = 0.75,
                  t_pattern: CSR | None = None) -> PipelinePlan:
    """Plan both hops of ``C = R x (A x P)`` and budget fast memory for the
    resident intermediate.

    Hop 1 is planned with T's exact per-row bytes as the C estimate, hop 2
    against C's exact structure. T stays resident iff both hops' staged
    peaks still fit the fast limit with the whole intermediate held beside
    them and the saved round trip beats the tighter partitions' extra
    streaming; otherwise the plan records the spill."""
    from repro_torch.core.symbolic import spgemm_pattern_host

    if t_pattern is None:
        t_pattern = spgemm_pattern_host(A, P)
    fast = float(fast_limit_bytes or system.fast.capacity_bytes)
    crb1 = row_bytes_csr(t_pattern)
    c_pattern = spgemm_pattern_host(R, t_pattern)
    crb2 = row_bytes_csr(c_pattern)
    t_nnz = int(_np(t_pattern.indptr)[-1])
    t_bytes = _csr_staged_bytes(t_pattern.n_rows, t_nnz, 8)

    def plan_hops(limit: float) -> tuple:
        p1 = plan_chunks(A, P, crb1, system, fast_limit_bytes=limit,
                         big_portion=big_portion)
        p2 = plan_chunks(R, t_pattern, crb2, system, fast_limit_bytes=limit,
                         big_portion=big_portion)
        return p1, p2

    # T's slow-memory round trip: hop 1 writes it once; hop 2's streamed-B
    # reads repeat per A/C strip pass in the chunk1 order, once otherwise.
    size_t = float(crb1.sum())

    def pipeline_copy(p1: ChunkPlan, p2: ChunkPlan, resident: bool) -> float:
        copy = p1.copy_bytes + p2.copy_bytes
        if resident:
            t_reads = p2.n_ac if p2.algorithm == "chunk1" else 1
            copy -= size_t * (1 + t_reads)
        return max(copy, 0.0)

    # reserve T's staged triple off the top and search both hops' partitions
    # against the remainder, backing the search limit off geometrically when
    # staged padding pushes a realized peak past the reservation
    resident_plans = None
    reserve = fast - t_bytes
    if reserve > 0:
        limit = reserve
        for _ in range(6):
            p1, p2 = plan_hops(limit)
            if (p1.fast_bytes_needed + t_bytes <= fast
                    and p2.fast_bytes_needed + t_bytes <= fast):
                resident_plans = (p1, p2)
                break
            limit *= 0.85
    spill_plans = plan_hops(fast)
    spill_copy = pipeline_copy(*spill_plans, resident=False)
    if resident_plans is not None:
        resident_copy = pipeline_copy(*resident_plans, resident=True)
        if resident_copy <= spill_copy:
            plan1, plan2 = resident_plans
            return PipelinePlan(
                plan1=plan1, plan2=plan2, t_resident=True, t_bytes=t_bytes,
                copy_bytes=resident_copy,
                fast_bytes_needed=max(plan1.fast_bytes_needed,
                                      plan2.fast_bytes_needed) + t_bytes)
    plan1, plan2 = spill_plans
    return PipelinePlan(
        plan1=plan1, plan2=plan2, t_resident=False, t_bytes=t_bytes,
        copy_bytes=spill_copy,
        fast_bytes_needed=max(plan1.fast_bytes_needed,
                              plan2.fast_bytes_needed))
