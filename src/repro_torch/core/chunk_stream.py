"""Streaming chunk executors behind the backend registry.

The paper's three chunk orders (KNL / Chunk1 / Chunk2) admit several numeric
backends. This module implements their executors and registers each with
``repro_torch.core.backend_registry`` (registrations at the bottom); the
dispatcher ``chunked_spgemm`` and the planner's ``backend="auto"`` resolve
derive their backend set from the registry.

The registered backends, in registry (= auto tie-break) order:

* ``loop`` — the host-driven Python loop of ``repro_torch.core.chunking``;
  the oracle.
* ``scan`` — the same three algorithms over the uniformly padded, stacked
  strips and chunks (``csr_stack``): a loop on the device over
  ``spgemm_ranged_impl``, with no Python-side staging between steps. No
  kernel of its own, as in the reference.
* ``pallas`` — the dense-slab accumulator: strips and chunks densified into
  ``[strip_rows, k + span]`` and ``[span, n]`` slabs and multiplied by the
  CUDA kernel ``repro_torch.kernels.ranged_spgemm`` (named after the
  reference's backend, whose kernel was Pallas).
* ``sparse`` — the CSR-output accumulator with the ESC merge
  (``repro_torch.kernels.sparse_accum_spgemm``), a fixed-capacity CSR
  scratch sized by the symbolic phase, so the footprint scales with
  ``nnz(C)``, not ``strip_rows * n_cols``.
* ``hash`` — the same with per-row linear-probing hash tables sized by the
  symbolic ``c_max_row_nnz`` (``repro_torch.kernels.hash_accum_spgemm``).
  It also registers ``run_masked`` (:func:`chunk_hash_masked`): the
  mask-fused product ``(A x B) ∘ M`` of triangle counting, and its placed
  entry ``run_masked_placed``.
* ``bsr`` — blocked tiles: every (strip, chunk) pair staged as BSR straight
  from the CSR operands and multiplied by the CUDA kernel
  ``repro_torch.kernels.bsr_spgemm``; opt-in under ``auto`` through
  ``block_size`` (uncapped envelopes price it at infinity).

``backend="auto"`` argmins the accumulators' ``BackendFastModel`` byte
models (``planner.select_accumulator_backend``).

Every backend also registers ``run_placed``: its executor with operands in
slow memory (pinned host memory on the card), each slow piece crossing onto
the card through the copy ring (``repro_torch.core.copy_ring``) before a
launch reads it, one launch a (strip, chunk) step, C equal bit for bit to
the all-fast call's. The streaming kernels' backends (``pallas``,
``sparse``, ``hash``, and the masked hash executor) also register
``run_in_place`` (and, but for the masked one, ``run_batched_in_place``):
each slow operand's stacks built in pinned memory and read in place by the
backend's kernel, one launch a strip of the plan, as the reference's
``memory_space=ANY`` operands are (``chunked_spgemm(...,
slow_reads="in_place")``).

Every backend but ``loop`` runs its kernel calls through *cores*
(:class:`_Core`), and its compile accounting is observable through
``TRACE_COUNTS`` under the spec's ``trace_key``/``trace_key_batched``
templates (``"{alg}"``, ``"{alg}_hash_batched"``, ...). The port has no
tracer: a core's first call at a static geometry (operand shapes and
dtypes, CSR metadata, static arguments: what the reference's jit keys a
trace on) counts once, and later calls at it count nothing.

:func:`chunked_spgemm_batched` runs a backend's batched entry over problem
instances sharing one plan: the many-small-matrices serving scenario.
Batches may mix sparsity structures: every instance is repadded to a shared
``GeometryEnvelope`` (the batch union, or a caller-provided bucket
envelope) before stacking, and the whole batch goes through one kernel call
with the width as its leading axis (``pallas``, ``sparse``, ``hash``) or
folded into the blocks of one launch per (strip, chunk) pair (``bsr``).
With operands in slow memory (``run_batched_placed``) a slow operand's
envelope-padded stacks are built in pinned memory and the copy ring moves
one (strip, chunk) step's pieces of the whole batch at a time, one launch a
step for every instance. ``repro_torch.serve.spgemm_service`` builds the
request-bucketing service on top.

ChunkStats for these backends is *computed from the plan*: the uniform
padding makes every staged chunk/strip/partial the same size, so the
per-copy event sequence is reproducible host-side. ``planned_stats`` replays
the loop executors' CSR-staging events; ``planned_stats_pallas`` replays the
streaming kernels' events (dense slabs for ``pallas``, padded CSR triples for
``sparse``/``hash``; Chunk2's C partials stay resident instead of bouncing to
slow memory).
"""

from __future__ import annotations

import collections
import dataclasses
from functools import partial

import numpy as np
import torch

from repro_torch.core import backend_registry, copy_ring
from repro_torch.core.chunking import (
    SLOW_READS, _assemble, _c_strip_nbytes, _empty_like_c, _stats_of, _step_elements,
    a_strips, b_chunks, batch_envelope, chunk_loop, in_place_refusal, instance_envelope,
    planned_stats, run_ranged,
)
from repro_torch.core.kkmem import spgemm_ranged_impl
from repro_torch.core.planner import (
    ChunkPlan, check_output_caps, csr_field_nbytes, hash_table_slots, planned_stats_bsr,
    planned_stats_dense_slab, planned_stats_hash, planned_stats_sparse,
    select_accumulator_backend,
)
from repro_torch.core.symbolic import masked_output_caps, strip_output_caps
from repro_torch.kernels.bsr_spgemm import bsr_spgemm_blocks, bsr_spgemm_symbolic
from repro_torch.kernels.hash_accum_spgemm import (
    hash_accum_spgemm_stream, hash_masked_accum_spgemm_stream,
)
from repro_torch.kernels.ranged_spgemm import ranged_spgemm_stream
from repro_torch.kernels.sparse_accum_spgemm import sparse_accum_spgemm_stream
from repro_torch.sparse.bsr import BSR, bsr_blocks_with_sentinel
from repro_torch.sparse.csr import (
    CSR, GeometryEnvelope, _csr_from_tensors, csr_from_dense, csr_pad_to, csr_pin,
    csr_stack, csr_unstack,
)

# One count under a core's key each time the core meets a static geometry it
# has not run before: the port's trace (see :class:`_Core`).
TRACE_COUNTS: collections.Counter = collections.Counter()


def _signature(value):
    """The static geometry of one core operand: a CSR's (stacked) field
    shapes, dtype, shape and ``max_row_nnz``; a tensor's or array's shape
    and dtype; a list's or tuple's items; anything else as it is."""
    if isinstance(value, CSR):
        return ("csr", tuple(value.indptr.shape), tuple(value.indices.shape),
                str(value.dtype), value.shape, value.max_row_nnz)
    if isinstance(value, (torch.Tensor, np.ndarray)):
        return (tuple(value.shape), str(value.dtype))
    if isinstance(value, (list, tuple)):
        return tuple(_signature(v) for v in value)
    return value


class _Core:
    """One executor core: ``run`` behind the record of the static geometries
    it has met (the operands' :func:`_signature` and the keyword statics).

    The reference jits its cores, and a jit traces once per static
    geometry. The port runs eagerly and builds its kernel libraries once a
    process (``kernels._build``), so the trace a core stands for is its
    first call at a geometry: that call counts once under ``key`` in
    :data:`TRACE_COUNTS`. A set of cores from a spec's
    ``make_batched_cores`` starts with an empty record, so its owner (a
    serving bucket) counts its own geometries, and drops them with it."""

    def __init__(self, key: str, run, counts: collections.Counter | None = None):
        self.key, self._run, self._seen = key, run, set()
        self.counts = TRACE_COUNTS if counts is None else counts

    @staticmethod
    def geometry(*operands, **statics) -> tuple:
        """The static geometry a call is keyed on: the operands'
        :func:`_signature` and the sorted keyword statics."""
        return _signature(operands), tuple(sorted(statics.items()))

    def fresh(self, counts: collections.Counter) -> "_Core":
        """The same core with an empty record, counting into ``counts``."""
        return _Core(self.key, self._run, counts)

    def __call__(self, *operands, **statics):
        geometry = self.geometry(*operands, **statics)
        if geometry not in self._seen:
            self._seen.add(geometry)
            self.counts[self.key] += 1
        return self._run(*operands, **statics)


def _core_set(template: str, runs: dict) -> dict:
    """A fresh core per algorithm, counted under ``template`` of it."""
    return {alg: _Core(template.format(alg=alg), run) for alg, run in runs.items()}


def _batched_core_factory(template: str, runs: dict):
    """A spec's ``make_batched_cores``: each call a fresh set of the batched
    cores (the module-level set's keys, an empty record). ``donate`` is the
    reference's flag for donating the C accumulator stacks; the port stages
    them fresh every call and its outputs are fresh allocations, so there is
    nothing to donate."""

    def make_batched_cores(donate: bool = False) -> dict:
        del donate
        return _core_set(template, runs)

    return make_batched_cores


# ---------------------------------------------------------------------------
# plan-derived copy accounting
# ---------------------------------------------------------------------------


def planned_events(plan: ChunkPlan, slab_nbytes: int, a_stage_nbytes: int,
                   c_stage_nbytes: int) -> list:
    """The streaming kernels' copy events from the plan, each tagged with
    its operand: ``[(operand, "in" | "out", bytes), ...]`` in issue order.

    Staged pieces are the kernel's own (dense slabs for ``pallas``, padded
    CSR triples for the CSR accumulators); the stationary operand is staged
    once per outer step and the streamed one once per step; and in the
    Chunk2 order the per-strip C partials stay resident, so the ``(n_b -
    1)`` per-strip out+in bounces collapse into one whole-block ``C_prev``
    fetch and one final writeback of ``n_ac * c_stage_nbytes`` each. A run
    with slow operands moves exactly the events of those operands across
    the link (``repro_torch.core.copy_ring``).
    """
    events = []
    if plan.algorithm in ("knl", "chunk1"):
        for _ in range(plan.n_ac):           # knl is the 1-strip special case
            events.append(("A", "in", a_stage_nbytes))     # stationary strip
            events.append(("C", "in", c_stage_nbytes))     # fused C_prev block
            events.extend([("B", "in", slab_nbytes)] * plan.n_b)   # streamed chunks
            events.append(("C", "out", c_stage_nbytes))    # strip result writeback
        return events
    if plan.algorithm == "chunk2":
        for jb in range(plan.n_b):
            events.append(("B", "in", slab_nbytes))        # stationary chunk
            if jb == 0:
                events.append(("C", "in", plan.n_ac * c_stage_nbytes))
            events.extend([("A", "in", a_stage_nbytes)] * plan.n_ac)   # streamed strips
        events.append(("C", "out", plan.n_ac * c_stage_nbytes))
        return events
    raise ValueError(f"unknown algorithm {plan.algorithm!r}")


def planned_stats_pallas(plan: ChunkPlan, slab_nbytes: int, a_stage_nbytes: int,
                         c_stage_nbytes: int):
    """The :class:`ChunkStats` of :func:`planned_events`: the streaming
    kernels' per-copy event sequence, replayed from the plan."""
    return _stats_of(plan, planned_events(plan, slab_nbytes, a_stage_nbytes,
                                          c_stage_nbytes))


def planned_events_masked(plan: ChunkPlan, slab_nbytes: int, a_stage_nbytes: int,
                          c_stage_nbytes: int, m_struct_nbytes: int) -> list:
    """The masked kernel's copy events, each tagged with its operand:
    :func:`planned_events`, with the mask's structure (operand ``"M"``: a
    strip's indptr and indices, ``m_struct_nbytes``) coming in beside every
    C_prev block: one a strip in the chunk1 orders, the whole block in
    Chunk2. These are the events :func:`stage_hash_masked` adds to the
    ChunkStats (there appended after the kernel's own)."""
    whole = plan.n_ac if plan.algorithm == "chunk2" else 1
    events = []
    for event in planned_events(plan, slab_nbytes, a_stage_nbytes, c_stage_nbytes):
        events.append(event)
        if event[:2] == ("C", "in"):
            events.append(("M", "in", whole * m_struct_nbytes))
    return events


def planned_events_bsr(plan: ChunkPlan, slab_nbytes: int, a_stage_nbytes: int,
                       c_part_nbytes: int, c_strip_nbytes: int) -> list:
    """The ``bsr`` executor's copy events with operands in slow memory, each
    tagged with its operand. It launches once a (strip, chunk) pair, and a
    pair's A piece is its own (the strip's rows at the chunk's columns), so
    A crosses once a pair in every order; B's chunk is stationary in Chunk2
    and crosses once a pair otherwise. A strip's C is its summed blocks
    (``c_part_nbytes``) while its pairs run and its CSR at ``c_pad``
    (``c_strip_nbytes``) once they end: in the chunk1 orders the strip's
    pairs are summed on the card and its CSR goes out once; in Chunk2 every
    strip's partial goes out after its step and comes back before the next
    chunk's, and its CSR goes out after its last. Its ChunkStats stay the
    idealized pipeline's (:func:`planned_stats_pallas`;
    ``_BSR_STATS_EXEMPT``)."""
    n_b = plan.n_b
    if plan.algorithm == "chunk2":
        events = []
        for jb in range(n_b):
            events.append(("B", "in", slab_nbytes))
            for _ in range(plan.n_ac):
                events.append(("A", "in", a_stage_nbytes))
                if jb > 0:
                    events.append(("C", "in", c_part_nbytes))
                events.append(("C", "out", c_part_nbytes if jb < n_b - 1 else c_strip_nbytes))
        return events
    return ([("A", "in", a_stage_nbytes), ("B", "in", slab_nbytes)] * n_b
            + [("C", "out", c_strip_nbytes)]) * plan.n_ac


def _pallas_stage_nbytes(strip_rows: int, k: int, span: int, n: int) -> tuple:
    """(slab, a_stage, c_stage) dense staged footprints in bytes (f32)."""
    return span * n * 4, strip_rows * (k + span) * 4, strip_rows * n * 4


# ---------------------------------------------------------------------------
# scan backend: a device loop over the stacked pieces
# ---------------------------------------------------------------------------


def _empty_c_stack(n, n_rows: int, n_cols: int, c_pad: int, dtype, device) -> CSR:
    """Stacked empty partials (leading axes ``n``: an int or a tuple) for
    the Chunk2 carry."""
    lead = (n,) if isinstance(n, int) else tuple(n)
    return CSR(
        indptr=torch.zeros(*lead, n_rows + 1, dtype=torch.int32, device=device),
        indices=torch.zeros(*lead, c_pad, dtype=torch.int32, device=device),
        data=torch.zeros(*lead, c_pad, dtype=dtype, device=device),
        shape=(n_rows, n_cols),
        max_row_nnz=0,
    )


def _scan_knl(A: CSR, Bs: CSR, r0s, r1s, C0: CSR, *, c_pad: int) -> CSR:
    """Algorithm 1 over the stacked chunks: C accumulates chunk by chunk."""
    C = C0
    for Bc, r0, r1 in zip(csr_unstack(Bs), r0s.tolist(), r1s.tolist()):
        C = spgemm_ranged_impl(A, Bc, r0, r1, C, c_pad)
    return C


def _scan_chunk1(As: CSR, Bs: CSR, r0s, r1s, C0: CSR, *, c_pad: int) -> list:
    """A/C strips outer (stationary), B chunks inner (streamed); every strip
    starts from the template ``C0``. Returns the per-strip results."""
    chunks = list(zip(csr_unstack(Bs), r0s.tolist(), r1s.tolist()))
    out = []
    for Ai in csr_unstack(As):
        Ci = C0
        for Bc, r0, r1 in chunks:
            Ci = spgemm_ranged_impl(Ai, Bc, r0, r1, Ci, c_pad)
        out.append(Ci)
    return out


def _scan_chunk2(As: CSR, Bs: CSR, r0s, r1s, C0s: CSR, *, c_pad: int) -> list:
    """B chunk outer (stationary), A/C strips inner (streamed); all per-strip
    partials ride along. Returns the per-strip results."""
    As, Cs = csr_unstack(As), csr_unstack(C0s)
    for Bc, r0, r1 in zip(csr_unstack(Bs), r0s.tolist(), r1s.tolist()):
        Cs = [spgemm_ranged_impl(Ai, Bc, r0, r1, Ci, c_pad) for Ai, Ci in zip(As, Cs)]
    return Cs


# the batched cores run the unbatched loop once an instance (the reference
# vmaps it), so same-structure batches equal the unbatched executors bit for
# bit; chunk1 and chunk2 share one C0 across the batch, as the reference's do
def _scan_knl_batched(Ast: CSR, Bst: CSR, r0s, r1s, C0s: CSR, *, c_pad: int) -> list:
    return [_scan_knl(A, Bs, r0s, r1s, C0, c_pad=c_pad)
            for A, Bs, C0 in zip(csr_unstack(Ast), csr_unstack(Bst), csr_unstack(C0s))]


def _scan_chunk1_batched(Ast: CSR, Bst: CSR, r0s, r1s, C0: CSR, *, c_pad: int) -> list:
    return [_scan_chunk1(As, Bs, r0s, r1s, C0, c_pad=c_pad)
            for As, Bs in zip(csr_unstack(Ast), csr_unstack(Bst))]


def _scan_chunk2_batched(Ast: CSR, Bst: CSR, r0s, r1s, C0s: CSR, *, c_pad: int) -> list:
    return [_scan_chunk2(As, Bs, r0s, r1s, C0s, c_pad=c_pad)
            for As, Bs in zip(csr_unstack(Ast), csr_unstack(Bst))]


_SCAN_RUNS = {"knl": _scan_knl, "chunk1": _scan_chunk1, "chunk2": _scan_chunk2}
_SCAN_RUNS_BATCHED = {"knl": _scan_knl_batched, "chunk1": _scan_chunk1_batched,
                      "chunk2": _scan_chunk2_batched}
_SCAN_CORES = _core_set("{alg}", _SCAN_RUNS)
_SCAN_CORES_BATCHED = _core_set("{alg}_batched", _SCAN_RUNS_BATCHED)


def chunk_knl_scan(A: CSR, B: CSR, plan: ChunkPlan, c_pad: int):
    chunks = b_chunks(B, plan.p_b)
    r0s, r1s = plan.b_ranges()
    C0 = _empty_like_c(A.n_rows, B.n_cols, c_pad, A.dtype, A.device)
    C = _SCAN_CORES["knl"](A, csr_stack(chunks), r0s, r1s, C0, c_pad=c_pad)
    return C, planned_stats(plan, chunks[0].nbytes(), 0, 0)


def chunk_gpu1_scan(A: CSR, B: CSR, plan: ChunkPlan, c_pad: int):
    strips = a_strips(A, plan.p_ac)
    chunks = b_chunks(B, plan.p_b)
    r0s, r1s = plan.b_ranges()
    strip_rows = strips[0].n_rows
    C0 = _empty_like_c(strip_rows, B.n_cols, c_pad, A.dtype, A.device)
    out = _SCAN_CORES["chunk1"](csr_stack(strips), csr_stack(chunks), r0s, r1s, C0,
                                c_pad=c_pad)
    stats = planned_stats(plan, chunks[0].nbytes(), strips[0].nbytes(),
                          _c_strip_nbytes(strip_rows, c_pad, A.dtype))
    return _assemble(out, plan.p_ac, B.n_cols), stats


def chunk_gpu2_scan(A: CSR, B: CSR, plan: ChunkPlan, c_pad: int):
    strips = a_strips(A, plan.p_ac)
    chunks = b_chunks(B, plan.p_b)
    r0s, r1s = plan.b_ranges()
    strip_rows = strips[0].n_rows
    C0s = _empty_c_stack(plan.n_ac, strip_rows, B.n_cols, c_pad, A.dtype, A.device)
    out = _SCAN_CORES["chunk2"](csr_stack(strips), csr_stack(chunks), r0s, r1s, C0s,
                                c_pad=c_pad)
    stats = planned_stats(plan, chunks[0].nbytes(), strips[0].nbytes(),
                          _c_strip_nbytes(strip_rows, c_pad, A.dtype))
    return _assemble(out, plan.p_ac, B.n_cols), stats


# ---------------------------------------------------------------------------
# dense-slab backend (kernels/ranged_spgemm)
# ---------------------------------------------------------------------------


def _dense_stack(stacked: CSR, levels: int = 1, pad_cols: int = 0,
                 pin_memory: bool = False) -> torch.Tensor:
    """Densify a CSR with ``levels`` leading stack axes into f32
    ``[..., rows, n_cols + pad_cols]``. The zero ``pad_cols`` columns are the
    reference's ``_pad_cols``, allocated here in the same buffer so the
    ranged column slice of the last chunk stays in bounds without a copy.
    ``pin_memory`` builds a host stack in pinned memory (a slow operand's
    pieces, straight where the copy ring reads them)."""
    lead = tuple(stacked.indptr.shape[:levels])
    n_rows, n_cols = stacked.shape
    ip = stacked.indptr.reshape(-1, n_rows + 1)
    ix = stacked.indices.reshape(ip.shape[0], -1).long()
    d = stacked.data.reshape(ip.shape[0], -1).to(torch.float32)
    dense = torch.zeros(ip.shape[0], n_rows, n_cols + pad_cols,
                        dtype=torch.float32, device=ip.device, pin_memory=pin_memory)
    if n_rows and ip.shape[0]:
        entry = torch.arange(ix.shape[1], dtype=torch.int32,
                             device=ip.device).expand(ip.shape[0], -1).contiguous()
        row = (torch.searchsorted(ip, entry, right=True) - 1).clamp(0, n_rows - 1)
        piece = torch.arange(ip.shape[0], device=ip.device)[:, None].expand_as(row)
        dense.index_put_((piece, row, ix), d, accumulate=True)
    return dense.reshape(*lead, n_rows, n_cols + pad_cols)


def _pallas_assemble(dense, p_ac: tuple) -> CSR:
    """Crop per-strip dense results (a ``[n_ac, rows, n]`` stack or a list) to their true rows, concatenate, and
    sparsify. The dense backend's CSR keeps exactly the nonzeros of the dense
    result, so comparisons against the loop oracle are allclose on densified
    values rather than exact on structure."""
    whole = torch.cat([dense[i][: e - s]
                       for i, (s, e) in enumerate(zip(p_ac[:-1], p_ac[1:]))])
    return csr_from_dense(whole, device=whole.device)


def _make_pallas_run(order: str, *, batched: bool, strips: bool):
    """The staging-and-launch body of one dense-slab core: densify the
    stacked A (a plain CSR for knl, a strip stack, or a per-instance stack of
    either) and B chunks, and run ``ranged_spgemm_stream`` once with the
    batch as its leading axis (width 1 unbatched). Returns dense f32 C:
    ``[(batch,) (n_ac,) rows, n]``."""
    a_levels = int(strips) + int(batched)

    def run(Ast: CSR, Bst: CSR, r0s) -> torch.Tensor:
        span = Bst.n_rows
        a = _dense_stack(Ast, levels=a_levels, pad_cols=span)
        slabs = _dense_stack(Bst, levels=2 if batched else 1)
        if not strips:               # knl: the whole A is the single strip
            a = a[:, None] if batched else a[None]
        if not batched:              # width-1 batch axis
            a, slabs = a[None], slabs[None]
        c0 = torch.zeros(a.shape[:3] + (Bst.n_cols,), dtype=torch.float32, device=a.device)
        out = ranged_spgemm_stream(a, slabs, c0, r0s, order=order)
        if not batched:
            out = out[0]
        if not strips:
            out = out[:, 0] if batched else out[0]
        return out

    return run


def _pallas_runs(batched: bool) -> dict:
    return {alg: _make_pallas_run("chunk2" if alg == "chunk2" else "chunk1",
                                  batched=batched, strips=alg != "knl")
            for alg in backend_registry.ALGORITHMS}


_PALLAS_RUNS_BATCHED = _pallas_runs(True)
_PALLAS_CORES = _core_set("{alg}_pallas", _pallas_runs(False))
_PALLAS_CORES_BATCHED = _core_set("{alg}_pallas_batched", _PALLAS_RUNS_BATCHED)


def _pallas_run(A: CSR, B: CSR, plan: ChunkPlan, strips: bool):
    Bs = csr_stack(b_chunks(B, plan.p_b))
    r0s, _ = plan.b_ranges()
    As = csr_stack(a_strips(A, plan.p_ac)) if strips else A
    out = _PALLAS_CORES[plan.algorithm](As, Bs, r0s)
    stats = planned_stats_pallas(
        plan, *_pallas_stage_nbytes(As.n_rows, A.n_cols, Bs.n_rows, B.n_cols))
    return out, stats


def chunk_knl_pallas(A: CSR, B: CSR, plan: ChunkPlan, c_pad: int):
    del c_pad  # capacity is implicit in the dense accumulator
    out, stats = _pallas_run(A, B, plan, strips=False)
    return csr_from_dense(out, device=out.device), stats


def chunk_gpu1_pallas(A: CSR, B: CSR, plan: ChunkPlan, c_pad: int):
    del c_pad
    out, stats = _pallas_run(A, B, plan, strips=True)
    return _pallas_assemble(out, plan.p_ac), stats


def chunk_gpu2_pallas(A: CSR, B: CSR, plan: ChunkPlan, c_pad: int):
    del c_pad
    out, stats = _pallas_run(A, B, plan, strips=True)
    return _pallas_assemble(out, plan.p_ac), stats


# ---------------------------------------------------------------------------
# CSR-output backends (kernels/sparse_accum_spgemm, kernels/hash_accum_spgemm)
# ---------------------------------------------------------------------------

_CSR_ACCUM_ORDERS = {"knl": "chunk1", "chunk1": "chunk1", "chunk2": "chunk2"}


def _sparse_c0_stack(batch: int, n_ac: int, strip_rows: int, n_cols: int,
                     c_cap: int, dtype, device) -> CSR:
    """Empty stacked C_prev strips ([batch, n_ac] leading axes) at the CSR
    scratch capacity ``c_cap``."""
    return CSR(
        indptr=torch.zeros(batch, n_ac, strip_rows + 1, dtype=torch.int32, device=device),
        indices=torch.zeros(batch, n_ac, c_cap, dtype=torch.int32, device=device),
        data=torch.zeros(batch, n_ac, c_cap, dtype=dtype, device=device),
        shape=(strip_rows, n_cols),
        max_row_nnz=c_cap,
    )


def _make_csr_accum_run(kind: str, order: str):
    """The launch body of one CSR-output core: the ESC kernel with its
    per-row accumulator width ``row_cap``, or the hash kernel with its
    ``table_size``, both static. All staging happens before the call, so
    batched cores share the body: the batch rides the stacks' leading axis."""
    if kind == "hash":
        def run(Ast, Bst, C0st, r0s, r1s, *, table_size: int, device=None):
            return hash_accum_spgemm_stream(Ast, Bst, C0st, r0s, r1s, order=order,
                                            table_size=table_size, device=device)
    else:
        def run(Ast, Bst, C0st, r0s, r1s, *, row_cap: int, device=None):
            return sparse_accum_spgemm_stream(Ast, Bst, C0st, r0s, r1s, order=order,
                                              row_cap=row_cap, device=device)
    return run


_SPARSE_RUNS = {alg: _make_csr_accum_run("sparse", order)
                for alg, order in _CSR_ACCUM_ORDERS.items()}
_HASH_RUNS = {alg: _make_csr_accum_run("hash", order)
              for alg, order in _CSR_ACCUM_ORDERS.items()}
_SPARSE_CORES = _core_set("{alg}_sparse", _SPARSE_RUNS)
_SPARSE_CORES_BATCHED = _core_set("{alg}_sparse_batched", _SPARSE_RUNS)
_HASH_CORES = _core_set("{alg}_hash", _HASH_RUNS)
_HASH_CORES_BATCHED = _core_set("{alg}_hash_batched", _HASH_RUNS)


def _checked_table(A: CSR, B: CSR, c_pad: int, backend: str, caps):
    """The hash table's slots (None for ESC), after checking the realized
    output structure against the capacities."""
    table = (hash_table_slots(caps.c_max_row_nnz) if backend == "hash"
             else None)
    check_output_caps(caps.strip_nnz, caps.c_max_row_nnz, c_pad, table,
                      backend=backend, a_shape=A.shape, b_shape=B.shape)
    return table


def _pinned_for(placement, device) -> tuple:
    """Which of A, B and C an in-place call on ``device`` builds in pinned
    host memory: the slow ones on the card (nothing on the CPU, where both
    spaces are host memory)."""
    card = device.type == "cuda"
    return tuple(card and getattr(placement, k) == "slow" for k in "ABC")


def _stack_one(pieces: list, pin: bool = False) -> CSR:
    """``pieces`` as a one-instance stack (leading ``[1, n]`` axes), in
    pinned host memory with ``pin``."""
    st = _one_stack(csr_stack(pieces))
    return csr_pin(st) if pin else st


def _sparse_run(A: CSR, B: CSR, plan: ChunkPlan, c_pad: int, caps=None, *, backend: str):
    """Shared body of the CSR-output executors (ESC and hash): stage CSR
    strips and chunks (knl is the 1-strip special case of the chunk1 order),
    validate the realized output structure against the capacities, launch,
    and assemble the accumulated strip CSRs.

    ``caps`` is the symbolic phase's :class:`StripOutputCaps` when the caller
    already ran the expansion; recomputed here only for direct calls."""
    if caps is None:
        caps = strip_output_caps(A, B, plan.p_ac)
    table = _checked_table(A, B, c_pad, backend, caps)
    strips = a_strips(A, plan.p_ac)
    strip_rows, a_stage = strips[0].n_rows, strips[0].nbytes()
    Ast = _one_stack(csr_stack(strips))
    del strips
    chunks = b_chunks(B, plan.p_b)
    slab = chunks[0].nbytes()
    Bst = _one_stack(csr_stack(chunks))
    del chunks
    r0s, r1s = plan.b_ranges()
    C0 = _sparse_c0_stack(1, plan.n_ac, strip_rows, B.n_cols, c_pad, A.dtype, A.device)
    if backend == "hash":
        ip, ix, d = _HASH_CORES[plan.algorithm](Ast, Bst, C0, r0s, r1s, table_size=table)
    else:
        ip, ix, d = _SPARSE_CORES[plan.algorithm](Ast, Bst, C0, r0s, r1s,
                                                  row_cap=caps.c_max_row_nnz)
    stats = planned_stats_pallas(plan, slab, a_stage,
                                 _c_strip_nbytes(strip_rows, c_pad, A.dtype))
    out = [CSR(ip[0, i], ix[0, i], d[0, i], (strip_rows, B.n_cols), c_pad)
           for i in range(plan.n_ac)]
    return _assemble(out, plan.p_ac, B.n_cols), stats


def chunk_sparse(A: CSR, B: CSR, plan: ChunkPlan, c_pad: int, caps=None):
    """ESC CSR-output executor for any plan algorithm."""
    return _sparse_run(A, B, plan, c_pad, caps, backend="sparse")


def chunk_hash(A: CSR, B: CSR, plan: ChunkPlan, c_pad: int, caps=None):
    """Hash-probe executor for any plan algorithm."""
    return _sparse_run(A, B, plan, c_pad, caps, backend="hash")


# ---------------------------------------------------------------------------
# CSR-output backends with operands in slow memory: the copy2Fast ring
# ---------------------------------------------------------------------------


def _one(m: CSR) -> CSR:
    """A piece as a one-element stack (leading ``[1, 1]`` axes, views)."""
    return CSR(m.indptr[None, None], m.indices[None, None], m.data[None, None],
               m.shape, m.max_row_nnz)


def _one_stack(m: CSR) -> CSR:
    """A piece as a one-element stack (one leading axis, views)."""
    return CSR(m.indptr[None], m.indices[None], m.data[None], m.shape, m.max_row_nnz)


def _drive_placed(link, plan: ChunkPlan, placement, As, Bs, zeros, launch,
                  card: bool, Ms=None, on_strip=None) -> list:
    """The step loop of the placed executors that carry C as ``C_prev``
    (the CSR accumulators, the masked kernel, the dense slab): one
    ``launch(A_i, B_j, C_i, M_i, j)`` a step, each operand's piece from its
    ring when it is slow (A strips stationary and B chunks streamed in the
    chunk1 orders, the other way in Chunk2). ``zeros`` is the empty C_prev
    in C's space: one strip's block, a ring element once a strip, in the
    chunk1 orders; all strips' block, one transfer, in Chunk2. ``Ms`` (the
    mask's pieces, in C's space) cross beside it. ``on_strip(i, C_i)`` sees
    each strip's final C on the card. A slow C goes out to a stack in slow
    memory as each strip ends (Chunk2: once, whole). Returns each strip's
    C, on the card when C is fast, else views of that stack."""
    n_ac, n_b = plan.n_ac, plan.n_b
    c_slow = placement.C == "slow"
    c_out = copy_ring.slow_stack(copy_ring.piece(zeros, 0), n_ac, card) if c_slow else None
    stationary, streamed = _step_elements(plan)
    out = []
    if plan.algorithm != "chunk2":
        get_a, put_a = copy_ring.source(link, "A", As, placement.A, "stationary", stationary)
        get_b, put_b = copy_ring.source(link, "B", Bs, placement.B, "streamed", streamed)
        get_c, put_c = copy_ring.source(link, "C", zeros, placement.C, "stationary", [0] * n_ac)
        get_m, put_m = ((lambda i: None), (lambda i: None)) if Ms is None else copy_ring.source(
            link, "M", Ms, placement.C, "stationary", range(n_ac))
        for i in range(n_ac):
            Ai, Ci, Mi = get_a(i), get_c(i), get_m(i)
            for j in range(n_b):
                lin = i * n_b + j
                Ci = launch(Ai, get_b(lin), Ci, Mi, j)
                put_b(lin)
                if j == 0:
                    put_c(i)
            put_a(i)
            put_m(i)
            if on_strip is not None:
                on_strip(i, Ci)
            if c_slow:
                link.copy_out("C", [Ci], c_out, first=i)
            else:
                out.append(Ci)
    else:
        get_b, put_b = copy_ring.source(link, "B", Bs, placement.B, "stationary", stationary)
        get_a, put_a = copy_ring.source(link, "A", As, placement.A, "streamed", streamed)
        # a slow C's block comes in as one transfer, each strip in its own
        # allocation: a strip's old partial is freed as its step replaces it
        out = (link.copy_in_each("C", zeros) if c_slow else
               [copy_ring.piece(zeros, i) for i in range(n_ac)])
        m_block = None if Ms is None else (link.copy_in("M", Ms) if c_slow else Ms)
        for jb in range(n_b):
            Bj = get_b(jb)
            for i in range(n_ac):
                lin = jb * n_ac + i
                Mi = None if m_block is None else copy_ring.piece(m_block, i)
                out[i] = launch(get_a(lin), Bj, out[i], Mi, jb)
                put_a(lin)
            put_b(jb)
        for i, Ci in enumerate(out if on_strip is not None else ()):
            on_strip(i, Ci)
        if c_slow:
            link.copy_out("C", out, c_out)
    link.finish()
    return [copy_ring.piece(c_out, i) for i in range(n_ac)] if c_slow else out


def _sparse_run_placed(A: CSR, B: CSR, plan: ChunkPlan, c_pad: int, caps,
                       placement, device: torch.device, *, backend: str):
    """:func:`_sparse_run` with operands in slow memory: the batched
    executor (:func:`_csr_accum_run_batched_placed`) on the one instance at
    its own envelope, through the module's unbatched cores.

    The strips and chunks of each slow operand are built in slow memory
    (pinned on the card), those of a fast one on ``device``. The stream
    wrapper launches once per (strip, chunk) step on one-element stacks, a
    slow operand's piece read from its ring's slot: the stationary operand
    (A strips in the chunk1 orders, B chunks in chunk2) through a ring over
    the outer steps, the streamed one through a ring over every step. Each
    step's C is the next step's ``C_prev``. A slow C comes in as the events
    list it (a strip's empty block per strip in the chunk1 orders, the whole
    block once in chunk2) and goes back out to a stack in slow memory, where
    the strips are assembled. Each launch is the step the one-launch kernel
    takes, so C equals the all-fast call's; ``ChunkStats`` are the same
    plan's. ``caps`` is the symbolic phase's :class:`StripOutputCaps`."""
    env = instance_envelope(A, B, plan, c_pad=c_pad, caps=caps)
    cores = _HASH_CORES if backend == "hash" else _SPARSE_CORES
    Cs, stats = _csr_accum_run_batched_placed([A], [B], plan, env, backend, caps_list=[caps],
                                              cores=cores, placement=placement, device=device)
    return Cs[0], stats


def _scan_run_placed(A: CSR, B: CSR, plan: ChunkPlan, c_pad: int, caps,
                     placement, device: torch.device):
    """The ``scan`` executor with operands in slow memory: the paper's steps
    and crossings (``chunking.run_ranged``), each step the plan's scan core
    on one-element stacks of card pieces. C equals the all-fast call's bit
    for bit, and the ChunkStats are :func:`planned_stats` of the plan."""
    del caps   # the ranged merge cannot overflow c_pad
    core = _SCAN_CORES[plan.algorithm]
    r0s, r1s = plan.b_ranges()

    def step(Ai, Bj, j, Ci):
        if plan.algorithm == "knl":
            return core(Ai, _one_stack(Bj), r0s[j:j + 1], r1s[j:j + 1], Ci, c_pad=c_pad)
        C0 = _one_stack(Ci) if plan.algorithm == "chunk2" else Ci
        return core(_one_stack(Ai), _one_stack(Bj), r0s[j:j + 1], r1s[j:j + 1], C0,
                    c_pad=c_pad)[0]

    return run_ranged(A, B, plan, c_pad, placement, device, step)


def _pallas_run_placed(A: CSR, B: CSR, plan: ChunkPlan, c_pad: int, caps,
                       placement, device: torch.device):
    """The dense-slab executor with operands in slow memory: the batched
    executor (:func:`_pallas_run_batched_placed`) on the one instance at its
    own envelope. ``ranged_spgemm_stream`` launches once a (strip, chunk)
    step, a slow operand's dense piece read from its ring's slot, each
    step's output the next step's ``c0``, so C equals the one-launch call
    bit for bit; a slow C stays in pinned memory."""
    env = instance_envelope(A, B, plan, c_pad=c_pad, caps=caps)
    Cs, stats = _pallas_run_batched_placed([A], [B], plan, env, placement=placement,
                                           device=device)
    return Cs[0], stats


# ---------------------------------------------------------------------------
# slow operands read in place: one launch a strip, no ring
# ---------------------------------------------------------------------------
#
# The in-place executors build each slow operand's stacks in pinned host
# memory, where the kernel on the card reads them through their mapped
# addresses (the reference's ``memory_space=ANY`` operands), and launch the
# backend's streaming kernel once per strip of the plan: a launch takes the
# strip's A (of every instance, side by side), every B chunk and one strip's
# empty C_prev, so its workspace on the card (the merge's per-row slabs,
# tables and flags, the output block when C is fast) is one strip's, as the
# reference's grid step holds one step's scratch. Each row meets its chunks
# in the plan's order in one launch, so C equals the all-fast call's bit for
# bit. A slow C's strips are written in place into pinned memory, launch by
# launch, and assembled there.


def _grid_stack(rows: list, pin: bool) -> CSR:
    """Pieces of one geometry, ``rows`` of equal length, as one stack
    ``[len(rows), len(rows[0]), ...]`` made by one copy of the pieces (a
    stack of stacks would hold a third); in pinned host memory with
    ``pin``."""
    st = csr_stack([p for row in rows for p in row])
    lead = (len(rows), len(rows[0]))
    st = CSR(*(t.reshape(*lead, -1) for t in (st.indptr, st.indices, st.data)), st.shape,
             st.max_row_nnz)
    return csr_pin(st) if pin else st


def _csr_accum_run_in_place(As, Bs, plan: ChunkPlan, envelope: GeometryEnvelope,
                            kind: str, *, caps_list=None, validate_caps: bool = True,
                            cores: dict | None = None, placement, device):
    """The CSR accumulators (ESC and hash) with slow operands read in place,
    one launch a strip for the whole batch (the batched entry's
    ``run_batched_in_place``; the unbatched ``run_in_place`` is its width-1
    call at the instance's own envelope). The envelope-padded A strips are
    stacked strip-major and the B chunks as the kernel takes them, each slow
    one in pinned memory; C_prev is one strip's empty block in C's space.
    Every C equals the all-fast call's bit for bit, in pinned host memory
    when C is slow; the ChunkStats are the same plan's."""
    statics = _csr_accum_statics(As, Bs, plan, envelope, kind, caps_list, validate_caps)
    pin = _pinned_for(placement, device)
    c_pad, n_cols, dtype = envelope.c_pad, Bs[0].n_cols, As[0].dtype
    strip_rows = envelope.strip_rows
    strips = [a_strips(A, plan.p_ac, envelope=envelope) for A in As]
    a_stage = strips[0][0].nbytes()
    Ast = _grid_stack(list(zip(*strips)), pin[0])    # strip-major: [n_ac, width]
    del strips
    chunks = [b_chunks(B, plan.p_b, envelope=envelope) for B in Bs]
    slab = chunks[0][0].nbytes()
    Bst = _grid_stack(chunks, pin[1])                 # as the kernel takes them
    del chunks
    C0 = _sparse_c0_stack(len(As), 1, strip_rows, n_cols, c_pad, dtype,
                          "cpu" if pin[2] else device)
    if pin[2]:
        C0 = csr_pin(C0)
    if cores is None:
        cores = _HASH_CORES_BATCHED if kind == "hash" else _SPARSE_CORES_BATCHED
    core = cores[plan.algorithm]
    r0s, r1s = plan.b_ranges()
    out = []
    for i in range(plan.n_ac):
        ip, ix, d = core(_col(copy_ring.piece(Ast, i)), Bst, C0, r0s, r1s, device=device,
                         **statics)
        out.append(CSR(ip[:, 0], ix[:, 0], d[:, 0], (strip_rows, n_cols), c_pad))
    stats = planned_stats_pallas(plan, slab, a_stage,
                                 _c_strip_nbytes(strip_rows, c_pad, dtype))
    return _unbatch(out, plan.p_ac, n_cols, pin[2]), stats


def _sparse_run_in_place(A: CSR, B: CSR, plan: ChunkPlan, c_pad: int, caps, placement,
                         device: torch.device, *, backend: str):
    """The ESC and hash backends' ``run_in_place``: :func:`_csr_accum_run_in_place`
    on the one instance at its own envelope, through the module's
    unbatched cores."""
    if caps is None:
        caps = strip_output_caps(A, B, plan.p_ac)
    env = instance_envelope(A, B, plan, c_pad=c_pad, caps=caps)
    cores = _HASH_CORES if backend == "hash" else _SPARSE_CORES
    Cs, stats = _csr_accum_run_in_place([A], [B], plan, env, backend, caps_list=[caps],
                                        cores=cores, placement=placement, device=device)
    return Cs[0], stats


def _pallas_run_batched_in_place(As, Bs, plan: ChunkPlan, envelope: GeometryEnvelope, *,
                                 caps_list=None, validate_caps: bool = True,
                                 cores: dict | None = None, placement, device):
    """The dense slab with slow operands read in place, one
    ``ranged_spgemm_stream`` launch a strip for the whole batch: the dense
    A strips (with their ``span`` zero columns) strip-major, the B slabs as
    the kernel takes them and one strip's C block, each slow one in pinned
    memory. The kernel writes C as base plus partial, chunk by chunk, so
    every C equals the all-fast call's bit for bit; a slow C is written in
    place and sparsified in pinned memory, where it stays."""
    del caps_list, validate_caps, cores   # dense accumulators cannot overflow
    pin = _pinned_for(placement, device)
    width, n_cols = len(As), Bs[0].n_cols
    order = "chunk2" if plan.algorithm == "chunk2" else "chunk1"
    strip_rows = envelope.strip_rows
    strips = zip(*(a_strips(A, plan.p_ac, envelope=envelope) for A in As))
    a = _dense_stack(_grid_stack(list(strips), False), levels=2,
                     pad_cols=envelope.chunk_rows, pin_memory=pin[0])
    slabs = _dense_stack(_grid_stack([b_chunks(B, plan.p_b, envelope=envelope) for B in Bs],
                                     False), levels=2, pin_memory=pin[1])
    c0 = torch.zeros(width, 1, strip_rows, n_cols, dtype=torch.float32,
                     device="cpu" if pin[2] else device, pin_memory=pin[2])
    r0s, _ = plan.b_ranges()
    out = [ranged_spgemm_stream(a[i][:, None], slabs, c0, r0s, order=order,
                                device=device)[:, 0] for i in range(plan.n_ac)]
    del a, slabs
    Cs = []
    for w in range(width):
        C = _pallas_assemble([o[w] for o in out], plan.p_ac)
        Cs.append(csr_pin(C) if pin[2] else C)
    return Cs, planned_stats_pallas(plan, *_pallas_stage_nbytes(
        strip_rows, envelope.a_shape[1], envelope.chunk_rows, n_cols))


def _pallas_run_in_place(A: CSR, B: CSR, plan: ChunkPlan, c_pad: int, caps,
                         placement, device: torch.device):
    """The dense slab's ``run_in_place``: :func:`_pallas_run_batched_in_place`
    on the one instance at its own envelope."""
    env = instance_envelope(A, B, plan, c_pad=c_pad, caps=caps)
    Cs, stats = _pallas_run_batched_in_place([A], [B], plan, env, placement=placement,
                                             device=device)
    return Cs[0], stats


# ---------------------------------------------------------------------------
# masked hash executor: fused output mask (triangle counting's fast path)
# ---------------------------------------------------------------------------


def stage_hash_masked(A: CSR, B: CSR, mask: CSR, plan: ChunkPlan, c_pad: int,
                      caps=None, c_prev: CSR | None = None, *, pin=(False, False, False),
                      device=None):
    """Stage the masked kernel's operands for ``plan``, as
    :func:`chunk_hash_masked` launches them: returns ``(operands,
    table_size, stats)`` with ``operands = (Ast, Bst, C0st, Mst, r0s, r1s)``
    of ``hash_masked_accum_spgemm_stream`` and the plan's ChunkStats.

    C_prev is empty at capacity ``c_pad``, or ``c_prev``'s strips at the
    larger of ``c_pad`` and their own capacity. ``pin`` builds A's, B's and
    C's stacks (C's: C_prev and the mask) in pinned host memory, for a
    launch on ``device`` that reads them in place; an empty C_prev is made
    on ``device`` (A's by default) otherwise."""
    if mask.shape != (A.n_rows, B.n_cols):
        raise ValueError(
            f"mask shape {mask.shape} != output shape {(A.n_rows, B.n_cols)}")
    if caps is None:
        caps = masked_output_caps(mask, plan.p_ac)
    table = hash_table_slots(caps.c_max_row_nnz)
    check_output_caps(caps.strip_nnz, caps.c_max_row_nnz, c_pad, table,
                      backend="hash", a_shape=A.shape, b_shape=B.shape)
    strips = a_strips(A, plan.p_ac)
    chunks = b_chunks(B, plan.p_b)
    mstrips = a_strips(mask, plan.p_ac)
    Ast, Bst, Mst = (_stack_one(pieces, p) for pieces, p in
                     ((strips, pin[0]), (chunks, pin[1]), (mstrips, pin[2])))
    r0s, r1s = plan.b_ranges()
    strip_rows = strips[0].n_rows
    if c_prev is None:
        C0 = _sparse_c0_stack(1, plan.n_ac, strip_rows, B.n_cols, c_pad,
                              A.dtype, "cpu" if pin[2] else device or A.device)
    else:
        c0s = a_strips(c_prev, plan.p_ac)
        c_pad = max(c_pad, c0s[0].nnz_pad)
        C0 = csr_stack([csr_stack([csr_pad_to(s, c_pad) for s in c0s])])
    if pin[2]:
        C0 = csr_pin(C0)
    stats = planned_stats_pallas(
        plan, chunks[0].nbytes(), strips[0].nbytes(),
        _c_strip_nbytes(strip_rows, c_pad, A.dtype))
    # the mask's structure operands (indptr + indices, no data) stage with
    # the fused C_prev block: once per strip in the chunk1 orders, one whole
    # block in chunk2
    m_struct = float((strip_rows + 1) * 4 + mstrips[0].indices.shape[-1] * 4)
    extra = ((plan.n_ac * m_struct,) if plan.algorithm == "chunk2"
             else (m_struct,) * plan.n_ac)
    stats = dataclasses.replace(stats, per_copy_in=stats.per_copy_in + extra)
    return (Ast, Bst, C0, Mst, r0s, r1s), table, stats


def chunk_hash_masked(A: CSR, B: CSR, mask: CSR, plan: ChunkPlan,
                      c_pad: int, caps=None):
    """Mask-fused hash executor: ``C = (A x B) ∘ mask``, mask inside the
    kernel — the hash backend's ``run_masked``.

    C's structure is pinned to the mask's (explicit zeros where no product
    lands), so every capacity derives from the mask alone
    (``symbolic.masked_output_caps``): the reference sizes the probe tables
    from the densest mask row and the CSR scratch from the largest strip's
    mask nnz; the unmasked product's structure is never expanded. ``caps``
    amortizes the (mask-only) host pass.
    """
    operands, table, stats = stage_hash_masked(A, B, mask, plan, c_pad, caps)
    return _masked_launch(operands, table, plan, B.n_cols, c_pad), stats


def _masked_launch(operands, table: int, plan: ChunkPlan, n_cols: int, c_pad: int) -> CSR:
    """One masked launch over the staged ``operands``, its strips assembled
    into C."""
    ip, ix, d = hash_masked_accum_spgemm_stream(
        *operands, order=_CSR_ACCUM_ORDERS[plan.algorithm], table_size=table)
    strip_rows = operands[0].n_rows
    out = [CSR(ip[0, i], ix[0, i], d[0, i], (strip_rows, n_cols), c_pad)
           for i in range(plan.n_ac)]
    return _assemble(out, plan.p_ac, n_cols)


def _masked_run_in_place(A: CSR, B: CSR, mask: CSR, plan: ChunkPlan, c_pad: int,
                         caps, placement, device: torch.device):
    """:func:`chunk_hash_masked` with slow operands read in place: the hash
    backend's ``run_masked_in_place``. Each slow role's stack (``placement.C``
    puts C_prev and the mask) is built in pinned host memory, and the masked
    kernel on ``device`` launches once a strip, reading the strip's A, mask
    and C_prev and every B chunk where they lie and writing a slow C's strip
    there; each launch's work list is cut from its strip (on the host when
    an operand is there). ChunkStats are :func:`stage_hash_masked`'s."""
    pin = _pinned_for(placement, device)
    (Ast, Bst, C0, Mst, r0s, r1s), table, stats = stage_hash_masked(
        A, B, mask, plan, c_pad, caps, pin=pin, device=device)
    order = _CSR_ACCUM_ORDERS[plan.algorithm]
    strip_rows, n_cols, c_cap = Ast.n_rows, B.n_cols, C0.indices.shape[-1]

    def strip(st, i):   # strip i of a one-instance stack (contiguous views)
        return CSR(st.indptr[:, i:i + 1], st.indices[:, i:i + 1], st.data[:, i:i + 1],
                   st.shape, st.max_row_nnz)

    out = []
    for i in range(plan.n_ac):
        ip, ix, d = hash_masked_accum_spgemm_stream(
            strip(Ast, i), Bst, strip(C0, i), strip(Mst, i), r0s, r1s, order=order,
            table_size=table, device=device)
        out.append(CSR(ip[0, 0], ix[0, 0], d[0, 0], (strip_rows, n_cols), c_cap))
    C = _assemble(out, plan.p_ac, n_cols)
    return (csr_pin(C) if pin[2] else C), stats


def _masked_run_placed(A: CSR, B: CSR, mask: CSR, plan: ChunkPlan, c_pad: int,
                       caps, placement, device: torch.device, on_strip=None):
    """:func:`chunk_hash_masked` with operands in slow memory: the hash
    backend's ``run_masked_placed``.

    As :func:`_sparse_run_placed`, with the mask beside C: ``placement.C``
    puts C and the mask in their space. A slow mask's strips cross as their
    structure (indptr and indices: the kernel reads no mask value), with C's
    empty block: a strip's in the chunk1 orders through a ring, the whole
    block in Chunk2 (:func:`planned_events_masked`). The masked kernel
    launches once a step, C carried as ``C_prev``. ``on_strip(i, C_i)``, when
    given, sees each strip's final C on ``device`` before a slow C goes out
    (the triangle count sums it there). ChunkStats are
    :func:`stage_hash_masked`'s."""
    if mask.shape != (A.n_rows, B.n_cols):
        raise ValueError(
            f"mask shape {mask.shape} != output shape {(A.n_rows, B.n_cols)}")
    if caps is None:
        caps = masked_output_caps(mask, plan.p_ac)
    table = hash_table_slots(caps.c_max_row_nnz)
    check_output_caps(caps.strip_nnz, caps.c_max_row_nnz, c_pad, table,
                      backend="hash", a_shape=A.shape, b_shape=B.shape)
    card = device.type == "cuda"
    n_ac, n_cols = plan.n_ac, B.n_cols
    order = _CSR_ACCUM_ORDERS[plan.algorithm]
    strips = a_strips(A, plan.p_ac)
    chunks = b_chunks(B, plan.p_b)
    mstrips = a_strips(mask, plan.p_ac)
    a_stage, slab = strips[0].nbytes(), chunks[0].nbytes()
    strip_rows, m_like = strips[0].n_rows, mstrips[0]
    As = copy_ring.staged(strips, placement.A, card)
    Bs = copy_ring.staged(chunks, placement.B, card)
    Ms = copy_ring.staged([(m.indptr, m.indices) for m in mstrips], placement.C, card)
    del strips, chunks, mstrips
    m_data = torch.zeros(m_like.indices.shape, dtype=m_like.dtype, device=device)
    r0s, r1s = plan.b_ranges()
    c_slow = placement.C == "slow"
    zeros = copy_ring.piece(_sparse_c0_stack(
        1, n_ac if plan.algorithm == "chunk2" else 1, strip_rows, n_cols, c_pad,
        A.dtype, "cpu" if c_slow else device), 0)
    if c_slow and card:
        zeros = csr_pin(zeros)
    link = copy_ring.Link(device)

    def launch(Ai, Bj, Ci, Mi, j):
        Mi = CSR(*Mi, m_data, m_like.shape, m_like.max_row_nnz)
        with link.step():
            ip, ix, d = hash_masked_accum_spgemm_stream(
                _one(Ai), _one(Bj), _one(Ci), _one(Mi), r0s[j:j + 1], r1s[j:j + 1],
                order=order, table_size=table)
        return CSR(ip[0, 0], ix[0, 0], d[0, 0], (strip_rows, n_cols), c_pad)

    out = _drive_placed(link, plan, placement, As, Bs, zeros, launch, card, Ms=Ms,
                        on_strip=on_strip)
    C = _assemble(out, plan.p_ac, n_cols)
    if c_slow and card:
        C = csr_pin(C)
    stats = planned_stats_pallas(plan, slab, a_stage,
                                 _c_strip_nbytes(strip_rows, c_pad, A.dtype))
    m_struct = float((strip_rows + 1) * 4 + m_like.indices.shape[-1] * 4)
    extra = ((n_ac * m_struct,) if plan.algorithm == "chunk2" else (m_struct,) * n_ac)
    return C, dataclasses.replace(stats, per_copy_in=stats.per_copy_in + extra)


# ---------------------------------------------------------------------------
# BSR backend: blocked tiles (kernels/bsr_spgemm), staged from the CSR
# ---------------------------------------------------------------------------

_BSR_DEFAULT_BLOCK = 8


def _stage_bsr(m: CSR, row0: int, row1: int, col0: int, col1: int,
               row_shift: int, shape: tuple, bs: int, pad_to: int) -> BSR:
    """The BSR of ``m[row0:row1, col0:col1]`` placed at rows
    ``row - row_shift`` (columns kept) of a zero ``shape`` matrix, built on
    ``m``'s device from the CSR entries: duplicates summed, a block kept iff
    one of its values is nonzero — the blocks the reference's densify-then-
    ``bsr_from_dense`` staging keeps — in (block row, block column) order,
    padded to ``pad_to`` zero blocks."""
    dev = m.device
    ip = m.indptr
    s, e = (int(v) for v in ip[[row0, row1]].tolist())
    cols = m.indices[s:e].long()
    entry = torch.arange(s, e, device=dev, dtype=ip.dtype)
    rows = torch.searchsorted(ip[row0 : row1 + 1].contiguous(), entry, right=True) - 1
    sel = (cols >= col0) & (cols < col1)
    lr, lc, v = rows[sel] + (row0 - row_shift), cols[sel], m.data[s:e][sel]
    n_bc = shape[1] // bs
    key = (lr // bs) * n_bc + lc // bs
    uniq, inv = torch.unique(key, return_inverse=True)
    tiles = torch.zeros(uniq.numel(), bs, bs, dtype=torch.float32, device=dev)
    tiles.index_put_((inv, lr % bs, lc % bs), v.float(), accumulate=True)
    keep = (tiles != 0).flatten(1).any(1)
    uniq, tiles = uniq[keep], tiles[keep]
    nbl = uniq.numel()
    if nbl > pad_to:
        raise ValueError(f"staged piece has {nbl} blocks, more than the "
                         f"envelope's cap {pad_to}")
    n_br = shape[0] // bs
    counts = torch.bincount(uniq // n_bc, minlength=n_br)
    indptr = torch.zeros(n_br + 1, dtype=torch.int32, device=dev)
    indptr[1:] = torch.cumsum(counts, 0)
    indices = torch.zeros(pad_to, dtype=torch.int32, device=dev)
    indices[:nbl] = (uniq % n_bc).to(torch.int32)
    blocks = torch.zeros(pad_to, bs, bs, dtype=torch.float32, device=dev)
    blocks[:nbl] = tiles
    return BSR(indptr, indices, blocks, tuple(shape), bs,
               int(counts.max()) if counts.numel() else 0)


def _fold_bsr(blocks: list, slots: list, device) -> tuple:
    """One launch's operand from ``width`` instances' pieces of one side:
    their blocks (each with its zero sentinel last) end to end, then one
    shared zero block, and their slot tables stacked, each instance's slots
    moved past the blocks of the instances before it and its own sentinel
    slot sent to the shared one. The kernel skips a step only at the last
    block's slot, so an instance sentinel left in place would multiply zero
    blocks: the same numbers, more work. Width 1 is the instance's own."""
    if len(blocks) == 1:
        return blocks[0], torch.from_numpy(slots[0]).to(device)
    cap = blocks[0].shape[0] - 1
    joined = torch.cat([b[:cap] for b in blocks] + [blocks[0][cap:]])
    shared = len(blocks) * cap
    table = np.concatenate([np.where(t == cap, shared, t + w * cap)
                            for w, t in enumerate(slots)]).astype(np.int32)
    return joined, torch.from_numpy(table).to(device)


def stage_bsr_pairs_batched(As, Bs, plan: ChunkPlan, envelope: GeometryEnvelope):
    """Stage the BSR executor's (strip, chunk) pairs of every instance in
    launch order (Chunk2 streams strips under a stationary chunk, the other
    orders chunks under a stationary strip) at the envelope's block caps,
    each pair's instances folded into one launch (:func:`_fold_bsr`). Yields
    ``(strip, operands, metas)``: the strip's index, ``(a_blocks, b_blocks,
    a_slots, b_slots)`` of ``bsr_spgemm_blocks`` at ``nc_pad = width x
    nc_cap`` C blocks (instance ``w``'s from row ``w x nc_cap``), and each
    instance's :class:`BsrSpgemmMeta`.

    An instance's A piece is its strip's rows with columns outside the chunk
    dropped, at full contraction width, and its B piece the chunk's rows at
    full output width, so summing pair products over chunks is exactly the
    strip product."""
    bs, nbl_a_cap, nbl_b_cap, nc_cap, u_cap = envelope.bsr_caps
    k, n = Bs[0].shape
    kpad = -(-k // bs) * bs
    npad = -(-n // bs) * bs
    srpad = -(-envelope.strip_rows // bs) * bs
    strips = list(zip(plan.p_ac[:-1], plan.p_ac[1:]))
    chunks = list(zip(plan.p_b[:-1], plan.p_b[1:]))
    pairs = ([(ia, jb) for jb in range(len(chunks)) for ia in range(len(strips))]
             if plan.algorithm == "chunk2" else
             [(ia, jb) for ia in range(len(strips)) for jb in range(len(chunks))])
    for ia, jb in pairs:
        s, e = strips[ia]
        r0, r1 = chunks[jb]
        a_bl, b_bl, a_sl, b_sl, metas = [], [], [], [], []
        for A, B in zip(As, Bs):
            Ab = _stage_bsr(A, s, e, r0, r1, s, (srpad, kpad), bs, nbl_a_cap)
            Bb = _stage_bsr(B, r0, r1, 0, n, 0, (kpad, npad), bs, nbl_b_cap)
            meta = bsr_spgemm_symbolic(Ab, Bb, nc_pad=nc_cap, u_max=u_cap)
            a_bl.append(bsr_blocks_with_sentinel(Ab))
            b_bl.append(bsr_blocks_with_sentinel(Bb))
            a_sl.append(meta.a_slots)
            b_sl.append(meta.b_slots)
            metas.append(meta)
        a_blocks, a_slots = _fold_bsr(a_bl, a_sl, As[0].device)
        b_blocks, b_slots = _fold_bsr(b_bl, b_sl, As[0].device)
        yield ia, (a_blocks, b_blocks, a_slots, b_slots), metas


def stage_bsr_pairs(A: CSR, B: CSR, plan: ChunkPlan, envelope: GeometryEnvelope):
    """:func:`stage_bsr_pairs_batched` of one instance: yields ``(strip,
    operands, meta)``."""
    for ia, operands, metas in stage_bsr_pairs_batched([A], [B], plan, envelope):
        yield ia, operands, metas[0]


def _bsr_kernel(a_blocks, b_blocks, a_slots, b_slots, *, envelope: GeometryEnvelope):
    """The launch body of the BSR cores; the whole envelope is the static
    key, as in the reference (two envelopes whose block caps agree still
    count apart)."""
    bs, _, _, _, u_max = envelope.bsr_caps
    return bsr_spgemm_blocks(a_blocks, b_blocks, a_slots, b_slots,
                             nc_pad=a_slots.shape[0], u_max=u_max, bs=bs)


_BSR_RUNS = dict.fromkeys(backend_registry.ALGORITHMS, _bsr_kernel)
_BSR_CORES = _core_set("{alg}_bsr", _BSR_RUNS)
_BSR_CORES_BATCHED = _core_set("{alg}_bsr_batched", _BSR_RUNS)


def _bsr_pair_keys(meta, mbs: int, nbp: int) -> np.ndarray:
    """A pair's C block keys (block row x ``nbp`` + block column), cropped
    to its real blocks: padded rows carry ``c_indices == 0`` and would alias
    block column 0 if kept."""
    n_c = meta.n_c_blocks
    brows = np.repeat(np.arange(mbs, dtype=np.int64), np.diff(meta.c_indptr))
    return brows[:n_c] * nbp + meta.c_indices[:n_c].astype(np.int64)


def _bsr_layout(pair_keys: list) -> tuple:
    """One strip's C blocks from its pairs' block keys: the sorted union
    (the strip's block keys) and each pair's rows in it (host arrays)."""
    keys = (np.unique(np.concatenate(pair_keys)) if pair_keys
            else np.zeros(0, dtype=np.int64))
    return keys, [np.searchsorted(keys, k) for k in pair_keys]


def _bsr_add(acc: torch.Tensor, pos, tiles: torch.Tensor) -> None:
    """Add one pair's output blocks into its strip's accumulator at the
    pair's rows of the strip's blocks (``pos``, host). A pair holds each
    block once, so every sum is ``acc + tile`` on the accumulator's device,
    the same bits whatever the order of the adds."""
    if len(pos):
        acc.index_add_(0, torch.from_numpy(pos).to(acc.device), tiles)


def _bsr_strip_csr(acc: torch.Tensor, keys, real_rows: int, strip_rows: int,
                   n: int, bs: int, nbp: int, dtype, pad_to: int | None) -> CSR:
    """One strip's C from its summed blocks ``acc`` (block keys ``keys``,
    host) on ``acc``'s device: the nonzero entries ``csr_from_dense`` would
    keep, inside the strip's ``real_rows`` and C's ``n`` columns, in row
    order, over ``strip_rows`` rows padded to ``pad_to`` entries."""
    dev = acc.device
    keys = torch.from_numpy(np.asarray(keys, dtype=np.int64)).to(dev)
    acc = acc[:keys.numel()]
    r = torch.arange(bs, device=dev)
    row = ((keys // nbp)[:, None, None] * bs + r[None, :, None]).expand_as(acc)
    col = ((keys % nbp)[:, None, None] * bs + r[None, None, :]).expand_as(acc)
    keep = (acc != 0) & (row < real_rows) & (col < n)
    rows, cols, vals = row[keep], col[keep], acc[keep]
    order = torch.argsort(rows * n + cols)
    rows, cols, vals = rows[order], cols[order], vals[order].to(dtype)
    indptr = torch.zeros(strip_rows + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=strip_rows), 0)
    return _csr_from_tensors(indptr, cols, vals, (strip_rows, n), int(rows.numel()),
                             pad_to)


def _bsr_execute(As, Bs, plan: ChunkPlan, envelope: GeometryEnvelope, cores: dict):
    """Body of the BSR executors over a list of instances: one launch of the
    blocked kernel per (strip, chunk) pair for the whole list
    (:func:`stage_bsr_pairs_batched`), each instance's output blocks summed
    per strip into its C. Returns the list of C and the stats.

    The reference densified whole operands and the whole product to get
    there, and launched once per pair and instance; here the pieces come
    straight from the CSR and C from the output blocks: the same blocks, the
    same block sums in the same pair order (:func:`_bsr_add`), and the
    nonzero entries ``csr_from_dense`` would keep (:func:`_bsr_strip_csr`)."""
    bs, _, _, nc_cap, _ = envelope.bsr_caps
    n = Bs[0].n_cols
    npad = -(-n // bs) * bs
    srpad = -(-envelope.strip_rows // bs) * bs
    mbs, nbp = srpad // bs, npad // bs
    dev = As[0].device
    strips = list(zip(plan.p_ac[:-1], plan.p_ac[1:]))
    parts = [[[] for _ in strips] for _ in As]
    core = cores[plan.algorithm]
    for ia, operands, metas in stage_bsr_pairs_batched(As, Bs, plan, envelope):
        out = core(*operands, envelope=envelope).view(len(As), nc_cap, bs, bs)
        for w, meta in enumerate(metas):
            if meta.n_c_blocks:
                parts[w][ia].append((_bsr_pair_keys(meta, mbs, nbp),
                                     out[w, :meta.n_c_blocks]))
    stats = planned_stats_pallas(plan, *_bsr_stage_nbytes(envelope))
    Cs = []
    for part, A in zip(parts, As):
        out = []
        for (s, e), pairs in zip(strips, part):
            keys, pos = _bsr_layout([k for k, _ in pairs])
            acc = torch.zeros(keys.size, bs, bs, dtype=torch.float32, device=dev)
            for p, (_, tiles) in zip(pos, pairs):
                _bsr_add(acc, p, tiles)
            out.append(_bsr_strip_csr(acc, keys, e - s, envelope.strip_rows, n, bs, nbp,
                                      A.dtype, None))
        Cs.append(_assemble(out, plan.p_ac, n))
    return Cs, stats


def _bsr_stage_nbytes(envelope: GeometryEnvelope) -> tuple:
    """(slab, a_stage, c_stage): the staged bytes of a B chunk, an A pair
    piece (each ``(indptr, indices, blocks)`` with the zero sentinel) and a
    C piece with its structure."""
    bs, nbl_a_cap, nbl_b_cap, nc_cap, _ = envelope.bsr_caps
    kpad = -(-envelope.b_shape[0] // bs) * bs
    mbs = -(-envelope.strip_rows // bs)
    block_bytes = bs * bs * 4
    slab = (kpad // bs + 1) * 4 + nbl_b_cap * (4 + block_bytes) + block_bytes
    a_stage = (mbs + 1) * 4 + nbl_a_cap * (4 + block_bytes) + block_bytes
    c_stage = (mbs + 1) * 4 + nc_cap * (4 + block_bytes)
    return slab, a_stage, c_stage


def chunk_bsr(A: CSR, B: CSR, plan: ChunkPlan, c_pad: int, caps=None,
              block_size: int | None = None):
    """Blocked-tile executor for any plan algorithm. Builds the block-capped
    instance envelope itself; the dispatch passes ``caps`` to amortize the
    element-level symbolic phase and ``block_size`` to override the default
    block edge."""
    env = instance_envelope(A, B, plan, c_pad=c_pad, caps=caps,
                            block_size=block_size or _BSR_DEFAULT_BLOCK)
    Cs, stats = _bsr_execute([A], [B], plan, env, _BSR_CORES)
    return Cs[0], stats


BsrPiece = collections.namedtuple("BsrPiece", "indptr indices blocks")


def _bsr_stage_placed(A: CSR, B: CSR, plan: ChunkPlan, env: GeometryEnvelope) -> tuple:
    """The placed ``bsr`` executor's pieces on the operands' own device
    (:func:`_stage_bsr` of the CSR, no densify step): ``(pairs, a_bsr,
    b_bsr, metas, layouts)``, the (strip, chunk) pairs in launch order (B's
    chunks stationary in Chunk2), a pair's A piece and each chunk's B
    piece, a pair's symbolic phase, and each strip's :func:`_bsr_layout`."""
    bs, nbl_a_cap, nbl_b_cap, nc_cap, u_cap = env.bsr_caps
    k, n = B.shape
    kpad, npad = -(-k // bs) * bs, -(-n // bs) * bs
    srpad = -(-env.strip_rows // bs) * bs
    strips = list(zip(plan.p_ac[:-1], plan.p_ac[1:]))
    chunks = list(zip(plan.p_b[:-1], plan.p_b[1:]))
    pairs = ([(ia, jb) for jb in range(len(chunks)) for ia in range(len(strips))]
             if plan.algorithm == "chunk2" else
             [(ia, jb) for ia in range(len(strips)) for jb in range(len(chunks))])
    b_bsr = [_stage_bsr(B, r0, r1, 0, n, 0, (kpad, npad), bs, nbl_b_cap)
             for r0, r1 in chunks]
    a_bsr = [_stage_bsr(A, *strips[ia], *chunks[jb], strips[ia][0], (srpad, kpad), bs,
                        nbl_a_cap) for ia, jb in pairs]
    metas = [bsr_spgemm_symbolic(a_bsr[p], b_bsr[jb], nc_pad=nc_cap, u_max=u_cap)
             for p, (_, jb) in enumerate(pairs)]
    keys = [[] for _ in strips]
    for meta, (ia, _) in zip(metas, pairs):
        keys[ia].append(_bsr_pair_keys(meta, srpad // bs, npad // bs))
    return pairs, a_bsr, b_bsr, metas, [_bsr_layout(k) for k in keys]


def _bsr_part_nbytes(layouts: list, bs: int) -> int:
    """A strip's summed blocks as they cross: the most blocks of a strip."""
    return max([1] + [keys.size for keys, _ in layouts]) * bs * bs * 4


def _bsr_run_placed(A: CSR, B: CSR, plan: ChunkPlan, c_pad: int, caps,
                    placement, device: torch.device):
    """:func:`chunk_bsr` with operands in slow memory: :func:`_bsr_placed`
    of the one instance at its block-capped envelope, through the
    module's cores."""
    env = instance_envelope(A, B, plan, c_pad=c_pad, caps=caps,
                            block_size=_BSR_DEFAULT_BLOCK)
    Cs, stats = _bsr_placed([A], [B], plan, env, _BSR_CORES, placement, device)
    return Cs[0], stats


def _unfolded_slots(slots: list, cap: int) -> np.ndarray:
    """One launch's slot table over the instances' pieces side by side
    (``cap + 1`` blocks each, its zero sentinel last): instance ``w``'s
    slots moved past the pieces before it, and its sentinel slot sent to
    the last block, the one the kernel skips. Width 1 is the instance's
    own table."""
    last = len(slots) * (cap + 1) - 1
    return np.concatenate([np.where(t == cap, last, t + w * (cap + 1))
                           for w, t in enumerate(slots)]).astype(np.int32)


def _bsr_placed(As, Bs, plan: ChunkPlan, env: GeometryEnvelope, cores: dict, placement,
                device: torch.device):
    """The ``bsr`` executor with operands in slow memory, over a batch.

    A slow operand's BSR pieces are built by :func:`_stage_bsr` from its
    pinned CSR on the host (no densify step), each instance's pieces of one
    pair (A) or chunk (B) stacked side by side with their zero sentinels,
    in pinned memory; a fast one's on ``device``. They stream through the
    ring as 3-field pieces ``(indptr, indices, blocks)``, one launch of
    ``bsr_spgemm_blocks`` a pair for the whole batch, over slot tables that
    reach every instance's blocks in place (:func:`_unfolded_slots`, the
    fold of :func:`_fold_bsr` without its copy). Each instance's output
    blocks are summed into its strip's blocks on the card (:func:`_bsr_add`),
    and a strip whose pairs have all run becomes its CSR there
    (:func:`_bsr_strip_csr`). A slow C crosses as :func:`planned_events_bsr`
    lists, times the width: in the chunk1 orders each strip's CSR once; in
    Chunk2 each strip's summed blocks out and back between chunks, then its
    CSR. Every C equals the all-fast call's bit for bit, in pinned host
    memory when C is slow; the ChunkStats are :func:`chunk_bsr`'s."""
    bs, nbl_a, nbl_b, nc_cap, _ = env.bsr_caps
    card = device.type == "cuda"
    width, n = len(As), Bs[0].n_cols
    nbp = -(-n // bs)
    strips = list(zip(plan.p_ac[:-1], plan.p_ac[1:]))
    n_ac, n_b = len(strips), plan.n_b
    chunk2 = plan.algorithm == "chunk2"
    staged = [_bsr_stage_placed(A, B, plan, env) for A, B in zip(As, Bs)]
    pairs = staged[0][0]
    metas = [st[3] for st in staged]
    layouts = [st[4] for st in staged]
    n_part = max(_bsr_part_nbytes(lay, bs) for lay in layouts) // (bs * bs * 4)

    def piece(ms):   # the instances' pieces of one element, side by side
        return BsrPiece(torch.stack([m.block_indptr for m in ms]),
                        torch.stack([m.block_indices for m in ms]),
                        torch.stack([bsr_blocks_with_sentinel(m) for m in ms]))

    Bst = copy_ring.staged([piece([st[2][jb] for st in staged]) for jb in range(n_b)],
                           placement.B, card)
    Ast = copy_ring.staged([piece([st[1][p] for st in staged]) for p in range(len(pairs))],
                           placement.A, card)
    del staged
    dtype = As[0].dtype
    c_slow = placement.C == "slow"
    c_out = (copy_ring.slow_stack(_empty_c_stack(width, env.strip_rows, n, env.c_pad, dtype,
                                                 "cpu"), n_ac, card) if c_slow else None)
    c_parts = (copy_ring.slow_stack(torch.empty(width, n_part, bs, bs), n_ac, card)
               if c_slow and chunk2 and n_b > 1 else None)
    link = copy_ring.Link(device)
    get_a, put_a = copy_ring.source(link, "A", Ast, placement.A, "streamed",
                                    range(len(pairs)))
    get_b, put_b = copy_ring.source(link, "B", Bst, placement.B,
                                    "stationary" if chunk2 else "streamed",
                                    range(n_b) if chunk2 else [jb for _, jb in pairs])
    core = cores[plan.algorithm]
    acc, out = [None] * n_ac, [None] * n_ac
    seen = [0] * n_ac          # a strip's pairs run so far
    for p, (ia, jb) in enumerate(pairs):
        b_lin = jb if chunk2 else p
        if not chunk2 or ia == 0:
            b_piece = get_b(b_lin)
        if acc[ia] is None:
            acc[ia] = (link.copy_in("C", copy_ring.piece(c_parts, ia))   # partial back in
                       if c_slow and jb > 0 else
                       torch.zeros(width, n_part, bs, bs, dtype=torch.float32, device=device))
        with link.step():   # the slot tables and output blocks live for the step
            slots = [torch.from_numpy(_unfolded_slots([m[p].a_slots for m in metas], nbl_a)),
                     torch.from_numpy(_unfolded_slots([m[p].b_slots for m in metas], nbl_b))]
            blocks = core(get_a(p).blocks.view(-1, bs, bs), b_piece.blocks.view(-1, bs, bs),
                          *(t.to(device) for t in slots),
                          envelope=env).view(width, nc_cap, bs, bs)
            for w in range(width):
                _bsr_add(acc[ia][w], layouts[w][ia][1][seen[ia]],
                         blocks[w, :metas[w][p].n_c_blocks])
            del blocks, slots
        seen[ia] += 1
        put_a(p)
        if not chunk2 or ia == n_ac - 1:
            put_b(b_lin)
        if jb == n_b - 1:                  # the strip's last pair: its CSRs
            s, e = strips[ia]
            with link.step():
                Ci = [_bsr_strip_csr(acc[ia][w], layouts[w][ia][0], e - s, env.strip_rows,
                                     n, bs, nbp, dtype, env.c_pad if c_slow else None)
                      for w in range(width)]
            acc[ia] = None
            if c_slow:
                link.copy_out("C", [tuple(torch.stack(f) for f in zip(
                    *(copy_ring.fields(c) for c in Ci)))], c_out, first=ia)
            else:
                out[ia] = Ci
        elif c_slow and chunk2:            # the strip's partial out
            link.copy_out("C", [acc[ia]], c_parts, first=ia)
            acc[ia] = None
    link.finish()
    if c_slow:
        out = [csr_unstack(copy_ring.piece(c_out, i)) for i in range(n_ac)]
    Cs = []
    for w in range(width):
        C = _assemble([strip[w] for strip in out], plan.p_ac, n)
        Cs.append(csr_pin(C) if c_slow and card else C)
    return Cs, planned_stats_pallas(plan, *_bsr_stage_nbytes(env))


# ---------------------------------------------------------------------------
# batched entry point: many problem instances, one plan, one kernel call
# ---------------------------------------------------------------------------


def _stage_chunks_batched(Bs, plan: ChunkPlan, envelope: GeometryEnvelope):
    """Every instance's B chunks repadded to the envelope and doubly stacked
    ([batch, n_b, ...]); returns the stack and one staged chunk's bytes."""
    chunk_lists = [b_chunks(B, plan.p_b, envelope=envelope) for B in Bs]
    return (csr_stack([csr_stack(cl) for cl in chunk_lists]),
            chunk_lists[0][0].nbytes())


def _stage_strips_batched(As, plan: ChunkPlan, envelope: GeometryEnvelope):
    """Every instance's A strips repadded to the envelope and doubly stacked
    ([batch, n_ac, ...]); returns the stack and one staged strip's bytes."""
    strip_lists = [a_strips(A, plan.p_ac, envelope=envelope) for A in As]
    return (csr_stack([csr_stack(sl) for sl in strip_lists]),
            strip_lists[0][0].nbytes())


def _stage_whole_a_batched(As, envelope: GeometryEnvelope) -> CSR:
    """Every whole A (the knl operand) repadded to the envelope, stacked."""
    return csr_stack([csr_pad_to(A, nnz_cap=envelope.a_nnz_cap,
                                 max_row_nnz=envelope.a_max_row_nnz) for A in As])


def _scan_run_batched(As, Bs, plan: ChunkPlan, envelope: GeometryEnvelope, *,
                      caps_list=None, validate_caps: bool = True,
                      cores: dict | None = None):
    """Batched entry of the scan backend: equal bit for bit to the unbatched
    executors on same-structure batches. ``cores`` substitutes a
    caller-owned set from the spec's ``make_batched_cores``."""
    del caps_list, validate_caps  # the ranged merge cannot overflow c_pad
    if cores is None:
        cores = _SCAN_CORES_BATCHED
    c_pad = envelope.c_pad
    r0s, r1s = plan.b_ranges()
    n_cols = Bs[0].n_cols
    dtype, dev = As[0].dtype, As[0].device
    Bst, chunk_nbytes = _stage_chunks_batched(Bs, plan, envelope)
    if plan.algorithm == "knl":
        C0s = _empty_c_stack(len(As), envelope.a_shape[0], n_cols, c_pad, dtype, dev)
        Cs = cores["knl"](_stage_whole_a_batched(As, envelope), Bst, r0s, r1s, C0s,
                          c_pad=c_pad)
        return Cs, planned_stats(plan, chunk_nbytes, 0, 0)
    Ast, strip_nbytes = _stage_strips_batched(As, plan, envelope)
    strip_rows = envelope.strip_rows
    stats = planned_stats(plan, chunk_nbytes, strip_nbytes,
                          _c_strip_nbytes(strip_rows, c_pad, dtype))
    if plan.algorithm == "chunk1":
        C0 = _empty_like_c(strip_rows, n_cols, c_pad, dtype, dev)
    else:
        C0 = _empty_c_stack(plan.n_ac, strip_rows, n_cols, c_pad, dtype, dev)
    out = cores[plan.algorithm](Ast, Bst, r0s, r1s, C0, c_pad=c_pad)
    return [_assemble(strips, plan.p_ac, n_cols) for strips in out], stats


def _pallas_run_batched(As, Bs, plan: ChunkPlan, envelope: GeometryEnvelope, *,
                        caps_list=None, validate_caps: bool = True,
                        cores: dict | None = None):
    """Batched entry of the dense-slab backend: the whole batch through one
    ``ranged_spgemm_stream`` call whose leading axis is the batch (staging
    and accumulation in f32: allclose, not bitwise, against the loop
    oracle)."""
    del caps_list, validate_caps  # dense accumulators cannot overflow
    if cores is None:
        cores = _PALLAS_CORES_BATCHED
    r0s, _ = plan.b_ranges()
    n_cols = Bs[0].n_cols
    Bst, _ = _stage_chunks_batched(Bs, plan, envelope)
    if plan.algorithm == "knl":
        dense = cores["knl"](_stage_whole_a_batched(As, envelope), Bst, r0s)
        stats = planned_stats_pallas(plan, *_pallas_stage_nbytes(
            envelope.a_shape[0], envelope.a_shape[1], envelope.chunk_rows, n_cols))
        return [csr_from_dense(d, device=d.device) for d in dense], stats
    Ast, _ = _stage_strips_batched(As, plan, envelope)
    dense = cores[plan.algorithm](Ast, Bst, r0s)
    stats = planned_stats_pallas(plan, *_pallas_stage_nbytes(
        envelope.strip_rows, envelope.a_shape[1], envelope.chunk_rows, n_cols))
    return [_pallas_assemble(d, plan.p_ac) for d in dense], stats


def _csr_accum_statics(As, Bs, plan: ChunkPlan, envelope: GeometryEnvelope, kind: str,
                       caps_list, validate_caps: bool) -> dict:
    """The batched CSR-accumulator core's static (``table_size`` or
    ``row_cap``), after checking every instance's exact output structure
    against the envelope's capacities when ``validate_caps``."""
    # the row width is a static of the core, so it derives from the envelope
    # alone: a zero c_max_row_nnz is exact when the symbolic phase ran (then
    # c_nnz_cap is nonzero); only an envelope with neither falls back to the
    # always-valid n_cols
    row_cap = envelope.c_max_row_nnz if envelope.c_nnz_cap else Bs[0].n_cols
    table = hash_table_slots(row_cap) if kind == "hash" else None
    if validate_caps:
        if caps_list is None:
            caps_list = [strip_output_caps(A, B, plan.p_ac) for A, B in zip(As, Bs)]
        for i, (A, B, caps) in enumerate(zip(As, Bs, caps_list)):
            check_output_caps(caps.strip_nnz, caps.c_max_row_nnz, envelope.c_pad, table,
                              backend=kind, a_shape=A.shape, b_shape=B.shape,
                              instance=i)
    return {"table_size": table} if kind == "hash" else {"row_cap": row_cap}


def _csr_accum_run_batched(As, Bs, plan: ChunkPlan, envelope: GeometryEnvelope,
                           kind: str, *, caps_list=None, validate_caps: bool = True,
                           cores: dict | None = None):
    """Shared batched entry of the CSR-output accumulators (ESC and hash):
    one kernel call, the batch on the stacks' leading axis, into CSR scratch
    sized by the envelope.

    ``validate_caps`` checks every instance's exact output structure against
    the envelope's capacities and raises a ``ValueError`` naming the
    instance on overflow. Callers whose envelopes dominate the instances by
    construction (the serving layer) pass ``False`` to skip the host
    symbolic expansion it costs; callers that already ran it pass
    ``caps_list``."""
    c_pad = envelope.c_pad
    n_cols = Bs[0].n_cols
    dtype, dev = As[0].dtype, As[0].device
    statics = _csr_accum_statics(As, Bs, plan, envelope, kind, caps_list, validate_caps)
    r0s, r1s = plan.b_ranges()
    Bst, chunk_nbytes = _stage_chunks_batched(Bs, plan, envelope)
    # knl is the 1-strip special case (p_ac == (0, n_rows)): every
    # algorithm stages strips
    Ast, strip_nbytes = _stage_strips_batched(As, plan, envelope)
    strip_rows = envelope.strip_rows
    C0 = _sparse_c0_stack(len(As), plan.n_ac, strip_rows, n_cols, c_pad, dtype, dev)
    if cores is None:
        cores = _HASH_CORES_BATCHED if kind == "hash" else _SPARSE_CORES_BATCHED
    ip, ix, d = cores[plan.algorithm](Ast, Bst, C0, r0s, r1s, **statics)
    stats = planned_stats_pallas(plan, chunk_nbytes, strip_nbytes,
                                 _c_strip_nbytes(strip_rows, c_pad, dtype))
    return [_assemble([CSR(ip[b, i], ix[b, i], d[b, i], (strip_rows, n_cols), c_pad)
                       for i in range(plan.n_ac)], plan.p_ac, n_cols)
            for b in range(len(As))], stats


def _sparse_run_batched(As, Bs, plan, envelope, *, caps_list=None,
                        validate_caps=True, cores=None):
    return _csr_accum_run_batched(As, Bs, plan, envelope, "sparse",
                                  caps_list=caps_list,
                                  validate_caps=validate_caps, cores=cores)


def _hash_run_batched(As, Bs, plan, envelope, *, caps_list=None,
                      validate_caps=True, cores=None):
    return _csr_accum_run_batched(As, Bs, plan, envelope, "hash",
                                  caps_list=caps_list,
                                  validate_caps=validate_caps, cores=cores)


def _bsr_run_batched(As, Bs, plan, envelope, *, caps_list=None,
                     validate_caps=True, cores=None):
    """Batched entry of the BSR backend: one launch per (strip, chunk) pair
    for the whole batch. Cap overflow is caught by the per-pair block
    symbolic itself (``bsr_spgemm_symbolic`` raises when the envelope's
    floors do not dominate an instance), so there is no validation to
    skip."""
    del caps_list, validate_caps
    if not envelope.bsr_caps:
        raise ValueError(
            "backend 'bsr' needs a block-capped envelope; rebuild it with "
            "batch_envelope(..., block_size=...)")
    return _bsr_execute(As, Bs, plan, envelope,
                        _BSR_CORES_BATCHED if cores is None else cores)


# ---------------------------------------------------------------------------
# the batched entry point with operands in slow memory: one ring for the batch
# ---------------------------------------------------------------------------


def _batch_pieces(lists: list, space: str, card: bool) -> CSR:
    """The instances' pieces (a list each, all of one geometry) as one
    stack of elements ``[n, width, ...]``, an element being the instances'
    pieces of one strip or chunk side by side: pinned when ``space`` is
    slow on the card, else where the pieces are."""
    return copy_ring.staged([csr_stack(ps) for ps in zip(*lists)], space, card)


def _col(m: CSR) -> CSR:
    """A ``[width, ...]`` piece as a one-strip stack ``[width, 1, ...]``
    (views)."""
    return CSR(m.indptr[:, None], m.indices[:, None], m.data[:, None], m.shape,
               m.max_row_nnz)


def _unbatch(out: list, p_ac: tuple, n_cols: int, pin: bool) -> list:
    """Each instance's C from the strips' ``[width, ...]`` results."""
    Cs = []
    for w in range(out[0].indptr.shape[0]):
        C = _assemble([CSR(o.indptr[w], o.indices[w], o.data[w], o.shape, o.max_row_nnz)
                       for o in out], p_ac, n_cols)
        Cs.append(csr_pin(C) if pin else C)
    return Cs


def _staged_batch(As, Bs, plan: ChunkPlan, envelope: GeometryEnvelope, placement,
                  card: bool) -> tuple:
    """``(Ast, Bst, a_stage, slab)``: every instance's envelope-padded
    strips and chunks as :func:`_batch_pieces` stacks, each in its
    operand's space, and one instance's strip and chunk bytes."""
    strips = [a_strips(A, plan.p_ac, envelope=envelope) for A in As]
    chunks = [b_chunks(B, plan.p_b, envelope=envelope) for B in Bs]
    a_stage, slab = strips[0][0].nbytes(), chunks[0][0].nbytes()
    return (_batch_pieces(strips, placement.A, card),
            _batch_pieces(chunks, placement.B, card), a_stage, slab)


def _c0_block(plan: ChunkPlan, width: int, strip_rows: int, n_cols: int, c_pad: int,
              dtype, c_slow: bool, device, card: bool, empty=_sparse_c0_stack) -> CSR:
    """The empty C_prev of a batch in C's space: one strip's block a
    ring element (the chunk1 orders), or all strips' block (Chunk2).
    ``empty(k, width, ...)`` builds it (:func:`_sparse_c0_stack` at the CSR
    scratch capacity, or the scan's :func:`_empty_c_stack`)."""
    k = plan.n_ac if plan.algorithm == "chunk2" else 1
    zeros = empty(k, width, strip_rows, n_cols, c_pad, dtype, "cpu" if c_slow else device)
    return csr_pin(zeros) if c_slow and card else zeros


def _csr_accum_run_batched_placed(As, Bs, plan: ChunkPlan, envelope: GeometryEnvelope,
                                  kind: str, *, caps_list=None, validate_caps: bool = True,
                                  cores: dict | None = None, placement, device):
    """:func:`_csr_accum_run_batched` with operands in slow memory: each
    slow operand's envelope-padded strips or chunks built in pinned memory
    (a fast one's on ``device``), one element a (strip or chunk) of the
    whole batch, and the step loop of :func:`_sparse_run_placed`
    (:func:`_drive_placed`): one launch a (strip, chunk) step serves every
    instance, the batch on the stacks' leading axis. The ring moves each
    slow operand's :func:`planned_events` times the width. Every C equals
    the all-fast batched call's bit for bit, in pinned host memory when C
    is slow; the ChunkStats are the same."""
    statics = _csr_accum_statics(As, Bs, plan, envelope, kind, caps_list, validate_caps)
    card = device.type == "cuda"
    c_pad, n_cols, dtype = envelope.c_pad, Bs[0].n_cols, As[0].dtype
    strip_rows = envelope.strip_rows
    Ast, Bst, a_stage, slab = _staged_batch(As, Bs, plan, envelope, placement, card)
    if cores is None:
        cores = _HASH_CORES_BATCHED if kind == "hash" else _SPARSE_CORES_BATCHED
    core = cores[plan.algorithm]
    r0s, r1s = plan.b_ranges()
    c_slow = placement.C == "slow"
    zeros = _c0_block(plan, len(As), strip_rows, n_cols, c_pad, dtype, c_slow, device, card)
    link = copy_ring.Link(device)

    def launch(Ai, Bj, Ci, _, j):
        with link.step():
            ip, ix, d = core(_col(Ai), _col(Bj), _col(Ci), r0s[j:j + 1], r1s[j:j + 1],
                             **statics)
        return CSR(ip[:, 0], ix[:, 0], d[:, 0], (strip_rows, n_cols), c_pad)

    out = _drive_placed(link, plan, placement, Ast, Bst, zeros, launch, card)
    stats = planned_stats_pallas(plan, slab, a_stage,
                                 _c_strip_nbytes(strip_rows, c_pad, dtype))
    return _unbatch(out, plan.p_ac, n_cols, c_slow and card), stats


def _scan_run_batched_placed(As, Bs, plan: ChunkPlan, envelope: GeometryEnvelope, *,
                             caps_list=None, validate_caps: bool = True,
                             cores: dict | None = None, placement, device):
    """:func:`_scan_run_batched` with operands in slow memory: the
    envelope-padded strips and chunks streamed as the CSR accumulators
    stream them (:func:`_drive_placed`, the pieces of the whole batch an
    element), each step one call of the batched ``knl`` core (one ranged
    multiply-add of every instance, from its own C_prev). Every C equals
    the all-fast batched call's bit for bit (under Algorithm 1 each is the
    one strip's C itself); the ChunkStats are the same."""
    del caps_list, validate_caps   # the ranged merge cannot overflow c_pad
    core = (_SCAN_CORES_BATCHED if cores is None else cores)["knl"]
    card = device.type == "cuda"
    c_pad, n_cols, dtype = envelope.c_pad, Bs[0].n_cols, As[0].dtype
    strip_rows = envelope.strip_rows
    Ast, Bst, a_stage, slab = _staged_batch(As, Bs, plan, envelope, placement, card)
    r0s, r1s = plan.b_ranges()
    c_slow = placement.C == "slow"
    zeros = _c0_block(plan, len(As), strip_rows, n_cols, c_pad, dtype, c_slow, device, card,
                      empty=lambda k, w, *rest: _empty_c_stack((k, w), *rest))
    link = copy_ring.Link(device)

    def launch(Ai, Bj, Ci, _, j):
        with link.step():
            return csr_stack(core(Ai, _col(Bj), r0s[j:j + 1], r1s[j:j + 1], Ci, c_pad=c_pad))

    out = _drive_placed(link, plan, placement, Ast, Bst, zeros, launch, card)
    if plan.algorithm == "knl":
        return (csr_unstack(out[0]), planned_stats(plan, slab, 0, 0))
    stats = planned_stats(plan, slab, a_stage, _c_strip_nbytes(strip_rows, c_pad, dtype))
    return _unbatch(out, plan.p_ac, n_cols, c_slow and card), stats


def _pallas_run_batched_placed(As, Bs, plan: ChunkPlan, envelope: GeometryEnvelope, *,
                               caps_list=None, validate_caps: bool = True,
                               cores: dict | None = None, placement, device):
    """:func:`_pallas_run_batched` with operands in slow memory: each slow
    operand's dense pieces built in pinned memory (a fast one's on
    ``device``): the A strips with their ``span`` zero columns, the B slabs
    and the empty C block, an element the pieces of the whole batch. The
    step loop (:func:`_drive_placed`) launches ``ranged_spgemm_stream`` once
    a (strip, chunk) step for every instance. The kernel writes C as base
    plus partial, chunk by chunk, in both orders, so every C equals the
    all-fast batched call's bit for bit; the bytes are
    :func:`planned_events` at the dense sizes (:func:`_pallas_stage_nbytes`).
    A slow C goes out to pinned memory as dense strips and is sparsified
    there; the result stays pinned."""
    del caps_list, validate_caps, cores   # dense accumulators cannot overflow
    card = device.type == "cuda"
    width, n_cols = len(As), Bs[0].n_cols
    order = "chunk2" if plan.algorithm == "chunk2" else "chunk1"
    r0s, _ = plan.b_ranges()

    def dense(lists, pad_cols, space):
        return _dense_stack(csr_stack([csr_stack(ps) for ps in zip(*lists)]), levels=2,
                            pad_cols=pad_cols, pin_memory=card and space == "slow")

    slabs = dense([b_chunks(B, plan.p_b, envelope=envelope) for B in Bs], 0, placement.B)
    a = dense([a_strips(A, plan.p_ac, envelope=envelope) for A in As],
              envelope.chunk_rows, placement.A)
    strip_rows = envelope.strip_rows
    c_slow = placement.C == "slow"
    zeros = torch.zeros(plan.n_ac if order == "chunk2" else 1, width, strip_rows, n_cols,
                        dtype=torch.float32, device="cpu" if c_slow else device,
                        pin_memory=card and c_slow)
    link = copy_ring.Link(device)

    def launch(a_i, slab_j, c_i, _, j):
        with link.step():
            return ranged_spgemm_stream(a_i[:, None], slab_j[:, None], c_i[:, None],
                                        r0s[j:j + 1], order=order)[:, 0]

    out = _drive_placed(link, plan, placement, a, slabs, zeros, launch, card)
    del a, slabs
    Cs = []
    for w in range(width):
        C = _pallas_assemble([o[w] for o in out], plan.p_ac)
        Cs.append(csr_pin(C) if c_slow and card else C)
    return Cs, planned_stats_pallas(plan, *_pallas_stage_nbytes(
        strip_rows, envelope.a_shape[1], envelope.chunk_rows, n_cols))


def _bsr_run_batched_placed(As, Bs, plan, envelope, *, caps_list=None, validate_caps=True,
                            cores=None, placement, device):
    """:func:`_bsr_run_batched` with operands in slow memory
    (:func:`_bsr_placed`): one launch a (strip, chunk) pair for the whole
    batch."""
    del caps_list, validate_caps
    if not envelope.bsr_caps:
        raise ValueError(
            "backend 'bsr' needs a block-capped envelope; rebuild it with "
            "batch_envelope(..., block_size=...)")
    return _bsr_placed(As, Bs, plan, envelope, _BSR_CORES_BATCHED if cores is None else cores,
                       placement, device)


def chunked_spgemm_batched(As, Bs, plan: ChunkPlan, c_pad: int | None = None,
                           envelope: GeometryEnvelope | None = None,
                           backend: str = "scan", validate_caps: bool = True,
                           cores: dict | None = None, *, placement=None, device=None,
                           slow_reads: str = "ring"):
    """Run a backend's batched entry over problem instances sharing one plan.

    Instances must share shapes and dtype but may differ in sparsity
    *structure*: every instance's chunks and strips are repadded to a shared
    :class:`GeometryEnvelope` (by default the batch's union envelope, or a
    caller-provided one, e.g. a serving bucket's) before stacking, so one
    core geometry serves the whole batch. Same-structure batches repad to
    their own geometry, which keeps the scan backend's results equal bit for
    bit to the unbatched executors'.

    ``backend`` names any registered spec with a batched entry
    (``backend_registry.batched_backends()``) or ``"auto"``, which resolves
    to the accumulator whose planner byte model is smallest under the batch
    envelope (``select_accumulator_backend``). Backends with
    ``needs_block_caps`` (``"bsr"``) get a block-capped default envelope at
    the spec's ``block_size``; a caller-provided envelope must carry block
    caps for them. ``validate_caps`` is forwarded to the spec (see
    ``_csr_accum_run_batched``). ``cores`` substitutes a caller-owned core
    set (from the spec's ``make_batched_cores``) for the module-level one.

    ``placement`` and ``device`` are ``chunked_spgemm``'s
    (``placement.resolve_batch_placement``): ``device=None`` is the card,
    ``device="cpu"`` runs the plain versions; the instances share one
    placement, and a batch whose operands lie in different spaces raises.
    With a slow operand the spec's ``run_batched_placed`` builds its
    envelope-padded stacks in slow memory and the copy ring moves one
    (strip, chunk) step's pieces of the whole batch at a time, one launch a
    step for every instance; a slow C comes back in pinned host memory.
    ``slow_reads="in_place"`` (``chunked_spgemm``'s) reads the slow stacks
    where they lie instead: the spec's ``run_batched_in_place`` launches its
    streaming kernel once a strip of the plan for the whole batch (``pallas``,
    ``sparse``, ``hash``, and ``auto`` resolving to one of them; another
    backend raises).

    Returns ``(list_of_C, stats)``; ``stats`` is one instance's modeled copy
    accounting at the envelope-padded staged sizes (the same for every
    instance by construction).
    """
    from repro_torch.core.placement import ALL_FAST, resolve_batch_placement

    if slow_reads not in SLOW_READS:
        raise ValueError(f"slow_reads must be one of {SLOW_READS}, not {slow_reads!r}")
    in_place = slow_reads == "in_place"
    As, Bs = list(As), list(Bs)
    if len(As) != len(Bs) or not As:
        raise ValueError("need equal, nonzero numbers of A and B instances")
    if plan.algorithm not in backend_registry.ALGORITHMS:
        raise ValueError(f"unsupported algorithm {plan.algorithm!r}")
    spec = None if backend == "auto" else backend_registry.get(backend)
    if spec is not None and not spec.supports_batched:
        raise ValueError(f"backend {backend!r} does not support batched execution")
    if in_place and spec is not None and spec.run_batched_in_place is None:
        raise in_place_refusal(f"backend {backend!r} has no such kernel")
    for A, B in zip(As, Bs):
        if A.shape != As[0].shape or B.shape != Bs[0].shape:
            raise ValueError(
                "batched instances must share shapes: "
                f"{A.shape}x{B.shape} vs {As[0].shape}x{Bs[0].shape}")
    for ms in (As, Bs):
        devices = sorted({str(m.device) for m in ms})
        if len(devices) > 1:
            raise ValueError(f"batched instances must share a device, got {devices}")
    placement, run_device = resolve_batch_placement(As, Bs, placement, device)
    caps_list = None
    if envelope is None:
        # the per-instance symbolic expansions feeding the union envelope are
        # exactly what cap validation needs: run them once
        caps_list = [strip_output_caps(A, B, plan.p_ac) for A, B in zip(As, Bs)]
        block = spec.block_size if spec is not None and spec.needs_block_caps else None
        envelope = batch_envelope(As, Bs, plan, c_pad=c_pad, caps_list=caps_list,
                                  block_size=block)
    elif c_pad is not None and c_pad != envelope.c_pad:
        raise ValueError(f"conflicting c_pad={c_pad} vs envelope.c_pad={envelope.c_pad}")
    if envelope.a_shape != As[0].shape or envelope.b_shape != Bs[0].shape:
        raise ValueError(
            f"envelope shapes {envelope.a_shape}x{envelope.b_shape} do not "
            f"match instances {As[0].shape}x{Bs[0].shape}")
    if spec is None:
        spec = backend_registry.get(select_accumulator_backend(plan, envelope))
        if in_place and spec.run_batched_in_place is None:
            raise in_place_refusal(f"backend 'auto' resolves to {spec.name!r}, which "
                                   "has no such kernel")
    if spec.needs_block_caps and not envelope.bsr_caps:
        raise ValueError(
            f"backend {spec.name!r} needs a block-capped envelope; rebuild it "
            "with batch_envelope(..., block_size=...)")
    if in_place:
        return spec.run_batched_in_place(As, Bs, plan, envelope, caps_list=caps_list,
                                         validate_caps=validate_caps, cores=cores,
                                         placement=placement, device=run_device)
    if placement == ALL_FAST:
        return spec.run_batched(As, Bs, plan, envelope, caps_list=caps_list,
                                validate_caps=validate_caps, cores=cores)
    if spec.run_batched_placed is None:
        raise ValueError(
            f"backend {spec.name!r} registers no batched copy ring (run_batched_placed) "
            f"for operands in slow memory ({placement}): put the operands on the card "
            "with place(x, 'fast')")
    return spec.run_batched_placed(As, Bs, plan, envelope, caps_list=caps_list,
                                   validate_caps=validate_caps, cores=cores,
                                   placement=placement, device=run_device)


# ---------------------------------------------------------------------------
# audit staging: TraceTargets for the static auditor (repro_torch.analysis)
# ---------------------------------------------------------------------------
#
# Each helper stages one instance at an explicit GeometryEnvelope (exactly
# the envelope-driven padding the batched executors perform) and binds the
# statics into the backend's core, so ``fn(*args)`` runs the very launch the
# executors make. Two same-envelope instances must therefore stage to one
# static geometry (the retrace contract); the staged launch is also what the
# shared-memory and traffic audits read.


def _audit_scan(A: CSR, B: CSR, plan: ChunkPlan, c_pad: int,
                envelope: GeometryEnvelope):
    Bst = csr_stack(b_chunks(B, plan.p_b, envelope=envelope))
    r0s, r1s = plan.b_ranges()
    if plan.algorithm == "knl":
        Ast = csr_pad_to(A, nnz_cap=envelope.a_nnz_cap,
                         max_row_nnz=envelope.a_max_row_nnz)
        C0 = _empty_like_c(A.n_rows, B.n_cols, c_pad, A.dtype, A.device)
    else:
        Ast = csr_stack(a_strips(A, plan.p_ac, envelope=envelope))
        strip_rows = envelope.strip_rows
        if plan.algorithm == "chunk1":
            C0 = _empty_like_c(strip_rows, B.n_cols, c_pad, A.dtype, A.device)
        else:
            C0 = _empty_c_stack(plan.n_ac, strip_rows, B.n_cols, c_pad, A.dtype,
                                A.device)
    return backend_registry.TraceTarget(
        fn=partial(_SCAN_CORES[plan.algorithm], c_pad=c_pad),
        args=(Ast, Bst, r0s, r1s, C0))


def _audit_pallas(A: CSR, B: CSR, plan: ChunkPlan, c_pad: int,
                  envelope: GeometryEnvelope):
    del c_pad  # capacity is implicit in the dense accumulator
    Bst = csr_stack(b_chunks(B, plan.p_b, envelope=envelope))
    r0s, _ = plan.b_ranges()
    if plan.algorithm == "knl":
        Ast = csr_pad_to(A, nnz_cap=envelope.a_nnz_cap,
                         max_row_nnz=envelope.a_max_row_nnz)
    else:
        Ast = csr_stack(a_strips(A, plan.p_ac, envelope=envelope))
    return backend_registry.TraceTarget(
        fn=partial(_PALLAS_CORES[plan.algorithm]), args=(Ast, Bst, r0s),
        meta={"scalar_args": (r0s,)})


def _make_audit_csr_accum(kind: str):
    """Audit staging shared by the ESC ("sparse") and hash backends — the
    doubly stacked width-1 staging of ``_sparse_run``, envelope-padded; the
    static (table or row width) derives from the envelope, as in the
    batched run."""

    def audit(A: CSR, B: CSR, plan: ChunkPlan, c_pad: int,
              envelope: GeometryEnvelope):
        Ast = csr_stack([csr_stack(a_strips(A, plan.p_ac, envelope=envelope))])
        Bst = csr_stack([csr_stack(b_chunks(B, plan.p_b, envelope=envelope))])
        r0s, r1s = plan.b_ranges()
        C0 = _sparse_c0_stack(1, plan.n_ac, envelope.strip_rows, B.n_cols, c_pad,
                              A.dtype, A.device)
        args = (Ast, Bst, C0, r0s, r1s)
        row_cap = envelope.c_max_row_nnz if envelope.c_nnz_cap else B.n_cols
        if kind == "hash":
            table = hash_table_slots(row_cap)
            return backend_registry.TraceTarget(
                fn=partial(_HASH_CORES[plan.algorithm], table_size=table), args=args,
                meta={"table_size": table, "scalar_args": (r0s, r1s)})
        return backend_registry.TraceTarget(
            fn=partial(_SPARSE_CORES[plan.algorithm], row_cap=row_cap), args=args,
            meta={"row_cap": row_cap, "scalar_args": (r0s, r1s)})

    return audit


def _audit_bsr(A: CSR, B: CSR, plan: ChunkPlan, c_pad: int,
               envelope: GeometryEnvelope):
    """Stage the first (strip, chunk) pair exactly as ``_bsr_execute`` does;
    every pair launches the same envelope-keyed kernel geometry, so one pair
    is the whole compile surface."""
    del c_pad
    _, operands, _ = next(stage_bsr_pairs(A, B, plan, envelope))
    a_slots, b_slots = operands[2], operands[3]
    return backend_registry.TraceTarget(
        fn=partial(_BSR_CORES[plan.algorithm], envelope=envelope), args=operands,
        meta={"scalar_args": (a_slots, b_slots)})


# ---------------------------------------------------------------------------
# traffic models: the per-copy-event byte flows the recorded launches must equal
# ---------------------------------------------------------------------------
#
# Each hook declares, per kernel operand and in operand order, the ordered
# list of copy-event byte sizes the staged launch performs: the planner-side
# half of the flow-equality audit (repro_torch.analysis.traffic), which
# records the same lists from the kernels' plain versions
# (kernels/copy_events.py) and demands exact equality, then ties the merged
# flows to the ChunkStats the executors log.


def _traffic_pallas(A, B, plan: ChunkPlan, c_pad: int, envelope: GeometryEnvelope, meta):
    """Dense-slab flows. knl/chunk1: the stationary strip and its C_prev
    block once a strip, the slab every step; chunk2 swaps the roles and
    keeps all C partials resident (one fetch, one write-back)."""
    del A, B, c_pad, meta
    OpFlow = backend_registry.OpFlow
    k, n = envelope.a_shape[1], envelope.b_shape[1]
    strip_rows = (envelope.a_shape[0] if plan.algorithm == "knl"
                  else envelope.strip_rows)
    slab, a_stage, c_stage = (
        float(v) for v in _pallas_stage_nbytes(strip_rows, k, envelope.chunk_rows, n))
    n_ac, n_b = plan.n_ac, plan.n_b
    if plan.algorithm in ("knl", "chunk1"):
        in_ops = (OpFlow("stationary", (a_stage,) * n_ac),
                  OpFlow("streamed", (slab,) * (n_ac * n_b)),
                  OpFlow("c_prev", (c_stage,) * n_ac))
        out_ops = (OpFlow("c_out", (c_stage,) * n_ac),)
    else:
        in_ops = (OpFlow("stationary", (slab,) * n_b),
                  OpFlow("streamed", (a_stage,) * (n_b * n_ac)),
                  OpFlow("c_prev", (n_ac * c_stage,)))
        out_ops = (OpFlow("c_out", (n_ac * c_stage,)),)
    st = planned_stats_pallas(plan, slab, a_stage, c_stage)
    return backend_registry.ExpectedTraffic(
        in_ops=in_ops, out_ops=out_ops,
        stats_in=tuple(st.per_copy_in), stats_out=tuple(st.per_copy_out))


def _traffic_csr_accum(A, B, plan: ChunkPlan, c_pad: int, envelope: GeometryEnvelope,
                       meta):
    """CSR-accumulator (ESC and hash) flows: every logical operand is three
    field operands (indptr, indices, data) whose per-event bytes sum to the
    staged triple's ``CSR.nbytes()``; same-key fields merge event-wise into
    the single ChunkStats event the executors log. knl stages as the
    1-strip chunk1 special case (see ``_sparse_run``)."""
    del A, B, meta
    OpFlow = backend_registry.OpFlow
    itemsize = int(np.dtype(envelope.dtype).itemsize)
    strip_f = csr_field_nbytes(envelope.strip_rows, envelope.strip_nnz_cap, itemsize)
    chunk_f = csr_field_nbytes(envelope.chunk_rows, envelope.chunk_nnz_cap, itemsize)
    c_f = csr_field_nbytes(envelope.strip_rows, c_pad, itemsize)
    n_ac, n_b = plan.n_ac, plan.n_b
    if plan.algorithm in ("knl", "chunk1"):
        stat_f, stream_f = strip_f, chunk_f
        n_stat, n_stream = n_ac, n_ac * n_b
        c_in = tuple(OpFlow("c_prev", (f,) * n_ac) for f in c_f)
        c_out = tuple(OpFlow("c_out", (f,) * n_ac) for f in c_f)
    else:
        stat_f, stream_f = chunk_f, strip_f
        n_stat, n_stream = n_b, n_b * n_ac
        c_in = tuple(OpFlow("c_prev", (n_ac * f,)) for f in c_f)
        c_out = tuple(OpFlow("c_out", (n_ac * f,)) for f in c_f)
    in_ops = (tuple(OpFlow("stationary", (f,) * n_stat) for f in stat_f)
              + tuple(OpFlow("streamed", (f,) * n_stream) for f in stream_f)
              + c_in)
    st = planned_stats_pallas(
        plan, int(sum(chunk_f)), int(sum(strip_f)),
        _c_strip_nbytes(envelope.strip_rows, c_pad, np.dtype(envelope.dtype)))
    return backend_registry.ExpectedTraffic(
        in_ops=in_ops, out_ops=c_out,
        stats_in=tuple(st.per_copy_in), stats_out=tuple(st.per_copy_out))


_BSR_STATS_EXEMPT = (
    "bsr executor stages per (strip, chunk) pair host-side; its "
    "ChunkStats model the idealized BSR pipeline, not the audited "
    "single-pair launch (documented in _bsr_execute)")


def _traffic_bsr(A, B, plan: ChunkPlan, c_pad: int, envelope: GeometryEnvelope, meta):
    """Blocked-kernel flows, replayed from the audited pair's slot tables: a
    ``bs x bs`` tile is fetched whenever the slot changes between
    consecutive grid steps (a resident block is reused where the step lands
    on the same slot), and each output block writes back once. The
    ChunkStats tie is exempt (``_BSR_STATS_EXEMPT``)."""
    del A, B, plan, c_pad
    OpFlow = backend_registry.OpFlow
    bs = envelope.bsr_caps[0]
    block_bytes = float(bs * bs * 4)
    a_slots = np.asarray(_to_numpy(meta["scalar_args"][0]))
    b_slots = np.asarray(_to_numpy(meta["scalar_args"][1]))

    def slot_flow(table):
        events, prev = [], None
        for val in table.reshape(-1):      # row-major == grid order (e, u)
            v = int(val)
            if prev is None or v != prev:
                events.append(block_bytes)
            prev = v
        return tuple(events)

    nc_pad = int(a_slots.shape[0])
    return backend_registry.ExpectedTraffic(
        in_ops=(OpFlow("a_blocks", slot_flow(a_slots)),
                OpFlow("b_blocks", slot_flow(b_slots))),
        out_ops=(OpFlow("c_blocks", (block_bytes,) * nc_pad),),
        stats_exempt=_BSR_STATS_EXEMPT)


def _to_numpy(value):
    return value.cpu().numpy() if isinstance(value, torch.Tensor) else value


# ---------------------------------------------------------------------------
# registrations (order = the planner's accumulator tie-break priority)
# ---------------------------------------------------------------------------


def _register_all() -> None:
    if "scan" in backend_registry._REGISTRY:   # tolerate importlib.reload
        return
    register, Spec = backend_registry.register, backend_registry.BackendSpec
    algs = backend_registry.ALGORITHMS
    register(Spec(
        name="loop",
        executors=dict.fromkeys(algs, chunk_loop),
        run_placed=chunk_loop,
    ))
    register(Spec(
        name="scan",
        executors={"knl": chunk_knl_scan, "chunk1": chunk_gpu1_scan,
                   "chunk2": chunk_gpu2_scan},
        run_batched=_scan_run_batched,
        trace_key="{alg}",
        trace_key_batched="{alg}_batched",
        audit_trace=_audit_scan,
        make_batched_cores=_batched_core_factory("{alg}_batched", _SCAN_RUNS_BATCHED),
        run_placed=_scan_run_placed,
        run_batched_placed=_scan_run_batched_placed,
    ))
    register(Spec(
        name="pallas",
        executors={"knl": chunk_knl_pallas, "chunk1": chunk_gpu1_pallas,
                   "chunk2": chunk_gpu2_pallas},
        run_batched=_pallas_run_batched,
        byte_model=planned_stats_dense_slab,
        trace_key="{alg}_pallas",
        trace_key_batched="{alg}_pallas_batched",
        is_accumulator=True,
        audit_trace=_audit_pallas,
        traffic_model=_traffic_pallas,
        make_batched_cores=_batched_core_factory("{alg}_pallas_batched",
                                                 _PALLAS_RUNS_BATCHED),
        run_placed=_pallas_run_placed,
        run_batched_placed=_pallas_run_batched_placed,
        run_in_place=_pallas_run_in_place,
        run_batched_in_place=_pallas_run_batched_in_place,
    ))
    register(Spec(
        name="sparse",
        executors=dict.fromkeys(algs, chunk_sparse),
        run_batched=_sparse_run_batched,
        byte_model=planned_stats_sparse,
        trace_key="{alg}_sparse",
        trace_key_batched="{alg}_sparse_batched",
        needs_output_caps=True,
        is_accumulator=True,
        audit_trace=_make_audit_csr_accum("sparse"),
        traffic_model=_traffic_csr_accum,
        make_batched_cores=_batched_core_factory("{alg}_sparse_batched", _SPARSE_RUNS),
        run_placed=partial(_sparse_run_placed, backend="sparse"),
        run_batched_placed=partial(_csr_accum_run_batched_placed, kind="sparse"),
        run_in_place=partial(_sparse_run_in_place, backend="sparse"),
        run_batched_in_place=partial(_csr_accum_run_in_place, kind="sparse"),
    ))
    register(Spec(
        name="hash",
        executors=dict.fromkeys(algs, chunk_hash),
        run_batched=_hash_run_batched,
        byte_model=planned_stats_hash,
        trace_key="{alg}_hash",
        trace_key_batched="{alg}_hash_batched",
        needs_output_caps=True,
        is_accumulator=True,
        run_masked=chunk_hash_masked,
        run_masked_placed=_masked_run_placed,
        run_masked_in_place=_masked_run_in_place,
        audit_trace=_make_audit_csr_accum("hash"),
        traffic_model=_traffic_csr_accum,
        make_batched_cores=_batched_core_factory("{alg}_hash_batched", _HASH_RUNS),
        run_placed=partial(_sparse_run_placed, backend="hash"),
        run_batched_placed=partial(_csr_accum_run_batched_placed, kind="hash"),
        run_in_place=partial(_sparse_run_in_place, backend="hash"),
        run_batched_in_place=partial(_csr_accum_run_in_place, kind="hash"),
    ))
    register(Spec(
        name="bsr",
        executors=dict.fromkeys(algs, chunk_bsr),
        run_batched=_bsr_run_batched,
        byte_model=planned_stats_bsr,
        trace_key="{alg}_bsr",
        trace_key_batched="{alg}_bsr_batched",
        needs_output_caps=True,
        needs_block_caps=True,
        is_accumulator=True,
        block_size=_BSR_DEFAULT_BLOCK,
        audit_trace=_audit_bsr,
        traffic_model=_traffic_bsr,
        stats_exempt=_BSR_STATS_EXEMPT,
        make_batched_cores=_batched_core_factory("{alg}_bsr_batched", _BSR_RUNS),
        run_placed=_bsr_run_placed,
        run_batched_placed=_bsr_run_batched_placed,
    ))


_register_all()
