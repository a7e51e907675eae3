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

``backend="auto"`` argmins the accumulators' ``BackendFastModel`` byte
models (``planner.select_accumulator_backend``).

ChunkStats for these backends is *computed from the plan*: the uniform
padding makes every staged chunk/strip/partial the same size, so the
per-copy event sequence is reproducible host-side. ``planned_stats`` replays
the loop executors' CSR-staging events; ``planned_stats_pallas`` replays the
streaming kernels' events (dense slabs for ``pallas``, padded CSR triples for
``sparse``/``hash``; Chunk2's C partials stay resident instead of bouncing to
slow memory).
"""

from __future__ import annotations

import torch

from repro_torch.core import backend_registry
from repro_torch.core.chunking import (
    StatsLog, _assemble, _empty_like_c, a_strips, b_chunks, chunk_gpu1,
    chunk_gpu2, chunk_knl,
)
from repro_torch.core.kkmem import spgemm_ranged_impl
from repro_torch.core.planner import (
    ChunkPlan, check_output_caps, hash_table_slots, planned_stats_dense_slab,
    planned_stats_hash, planned_stats_sparse,
)
from repro_torch.core.symbolic import strip_output_caps
from repro_torch.kernels.hash_accum_spgemm import hash_accum_spgemm_stream
from repro_torch.kernels.ranged_spgemm import ranged_spgemm_stream
from repro_torch.kernels.sparse_accum_spgemm import sparse_accum_spgemm_stream
from repro_torch.sparse.csr import CSR, csr_from_dense, csr_stack, csr_unstack


# ---------------------------------------------------------------------------
# plan-derived copy accounting
# ---------------------------------------------------------------------------


def planned_stats(plan: ChunkPlan, chunk_nbytes: int, strip_nbytes: int,
                  c_strip_nbytes: int):
    """Replay the loop executors' per-copy event sequence from the plan.

    Uniform padding makes every B chunk / A strip / C partial the same size,
    so the event stream is fully determined by (algorithm, n_ac, n_b) plus the
    three footprints.
    """
    stats = StatsLog(plan.algorithm, plan.n_ac, plan.n_b)
    if plan.algorithm == "knl":
        for _ in range(plan.n_b):
            stats.add_in(chunk_nbytes)
        stats.kernel_calls = plan.n_b
        return stats.freeze()
    if plan.algorithm == "chunk1":
        for a0, a1 in zip(plan.p_ac[:-1], plan.p_ac[1:]):
            stats.add_in(strip_nbytes)
            stats.add_in((a1 - a0 + 1) * 4)
            for _ in range(plan.n_b):
                stats.add_in(chunk_nbytes)
                stats.kernel_calls += 1
            stats.add_out(c_strip_nbytes)
        return stats.freeze()
    if plan.algorithm == "chunk2":
        for jb in range(plan.n_b):
            stats.add_in(chunk_nbytes)
            for _ in range(plan.n_ac):
                stats.add_in(strip_nbytes)
                if jb > 0:
                    stats.add_in(c_strip_nbytes)
                stats.kernel_calls += 1
                if jb < plan.n_b - 1:
                    stats.add_out(c_strip_nbytes)
            if jb == plan.n_b - 1:
                for _ in range(plan.n_ac):
                    stats.add_out(c_strip_nbytes)
        return stats.freeze()
    raise ValueError(f"unknown algorithm {plan.algorithm!r}")


def _c_strip_nbytes(strip_rows: int, c_pad: int, dtype) -> int:
    return (strip_rows + 1) * 4 + c_pad * (4 + dtype.itemsize)


def planned_stats_pallas(plan: ChunkPlan, slab_nbytes: int, a_stage_nbytes: int,
                         c_stage_nbytes: int):
    """Replay the streaming kernels' per-copy event sequence from the plan.

    It differs from :func:`planned_stats` in three ways: staged pieces are
    the kernel's own (dense slabs for ``pallas``, padded CSR triples for the
    CSR accumulators); the stationary operand is staged once per outer step
    and the streamed one once per step; and in the Chunk2 order the
    per-strip C partials stay resident, so the ``(n_b - 1)`` per-strip
    out+in bounces collapse into one whole-block ``C_prev`` fetch and one
    final writeback of ``n_ac * c_stage_nbytes`` each.
    """
    stats = StatsLog(plan.algorithm, plan.n_ac, plan.n_b)
    if plan.algorithm in ("knl", "chunk1"):
        for _ in range(plan.n_ac):           # knl is the 1-strip special case
            stats.add_in(a_stage_nbytes)     # stationary strip
            stats.add_in(c_stage_nbytes)     # fused C_prev block
            for _ in range(plan.n_b):
                stats.add_in(slab_nbytes)    # streamed chunk
                stats.kernel_calls += 1
            stats.add_out(c_stage_nbytes)    # strip result writeback
        return stats.freeze()
    if plan.algorithm == "chunk2":
        for jb in range(plan.n_b):
            stats.add_in(slab_nbytes)        # stationary chunk
            if jb == 0:
                stats.add_in(plan.n_ac * c_stage_nbytes)
            for _ in range(plan.n_ac):
                stats.add_in(a_stage_nbytes)       # streamed strip
                stats.kernel_calls += 1
        stats.add_out(plan.n_ac * c_stage_nbytes)
        return stats.freeze()
    raise ValueError(f"unknown algorithm {plan.algorithm!r}")


def _pallas_stage_nbytes(strip_rows: int, k: int, span: int, n: int) -> tuple:
    """(slab, a_stage, c_stage) dense staged footprints in bytes (f32)."""
    return span * n * 4, strip_rows * (k + span) * 4, strip_rows * n * 4


# ---------------------------------------------------------------------------
# scan backend: a device loop over the stacked pieces
# ---------------------------------------------------------------------------


def _ranges(plan: ChunkPlan) -> list:
    return list(zip(plan.p_b[:-1], plan.p_b[1:]))


def chunk_knl_scan(A: CSR, B: CSR, plan: ChunkPlan, c_pad: int):
    chunks = b_chunks(B, plan.p_b)
    Bs = csr_stack(chunks)
    C = _empty_like_c(A.n_rows, B.n_cols, c_pad, A.dtype, A.device)
    for Bc, (r0, r1) in zip(csr_unstack(Bs), _ranges(plan)):
        C = spgemm_ranged_impl(A, Bc, r0, r1, C, c_pad)
    return C, planned_stats(plan, chunks[0].nbytes(), 0, 0)


def chunk_gpu1_scan(A: CSR, B: CSR, plan: ChunkPlan, c_pad: int):
    strips = a_strips(A, plan.p_ac)
    chunks = b_chunks(B, plan.p_b)
    As, Bs = csr_unstack(csr_stack(strips)), csr_unstack(csr_stack(chunks))
    strip_rows = strips[0].n_rows
    out = []
    for Ai in As:                       # A/C strip stationary, chunks streamed
        Ci = _empty_like_c(strip_rows, B.n_cols, c_pad, A.dtype, A.device)
        for Bc, (r0, r1) in zip(Bs, _ranges(plan)):
            Ci = spgemm_ranged_impl(Ai, Bc, r0, r1, Ci, c_pad)
        out.append(Ci)
    stats = planned_stats(plan, chunks[0].nbytes(), strips[0].nbytes(),
                          _c_strip_nbytes(strip_rows, c_pad, A.dtype))
    return _assemble(out, plan.p_ac, B.n_cols), stats


def chunk_gpu2_scan(A: CSR, B: CSR, plan: ChunkPlan, c_pad: int):
    strips = a_strips(A, plan.p_ac)
    chunks = b_chunks(B, plan.p_b)
    As, Bs = csr_unstack(csr_stack(strips)), csr_unstack(csr_stack(chunks))
    strip_rows = strips[0].n_rows
    Cs = [_empty_like_c(strip_rows, B.n_cols, c_pad, A.dtype, A.device) for _ in As]
    for Bc, (r0, r1) in zip(Bs, _ranges(plan)):   # B chunk stationary
        Cs = [spgemm_ranged_impl(Ai, Bc, r0, r1, Ci, c_pad)
              for Ai, Ci in zip(As, Cs)]
    stats = planned_stats(plan, chunks[0].nbytes(), strips[0].nbytes(),
                          _c_strip_nbytes(strip_rows, c_pad, A.dtype))
    return _assemble(Cs, plan.p_ac, B.n_cols), stats


# ---------------------------------------------------------------------------
# dense-slab backend (kernels/ranged_spgemm)
# ---------------------------------------------------------------------------


def _dense_stack(stacked: CSR, levels: int = 1, pad_cols: int = 0) -> torch.Tensor:
    """Densify a CSR with ``levels`` leading stack axes into f32
    ``[..., rows, n_cols + pad_cols]``. The zero ``pad_cols`` columns are the
    reference's ``_pad_cols``, allocated here in the same buffer so the
    ranged column slice of the last chunk stays in bounds without a copy."""
    lead = tuple(stacked.indptr.shape[:levels])
    n_rows, n_cols = stacked.shape
    ip = stacked.indptr.reshape(-1, n_rows + 1)
    ix = stacked.indices.reshape(ip.shape[0], -1).long()
    d = stacked.data.reshape(ip.shape[0], -1).to(torch.float32)
    dense = torch.zeros(ip.shape[0], n_rows, n_cols + pad_cols,
                        dtype=torch.float32, device=ip.device)
    if n_rows and ip.shape[0]:
        entry = torch.arange(ix.shape[1], dtype=torch.int32,
                             device=ip.device).expand(ip.shape[0], -1).contiguous()
        row = (torch.searchsorted(ip, entry, right=True) - 1).clamp(0, n_rows - 1)
        piece = torch.arange(ip.shape[0], device=ip.device)[:, None].expand_as(row)
        dense.index_put_((piece, row, ix), d, accumulate=True)
    return dense.reshape(*lead, n_rows, n_cols + pad_cols)


def _pallas_assemble(dense: torch.Tensor, p_ac: tuple) -> CSR:
    """Crop per-strip dense results to their true rows, concatenate, and
    sparsify. The dense backend's CSR keeps exactly the nonzeros of the dense
    result, so comparisons against the loop oracle are allclose on densified
    values rather than exact on structure."""
    whole = torch.cat([dense[i][: e - s]
                       for i, (s, e) in enumerate(zip(p_ac[:-1], p_ac[1:]))])
    return csr_from_dense(whole, device=dense.device)


def _pallas_run(A: CSR, B: CSR, plan: ChunkPlan, strips: bool):
    chunks = b_chunks(B, plan.p_b)
    Bs = csr_stack(chunks)
    span = Bs.n_rows
    r0s, _ = plan.b_ranges()
    if strips:
        As = csr_stack(a_strips(A, plan.p_ac))
        a = _dense_stack(As, levels=1, pad_cols=span)[None]
    else:                            # knl: the whole A is the single strip
        a = _dense_stack(A, levels=0, pad_cols=span)[None, None]
    slabs = _dense_stack(Bs, levels=1)[None]
    c0 = torch.zeros(a.shape[:3] + (B.n_cols,), dtype=torch.float32, device=a.device)
    order = "chunk2" if plan.algorithm == "chunk2" else "chunk1"
    out = ranged_spgemm_stream(a, slabs, c0, r0s, order=order)[0]
    stats = planned_stats_pallas(
        plan, *_pallas_stage_nbytes(a.shape[2], A.n_cols, span, B.n_cols))
    return out, stats


def chunk_knl_pallas(A: CSR, B: CSR, plan: ChunkPlan, c_pad: int):
    del c_pad  # capacity is implicit in the dense accumulator
    out, stats = _pallas_run(A, B, plan, strips=False)
    return csr_from_dense(out[0], device=out.device), stats


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


def _sparse_run(A: CSR, B: CSR, plan: ChunkPlan, c_pad: int, backend: str,
                caps=None):
    """Shared body of the CSR-output executors (ESC and hash): stage CSR
    strips and chunks (knl is the 1-strip special case of the chunk1 order),
    validate the realized output structure against the capacities, launch,
    and assemble the accumulated strip CSRs.

    ``caps`` is the symbolic phase's :class:`StripOutputCaps` when the caller
    already ran the expansion; recomputed here only for direct calls."""
    if caps is None:
        caps = strip_output_caps(A, B, plan.p_ac)
    table = (hash_table_slots(caps.c_max_row_nnz) if backend == "hash"
             else None)
    check_output_caps(caps.strip_nnz, caps.c_max_row_nnz, c_pad, table,
                      backend=backend, a_shape=A.shape, b_shape=B.shape)
    strips = a_strips(A, plan.p_ac)
    chunks = b_chunks(B, plan.p_b)
    Ast = csr_stack([csr_stack(strips)])
    Bst = csr_stack([csr_stack(chunks)])
    r0s, r1s = plan.b_ranges()
    strip_rows = strips[0].n_rows
    C0 = _sparse_c0_stack(1, plan.n_ac, strip_rows, B.n_cols, c_pad, A.dtype,
                          A.device)
    order = _CSR_ACCUM_ORDERS[plan.algorithm]
    if backend == "hash":
        ip, ix, d = hash_accum_spgemm_stream(Ast, Bst, C0, r0s, r1s,
                                             order=order, table_size=table)
    else:
        ip, ix, d = sparse_accum_spgemm_stream(Ast, Bst, C0, r0s, r1s,
                                               order=order,
                                               row_cap=caps.c_max_row_nnz)
    stats = planned_stats_pallas(
        plan, chunks[0].nbytes(), strips[0].nbytes(),
        _c_strip_nbytes(strip_rows, c_pad, A.dtype))
    out = [CSR(ip[0, i], ix[0, i], d[0, i], (strip_rows, B.n_cols), c_pad)
           for i in range(plan.n_ac)]
    return _assemble(out, plan.p_ac, B.n_cols), stats


def chunk_sparse(A: CSR, B: CSR, plan: ChunkPlan, c_pad: int, caps=None):
    """ESC CSR-output executor for any plan algorithm."""
    return _sparse_run(A, B, plan, c_pad, "sparse", caps=caps)


def chunk_hash(A: CSR, B: CSR, plan: ChunkPlan, c_pad: int, caps=None):
    """Hash-probe executor for any plan algorithm."""
    return _sparse_run(A, B, plan, c_pad, "hash", caps=caps)


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
        executors={"knl": chunk_knl, "chunk1": chunk_gpu1, "chunk2": chunk_gpu2},
    ))
    register(Spec(
        name="scan",
        executors={"knl": chunk_knl_scan, "chunk1": chunk_gpu1_scan,
                   "chunk2": chunk_gpu2_scan},
    ))
    register(Spec(
        name="pallas",
        executors={"knl": chunk_knl_pallas, "chunk1": chunk_gpu1_pallas,
                   "chunk2": chunk_gpu2_pallas},
        byte_model=planned_stats_dense_slab,
        is_accumulator=True,
    ))
    register(Spec(
        name="sparse",
        executors=dict.fromkeys(algs, chunk_sparse),
        byte_model=planned_stats_sparse,
        needs_output_caps=True,
        is_accumulator=True,
    ))
    register(Spec(
        name="hash",
        executors=dict.fromkeys(algs, chunk_hash),
        byte_model=planned_stats_hash,
        needs_output_caps=True,
        is_accumulator=True,
    ))


_register_all()
