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
  mask-fused product ``(A x B) ∘ M`` of triangle counting.
* ``bsr`` — blocked tiles: every (strip, chunk) pair staged as BSR straight
  from the CSR operands and multiplied by the CUDA kernel
  ``repro_torch.kernels.bsr_spgemm``; opt-in under ``auto`` through
  ``block_size`` (uncapped envelopes price it at infinity).

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

import dataclasses

import torch

from repro_torch.core import backend_registry
from repro_torch.core.chunking import (
    StatsLog, _assemble, _empty_like_c, a_strips, b_chunks, chunk_gpu1,
    chunk_gpu2, chunk_knl, instance_envelope,
)
from repro_torch.core.kkmem import spgemm_ranged_impl
from repro_torch.core.planner import (
    ChunkPlan, check_output_caps, hash_table_slots, planned_stats_bsr,
    planned_stats_dense_slab, planned_stats_hash, planned_stats_sparse,
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
    CSR, GeometryEnvelope, _csr_from_tensors, csr_from_dense, csr_pad_to,
    csr_stack, csr_unstack,
)


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
# masked hash executor: fused output mask (triangle counting's fast path)
# ---------------------------------------------------------------------------


def stage_hash_masked(A: CSR, B: CSR, mask: CSR, plan: ChunkPlan, c_pad: int,
                      caps=None, c_prev: CSR | None = None):
    """Stage the masked kernel's operands for ``plan``, as
    :func:`chunk_hash_masked` launches them: returns ``(operands,
    table_size, stats)`` with ``operands = (Ast, Bst, C0st, Mst, r0s, r1s)``
    of ``hash_masked_accum_spgemm_stream`` and the plan's ChunkStats.

    C_prev is empty at capacity ``c_pad``, or ``c_prev``'s strips at the
    larger of ``c_pad`` and their own capacity."""
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
    Ast = csr_stack([csr_stack(strips)])
    Bst = csr_stack([csr_stack(chunks)])
    Mst = csr_stack([csr_stack(mstrips)])
    r0s, r1s = plan.b_ranges()
    strip_rows = strips[0].n_rows
    if c_prev is None:
        C0 = _sparse_c0_stack(1, plan.n_ac, strip_rows, B.n_cols, c_pad,
                              A.dtype, A.device)
    else:
        c0s = a_strips(c_prev, plan.p_ac)
        c_pad = max(c_pad, c0s[0].nnz_pad)
        C0 = csr_stack([csr_stack([csr_pad_to(s, c_pad) for s in c0s])])
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
    ip, ix, d = hash_masked_accum_spgemm_stream(
        *operands, order=_CSR_ACCUM_ORDERS[plan.algorithm], table_size=table)
    strip_rows = operands[0].n_rows
    out = [CSR(ip[0, i], ix[0, i], d[0, i], (strip_rows, B.n_cols), c_pad)
           for i in range(plan.n_ac)]
    return _assemble(out, plan.p_ac, B.n_cols), stats


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


def stage_bsr_pairs(A: CSR, B: CSR, plan: ChunkPlan, envelope: GeometryEnvelope):
    """Stage the BSR executor's (strip, chunk) pairs in launch order (Chunk2
    streams strips under a stationary chunk, the other orders chunks under
    a stationary strip) at the envelope's block caps. Yields ``(strip,
    operands, meta)``: the strip's index, ``(a_blocks, b_blocks, a_slots,
    b_slots)`` of ``bsr_spgemm_blocks`` (blocks with the zero sentinel,
    slot tables on the operands' device) and the pair's
    :class:`BsrSpgemmMeta`.

    The pair's A piece is the strip's rows with columns outside the chunk
    dropped, at full contraction width, and the B piece is the chunk's rows
    at full output width, so summing pair products over chunks is exactly
    the strip product."""
    bs, nbl_a_cap, nbl_b_cap, nc_cap, u_cap = envelope.bsr_caps
    k, n = B.shape
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
        Ab = _stage_bsr(A, s, e, r0, r1, s, (srpad, kpad), bs, nbl_a_cap)
        Bb = _stage_bsr(B, r0, r1, 0, n, 0, (kpad, npad), bs, nbl_b_cap)
        meta = bsr_spgemm_symbolic(Ab, Bb, nc_pad=nc_cap, u_max=u_cap)
        slots = (torch.from_numpy(t).to(A.device) for t in (meta.a_slots, meta.b_slots))
        yield ia, (bsr_blocks_with_sentinel(Ab), bsr_blocks_with_sentinel(Bb),
                   *slots), meta


def _bsr_execute(A: CSR, B: CSR, plan: ChunkPlan, envelope: GeometryEnvelope):
    """Body of the BSR executor: launch the blocked kernel on every pair
    :func:`stage_bsr_pairs` stages, sum the pairs' output blocks per strip
    and keep the nonzero entries as C.

    The reference densified whole operands and the whole product to get
    there; here the pieces come straight from the CSR and C from the output
    blocks: the same blocks, the same block sums in the same pair order,
    and the nonzero entries ``csr_from_dense`` would keep."""
    bs, nbl_a_cap, nbl_b_cap, nc_cap, u_cap = envelope.bsr_caps
    k, n = B.shape
    kpad = -(-k // bs) * bs
    npad = -(-n // bs) * bs
    srpad = -(-envelope.strip_rows // bs) * bs
    mbs, nbp = srpad // bs, npad // bs
    dev = A.device
    strips = list(zip(plan.p_ac[:-1], plan.p_ac[1:]))
    parts = [[] for _ in strips]
    for ia, operands, meta in stage_bsr_pairs(A, B, plan, envelope):
        out = bsr_spgemm_blocks(*operands, nc_pad=nc_cap, u_max=u_cap, bs=bs)
        n_c = meta.n_c_blocks
        if not n_c:
            continue
        # crop to the real blocks: padded rows carry c_indices == 0 and would
        # alias block column 0 if kept
        brows = torch.repeat_interleave(
            torch.arange(mbs, device=dev),
            torch.from_numpy(meta.c_indptr[1:] - meta.c_indptr[:-1]).to(dev).long())
        cols = torch.from_numpy(meta.c_indices[:n_c]).to(dev).long()
        parts[ia].append((brows * nbp + cols, out[:n_c]))
    rows_all, cols_all, vals_all = [], [], []
    r = torch.arange(bs, device=dev)
    for (s, e), part in zip(strips, parts):
        if not part:
            continue
        keys = torch.cat([p[0] for p in part])
        tiles = torch.cat([p[1] for p in part])
        uniq, inv = torch.unique(keys, return_inverse=True)
        acc = torch.zeros(uniq.numel(), bs, bs, dtype=torch.float32, device=dev)
        acc.index_add_(0, inv, tiles)
        row = (uniq // nbp)[:, None, None] * bs + r[None, :, None]
        col = (uniq % nbp)[:, None, None] * bs + r[None, None, :]
        row, col = row.expand_as(acc), col.expand_as(acc)
        keep = (acc != 0) & (row < e - s) & (col < n)
        rows_all.append(row[keep] + s)
        cols_all.append(col[keep])
        vals_all.append(acc[keep])
    block_bytes = bs * bs * 4
    slab = (kpad // bs + 1) * 4 + nbl_b_cap * (4 + block_bytes) + block_bytes
    a_stage = (mbs + 1) * 4 + nbl_a_cap * (4 + block_bytes) + block_bytes
    c_stage = (mbs + 1) * 4 + nc_cap * (4 + block_bytes)
    stats = planned_stats_pallas(plan, slab, a_stage, c_stage)
    if rows_all:
        rows, cols, vals = torch.cat(rows_all), torch.cat(cols_all), torch.cat(vals_all)
    else:
        rows = cols = torch.zeros(0, dtype=torch.int64, device=dev)
        vals = torch.zeros(0, dtype=torch.float32, device=dev)
    order = torch.argsort(rows * n + cols)
    rows, cols, vals = rows[order], cols[order], vals[order].to(A.dtype)
    indptr = torch.zeros(A.n_rows + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=A.n_rows), 0)
    C = _csr_from_tensors(indptr, cols, vals, (A.n_rows, n), int(rows.numel()), None)
    return C, stats


def chunk_bsr(A: CSR, B: CSR, plan: ChunkPlan, c_pad: int, caps=None,
              block_size: int | None = None):
    """Blocked-tile executor for any plan algorithm. Builds the block-capped
    instance envelope itself; the dispatch passes ``caps`` to amortize the
    element-level symbolic phase and ``block_size`` to override the default
    block edge."""
    env = instance_envelope(A, B, plan, c_pad=c_pad, caps=caps,
                            block_size=block_size or _BSR_DEFAULT_BLOCK)
    return _bsr_execute(A, B, plan, env)


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
        run_masked=chunk_hash_masked,
    ))
    register(Spec(
        name="bsr",
        executors=dict.fromkeys(algs, chunk_bsr),
        byte_model=planned_stats_bsr,
        needs_output_caps=True,
        needs_block_caps=True,
        is_accumulator=True,
        block_size=_BSR_DEFAULT_BLOCK,
    ))


_register_all()
