"""Operands in slow memory under ``pallas``, ``scan``, ``loop`` and ``bsr``,
on the CPU, held to the JAX package.

``chunked_spgemm(..., placement=..., device="cpu")`` streams each slow
operand's pieces through the copy ring (``repro_torch.core.copy_ring``):
dense strips, slabs and C blocks under ``pallas``, CSR strips and chunks
under ``scan`` and ``loop``, BSR pieces ``(indptr, indices, blocks)`` under
``bsr``. For the conformance geometries (``CASES``, ``_plan``) x the four
backends x the three algorithms x the paper's six Table 3 placements: C
equal to the port's all-fast call bit for bit and to the reference's
``chunked_spgemm`` of the same backend on the same plan (structure exactly
and values within atol 1e-4; the dense slab's within atol 1e-4 densified),
ChunkStats equal to the reference's, the bytes moved per operand equal to that
operand's tagged events (``planned_events`` at the dense sizes,
``planned_events_ranged``, ``planned_events_bsr``), and every ring's log
equal to its schedule's program (``check_ring_structure``) and race-free
(``check_interleave``) at its ``n_fields``. Under Algorithm 1 the loop
executors count only B's chunks: a slow A crosses whole before the first
step and a slow C whole after the last, each one transfer logged apart from
the events, as ``whole_fast`` moves its operands.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.core import chunking as ref_chunking
from repro.sparse.csr import csr_to_dense as ref_to_dense
from repro_torch.analysis.dma import check_ring_structure
from repro_torch.analysis.interleave import check_interleave
from repro_torch.core import chunk_stream, copy_ring
from repro_torch.core.chunking import (
    _c_strip_nbytes, a_strips, b_chunks, chunked_spgemm, instance_envelope,
    planned_events_ranged,
)
from repro_torch.core.placement import TABLE3
from repro_torch.kernels.convert import plan_from_fields
from repro_torch.sparse.csr import csr_to_dense
from test_backend_conformance import CASES, _plan
from test_torch_sparse_accum import _port

ALGORITHMS = ("knl", "chunk1", "chunk2")
BACKENDS = ("pallas", "scan", "loop", "bsr")
ATOL = 1e-4


def _stats_tuple(s):
    return (s.algorithm, s.n_ac, s.n_b, s.kernel_calls, s.copy_in_bytes,
            s.copy_out_bytes, tuple(s.per_copy_in), tuple(s.per_copy_out))


@functools.lru_cache(maxsize=None)
def _reference(case, algorithm, backend):
    """The reference's operands, plan, and C and ChunkStats of ``backend``
    on it."""
    build, seed = CASES[case]
    A, B = build(np.random.default_rng(seed))
    plan = _plan(algorithm, A, B)
    c_pad = ref_chunking.default_c_pad(A, B, plan)
    C, stats = ref_chunking.chunked_spgemm(A, B, plan, c_pad, backend=backend)
    return A, B, plan, C, stats


@functools.lru_cache(maxsize=None)
def _port_case(case, algorithm):
    A, B, ref_plan, _, _ = _reference(case, algorithm, "loop")
    return _port(A), _port(B), plan_from_fields(*dataclasses.astuple(ref_plan))


@functools.lru_cache(maxsize=None)
def _all_fast(case, algorithm, backend):
    pA, pB, plan = _port_case(case, algorithm)
    return chunked_spgemm(pA, pB, plan, backend=backend, device="cpu")


@functools.lru_cache(maxsize=None)
def _interleave_clean(total, n_fields):
    return check_interleave(total, n_fields)[0] == []


def _events(backend, pA, pB, plan, c_pad):
    """The plan's tagged copy events at the port's staged piece sizes."""
    strips, chunks = a_strips(pA, plan.p_ac), b_chunks(pB, plan.p_b)
    if backend == "pallas":
        return chunk_stream.planned_events(plan, *chunk_stream._pallas_stage_nbytes(
            strips[0].n_rows, pA.n_cols, chunks[0].n_rows, pB.n_cols))
    if backend == "bsr":
        env = instance_envelope(pA, pB, plan, c_pad=c_pad,
                                block_size=chunk_stream._BSR_DEFAULT_BLOCK)
        slab, a_stage, _ = chunk_stream._bsr_stage_nbytes(env)
        layouts = chunk_stream._bsr_stage_placed(pA, pB, plan, env)[-1]
        return chunk_stream.planned_events_bsr(
            plan, slab, a_stage, chunk_stream._bsr_part_nbytes(layouts, env.bsr_caps[0]),
            _c_strip_nbytes(env.strip_rows, c_pad, pA.dtype))
    return planned_events_ranged(plan, chunks[0].nbytes(), strips[0].nbytes(),
                                 _c_strip_nbytes(strips[0].n_rows, c_pad, pA.dtype))


def _rings_expected(backend, algorithm, where) -> dict:
    """Operand -> fields of the rings a call opens: every slow operand's but
    C in Chunk2 (one block, or the partials, crossing whole), C under
    ``bsr`` (its summed blocks and its CSR cross whole) and A and C under
    Algorithm 1 in the loop executors (each crossing whole once)."""
    ranged = backend in ("scan", "loop")
    want = {}
    for k in where.slow:
        if k == "C" and (algorithm == "chunk2" or backend == "bsr"):
            continue
        if ranged and algorithm == "knl" and k in ("A", "C"):
            continue
        want[k] = 3
        if backend == "pallas" or (ranged and k == "C"):
            want[k] = 1          # a dense piece; a strip's C row pointers
    return want


@pytest.mark.parametrize("placement", sorted(TABLE3))
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_placed_call_matches_all_fast_and_reference(case, algorithm, backend, placement):
    A, B, ref_plan, C_ref, stats_ref = _reference(case, algorithm, backend)
    pA, pB, plan = _port_case(case, algorithm)
    where = TABLE3[placement]
    with copy_ring.RingLog() as log:
        C, stats = chunked_spgemm(pA, pB, plan, backend=backend, placement=where,
                                  device="cpu")
    C_fast, stats_fast = _all_fast(case, algorithm, backend)
    for f in ("indptr", "indices", "data"):
        assert torch.equal(getattr(C, f), getattr(C_fast, f)), f
    assert (C.shape, C.max_row_nnz) == (C_fast.shape, C_fast.max_row_nnz)
    # the reference's own backend on the same plan
    if backend == "pallas":
        np.testing.assert_allclose(csr_to_dense(C).numpy(), np.asarray(ref_to_dense(C_ref)),
                                   atol=ATOL, rtol=0)
    else:
        nnz = int(np.asarray(C_ref.indptr)[-1])
        np.testing.assert_array_equal(C.indptr.numpy(), np.asarray(C_ref.indptr))
        np.testing.assert_array_equal(C.indices.numpy()[:nnz],
                                      np.asarray(C_ref.indices)[:nnz])
        np.testing.assert_allclose(C.data.numpy()[:nnz], np.asarray(C_ref.data)[:nnz],
                                   atol=ATOL, rtol=0)
    assert stats == stats_fast
    assert _stats_tuple(stats) == _stats_tuple(stats_ref)
    # the links moved exactly the slow operands' tagged events
    c_pad = ref_chunking.default_c_pad(A, B, ref_plan)
    events = _events(backend, pA, pB, plan, c_pad)
    if backend != "bsr":       # bsr's ChunkStats are the idealized pipeline's
        assert tuple(float(b) for _, d, b in events if d == "in") == stats.per_copy_in
        assert tuple(float(b) for _, d, b in events if d == "out") == stats.per_copy_out
    for operand in ("A", "B", "C"):
        for direction in ("in", "out"):
            want = ([b for o, d, b in events if o == operand and d == direction]
                    if getattr(where, operand) == "slow" else [])
            assert log.moved(operand, direction) == want, (operand, direction)
    # Algorithm 1 in the loop executors: a slow A and C cross whole, apart
    whole = algorithm == "knl" and backend in ("scan", "loop")
    assert log.moved("A", "in", apart=True) == (
        [pA.nbytes()] if whole and where.A == "slow" else [])
    assert log.moved("C", "out", apart=True) == (
        [C.nbytes()] if whole and where.C == "slow" else [])
    assert [t for t in log.transfers if t.apart and t.operand == "B"] == []
    # every ring's log is its schedule's program, at its fields
    want_rings = _rings_expected(backend, algorithm, where)
    assert {r.operand: r.n_fields for r in log.rings} == want_rings
    assert len(log.rings) == len(want_rings)
    for ring in log.rings:
        assert check_ring_structure(ring.ops, ring.total, ring.n_fields) == []
        assert _interleave_clean(ring.total, ring.n_fields)
        assert len(log.moved(ring.operand, "in")) == ring.total

