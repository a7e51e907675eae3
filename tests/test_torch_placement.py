"""Operands in slow memory through the copy ring, on the CPU, held to the JAX
package.

``chunked_spgemm(..., placement=..., device="cpu")`` runs the ``sparse``
and ``hash`` executors with each slow operand's pieces crossing through
the two-slot ring (``repro_torch.core.copy_ring``) into host-side slots.
For the conformance geometries (``CASES``, ``_plan``) x both backends x the
three algorithms x the paper's six Table 3 placements: C against the
reference's loop oracle (structure exact, values 1e-4), ChunkStats equal
to the reference's accounting for the backend, C equal to the port's
all-fast call bit for bit, the bytes the ring moved equal to the slow
operands' events, operand for operand and event for event, and every
ring's log equal to its schedule's program. Then ``place`` and
``Placement.fast_bytes``, every path that must raise on a slow operand, and
the spill pipeline (T streamed from slow memory) against the reference's.
The other four backends with slow operands are
``tests/test_torch_placement_backends.py``'s, the spill pipeline under all
six ``tests/test_torch_pipeline_spill.py``'s.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from benchmarks.data_placement import PLACEMENTS as REF_PLACEMENTS
from repro.core import chunk_stream as ref_cs
from repro.core import chunking as ref_chunking
from repro.core import pipeline_spgemm as ref_pipe
from repro.core import placement as ref_placement
from repro.core.memory_model import P100 as REF_P100
from repro.core.planner import row_bytes_csr as ref_row_bytes
from repro.core.symbolic import pipeline_output_caps as ref_pipeline_caps
from repro.core.symbolic import strip_output_caps as ref_caps
from repro.sparse import multigrid as ref_mg
from repro_torch.analysis.dma import check_ring_structure
from repro_torch.core import (
    backend_registry, chunk_stream, copy_ring, pipeline_spgemm, planner,
)
from repro_torch.core.chunking import a_strips, b_chunks, chunked_spgemm
from repro_torch.core.memory_model import P100
from repro_torch.core.placement import (
    ALL_FAST, ALL_SLOW, DP, TABLE3, Placement, place, resolve_placement,
)
from repro_torch.core.symbolic import pipeline_output_caps
from repro_torch.kernels import bsr_spgemm, hash_accum_spgemm, ranged_spgemm
from repro_torch.kernels import sparse_accum_spgemm
from repro_torch.kernels.convert import plan_from_fields
from repro_torch.serve.spgemm_service import SpGEMMService
from repro_torch.sparse.csr import csr_stack
from test_backend_conformance import CASES, _plan
from test_torch_sparse_accum import _port

ATOL = 1e-4
ALGORITHMS = ("knl", "chunk1", "chunk2")
BACKENDS = ("sparse", "hash")


def _stats_tuple(s):
    return (s.algorithm, s.n_ac, s.n_b, s.kernel_calls, s.copy_in_bytes,
            s.copy_out_bytes, tuple(s.per_copy_in), tuple(s.per_copy_out))


@functools.lru_cache(maxsize=None)
def _reference(case, algorithm):
    """The reference's operands, plan, loop-oracle C and the CSR
    accumulators' accounting on this plan."""
    build, seed = CASES[case]
    A, B = build(np.random.default_rng(seed))
    plan = _plan(algorithm, A, B)
    c_pad = ref_chunking.default_c_pad(A, B, plan)
    C, _ = ref_chunking.chunked_spgemm(A, B, plan, c_pad, backend="loop")
    strips = ref_chunking.a_strips(A, plan.p_ac)
    chunks = ref_chunking.b_chunks(B, plan.p_b)
    stats = ref_cs.planned_stats_pallas(
        plan, chunks[0].nbytes(), strips[0].nbytes(),
        ref_cs._c_strip_nbytes(strips[0].n_rows, ref_caps(A, B, plan.p_ac).c_pad, A.dtype))
    return A, B, plan, C, stats


@functools.lru_cache(maxsize=None)
def _port_case(case, algorithm):
    A, B, ref_plan, _, _ = _reference(case, algorithm)
    return _port(A), _port(B), plan_from_fields(*dataclasses.astuple(ref_plan))


@functools.lru_cache(maxsize=None)
def _all_fast(case, algorithm, backend):
    pA, pB, plan = _port_case(case, algorithm)
    return chunked_spgemm(pA, pB, plan, backend=backend, device="cpu")


def _events(pA, pB, plan, c_pad):
    """The plan's tagged copy events at the port's staged piece sizes."""
    strips, chunks = a_strips(pA, plan.p_ac), b_chunks(pB, plan.p_b)
    return chunk_stream.planned_events(
        plan, chunks[0].nbytes(), strips[0].nbytes(),
        chunk_stream._c_strip_nbytes(strips[0].n_rows, c_pad, pA.dtype))


@pytest.mark.parametrize("placement", sorted(TABLE3))
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_placed_call_matches_reference(case, algorithm, backend, placement):
    A, B, ref_plan, C_ref, stats_ref = _reference(case, algorithm)
    pA, pB, plan = _port_case(case, algorithm)
    where = TABLE3[placement]
    with copy_ring.RingLog() as log:
        C, stats = chunked_spgemm(pA, pB, plan, backend=backend, placement=where,
                                  device="cpu")
    nnz = int(np.asarray(C_ref.indptr)[-1])
    np.testing.assert_array_equal(C.indptr.numpy(), np.asarray(C_ref.indptr))
    np.testing.assert_array_equal(C.indices.numpy()[:nnz], np.asarray(C_ref.indices)[:nnz])
    np.testing.assert_allclose(C.data.numpy()[:nnz], np.asarray(C_ref.data)[:nnz],
                               atol=ATOL, rtol=0)
    assert _stats_tuple(stats) == _stats_tuple(stats_ref)
    C_fast, stats_fast = _all_fast(case, algorithm, backend)
    assert stats == stats_fast
    for f in ("indptr", "indices", "data"):
        assert torch.equal(getattr(C, f), getattr(C_fast, f)), f
    # the ring moved exactly the slow operands' events, and nothing of a fast one
    events = _events(pA, pB, plan, ref_caps(A, B, ref_plan.p_ac).c_pad)
    assert tuple(float(b) for _, d, b in events if d == "in") == stats.per_copy_in
    assert tuple(float(b) for _, d, b in events if d == "out") == stats.per_copy_out
    for operand in ("A", "B", "C"):
        for direction in ("in", "out"):
            want = ([b for o, d, b in events if o == operand and d == direction]
                    if getattr(where, operand) == "slow" else [])
            assert log.moved(operand, direction) == want, (operand, direction)
    assert sorted(r.operand for r in log.rings) == sorted(
        k for k in where.slow if not (k == "C" and plan.algorithm == "chunk2"))
    for ring in log.rings:
        assert check_ring_structure(ring.ops, ring.total, ring.n_fields) == []
        stationary = ring.role == "stationary"
        outer = plan.n_b if plan.algorithm == "chunk2" else plan.n_ac
        assert ring.total == (outer if stationary else plan.n_ac * plan.n_b)


def test_table3_placements_match_the_benchmark():
    assert set(TABLE3) == set(REF_PLACEMENTS)
    for name, ref in REF_PLACEMENTS.items():
        assert (TABLE3[name].A, TABLE3[name].B, TABLE3[name].C) == (ref.A, ref.B, ref.C)


@pytest.mark.parametrize("name", sorted(TABLE3))
def test_fast_bytes_matches_reference(name):
    p = TABLE3[name]
    ref = ref_placement.Placement(p.A, p.B, p.C)
    for sizes in ((1.0, 2.0, 4.0), (23.3e6, 3.3e6, 12.8e6), (0.0, 7.0, 0.5)):
        assert p.fast_bytes(*sizes) == ref.fast_bytes(*sizes)
    assert p.slow == tuple(k for k in "ABC" if getattr(p, k) == "slow")


def test_place_round_trips_on_the_cpu():
    pA, pB, _ = _port_case("skewed_rows", "chunk1")
    t = torch.arange(6, dtype=torch.float32)
    for space in ("slow", "fast"):
        got = place({"A": pA, "pair": (pB, t), "list": [t]}, space, device="cpu")
        assert isinstance(got["pair"], tuple) and isinstance(got["list"], list)
        back = place(got, "fast", device="cpu")
        for m, want in ((back["A"], pA), (back["pair"][0], pB)):
            for f in ("indptr", "indices", "data"):
                assert torch.equal(getattr(m, f), getattr(want, f))
            assert (m.shape, m.max_row_nnz) == (want.shape, want.max_row_nnz)
        assert torch.equal(back["pair"][1], t) and torch.equal(back["list"][0], t)
    with pytest.raises(ValueError, match="space must be one of"):
        place(pA, "hbm", device="cpu")
    with pytest.raises(ValueError, match="space must be one of"):
        ref_placement.place(np.zeros(2), "hbm")
    with pytest.raises(TypeError, match="cannot place"):
        place(3, "fast", device="cpu")


def test_resolve_placement_on_the_cpu():
    pA, pB, _ = _port_case("skewed_rows", "chunk1")
    ops = {"A": pA, "B": pB}
    placement, device = resolve_placement(ops, None, "cpu")
    assert placement == ALL_FAST and device.type == "cpu"
    assert resolve_placement(ops, DP, "cpu") == (DP, torch.device("cpu"))
    # the run device defaults to the card, where a pageable operand raises
    with pytest.raises(ValueError, match=r"place\(x, 'fast'\)"):
        resolve_placement(ops, None, None)
    with pytest.raises(ValueError, match=r"place\(x, 'fast'\)"):
        chunked_spgemm(pA, pB, _port_case("skewed_rows", "chunk1")[2], backend="hash")


@pytest.fixture
def pinned(monkeypatch):
    """Every CPU tensor reads as pinned: the refusals of a slow operand
    checked where no card can pin one."""
    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self, *a, **k: True)


def test_pageable_operand_in_a_card_run_raises():
    pA, pB, plan = _port_case("skewed_rows", "chunk1")
    with pytest.raises(ValueError, match=r"place\(x, 'fast'\)"):
        chunked_spgemm(pA, pB, plan, backend="hash", device="cuda")
    with pytest.raises(ValueError, match="place"):
        chunked_spgemm(pA, pB, plan, backend="hash", placement=ALL_SLOW, device="cuda")


def test_placement_disagreeing_with_the_operands_raises(pinned):
    pA, pB, plan = _port_case("skewed_rows", "chunk1")
    with pytest.raises(ValueError, match=r"place\(A, 'fast'\)"):
        chunked_spgemm(pA, pB, plan, backend="hash", placement=ALL_FAST, device="cuda")
    with pytest.raises(ValueError, match=r"place\(B, 'fast'\)"):
        chunked_spgemm(pA, pB, plan, backend="hash", placement=DP, device="cuda")


def test_auto_resolving_to_a_backend_without_a_ring_raises(monkeypatch):
    """``auto`` may resolve to any backend with a slow operand: every
    registered backend has a ring. A spec registered without one
    (``run_placed=None``) still raises, whichever way it is reached."""
    pA, pB, plan = _port_case("dense_row", "chunk1")
    monkeypatch.setattr(planner, "select_accumulator_backend", lambda plan, env: "hash")
    C, _ = chunked_spgemm(pA, pB, plan, backend="auto", placement=ALL_SLOW, device="cpu")
    assert torch.equal(C.data, _all_fast("dense_row", "chunk1", "hash")[0].data)
    monkeypatch.setattr(planner, "select_accumulator_backend", lambda plan, env: "pallas")
    with copy_ring.RingLog() as log:
        C, _ = chunked_spgemm(pA, pB, plan, backend="auto", placement=ALL_SLOW,
                              device="cpu")
    C_fast, _ = _all_fast("dense_row", "chunk1", "pallas")
    for f in ("indptr", "indices", "data"):
        assert torch.equal(getattr(C, f), getattr(C_fast, f)), f
    assert sorted(r.operand for r in log.rings) == ["A", "B", "C"]
    assert all(r.n_fields == 1 for r in log.rings)
    ringless = dataclasses.replace(backend_registry.get("pallas"), run_placed=None)
    monkeypatch.setitem(backend_registry._REGISTRY, "pallas", ringless)
    with pytest.raises(ValueError, match="'pallas' registers no copy ring"):
        chunked_spgemm(pA, pB, plan, backend="auto", placement=ALL_SLOW, device="cpu")


def test_kernel_wrappers_refuse_pinned_tensors(pinned):
    pA, pB, plan = _port_case("skewed_rows", "chunk1")
    Ast = csr_stack([csr_stack(a_strips(pA, plan.p_ac))])
    Bst = csr_stack([csr_stack(b_chunks(pB, plan.p_b))])
    C0 = chunk_stream._sparse_c0_stack(1, plan.n_ac, Ast.n_rows, pB.n_cols, 64,
                                       torch.float32, "cpu")
    r0s, r1s = plan.b_ranges()
    calls = [
        lambda: sparse_accum_spgemm.sparse_accum_spgemm_stream(
            Ast, Bst, C0, r0s, r1s, order="chunk1", row_cap=16),
        lambda: hash_accum_spgemm.hash_accum_spgemm_stream(
            Ast, Bst, C0, r0s, r1s, order="chunk1", table_size=16),
        lambda: hash_accum_spgemm.hash_masked_accum_spgemm_stream(
            Ast, Bst, C0, C0, r0s, r1s, order="chunk1", table_size=16),
        lambda: ranged_spgemm.ranged_spgemm_stream(
            torch.zeros(1, 1, 4, 8), torch.zeros(1, 2, 4, 4), torch.zeros(1, 1, 4, 4),
            np.array([0, 4], np.int32), order="chunk1"),
        lambda: bsr_spgemm.bsr_spgemm_blocks(
            torch.zeros(2, 4, 4), torch.zeros(2, 4, 4), np.zeros((1, 1), np.int32),
            np.zeros((1, 1), np.int32), nc_pad=1, u_max=1, bs=4),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="pinned host memory"):
            call()


def test_entry_points_without_a_ring_refuse_slow_operands(pinned):
    """No entry point is left without a ring: the batched entry point, the
    service and the pipeline take a pinned operand as a slow one and run on
    the card by default, which here, where there is none, raises for the
    missing card and not for the operand."""
    pA, pB, plan = _port_case("skewed_rows", "chunk1")
    no_card = pytest.raises(RuntimeError, match="torch.cuda.is_available")
    with no_card:
        chunk_stream.chunked_spgemm_batched([pA], [pB], plan, backend="hash")
    with no_card:
        SpGEMMService(plan, backend="hash").submit(pA, pB)
    with no_card:
        pipeline_spgemm.pipeline_spgemm(pA, pB, pA, system=None)


@pytest.mark.parametrize("backend", BACKENDS)
def test_whole_fast_with_slow_operands_copies_them_whole(backend):
    pA, pB, _ = _port_case("wide_sparse_output", "knl")
    plan = planner.ChunkPlan("whole_fast", (0, pA.n_rows), (0, pB.n_rows), 0.0, 0.0)
    C0, s0 = chunked_spgemm(pA, pB, plan, backend=backend, device="cpu")
    with copy_ring.RingLog() as log:
        C, s = chunked_spgemm(pA, pB, plan, backend=backend, placement=ALL_SLOW,
                              device="cpu")
    assert s == s0 and torch.equal(C.data, C0.data) and torch.equal(C.indices, C0.indices)
    assert log.moved("A", "in") + log.moved("B", "in") == [pA.nbytes(), pB.nbytes()]
    assert sum(log.moved("A", "in") + log.moved("B", "in")) == s.per_copy_in[0]
    assert log.moved("C", "out") == [C.nbytes()] == [s.per_copy_out[0]]


@pytest.mark.parametrize("backend", BACKENDS)
def test_spill_pipeline_streams_t_and_matches_reference(backend):
    rA, rR, rP = ref_mg.problem("brick3d", 6)
    total = float(sum(ref_row_bytes(m).sum() for m in (rA, rP, rR)))
    ref_plan = ref_pipe.plan_pipeline(rA, rP, rR, REF_P100, fast_limit_bytes=total * 0.25)
    assert not ref_plan.t_resident
    want, want_stats = ref_pipe.pipeline_spgemm(
        rA, rP, rR, ref_plan, backend=backend,
        caps=ref_pipeline_caps(rA, rP, rR, ref_plan.plan1.p_ac, ref_plan.plan2.p_ac))
    A, P, R = _port(rA), _port(rP), _port(rR)
    plan = planner.plan_pipeline(A, P, R, P100, fast_limit_bytes=total * 0.25)
    assert plan.plan2 == plan_from_fields(*dataclasses.astuple(ref_plan.plan2))
    caps = pipeline_output_caps(A, P, R, plan.plan1.p_ac, plan.plan2.p_ac)
    with copy_ring.RingLog() as log:
        C, stats = pipeline_spgemm.pipeline_spgemm(A, P, R, plan, backend=backend, caps=caps,
                                                   device="cpu")
    nnz = int(np.asarray(want.indptr)[-1])
    np.testing.assert_array_equal(C.indptr.numpy(), np.asarray(want.indptr))
    np.testing.assert_array_equal(C.indices.numpy()[:nnz], np.asarray(want.indices)[:nnz])
    np.testing.assert_allclose(C.data.numpy()[:nnz], np.asarray(want.data)[:nnz],
                               atol=ATOL, rtol=0)
    assert stats.spilled and want_stats.spilled
    assert stats.spill_bytes == want_stats.spill_bytes
    assert _stats_tuple(stats.hop1) == _stats_tuple(want_stats.hop1)
    assert _stats_tuple(stats.hop2) == _stats_tuple(want_stats.hop2)
    # only T (hop 2's B) crossed, as hop 2's B events say
    assert [r.operand for r in log.rings] == ["B"]
    assert log.moved("A", "in") == log.moved("C", "in") == log.moved("C", "out") == []
    assert sum(log.moved("B", "in")) == (
        plan.plan2.n_ac * plan.plan2.n_b if plan.plan2.algorithm != "chunk2"
        else plan.plan2.n_b) * log.moved("B", "in")[0]
