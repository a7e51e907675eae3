"""Slow operands read in place launch their kernel once a strip, on the CPU.

``chunked_spgemm(..., slow_reads="in_place")`` and ``count_triangles(...,
slow_reads="in_place")`` launch the backend's streaming kernel once per
strip of the plan: a launch takes one strip's A (and mask and C_prev) and
every B chunk, so the workspace it allocates on the card is one strip's.
Here the executors stage as for the card (``card_staging``: every slow
stack built through the pinned builds, ``is_pinned`` patched), a spy on
each wrapper counts its calls and the strips each was given, and the
kernels' plain versions run. On brick3d n=6 A x P (and the masked kernel
on L of rmat(7)) x knl, chunk1 and chunk2 with every operand slow: one
launch a strip, each C equal bit for bit to the ring twin's (the same call
through the copy ring) and to the JAX package's result under the knl plan
(its scan call; for the masked kernel its dense product at the mask's
entries: structure exactly but for the dense slab, values within atol
1e-4). Then the card model of
one strip launch (``placement.strip_workspace``), held to the
allocations the wrapper makes for the strips it was given, and at brick3d
n=80's capacity plan, from the plan's sizes, under the capacity run's
allocator cap; and the auditor's probe-bound pass
(``analysis.dma.check_while_bounds``), clean on the fast corpus and
flagging a launch given a wrong table.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import chunking as ref_chunking
from repro.core import planner as ref_planner
from repro.kernels.hash_accum_spgemm import probe_step_bound as ref_probe_step_bound
from repro.sparse import multigrid as ref_mg
from repro.sparse.csr import csr_to_dense as ref_to_dense
from repro_torch.analysis import audit_all, check_while_bounds, corpus
from repro_torch.core import chunk_stream, copy_ring, triangle
from repro_torch.core.chunking import chunked_spgemm
from repro_torch.core.placement import ALL_SLOW, TABLE3, card_bytes, strip_workspace
from repro_torch.core.planner import ChunkPlan, hash_table_slots
from repro_torch.core.symbolic import masked_output_caps, strip_output_caps
from repro_torch.kernels.sparse_accum_spgemm import stack_geometry
from repro_torch.sparse.csr import csr_to_dense
from test_torch_inplace_parity import card_staging  # noqa: F401  (a fixture)
from test_torch_sparse_accum import _port
from test_torch_triangle import _lower

ATOL = 1e-4
ALGORITHMS = ("knl", "chunk1", "chunk2")
WRAPPERS = {"hash": "hash_accum_spgemm_stream", "sparse": "sparse_accum_spgemm_stream",
            "pallas": "ranged_spgemm_stream"}
# brick3d n=80 at budget/12: chunk1 60 x 15 over its 512,000 rows, the
# planner's largest strip 9,955 rows (the strips follow row bytes, so they
# are not equal), under an allocator cap of 35.8 MiB (the capacity run's)
CAPACITY_ROWS, CAPACITY_PLAN, CAPACITY_STRIP = 512_000, (60, 15), 9_955
CAPACITY_CAP = 35.8 * (1 << 20)


def _thirds(n):
    return (0, n // 3, 2 * n // 3, n)


def _plans(algorithm, n_rows, n_mid):
    """The port's plan and the reference's of one algorithm: thirds of
    both partitions (knl: one strip)."""
    p_ac = (0, n_rows) if algorithm == "knl" else _thirds(n_rows)
    return (ChunkPlan(algorithm, p_ac, _thirds(n_mid), 0.0, 0.0),
            ref_planner.ChunkPlan(algorithm, p_ac, _thirds(n_mid), 0.0, 0.0))


@functools.lru_cache(maxsize=None)
def _brick():
    rA, _, rP = ref_mg.problem("brick3d", 6)
    return rA, rP, _port(rA), _port(rP)


@functools.lru_cache(maxsize=None)
def _reference():
    """The reference's scan call under the knl plan: every plan and backend
    gives C this structure and these values (within atol)."""
    rA, rP, _, _ = _brick()
    _, ref_plan = _plans("knl", rA.shape[0], rP.shape[0])
    c_pad = ref_chunking.default_c_pad(rA, rP, ref_plan)
    return ref_chunking.chunked_spgemm(rA, rP, ref_plan, c_pad, backend="scan")[0]


def _spy(monkeypatch, name):
    """Record every call of the wrapper ``name`` the executors make: the
    strips (A's second axis) and rows of the stacks it was given and its
    run device."""
    calls, real = [], getattr(chunk_stream, name)

    def spy(*args, **kw):
        a = args[0]
        lead = tuple(a.shape[:2]) if isinstance(a, torch.Tensor) else tuple(a.indptr.shape[:2])
        calls.append({"lead": lead, "args": args, "kw": kw})
        return real(*args, **kw)

    monkeypatch.setattr(chunk_stream, name, spy)
    return calls


def _equal(got, want):
    return all(torch.equal(getattr(got, f), getattr(want, f))
               for f in ("indptr", "indices", "data"))


def _held_to_reference(C, ref_C, dense_only: bool):
    np.testing.assert_allclose(csr_to_dense(C).numpy(), np.asarray(ref_to_dense(ref_C)),
                               atol=ATOL, rtol=0)
    if dense_only:   # the dense slab keeps only nonzero sums
        return
    nnz = int(np.asarray(ref_C.indptr)[-1])
    np.testing.assert_array_equal(C.indptr.numpy(), np.asarray(ref_C.indptr))
    np.testing.assert_array_equal(C.indices.numpy()[:nnz], np.asarray(ref_C.indices)[:nnz])
    np.testing.assert_allclose(C.data.numpy()[:nnz], np.asarray(ref_C.data)[:nnz],
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("backend", ("hash", "sparse", "pallas"))
def test_in_place_launches_once_a_strip(backend, algorithm, request, monkeypatch):
    """Every operand slow: one wrapper call a strip, each given one strip
    (of one instance) and the run device, C equal bit for bit to the ring
    twin's and to the all-fast call's, and held to the reference's."""
    _, _, A, P = _brick()
    plan, _ = _plans(algorithm, A.n_rows, P.n_rows)
    fast, fast_stats = chunked_spgemm(A, P, plan, backend=backend, device="cpu")
    ring, _ = chunked_spgemm(A, P, plan, backend=backend, device="cpu",
                             placement=TABLE3["HostPin"])
    request.getfixturevalue("card_staging")   # the in-place call stages as on the card
    calls = _spy(monkeypatch, WRAPPERS[backend])
    with copy_ring.RingLog() as log:
        C, stats = chunked_spgemm(A, P, plan, backend=backend, device="cpu",
                                  placement=TABLE3["HostPin"], slow_reads="in_place")
    assert [c["lead"] for c in calls] == [(1, 1)] * plan.n_ac
    assert all(c["kw"]["device"] == torch.device("cpu") for c in calls)
    assert log.rings == [] and log.transfers == []
    assert stats == fast_stats
    assert _equal(C, ring) and _equal(C, fast)
    _held_to_reference(C, _reference(), dense_only=backend == "pallas")


@functools.lru_cache(maxsize=None)
def _graph():
    ref_L, L = _lower("g500_s7")
    return ref_L, L


@functools.lru_cache(maxsize=None)
def _masked_reference():
    """``(L L) o L`` from the JAX package's L: C's structure is the mask's
    (L's), its values the reference's dense product at those entries."""
    ref_L, _ = _graph()
    dense = np.asarray(ref_to_dense(ref_L))
    product = np.asarray(jnp.matmul(ref_to_dense(ref_L), ref_to_dense(ref_L)))
    indptr, indices = np.asarray(ref_L.indptr), np.asarray(ref_L.indices)
    nnz = int(indptr[-1])
    rows = np.repeat(np.arange(dense.shape[0]), np.diff(indptr))
    return indptr, indices[:nnz], product[rows, indices[:nnz]]


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_masked_in_place_launches_once_a_strip(algorithm, request, monkeypatch):
    """The masked kernel in place on L x L masked by L, every role slow:
    one launch a strip (its A, mask and C_prev one strip, B whole), C equal
    bit for bit to the ring twin's and held to the reference's, and the
    triangle count the same through both routes."""
    _, L = _graph()
    plan, _ = _plans(algorithm, L.n_rows, L.n_rows)
    caps = masked_output_caps(L, plan.p_ac)
    spec = chunk_stream.backend_registry.get("hash")
    where, cpu = TABLE3["HostPin"], torch.device("cpu")
    ring, _ = spec.run_masked_placed(L, L, L, plan, caps.c_pad, caps, where, cpu)
    ring_count = triangle.count_triangles(L, plan=plan, placement=where, device="cpu")
    request.getfixturevalue("card_staging")
    calls = _spy(monkeypatch, "hash_masked_accum_spgemm_stream")
    C, _ = spec.run_masked_in_place(L, L, L, plan, caps.c_pad, caps, where, cpu)
    assert [c["lead"] for c in calls] == [(1, 1)] * plan.n_ac
    for c in calls:   # B whole, the strip's mask and C_prev
        _, Bst, C0, Mst = c["args"][:4]
        assert Bst.indptr.shape[1] == plan.n_b
        assert C0.indptr.shape[:2] == Mst.indptr.shape[:2] == (1, 1)
    assert _equal(C, ring)
    indptr, indices, values = _masked_reference()
    nnz = len(indices)
    np.testing.assert_array_equal(C.indptr.numpy(), indptr)
    np.testing.assert_array_equal(C.indices.numpy()[:nnz], indices)
    np.testing.assert_allclose(C.data.numpy()[:nnz], values, atol=ATOL, rtol=0)
    count = triangle.count_triangles(L, plan=plan, placement=where, device="cpu",
                                     slow_reads="in_place")
    assert float(count) == float(ring_count) == float(C.data.double().sum())


@pytest.mark.parametrize("backend", ("hash", "sparse", "pallas"))
def test_one_strip_launch_workspace_is_the_card_model(backend, card_staging, monkeypatch):
    """``placement.strip_workspace`` is what the wrapper allocates on the
    card for the strip it is given (the CSR merge's slabs a row, its count,
    the overflow flag and the chunk ranges; the dense slab's chunk starts),
    and with every operand slow it is all ``card_bytes`` holds in place."""
    _, _, A, P = _brick()
    plan, _ = _plans("chunk1", A.n_rows, P.n_rows)
    caps = strip_output_caps(A, P, plan.p_ac)
    calls = _spy(monkeypatch, WRAPPERS[backend])
    chunked_spgemm(A, P, plan, backend=backend, device="cpu", placement=ALL_SLOW,
                   slow_reads="in_place", caps=caps)
    row_cap = {"hash": hash_table_slots(caps.c_max_row_nnz), "sparse": caps.c_max_row_nnz,
               "pallas": 0}[backend]
    for c in calls:
        if backend == "pallas":
            a, slabs = c["args"][:2]
            rows, n_b = a.shape[2], slabs.shape[1]
            allocated = 4 * n_b                                    # the chunk starts
        else:
            g = stack_geometry(*c["args"][:3], "chunk1")
            rows, n_b = g["batch"] * g["n_ac"] * g["strip_rows"], g["n_b"]
            allocated = rows * row_cap * 8 + rows * 4 + 4 + 2 * 4 * n_b
            assert rows == max(e - s for s, e in zip(plan.p_ac[:-1], plan.p_ac[1:]))
        model = strip_workspace(backend, strip_rows=rows, n_b=n_b, row_cap=row_cap)
        assert model == allocated
        parts = card_bytes(plan, ALL_SLOW, a_stage=1, slab=1, c_stage=1, c_bytes=1,
                           workspace=model, slow_reads="in_place")
        assert parts["total"] == model


def test_capacity_plan_in_place_fits_under_the_cap():
    """brick3d n=80's capacity plan (chunk1 60 x 15 over 512,000 rows, its
    largest strip 9,955 rows) read in place holds one strip's workspace: its
    densest output row (an interior row of the stencil, the same at n=8 as
    at n=80) sizes the hash table, and the model sits under the capacity
    run's 35.8 MiB cap, where one launch for the whole call (every strip's
    slabs) would not."""
    A, _, P = (_port(m) for m in ref_mg.problem("brick3d", 8))
    table = hash_table_slots(strip_output_caps(A, P, (0, A.n_rows)).c_max_row_nnz)
    n_ac, n_b = CAPACITY_PLAN
    rest = CAPACITY_ROWS - CAPACITY_STRIP   # the other 59 strips share the rest
    p_ac = (0, *(CAPACITY_STRIP + rest * i // (n_ac - 1) for i in range(n_ac)))
    plan = ChunkPlan("chunk1", p_ac, tuple(range(n_b + 1)), 0.0, 0.0)
    assert plan.n_ac == n_ac and p_ac[-1] == CAPACITY_ROWS
    assert max(e - s for s, e in zip(p_ac[:-1], p_ac[1:])) == CAPACITY_STRIP
    one = strip_workspace("hash", strip_rows=CAPACITY_STRIP, n_b=n_b, row_cap=table)
    model = card_bytes(plan, ALL_SLOW, a_stage=0, slab=0, c_stage=0, c_bytes=0,
                       workspace=one, slow_reads="in_place")
    assert table == 32
    assert model["total"] == one == CAPACITY_STRIP * (32 * 8 + 4) + 4 + 8 * n_b == 2_588_424
    assert model["total"] < CAPACITY_CAP
    whole = strip_workspace("hash", strip_rows=CAPACITY_ROWS, n_b=n_b, row_cap=table)
    assert whole > 3 * CAPACITY_CAP


def test_probe_bound_pass_clean_and_flags_a_wrong_table(monkeypatch):
    """The probe-bound pass on the fast corpus's hash launches (staged,
    ring, in place a strip, batched in place) is clean, each record's bound
    the reference's ``probe_step_bound(hash_table_slots(...))`` of the
    case's densest row; a launch given a table twice the planner's is
    flagged with the reference's message, and so is a table of no slot or
    no launch at all."""
    rep = audit_all(backends=["hash"], cases="fast", analyses=["while"], device="cpu")
    assert rep["ok"], rep["violations"]
    records = {(r["case"], r["algorithm"]): r["while"] for r in rep["records"]}
    assert len(records) == len(corpus.FAST_CASES) * len(ALGORITHMS)
    for (case, algorithm), record in records.items():
        A, B = corpus.build_case(case, device="cpu")
        c_max = strip_output_caps(A, B, corpus.make_plan(algorithm, A, B).p_ac).c_max_row_nnz
        assert record["checked"] and record["launches"] > 0
        assert record["expected_bound"] == ref_probe_step_bound(
            ref_planner.hash_table_slots(c_max))
    assert audit_all(backends=["scan"], cases="fast", analyses=["while"],
                     device="cpu")["records"][0]["while"]["checked"] is False
    real = chunk_stream.hash_table_slots
    monkeypatch.setattr(chunk_stream, "hash_table_slots", lambda n: 2 * real(n))
    bad = audit_all(backends=["hash"], cases=[corpus.FAST_CASES[0]], algorithms=["chunk1"],
                    analyses=["while"], device="cpu")
    assert not bad["ok"]
    assert {v["analysis"] for v in bad["violations"]} == {"while"}
    assert "is not the planner-derived bound" in bad["violations"][0]["message"]
    assert check_while_bounds([0], expected_bound=None) != []
    assert check_while_bounds([], expected_bound=8) == [
        "no hash launch found, but the backend's probe loops were expected (hash kernel)"]
