"""Fused-mask triangle counting and the masked hash merge against the JAX package.

* Counts: ``count_triangles`` (the fused masked path), ``count_triangles_kkmem``
  and ``count_triangles_dense`` of the port equal the reference's dense
  oracle on RMAT graphs of scale 7-8 and a 256-vertex power-law graph (the
  reference's bench graph classes), exactly; the reference's fused path
  itself is held to the port's executor below.
* The masked merge: the port's plain version (and its wrapper, which takes
  it for CPU tensors) against the reference Pallas kernel
  ``hash_masked_accum_spgemm_stream`` in interpret mode, on staged strips of
  conformance geometries under a random mask, with a nonzero ``C_prev``,
  both streaming orders: structure exact, values within atol 1e-4.
* The executor: ``chunk_hash_masked`` against the reference's under knl,
  chunk1 and chunk2 plans — C structure exact, values atol 1e-4, ChunkStats
  equal.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.core import backend_registry as ref_registry
from repro.core import chunk_stream as ref_cs
from repro.core import triangle as ref_tri
from repro.core.chunking import a_strips, b_chunks
from repro.core.planner import ChunkPlan, hash_table_slots, plan_knl
from repro.core.symbolic import masked_output_caps as ref_masked_caps
from repro.kernels import hash_accum_spgemm as ref_hash
from repro.sparse import graphs as ref_graphs
from repro.sparse.csr import csr_from_dense, csr_pad_to, csr_stack
from repro_torch.core import backend_registry
from repro_torch.core import chunk_stream as port_cs
from repro_torch.core import triangle
from repro_torch.core.symbolic import masked_output_caps
from repro_torch.kernels import hash_accum_spgemm as port_hash
from repro_torch.kernels.convert import csr_from_fields, plan_from_fields
from test_backend_conformance import CASES, _plan
from test_torch_sparse_accum import ORDERS, _port, assert_stacks_match

ATOL = 1e-4
GRAPHS = {
    "g500_s7": lambda g, **kw: g.rmat(7, 8, seed=1, **kw),
    "g500_s8": lambda g, **kw: g.rmat(8, 8, seed=4, **kw),
    "web_like": lambda g, **kw: g.rmat(7, 4, a=0.45, b=0.25, c=0.15, seed=3, **kw),
    "social_powerlaw": lambda g, **kw: g.powerlaw(256, 8, seed=2, **kw),
}
MASKED_CASES = ("dense_row", "duplicate_heavy", "empty_rows")


@functools.lru_cache(maxsize=None)
def _lower(name):
    ref_L = ref_graphs.lower_triangular_degree_sorted(GRAPHS[name](ref_graphs))
    return ref_L, _port(ref_L)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_triangle_counts_equal_reference(name):
    ref_L, L = _lower(name)
    want = float(ref_tri.count_triangles_dense(ref_L))
    assert want > 0
    fused = triangle.count_triangles(L, device="cpu")
    assert fused.dtype == torch.float64
    assert float(fused) == want
    assert float(triangle.count_triangles_kkmem(L)) == want
    assert float(triangle.count_triangles_dense(L)) == want


@pytest.mark.parametrize("algorithm", ["knl", "chunk1", "chunk2"])
def test_chunk_hash_masked_matches_reference(algorithm):
    ref_L, L = _lower("g500_s8")
    n = L.n_rows
    p_ac = (0, n) if algorithm == "knl" else (0, n // 4, n // 2, 3 * n // 4, n)
    ref_plan = ChunkPlan(algorithm, p_ac, (0, n // 3, 2 * n // 3, n), 0.0, 0.0)
    caps, ref_caps = masked_output_caps(L, p_ac), ref_masked_caps(ref_L, p_ac)
    assert dataclasses.astuple(caps) == dataclasses.astuple(ref_caps)
    want, want_stats = ref_cs.chunk_hash_masked(ref_L, ref_L, ref_L, ref_plan,
                                                ref_caps.c_pad, caps=ref_caps)
    got, stats = port_cs.chunk_hash_masked(
        L, L, L, plan_from_fields(*dataclasses.astuple(ref_plan)), caps.c_pad,
        caps=caps)
    nnz = int(np.asarray(want.indptr)[-1])
    np.testing.assert_array_equal(got.indptr.numpy(), np.asarray(want.indptr))
    np.testing.assert_array_equal(got.indices.numpy()[:nnz], np.asarray(want.indices)[:nnz])
    np.testing.assert_allclose(got.data.numpy()[:nnz], np.asarray(want.data)[:nnz],
                               atol=ATOL, rtol=0)
    # the output structure is the mask's
    np.testing.assert_array_equal(got.indptr.numpy(), L.indptr.numpy())
    assert (stats.algorithm, stats.n_ac, stats.n_b, stats.kernel_calls) == (
        want_stats.algorithm, want_stats.n_ac, want_stats.n_b, want_stats.kernel_calls)
    assert stats.per_copy_in == tuple(want_stats.per_copy_in)
    assert stats.per_copy_out == tuple(want_stats.per_copy_out)


def _masked_case_inputs(case: str):
    """A and B of a conformance geometry, a random mask (one row of it fully
    dense), a nonzero C_prev partly outside the mask, and a thirds plan."""
    build, seed = CASES[case]
    A, B = build(np.random.default_rng(seed))
    plan = _plan("chunk1", A, B)
    rng = np.random.default_rng(seed + 2000)
    m = rng.random((A.n_rows, B.n_cols)) < 0.3
    m[A.n_rows // 2] = True
    c0 = ((rng.random((A.n_rows, B.n_cols)) < 0.2)
          * rng.standard_normal((A.n_rows, B.n_cols))).astype(np.float32)
    return A, B, csr_from_dense(m.astype(np.float32)), csr_from_dense(c0), plan


def stage_masked_case(case: str):
    """Staged A strips / B chunks of a conformance geometry under a thirds
    plan, a random mask (one row of it fully dense), and a nonzero C_prev
    that is partly outside the mask. Returns the reference stacks, the port
    stacks, the chunk ranges and the table size."""
    A, B, M, C0, plan = _masked_case_inputs(case)
    caps = ref_masked_caps(M, plan.p_ac)
    c0_strips = a_strips(C0, plan.p_ac)
    c_cap = max(caps.c_pad, c0_strips[0].nnz_pad)
    Ast = csr_stack([csr_stack(a_strips(A, plan.p_ac))])
    Bst = csr_stack([csr_stack(b_chunks(B, plan.p_b))])
    C0st = csr_stack([csr_stack([csr_pad_to(s, c_cap) for s in c0_strips])])
    Mst = csr_stack([csr_stack(a_strips(M, plan.p_ac))])
    ref = (Ast, Bst, C0st, Mst)
    r0s, r1s = plan.b_ranges()
    return ref, tuple(_port(s) for s in ref), (r0s, r1s), hash_table_slots(caps.c_max_row_nnz)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("case", MASKED_CASES)
def test_masked_plain_matches_reference_kernel(case, order):
    ref, port, (r0s, r1s), table = stage_masked_case(case)
    want = ref_hash.hash_masked_accum_spgemm_stream(*ref, r0s, r1s, order=order,
                                                    table_size=table, interpret=True)
    got = port_hash.hash_masked_plain(*port, r0s, r1s, order=order, table_size=table)
    assert_stacks_match(got, want)
    via_wrapper = port_hash.hash_masked_accum_spgemm_stream(
        *port, r0s, r1s, order=order, table_size=table)
    for a, b in zip(via_wrapper, got):
        assert torch.equal(a, b)
    # every strip's output structure is its mask strip's
    assert torch.equal(got[0], port[3].indptr)


@pytest.mark.parametrize("case", MASKED_CASES)
def test_stage_hash_masked_with_c_prev_matches_reference_stacks(case):
    """The executor's staging, given a C_prev (the path the card checks
    take), stacks what the reference's strip helpers stack."""
    _, port, (r0s, r1s), table = stage_masked_case(case)
    *matrices, ref_plan = _masked_case_inputs(case)
    A, B, M, C0 = (_port(x) for x in matrices)
    plan = plan_from_fields(*dataclasses.astuple(ref_plan))
    caps = masked_output_caps(M, plan.p_ac)
    operands, got_table, stats = port_cs.stage_hash_masked(A, B, M, plan, caps.c_pad,
                                                           caps, c_prev=C0)
    assert got_table == table and stats.n_ac == plan.n_ac
    for got, want in zip(operands[:4], port):
        for field in ("indptr", "indices", "data"):
            assert torch.equal(getattr(got, field), getattr(want, field)), field
    assert list(operands[4]) == list(r0s) and list(operands[5]) == list(r1s)


def test_masked_mask_contract_raises():
    """A table below the densest mask row, an unsorted mask row and a mask
    strip larger than the output capacity all fail loudly."""
    _, (Ast, Bst, C0st, Mst), (r0s, r1s), table = stage_masked_case("dense_row")
    with pytest.raises(ValueError, match="exceeds the hash table"):
        port_hash.hash_masked_plain(Ast, Bst, C0st, Mst, r0s, r1s,
                                    order="chunk1", table_size=table // 4)
    ix = Mst.indices.clone()
    ix[0, 0, :2] = ix[0, 0, :2].flip(0)
    swapped = dataclasses.replace(Mst, indices=ix)
    with pytest.raises(ValueError, match="strictly increasing"):
        port_hash.hash_masked_plain(Ast, Bst, C0st, swapped, r0s, r1s,
                                    order="chunk1", table_size=table)
    small = dataclasses.replace(C0st, indices=C0st.indices[..., :4],
                                data=C0st.data[..., :4])
    with pytest.raises(ValueError, match="output capacity"):
        port_hash.hash_masked_plain(Ast, Bst, small, Mst, r0s, r1s,
                                    order="chunk1", table_size=table)


def test_masked_bins_cover_every_mask_row_once():
    """The kernel's launches: every row with a nonempty mask row in exactly
    one part (no row here outgrows a part), by its table of at least twice
    its nnz; each shared-memory launch reserves exactly its parts' table;
    global tables sized per row, offsets packed."""
    counts = np.array([0, 1, 32, 33, 256, 257, 1024, 1025, 8192, 8193, 40000, 3])
    n_cols = 50000
    ptr = np.concatenate([[0], np.cumsum(counts)])
    idx = np.concatenate([np.arange(c) for c in counts]).astype(np.int32)
    M = csr_from_fields(ptr, idx, np.ones(idx.size, np.float32), (counts.size, n_cols),
                        int(counts.max()), device="cpu")
    stack = lambda m: dataclasses.replace(  # noqa: E731
        m, indptr=m.indptr[None, None], indices=m.indices[None, None],
        data=m.data[None, None])
    A = csr_from_fields(np.arange(counts.size + 1), np.zeros(counts.size, np.int32),
                        np.ones(counts.size, np.float32), (counts.size, 1), 1, device="cpu")
    B = csr_from_fields(np.array([0, 2]), np.array([0, 1], np.int32),
                        np.ones(2, np.float32), (1, n_cols), 2, device="cpu")
    Mst = stack(M)
    work = port_hash.masked_work(stack(A), stack(B), Mst, [0], [1], 132)
    launches = port_hash.masked_launches(work, Mst)
    rows = launches.parts[:, 0].tolist()
    assert sorted(rows) == [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11]
    assert rows == [1, 11, 2, 3, 4, 5, 6, 7, 8, 9, 10]
    assert [port_hash.masked_table_slots(c) for c in (1, 32, 33, 8193, 40000)] == [
        2, 64, 128, 32768, 131072]
    # every table is one power of two of at least twice the row's nnz, and
    # each shared launch reserves exactly its parts' table
    sizes = launches.slots.tolist()
    assert sizes == [port_hash.masked_table_slots(c) for c in counts[rows]]
    ends = np.cumsum([g[2] for g in launches.groups])
    for (team, slots, n, _), end in zip(launches.groups, ends):
        if team < 2:
            assert sizes[end - n:end] == [slots] * n
            assert slots <= port_hash.MASKED_SHARED_MAX
    assert [g[:3] for g in launches.groups][-1] == (2, 0, 2)
    assert launches.grows.tolist() == [9, 10]
    assert launches.goff.tolist() == [0, 32768, 32768 + 131072]


def test_masked_backend_roster_matches_reference():
    assert backend_registry.masked_backends() == ref_registry.masked_backends() == ("hash",)
    with pytest.raises(ValueError, match="does not support a fused output mask"):
        triangle.count_triangles(_lower("g500_s7")[1], backend="sparse", device="cpu")
    L = _lower("g500_s7")[1]
    plan = plan_from_fields(*dataclasses.astuple(plan_knl(_lower("g500_s7")[0],
                                                          _lower("g500_s7")[0],
                                                          float("inf"))))
    assert float(triangle.count_triangles(L, plan=plan, device="cpu")) == float(
        triangle.count_triangles(L, device="cpu"))
