"""The BSR container, the BSR kernels' plain versions and the ``bsr`` backend
against the JAX package.

* ``sparse/bsr.py``: conversions from dense (f32 and bf16) and from CSR give
  the reference's fields exactly; ``bsr_to_dense`` its dense matrix; the
  zero-sentinel contract refuses a tampered padding tail.
* ``bsr_spgemm_symbolic`` / ``bsr_spmm_symbolic``: tables equal to the
  reference's; the plain versions of ``bsr_spgemm_blocks`` and
  ``bsr_spmm_blocks`` against the reference Pallas kernels in interpret
  mode (atol 1e-4), and ``ops.bsr_spgemm`` / ``ops.bsr_spmm`` against the
  reference's (bf16: 5e-2, the reference's own tolerance).
* The ``bsr`` backend: ``bsr_plan_caps``, the block-capped envelope and
  ``planned_stats_bsr`` exact; ``chunk_bsr`` gives the reference's C
  (structure exact, values atol 1e-4) and ChunkStats under knl, chunk1 and
  chunk2 plans at block sizes 8 and 16; ``auto`` selects ``bsr`` exactly
  where the reference does.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import chunking as ref_chunking
from repro.core import planner as ref_planner
from repro.core.symbolic import bsr_plan_caps as ref_bsr_plan_caps
from repro.kernels import bsr_spgemm as ref_spgemm
from repro.kernels import bsr_spmm as ref_spmm
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.sparse import bsr as ref_bsr
from repro.sparse.csr import csr_from_dense as ref_csr_from_dense
from repro_torch.core import chunk_stream as port_cs
from repro_torch.core import chunking, planner
from repro_torch.core.symbolic import bsr_plan_caps
from repro_torch.kernels import bsr_spgemm, bsr_spmm, ops, ref
from repro_torch.kernels.convert import plan_from_fields
from repro_torch.sparse import bsr
from test_backend_conformance import CASES, _plan
from test_torch_sparse_accum import _port

ATOL = 1e-4


def _sprand(rng, m, n, density):
    return ((rng.random((m, n)) < density) * rng.standard_normal((m, n))).astype(np.float32)


def _bsr_pair(rng, bs, m=64, k=48, n=64, density=0.15):
    da, db = _sprand(rng, m, k, density), _sprand(rng, k, n, density)
    return (da, db), (ref_bsr.bsr_from_dense(da, bs), ref_bsr.bsr_from_dense(db, bs)), \
        (bsr.bsr_from_dense(da, bs, device="cpu"), bsr.bsr_from_dense(db, bs, device="cpu"))


def assert_bsr_equal(port, want):
    np.testing.assert_array_equal(port.block_indptr.numpy(), np.asarray(want.block_indptr))
    np.testing.assert_array_equal(port.block_indices.numpy(), np.asarray(want.block_indices))
    np.testing.assert_array_equal(port.blocks.float().numpy(),
                                  np.asarray(want.blocks, dtype=np.float32))
    assert (port.shape, port.block_size, port.max_row_blocks) == (
        want.shape, want.block_size, want.max_row_blocks)


@pytest.mark.parametrize("bs", [8, 16])
def test_bsr_container_matches_reference(bs):
    rng = np.random.default_rng(700 + bs)
    d = _sprand(rng, 64, 96, 0.05)
    pad = ref_bsr.bsr_from_dense(d, bs).nbl_pad + 7
    assert_bsr_equal(bsr.bsr_from_dense(d, bs, pad_to=pad, device="cpu"),
                     ref_bsr.bsr_from_dense(d, bs, pad_to=pad))
    assert_bsr_equal(bsr.bsr_from_dense(d, bs, keep_zero_blocks=True, device="cpu"),
                     ref_bsr.bsr_from_dense(d, bs, keep_zero_blocks=True))
    b16 = torch.tensor(d).to(torch.bfloat16)
    port16 = bsr.bsr_from_dense(b16, bs, device="cpu")
    assert port16.dtype == torch.bfloat16
    assert_bsr_equal(port16, ref_bsr.bsr_from_dense(jnp.asarray(d, jnp.bfloat16), bs))
    # from CSR (element shape padded up to a block multiple)
    e = _sprand(rng, 61, 45, 0.08)
    rc = ref_csr_from_dense(e)
    got = bsr.bsr_from_csr(_port(rc), bs)
    assert_bsr_equal(got, ref_bsr.bsr_from_csr(rc, bs))
    np.testing.assert_array_equal(bsr.bsr_to_dense(got).numpy(),
                                  np.asarray(ref_bsr.bsr_to_dense(ref_bsr.bsr_from_csr(rc, bs))))


def test_sentinel_rejects_tampered_padding_tail():
    rng = np.random.default_rng(619)
    dense = _sprand(rng, 16, 16, 0.3)
    m = bsr.bsr_from_dense(dense, 8, pad_to=6, device="cpu")
    ok = bsr.bsr_blocks_with_sentinel(m)
    assert ok.shape[0] == m.nbl_pad + 1 and not ok[-1].any()
    np.testing.assert_array_equal(
        ok.numpy(), np.asarray(ref_bsr.bsr_blocks_with_sentinel(
            ref_bsr.bsr_from_dense(dense, 8, pad_to=6))))
    blocks = m.blocks.clone()
    blocks[-1, 0, 0] = 1.0
    with pytest.raises(ValueError, match="zero-sentinel"):
        bsr.bsr_blocks_with_sentinel(dataclasses.replace(m, blocks=blocks))


@pytest.mark.parametrize("bs", [8, 16])
def test_bsr_spgemm_symbolic_and_plain_match_reference(bs):
    rng = np.random.default_rng(710 + bs)
    _, (rA, rB), (A, B) = _bsr_pair(rng, bs)
    tight = ref_spgemm.bsr_spgemm_symbolic(rA, rB)
    for kw in ({}, {"nc_pad": tight.nc_pad + 16, "u_max": tight.u_max + 2}):
        want = ref_spgemm.bsr_spgemm_symbolic(rA, rB, **kw)
        meta = bsr_spgemm.bsr_spgemm_symbolic(A, B, **kw)
        for f in dataclasses.fields(want):
            np.testing.assert_array_equal(getattr(meta, f.name), getattr(want, f.name))
        out = bsr_spgemm.bsr_spgemm_blocks(
            bsr.bsr_blocks_with_sentinel(A), bsr.bsr_blocks_with_sentinel(B),
            meta.a_slots, meta.b_slots, meta.nc_pad, meta.u_max, bs)
        ref_out = ref_spgemm.bsr_spgemm_blocks(
            ref_bsr.bsr_blocks_with_sentinel(rA), ref_bsr.bsr_blocks_with_sentinel(rB),
            jnp.asarray(want.a_slots), jnp.asarray(want.b_slots), nc_pad=want.nc_pad,
            u_max=want.u_max, bs=bs, interpret=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=ATOL, rtol=0)
        assert not out[meta.n_c_blocks:].any(), "padding rows must be zero tiles"
    with pytest.raises(ValueError, match="do not dominate"):
        bsr_spgemm.bsr_spgemm_symbolic(A, B, u_max=1)


@pytest.mark.parametrize(("dtype", "tol"), [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_ops_bsr_spgemm_matches_reference(dtype, tol):
    rng = np.random.default_rng(720)
    da, db = _sprand(rng, 64, 64, 0.2), _sprand(rng, 64, 64, 0.2)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    A = bsr.bsr_from_dense(torch.tensor(da).to(tdt), 8, device="cpu")
    B = bsr.bsr_from_dense(torch.tensor(db).to(tdt), 8, device="cpu")
    rA, rB = (ref_bsr.bsr_from_dense(jnp.asarray(x, jdt), 8) for x in (da, db))
    C = ops.bsr_spgemm(A, B)
    want = np.asarray(ref_bsr.bsr_to_dense(ref_ops.bsr_spgemm(rA, rB, interpret=True)))
    np.testing.assert_allclose(bsr.bsr_to_dense(C).numpy(), want, atol=tol, rtol=tol)
    np.testing.assert_allclose(ref.bsr_spgemm_ref(A, B).numpy(),
                               np.asarray(ref_ref.bsr_spgemm_ref(rA, rB)), atol=tol, rtol=tol)
    skip = ops.bsr_spgemm(A, B, skip_zero=False)
    np.testing.assert_allclose(bsr.bsr_to_dense(skip).numpy(),
                               bsr.bsr_to_dense(C).numpy(), atol=1e-5)


@pytest.mark.parametrize(("bs", "nf", "bn"), [(8, 128, 128), (16, 256, 128), (8, 64, 64)])
def test_bsr_spmm_matches_reference(bs, nf, bn):
    rng = np.random.default_rng(730 + bs + nf)
    da = _sprand(rng, 8 * bs, 6 * bs, 0.2)
    x = rng.standard_normal((6 * bs, nf)).astype(np.float32)
    A, rA = bsr.bsr_from_dense(da, bs, device="cpu"), ref_bsr.bsr_from_dense(da, bs)
    meta, want = bsr_spmm.bsr_spmm_symbolic(A), ref_spmm.bsr_spmm_symbolic(rA)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(meta, f.name), getattr(want, f.name))
    y = ops.bsr_spmm(A, torch.tensor(x), bn=bn)
    ref_y = ref_ops.bsr_spmm(rA, jnp.asarray(x), bn=bn, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ref.bsr_spmm_ref(A, torch.tensor(x)).numpy(),
                               np.asarray(ref_ref.bsr_spmm_ref(rA, jnp.asarray(x))),
                               atol=ATOL, rtol=1e-5)


BSR_CASES = ("skewed_rows", "dense_row", "wide_sparse_output")


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("algorithm", ["knl", "chunk1", "chunk2"])
@pytest.mark.parametrize("case", BSR_CASES)
def test_chunk_bsr_matches_reference(case, algorithm, bs):
    build, seed = CASES[case]
    rA, rB = build(np.random.default_rng(seed))
    ref_plan = _plan(algorithm, rA, rB)
    plan = plan_from_fields(*dataclasses.astuple(ref_plan))
    A, B = _port(rA), _port(rB)
    caps = ref_bsr_plan_caps(rA, rB, ref_plan, bs)
    assert dataclasses.astuple(bsr_plan_caps(A, B, plan, bs)) == dataclasses.astuple(caps)
    env = chunking.instance_envelope(A, B, plan, block_size=bs)
    ref_env = ref_chunking.instance_envelope(rA, rB, ref_plan, block_size=bs)
    assert dataclasses.astuple(env) == dataclasses.astuple(ref_env)
    assert (dataclasses.astuple(planner.planned_stats_bsr(plan, env))
            == dataclasses.astuple(ref_planner.planned_stats_bsr(ref_plan, ref_env)))
    want, want_stats = ref_chunking.chunked_spgemm(rA, rB, ref_plan, backend="bsr",
                                                   block_size=bs)
    got, stats = chunking.chunked_spgemm(A, B, plan, backend="bsr", block_size=bs)
    nnz = int(np.asarray(want.indptr)[-1])
    np.testing.assert_array_equal(got.indptr.numpy(), np.asarray(want.indptr))
    np.testing.assert_array_equal(got.indices.numpy()[:nnz], np.asarray(want.indices)[:nnz])
    np.testing.assert_allclose(got.data.numpy()[:nnz], np.asarray(want.data)[:nnz],
                               atol=ATOL, rtol=0)
    assert (stats.kernel_calls, stats.per_copy_in, stats.per_copy_out) == (
        want_stats.kernel_calls, tuple(want_stats.per_copy_in),
        tuple(want_stats.per_copy_out))


def test_bsr_stage_drops_zero_valued_blocks():
    """A stored entry that is an explicit zero keeps no block, as the
    reference's densify-then-block staging keeps none."""
    from repro_torch.kernels.convert import csr_from_fields

    m = csr_from_fields(np.array([0, 2, 3]), np.array([0, 9, 1]),
                        np.array([0.0, 2.0, 0.0], np.float32), (2, 16), 2, device="cpu")
    piece = port_cs._stage_bsr(m, 0, 2, 0, 16, 0, (8, 16), 8, 4)
    assert piece.n_blocks() == 1 and piece.block_indices.tolist()[:1] == [1]
    assert float(piece.blocks[0, 0, 1]) == 2.0


def test_auto_selects_bsr_where_the_reference_does():
    rng = np.random.default_rng(631)
    d = np.zeros((64, 64), np.float32)
    for i in range(8):
        d[i * 8:(i + 1) * 8, i * 8:(i + 1) * 8] = rng.standard_normal((8, 8))
    rA = ref_csr_from_dense(d)
    A = _port(rA)
    ref_plan = ref_planner.ChunkPlan("knl", (0, 64), (0, 32, 64), 0.0, 0.0)
    plan = plan_from_fields(*dataclasses.astuple(ref_plan))
    for block_size in (8, None):
        want = ref_planner.select_accumulator_backend(
            ref_plan, ref_chunking.instance_envelope(rA, rA, ref_plan, block_size=block_size))
        got = planner.select_accumulator_backend(
            plan, chunking.instance_envelope(A, A, plan, block_size=block_size))
        assert got == want
    assert planner.select_accumulator_backend(
        plan, chunking.instance_envelope(A, A, plan, block_size=8)) == "bsr"
    C, _ = chunking.chunked_spgemm(A, A, plan, backend="auto", block_size=8)
    want, _ = ref_chunking.chunked_spgemm(rA, rA, ref_plan, backend="auto", block_size=8)
    np.testing.assert_array_equal(C.indptr.numpy(), np.asarray(want.indptr))
    np.testing.assert_allclose(C.data.numpy()[: C.nnz()],
                               np.asarray(want.data)[: C.nnz()], atol=ATOL)
