"""The batched entry point of the port against the reference's.

The same seeded instances go through ``repro`` and ``repro_torch``:
``batch_envelope`` field by field (with and without block caps),
``replan_for_latency``, ``chunked_spgemm_batched`` on the heterogeneous
batches of ``tests/test_backend_conformance.py`` for every batched backend,
algorithm and ``auto`` (structure exactly equal for ``scan``, ``sparse`` and
``hash``, values within atol 1e-4 for every backend); the ``TRACE_COUNTS``
deltas are in ``test_torch_batched_traces.py``. Port-only: the scan
backend's batches equal its unbatched executor bit for bit on
same-structure batches, the BSR batch folds its instances' zero-sentinel
slots onto one shared slot, and under-capped envelopes raise.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import backend_registry as ref_registry
from repro.core import chunk_stream as ref_cs
from repro.core import chunking as ref_chunking
from repro.core import planner as ref_planner
from repro.sparse.csr import csr_from_dense as ref_from_dense
from repro.sparse.csr import csr_to_dense as ref_to_dense
from repro_torch.core import backend_registry, chunk_stream, chunking, planner
from repro_torch.core.symbolic import strip_output_caps
from repro_torch.kernels.bsr_spgemm import bsr_spgemm_plain
from repro_torch.kernels.convert import plan_from_fields
from repro_torch.sparse.csr import csr_from_dense, csr_to_dense
from conftest import random_dense
from test_backend_conformance import _plan

ATOL = 1e-4
ALGORITHMS = ["knl", "chunk1", "chunk2"]
BATCHED = ["scan", "pallas", "sparse", "hash", "bsr", "auto"]
EXACT_STRUCTURE = ("scan", "sparse", "hash")


def _pair(dense):
    """The same matrix as a reference CSR and a port CSR on the CPU."""
    return ref_from_dense(dense), csr_from_dense(dense, device="cpu")


def _port_plan(plan):
    return plan_from_fields(plan.algorithm, plan.p_ac, plan.p_b, plan.copy_bytes,
                            plan.fast_bytes_needed)


def _hetero(seed=207, m=18, k=15, n=13):
    """test_batched_hetero_conformance's batch: mixed densities and one
    structurally empty A, as dense arrays."""
    rng = np.random.default_rng(seed)
    a = [random_dense(rng, m, k, d) for d in (0.10, 0.30)]
    a.append(np.zeros((m, k), np.float32))
    b = [random_dense(rng, k, n, d) for d in (0.15, 0.25, 0.35)]
    return a, b


def _both(dense_list):
    pairs = [_pair(d) for d in dense_list]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _fields(env):
    return dataclasses.astuple(env)


def test_batched_backends_match_reference():
    assert backend_registry.batched_backends() == ref_registry.batched_backends() == (
        "scan", "pallas", "sparse", "hash", "bsr")
    assert backend_registry.all_backends() == ref_registry.all_backends()
    for spec in backend_registry.specs():
        ref = ref_registry.get(spec.name)
        assert (spec.trace_key, spec.trace_key_batched) == (ref.trace_key,
                                                            ref.trace_key_batched)
        assert spec.supports_batched == ref.supports_batched
        assert (spec.make_batched_cores is None) == (ref.make_batched_cores is None)


@pytest.mark.parametrize("block_size", [None, 8, 4])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_batch_envelope_matches_reference(algorithm, block_size):
    a, b = _hetero()
    ref_as, port_as = _both(a)
    ref_bs, port_bs = _both(b)
    plan = _plan(algorithm, ref_as[0], ref_bs[0])
    want = ref_chunking.batch_envelope(ref_as, ref_bs, plan, block_size=block_size)
    got = chunking.batch_envelope(port_as, port_bs, _port_plan(plan),
                                  block_size=block_size)
    assert _fields(got) == _fields(want)
    # a caller's c_pad overrides every instance's capacity, as in the reference
    want = ref_chunking.batch_envelope(ref_as, ref_bs, plan, c_pad=97)
    got = chunking.batch_envelope(port_as, port_bs, _port_plan(plan), c_pad=97)
    assert _fields(got) == _fields(want)
    assert _fields(got.quantized(8)) == _fields(want.quantized(8))


@pytest.mark.parametrize("p_b", [(0, 18), (0, 9, 18), (0, 6, 12, 18),
                                 (0, 3, 7, 10, 14, 18), (0, 1, 2, 3, 4, 5, 6, 18)])
def test_replan_for_latency_matches_reference(p_b):
    plan = ref_planner.ChunkPlan("knl", (0, 18), p_b, 123.0, 456.0)
    want = ref_planner.replan_for_latency(plan)
    got = planner.replan_for_latency(_port_plan(plan))
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


@pytest.mark.parametrize("backend", BATCHED)
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_batched_hetero_matches_reference(algorithm, backend):
    a, b = _hetero()
    ref_as, port_as = _both(a)
    ref_bs, port_bs = _both(b)
    plan = _plan(algorithm, ref_as[0], ref_bs[0])
    want, want_stats = ref_cs.chunked_spgemm_batched(ref_as, ref_bs, plan, backend=backend)
    got, got_stats = chunk_stream.chunked_spgemm_batched(port_as, port_bs, _port_plan(plan),
                                                         backend=backend, device="cpu")
    assert len(got) == len(want) == 3
    env = ref_chunking.batch_envelope(ref_as, ref_bs, plan)
    resolved = (ref_planner.select_accumulator_backend(plan, env) if backend == "auto"
                else backend)
    for i, (C, R) in enumerate(zip(got, want)):
        assert C.shape == R.shape and C.device.type == "cpu"
        np.testing.assert_allclose(csr_to_dense(C).numpy(), np.asarray(ref_to_dense(R)),
                                   atol=ATOL, err_msg=f"{algorithm}/{backend}/{i}")
        if resolved in EXACT_STRUCTURE:
            nnz = int(R.indptr[-1])
            assert C.nnz() == nnz
            np.testing.assert_array_equal(C.indptr.numpy(), np.asarray(R.indptr))
            np.testing.assert_array_equal(C.indices[:nnz].numpy(),
                                          np.asarray(R.indices)[:nnz])
    assert got_stats.kernel_calls == want_stats.kernel_calls
    assert got_stats.per_copy_in == tuple(want_stats.per_copy_in)
    assert got_stats.per_copy_out == tuple(want_stats.per_copy_out)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_scan_batched_equals_unbatched_bitwise(algorithm):
    """Same-structure batch (values differ): every instance of the batched
    scan equals the unbatched scan executor bit for bit."""
    rng = np.random.default_rng(51)
    a = random_dense(rng, 20, 16, 0.3)
    b = random_dense(rng, 16, 12, 0.3)
    scales = (1.0, -0.5, 3.25)
    As = [csr_from_dense(a * s, device="cpu") for s in scales]
    Bs = [csr_from_dense(b * (1 + s), device="cpu") for s in scales]
    plan = _port_plan(_plan(algorithm, As[0], Bs[0]))
    got, stats = chunk_stream.chunked_spgemm_batched(As, Bs, plan, backend="scan",
                                                     device="cpu")
    for A, B, C in zip(As, Bs, got):
        want, want_stats = chunking.chunked_spgemm(A, B, plan, backend="scan",
                                                   device="cpu")
        for f in ("indptr", "indices", "data"):
            assert torch.equal(getattr(C, f), getattr(want, f)), f
        assert stats == want_stats


def test_bsr_fold_shares_one_sentinel():
    """The BSR batch folds its instances into one launch: every step on an
    instance's own zero-sentinel slot lands on the one shared sentinel (the
    slot the kernel skips), no real step leaves its instance's blocks, and
    the folded launch's plain version equals the instances' own launches."""
    a, b = _hetero(seed=208, m=24, k=20, n=16)
    As = [csr_from_dense(d, device="cpu") for d in a]
    Bs = [csr_from_dense(d, device="cpu") for d in b]
    plan = _port_plan(_plan("chunk1", As[0], Bs[0]))
    env = chunking.batch_envelope(As, Bs, plan, block_size=4)
    bs, nbl_a, nbl_b, nc, u = env.bsr_caps
    width = len(As)
    folded = list(chunk_stream.stage_bsr_pairs_batched(As, Bs, plan, env))
    singles = [list(chunk_stream.stage_bsr_pairs(A, B, plan, env)) for A, B in zip(As, Bs)]
    assert len(folded) == plan.n_ac * plan.n_b
    for p, (ia, (ab, bb, sa, sb), metas) in enumerate(folded):
        assert ab.shape[0] == width * nbl_a + 1 and bb.shape[0] == width * nbl_b + 1
        assert sa.shape == (width * nc, u)
        out = bsr_spgemm_plain(ab, bb, sa, sb, width * nc, u, bs).view(width, nc, bs, bs)
        for w in range(width):
            own_a = torch.from_numpy(metas[w].a_slots)
            rows = sa[w * nc:(w + 1) * nc]
            dead = own_a == nbl_a
            assert bool((rows[dead] == width * nbl_a).all())
            live = rows[~dead]
            assert bool(((live >= w * nbl_a) & (live < (w + 1) * nbl_a)).all())
            s_ia, (sab, sbb, ssa, ssb), _ = singles[w][p]
            assert s_ia == ia
            want = bsr_spgemm_plain(sab, sbb, ssa, ssb, nc, u, bs)
            assert torch.equal(out[w], want)


@pytest.mark.parametrize("backend", ["sparse", "hash"])
def test_undercapped_batched_envelope_raises(backend):
    rng = np.random.default_rng(402)
    a = [random_dense(rng, 12, 10, d) for d in (0.15, 0.45)]
    b = [random_dense(rng, 10, 9, d) for d in (0.2, 0.45)]
    As = [csr_from_dense(d, device="cpu") for d in a]
    Bs = [csr_from_dense(d, device="cpu") for d in b]
    plan = _port_plan(_plan("chunk1", As[0], Bs[0]))
    env = chunking.batch_envelope(As, Bs, plan)
    caps1 = strip_output_caps(As[1], Bs[1], plan.p_ac)
    bad = dataclasses.replace(env, c_pad=max(caps1.strip_nnz) - 1)
    with pytest.raises(ValueError, match="batch instance 1"):
        chunk_stream.chunked_spgemm_batched(As, Bs, plan, envelope=bad, backend=backend,
                                            device="cpu")


def test_undercapped_hash_table_raises():
    rng = np.random.default_rng(403)
    As = [csr_from_dense(random_dense(rng, 12, 10, 0.5), device="cpu")]
    Bs = [csr_from_dense(random_dense(rng, 10, 9, 0.5), device="cpu")]
    plan = _port_plan(_plan("chunk1", As[0], Bs[0]))
    env = chunking.batch_envelope(As, Bs, plan)
    assert strip_output_caps(As[0], Bs[0], plan.p_ac).c_max_row_nnz > 2
    bad = dataclasses.replace(env, c_max_row_nnz=2)
    with pytest.raises(ValueError, match="hash-table capacity"):
        chunk_stream.chunked_spgemm_batched(As, Bs, plan, envelope=bad, backend="hash",
                                            device="cpu")


def test_batched_refusals():
    rng = np.random.default_rng(404)
    A = csr_from_dense(random_dense(rng, 12, 10, 0.3), device="cpu")
    B = csr_from_dense(random_dense(rng, 10, 9, 0.3), device="cpu")
    plan = _port_plan(_plan("chunk1", A, B))
    with pytest.raises(ValueError, match="does not support batched"):
        chunk_stream.chunked_spgemm_batched([A], [B], plan, backend="loop", device="cpu")
    with pytest.raises(ValueError, match="equal, nonzero"):
        chunk_stream.chunked_spgemm_batched([A, A], [B], plan, device="cpu")
    env = chunking.batch_envelope([A], [B], plan)
    with pytest.raises(ValueError, match="block-capped"):
        chunk_stream.chunked_spgemm_batched([A], [B], plan, envelope=env, backend="bsr",
                                            device="cpu")
    # instances on two devices ("meta" stands in for a second one here)
    M = dataclasses.replace(B, indptr=B.indptr.to("meta"), indices=B.indices.to("meta"),
                            data=B.data.to("meta"))
    with pytest.raises(ValueError, match="share a device"):
        chunk_stream.chunked_spgemm_batched([A, A], [B, M], plan, envelope=env, device="cpu")
