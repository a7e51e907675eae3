"""Slow operands read in place (``slow_reads="in_place"``) under ``pallas``,
``sparse`` and ``hash``, on the CPU, held to the JAX package and to the
port's own all-fast call.

On the card the in-place executors build each slow operand's stacks in
pinned host memory and launch the backend's streaming kernel once, reading
them where they lie. Here both spaces are host memory, so the same executors
run the kernels' plain versions on the same stacks; ``torch.Tensor.is_pinned``
is patched to True (as in ``tests/test_torch_placement*.py``) so that every
operand looks like a slow one to the wrappers and the placement is named
explicitly, and the executors stage as for a launch on the card
(:func:`card_staging`): each slow operand's stacks, and a slow C's, go
through the pinned builds, which make host memory here as there. For three conformance geometries, one per algorithm (knl,
chunk1, chunk2), x the three backends x Table 3's five placements with a
slow operand: C's structure equal to the reference's ``chunked_spgemm`` of
the same backend on the same plan and its values within atol 1e-4 (the
dense slab's densified, its CSR keeping only nonzero sums), as the
reference's own tests hold it; C equal bit for bit to the port's all-fast
call; the ChunkStats equal; and no ring op or transfer logged.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.core import chunking as ref_chunking
from repro.sparse.csr import csr_to_dense as ref_to_dense
from repro_torch.core import chunk_stream, copy_ring
from repro_torch.core.chunking import chunked_spgemm
from repro_torch.core.placement import TABLE3
from repro_torch.kernels.convert import plan_from_fields
from repro_torch.sparse.csr import csr_to_dense
from test_backend_conformance import CASES, _plan
from test_torch_sparse_accum import _port

# one geometry per algorithm: knl, chunk1 and chunk2 each over a case that
# stresses it (empty rows, a skewed row, a dense output row)
CASE_ALGORITHMS = (("skewed_rows", "knl"), ("dense_row", "chunk1"),
                   ("empty_rows", "chunk2"))
BACKENDS = ("pallas", "sparse", "hash")
SLOW_PLACEMENTS = ("A_Pin", "B_Pin", "C_Pin", "HostPin", "DP")
ATOL = 1e-4  # float32 sums in another order than the reference's


@functools.lru_cache(maxsize=None)
def _reference(case, algorithm, backend):
    build, seed = CASES[case]
    A, B = build(np.random.default_rng(seed))
    plan = _plan(algorithm, A, B)
    c_pad = ref_chunking.default_c_pad(A, B, plan)
    C, stats = ref_chunking.chunked_spgemm(A, B, plan, c_pad, backend=backend)
    return A, B, plan, C, stats


@pytest.fixture
def card_staging(monkeypatch):
    """Stage as an in-place call on the card does: ``_pinned_for`` answers
    for a card, pinned allocations are made in host memory (the only memory
    here) and every pinned build is recorded: returns the list of pinned
    builds, ``"csr"`` for a CSR stack (``csr_pin``) and ``"dense"`` for a
    dense one."""
    builds = []
    pinned_for, csr_pin, zeros = chunk_stream._pinned_for, chunk_stream.csr_pin, torch.zeros
    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self, *a, **k: True)
    monkeypatch.setattr(chunk_stream, "_pinned_for",
                        lambda placement, device: pinned_for(placement, torch.device("cuda", 0)))

    def pin_csr(m):
        builds.append("csr")
        return csr_pin(m)

    def host_zeros(*args, pin_memory=False, **kw):
        if pin_memory:
            builds.append("dense")
        return zeros(*args, **kw)

    monkeypatch.setattr(chunk_stream, "csr_pin", pin_csr)
    monkeypatch.setattr(torch, "zeros", host_zeros)
    return builds


def _pinned_builds(backend, where) -> list:
    """The pinned builds of one in-place call under ``where``: the dense
    slab's strips, slabs and C block, then a slow C's CSR; the CSR
    executors' strip and chunk stacks, then a slow C's C_prev and C."""
    slow = [getattr(where, k) == "slow" for k in "ABC"]
    if backend == "pallas":
        return ["dense"] * sum(slow) + ["csr"] * slow[2]
    return ["csr"] * (slow[0] + slow[1] + 2 * slow[2])


def _stats_tuple(s):
    return (s.algorithm, s.n_ac, s.n_b, s.kernel_calls, s.copy_in_bytes,
            s.copy_out_bytes, tuple(s.per_copy_in), tuple(s.per_copy_out))


def _all_fast(pA, pB, plan, backend):
    return chunked_spgemm(pA, pB, plan, backend=backend, device="cpu")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case,algorithm", CASE_ALGORITHMS)
def test_in_place_matches_reference_and_all_fast(case, algorithm, backend, request):
    A, B, ref_plan, C_ref, stats_ref = _reference(case, algorithm, backend)
    pA, pB = _port(A), _port(B)
    plan = plan_from_fields(*dataclasses.astuple(ref_plan))
    C_fast, stats_fast = _all_fast(pA, pB, plan, backend)
    assert _stats_tuple(stats_fast) == _stats_tuple(stats_ref)
    builds = request.getfixturevalue("card_staging")
    for name in SLOW_PLACEMENTS:
        builds.clear()
        with copy_ring.RingLog() as log:
            C, stats = chunked_spgemm(pA, pB, plan, backend=backend, device="cpu",
                                      placement=TABLE3[name], slow_reads="in_place")
        assert builds == _pinned_builds(backend, TABLE3[name]), name
        assert log.rings == [] and log.transfers == [], name
        for f in ("indptr", "indices", "data"):
            assert torch.equal(getattr(C, f), getattr(C_fast, f)), (name, f)
        assert stats == stats_fast, name
        if backend == "pallas":
            np.testing.assert_allclose(csr_to_dense(C).numpy(),
                                       np.asarray(ref_to_dense(C_ref)), atol=ATOL)
            continue
        nnz = C.nnz()
        assert nnz == int(C_ref.indptr[-1])
        np.testing.assert_array_equal(C.indptr.numpy(), np.asarray(C_ref.indptr))
        np.testing.assert_array_equal(C.indices[:nnz].numpy(),
                                      np.asarray(C_ref.indices)[:nnz])
        np.testing.assert_allclose(C.data[:nnz].numpy(), np.asarray(C_ref.data)[:nnz],
                                   atol=ATOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_in_place_with_every_operand_fast_is_the_all_fast_call(backend, monkeypatch):
    """``slow_reads="in_place"`` with nothing slow (the paper's HBM) is the
    one launch of the all-fast call: the same C and stats, no ring."""
    A, B, ref_plan, _, _ = _reference("skewed_rows", "knl", backend)
    pA, pB = _port(A), _port(B)
    plan = plan_from_fields(*dataclasses.astuple(ref_plan))
    C_fast, stats_fast = _all_fast(pA, pB, plan, backend)
    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self, *a, **k: True)
    with copy_ring.RingLog() as log:
        C, stats = chunked_spgemm(pA, pB, plan, backend=backend, device="cpu",
                                  placement=TABLE3["HBM"], slow_reads="in_place")
    assert log.rings == [] and log.transfers == []
    assert stats == stats_fast
    for f in ("indptr", "indices", "data"):
        assert torch.equal(getattr(C, f), getattr(C_fast, f)), f
