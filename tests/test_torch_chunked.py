"""``chunked_spgemm`` through the port against the reference's loop oracle.

Multigrid operands (``A x P``) of two of the paper's problems at small size
run through every backend of the port — ``loop``, ``scan``, ``pallas``,
``sparse``, ``hash``, ``bsr`` and ``auto`` — under a ``knl``, a ``chunk1``
and a ``chunk2`` plan, and are held to ``repro.core.chunking.chunked_spgemm``
with ``backend="loop"`` on the same operands and plan: dense values within
atol 1e-4 for every backend, the CSR structure exactly for the CSR-output
ones, and ChunkStats equal to the reference's accounting for that backend.
``bsr`` keeps only nonzero sums, as the reference's does, so its structure
and stats are held to the reference's ``bsr`` run instead.
"""

import dataclasses
import functools

import numpy as np
import pytest

from repro.core import chunk_stream as ref_cs
from repro.core import chunking as ref_chunking
from repro.core import planner as ref_planner
from repro.core.memory_model import P100
from repro.core.symbolic import spgemm_structure_host, strip_output_caps
from repro.sparse import multigrid as ref_mg
from repro.sparse.csr import csr_to_dense
from repro_torch.core import planner as port_planner
from repro_torch.core.chunking import chunked_spgemm, instance_envelope
from repro_torch.kernels.convert import csr_from_fields, plan_from_fields
from repro_torch.sparse.csr import csr_to_dense as port_to_dense

ATOL = 1e-4
PROBLEMS = {"brick3d": 6, "elasticity": 4}
BACKENDS = ["loop", "scan", "pallas", "sparse", "hash", "bsr", "auto"]
ALGORITHMS = ["knl", "chunk1", "chunk2"]


def _port(m):
    return csr_from_fields(np.asarray(m.indptr), np.asarray(m.indices),
                           np.asarray(m.data), m.shape, m.max_row_nnz,
                           device="cpu")


def _thirds(n):
    return (0, n // 3, 2 * n // 3, n)


def _plan(A, P, algorithm):
    """The planner's plan for ``algorithm`` (quickstart's budget shape), or a
    thirds x thirds plan where the planner never picks it at this size."""
    ws = spgemm_structure_host(A, P)
    crb = np.full(A.n_rows, max(ws.c_nnz / A.n_rows, 1) * 12.0)
    full = (float(ref_planner.row_bytes_csr(A).sum()
                  + ref_planner.row_bytes_csr(P).sum()) + float(crb.sum()))
    if algorithm == "knl":
        b_bytes = float(ref_planner.row_bytes_csr(P).sum())
        return ref_planner.plan_knl(A, P, fast_limit_bytes=b_bytes / 3)
    plan = ref_planner.plan_chunks(A, P, crb, P100,
                                   fast_limit_bytes=full / (4 if algorithm == "chunk2" else 12))
    if plan.algorithm != algorithm:
        plan = ref_planner.ChunkPlan(algorithm, _thirds(A.n_rows), _thirds(P.n_rows), 0.0, 0.0)
    return plan


@functools.lru_cache(maxsize=None)
def _reference(problem, algorithm):
    A, _, P = ref_mg.problem(problem, PROBLEMS[problem])
    plan = _plan(A, P, algorithm)
    assert plan.algorithm == algorithm
    C, stats = ref_chunking.chunked_spgemm(A, P, plan, backend="loop")
    return A, P, plan, C, stats


def _expected_stats(A, P, plan, backend, ref_loop_stats):
    """The reference's accounting for ``backend`` on this plan."""
    if backend in ("loop", "scan"):
        return ref_loop_stats
    strips = ref_chunking.a_strips(A, plan.p_ac)
    chunks = ref_chunking.b_chunks(P, plan.p_b)
    if backend == "pallas":
        strip_rows = A.n_rows if plan.algorithm == "knl" else strips[0].n_rows
        return ref_cs.planned_stats_pallas(plan, *ref_cs._pallas_stage_nbytes(
            strip_rows, A.n_cols, chunks[0].n_rows, P.n_cols))
    c_pad = strip_output_caps(A, P, plan.p_ac).c_pad
    return ref_cs.planned_stats_pallas(
        plan, chunks[0].nbytes(), strips[0].nbytes(),
        ref_cs._c_strip_nbytes(strips[0].n_rows, c_pad, A.dtype))


def _stats_tuple(s):
    return (s.algorithm, s.n_ac, s.n_b, s.kernel_calls, s.copy_in_bytes,
            s.copy_out_bytes, tuple(s.per_copy_in), tuple(s.per_copy_out))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_chunked_matches_reference_loop(problem, algorithm, backend):
    A, P, ref_plan, C_ref, stats_ref = _reference(problem, algorithm)
    plan = plan_from_fields(*dataclasses.astuple(ref_plan))
    pA, pP = _port(A), _port(P)
    C, stats = chunked_spgemm(pA, pP, plan, backend=backend)
    np.testing.assert_allclose(port_to_dense(C).numpy(), np.asarray(csr_to_dense(C_ref)),
                               atol=ATOL, rtol=0)
    resolved = backend
    if backend == "auto":
        env = instance_envelope(pA, pP, plan)
        resolved = port_planner.select_accumulator_backend(plan, env)
        assert resolved == ref_planner.select_accumulator_backend(
            ref_plan, ref_chunking.instance_envelope(A, P, ref_plan))
    if resolved == "bsr":       # nonzero sums only: the reference's bsr run
        C_want, stats_want = ref_chunking.chunked_spgemm(A, P, ref_plan, backend="bsr")
        nnz = int(np.asarray(C_want.indptr)[-1])
        np.testing.assert_array_equal(C.indptr.numpy(), np.asarray(C_want.indptr))
        np.testing.assert_array_equal(C.indices.numpy()[:nnz],
                                      np.asarray(C_want.indices)[:nnz])
        np.testing.assert_allclose(C.data.numpy()[:nnz], np.asarray(C_want.data)[:nnz],
                                   atol=ATOL, rtol=0)
        assert _stats_tuple(stats) == _stats_tuple(stats_want)
        return
    if resolved != "pallas":   # the dense backend keeps only nonzero sums
        # entries past nnz are capacity padding (the knl loop keeps c_pad)
        nnz = int(np.asarray(C_ref.indptr)[-1])
        np.testing.assert_array_equal(C.indptr.numpy(), np.asarray(C_ref.indptr))
        np.testing.assert_array_equal(C.indices.numpy()[:nnz],
                                      np.asarray(C_ref.indices)[:nnz])
        np.testing.assert_allclose(C.data.numpy()[:nnz], np.asarray(C_ref.data)[:nnz],
                                   atol=ATOL, rtol=0)
    assert stats.kernel_calls == stats_ref.kernel_calls
    assert _stats_tuple(stats) == _stats_tuple(
        _expected_stats(A, P, ref_plan, resolved, stats_ref))
