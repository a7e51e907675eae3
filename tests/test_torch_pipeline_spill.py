"""The spilled two-hop pipeline ``C = R x (A x P)`` under every backend, on
the CPU, against the JAX package.

With a fast limit of a quarter of size(A, P, R) on brick3d n=6 the planner
spills the intermediate T: hop 1 writes it to slow memory and hop 2 streams
it as its B operand through the backend's copy ring. Under ``loop``,
``scan``, ``pallas``, ``sparse``, ``hash`` and ``bsr`` the port's
``pipeline_spgemm`` must give the reference's spilled pipeline on the same
plan: structure exact, values within atol 1e-4, ``spill_bytes`` and both
hops' ChunkStats exact. Only T crosses, through one ring, and its bytes are
hop 2's B events under that backend.
"""

import dataclasses
import functools

import numpy as np
import pytest

from repro.core import pipeline_spgemm as ref_pipe
from repro.core.memory_model import P100 as REF_P100
from repro.core.planner import row_bytes_csr as ref_row_bytes
from repro.core.symbolic import pipeline_output_caps as ref_pipeline_caps
from repro.sparse import multigrid as ref_mg
from repro_torch.analysis.dma import check_ring_structure
from repro_torch.core import chunk_stream, copy_ring, pipeline_spgemm, planner
from repro_torch.core.chunking import (
    a_strips, b_chunks, instance_envelope, planned_events_ranged,
)
from repro_torch.core.memory_model import P100
from repro_torch.core.symbolic import pipeline_output_caps
from repro_torch.kernels.convert import plan_from_fields
from test_torch_sparse_accum import _port

ATOL = 1e-4
BACKENDS = ("loop", "scan", "pallas", "sparse", "hash", "bsr")


def _stats_tuple(s):
    return (s.algorithm, s.n_ac, s.n_b, s.kernel_calls, s.copy_in_bytes,
            s.copy_out_bytes, tuple(s.per_copy_in), tuple(s.per_copy_out))


@functools.lru_cache(maxsize=None)
def _problem():
    rA, rR, rP = ref_mg.problem("brick3d", 6)
    total = float(sum(ref_row_bytes(m).sum() for m in (rA, rP, rR)))
    return (rA, rR, rP), total * 0.25


@functools.lru_cache(maxsize=None)
def _reference(backend):
    (rA, rR, rP), limit = _problem()
    plan = ref_pipe.plan_pipeline(rA, rP, rR, REF_P100, fast_limit_bytes=limit)
    caps = ref_pipeline_caps(rA, rP, rR, plan.plan1.p_ac, plan.plan2.p_ac)
    C, stats = ref_pipe.pipeline_spgemm(rA, rP, rR, plan, backend=backend, caps=caps)
    return plan, C, stats


def _b_events(backend, R, T, plan, caps) -> list:
    """Hop 2's B events under ``backend``, at the port's staged sizes."""
    chunks = b_chunks(T, plan.p_b)
    strips = a_strips(R, plan.p_ac)
    c_pad = caps.c_pad
    if backend == "pallas":
        events = chunk_stream.planned_events(plan, *chunk_stream._pallas_stage_nbytes(
            strips[0].n_rows, R.n_cols, chunks[0].n_rows, T.n_cols))
    elif backend == "bsr":
        env = instance_envelope(R, T, plan, c_pad=c_pad, caps=caps,
                                block_size=chunk_stream._BSR_DEFAULT_BLOCK)
        slab, a_stage, _ = chunk_stream._bsr_stage_nbytes(env)
        events = chunk_stream.planned_events_bsr(plan, slab, a_stage, 0, 0)
    elif backend in ("loop", "scan"):
        events = planned_events_ranged(
            plan, chunks[0].nbytes(), strips[0].nbytes(),
            chunk_stream._c_strip_nbytes(strips[0].n_rows, c_pad, R.dtype))
    else:
        events = chunk_stream.planned_events(
            plan, chunks[0].nbytes(), strips[0].nbytes(),
            chunk_stream._c_strip_nbytes(strips[0].n_rows, c_pad, R.dtype))
    return [b for o, d, b in events if (o, d) == ("B", "in")]


@pytest.mark.parametrize("backend", BACKENDS)
def test_spilled_pipeline_matches_reference(backend, monkeypatch):
    ref_plan, want, want_stats = _reference(backend)
    (rA, rR, rP), limit = _problem()
    A, P, R = _port(rA), _port(rP), _port(rR)
    plan = planner.plan_pipeline(A, P, R, P100, fast_limit_bytes=limit)
    assert not plan.t_resident and not ref_plan.t_resident
    assert plan.plan1 == plan_from_fields(*dataclasses.astuple(ref_plan.plan1))
    assert plan.plan2 == plan_from_fields(*dataclasses.astuple(ref_plan.plan2))
    caps = pipeline_output_caps(A, P, R, plan.plan1.p_ac, plan.plan2.p_ac)
    spilled = []
    real = pipeline_spgemm._spill_to_slow

    def spy(T):
        spilled.append(real(T))
        return spilled[-1]

    monkeypatch.setattr(pipeline_spgemm, "_spill_to_slow", spy)
    with copy_ring.RingLog() as log:
        C, stats = pipeline_spgemm.pipeline_spgemm(A, P, R, plan, backend=backend,
                                                   caps=caps, device="cpu")
    nnz = int(np.asarray(want.indptr)[-1])
    np.testing.assert_array_equal(C.indptr.numpy(), np.asarray(want.indptr))
    np.testing.assert_array_equal(C.indices.numpy()[:nnz], np.asarray(want.indices)[:nnz])
    np.testing.assert_allclose(C.data.numpy()[:nnz], np.asarray(want.data)[:nnz],
                               atol=ATOL, rtol=0)
    assert stats.spilled and want_stats.spilled
    assert stats.spill_bytes == want_stats.spill_bytes
    assert _stats_tuple(stats.hop1) == _stats_tuple(want_stats.hop1)
    assert _stats_tuple(stats.hop2) == _stats_tuple(want_stats.hop2)
    # only T (hop 2's B) crossed, through one ring, as hop 2's B events say
    (T,) = spilled
    assert [r.operand for r in log.rings] == ["B"]
    ring = log.rings[0]
    assert check_ring_structure(ring.ops, ring.total, ring.n_fields) == []
    assert ring.n_fields == {"pallas": 1}.get(backend, 3)
    assert log.moved("B", "in") == _b_events(backend, R, T, plan.plan2, caps.hop2)
    assert [t for t in log.transfers if t.operand != "B"] == []
