"""The two-hop pipeline ``C = R x (A x P)`` with A, P and R in slow memory,
on the CPU, against the JAX package.

On brick3d n=6 at two plans (the spill plan of
``test_torch_pipeline_spill.py``, a quarter of size(A, P, R) by row bytes,
and a resident plan at size(A, P, R) whose hops are both chunked), every
backend and ``auto`` runs the pipeline with the spaces given explicitly
(``PipelinePlacement``): HostPin (A, P, R and C slow), DP (P fast) and one
slow operand at a time (the spill plan; HostPin and DP on the resident
one). Each C equals the all-fast pipeline call's bit for bit and, on the
spill plan, the reference's hash ``pipeline_spgemm`` (structure exactly
but for the dense and block backends, values within atol 1e-4); plans and
caps equal the reference's at both plans, and ``PipelineStats`` (each
hop's ChunkStats, ``spill_bytes``) equal the all-fast call's (which
``test_torch_pipeline_spill.py`` holds to the reference's per backend), and
under hash the reference's. Each hop's ring moves what
``chunked_spgemm`` moves for that hop's operands under the hop's placement
(A, P, T for hop 1; R, T, C for hop 2, T slow when spilled), which
``test_torch_placement*.py`` holds to the tagged events (replayed under
HostPin; every placement moves exactly its slow operands); under ``hash``
and ``sparse`` the bytes are checked against ``planned_events`` here too. A
resident plan whose hop 2 is whole_fast copies its slow operands whole.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.core import pipeline_spgemm as ref_pipe
from repro.core.memory_model import P100 as REF_P100
from repro.core.symbolic import pipeline_output_caps as ref_pipeline_caps
from repro.sparse.csr import csr_to_dense as ref_to_dense
from repro_torch.core import chunk_stream, chunking, copy_ring, pipeline_spgemm, planner
from repro_torch.core.memory_model import P100
from repro_torch.core.placement import (
    ALL_FAST, PIPELINE_TABLE3, Placement, PipelinePlacement, resolve_pipeline_placement,
)
from repro_torch.core.symbolic import pipeline_output_caps
from repro_torch.kernels.convert import plan_from_fields
from repro_torch.sparse.csr import csr_to_dense
from test_torch_pipeline_spill import _problem
from test_torch_sparse_accum import _port

ATOL = 1e-4
BACKENDS = ("loop", "scan", "pallas", "sparse", "hash", "bsr", "auto")
PLACEMENTS = {
    "HostPin": PIPELINE_TABLE3["HostPin"],
    "DP": PIPELINE_TABLE3["DP"],
    "A_slow": PipelinePlacement("slow", "fast", "fast", "fast"),
    "P_slow": PipelinePlacement("fast", "slow", "fast", "fast"),
    "R_slow": PipelinePlacement("fast", "fast", "slow", "fast"),
    "C_slow": PipelinePlacement("fast", "fast", "fast", "slow"),
}


def _limit(which):
    (rA, rR, rP), quarter = _problem()
    if which == "spill":
        return quarter
    return float(sum(m.nbytes() for m in (rA, rP, rR)))


@functools.lru_cache(maxsize=None)
def _reference(which, backend):
    (rA, rR, rP), _ = _problem()
    plan = ref_pipe.plan_pipeline(rA, rP, rR, REF_P100, fast_limit_bytes=_limit(which))
    caps = ref_pipeline_caps(rA, rP, rR, plan.plan1.p_ac, plan.plan2.p_ac)
    return plan, caps, ref_pipe.pipeline_spgemm(rA, rP, rR, plan, backend=backend, caps=caps)


@functools.lru_cache(maxsize=None)
def _port_case(which):
    (rA, rR, rP), _ = _problem()
    A, P, R = _port(rA), _port(rP), _port(rR)
    plan = planner.plan_pipeline(A, P, R, P100, fast_limit_bytes=_limit(which))
    return A, P, R, plan, pipeline_output_caps(A, P, R, plan.plan1.p_ac, plan.plan2.p_ac)


@functools.lru_cache(maxsize=None)
def _all_fast(which, backend):
    A, P, R, plan, caps = _port_case(which)
    return pipeline_spgemm.pipeline_spgemm(A, P, R, plan, backend=backend, caps=caps,
                                           device="cpu")


def _hop_logs(monkeypatch):
    """Each hop's ring records apart: ``[(X, Y, hop plan, caps, placement,
    RingLog), ...]`` in hop order."""
    hops, real = [], pipeline_spgemm._run_hop

    def spy(X, Y, plan, caps, backend, placement, device, *slow_reads):
        with copy_ring.RingLog() as log:
            out = real(X, Y, plan, caps, backend, placement, device, *slow_reads)
        hops.append((X, Y, plan, caps, placement, log))
        return out

    monkeypatch.setattr(pipeline_spgemm, "_run_hop", spy)
    return hops


def _tagged(log):
    return [(t.operand, t.direction, t.nbytes, t.apart) for t in log.transfers]


@pytest.mark.parametrize("which", ("spill", "resident"))
def test_plans_and_caps_equal_the_reference(which):
    (rA, rR, rP), _ = _problem()
    ref_plan = ref_pipe.plan_pipeline(rA, rP, rR, REF_P100, fast_limit_bytes=_limit(which))
    ref_caps = ref_pipeline_caps(rA, rP, rR, ref_plan.plan1.p_ac, ref_plan.plan2.p_ac)
    _, _, _, plan, caps = _port_case(which)
    assert plan.t_resident == ref_plan.t_resident == (which == "resident")
    for hop in ("plan1", "plan2"):
        assert getattr(plan, hop) == plan_from_fields(
            *dataclasses.astuple(getattr(ref_plan, hop)))
        assert getattr(plan, hop).algorithm != "whole_fast"
    assert plan.t_bytes == ref_plan.t_bytes
    for hop in ("hop1", "hop2"):
        assert dataclasses.astuple(getattr(caps, hop)) == dataclasses.astuple(
            getattr(ref_caps, hop))


# every placement on the spill plan; HostPin and DP on the resident one
CASES = ([("spill", name) for name in sorted(PLACEMENTS)]
         + [("resident", name) for name in ("HostPin", "DP")])


@pytest.mark.parametrize("which,name", CASES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_placed_pipeline_equals_all_fast_and_reference(which, backend, name, monkeypatch):
    A, P, R, plan, caps = _port_case(which)
    want, want_stats = _all_fast(which, backend)
    # the reference's hash pipeline on the spill plan: C's structure and
    # values are the backends' common ones, and test_torch_pipeline_spill.py
    # holds each backend's all-fast stats to the reference's
    _, _, (ref_C, ref_stats) = _reference("spill", "hash")
    if which == "resident":
        ref_C, ref_stats = None, None
    where = PLACEMENTS[name]
    hops = _hop_logs(monkeypatch)
    C, stats = pipeline_spgemm.pipeline_spgemm(A, P, R, plan, backend=backend, caps=caps,
                                               placement=where, device="cpu")
    for f in ("indptr", "indices", "data"):
        assert torch.equal(getattr(C, f), getattr(want, f)), f
    assert (stats.hop1, stats.hop2) == (want_stats.hop1, want_stats.hop2)
    assert (stats.spilled, stats.spill_bytes) == (want_stats.spilled, want_stats.spill_bytes)
    if ref_stats is None:
        ref_C, ref_stats = want, want_stats
    assert stats.spill_bytes == ref_stats.spill_bytes
    if backend == "hash" or ref_stats is want_stats:
        for hop in ("hop1", "hop2"):
            got, ref = getattr(stats, hop), getattr(ref_stats, hop)
            assert (got.per_copy_in, got.per_copy_out, got.kernel_calls) == (
                tuple(ref.per_copy_in), tuple(ref.per_copy_out), ref.kernel_calls)
    nnz = int(np.asarray(ref_C.indptr)[-1])
    ref_dense = (csr_to_dense(ref_C).numpy() if ref_C is want
                 else np.asarray(ref_to_dense(ref_C)))
    np.testing.assert_allclose(csr_to_dense(C).numpy(), ref_dense, atol=ATOL, rtol=0)
    if backend not in ("pallas", "bsr", "auto"):   # those keep only nonzero sums
        np.testing.assert_array_equal(C.indptr.numpy(), np.asarray(ref_C.indptr))
        np.testing.assert_array_equal(C.indices.numpy()[:nnz],
                                      np.asarray(ref_C.indices)[:nnz])
        np.testing.assert_allclose(C.data.numpy()[:nnz], np.asarray(ref_C.data)[:nnz],
                                   atol=ATOL, rtol=0)
    # each hop under its own placement: T slow when spilled, C in its space
    t = "slow" if which == "spill" else "fast"
    assert [h[4] for h in hops] == ([where.hop1(t)] if where.hop1("fast").slow else
                                    [ALL_FAST]) + [where.hop2(t)]
    for X, Y, hplan, hcaps, hwhere, log in hops:
        if not hwhere.slow:
            assert log.transfers == []
            continue
        assert {t.operand for t in log.transfers} == set(hwhere.slow)
        if name == "HostPin":   # the hop's ring is chunked_spgemm's for its operands
            with copy_ring.RingLog() as direct:
                chunking.chunked_spgemm(X, Y, hplan, hcaps.c_pad, backend=_resolved(
                    backend, X, Y, hplan, hcaps), placement=hwhere, device="cpu")
            assert _tagged(log) == _tagged(direct)
        if backend in ("hash", "sparse"):
            hstats = stats.hop1 if hplan == plan.plan1 else stats.hop2
            events = _events(hplan, hstats)
            for operand in "ABC":
                expect = [b for o, d, b in events
                          if o == operand and getattr(hwhere, operand) == "slow"]
                assert sum(log.moved(operand, "in") + log.moved(operand, "out")) == sum(expect)


def _resolved(backend, X, Y, plan, caps):
    """The backend ``auto`` resolves to on one hop's envelope."""
    if backend != "auto":
        return backend
    env = chunking.instance_envelope(X, Y, plan, caps=caps)
    return planner.select_accumulator_backend(plan, env)


def _events(plan, stats):
    ins = stats.per_copy_in
    if plan.algorithm == "chunk2":
        slab, a_stage, c_stage = ins[0], ins[2], ins[1] // plan.n_ac
    else:
        slab, a_stage, c_stage = ins[2], ins[0], ins[1]
    return chunk_stream.planned_events(plan, int(slab), int(a_stage), int(c_stage))


@pytest.mark.parametrize("backend", ("hash", "loop"))
def test_whole_fast_hop_copies_slow_operands_whole(backend, monkeypatch):
    """A resident plan whose hop 2 is whole_fast: R and C cross whole, and T
    (resident) stays where hop 1 put it."""
    (rA, rR, rP), quarter = _problem()
    A, P, R = _port(rA), _port(rP), _port(rR)
    plan = planner.plan_pipeline(A, P, R, P100, fast_limit_bytes=quarter * 4)
    assert plan.t_resident and plan.plan2.algorithm == "whole_fast"
    caps = pipeline_output_caps(A, P, R, plan.plan1.p_ac, plan.plan2.p_ac)
    want, want_stats = pipeline_spgemm.pipeline_spgemm(A, P, R, plan, backend=backend,
                                                       caps=caps, device="cpu")
    hops = _hop_logs(monkeypatch)
    C, stats = pipeline_spgemm.pipeline_spgemm(
        A, P, R, plan, backend=backend, caps=caps, placement=PIPELINE_TABLE3["HostPin"],
        device="cpu")
    for f in ("indptr", "indices", "data"):
        assert torch.equal(getattr(C, f), getattr(want, f)), f
    assert stats.hop2 == want_stats.hop2
    log = hops[1][5]
    assert log.moved("A", "in") == [R.nbytes()] and log.moved("B", "in") == []
    assert log.moved("C", "out") == [C.nbytes()]


def test_pipeline_placement_resolution():
    """On the CPU the spaces are the ones given (all fast by default, C
    following R's when not named); C takes R's space."""
    A, P, R, _, _ = _port_case("spill")
    ops = {"A": A, "P": P, "R": R}
    assert resolve_pipeline_placement(ops, None, "cpu") == (
        PIPELINE_TABLE3["HBM"], torch.device("cpu"))
    got, _ = resolve_pipeline_placement(ops, PipelinePlacement("slow", None, "slow"), "cpu")
    assert got == PipelinePlacement("slow", "fast", "slow", "slow")
    assert got.hop1("slow") == Placement("slow", "fast", "slow")
    assert got.hop2("fast") == Placement("slow", "fast", "slow")
    with pytest.raises(ValueError, match="space"):
        PipelinePlacement("pinned")

