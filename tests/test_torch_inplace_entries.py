"""The pipeline, the batched entry point and the service read slow operands
in place, on the CPU.

``pipeline_spgemm``, ``chunked_spgemm_batched`` and ``SpGEMMService`` take
``slow_reads="in_place"`` as ``chunked_spgemm`` does: the streaming kernel
of the hop, batch or flush reads each slow operand where it lies, one launch
a strip of the plan (for the whole batch), and nothing crosses the copy
ring. Here the executors stage as for the card (``card_staging``) and the
kernels' plain versions run. With every operand slow under ``hash``,
``sparse``, ``pallas`` and ``auto``: the spilled Galerkin product of brick3d
n=6 (T written in place by hop 1 and read in place by hop 2) equal bit for
bit to the ring twin and the all-fast call and held to the JAX package's
product R (A P); the heterogeneous batch of ``test_torch_batched.py`` under knl,
chunk1 and chunk2 equal bit for bit to its ring twin and all-fast call and
held to the JAX package's product of each instance; the placed service's responses
equal bit for bit to the ring service's and the all-fast service's, with
no compile in the warm wave. ``scan``, ``loop``, ``bsr``, a whole_fast hop
and ``auto`` resolving to a backend without such a kernel raise, naming
the ring.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sparse.csr import csr_to_dense as ref_to_dense
from repro_torch.core import chunk_stream, copy_ring, pipeline_spgemm, planner
from repro_torch.core.memory_model import P100
from repro_torch.core.placement import PIPELINE_TABLE3, TABLE3
from repro_torch.core.symbolic import pipeline_output_caps
from repro_torch.serve.spgemm_service import SpGEMMService
from repro_torch.sparse.csr import csr_to_dense
from test_backend_conformance import _plan
from test_torch_batched import _both, _hetero, _port_plan
from test_torch_inplace_parity import card_staging  # noqa: F401  (a fixture)
from test_torch_pipeline_placed import _all_fast, _port_case
from test_torch_pipeline_spill import _problem
from test_torch_service_placed import PLAN, _requests

ATOL = 1e-4
IN_PLACE = ("hash", "sparse", "pallas", "auto")
WRAPPERS = {"hash": "hash_accum_spgemm_stream", "sparse": "sparse_accum_spgemm_stream",
            "pallas": "ranged_spgemm_stream"}
RING = "use slow_reads='ring'"


def _equal(got, want):
    return all(torch.equal(getattr(got, f), getattr(want, f))
               for f in ("indptr", "indices", "data"))


def _count_calls(monkeypatch, name):
    """The A stacks' leading axes of every call of the wrapper ``name``."""
    calls, real = [], getattr(chunk_stream, name)

    def spy(*args, **kw):
        a = args[0]
        calls.append(tuple((a if isinstance(a, torch.Tensor) else a.indptr).shape[:2]))
        return real(*args, **kw)

    monkeypatch.setattr(chunk_stream, name, spy)
    return calls


def _held(C, want: np.ndarray):
    """C within atol of the JAX package's dense product (its structure is
    the all-fast call's, bit for bit, which the placed tests hold to the
    reference's)."""
    np.testing.assert_allclose(csr_to_dense(C).numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("backend", IN_PLACE)
def test_pipeline_in_place_equals_ring_all_fast_and_reference(backend, request, monkeypatch):
    """The spilled Galerkin product with A, P, R and C slow: each hop
    launches once a strip (the spilled T written in place by hop 1, read
    in place by hop 2), no ring op; C and the PipelineStats equal the ring
    twin's and the all-fast call's, C held to the reference's product."""
    A, P, R, plan, caps = _port_case("spill")
    where = PIPELINE_TABLE3["HostPin"]
    want, want_stats = _all_fast("spill", backend)
    ring, _ = pipeline_spgemm.pipeline_spgemm(A, P, R, plan, backend=backend, caps=caps,
                                              placement=where, device="cpu")
    builds = request.getfixturevalue("card_staging")
    resolved = {h: planner.select_accumulator_backend(hp, chunk_stream.instance_envelope(
        X, Y, hp, caps=hc)) if backend == "auto" else backend
        for h, hp, hc, X, Y in (("hop1", plan.plan1, caps.hop1, A, P),
                                ("hop2", plan.plan2, caps.hop2, R, caps.t_pattern))}
    spies = {b: _count_calls(monkeypatch, WRAPPERS[b]) for b in set(resolved.values())}
    with copy_ring.RingLog() as log:
        C, stats = pipeline_spgemm.pipeline_spgemm(A, P, R, plan, backend=backend, caps=caps,
                                                   placement=where, device="cpu",
                                                   slow_reads="in_place")
    assert log.rings == [] and log.transfers == []
    assert sum(len(c) for c in spies.values()) == plan.plan1.n_ac + plan.plan2.n_ac
    assert all(lead == (1, 1) for c in spies.values() for lead in c)
    assert builds   # the slow stacks, T among them, built as pinned ones
    assert _equal(C, want) and _equal(C, ring)
    assert (stats.hop1, stats.hop2, stats.spilled, stats.spill_bytes) == (
        want_stats.hop1, want_stats.hop2, want_stats.spilled, want_stats.spill_bytes)
    _held(C, _pipeline_reference())


@pytest.mark.parametrize("backend", ("scan", "loop", "bsr", "whole_fast", "auto"))
def test_pipeline_in_place_refusals(backend, monkeypatch):
    """A backend without a streaming kernel, a whole_fast hop (here hop 2 of
    a resident plan) and ``auto`` resolving to ``bsr`` on a hop raise,
    naming the ring."""
    A, P, R, plan, caps = _port_case("spill")
    want = f"backend {backend!r} has no such kernel"
    if backend == "whole_fast":
        _, quarter = _problem()
        plan = planner.plan_pipeline(A, P, R, P100, fast_limit_bytes=quarter * 4)
        assert plan.plan2.algorithm == "whole_fast"
        caps = pipeline_output_caps(A, P, R, plan.plan1.p_ac, plan.plan2.p_ac)
        backend, want = "hash", "a whole_fast hop copies its operands whole"
    if backend == "auto":
        monkeypatch.setattr(pipeline_spgemm, "select_accumulator_backend",
                            lambda plan, env: "bsr")
        want = "backend 'auto' resolves to 'bsr', which has no such kernel"
    with pytest.raises(ValueError, match=want) as err:
        pipeline_spgemm.pipeline_spgemm(A, P, R, plan, backend=backend, caps=caps,
                                        placement=PIPELINE_TABLE3["HostPin"], device="cpu",
                                        slow_reads="in_place")
    assert RING in str(err.value)
    with pytest.raises(ValueError, match="slow_reads must be one of"):
        pipeline_spgemm.pipeline_spgemm(A, P, R, plan, caps=caps, device="cpu",
                                        slow_reads="mapped")


@functools.lru_cache(maxsize=None)
def _batch():
    a, b = _hetero()
    ref_as, As = _both(a)
    ref_bs, Bs = _both(b)
    return ref_as, ref_bs, As, Bs


@functools.lru_cache(maxsize=None)
def _batched_reference():
    """Each instance's product by the JAX package: its dense A B."""
    ref_as, ref_bs, _, _ = _batch()
    return [np.asarray(jnp.matmul(ref_to_dense(a), ref_to_dense(b)))
            for a, b in zip(ref_as, ref_bs)]


@functools.lru_cache(maxsize=None)
def _pipeline_reference():
    """R (A P) by the JAX package, dense, on the spill case's operands."""
    (rA, rR, rP), _ = _problem()
    return np.asarray(jnp.matmul(ref_to_dense(rR),
                                 jnp.matmul(ref_to_dense(rA), ref_to_dense(rP))))


@pytest.mark.parametrize("algorithm", ("knl", "chunk1", "chunk2"))
@pytest.mark.parametrize("backend", IN_PLACE)
def test_batched_in_place_launches_once_a_strip_for_the_batch(backend, algorithm, request,
                                                              monkeypatch):
    """Every operand slow: one launch a strip for all three instances, no
    ring op, each C equal bit for bit to the ring twin's and the all-fast
    batched call's and held to the reference's, the ChunkStats equal."""
    ref_as, ref_bs, As, Bs = _batch()
    plan = _port_plan(_plan(algorithm, ref_as[0], ref_bs[0]))
    fast, fast_stats = chunk_stream.chunked_spgemm_batched(As, Bs, plan, backend=backend,
                                                           device="cpu")
    ring, _ = chunk_stream.chunked_spgemm_batched(As, Bs, plan, backend=backend, device="cpu",
                                                  placement=TABLE3["HostPin"])
    request.getfixturevalue("card_staging")
    env = chunk_stream.batch_envelope(As, Bs, plan)
    resolved = (planner.select_accumulator_backend(plan, env) if backend == "auto"
                else backend)
    calls = _count_calls(monkeypatch, WRAPPERS[resolved])
    with copy_ring.RingLog() as log:
        got, stats = chunk_stream.chunked_spgemm_batched(
            As, Bs, plan, backend=backend, device="cpu", placement=TABLE3["HostPin"],
            slow_reads="in_place")
    assert calls == [(len(As), 1)] * plan.n_ac
    assert log.rings == [] and log.transfers == []
    assert stats == fast_stats
    for C, F, W, R in zip(got, fast, ring, _batched_reference()):
        assert _equal(C, F) and _equal(C, W)
        _held(C, R)


@pytest.mark.parametrize("backend", ("scan", "bsr", "auto"))
def test_batched_in_place_refusals(backend, monkeypatch):
    _, _, As, Bs = _batch()
    plan = _port_plan(_plan("chunk1", _batch()[0][0], _batch()[1][0]))
    want = f"backend {backend!r} has no such kernel"
    if backend == "auto":
        monkeypatch.setattr(chunk_stream, "select_accumulator_backend",
                            lambda plan, env: "bsr")
        want = "backend 'auto' resolves to 'bsr', which has no such kernel"
    with pytest.raises(ValueError, match=want) as err:
        chunk_stream.chunked_spgemm_batched(As, Bs, plan, backend=backend, device="cpu",
                                            slow_reads="in_place")
    assert RING in str(err.value)
    with pytest.raises(ValueError, match="slow_reads must be one of"):
        chunk_stream.chunked_spgemm_batched(As, Bs, plan, device="cpu", slow_reads="mapped")


def _serve(backend, reqs, where, slow_reads="ring"):
    svc = SpGEMMService(PLAN, quantum=32, max_batch=4, backend=backend, device="cpu",
                        slow_reads=slow_reads)
    waves = []
    for _ in range(2):
        for A, B in reqs:
            svc.submit(A, B, placement=where)
        waves.append(svc.drain())
    return svc, waves


@pytest.mark.parametrize("backend", IN_PLACE)
def test_service_in_place_equals_ring_and_all_fast(backend, request):
    """A service built with ``slow_reads="in_place"`` serves the placed
    requests through the in-place batched executor: the same buckets
    (the argument is service-wide), no ring op, each response equal bit for
    bit to the ring service's and the all-fast service's, and the warm wave
    compiles nothing."""
    reqs = _requests()
    _, fast = _serve(backend, reqs, None)
    _, ring = _serve(backend, reqs, TABLE3["HostPin"])
    request.getfixturevalue("card_staging")
    with copy_ring.RingLog() as log:
        svc, got = _serve(backend, reqs, TABLE3["HostPin"], slow_reads="in_place")
    assert log.rings == [] and log.transfers == []
    for waves in zip(fast, ring, got):
        for f, r, g in zip(*waves):
            assert g.req_id % len(reqs) == r.req_id % len(reqs) == f.req_id % len(reqs)
            assert g.bucket_key == r.bucket_key
            assert (g.batch_size, g.padded_batch, g.stats) == (f.batch_size, f.padded_batch,
                                                               f.stats)
            assert _equal(g.C, r.C) and _equal(g.C, f.C)
    assert all(r.compile_s == 0 for r in got[1])


def test_service_in_place_refusals():
    with pytest.raises(ValueError, match="backend 'scan' has no such kernel") as err:
        SpGEMMService(PLAN, backend="scan", device="cpu", slow_reads="in_place")
    assert RING in str(err.value)
    with pytest.raises(ValueError, match="slow_reads must be one of"):
        SpGEMMService(PLAN, backend="hash", device="cpu", slow_reads="mapped")
