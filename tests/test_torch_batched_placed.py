"""The batched entry point with operands in slow memory, on the CPU.

``chunked_spgemm_batched(..., placement=..., device="cpu")`` builds each
slow operand's envelope-padded stacks in slow memory and streams one (strip,
chunk) step's pieces of the whole batch through the copy ring, one launch a
step for every instance. On the heterogeneous batch of
``test_torch_batched.py`` (three instances, one structurally empty) x every
batched backend and ``auto`` x the three algorithms x the paper's Table 3
placements: every C equal bit for bit to the all-fast batched call's (which
``test_torch_batched.py`` holds to the JAX package) and the ChunkStats
equal; under the CSR backends and the dense slab the bytes the ring moved
are each slow operand's tagged events times the width, and every ring's log
is its schedule's program. A batch whose instances lie in different spaces
raises.
"""

import functools

import pytest
import torch

from repro_torch.analysis.dma import check_ring_structure
from repro_torch.core import backend_registry, chunk_stream, chunking, copy_ring, placement
from repro_torch.core.placement import TABLE3
from repro_torch.sparse.csr import csr_from_dense
from test_torch_batched import _hetero, _port_plan
from test_backend_conformance import _plan

ALGORITHMS = ("knl", "chunk1", "chunk2")
BATCHED = ("scan", "pallas", "sparse", "hash", "bsr", "auto")
PLACEMENTS = tuple(k for k in TABLE3 if k != "HBM")


@functools.lru_cache(maxsize=None)
def _batch(algorithm):
    a, b = _hetero()
    As = [csr_from_dense(d, device="cpu") for d in a]
    Bs = [csr_from_dense(d, device="cpu") for d in b]
    return As, Bs, _port_plan(_plan(algorithm, As[0], Bs[0]))


@functools.lru_cache(maxsize=None)
def _all_fast(algorithm, backend):
    As, Bs, plan = _batch(algorithm)
    return chunk_stream.chunked_spgemm_batched(As, Bs, plan, backend=backend, device="cpu")


def _events(backend, plan, stats):
    """One instance's tagged events at the staged sizes its ChunkStats give
    (the CSR accumulators', the dense slab's and the batched scan's
    streaming order: ``planned_events``)."""
    ins = stats.per_copy_in
    if backend == "scan":   # its stats are the ranged replay: sizes from the staging
        As, Bs, _ = _batch(plan.algorithm)
        env = chunking.batch_envelope(As, Bs, plan)
        strip = chunking.a_strips(As[0], plan.p_ac, envelope=env)[0]
        chunk = chunking.b_chunks(Bs[0], plan.p_b, envelope=env)[0]
        return chunk_stream.planned_events(
            plan, chunk.nbytes(), strip.nbytes(),
            chunk_stream._c_strip_nbytes(env.strip_rows, env.c_pad, As[0].dtype))
    if plan.algorithm == "chunk2":
        slab, a_stage, c_stage = ins[0], ins[2], ins[1] // plan.n_ac
    else:
        slab, a_stage, c_stage = ins[2], ins[0], ins[1]
    return chunk_stream.planned_events(plan, int(slab), int(a_stage), int(c_stage))


@pytest.mark.parametrize("name", PLACEMENTS)
@pytest.mark.parametrize("backend", BATCHED)
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_placed_batch_equals_all_fast(algorithm, backend, name):
    As, Bs, plan = _batch(algorithm)
    want, want_stats = _all_fast(algorithm, backend)
    where = TABLE3[name]
    with copy_ring.RingLog() as log:
        got, stats = chunk_stream.chunked_spgemm_batched(As, Bs, plan, backend=backend,
                                                         placement=where, device="cpu")
    assert stats == want_stats
    assert len(got) == len(want) == len(As)
    for i, (C, W) in enumerate(zip(got, want)):
        for f in ("indptr", "indices", "data"):
            assert torch.equal(getattr(C, f), getattr(W, f)), (i, f)
        assert C.shape == W.shape
    for ring in log.rings:
        assert check_ring_structure(ring.ops, ring.total, ring.n_fields) == []
    assert {r.operand for r in log.rings} <= set(where.slow)
    if backend in ("bsr", "auto"):
        return
    width = len(As)
    events = _events(backend, plan, stats)
    for operand in "ABC":
        for direction in ("in", "out"):
            expect = ([width * b for o, d, b in events if (o, d) == (operand, direction)]
                      if getattr(where, operand) == "slow" else [])
            assert log.moved(operand, direction) == expect, (operand, direction)


@pytest.mark.parametrize("backend", ("scan", "hash", "bsr"))
def test_placed_batch_one_launch_a_step(backend, monkeypatch):
    """One core call a (strip, chunk) step serves the whole batch."""
    As, Bs, plan = _batch("chunk1")
    cores = backend_registry.get(backend).make_batched_cores()
    key = "knl" if backend == "scan" else plan.algorithm   # scan steps on its knl core
    core, calls = cores[key], []
    monkeypatch.setitem(cores, key, lambda *a, **k: calls.append(1) or core(*a, **k))
    chunk_stream.chunked_spgemm_batched(As, Bs, plan, backend=backend, cores=cores,
                                        placement=TABLE3["HostPin"], device="cpu")
    assert len(calls) == plan.n_ac * plan.n_b


def test_mixed_space_batch_raises(monkeypatch):
    """A batch shares one placement: on the card, a pageable host operand
    raises, and so do instances whose operands lie in different spaces,
    before anything runs (the spaces are stood in for here by the
    residence the placement reads)."""
    As, Bs, plan = _batch("chunk1")
    with pytest.raises(ValueError, match="pageable host memory"):
        chunk_stream.chunked_spgemm_batched(As, Bs, plan, backend="hash")
    # on the CPU the placement given holds for every instance alike
    assert placement.resolve_batch_placement(As, Bs, TABLE3["DP"], "cpu") == (
        TABLE3["DP"], torch.device("cpu"))
    assert placement.resolve_batch_placement(As, Bs, None, "cpu")[0] == TABLE3["HBM"]
    on_card = {id(As[0]), id(Bs[0])}
    monkeypatch.setattr(placement, "csr_residence",
                        lambda m: "card" if id(m) in on_card else "pinned")
    with pytest.raises(ValueError, match="a batch shares one placement"):
        chunk_stream.chunked_spgemm_batched(As, Bs, plan, backend="hash")
    on_card |= {id(m) for m in As + Bs}
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        chunk_stream.chunked_spgemm_batched(As, Bs, plan, backend="hash")
