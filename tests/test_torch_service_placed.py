"""The SpGEMM service with requests in slow memory, on the CPU.

A request's placement is part of its bucket's key: the same operands
submitted all fast and with a placement (given explicitly on the CPU, read
from the operands on the card) land in different buckets, and a flush never
mixes spaces. Served through ``chunked_spgemm_batched``'s copy ring, each
placed response equals the all-fast service's response for the same request
bit for bit, with the same widths and padding (sentinel instances in the
bucket's spaces), and a warm wave compiles nothing. The service is held to
the JAX package's in ``test_torch_spgemm_service*.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import copy_ring
from repro_torch.core.placement import ALL_FAST, TABLE3
from repro_torch.core.planner import ChunkPlan
from repro_torch.serve.spgemm_service import SpGEMMService
from repro_torch.sparse.csr import csr_from_dense
from conftest import random_dense

DIM = 16
PLAN = ChunkPlan("chunk1", (0, 8, DIM), (0, 5, 11, DIM), 0.0, 0.0)


def _requests(n=5, seed=77):
    rng = np.random.default_rng(seed)
    return [(csr_from_dense(random_dense(rng, DIM, DIM, d), device="cpu"),
             csr_from_dense(random_dense(rng, DIM, DIM, 0.25), device="cpu"))
            for d in (0.1, 0.2, 0.3, 0.15, 0.25)[:n]]


def _serve(backend, reqs, where, waves=2):
    svc = SpGEMMService(PLAN, quantum=32, max_batch=4, backend=backend, device="cpu")
    out = []
    for _ in range(waves):
        for A, B in reqs:
            svc.submit(A, B, placement=where)
        out.append(svc.drain())
    return svc, out


@pytest.mark.parametrize("name", ("HostPin", "DP"))
@pytest.mark.parametrize("backend", ("scan", "pallas", "sparse", "hash", "bsr", "auto"))
def test_placed_responses_equal_all_fast(backend, name):
    reqs = _requests()
    _, fast = _serve(backend, reqs, None)
    with copy_ring.RingLog() as log:
        svc, placed = _serve(backend, reqs, TABLE3[name])
    assert log.rings and {r.operand for r in log.rings} <= set(TABLE3[name].slow)
    for wave_fast, wave_placed in zip(fast, placed):
        assert [r.req_id % len(reqs) for r in wave_placed] == [
            r.req_id % len(reqs) for r in wave_fast]
        for f, p in zip(wave_fast, wave_placed):
            assert (p.batch_size, p.padded_batch, p.stats) == (
                f.batch_size, f.padded_batch, f.stats)
            assert p.bucket_key[:2] == f.bucket_key[:2]
            assert p.bucket_key[2] == TABLE3[name] and f.bucket_key[2] == ALL_FAST
            for fld in ("indptr", "indices", "data"):
                assert torch.equal(getattr(p.C, fld), getattr(f.C, fld)), fld
    # the warm wave meets only geometries the cold one compiled; the placed
    # dense slab launches its wrapper on dense pieces, through no core, so
    # it counts none
    assert all(r.compile_s == 0.0 for r in placed[1])
    assert sum(b.compiles for b in svc._buckets.values()) == svc.stats.compiles
    if {b.backend for b in svc._buckets.values()} != {"pallas"}:
        assert svc.stats.compiles > 0


def test_fast_and_placed_requests_land_in_different_buckets():
    reqs = _requests(n=1) * 2   # one geometry: only the placement tells them apart
    svc = SpGEMMService(PLAN, quantum=32, max_batch=4, backend="hash", device="cpu")
    for A, B in reqs:
        svc.submit(A, B)
        svc.submit(A, B, placement=TABLE3["HostPin"])
    assert svc.n_buckets == 2
    spaces = sorted(str(b.placement) for b in svc._buckets.values())
    assert spaces == sorted(str(p) for p in (ALL_FAST, TABLE3["HostPin"]))
    assert all(len(b.queue) == 2 for b in svc._buckets.values())
    out = svc.drain()
    assert len(out) == 4 and {r.batch_size for r in out} == {2}
    by_id = {r.req_id: r for r in out}
    for i in range(0, 4, 2):
        assert torch.equal(by_id[i].C.data, by_id[i + 1].C.data)
        assert by_id[i].bucket_key != by_id[i + 1].bucket_key
