"""The port's SpGEMM service against the reference's, by backend.

``test_service_conformance``'s traffic (every request planned by
``plan_knl`` against a fast limit) through both services for every batched
backend and ``auto``, recorded and compared as in
``test_torch_spgemm_service.py``. Port-only: a response's C is fresh memory
that a later flush through the same bucket leaves as it was.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.planner import ChunkPlan as PortPlan
from repro_torch.serve import spgemm_service as port_service
from repro_torch.sparse.csr import csr_from_dense
from conftest import random_dense
from test_torch_spgemm_service import _compare


@pytest.mark.parametrize("backend", ["scan", "pallas", "sparse", "hash", "bsr", "auto"])
def test_planning_service_matches_reference(backend):
    """Four requests, each planned by ``plan_knl`` at 1,500 bytes."""

    def scenario(pkg, rec):
        rng = np.random.default_rng(303)
        a = [random_dense(rng, 12, 10, d) for d in (0.1, 0.2, 0.3, 0.15)]
        b = [random_dense(rng, 10, 8, d) for d in (0.2, 0.3, 0.1, 0.25)]
        svc = pkg.service(fast_limit_bytes=1500.0, backend=backend, max_batch=2)
        for x, y in zip(a, b):
            svc.submit(pkg.csr(x), pkg.csr(y))
        rec.responses("flush", svc.flush(), exact_structure=backend == "scan")
        rec.state("flush", svc)
        rec.note("backends", sorted(str(bk.backend) for bk in svc._buckets.values()))

    _compare(scenario)


def test_response_not_overwritten_by_later_flush():
    """A response's C is fresh memory: flushing more requests through the
    same bucket and widths leaves an earlier response's C as it was."""
    rng = np.random.default_rng(29)
    dim = 16
    plan = PortPlan("knl", (0, dim), (0, dim // 2, dim), 0.0, 0.0)
    for backend in ("scan", "sparse", "hash", "pallas", "bsr"):
        svc = port_service.SpGEMMService(plan, quantum=32, max_batch=2, backend=backend,
                                         device="cpu")
        a, b = random_dense(rng, dim, dim, 0.3), random_dense(rng, dim, dim, 0.3)
        mats = [(csr_from_dense(a * s, device="cpu"), csr_from_dense(b - s, device="cpu"))
                for s in (1.0, 2.0, -3.0, 0.5)]
        for A, B in mats[:2]:
            svc.submit(A, B)
        first = svc.flush()
        kept = [(r.C.indptr.clone(), r.C.indices.clone(), r.C.data.clone()) for r in first]
        for A, B in mats[2:]:
            svc.submit(A, B)
        second = svc.flush()
        assert [r.padded_batch for r in second] == [r.padded_batch for r in first]
        for r, (ip, ix, d) in zip(first, kept):
            assert torch.equal(r.C.indptr, ip) and torch.equal(r.C.indices, ix)
            assert torch.equal(r.C.data, d), backend
        for r, s in zip(first, second):
            assert r.C.data.data_ptr() != s.C.data.data_ptr()


def test_service_refuses_unbatched_backend_and_device_none_means_card():
    plan = PortPlan("knl", (0, 8), (0, 8), 0.0, 0.0)
    with pytest.raises(ValueError, match="backend"):
        port_service.SpGEMMService(plan, backend="loop")
    with pytest.raises(ValueError, match="backend"):
        port_service.SpGEMMService(plan, backend="nope")
    with pytest.raises(ValueError):
        port_service.SpGEMMService()
