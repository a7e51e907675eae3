"""Where the entry points run: the card unless the caller asks for the CPU.

``pipeline_spgemm``, ``chunked_spgemm_batched`` and ``SpGEMMService`` take
``device=None`` as ``chunked_spgemm`` does: the card, resolved by
``placement.resolve_placement``. Here, where there is no card, ``device=None``
raises: for operands in pageable host memory it names ``place`` (before any
work), for pinned ones (stood in for by marking every CPU tensor pinned) it
names the missing card, and a service cannot be built for it. With
``device="cpu"`` each runs the kernels' plain versions and returns host
results equal to the same call's plain reference.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import chunk_stream, chunking, pipeline_spgemm
from repro_torch.core.memory_model import P100
from repro_torch.core.planner import ChunkPlan
from repro_torch.serve.spgemm_service import SpGEMMService
from repro_torch.sparse import multigrid
from repro_torch.sparse.csr import csr_from_dense, csr_to_dense
from conftest import random_dense

NO_CARD = r"torch.cuda.is_available"


def _pair(seed=11, m=12, k=10, n=9):
    rng = np.random.default_rng(seed)
    return (csr_from_dense(random_dense(rng, m, k, 0.3), device="cpu"),
            csr_from_dense(random_dense(rng, k, n, 0.3), device="cpu"))


def _galerkin():
    A, R, P = multigrid.problem("brick3d", 4, device="cpu")
    return A, P, R


@pytest.fixture
def pinned(monkeypatch):
    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self, *a, **k: True)


def test_pipeline_runs_on_the_card_by_default():
    A, P, R = _galerkin()
    with pytest.raises(ValueError, match=r"place\(x, 'fast'\)"):
        pipeline_spgemm.pipeline_spgemm(A, P, R, system=P100)
    C, stats = pipeline_spgemm.pipeline_spgemm(A, P, R, system=P100, device="cpu")
    assert C.device.type == "cpu" and stats.plan is not None
    want = csr_to_dense(R) @ csr_to_dense(A) @ csr_to_dense(P)
    torch.testing.assert_close(csr_to_dense(C), want, atol=1e-4, rtol=1e-5)


def test_pipeline_pinned_operands_go_to_the_card(pinned):
    A, P, R = _galerkin()
    with pytest.raises(RuntimeError, match=NO_CARD):
        pipeline_spgemm.pipeline_spgemm(A, P, R, system=P100)


def test_batched_runs_on_the_card_by_default():
    A, B = _pair()
    plan = ChunkPlan("chunk1", (0, 6, 12), (0, 5, 10), 0.0, 0.0)
    with pytest.raises(ValueError, match=r"place\(x, 'fast'\)"):
        chunk_stream.chunked_spgemm_batched([A, A], [B, B], plan, backend="hash")
    Cs, _ = chunk_stream.chunked_spgemm_batched([A, A], [B, B], plan, backend="hash",
                                                device="cpu")
    want, _ = chunking.chunked_spgemm(A, B, plan, backend="hash", device="cpu")
    for C in Cs:
        assert C.device.type == "cpu"
        assert torch.equal(C.indptr, want.indptr) and torch.equal(C.data, want.data)


def test_batched_pinned_operands_go_to_the_card(pinned):
    A, B = _pair()
    plan = ChunkPlan("knl", (0, 12), (0, 10), 0.0, 0.0)
    with pytest.raises(RuntimeError, match=NO_CARD):
        chunk_stream.chunked_spgemm_batched([A], [B], plan, backend="scan")


def test_service_runs_on_the_card_by_default():
    plan = ChunkPlan("knl", (0, 12), (0, 5, 10), 0.0, 0.0)
    with pytest.raises(RuntimeError, match=NO_CARD):
        SpGEMMService(plan, backend="hash")
    svc = SpGEMMService(plan, backend="hash", device="cpu")
    assert svc.device == torch.device("cpu")
    A, B = _pair()
    fut = svc.submit(A, B)
    (resp,) = svc.drain()
    assert resp.req_id == int(fut) and resp.C.device.type == "cpu"
    torch.testing.assert_close(csr_to_dense(resp.C), csr_to_dense(A) @ csr_to_dense(B),
                               atol=1e-4, rtol=1e-5)


def test_service_refuses_an_operand_off_its_device(monkeypatch):
    """A CPU service takes host operands only; an operand on the card (its
    residence stood in for here) raises at submit, before it queues."""
    from repro_torch.core import placement

    plan = ChunkPlan("knl", (0, 12), (0, 10), 0.0, 0.0)
    svc = SpGEMMService(plan, backend="hash", device="cpu")
    A, B = _pair()
    monkeypatch.setattr(placement, "csr_residence",
                        lambda m: "card" if m is B else "host")
    with pytest.raises(ValueError, match="on the card"):
        svc.submit(A, B)
    assert svc.pending == 0
