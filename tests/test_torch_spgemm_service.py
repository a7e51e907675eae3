"""The port's SpGEMM service against the reference's.

Both services are driven through the request sequences of
``tests/test_spgemm_service.py`` (small dims as there) on the same seeded
matrices: mixed structures, the flush-tail ladder, the budget merge,
domination, sentinel tails, eviction and refault, poll priority, admission
shed and flush, futures, tail learning, adaptive quantum, replan (every
batched backend behind a planning service, and the no-aliasing check, are in
``test_torch_spgemm_service_backends.py``). Each scenario records what a
caller sees; the port's record must equal the reference's exactly: every
``ServiceStats`` counter but the two times, ``bucket_summaries()`` (envelope
field by field), the width ladder, and each response's id, bucket, widths
and whether it paid a cold start, with its C within atol 1e-4 (structure
exactly equal for the ``scan`` backend). SLOs are ``None`` or 0, so nothing
depends on the clock.
"""

import dataclasses
import time

import numpy as np
import pytest

from repro.core.planner import ChunkPlan as RefPlan
from repro.serve import spgemm_service as ref_service
from repro.sparse.csr import csr_from_dense as ref_from_dense
from repro.sparse.csr import csr_to_dense as ref_to_dense
from repro_torch.core.planner import ChunkPlan as PortPlan
from repro_torch.serve import spgemm_service as port_service
from repro_torch.sparse.csr import csr_from_dense, csr_to_dense
from conftest import random_dense

ATOL = 1e-4


class Pkg:
    """One package's service, plan and CSR constructors."""

    def __init__(self, name: str):
        self.name = name
        if name == "ref":
            self.svc, self.Plan = ref_service, RefPlan
            self.csr = ref_from_dense
            self.dense = lambda C: np.asarray(ref_to_dense(C))
            self.fields = lambda C: (np.asarray(C.indptr), np.asarray(C.indices))
        else:
            self.svc, self.Plan = port_service, PortPlan
            self.csr = lambda d: csr_from_dense(d, device="cpu")
            self.dense = lambda C: csr_to_dense(C).numpy()
            self.fields = lambda C: (C.indptr.numpy(), C.indices.numpy())

    def service(self, *args, **kwargs):
        if self.name != "ref":
            kwargs["device"] = "cpu"
        return self.svc.SpGEMMService(*args, **kwargs)

    def plan(self, dim, p_b, algorithm="knl", p_ac=None):
        return self.Plan(algorithm, p_ac or (0, dim), p_b, 0.0, 0.0)


def _banded(dim, k, val=1.0):
    d = np.zeros((dim, dim), np.float32)
    d[:, :k] = val
    return d


def _mixed(rng, n, dim, densities):
    return [(random_dense(rng, dim, dim, densities[i % len(densities)]),
             random_dense(rng, dim, dim, densities[i % len(densities)]))
            for i in range(n)]


class Recorder:
    """What a caller of one service sees, in a comparable form."""

    def __init__(self, pkg: Pkg):
        self.pkg = pkg
        self.events = []
        self.cs = []

    def responses(self, tag, out, exact_structure=False):
        for r in out:
            env, pk = r.bucket_key[:2]   # the port's key also carries the placement
            self.events.append((tag, r.req_id, dataclasses.astuple(env), pk, r.batch_size,
                                r.padded_batch, r.compile_s == 0.0, r.stats.kernel_calls,
                                tuple(r.stats.per_copy_in), tuple(r.stats.per_copy_out)))
            self.cs.append((tag, r.req_id, self.pkg.dense(r.C),
                            self.pkg.fields(r.C) if exact_structure else None))

    def state(self, tag, svc):
        stats = dataclasses.asdict(svc.stats)
        del stats["exec_s"], stats["compile_s"]
        summaries = [(dataclasses.astuple(e), alg, c, x, s, tuple(sorted(w)))
                     for e, alg, c, x, s, w in svc.bucket_summaries()]
        self.events.append((tag, stats, summaries, list(svc.widths), svc.pending,
                            svc.n_buckets))

    def note(self, *what):
        self.events.append(what)


def _mixed_structures(pkg, rec):
    rng = np.random.default_rng(0)
    dim = 24
    svc = pkg.service(pkg.plan(dim, (0, dim // 2, dim)), quantum=32, max_batch=3,
                      retrace_budget=8)
    for wave in range(2):
        for a, b in _mixed(rng, 7, dim, [0.08, 0.25]):
            svc.submit(pkg.csr(a), pkg.csr(b))
        rec.responses(f"wave{wave}", svc.flush(), exact_structure=True)
        rec.state(f"wave{wave}", svc)


def _budget_merge(pkg, rec):
    rng = np.random.default_rng(7)
    dim = 24
    svc = pkg.service(pkg.plan(dim, (0, dim // 2, dim)), quantum=8, max_batch=2,
                      retrace_budget=2)
    for a, b in _mixed(rng, 8, dim, [0.03, 0.1, 0.2, 0.3, 0.4]):
        svc.submit(pkg.csr(a), pkg.csr(b))
    rec.state("submitted", svc)
    rec.responses("flush", svc.flush(), exact_structure=True)
    rec.state("flushed", svc)


def _tail_ladder(pkg, rec):
    rng = np.random.default_rng(1)
    dim = 16
    svc = pkg.service(pkg.plan(dim, (0, dim // 2, dim)), quantum=32, max_batch=4,
                      retrace_budget=4)
    A = pkg.csr(random_dense(rng, dim, dim, 0.2))
    B = pkg.csr(random_dense(rng, dim, dim, 0.2))
    for n in (1, 5, 3):
        for _ in range(n):
            svc.submit(A, B)
        rec.responses(f"n{n}", svc.flush())
        rec.state(f"n{n}", svc)


def _dominator(pkg, rec):
    dim = 12
    svc = pkg.service(pkg.plan(dim, (0, dim // 2, dim)), quantum=1, max_batch=1,
                      retrace_budget=8)
    svc.submit(pkg.csr(_banded(dim, 4, 2.0)), pkg.csr(_banded(dim, 1, 3.0)))
    svc.submit(pkg.csr(_banded(dim, 1, 2.0)), pkg.csr(_banded(dim, 4, 3.0)))
    rec.state("two", svc)
    svc.submit(pkg.csr(_banded(dim, 1, 5.0)), pkg.csr(_banded(dim, 1, 7.0)))
    rec.state("dominated", svc)
    rec.responses("drain", svc.drain())


def _sentinel_tail(pkg, rec):
    rng = np.random.default_rng(11)
    dim = 16
    svc = pkg.service(pkg.plan(dim, (0, dim // 2, dim)), quantum=32, max_batch=4,
                      retrace_budget=4)
    for _ in range(3):
        svc.submit(pkg.csr(random_dense(rng, dim, dim, 0.3)),
                   pkg.csr(random_dense(rng, dim, dim, 0.3)))
    rec.responses("flush", svc.flush())
    rec.state("flush", svc)
    (bucket,) = svc._buckets.values()
    A0, B0 = bucket.sentinel
    rec.note("sentinel", int(A0.indptr[-1]), int(B0.indptr[-1]), A0.shape, B0.shape)


def _eviction_refault(pkg, rec):
    dim = 12
    svc = pkg.service(pkg.plan(dim, (0, dim // 2, dim)), quantum=1, max_batch=1,
                      retrace_budget=3, eviction_hysteresis=0)
    pairs = [(pkg.csr(_banded(dim, i + 1, float(i + 1))), pkg.csr(_banded(dim, 6 - i)))
             for i in range(6)]
    for i, (A, B) in enumerate(pairs):
        svc.submit(A, B)
        rec.responses(f"geometry{i}", svc.drain())
        rec.state(f"geometry{i}", svc)
    for tag in ("refault", "resident"):
        svc.submit(*pairs[0])
        rec.responses(tag, svc.drain())
        rec.state(tag, svc)


def _poll_priority(pkg, rec):
    dim = 12
    plan = pkg.plan(dim, (0, dim // 2, dim))
    a_pair = (pkg.csr(_banded(dim, 4, 2.0)), pkg.csr(_banded(dim, 1, 3.0)))
    b_pair = (pkg.csr(_banded(dim, 1, 2.0)), pkg.csr(_banded(dim, 4, 3.0)))
    svc = pkg.service(plan, quantum=1, max_batch=2, retrace_budget=8)
    svc.submit(*a_pair)
    rec.responses("partial", svc.poll())
    svc.submit(*a_pair)
    rec.responses("full", svc.poll())
    rec.state("no_slo", svc)
    svc2 = pkg.service(plan, quantum=1, max_batch=4, retrace_budget=8, slo_s=0.0)
    svc2.submit(*a_pair)
    svc2.submit(*b_pair)
    rec.responses("both", svc2.drain())
    svc2.submit(*b_pair)
    svc2.submit(*a_pair)
    time.sleep(0.001)
    rec.responses("slo", svc2.poll())
    rec.state("slo", svc2)


def _admission(pkg, rec):
    rng = np.random.default_rng(13)
    dim = 16
    plan = pkg.plan(dim, (0, dim // 2, dim))
    A = pkg.csr(random_dense(rng, dim, dim, 0.3))
    B = pkg.csr(random_dense(rng, dim, dim, 0.3))
    svc = pkg.service(plan, max_batch=4, max_pending=2, admission="shed")
    svc.submit(A, B)
    svc.submit(A, B)
    with pytest.raises(pkg.svc.AdmissionError):
        svc.submit(A, B)
    rec.state("shed", svc)
    rec.responses("shed", svc.drain())
    svc2 = pkg.service(plan, max_batch=4, max_pending=2, admission="flush")
    futures = [svc2.submit(A, B) for _ in range(3)]
    rec.note("done", [f.done() for f in futures])
    rec.state("flush", svc2)
    rec.responses("forced", svc2.poll())
    rec.responses("future", [futures[2].result()])
    rec.note("done", [f.done() for f in futures])


def _future_api(pkg, rec):
    rng = np.random.default_rng(17)
    dim = 16
    svc = pkg.service(pkg.plan(dim, (0, dim // 2, dim)), max_batch=2)
    fut = svc.submit(pkg.csr(random_dense(rng, dim, dim, 0.3)),
                     pkg.csr(random_dense(rng, dim, dim, 0.3)))
    rec.note("future", int(fut), isinstance(fut, int), fut.done())
    resp = fut.result()
    rec.note("resolved", fut.done(), fut.result() is resp)
    rec.responses("result", [resp])


def _tail_learning(pkg, rec):
    rng = np.random.default_rng(19)
    dim = 16
    svc = pkg.service(pkg.plan(dim, (0, dim // 2, dim)), quantum=32, max_batch=4,
                      retrace_budget=4, learn_tail_widths=True, tail_learn_threshold=2)
    A = pkg.csr(random_dense(rng, dim, dim, 0.3))
    B = pkg.csr(random_dense(rng, dim, dim, 0.3))
    for wave in range(3):
        for _ in range(3):
            svc.submit(A, B)
        rec.responses(f"wave{wave}", svc.flush())
        rec.state(f"wave{wave}", svc)


def _adaptive_quantum(pkg, rec):
    dim = 16
    svc = pkg.service(pkg.plan(dim, (0, dim // 2, dim)), quantum=8, max_batch=1,
                      retrace_budget=32, adapt_quantum=True)
    for i in range(16):
        svc.submit(pkg.csr(_banded(dim, i + 1)), pkg.csr(_banded(dim, 16 - i)))
    rec.note("churny", sorted(svc._family_quanta.values()))
    A, B = pkg.csr(_banded(dim, 1)), pkg.csr(_banded(dim, 16))
    for _ in range(16):
        svc.submit(A, B)
    rec.note("stable", sorted(svc._family_quanta.values()))
    rec.state("submitted", svc)


def _replan(pkg, rec):
    rng = np.random.default_rng(23)
    dim = 18
    svc = pkg.service(pkg.plan(dim, (0, 6, 12, dim)), quantum=32, max_batch=2,
                      retrace_budget=8)
    A = pkg.csr(random_dense(rng, dim, dim, 0.3))
    B = pkg.csr(random_dense(rng, dim, dim, 0.3))
    with pytest.raises(ValueError):
        svc.replan_lagging_buckets()
    svc.submit(A, B)
    rec.responses("first", svc.drain())
    svc.submit(A, B)
    rec.note("replanned", svc.replan_lagging_buckets(slo_s=0.0))
    rec.state("replanned", svc)
    rec.responses("rerouted", svc.drain())
    svc.submit(pkg.csr(random_dense(rng, dim, dim, 0.3)),
               pkg.csr(random_dense(rng, dim, dim, 0.3)))
    rec.responses("override", svc.drain())
    rec.state("override", svc)


def _pallas_chunk2(pkg, rec):
    rng = np.random.default_rng(9)
    dim = 20
    plan = pkg.plan(dim, (0, dim // 2, dim), "chunk2", (0, dim // 2, dim))
    svc = pkg.service(plan, quantum=32, max_batch=2, retrace_budget=8, backend="pallas")
    for a, b in _mixed(rng, 5, dim, [0.1, 0.3]):
        svc.submit(pkg.csr(a), pkg.csr(b))
    rec.responses("flush", svc.flush())
    rec.state("flush", svc)


SCENARIOS = {
    "mixed_structures": _mixed_structures, "budget_merge": _budget_merge,
    "tail_ladder": _tail_ladder, "dominator": _dominator,
    "sentinel_tail": _sentinel_tail, "eviction_refault": _eviction_refault,
    "poll_priority": _poll_priority, "admission": _admission,
    "future_api": _future_api, "tail_learning": _tail_learning,
    "adaptive_quantum": _adaptive_quantum, "replan": _replan,
    "pallas_chunk2": _pallas_chunk2,
}


def _compare(scenario):
    recs = {}
    for name in ("ref", "port"):
        pkg = Pkg(name)
        recs[name] = Recorder(pkg)
        scenario(pkg, recs[name])
    ref, port = recs["ref"], recs["port"]
    assert port.events == ref.events
    assert len(port.cs) == len(ref.cs)
    for (tag, rid, got, got_struct), (_, _, want, want_struct) in zip(port.cs, ref.cs):
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=f"{tag}/{rid}")
        if want_struct is not None:
            nnz = int(want_struct[0][-1])
            np.testing.assert_array_equal(got_struct[0], want_struct[0])
            np.testing.assert_array_equal(got_struct[1][:nnz], want_struct[1][:nnz])
    return port


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_service_matches_reference(scenario):
    _compare(SCENARIOS[scenario])
