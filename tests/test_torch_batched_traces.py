"""The port's compile accounting against the reference's.

``TRACE_COUNTS`` deltas of the call sequences the reference's conformance
suite pins (``test_trace_counts_exact_batched`` and
``test_trace_counts_exact``), through both packages on the same seeded
instances: one count on a first call, none on a repeat or on new values of
the same geometry, one more on a new geometry, under the key of the backend
the call resolves to.
"""

import numpy as np
import pytest

from repro.core import backend_registry as ref_registry
from repro.core import chunk_stream as ref_cs
from repro.core import chunking as ref_chunking
from repro.core import planner as ref_planner
from repro.sparse.csr import csr_from_dense as ref_from_dense
from repro_torch.core import backend_registry, chunk_stream, chunking, planner
from repro_torch.kernels.convert import plan_from_fields
from repro_torch.sparse.csr import csr_from_dense
from conftest import random_dense
from test_backend_conformance import _plan

BATCHED = ["scan", "pallas", "sparse", "hash", "bsr", "auto"]


def _port_plan(plan):
    return plan_from_fields(plan.algorithm, plan.p_ac, plan.p_b, plan.copy_bytes,
                            plan.fast_bytes_needed)


def _subset(d):
    keep = np.arange(d.size).reshape(d.shape) % 2 == 0
    return (d * keep * 1.5).astype(d.dtype)


def _trace_sequence(pkg, backend, algorithm, dims, seed):
    """test_trace_counts_exact_batched's calls through one package: the
    TRACE_COUNTS deltas of the first call, a repeat, structural subsets
    under the same envelope, and a grown envelope."""
    cs, ch, pl, reg = pkg
    m, k, n = dims
    rng = np.random.default_rng(seed)
    a = [random_dense(rng, m, k, 0.2) for _ in range(2)]
    b = [random_dense(rng, k, n, 0.25) for _ in range(2)]
    a3 = [random_dense(rng, m, k, 0.5) for _ in range(2)]
    b3 = [random_dense(rng, k, n, 0.5) for _ in range(2)]
    if cs is ref_cs:
        make = ref_from_dense
    else:
        def make(d):
            return csr_from_dense(d, device="cpu")
    As, Bs = [make(d) for d in a], [make(d) for d in b]
    plan = _plan(algorithm, As[0], Bs[0])
    if cs is chunk_stream:
        plan = _port_plan(plan)
    spec_block = None if backend == "auto" else reg.get(backend)
    block = spec_block.block_size if spec_block and spec_block.needs_block_caps else None
    env = ch.batch_envelope(As, Bs, plan, block_size=block)

    def key(e):
        name = pl.select_accumulator_backend(plan, e) if backend == "auto" else backend
        return reg.get(name).trace_key_batched.format(alg=algorithm)

    run = {"device": "cpu"} if cs is chunk_stream else {}
    deltas = []
    k1 = key(env)
    for As_, Bs_, e in ((As, Bs, env), (As, Bs, env),
                        ([make(_subset(d)) for d in a], [make(_subset(d)) for d in b], env)):
        before = cs.TRACE_COUNTS[k1]
        cs.chunked_spgemm_batched(As_, Bs_, plan, envelope=e, backend=backend, **run)
        deltas.append(cs.TRACE_COUNTS[k1] - before)
    As3, Bs3 = [make(d) for d in a3], [make(d) for d in b3]
    env3 = env.union(ch.batch_envelope(As3, Bs3, plan, block_size=block))
    k3 = key(env3)
    before = cs.TRACE_COUNTS[k3]
    cs.chunked_spgemm_batched(As3, Bs3, plan, envelope=env3, backend=backend, **run)
    deltas.append(cs.TRACE_COUNTS[k3] - before)
    return (k1, k3), deltas


REF = (ref_cs, ref_chunking, ref_planner, ref_registry)
PORT = (chunk_stream, chunking, planner, backend_registry)


@pytest.mark.parametrize("backend", BATCHED)
def test_trace_counts_batched_match_reference(backend):
    """Sizes used by no other test, so neither process-wide record (the
    reference's jit caches, the port's module-level cores) has met them."""
    seed = 2100 + BATCHED.index(backend)
    dims = (23 + BATCHED.index(backend), 19, 14)
    want = _trace_sequence(REF, backend, "chunk1", dims, seed)
    got = _trace_sequence(PORT, backend, "chunk1", dims, seed)
    assert got == want
    assert got[1] == [1, 0, 0, 1]


@pytest.mark.parametrize("backend", ["scan", "pallas", "sparse", "hash", "bsr", "auto"])
def test_trace_counts_unbatched_match_reference(backend):
    """test_trace_counts_exact's calls through both packages (chunk2):
    first call 1, repeat 0, same structure with new values 0, a new
    geometry 1, each under the key of the backend the call resolves to."""
    seed = 3100 + BATCHED.index(backend)
    results = []
    for cs, ch, pl, reg in (REF, PORT):
        rng = np.random.default_rng(seed)
        a1, b1 = random_dense(rng, 29, 17, 0.25), random_dense(rng, 17, 11, 0.3)
        a2, b2 = random_dense(rng, 31, 18, 0.4), random_dense(rng, 18, 9, 0.35)
        if cs is ref_cs:
            make = ref_from_dense
        else:
            def make(d):
                return csr_from_dense(d, device="cpu")
        deltas, keys = [], []
        for a, b in ((a1, b1), (a1, b1), (a1 * 2.0, b1 * 0.5), (a2, b2)):
            A, B = make(a), make(b)
            plan = _plan("chunk2", A, B)
            if cs is chunk_stream:
                plan = _port_plan(plan)
            c_pad = ch.default_c_pad(A, B, plan)
            name = backend
            if backend == "auto":
                name = pl.select_accumulator_backend(
                    plan, ch.instance_envelope(A, B, plan, c_pad=c_pad))
            key = reg.get(name).trace_key.format(alg="chunk2")
            before = cs.TRACE_COUNTS[key]
            ch.chunked_spgemm(A, B, plan, c_pad, backend=backend,
                              **({"device": "cpu"} if cs is chunk_stream else {}))
            deltas.append(cs.TRACE_COUNTS[key] - before)
            keys.append(key)
        results.append((keys, deltas))
    assert results[1] == results[0]
    assert results[1][1] == [1, 0, 0, 1]
