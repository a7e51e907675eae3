"""The two-hop Galerkin pipeline ``C = R x (A x P)`` against the JAX package.

On the four multigrid problems at small size, with a fast budget tight
enough that both hops are chunked, the port's ``plan_pipeline`` must equal
the reference's (every field of both hop plans, the residency decision and
the byte counts), the composed symbolic caps and envelopes must be equal,
and ``pipeline_spgemm`` through the ``hash`` and ``sparse`` backends (each
on two of the problems) must give the reference's C: structure exact, values within atol 1e-4, and the
same per-hop ChunkStats and spill bytes. The resident and spill paths must
give the same structure.
"""

import dataclasses
import functools

import numpy as np
import pytest

from repro.core import pipeline_spgemm as ref_pipe
from repro.core import planner as ref_planner
from repro.core import symbolic as ref_symbolic
from repro.core.memory_model import P100 as REF_P100
from repro.sparse import multigrid as ref_mg
from repro_torch.core import pipeline_spgemm as pipe
from repro_torch.core import planner, symbolic
from repro_torch.core.memory_model import P100
from test_torch_sparse_accum import _port

ATOL = 1e-4
SIZES = {"laplace3d": 4, "bigstar2d": 8, "brick3d": 4, "elasticity": 3}


@functools.lru_cache(maxsize=None)
def _problem(name):
    A, R, P = ref_mg.problem(name, SIZES[name])
    return (A, R, P), tuple(_port(m) for m in (A, R, P))


def _limit(ref_ops, frac):
    A, R, P = ref_ops
    return float(A.nbytes() + P.nbytes() + R.nbytes()) * frac


def _plan_tuple(p):
    return (dataclasses.astuple(p.plan1), dataclasses.astuple(p.plan2),
            p.t_resident, p.t_bytes, p.copy_bytes, p.fast_bytes_needed)


def _stats_tuple(s):
    return (s.algorithm, s.n_ac, s.n_b, s.kernel_calls, tuple(s.per_copy_in),
            tuple(s.per_copy_out))


def assert_csr_match(got, want, exact_values=False):
    nnz = int(np.asarray(want.indptr)[-1])
    np.testing.assert_array_equal(got.indptr.numpy(), np.asarray(want.indptr))
    np.testing.assert_array_equal(got.indices.numpy()[:nnz], np.asarray(want.indices)[:nnz])
    np.testing.assert_allclose(got.data.numpy()[:nnz], np.asarray(want.data)[:nnz],
                               atol=0 if exact_values else ATOL, rtol=0)


# every problem once, each backend on two of them (the reference kernels
# run interpreted, a few seconds a hop)
CELLS = [("laplace3d", "hash"), ("brick3d", "hash"), ("bigstar2d", "sparse"),
         ("elasticity", "sparse")]


@pytest.mark.parametrize(("name", "backend"), CELLS)
def test_pipeline_matches_reference(name, backend):
    ref_ops, (A, R, P) = _problem(name)
    rA, rR, rP = ref_ops
    limit = _limit(ref_ops, 0.25)
    ref_plan = ref_planner.plan_pipeline(rA, rP, rR, REF_P100, fast_limit_bytes=limit)
    plan = planner.plan_pipeline(A, P, R, P100, fast_limit_bytes=limit)
    assert _plan_tuple(plan) == _plan_tuple(ref_plan)
    assert "whole_fast" not in (plan.plan1.algorithm, plan.plan2.algorithm)
    want, want_stats = ref_pipe.pipeline_spgemm(rA, rP, rR, ref_plan, backend=backend)
    got, stats = pipe.pipeline_spgemm(A, P, R, plan, backend=backend)
    assert_csr_match(got, want)
    assert stats.spilled == want_stats.spilled
    assert stats.spill_bytes == want_stats.spill_bytes
    assert _stats_tuple(stats.hop1) == _stats_tuple(want_stats.hop1)
    assert _stats_tuple(stats.hop2) == _stats_tuple(want_stats.hop2)
    assert stats.copy_bytes == pytest.approx(want_stats.copy_bytes, rel=1e-12)


@pytest.mark.parametrize("name", ["laplace3d", "elasticity"])
def test_pipeline_caps_envelope_and_fast_model_exact(name):
    ref_ops, (A, R, P) = _problem(name)
    rA, rR, rP = ref_ops
    limit = _limit(ref_ops, 0.25)
    ref_plan = ref_planner.plan_pipeline(rA, rP, rR, REF_P100, fast_limit_bytes=limit)
    plan = planner.plan_pipeline(A, P, R, P100, fast_limit_bytes=limit)
    ref_caps = ref_symbolic.pipeline_output_caps(rA, rP, rR, ref_plan.plan1.p_ac,
                                                 ref_plan.plan2.p_ac)
    caps = symbolic.pipeline_output_caps(A, P, R, plan.plan1.p_ac, plan.plan2.p_ac)
    for f in ("hop1", "hop2"):
        assert dataclasses.astuple(getattr(caps, f)) == dataclasses.astuple(getattr(ref_caps, f))
    assert (caps.t_nnz, caps.t_max_row_nnz) == (ref_caps.t_nnz, ref_caps.t_max_row_nnz)
    assert_csr_match(caps.t_pattern, ref_caps.t_pattern, exact_values=True)
    assert_csr_match(symbolic.spgemm_pattern_host(A, P),
                     ref_symbolic.spgemm_pattern_host(rA, rP), exact_values=True)
    for rows, cap, itemsize in ((5, 0, 4), (127, 3001, 4), (1, 8, 8)):
        assert (planner.csr_field_nbytes(rows, cap, itemsize)
                == ref_planner.csr_field_nbytes(rows, cap, itemsize))
    penv = pipe.pipeline_envelope(A, P, R, plan, caps)
    ref_penv = ref_pipe.pipeline_envelope(rA, rP, rR, ref_plan, ref_caps)
    assert dataclasses.astuple(penv.hop1) == dataclasses.astuple(ref_penv.hop1)
    assert dataclasses.astuple(penv.hop2) == dataclasses.astuple(ref_penv.hop2)
    for backend in ("sparse", "hash", "pallas"):
        model = pipe.pipeline_fast_model(plan, penv, backend)
        ref_model = ref_pipe.pipeline_fast_model(ref_plan, ref_penv, backend)
        assert model.fast_bytes_needed == ref_model.fast_bytes_needed
        assert dataclasses.astuple(model.hop1)[1:] == dataclasses.astuple(ref_model.hop1)[1:]
        assert pipe.check_pipeline_model(model) == []
        bad = dataclasses.replace(model, fast_bytes_needed=model.fast_bytes_needed
                                  + model.t_bytes)
        assert pipe.check_pipeline_model(bad) and ref_pipe.check_pipeline_model(
            dataclasses.replace(ref_model, fast_bytes_needed=bad.fast_bytes_needed))


def test_pipeline_resident_and_spill_same_structure():
    ref_ops, (A, R, P) = _problem("bigstar2d")
    C_ample, s_ample = pipe.pipeline_spgemm(A, P, R, system=P100, backend="sparse")
    C_tight, s_tight = pipe.pipeline_spgemm(A, P, R, system=P100, backend="hash",
                                            fast_limit_bytes=_limit(ref_ops, 0.25))
    assert s_ample.plan.t_resident and not s_tight.plan.t_resident
    assert s_tight.spilled and s_tight.spill_bytes > 0
    assert s_tight.copy_bytes > s_tight.hop1.copy_bytes + s_tight.hop2.copy_bytes
    nnz = C_ample.nnz()
    assert np.array_equal(C_ample.indptr.numpy(), C_tight.indptr.numpy())
    assert np.array_equal(C_ample.indices.numpy()[:nnz], C_tight.indices.numpy()[:nnz])
    np.testing.assert_allclose(C_ample.data.numpy()[:nnz], C_tight.data.numpy()[:nnz],
                               atol=ATOL, rtol=1e-5)


def test_pipeline_requires_plan_or_system():
    _, (A, R, P) = _problem("laplace3d")
    with pytest.raises(ValueError, match="PipelinePlan or"):
        pipe.pipeline_spgemm(A, P, R)
