"""The pipeline's static-audit hooks, on the CPU, against the JAX package.

``pipeline_audit_traces`` stages both hops' cores as the executor would,
and ``audit_pipeline`` holds each hop's byte model to its staged step and
the composed model to the two-hop peak plus the resident intermediate. On
the reference test's fixture (``tests/test_static_audit.py::
_pipeline_fixture``: laplace3d n=4 at a quarter of size(A, P, R), both hops
chunked, T resident) the port and the reference find no violation under
``sparse`` and ``hash``, and ``t_bytes``, ``t_resident`` and
``fast_bytes_needed`` are exactly the reference's; the port is also clean
under its other audited backends. The negative fixture, a composed model
that counts the resident intermediate twice, is flagged by both.
"""

import dataclasses
import functools

import pytest

from repro.core import pipeline_spgemm as ref_pipe
from repro_torch.core import backend_registry, pipeline_spgemm as pipe
from repro_torch.core.memory_model import P100
from repro_torch.core.planner import plan_pipeline
from repro_torch.core.symbolic import pipeline_output_caps
from repro_torch.kernels.convert import plan_from_fields
from repro_torch.sparse import multigrid
from test_static_audit import _pipeline_fixture


@functools.lru_cache(maxsize=None)
def _port_fixture(frac=0.25):
    """``_pipeline_fixture`` built by the port."""
    A, R, P = multigrid.problem("laplace3d", 4, device="cpu")
    limit = float(A.nbytes() + P.nbytes() + R.nbytes()) * frac
    plan = plan_pipeline(A, P, R, P100, fast_limit_bytes=limit)
    return A, P, R, plan, pipeline_output_caps(A, P, R, plan.plan1.p_ac, plan.plan2.p_ac)


@functools.lru_cache(maxsize=None)
def _ref_audit(backend):
    A, P, R, plan, caps = _pipeline_fixture()
    return ref_pipe.audit_pipeline(A, P, R, plan, backend=backend, caps=caps)


def test_fixture_plans_equal():
    ref_plan = _pipeline_fixture()[3]
    plan = _port_fixture()[3]
    for hop in ("plan1", "plan2"):
        assert getattr(plan, hop) == plan_from_fields(
            *dataclasses.astuple(getattr(ref_plan, hop)))
    assert "whole_fast" not in (plan.plan1.algorithm, plan.plan2.algorithm)
    assert plan.t_resident == ref_plan.t_resident
    assert plan.t_bytes == ref_plan.t_bytes


@pytest.mark.parametrize("backend", ("sparse", "hash"))
def test_audit_clean_and_equal_to_reference(backend):
    ref_record, ref_violations = _ref_audit(backend)
    A, P, R, plan, caps = _port_fixture()
    record, violations = pipe.audit_pipeline(A, P, R, plan, backend=backend, caps=caps)
    assert violations == [] and ref_violations == []
    assert record["n_violations"] == 0
    for key in ("backend", "t_resident", "t_bytes", "fast_bytes_needed"):
        assert record[key] == ref_record[key], key
    assert set(record["hops"]) == set(ref_record["hops"]) == {"hop1", "hop2"}
    for hop in record["hops"].values():
        assert hop["model_bytes"] >= hop["step_bytes"] > 0
    assert record["traced_peak"] == max(h["step_bytes"] for h in record["hops"].values())
    assert record["fast_bytes_needed"] >= record["traced_peak"] + (
        plan.t_bytes if plan.t_resident else 0.0)


@pytest.mark.parametrize("backend", ("scan", "pallas", "bsr"))
def test_audit_clean_under_every_audited_backend(backend):
    A, P, R, plan, caps = _port_fixture()
    traces = pipe.pipeline_audit_traces(A, P, R, plan, backend, caps=caps)
    assert [t[0] for t in traces] == ["hop1", "hop2"]
    record, violations = pipe.audit_pipeline(A, P, R, plan, backend=backend, caps=caps)
    assert violations == [], violations
    if backend_registry.get(backend).byte_model is None:   # scan: staged, no model
        assert record["fast_bytes_needed"] is None
        assert all(h["model_bytes"] is None for h in record["hops"].values())


def test_audit_traces_skip_whole_fast_and_refuse_unaudited():
    A, P, R, plan, caps = _port_fixture(frac=4.0)
    kinds = (plan.plan1.algorithm, plan.plan2.algorithm)
    traces = pipe.pipeline_audit_traces(A, P, R, plan, "hash", caps=caps)
    assert [t[0] for t in traces] == [f"hop{i + 1}" for i, k in enumerate(kinds)
                                      if k != "whole_fast"]
    with pytest.raises(ValueError, match="registers no audit_trace"):
        pipe.pipeline_audit_traces(A, P, R, plan, "loop", caps=caps)


def test_double_counted_intermediate_is_flagged_by_both():
    rA, rP, rR, ref_plan, ref_caps = _pipeline_fixture()
    A, P, R, plan, caps = _port_fixture()
    honest = pipe.pipeline_fast_model(plan, pipe.pipeline_envelope(A, P, R, plan, caps),
                                      "sparse")
    ref_honest = ref_pipe.pipeline_fast_model(
        ref_plan, ref_pipe.pipeline_envelope(rA, rP, rR, ref_plan, ref_caps), "sparse")
    assert honest.t_bytes > 0 and honest.fast_bytes_needed == ref_honest.fast_bytes_needed
    assert pipe.check_pipeline_model(honest) == []
    bad = dataclasses.replace(honest, fast_bytes_needed=honest.fast_bytes_needed
                              + honest.t_bytes)
    ref_bad = dataclasses.replace(ref_honest, fast_bytes_needed=bad.fast_bytes_needed)
    for violations in (pipe.check_pipeline_model(bad),
                       ref_pipe.check_pipeline_model(ref_bad)):
        assert violations and "counted exactly once" in violations[0]
