"""The port's static auditor (``repro_torch.analysis``) on the CPU.

* The corpus builds the JAX package's matrices, field for field.
* For every backend x algorithm x corpus case the port's ``traffic_model``
  gives the reference's ``ExpectedTraffic`` exactly: the values, not the
  reference auditor's verdicts (three of its tests fail under this jax).
* ``audit_all(cases="fast")`` is clean; every accumulator's byte model was
  checked against a staged step, flow equality ran where a model is
  registered, the scan backend's exemption is recorded.
* Negative fixtures each give their violation: an undercounting byte
  model, a traffic model missing an event, a wrong event size (located by
  index), stats above the recorded flow, a leaked Python scalar in a core's
  static geometry, a staging shape mismatch, a shared-memory request over
  the limit, a float64 operand.
"""

import collections
import dataclasses
import functools

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the package before its kernels: they import each other)
from repro.analysis import corpus as ref_corpus
from repro.core import backend_registry as ref_registry
from repro.core.chunking import instance_envelope as ref_instance_envelope
from repro_torch.analysis import (
    audit_all, audit_smem, check_preflight, check_retrace, check_smem, check_traffic,
    normalize_analyses, trace_text, traced_flows,
)
from repro_torch.analysis import corpus
from repro_torch.analysis.__main__ import main as audit_main
from repro_torch.analysis.smem import launch_requests
from repro_torch.core import backend_registry
from repro_torch.core.backend_registry import BackendSpec, TraceTarget
from repro_torch.core.chunk_stream import _Core
from repro_torch.core.chunking import instance_envelope
from repro_torch.kernels import copy_events
from repro_torch.kernels.sparse_accum_spgemm import SMEM_PER_BLOCK

TRAFFIC_BACKENDS = ("pallas", "sparse", "hash", "bsr")
ALGORITHMS = ("knl", "chunk1", "chunk2")


@pytest.mark.parametrize("case", sorted(corpus.CASES))
def test_corpus_matrices_equal_the_reference(case):
    assert corpus.CASES[case][1] == ref_corpus.CASES[case][1]
    for port, ref in zip(corpus.build_case(case, device="cpu"), ref_corpus.build_case(case)):
        assert port.shape == ref.shape and port.max_row_nnz == ref.max_row_nnz
        for f in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(port, f).numpy(), np.asarray(getattr(ref, f)))
    A, B = corpus.build_case(case, device="cpu")
    for alg in ALGORITHMS:
        assert dataclasses.astuple(corpus.make_plan(alg, A, B)) == dataclasses.astuple(
            ref_corpus.make_plan(alg, *ref_corpus.build_case(case)))
    for port, ref in zip(corpus.retrace_pair(A, B),
                         ref_corpus.retrace_pair(*ref_corpus.build_case(case))):
        np.testing.assert_array_equal(port.data.numpy(), np.asarray(ref.data))
        np.testing.assert_array_equal(port.indices.numpy(), np.asarray(ref.indices))


def _staged(backend, algorithm, case, device="cpu"):
    spec = backend_registry.get(backend)
    A, B = corpus.build_case(case, device=device)
    plan = corpus.make_plan(algorithm, A, B)
    env = instance_envelope(A, B, plan,
                            block_size=spec.block_size if spec.needs_block_caps else None)
    return spec, A, B, plan, env, spec.audit_trace(A, B, plan, env.c_pad, env)


@pytest.mark.parametrize("case", sorted(corpus.CASES))
@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("backend", TRAFFIC_BACKENDS)
def test_traffic_model_equals_the_reference(backend, algorithm, case):
    spec, A, B, plan, env, target = _staged(backend, algorithm, case)
    got = spec.traffic_model(A, B, plan, env.c_pad, env, target.meta)
    ref_spec = ref_registry.get(backend)
    rA, rB = ref_corpus.build_case(case)
    rplan = ref_corpus.make_plan(algorithm, rA, rB)
    renv = ref_instance_envelope(
        rA, rB, rplan, block_size=ref_spec.block_size if ref_spec.needs_block_caps else None)
    rtarget = ref_spec.audit_trace(rA, rB, rplan, renv.c_pad, renv)
    want = ref_spec.traffic_model(rA, rB, rplan, renv.c_pad, renv, rtarget.meta)
    assert env.c_pad == renv.c_pad
    for side in ("in_ops", "out_ops"):
        assert [(op.key, tuple(map(float, op.events))) for op in getattr(got, side)] == \
            [(op.key, tuple(map(float, op.events))) for op in getattr(want, side)]
    assert tuple(map(float, got.stats_in)) == tuple(map(float, want.stats_in))
    assert tuple(map(float, got.stats_out)) == tuple(map(float, want.stats_out))
    assert got.stats_exempt == want.stats_exempt


def test_audit_clean_on_fast_corpus():
    rep = audit_all(cases="fast", device="cpu")
    assert rep["ok"], rep["violations"]
    assert set(rep) >= {"ok", "violations", "analyses", "skipped", "records"}
    assert rep["cases"] == list(corpus.FAST_CASES)
    assert rep["analyses"] == ["smem", "traffic", "retrace", "preflight", "dma", "while",
                               "interleave"]
    checked = {r["backend"] for r in rep["records"] if r["dominated"] is True}
    assert set(TRAFFIC_BACKENDS) <= checked
    assert [s["backend"] for s in rep["skipped"]] == ["loop"]
    for r in rep["records"]:
        if r["backend"] in TRAFFIC_BACKENDS:
            assert r["traffic"]["checked"] and r["traffic"]["in_events"] > 0, r
            assert r["n_launches"] == 1
            assert all(q["total"] <= SMEM_PER_BLOCK for q in r["smem"]["requests"])
        else:
            assert r["backend"] == "scan" and r["traffic"]["checked"] is False
            assert "reason" in r["traffic"] and r["dominated"] is None
        assert r["preflight"]["counts"]["error"] == 0, r
    infos = {r["backend"]: [d["check"] for d in r["preflight"]["diagnostics"]]
             for r in rep["records"]}
    assert {b for b, checks in infos.items() if "chooser" in checks} == {
        "pallas", "sparse", "bsr"}


def test_audit_analyses_subset_and_cli():
    rep = audit_all(cases=["skewed_rows"], backends=["pallas"], algorithms=["knl"],
                    analyses=["preflight"], device="cpu")
    assert rep["ok"] and rep["analyses"] == ["preflight"]
    (record,) = rep["records"]
    assert "preflight" in record and "smem" not in record and "traffic" not in record
    with pytest.raises(ValueError, match="unknown analyses"):
        normalize_analyses(["preflight", "nonsense"])
    assert audit_main(["--cases", "fast", "--device", "cpu", "--analyses",
                       "traffic,smem", "--backends", "sparse,hash"]) == 0


def test_copy_events_are_off_by_default():
    spec, *_, target = _staged("sparse", "chunk1", "skewed_rows")
    assert not copy_events.active()
    target.fn(*target.args)
    assert not copy_events.active()
    launches = traced_flows(target)
    assert [launch.kernel for launch in launches] == ["sparse_accum_spgemm"]
    assert not copy_events.active()


@pytest.mark.parametrize("backend", ["scan", "pallas", "sparse", "hash", "bsr"])
def test_retrace_identical_across_backends(backend):
    """Same envelope, different instance data: one static geometry, one
    compile through one core."""
    spec = backend_registry.get(backend)
    A, B = corpus.build_case("dense_row", device="cpu")
    A2, B2 = corpus.retrace_pair(A, B)
    for algorithm in ("knl", "chunk2"):
        plan = corpus.make_plan(algorithm, A, B)
        block = spec.block_size if spec.needs_block_caps else None
        env = instance_envelope(A, B, plan, block_size=block).union(
            instance_envelope(A2, B2, plan, block_size=block))
        t1 = spec.audit_trace(A, B, plan, env.c_pad, env)
        t2 = spec.audit_trace(A2, B2, plan, env.c_pad, env)
        assert trace_text(t1) == trace_text(t2)
        assert check_retrace(t1, t2) == [], (backend, algorithm)


# -- negative fixtures --------------------------------------------------------


def test_undercounting_byte_model_is_flagged():
    spec, A, B, plan, env, target = _staged("sparse", "chunk1", "skewed_rows")
    launches = traced_flows(target)
    honest = spec.byte_model(plan, env)
    assert audit_smem(target, launches, honest).dominated is True
    lying = dataclasses.replace(honest, fast_bytes_needed=64.0)
    audit = audit_smem(target, launches, lying)
    assert audit.dominated is False
    assert any("undercounts" in v for v in check_smem(audit))


def _traffic_fixture(backend="pallas"):
    spec, A, B, plan, env, target = _staged(backend, "chunk1", "skewed_rows")
    return traced_flows(target), spec.traffic_model(A, B, plan, env.c_pad, env, target.meta)


def test_traffic_flow_divergence_is_flagged():
    launches, expected = _traffic_fixture()
    assert check_traffic(launches, expected)[0] == []
    short = dataclasses.replace(expected.in_ops[1], events=expected.in_ops[1].events[:-1])
    tampered = dataclasses.replace(
        expected, in_ops=(expected.in_ops[0], short, expected.in_ops[2]))
    violations, _ = check_traffic(launches, tampered)
    assert any("copy events" in v and "slow->fast" in v for v in violations)


def test_traffic_wrong_event_size_diff_names_the_event():
    launches, expected = _traffic_fixture()
    events = list(expected.in_ops[0].events)
    events[1] = events[1] + 4.0
    bad = dataclasses.replace(expected.in_ops[0], events=tuple(events))
    violations, _ = check_traffic(
        launches, dataclasses.replace(expected, in_ops=(bad,) + expected.in_ops[1:]))
    assert any("first divergence at event 1" in v for v in violations)


def test_traffic_stats_undercount_is_flagged():
    launches, expected = _traffic_fixture("sparse")
    assert check_traffic(launches, expected)[0] == []
    undercounted = dataclasses.replace(expected, stats_in=expected.stats_in[:-1])
    violations, _ = check_traffic(launches, undercounted)
    assert any("stats tie broken" in v for v in violations)
    assert any("absent from the stats" in v for v in violations)


def test_leaked_python_scalar_is_flagged():
    """A core that keys on a value from the instance data stages two
    same-envelope instances to two geometries, and counts two compiles."""
    A, _ = corpus.build_case("skewed_rows", device="cpu")
    A2, _ = corpus.retrace_pair(A, A)
    cap = max(A.data.numel(), A2.data.numel())
    core = _Core("leak_fixture", lambda data, *, scale: data * scale,
                 collections.Counter())

    def make_target(M):
        staged = torch.zeros(cap)                      # envelope-shaped staging
        staged[: M.data.numel()] = M.data
        leak = float(M.data[0])                        # Python scalar from the data
        return TraceTarget(fn=functools.partial(core, scale=leak), args=(staged,))

    violations = check_retrace(make_target(A), make_target(A2))
    assert violations and "leaked" in violations[0]
    assert "static scale" in violations[0]


def test_staging_shape_mismatch_is_flagged():
    core = _Core("shape_fixture", lambda x: x, collections.Counter())
    a = TraceTarget(fn=functools.partial(core), args=(torch.ones(3),))
    b = TraceTarget(fn=functools.partial(core), args=(torch.ones(4),))
    violations = check_retrace(a, b)
    assert violations and "staging is broken" in violations[0]


def test_smem_request_over_the_limit_is_flagged():
    """A hash table of 32,768 slots: 256 KB of shared memory a row, past a
    block's 232,448 bytes; smem and preflight both refuse it."""
    spec, A, B, plan, env, target = _staged("hash", "chunk1", "skewed_rows")
    big = TraceTarget(fn=functools.partial(target.fn.func, table_size=32_768),
                      args=target.args, meta={**target.meta, "table_size": 32_768})
    launches = traced_flows(big)
    audit = audit_smem(big, launches, spec.byte_model(plan, env))
    assert audit.over_limit and audit.requests[0]["dynamic"] == 32_768 * 8
    assert any("more than the 232448" in v for v in check_smem(audit))
    violations, info = check_preflight("hash", big, launch_requests(big, launches))
    assert any("shared-memory" in v for v in violations) and info["counts"]["error"] == 1
    # the real table fits
    assert check_preflight("hash", target, launch_requests(target, traced_flows(target)))[0] \
        == []


def test_float64_operand_and_wide_table_are_flagged():
    spec, *_, target = _staged("pallas", "chunk1", "skewed_rows")
    Ast, Bst, r0s = target.args
    wide = dataclasses.replace(Ast, data=Ast.data.double())
    bad = TraceTarget(fn=target.fn, args=(wide, Bst, r0s),
                      meta={"scalar_args": (np.asarray([0, 2**31], np.int64),)})
    violations, info = check_preflight("pallas", bad)
    assert any("float64" in v for v in violations)
    assert any("wider than int32" in v for v in violations)
    assert check_preflight("pallas", target)[0] == []


def test_esc_routes_show_in_preflight(monkeypatch):
    """Where the launch-wide bound passes a block (monkeypatched) and the
    class cuts are small, the ESC route info names the step classes, their
    launches and shared memory, and the shared-memory audit lists each
    class kernel that launches at its own dynamic bytes."""
    from repro_torch.analysis.smem import launch_requests
    from repro_torch.kernels import sparse_accum_spgemm as esc

    _, *_, target = _staged("sparse", "chunk1", "dense_row")
    bound = esc.esc_workspace
    monkeypatch.setattr(esc, "esc_workspace",
                        lambda *a: (bound(*a)[0], esc.SMEM_PER_BLOCK + 1))
    monkeypatch.setattr(esc, "STEP_CLASSES", tuple(
        (name, kind, w) for (name, kind, _), w in zip(esc.STEP_CLASSES, (1, 2, 4, 8))))
    _, info = check_preflight("sparse", target)
    (msg,) = [d["message"] for d in info["diagnostics"] if d["check"] == "chooser"]
    assert "steps by class" in msg and "'global'" in msg and "shared memory a block" in msg
    plan = esc.esc_launch_plan(*target.args, row_cap=target.fn.keywords["row_cap"])
    requests = launch_requests(target, [type("L", (), {"kernel": "sparse_accum_spgemm"})])
    assert [(r["kernel"], r["dynamic"]) for r in requests] == [
        (c.kernel, c.smem) for c in plan.classes if c.name in plan.launches]
    assert "esc_global_kernel" in {r["kernel"] for r in requests}


# -- registry validation --------------------------------------------------------


def test_register_rejects_traffic_model_without_audit_trace():
    spec = BackendSpec(name="_audit_test_backend",
                       executors=dict.fromkeys(backend_registry.ALGORITHMS, lambda: None),
                       traffic_model=lambda *a: None)
    with pytest.raises(ValueError, match="traffic_model without an\\s+audit_trace"):
        backend_registry.register(spec)
    assert spec.name not in backend_registry._REGISTRY


def test_registered_specs_match_the_reference_capabilities():
    for spec in backend_registry.specs():
        ref = ref_registry.get(spec.name)
        assert spec.supports_audit == ref.supports_audit, spec.name
        assert spec.supports_traffic == ref.supports_traffic, spec.name
    assert backend_registry.get("bsr").stats_exempt
    assert backend_registry.get("scan").traffic_model is None
