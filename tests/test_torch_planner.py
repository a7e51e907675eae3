"""Parity of the port's host planning layer with the JAX package.

Symbolic caps, Algorithm 4 and Algorithm 1 plans, the envelope, the three
accumulator byte models, the ``auto`` choice, the plan-derived ChunkStats,
the memory model and the placement policy must be exactly equal.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import chunk_stream as ref_cs
from repro.core import chunking as ref_chunking
from repro.core import memory_model as ref_mm
from repro.core import placement as ref_pl
from repro.core import planner as ref_planner
from repro.core import symbolic as ref_sym
from repro.sparse import generators as ref_gen
from repro.sparse import multigrid as ref_mg
from repro_torch.core import backend_registry
from repro_torch.core import chunk_stream as port_cs
from repro_torch.core import chunking as port_chunking
from repro_torch.core import memory_model as port_mm
from repro_torch.core import placement as port_pl
from repro_torch.core import planner as port_planner
from repro_torch.core import symbolic as port_sym
from repro_torch.kernels.convert import csr_from_fields
from repro_torch.sparse import generators as port_gen

CPU = "cpu"


def _port(ref):
    return csr_from_fields(np.asarray(ref.indptr), np.asarray(ref.indices),
                           np.asarray(ref.data), ref.shape, ref.max_row_nnz,
                           device=CPU)


def _operands(name: str):
    if name == "uniform":
        A = ref_gen.random_uniform_degree(150, 120, 6, seed=3)
        B = ref_gen.random_uniform_degree(120, 90, 4, seed=4)
    else:
        problem, n = name.split(":")
        A, _, B = ref_mg.problem(problem, int(n))
    return A, B, _port(A), _port(B)


PROBLEMS = ["brick3d:6", "elasticity:4", "laplace3d:6", "bigstar2d:9", "uniform"]
DIVISORS = [1, 2, 4, 8, 12, 16]


def _c_row_bytes(A, B):
    ws = ref_sym.spgemm_structure_host(A, B)
    return np.full(A.n_rows, max(ws.c_nnz / A.n_rows, 1) * 12.0)


def _budget(A, B, crb):
    return (float(ref_planner.row_bytes_csr(A).sum()
                  + ref_planner.row_bytes_csr(B).sum()) + float(crb.sum()))


def _plans(A, B, crb):
    full = _budget(A, B, crb)
    out = [("chunks", d, ref_planner.plan_chunks(A, B, crb, ref_mm.P100,
                                                  fast_limit_bytes=full / d))
           for d in DIVISORS]
    b_bytes = float(ref_planner.row_bytes_csr(B).sum())
    out += [("knl", d, ref_planner.plan_knl(A, B, fast_limit_bytes=b_bytes / d))
            for d in (1, 3, 5)]
    return out


@pytest.mark.parametrize("name", PROBLEMS)
def test_symbolic_and_caps_equal(name):
    A, B, pA, pB = _operands(name)
    rs, ps = ref_sym.spgemm_structure_host(A, B), port_sym.spgemm_structure_host(pA, pB)
    np.testing.assert_array_equal(ps.per_row_nnz, rs.per_row_nnz)
    assert (ps.c_nnz, ps.c_max_row_nnz, ps.flops) == (rs.c_nnz, rs.c_max_row_nnz, rs.flops)
    for bounds in [(0, A.n_rows), (0, A.n_rows // 3, A.n_rows // 2, A.n_rows)]:
        for mult in (1, 64):
            assert (dataclasses.astuple(
                        port_sym.strip_output_caps(pA, pB, bounds, pad_multiple=mult))
                    == dataclasses.astuple(
                        ref_sym.strip_output_caps(A, B, bounds, pad_multiple=mult)))


@pytest.mark.parametrize("name", PROBLEMS)
def test_plans_equal(name):
    A, B, pA, pB = _operands(name)
    np.testing.assert_array_equal(port_planner.row_bytes_csr(pA),
                                  ref_planner.row_bytes_csr(A))
    crb = _c_row_bytes(A, B)
    full = _budget(A, B, crb)
    for kind, d, ref_plan in _plans(A, B, crb):
        if kind == "chunks":
            plan = port_planner.plan_chunks(pA, pB, crb, port_mm.P100,
                                            fast_limit_bytes=full / d)
        else:
            b_bytes = float(ref_planner.row_bytes_csr(B).sum())
            plan = port_planner.plan_knl(pA, pB, fast_limit_bytes=b_bytes / d)
        assert dataclasses.astuple(plan) == dataclasses.astuple(ref_plan), (kind, d)
        if plan.algorithm != "whole_fast":
            assert (port_planner.staged_chunk_bytes(pB, plan.p_b)
                    == ref_planner.staged_chunk_bytes(B, ref_plan.p_b))
            assert (port_planner.staged_row_bytes(crb, plan.p_ac)
                    == ref_planner.staged_row_bytes(crb, ref_plan.p_ac))


def test_partition_primitives_equal():
    rng = np.random.default_rng(2)
    rb = rng.integers(0, 400, 300).astype(np.int32) * 12
    for target in (10.0, 500.0, 4000.0, 1e9):
        assert (port_planner.binary_search_partition(rb, target)
                == ref_planner.binary_search_partition(rb, target))
    for alg in ("chunk1", "chunk2"):
        assert (port_planner.partition_cost(1e5, 3e5, 2e4, 4, 3, alg)
                == ref_planner.partition_cost(1e5, 3e5, 2e4, 4, 3, alg))
    for v in (0, 1, 2, 3, 27, 64, 81, 1000):
        assert port_planner.hash_table_slots(v) == ref_planner.hash_table_slots(v)


@pytest.mark.parametrize("name", PROBLEMS)
def test_envelopes_byte_models_and_auto_equal(name):
    A, B, pA, pB = _operands(name)
    crb = _c_row_bytes(A, B)
    assert (port_planner.accumulator_backends() == ref_planner.accumulator_backends()
            == ("pallas", "sparse", "hash", "bsr"))
    for _, _, ref_plan in _plans(A, B, crb):
        if ref_plan.algorithm == "whole_fast":
            continue
        plan = port_planner.ChunkPlan(*dataclasses.astuple(ref_plan))
        ref_env = ref_chunking.instance_envelope(A, B, ref_plan)
        env = port_chunking.instance_envelope(pA, pB, plan)
        assert dataclasses.astuple(env) == dataclasses.astuple(ref_env)
        for fn in ("planned_stats_dense_slab", "planned_stats_sparse",
                   "planned_stats_hash", "planned_stats_bsr"):
            assert (dataclasses.astuple(getattr(port_planner, fn)(plan, env))
                    == dataclasses.astuple(getattr(ref_planner, fn)(ref_plan, ref_env)))
        assert (port_planner.select_accumulator_backend(plan, env)
                == ref_planner.select_accumulator_backend(ref_plan, ref_env))


def _stats_tuple(s):
    return (s.algorithm, s.n_ac, s.n_b, s.kernel_calls, s.copy_in_bytes,
            s.copy_out_bytes, tuple(s.per_copy_in), tuple(s.per_copy_out))


@pytest.mark.parametrize("algorithm", ["knl", "chunk1", "chunk2"])
def test_plan_derived_stats_equal(algorithm):
    p_ac = (0, 40) if algorithm == "knl" else (0, 13, 29, 40)
    plan = port_planner.ChunkPlan(algorithm, p_ac, (0, 7, 20, 31, 50), 0.0, 0.0)
    ref_plan = ref_planner.ChunkPlan(algorithm, p_ac, (0, 7, 20, 31, 50), 0.0, 0.0)
    assert (_stats_tuple(port_cs.planned_stats(plan, 1036, 2212, 804))
            == _stats_tuple(ref_cs.planned_stats(ref_plan, 1036, 2212, 804)))
    assert (_stats_tuple(port_cs.planned_stats_pallas(plan, 1036, 2212, 804))
            == _stats_tuple(ref_cs.planned_stats_pallas(ref_plan, 1036, 2212, 804)))
    assert (port_cs._pallas_stage_nbytes(16, 40, 19, 33)
            == ref_cs._pallas_stage_nbytes(16, 40, 19, 33))


def test_check_output_caps_raises_like_reference():
    kw = dict(backend="hash", a_shape=(4, 5), b_shape=(5, 6))
    port_planner.check_output_caps((10, 12), 4, 12, 4, **kw)
    with pytest.raises(ValueError, match="exceeds the accumulator capacity"):
        port_planner.check_output_caps((10, 13), 4, 12, 4, **kw)
    with pytest.raises(ValueError, match="hash-table capacity"):
        port_planner.check_output_caps((10, 12), 5, 12, 4, **kw)


def test_registry_roster_and_contracts():
    assert [s.name for s in backend_registry.specs()] == [
        "loop", "scan", "pallas", "sparse", "hash", "bsr"]
    assert [s.name for s in backend_registry.accumulator_specs()] == [
        "pallas", "sparse", "hash", "bsr"]
    assert backend_registry.masked_backends() == ("hash",)
    assert backend_registry.get("bsr").block_size == 8
    with pytest.raises(ValueError, match="registers no block_size"):
        backend_registry.register(backend_registry.BackendSpec(
            name="y", executors=dict.fromkeys(backend_registry.ALGORITHMS, len),
            needs_block_caps=True))
    with pytest.raises(ValueError, match="unknown backend"):
        backend_registry.get("nope")
    spec = backend_registry.BackendSpec(name="auto", executors={})
    with pytest.raises(ValueError, match="dispatch mode"):
        backend_registry.register(spec)
    with pytest.raises(ValueError, match="missing executors"):
        backend_registry.register(backend_registry.BackendSpec(name="x", executors={}))


PRESETS = ("KNL", "P100")


def test_memory_model_and_placement_equal():
    for key in PRESETS:
        assert getattr(port_mm, key) == _mm_copy(getattr(ref_mm, key))
    kw = dict(bytes_A=3e9, bytes_B=8e8, bytes_C=1e9, flops=4e10,
              b_row_reads=2e8, b_row_bytes=96.0, b_miss_fraction=0.3,
              place_A="slow", place_B="fast", place_C="slow", copy_bytes=1e6)
    for key in PRESETS:
        port_sys, ref_sys = getattr(port_mm, key), getattr(ref_mm, key)
        assert (dataclasses.astuple(port_mm.spgemm_cost(port_sys, **kw))
                == dataclasses.astuple(ref_mm.spgemm_cost(ref_sys, **kw)))
        for sizes in [(1e9, 1e9, 1e9), (2e10, 4e9, 3e9), (5e10, 4e10, 1e10)]:
            assert (port_pl.dp_recommendation(port_sys, *sizes)
                    == _pl_copy(ref_pl.dp_recommendation(ref_sys, *sizes)))
    A, B, pA, pB = _operands("brick3d:6")
    for placement in ("ALL_FAST", "ALL_SLOW", "DP"):
        got = port_pl.placement_cost(port_mm.P100, getattr(port_pl, placement),
                                     pA, pB, 5e4, 1e6)
        want = ref_pl.placement_cost(ref_mm.P100, getattr(ref_pl, placement),
                                     A, B, 5e4, 1e6)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)


def _mm_copy(ref_system):
    """The reference's MemorySystem rebuilt from the port's classes."""
    lvl = lambda lv: port_mm.MemoryLevel(**dataclasses.asdict(lv))  # noqa: E731
    d = dataclasses.asdict(ref_system)
    d["fast"], d["slow"] = lvl(ref_system.fast), lvl(ref_system.slow)
    return port_mm.MemorySystem(**d)


def _pl_copy(ref_placement):
    return port_pl.Placement(ref_placement.A, ref_placement.B, ref_placement.C)


def test_uniform_generator_plan_under_port_generator():
    """A plan built entirely from port objects (generator included) equals
    the reference's on the same seed."""
    pA = port_gen.random_uniform_degree(150, 120, 6, seed=3, device=CPU)
    pB = port_gen.random_uniform_degree(120, 90, 4, seed=4, device=CPU)
    A, B, _, _ = _operands("uniform")
    crb = _c_row_bytes(A, B)
    full = _budget(A, B, crb)
    got = port_planner.plan_chunks(pA, pB, crb, port_mm.KNL, fast_limit_bytes=full / 6)
    want = ref_planner.plan_chunks(A, B, crb, ref_mm.KNL, fast_limit_bytes=full / 6)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
