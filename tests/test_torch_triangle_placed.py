"""Fused triangle counting with L in slow memory, on the CPU, against the
JAX package.

``count_triangles(L, plan, placement=..., device="cpu")`` streams each slow
role of L (A strips, B chunks, and the mask beside C) through the copy
ring into the masked kernel, one launch a step, and sums C in float64 on
the run device; the fast roles share one whole copy of L, logged as one
transfer apart from the events. On the reference's triangle graphs x the
six Table 3 placements x the three algorithms: the count equals the
reference's, the placed masked executor's C equals the all-fast
``chunk_hash_masked`` bit for bit with the reference's ChunkStats, and the
ring's bytes equal the masked events (``planned_events_masked``), role for
role.
"""

import dataclasses
import functools

import pytest
import torch

from repro.core import chunk_stream as ref_cs
from repro.core import triangle as ref_tri
from repro.core.planner import ChunkPlan
from repro.core.symbolic import masked_output_caps as ref_masked_caps
from repro_torch.analysis.dma import check_ring_structure
from repro_torch.core import backend_registry, chunk_stream, copy_ring, triangle
from repro_torch.core.chunking import a_strips, b_chunks
from repro_torch.core.placement import ALL_FAST, DP, TABLE3
from repro_torch.core.symbolic import masked_output_caps
from repro_torch.kernels.convert import plan_from_fields
from test_torch_triangle import GRAPHS, _lower

ALGORITHMS = ("knl", "chunk1", "chunk2")


@functools.lru_cache(maxsize=None)
def _reference(name, algorithm):
    """The reference's count, and its masked executor's ChunkStats on the
    plan (L strips in quarters, chunks in thirds)."""
    ref_L, _ = _lower(name)
    n = ref_L.n_rows
    p_ac = (0, n) if algorithm == "knl" else (0, n // 4, n // 2, 3 * n // 4, n)
    plan = ChunkPlan(algorithm, p_ac, (0, n // 3, 2 * n // 3, n), 0.0, 0.0)
    caps = ref_masked_caps(ref_L, p_ac)
    _, stats = ref_cs.chunk_hash_masked(ref_L, ref_L, ref_L, plan, caps.c_pad, caps=caps)
    return float(ref_tri.count_triangles_dense(ref_L)), plan, stats


@functools.lru_cache(maxsize=None)
def _all_fast(name, algorithm):
    L = _lower(name)[1]
    plan = plan_from_fields(*dataclasses.astuple(_reference(name, algorithm)[1]))
    caps = masked_output_caps(L, plan.p_ac)
    return chunk_stream.chunk_hash_masked(L, L, L, plan, caps.c_pad, caps=caps)


def _masked_events(L, plan, c_pad):
    strips, chunks = a_strips(L, plan.p_ac), b_chunks(L, plan.p_b)
    strip_rows = strips[0].n_rows
    m_struct = (strip_rows + 1) * 4 + strips[0].indices.shape[-1] * 4
    return chunk_stream.planned_events_masked(
        plan, chunks[0].nbytes(), strips[0].nbytes(),
        chunk_stream._c_strip_nbytes(strip_rows, c_pad, L.dtype), m_struct)


@pytest.mark.parametrize("placement", sorted(TABLE3))
@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_placed_count_matches_reference(name, algorithm, placement):
    want, ref_plan, ref_stats = _reference(name, algorithm)
    L = _lower(name)[1]
    plan = plan_from_fields(*dataclasses.astuple(ref_plan))
    caps = masked_output_caps(L, plan.p_ac)
    where = TABLE3[placement]
    with copy_ring.RingLog() as log:
        got = triangle.count_triangles(L, plan=plan, caps=caps, placement=where,
                                       device="cpu")
    assert got.dtype == torch.float64 and float(got) == want
    # the fast roles share one whole copy of L, apart from the events
    mixed = 0 < len(where.slow) < 3
    assert log.moved("L", "in", apart=True) == ([L.nbytes()] if mixed else [])
    events = _masked_events(L, plan, caps.c_pad)
    for operand, role in (("A", "A"), ("B", "B"), ("C", "C"), ("M", "C")):
        for direction in ("in", "out"):
            want_bytes = ([b for o, d, b in events if o == operand and d == direction]
                          if getattr(where, role) == "slow" else [])
            assert log.moved(operand, direction) == want_bytes, (operand, direction)
    for ring in log.rings:
        assert check_ring_structure(ring.ops, ring.total, ring.n_fields) == []
        assert ring.n_fields == (2 if ring.operand == "M" else 3)
    # the placed masked executor against the all-fast one and the reference
    spec = backend_registry.get("hash")
    C, stats = spec.run_masked_placed(L, L, L, plan, caps.c_pad, caps, where,
                                      torch.device("cpu"))
    C_fast, stats_fast = _all_fast(name, algorithm)
    for f in ("indptr", "indices", "data"):
        assert torch.equal(getattr(C, f), getattr(C_fast, f)), f
    assert stats == stats_fast
    assert stats.per_copy_in == tuple(ref_stats.per_copy_in)
    assert stats.per_copy_out == tuple(ref_stats.per_copy_out)
    assert (stats.n_ac, stats.n_b, stats.kernel_calls) == (
        ref_stats.n_ac, ref_stats.n_b, ref_stats.kernel_calls)


def test_placement_of_l_on_the_cpu_and_its_refusals(monkeypatch):
    L = _lower("g500_s7")[1]
    want = float(triangle.count_triangles(L, device="cpu"))
    assert float(triangle.count_triangles(L, placement=DP, device="cpu")) == want
    assert float(triangle.count_triangles(L, placement=ALL_FAST, device="cpu")) == want
    # the run device defaults to the card, where an L in pageable host
    # memory raises naming place, as chunked_spgemm's operands do
    for device in ("cuda", None):
        with pytest.raises(ValueError, match=r"place\(L, 'fast'\)"):
            triangle.count_triangles(L, device=device)
    assert triangle._resolve(L, None, "cpu") == (ALL_FAST, torch.device("cpu"))
    assert triangle._resolve(L, DP, "cpu") == (DP, torch.device("cpu"))
    # a pinned L runs on the card by default (here, where there is none, it raises)
    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self, *a, **k: True)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        triangle._resolve(L, None, None)
