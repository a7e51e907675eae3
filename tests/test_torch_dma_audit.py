"""The copy ring's schedule and its checkers, held to the JAX package's.

``repro_torch.kernels.dma_schedule`` against ``repro.kernels.dma_schedule``
step by step; ``simulate_schedule`` against the reference's on the two-slot
schedule, an aliasing one, a three-slot one and one that never primes
(fixtures rebuilt on each package's ``SlotSchedule``, as
``tests/test_static_audit.py`` builds them); ``explore`` against the
reference's counterexamples (hazard and shortest trace) on its programs;
the asynchronous-read model (``async_reads=True``): clean for the two-slot
ring, a counterexample for a ring without its ``release``; a real CPU
ring's log through ``check_ring_structure`` (and a tampered one refused);
and ``audit_all`` running ``dma`` and ``interleave`` clean on the fast
corpus.
"""

import pytest

from repro.analysis import dma as ref_dma
from repro.analysis import interleave as ref_il
from repro.kernels import dma_schedule as ref_sched
from repro_torch.analysis import audit_all
from repro_torch.analysis.dma import check_ring_structure, simulate_schedule
from repro_torch.analysis.interleave import (
    MODELED, Op, build_program, check_interleave, explore,
)
from repro_torch.core import backend_registry, copy_ring
from repro_torch.core.chunking import chunked_spgemm
from repro_torch.core.placement import ALL_SLOW
from repro_torch.kernels import dma_schedule as sched
from test_torch_placement import _port_case


def _fixtures(base):
    """The JAX package's broken schedules, on ``base`` (either package's
    ``SlotSchedule``)."""

    class Aliasing(base):
        def prefetch_slot(self, lin):
            return self.read_slot(lin)

    class ThreeSlot(base):
        n_slots = 3

    class NoPrime(base):
        def is_prime_step(self, lin):
            return False

    return {"two_slot": base(), "aliasing": Aliasing(), "three_slot": ThreeSlot(),
            "no_prime": NoPrime()}


PORT, REF = _fixtures(sched.SlotSchedule), _fixtures(ref_sched.SlotSchedule)


def test_schedule_functions_match_reference():
    assert sched.N_SLOTS == ref_sched.N_SLOTS == sched.TWO_SLOT.n_slots
    assert sched.prime_slot() == ref_sched.prime_slot()
    for lin in range(17):
        for name in ("read_slot", "prefetch_slot", "is_prime_step"):
            assert getattr(sched, name)(lin) == getattr(ref_sched, name)(lin), (name, lin)
        for total in range(17):
            assert sched.has_prefetch(lin, total) == ref_sched.has_prefetch(lin, total)


def test_one_slot_schedule_is_rejected_at_construction():
    class OneSlot(sched.SlotSchedule):
        n_slots = 1

    with pytest.raises(ValueError, match="n_slots >= 2"):
        OneSlot()


@pytest.mark.parametrize("name", sorted(PORT))
def test_simulate_schedule_matches_reference(name):
    for total in range(13):
        got = simulate_schedule(total, PORT[name])
        assert got == ref_dma.simulate_schedule(total, REF[name]), total
        if name in ("two_slot", "three_slot"):
            assert got == []
    assert any("write-after-read race" in v for v in simulate_schedule(6, PORT["aliasing"]))


@pytest.mark.parametrize("n_fields", [1, 3])
@pytest.mark.parametrize("name", sorted(PORT))
def test_explore_matches_reference(name, n_fields):
    n_slots = PORT[name].n_slots
    for total in range(8):
        got = explore(build_program(total, PORT[name], n_fields), n_slots, n_fields)
        want = ref_il.explore(ref_il.build_program(total, REF[name], n_fields),
                              n_slots, n_fields)
        assert (got is None) == (want is None), total
        if got is not None:
            assert got.hazard == want.hazard and got.trace == want.trace
            assert got.describe() == want.describe()
    if name == "aliasing":
        cex = explore(build_program(4, PORT[name]), n_slots=2)
        assert "still in flight" in cex.hazard and len(cex.trace) == 2
    if name == "no_prime":
        assert "deadlock" in explore(build_program(3, PORT[name]), n_slots=2).hazard


@pytest.mark.parametrize("n_fields", [1, 3])
def test_async_reads_two_slot_ring_is_clean(n_fields):
    for total in range(MODELED + 1):
        ops = build_program(total, sched.TWO_SLOT, n_fields, async_reads=True)
        assert sum(op.kind == "release" for op in ops) == total * n_fields
        assert explore(ops, 2, n_fields, async_reads=True) is None
    violations, info = check_interleave(1000, n_fields)
    assert violations == [] and info["ok"] and info["modeled"] == MODELED


def test_async_reads_catch_a_ring_without_release():
    ops = [op for op in build_program(4, sched.TWO_SLOT, 1, async_reads=True)
           if op.kind != "release"]
    # with synchronous reads the same program is clean: only a read that
    # outlives its launch races the copy two steps later
    assert explore(ops, 2, 1) is None
    cex = explore(ops, 2, 1, async_reads=True)
    assert cex is not None
    assert "read of elem 0 is still in flight" in cex.hazard
    assert cex.trace[-1] == "start copy of elem 2 into slot 0 field 0"
    assert len(cex.trace) == 6      # prime, land, prefetch, wait, read, overwrite


def test_async_reads_keep_the_sync_hazards():
    cex = explore(build_program(4, PORT["aliasing"], 1, async_reads=True), 2, 1,
                  async_reads=True)
    assert cex is not None and "still in flight" in cex.hazard
    cex = explore(build_program(3, PORT["no_prime"], 1, async_reads=True), 2, 1,
                  async_reads=True)
    assert cex is not None and "deadlock" in cex.hazard


@pytest.mark.parametrize("algorithm", ["knl", "chunk1", "chunk2"])
def test_cpu_ring_log_passes_ring_structure(algorithm):
    pA, pB, plan = _port_case("duplicate_heavy", algorithm)
    with copy_ring.RingLog() as log:
        chunked_spgemm(pA, pB, plan, backend="hash", placement=ALL_SLOW, device="cpu")
    assert log.rings
    for ring in log.rings:
        assert ring.n_fields == 3
        assert check_ring_structure(ring.ops, ring.total, 3) == []
        assert simulate_schedule(ring.total) == []
        assert len(log.moved(ring.operand, "in")) == ring.total
        # tampered logs are refused: a dropped release, a swapped slot
        dropped = [op for op in ring.ops if op != ("release", 0, 0, 0)]
        assert check_ring_structure(dropped, ring.total, 3)
        swapped = [(k, 1 - s, f, e) if (k, e) == ("read", 0) else (k, s, f, e)
                   for k, s, f, e in ring.ops]
        assert check_ring_structure(swapped, ring.total, 3)
        assert check_ring_structure([Op(*op) for op in ring.ops], ring.total, 3) == []


def test_ring_structure_flags_a_twice_copied_element():
    log = build_program(3, sched.TWO_SLOT, 1, async_reads=True)
    twice = log + [Op("start", 0, 0, 1)]
    violations = check_ring_structure(twice, 3, 1)
    assert any("copied more than once" in v for v in violations)


def test_audit_all_runs_dma_and_interleave_clean():
    rep = audit_all(cases="fast", analyses=["dma", "interleave"], device="cpu")
    assert rep["ok"], rep["violations"][:3]
    assert rep["analyses"] == ["dma", "interleave"]
    # every audited backend has a ring (loop has no audit_trace: skipped)
    audited = [s.name for s in backend_registry.specs() if s.supports_audit]
    assert {r["backend"] for r in rep["records"]} == set(audited)
    assert len(rep["records"]) == len(audited) * 3 * 3
    for r in rep["records"]:
        for analysis in ("dma", "interleave"):
            assert r[analysis]["checked"] and r[analysis]["rings"]
            operands = {g["operand"] for g in r[analysis]["rings"]}
            # Algorithm 1 under scan counts B's chunks only: A crosses whole
            assert operands >= ({"B"} if (r["backend"], r["algorithm"]) == ("scan", "knl")
                                else {"A", "B"})

