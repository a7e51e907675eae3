"""Copy-ring checker: proves the two-slot copy2Fast schedule race-free and
holds a ring's recorded op log to it.

Two passes:

**Host simulation** (:func:`simulate_schedule`) replays the slot
arithmetic of ``repro_torch.kernels.dma_schedule``, the module the ring
itself calls, over every step of a stream and asserts the pipeline
invariants concretely: the step-``j`` prefetch of element ``j+1`` never
targets the slot step ``j`` is reading, a slot is never overwritten before
its element was consumed, every read consumes a copy that was started and
waited on, and every element is copied and read exactly once. Because the
ring takes its slot indices from the same functions, simulating the module
is simulating the ring.

**Ring structure** (:func:`check_ring_structure`) is what the JAX
package's jaxpr walk (``check_dma_structure``) checks of its kernels,
checked here of what the ring really issued: its log, op for op, against
the program :func:`repro_torch.analysis.interleave.build_program` emits for
the same schedule with asynchronous reads (prime and prefetch starts, the
wait, the read and the release of every element, once per field), with
every element copied once and read once.

**Probe bounds** (:func:`check_while_bounds`) is the JAX package's pass of
the same name, which holds every hash probe loop in the traced core to the
planner's bound. The CUDA hash kernel takes its table size as a launch
argument and a probe visits at most that many slots
(``csrc/hash_accum_spgemm.cu``), so the bound of a launch is
``probe_step_bound`` of the table it was given: the pass reads those sizes
from the launches themselves (``hash_accum_spgemm.TableLog``) and holds
each to ``probe_step_bound(hash_table_slots(...))`` of the audited
envelope.
"""

from __future__ import annotations

from repro_torch.kernels.dma_schedule import TWO_SLOT
from repro_torch.kernels.hash_accum_spgemm import probe_step_bound


def simulate_schedule(total: int, schedule=TWO_SLOT) -> list:
    """Replay the double-buffer schedule over ``total`` steps.

    Returns a list of violation strings (empty = race-free). ``schedule`` is
    any object with the :class:`repro_torch.kernels.dma_schedule.SlotSchedule`
    surface: the ring's ``TWO_SLOT`` by default, or a deliberately broken
    one.
    """
    violations = []
    # per-slot state: (element, waited, consumed) or None (never written)
    slots = [None] * schedule.n_slots
    copied = set()
    read = set()

    def start(step, elem, slot, what):
        if not 0 <= slot < schedule.n_slots:
            violations.append(
                f"step {step}: {what} targets slot {slot} outside the "
                f"{schedule.n_slots}-slot buffer")
            return
        state = slots[slot]
        if state is not None and not state[2]:
            violations.append(
                f"step {step}: {what} of element {elem} overwrites slot "
                f"{slot} holding unconsumed element {state[0]}")
        if elem in copied:
            violations.append(
                f"step {step}: element {elem} copied twice")
        copied.add(elem)
        slots[slot] = (elem, False, False)

    for lin in range(total):
        if schedule.is_prime_step(lin):
            start(lin, 0, schedule.prime_slot(), "warm-up copy")
        if schedule.has_prefetch(lin, total):
            pslot = schedule.prefetch_slot(lin)
            if pslot == schedule.read_slot(lin):
                violations.append(
                    f"step {lin}: prefetch of element {lin + 1} targets "
                    f"slot {pslot}, the slot this step reads — "
                    "write-after-read race")
            start(lin, lin + 1, pslot, "prefetch")
        rslot = schedule.read_slot(lin)
        if not 0 <= rslot < schedule.n_slots or slots[rslot] is None:
            violations.append(
                f"step {lin}: reads slot {rslot}, which holds no element")
            continue
        elem, _, consumed = slots[rslot]
        if elem != lin:
            violations.append(
                f"step {lin}: reads slot {rslot} holding element {elem}, "
                f"expected element {lin}")
        if consumed:
            violations.append(
                f"step {lin}: re-reads already-consumed element {elem}")
        # the ring waits on exactly the slot it reads, every step
        slots[rslot] = (elem, True, True)
        read.add(elem)

    missing = set(range(total)) - read
    if missing:
        violations.append(
            f"elements never streamed: {sorted(missing)[:8]}"
            f"{'...' if len(missing) > 8 else ''}")
    return violations


def check_ring_structure(log, total: int, n_fields: int,
                         schedule=TWO_SLOT) -> list:
    """A ring's recorded ops (``(kind, slot, field, elem)`` tuples or
    :class:`~repro_torch.analysis.interleave.Op` s, in issue order) against
    the program of ``total`` elements of ``n_fields`` fields under
    ``schedule`` with asynchronous reads. Returns violation strings."""
    from repro_torch.analysis.interleave import Op, build_program

    got = [op if isinstance(op, Op) else Op(*op) for op in log]
    want = build_program(total, schedule, n_fields, async_reads=True)
    violations = []
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            violations.append(
                f"op {i}: the ring issued '{g.kind} slot {g.slot} field {g.field} "
                f"elem {g.elem}', the schedule's program '{w.kind} slot {w.slot} "
                f"field {w.field} elem {w.elem}'")
            break
    if len(got) != len(want):
        violations.append(f"the ring issued {len(got)} ops, the schedule's "
                          f"program {len(want)}")
    for kind, verb in (("start", "copied"), ("read", "read")):
        per = {}
        for op in got:
            if op.kind == kind:
                per[(op.elem, op.field)] = per.get((op.elem, op.field), 0) + 1
        twice = sorted(k for k, n in per.items() if n > 1)
        missing = sorted({(e, f) for e in range(total) for f in range(n_fields)}
                         - set(per))
        if twice:
            violations.append(f"(element, field) {twice[:4]} {verb} more than once")
        if missing:
            violations.append(f"(element, field) {missing[:4]} never {verb}")
    return violations


def check_while_bounds(tables, *, expected_bound: int | None = None) -> list:
    """The probe loops of every recorded hash launch (``tables``: the table
    size each was given, ``hash_accum_spgemm.TableLog``) must carry a
    derivable step bound, a table of at least one slot; with
    ``expected_bound`` (the hash backend:
    ``probe_step_bound(hash_table_slots(...))`` of the audited envelope)
    that bound must be every launch's. Returns violation strings."""
    violations = []
    for ix, table in enumerate(tables):
        if int(table) < 1:
            violations.append(
                f"hash launch #{ix}: a table of {table} slots gives no step bound — "
                "bound not derivable, loop may not terminate")
            continue
        bound = probe_step_bound(table)
        if expected_bound is not None and bound != expected_bound:
            violations.append(
                f"hash launch #{ix}: probe bound {bound} (a table of {table} slots) is "
                f"not the planner-derived bound {expected_bound} "
                "(probe_step_bound of hash_table_slots)")
    if expected_bound is not None and not tables:
        violations.append(
            "no hash launch found, but the backend's probe loops were expected "
            "(hash kernel)")
    return violations
