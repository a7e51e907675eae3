"""Interleaving model checker: prove the copy ring safe under *every*
completion order of its asynchronous operations.

``analysis/dma.py`` replays one linear order of the slot schedule, copies
completing exactly when waited on. Real copies are asynchronous: a started
copy may land at any later point, and the schedule is only correct if
**no** completion order can make a step read a slot before its copy has
landed or let a new copy overwrite a slot that is still in flight. This
module checks that exhaustively:

* the program (:func:`build_program`) is the per-step op sequence, prime
  ``start``, prefetch ``start``, ``wait``, ``read``, emitted from the same
  :class:`~repro_torch.kernels.dma_schedule.SlotSchedule` arithmetic the
  ring calls, once per streamed element and once per field (a CSR piece is
  three);
* :func:`explore` walks every interleaving consistent with that program
  order: from each state either the next program op executes (if enabled)
  or any in-flight copy completes. States are memoized, and the two-slot
  schedule keeps the reachable set tiny;
* hazards surface as a **minimal counterexample**: the search is
  breadth-first over transitions, so the first violation found is a
  shortest event trace.

Hazards checked: a ``start`` into a slot/field with a copy still in flight
(overwrite-in-flight), a ``read`` of a slot/field with a copy still in
flight (read-before-landing), a ``read`` observing the wrong element (stale
contents), and a ``wait`` no pending copy can ever satisfy (deadlock).

``async_reads=True`` models the ring on the card, where a read is a kernel
that ends after it is launched: a ``read`` completes at any later point,
each step's ``release`` records that the slot may be reused once its read
has completed, and a ``start`` into a slot waits for that release. This
adds one hazard, a copy into a slot whose read is still in flight with no
release to wait on. On the JAX package's programs (synchronous reads, no
releases) :func:`explore` returns the JAX package's result, hazard and
trace.
"""

from __future__ import annotations

import collections
import dataclasses

from repro_torch.kernels.dma_schedule import TWO_SLOT

# the modeled stream: the schedule is periodic in the slot count, so a
# hazard reachable at all is reachable within a few periods; 6 elements are
# three two-slot periods
MODELED = 6


@dataclasses.dataclass(frozen=True)
class Op:
    """One program event. ``kind`` in {"start", "wait", "read",
    "release"}; ``slot`` and ``field`` address the buffer cell; ``elem`` is
    the streamed element the op moves or consumes (for ``wait`` the element
    the schedule believes the signal belongs to)."""

    kind: str
    slot: int
    field: int
    elem: int

    def describe(self) -> str:
        if self.kind == "release":
            return (f"release slot {self.slot} field {self.field} after "
                    f"reading elem {self.elem}")
        verb = {"start": "start copy of elem",
                "wait": "wait on sem for elem",
                "read": "read elem"}[self.kind]
        return (f"{verb} {self.elem} "
                f"{'into' if self.kind == 'start' else 'from'} "
                f"slot {self.slot} field {self.field}")


def build_program(total: int, schedule=TWO_SLOT, n_fields: int = 1,
                  async_reads: bool = False) -> list:
    """The op sequence of ``total`` elements under ``schedule``: prime start
    (step 0 only), prefetch start, wait, read, each replicated per field,
    and with ``async_reads`` the step's release after its read."""
    ops = []
    for lin in range(total):
        if schedule.is_prime_step(lin):
            for f in range(n_fields):
                ops.append(Op("start", int(schedule.prime_slot()), f, lin))
        if schedule.has_prefetch(lin, total):
            for f in range(n_fields):
                ops.append(
                    Op("start", int(schedule.prefetch_slot(lin)), f, lin + 1))
        rs = int(schedule.read_slot(lin))
        for f in range(n_fields):
            ops.append(Op("wait", rs, f, lin))
        for f in range(n_fields):
            ops.append(Op("read", rs, f, lin))
        if async_reads:
            for f in range(n_fields):
                ops.append(Op("release", rs, f, lin))
    return ops


@dataclasses.dataclass(frozen=True)
class Counterexample:
    """A violating interleaving: the hazard, plus the shortest event trace
    reaching it (program ops interleaved with ``complete ...`` events)."""

    hazard: str
    trace: tuple

    def describe(self) -> str:
        lines = [f"hazard: {self.hazard}", "shortest interleaving:"]
        lines += [f"  {i + 1}. {step}" for i, step in enumerate(self.trace)]
        return "\n".join(lines)


def _trace_back(parents, state, last_step):
    steps = [last_step]
    while state is not None:
        prev, step = parents[state]
        if step is not None:
            steps.append(step)
        state = prev
    return tuple(reversed(steps))


def explore(ops, n_slots: int, n_fields: int = 1, max_states: int = 200_000,
            async_reads: bool = False) -> Counterexample | None:
    """Exhaustive interleaving search. Returns ``None`` when every
    completion order is hazard-free, else the shortest counterexample.

    State: ``(pc, in_flight, contents, sems)``, and with ``async_reads``
    also the reads in flight and those among them whose release was
    recorded. ``in_flight`` is the set of started-but-unlanded copies
    ``(slot, field, elem)``, ``contents`` maps each cell to the element it
    holds (-1 = garbage), and ``sems`` counts unconsumed completion signals
    per cell. Transitions: complete any in-flight copy (land its element,
    bump the cell's semaphore), complete any in-flight read, or execute
    ``ops[pc]`` when enabled (``wait`` needs a signal; with ``async_reads``
    a ``start`` into a cell whose read is in flight waits for that read's
    release). Breadth-first search with memoization makes the first hazard
    found minimal.
    """
    empty = tuple(-1 for _ in range(n_slots * n_fields))
    zeros = tuple(0 for _ in range(n_slots * n_fields))
    init = (0, frozenset(), empty, zeros)
    if async_reads:
        init += (frozenset(), frozenset())
    parents = {init: (None, None)}
    queue = collections.deque([init])
    cell = lambda s, f: s * n_fields + f  # noqa: E731
    while queue:
        if len(parents) > max_states:
            raise RuntimeError(
                f"interleaving state space exceeded {max_states} states — "
                "not a two-slot-shaped schedule")
        state = queue.popleft()
        pc, in_flight, contents, sems = state[:4]
        rest = state[4:]

        def push(nxt, step):
            if nxt not in parents:
                parents[nxt] = (state, step)
                queue.append(nxt)

        # transition family 1: any in-flight copy lands
        for copy in in_flight:
            slot, field, elem = copy
            c = cell(slot, field)
            push((pc, in_flight - {copy},
                  tuple(elem if i == c else v for i, v in enumerate(contents)),
                  tuple(s + 1 if i == c else s for i, s in enumerate(sems)),
                  *rest),
                 f"complete copy of elem {elem} into slot {slot} field {field}")
        if async_reads:
            reading, released = rest
            # any in-flight read ends (its kernel finishes)
            for rd in sorted(reading):
                push((pc, in_flight, contents, sems, reading - {rd},
                      released - {rd}),
                     f"complete read of elem {rd[2]} from slot {rd[0]} field {rd[1]}")
        if pc >= len(ops):
            continue
        # transition family 2: the next program op executes
        op = ops[pc]
        c = cell(op.slot, op.field)
        here = {cp for cp in in_flight if cp[0] == op.slot and cp[1] == op.field}
        if op.kind == "start":
            if here:
                victim = sorted(here)[0]
                return Counterexample(
                    f"{op.describe()} overwrites slot {op.slot} field "
                    f"{op.field} while the copy of elem {victim[2]} is "
                    "still in flight",
                    _trace_back(parents, state, op.describe()))
            if async_reads:
                busy = {rd for rd in rest[0] if rd[:2] == (op.slot, op.field)}
                unreleased = busy - rest[1]
                if unreleased:
                    victim = sorted(unreleased)[0]
                    return Counterexample(
                        f"{op.describe()} overwrites slot {op.slot} field "
                        f"{op.field} while the read of elem {victim[2]} is still "
                        "in flight, with no release to wait on",
                        _trace_back(parents, state, op.describe()))
                if busy:
                    continue  # the copy waits for the release; reads move it on
            nxt = (pc + 1, in_flight | {(op.slot, op.field, op.elem)},
                   contents, sems, *rest)
        elif op.kind == "wait":
            if sems[c] == 0:
                if not here:
                    return Counterexample(
                        f"{op.describe()} can never be satisfied: no copy "
                        f"to slot {op.slot} field {op.field} is in flight "
                        "and its semaphore is zero (deadlock)",
                        _trace_back(parents, state, op.describe()))
                continue  # blocked; only completions can move this state on
            nxt = (pc + 1, in_flight, contents,
                   tuple(s - 1 if i == c else s for i, s in enumerate(sems)), *rest)
        elif op.kind == "read":
            if here:
                victim = sorted(here)[0]
                return Counterexample(
                    f"{op.describe()} races the in-flight copy of elem "
                    f"{victim[2]} into the same slot",
                    _trace_back(parents, state, op.describe()))
            if contents[c] != op.elem:
                seen = ("garbage (never written)" if contents[c] == -1
                        else f"elem {contents[c]}")
                return Counterexample(
                    f"{op.describe()} observes {seen} — stale slot contents",
                    _trace_back(parents, state, op.describe()))
            if async_reads:
                rest = (rest[0] | {(op.slot, op.field, op.elem)}, rest[1])
            nxt = (pc + 1, in_flight, contents, sems, *rest)
        else:  # release: the slot may be reused once this read has ended
            rd = (op.slot, op.field, op.elem)
            released = rest[1] | {rd} if rd in rest[0] else rest[1]
            nxt = (pc + 1, in_flight, contents, sems, rest[0], released)
        push(nxt, op.describe())
    return None


def check_interleave(total: int, n_fields: int, schedule=TWO_SLOT) -> tuple:
    """Model-check one ring of ``total`` elements of ``n_fields`` fields
    (3 for a CSR piece) under ``schedule``, reads asynchronous as on the
    card. Returns ``(violations, info)``: each violation a formatted minimal
    counterexample."""
    modeled = min(total, MODELED)
    ops = build_program(modeled, schedule, n_fields, async_reads=True)
    cex = explore(ops, int(schedule.n_slots), n_fields, async_reads=True)
    info = {"checked": True, "total": total, "modeled": modeled,
            "n_fields": n_fields, "ok": cex is None}
    return ([] if cex is None else [cex.describe()]), info
