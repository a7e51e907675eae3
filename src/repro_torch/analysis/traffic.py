"""Copy-event flow equality: the copies a staged launch makes must equal
the backend's declared per-copy event model **exactly** — not dominate it.

The paper's cost model is a stream of ``copy2Fast``/``copy2Slow`` events;
the executors report that stream as :class:`~repro_torch.core.chunking.ChunkStats`
and the planner prices plans from the same arithmetic. This pass ties those
host-side models to the bytes the staged launches move, in three layers:

1. **Recorded flows** (:func:`traced_flows`): the spec's ``audit_trace``
   target runs its core once on the CPU under
   :class:`~repro_torch.kernels.copy_events.CopyEvents`, and the plain
   version of each streamed kernel it calls records, per operand in the
   kernel's operand order, the byte size of every stage-in and write-back
   in the kernel's grid order (the port has no jaxpr to walk: the recorded
   launch is its trace).
2. **Flow equality** (:func:`check_traffic`): the recorded flows must equal
   the spec's :class:`~repro_torch.core.backend_registry.ExpectedTraffic`
   operand for operand and event for event; any divergence gives a
   per-event diff naming the operand, the event index, and both byte
   streams.
3. **Stats tie**: same-key expected flows merge event-wise (the three CSR
   field operands of one logical staging sum into the single event the
   executors log) and the merged multiset must equal the
   ``ChunkStats.per_copy_in/out`` the backend reports. A spec may declare a
   documented ``stats_exempt`` reason (the BSR executor's per-pair host
   staging) — recorded, not flagged.
"""

from __future__ import annotations

import collections
import functools

import torch

from repro_torch.kernels import copy_events
from repro_torch.sparse.csr import CSR


def to_cpu(value):
    """A staged operand (CSR, tensor, or a list or tuple of them) on the CPU."""
    if isinstance(value, CSR):
        return CSR(value.indptr.cpu(), value.indices.cpu(), value.data.cpu(),
                   value.shape, value.max_row_nnz)
    if isinstance(value, torch.Tensor):
        return value.cpu()
    if isinstance(value, (list, tuple)):
        return type(value)(to_cpu(v) for v in value)
    return value


def fresh_fn(target, counts=None):
    """The target's core with an empty record counting into ``counts`` (a
    private counter by default), its statics bound: running it leaves the
    module-level cores and ``TRACE_COUNTS`` as they were."""
    fn = target.fn
    core = fn.func.fresh(collections.Counter() if counts is None else counts)
    return functools.partial(core, **fn.keywords)


def traced_flows(target) -> list:
    """Run the target's core once on CPU copies of its operands (the
    kernels' plain versions) and return the recorded launches
    (:class:`~repro_torch.kernels.copy_events.Launch`), in call order."""
    fn, args = fresh_fn(target), to_cpu(target.args)
    with copy_events.CopyEvents() as rec:
        fn(*args)
    return rec.launches


def _fmt_events(events, limit: int = 6) -> str:
    shown = ", ".join(f"{e:.0f}" for e in events[:limit])
    more = f", ...({len(events)} total)" if len(events) > limit else ""
    return f"[{shown}{more}]"


def _diff_flow(direction: str, op, label: str, events: tuple) -> str | None:
    """One per-event diff line, or None when the flows match exactly."""
    expected = tuple(float(e) for e in op.events)
    if events == expected:
        return None
    head = (f"{direction} operand {label} (model key {op.key!r}): traced "
            f"{len(events)} copy events {_fmt_events(events)} vs model "
            f"{len(expected)} events {_fmt_events(expected)}")
    for ix, (t, e) in enumerate(zip(events, expected)):
        if t != e:
            return (f"{head}; first divergence at event {ix}: traced "
                    f"{t:.0f} B vs model {e:.0f} B")
    return f"{head}; streams agree up to the shorter length"


def _merged_events(ops) -> tuple:
    """Same-key flows merged event-wise: the k-th event of every operand
    sharing a key sums into one k-th merged event (three CSR fields staging
    together are one ChunkStats copy)."""
    merged, order, errors = {}, [], []
    for op in ops:
        if op.key not in merged:
            merged[op.key] = [float(e) for e in op.events]
            order.append(op.key)
        else:
            cur = merged[op.key]
            if len(cur) != len(op.events):
                errors.append(
                    f"model flows sharing key {op.key!r} differ in event "
                    f"count ({len(cur)} vs {len(op.events)}) — they cannot "
                    "merge into one ChunkStats event stream")
                continue
            merged[op.key] = [a + float(b) for a, b in zip(cur, op.events)]
    events = [e for key in order for e in merged[key]]
    return events, errors


def _diff_multiset(direction: str, merged: list, stats: tuple) -> list:
    got = collections.Counter(round(e, 6) for e in merged)
    want = collections.Counter(round(float(e), 6) for e in stats)
    if got == want:
        return []
    missing = sorted((want - got).elements())
    extra = sorted((got - want).elements())
    return [
        f"{direction} stats tie broken: merged model flow has "
        f"{len(merged)} events summing {sum(merged):.0f} B but the "
        f"executors' ChunkStats log {len(stats)} events summing "
        f"{sum(float(e) for e in stats):.0f} B"
        + (f"; stats events absent from the flow: {_fmt_events(missing)}"
           if missing else "")
        + (f"; flow events absent from the stats: {_fmt_events(extra)}"
           if extra else "")
    ]


def check_traffic(traced, expected) -> tuple:
    """Flow-equality audit of one staged core against its
    :class:`~repro_torch.core.backend_registry.ExpectedTraffic`. ``traced``
    is a TraceTarget (recorded here) or the launches :func:`traced_flows`
    recorded.

    Returns ``(violations, info)``: violation strings (empty = the recorded
    movement equals the model exactly and ties to the reported stats) and a
    JSON-able summary for the report record.
    """
    launches = traced if isinstance(traced, list) else traced_flows(traced)
    violations = []
    info = {"checked": True, "n_launches": len(launches),
            "stats_exempt": expected.stats_exempt}
    if len(launches) != 1:
        violations.append(
            f"traffic model describes one staged launch but the core made "
            f"{len(launches)} kernel launches")
        return violations, info
    (launch,) = launches
    info["kernel"] = launch.kernel
    sides = (("slow->fast", launch.inputs, expected.in_ops),
             ("fast->slow", launch.outputs, expected.out_ops))
    for direction, traced_side, model_side in sides:
        if len(traced_side) != len(model_side):
            violations.append(
                f"{direction}: trace has {len(traced_side)} operands but "
                f"the model declares {len(model_side)}")
            continue
        for (label, events), op in zip(traced_side, model_side):
            diff = _diff_flow(direction, op, label, tuple(events))
            if diff:
                violations.append(diff)
    info["in_bytes"] = sum(e for _, ev in launch.inputs for e in ev)
    info["out_bytes"] = sum(e for _, ev in launch.outputs for e in ev)
    info["in_events"] = sum(len(ev) for _, ev in launch.inputs)
    info["out_events"] = sum(len(ev) for _, ev in launch.outputs)
    if expected.stats_exempt is None:
        for direction, ops, stats in (("slow->fast", expected.in_ops, expected.stats_in),
                                      ("fast->slow", expected.out_ops, expected.stats_out)):
            merged, errors = _merged_events(ops)
            violations.extend(errors)
            violations.extend(_diff_multiset(direction, merged, stats))
    return violations, info
