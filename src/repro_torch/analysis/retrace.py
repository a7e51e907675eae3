"""Retrace detector: same envelope, same static geometry — or a value leaked.

A :class:`~repro_torch.sparse.csr.GeometryEnvelope` is the compile key: two
instances staged to one envelope must give one static geometry of a backend
core (``chunk_stream._Core.geometry``: the operands' shapes, dtypes and CSR
metadata, and the keyword statics), otherwise some Python value derived
from the instance *data* (an nnz count, a float, a host-computed table
size) leaked into the key, and a core (a serving bucket's) would count a
second compile for what should be one.

The staging contract is the spec's ``audit_trace``: both instances are
staged at the *shared* envelope (exactly what the batched executors do), so
any shape or dtype difference is itself a staging bug and reported as such
before the geometry diff runs. Then both run through one fresh core, which
must count one compile, not two.
"""

from __future__ import annotations

import collections
import itertools

import torch

from repro_torch.analysis.traffic import fresh_fn
from repro_torch.sparse.csr import CSR


def trace_text(target) -> str:
    """Canonical text of one TraceTarget's static geometry: the core's key,
    one line per operand signature, one line per static."""
    core, statics = target.fn.func, target.fn.keywords
    signature, items = core.geometry(*target.args, **statics)
    lines = [f"core {core.key}"]
    lines += [f"arg{i}: {sig!r}" for i, sig in enumerate(signature)]
    lines += [f"static {k} = {v!r}" for k, v in items]
    return "\n".join(lines)


def _avals(value):
    """Shapes and dtypes of a staged operand tree (what the staging fixes)."""
    if isinstance(value, CSR):
        return tuple(_avals(getattr(value, f)) for f in ("indptr", "indices", "data"))
    if isinstance(value, (list, tuple)):
        return tuple(_avals(v) for v in value)
    shape = getattr(value, "shape", ())
    return (tuple(shape), str(getattr(value, "dtype", "")))


def diff_summary(text_a: str, text_b: str, context: int = 2,
                 max_lines: int = 12) -> list:
    """First divergence between two geometry texts, a few lines of context."""
    lines_a, lines_b = text_a.splitlines(), text_b.splitlines()
    for ix, (la, lb) in enumerate(itertools.zip_longest(lines_a, lines_b)):
        if la != lb:
            lo = max(0, ix - context)
            out = [f"first divergence at geometry line {ix + 1}:"]
            for j in range(lo, min(ix + context + 1, max(len(lines_a), len(lines_b)))):
                a = lines_a[j] if j < len(lines_a) else "<absent>"
                b = lines_b[j] if j < len(lines_b) else "<absent>"
                marker = ">>" if j == ix else "  "
                out.append(f"{marker} A| {a.strip()}")
                out.append(f"{marker} B| {b.strip()}")
                if len(out) >= max_lines:
                    break
            return out
    return []


def check_retrace(target_a, target_b) -> list:
    """Violations if two same-envelope TraceTargets diverge: staged shapes
    first (a staging bug masquerades as a leak), then the static-geometry
    texts; then both run through one fresh core, which must count one
    compile."""
    shapes_a, shapes_b = _avals(target_a.args), _avals(target_b.args)
    if shapes_a != shapes_b:
        return ["staged operand avals differ between same-envelope "
                f"instances: {shapes_a} vs {shapes_b} — envelope-driven "
                "staging is broken for this backend"]
    text_a, text_b = trace_text(target_a), trace_text(target_b)
    if text_a != text_b:
        detail = "; ".join(diff_summary(text_a, text_b))
        return ["same-envelope instances stage to different static geometries — a "
                "Python value from the instance data leaked into the compile "
                f"key ({detail})"]
    counts = collections.Counter()
    fn = fresh_fn(target_a, counts)
    with torch.no_grad():
        fn(*target_a.args)
        fn(*target_b.args)
    key = target_a.fn.func.key
    if counts[key] != 1:
        return [f"same-envelope instances counted {counts[key]} compiles of core "
                f"{key!r} through one core, not 1"]
    return []
