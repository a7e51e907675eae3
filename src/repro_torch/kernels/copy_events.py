"""Copy events of the streamed kernels, recorded by their plain versions.

The paper's cost model is a stream of copy events: a piece staged into fast
memory, a result written back to slow memory. The executors report that
stream as ``ChunkStats`` and the planner prices plans from the same
arithmetic; the static auditor (``repro_torch.analysis.traffic``) holds both
to what the kernels move. While a :class:`CopyEvents` block is active, the
plain versions of the four streamed kernels (``ranged_spgemm``,
``sparse_accum_spgemm``, ``hash_accum_spgemm``, ``bsr_spgemm``) record one
event at each stage-in and write-back of their launch, in the kernel's grid
order: per launch, per operand in the kernel's operand order (stationary
piece, streamed piece, C_prev; C_out), the bytes of each copy. CSR operands
record their three fields (indptr, indices, data) as three operands.

Off by default: with no active block every hook returns at once.
"""

from __future__ import annotations

import dataclasses

import torch

_ACTIVE = None   # the active CopyEvents, if any


@dataclasses.dataclass
class Launch:
    """The copy events of one kernel call: ``inputs`` and ``outputs`` are
    ``[(label, [bytes, ...]), ...]`` in operand order; ``workspace`` the
    largest per-step workspace the kernel holds beside its operands."""

    kernel: str
    inputs: list
    outputs: list
    workspace: float = 0.0


class CopyEvents:
    """Context manager that records the launches of the streamed kernels'
    plain versions made inside it (``launches``, in call order)."""

    def __init__(self):
        self.launches: list = []

    def __enter__(self):
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("copy events are already being recorded")
        _ACTIVE = self
        return self

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        _ACTIVE = None


def active() -> bool:
    return _ACTIVE is not None


def _nbytes(t: torch.Tensor) -> float:
    return float(t.numel() * t.element_size())


def begin(kernel: str, inputs, outputs) -> Launch | None:
    """Open one launch's record with its operands' labels; None when off."""
    if _ACTIVE is None:
        return None
    rec = Launch(kernel, [(label, []) for label in inputs],
                 [(label, []) for label in outputs])
    _ACTIVE.launches.append(rec)
    return rec


def _fields(prefix: str) -> tuple:
    return tuple(f"{prefix}.{f}" for f in ("indptr", "indices", "data"))


def _csr_fields(st, lead: tuple) -> list:
    """Bytes of the (indptr, indices, data) of one element of a stacked CSR."""
    return [_nbytes(getattr(st, f)[lead]) for f in ("indptr", "indices", "data")]


def record_dense_stream(a_dense, b_slabs, c0, order: str) -> None:
    """The dense-slab kernel's copies over its ``(batch, n_ac, n_b)`` grid:
    chunk1 stages a strip and its C_prev block once a strip and a slab every
    step, writing the strip's C back after its last chunk; chunk2 keeps
    every strip's C resident (one C_prev fetch, one write-back a batch),
    stages a slab once a chunk and a strip every step."""
    rec = begin("ranged_spgemm", ("stationary", "streamed", "c_prev"), ("c_out",))
    if rec is None:
        return
    batch, n_ac = a_dense.shape[:2]
    n_b = b_slabs.shape[1]
    (_, stat), (_, stream), (_, c_prev) = rec.inputs
    c_out = rec.outputs[0][1]
    for b in range(batch):
        if order == "chunk1":
            for i in range(n_ac):
                stat.append(_nbytes(a_dense[b, i]))
                c_prev.append(_nbytes(c0[b, i]))
                stream.extend(_nbytes(b_slabs[b, j]) for j in range(n_b))
                c_out.append(_nbytes(c0[b, i]))
        else:
            c_prev.append(_nbytes(c0[b]))
            for j in range(n_b):
                stat.append(_nbytes(b_slabs[b, j]))
                stream.extend(_nbytes(a_dense[b, i]) for i in range(n_ac))
            c_out.append(_nbytes(c0[b]))


def record_csr_stream(kernel: str, Ast, Bst, C0st, order: str, workspace: float) -> None:
    """A CSR-output kernel's copies (``csr_accum.cuh``'s schedule): each CSR
    piece as its three fields; chunk1 stages a strip and its C_prev once a
    strip and a chunk every step, writing the strip back after its last
    chunk; chunk2 keeps every strip's accumulator resident (one C_prev fetch
    and one write-back of all strips a batch), staging a chunk once a chunk
    and a strip every step. ``workspace`` is the kernel's largest step
    workspace."""
    rec = begin(kernel, (*_fields("stationary"), *_fields("streamed"), *_fields("c_prev")),
                _fields("c_out"))
    if rec is None:
        return
    rec.workspace = float(workspace)
    batch, n_ac = Ast.indptr.shape[:2]
    n_b = Bst.indptr.shape[1]
    ins = [events for _, events in rec.inputs]
    stat, stream, c_prev = ins[0:3], ins[3:6], ins[6:9]
    c_out = [events for _, events in rec.outputs]

    def add(events, sizes):
        for ev, size in zip(events, sizes):
            ev.append(size)

    for b in range(batch):
        if order == "chunk1":
            for i in range(n_ac):
                add(stat, _csr_fields(Ast, (b, i)))
                add(c_prev, _csr_fields(C0st, (b, i)))
                for j in range(n_b):
                    add(stream, _csr_fields(Bst, (b, j)))
                add(c_out, _csr_fields(C0st, (b, i)))
        else:
            add(c_prev, _csr_fields(C0st, (b,)))
            for j in range(n_b):
                add(stat, _csr_fields(Bst, (b, j)))
                for i in range(n_ac):
                    add(stream, _csr_fields(Ast, (b, i)))
            add(c_out, _csr_fields(C0st, (b,)))


def record_bsr(a_blocks, b_blocks, a_slots, b_slots, workspace: float) -> None:
    """The BSR x BSR kernel's copies over its ``(nc_pad, u_max)`` grid in
    row-major order: a block of A (of B) is fetched wherever the step's slot
    differs from the previous step's (a resident block is reused), and each
    C block is written back once."""
    rec = begin("bsr_spgemm", ("a_blocks", "b_blocks"), ("c_blocks",))
    if rec is None:
        return
    rec.workspace = float(workspace)
    for (_, events), blocks, slots in zip(rec.inputs, (a_blocks, b_blocks),
                                          (a_slots, b_slots)):
        block = _nbytes(blocks[0])
        prev = None
        for v in torch.as_tensor(slots).reshape(-1).tolist():
            if v != prev:
                events.append(block)
            prev = v
    rec.outputs[0][1].extend([float(a_blocks[0].numel() * 4)] * int(a_slots.shape[0]))
