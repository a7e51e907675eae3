"""The copy2Fast ring: staged pieces of a slow operand crossing onto the card.

A slow operand lives in pinned host memory (``placement.place``). The
executors run one kernel launch per (strip, chunk) step on pieces staged in
device slots, and each piece crosses the link through a two-slot ring that
``repro_torch.kernels.dma_schedule`` drives: step ``lin`` reads slot
``read_slot(lin)`` while the copy of element ``lin + 1`` lands in
``prefetch_slot(lin)``.

A piece is a :class:`CSR` (its three fields), one dense tensor (a slab, a
strip or a C block: one field), or a tuple of tensors such as a BSR piece
``(indptr, indices, blocks)`` (:func:`fields`). A ring streams the elements
of a stack (a piece whose fields carry a leading element axis) or of a list
of pieces; a slot holds the largest element, field by field.

On the card:

* a side copy stream issues ``copy_(non_blocking=True)`` from the pinned
  piece into the slot's device buffers, one per field, then records the
  slot's "copied" event;
* the compute stream waits on that event before the step's kernels read the
  slot;
* after the step's kernels the compute stream records the slot's "released"
  event, and the copy stream waits on it before it overwrites the slot. A
  kernel's reads of the slot end when the kernel does, not when it is
  launched, so this wait is what keeps element ``lin + 2`` out of the slot
  step ``lin`` still reads.

On the CPU the same code runs with host buffers and synchronous copies.

Every ring records its ops in issue order, ``(kind, slot, field, elem)``
with ``kind`` in ``start``, ``wait``, ``read``, ``release``, the program
``repro_torch.analysis.interleave.build_program(..., async_reads=True)``
emits for the same schedule, and every transfer is logged with its operand,
direction and bytes; a whole operand that crosses once, outside the
events its plan counts, is logged apart (``Transfer.apart``). :class:`RingLog`
is the context manager that collects them, in the style of ``chunk_stream.TRACE_COUNTS`` and the kernels'
``LaunchCounter``; with ``timed=True`` it also keeps CUDA events around each
copy and each step's kernels, for the copy and compute times and the share
of copy time spent under compute.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import itertools

import torch

from repro_torch.kernels import dma_schedule
from repro_torch.sparse.csr import CSR

_ACTIVE: list = []     # the RingLogs recording, innermost last


def fields(piece) -> list:
    """The tensors of a piece: a CSR's ``(indptr, indices, data)``, a dense
    tensor alone, or a tuple's items (a BSR piece's ``(indptr, indices,
    blocks)``)."""
    if isinstance(piece, CSR):
        return [piece.indptr, piece.indices, piece.data]
    if isinstance(piece, torch.Tensor):
        return [piece]
    return list(piece)


def rebuild(like, tensors):
    """A piece of ``like``'s kind over ``tensors`` (a CSR keeps ``like``'s
    shape and row bound)."""
    if isinstance(like, CSR):
        return CSR(*tensors, like.shape, like.max_row_nnz)
    if isinstance(like, torch.Tensor):
        return tensors[0]
    return type(like)(*tensors) if hasattr(like, "_fields") else tuple(tensors)


@dataclasses.dataclass
class RingRecord:
    """One ring's log: its ``ops`` in issue order."""

    operand: str          # "A", "B" or "C"
    role: str             # "streamed" (once a step) or "stationary" (once an outer step)
    total: int            # elements the ring streams
    n_fields: int
    ops: list = dataclasses.field(default_factory=list)
    source_pinned: bool | None = None   # on the card: the slow stack is pinned


@dataclasses.dataclass(frozen=True)
class Transfer:
    """One copy across the link: a ring element, a whole block, or (with
    ``apart``) a whole operand crossing outside its plan's events."""

    operand: str
    direction: str        # "in" (host to card) or "out" (card to host)
    nbytes: int
    apart: bool = False


class RingLog:
    """Records the rings and transfers of the executor calls made inside it
    (``rings``, ``transfers``, in issue order), and each call's own apart
    (``calls``: one RingLog a :class:`Link`, in the order the calls
    finished; a two-hop pipeline's hops, each through its ring). With
    ``timed`` (on the card) it keeps CUDA events around every copy and every
    step's kernels; :meth:`times` reads them."""

    def __init__(self, timed: bool = False):
        self.timed = timed
        self.rings: list = []
        self.transfers: list = []
        self.calls: list = []
        self._origin = None
        self._copies: list = []       # (direction, nbytes, start, end)
        self._steps: list = []        # (start, end)

    def __enter__(self):
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)

    def moved(self, operand: str, direction: str, apart: bool = False) -> list:
        """Bytes of each transfer of ``operand`` in ``direction``, in order:
        the plan's events, or with ``apart`` the whole crossings outside
        them."""
        return [t.nbytes for t in self.transfers
                if t.operand == operand and t.direction == direction
                and t.apart == apart]

    def times(self) -> dict:
        """Copy-stream and compute-stream ms (CUDA events), GB/s each way,
        and the share of copy time that ran while a step's kernels ran.
        Synchronizes; empty without ``timed`` events."""
        if not self._copies and not self._steps:
            return {}
        torch.cuda.synchronize()
        at = lambda e: self._origin.elapsed_time(e)  # noqa: E731
        # the steps run one after another on the compute stream: disjoint,
        # so the step time before t is a prefix sum up to the step holding t
        steps = sorted((at(s), at(e)) for s, e in self._steps)
        starts = [s0 for s0, _ in steps]
        before = list(itertools.accumulate((s1 - s0 for s0, s1 in steps), initial=0.0))

        def covered(t: float) -> float:
            k = bisect.bisect_right(starts, t)
            return before[k - 1] + min(t, steps[k - 1][1]) - steps[k - 1][0] if k else 0.0

        copy_ms = {"in": 0.0, "out": 0.0}
        moved = {"in": 0, "out": 0}
        under = 0.0
        for direction, nbytes, s, e in self._copies:
            c0, c1 = at(s), at(e)
            copy_ms[direction] += c1 - c0
            moved[direction] += nbytes
            under += covered(c1) - covered(c0)
        total = copy_ms["in"] + copy_ms["out"]
        rate = lambda d: moved[d] / copy_ms[d] / 1e6 if copy_ms[d] > 0 else None  # noqa: E731
        return {"copy_ms": total, "copy_in_ms": copy_ms["in"],
                "copy_out_ms": copy_ms["out"],
                "compute_ms": sum(e - s for s, e in steps),
                "h2d_gb_s": rate("in"), "d2h_gb_s": rate("out"),
                "copy_under_compute": under / total if total > 0 else None}


def _nbytes(fields) -> int:
    return sum(t.numel() * t.element_size() for t in fields)


class Link:
    """The transfers of one executor call on ``device``: its copy stream,
    its rings, and the whole-block copies of C. :meth:`finish` waits for
    every copy and hands the records to the active :class:`RingLog` s."""

    def __init__(self, device: torch.device):
        self.device = device
        self.card = device.type == "cuda"
        self.rings: list = []
        self.transfers: list = []
        self.logs = list(_ACTIVE)
        self.timed = self.card and any(log.timed for log in self.logs)
        self.stream = torch.cuda.Stream(device) if self.card else None
        self.compute_stream = torch.cuda.current_stream(device) if self.card else None
        self._copies, self._steps = [], []
        self._origin = None
        if self.timed:
            self._origin = self._event()
            self._origin.record(self.compute_stream)

    def _event(self):
        return torch.cuda.Event(enable_timing=self.timed)

    def ring(self, operand: str, role: str, source, elements: list) -> "CopyRing":
        """A ring streaming ``source``'s pieces (a stack or a list of pieces
        in slow memory) in the order ``elements`` (the source piece of each
        step)."""
        ring = CopyRing(self, operand, role, source, elements)
        self.rings.append(ring)
        return ring

    @contextlib.contextmanager
    def copying(self, direction: str, nbytes: int, after=None):
        """The body's copies run on the copy stream (after ``after``, an
        event of the compute stream, on the card), timed when asked."""
        if not self.card:
            yield
            return
        with torch.cuda.stream(self.stream):
            if after is not None:
                self.stream.wait_event(after)
            start = end = None
            if self.timed:
                start, end = self._event(), self._event()
                start.record(self.stream)
            yield
            if self.timed:
                end.record(self.stream)
                self._copies.append((direction, nbytes, start, end))

    @contextlib.contextmanager
    def step(self):
        """One step's kernels on the compute stream, timed when asked."""
        if not self.timed:
            yield
            return
        start, end = self._event(), self._event()
        start.record(self.compute_stream)
        yield
        end.record(self.compute_stream)
        self._steps.append((start, end))

    def copy_in(self, operand: str, source, apart: bool = False):
        """One whole piece of ``operand`` onto the device (one transfer;
        ``apart``: a whole operand crossing outside its plan's events)."""
        return self._copy_in(operand, [source], apart)[0]

    def copy_in_each(self, operand: str, stack) -> list:
        """The elements of ``stack`` onto the device as one transfer, each
        in an allocation of its own, so that each is freed when its last
        user drops it (a Chunk2 C block whose strips are replaced one by
        one)."""
        return self._copy_in(operand, [piece(stack, i)
                                       for i in range(fields(stack)[0].shape[0])])

    def _copy_in(self, operand: str, sources: list, apart: bool = False) -> list:
        nbytes = sum(_nbytes(fields(p)) for p in sources)
        outs = [[torch.empty(t.shape, dtype=t.dtype, device=self.device) for t in fields(p)]
                for p in sources]
        with self.copying("in", nbytes):
            for out, p in zip(outs, sources):
                for o, t in zip(out, fields(p)):
                    o.copy_(t, non_blocking=self.card)
        if self.card:
            ready = self._event()
            ready.record(self.stream)
            self.compute_stream.wait_event(ready)
        self.transfers.append(Transfer(operand, "in", nbytes, apart))
        return [rebuild(p, out) for p, out in zip(sources, outs)]

    def copy_out(self, operand: str, pieces: list, dest, first: int = 0,
                 apart: bool = False) -> None:
        """Device ``pieces`` of ``operand`` into ``dest[first:]`` (a stack in
        slow memory) as one transfer, after the kernels that wrote them."""
        nbytes = sum(_nbytes(fields(p)) for p in pieces)
        done = None
        if self.card:
            done = self._event()
            done.record(self.compute_stream)
        with self.copying("out", nbytes, after=done):
            for k, p in enumerate(pieces):
                for src, stack in zip(fields(p), fields(dest)):
                    stack[first + k].copy_(src, non_blocking=self.card)
                    if self.card:
                        src.record_stream(self.stream)
        self.transfers.append(Transfer(operand, "out", nbytes, apart))

    def finish(self) -> None:
        """Wait for every copy; hand the records to the active logs and free
        the slots."""
        if self.card and self.transfers:
            self.stream.synchronize()
            self.compute_stream.wait_stream(self.stream)
        records = [r.record for r in self.rings]
        self.rings = []      # the rings hold the link: free their slots now, not at a GC
        for log in self.logs:
            call = RingLog(timed=log.timed)
            for into in (log, call):
                into.rings.extend(records)
                into.transfers.extend(self.transfers)
                if self.timed and log.timed:
                    into._origin = into._origin or self._origin
                    into._copies.extend(self._copies)
                    into._steps.extend(self._steps)
            log.calls.append(call)


class CopyRing:
    """Two device slots of one slow operand's pieces, driven by
    ``dma_schedule``. Call :meth:`acquire` before a step's kernels (it
    starts the prime and the prefetch copies and returns the step's piece,
    read from its slot) and :meth:`release` after them."""

    def __init__(self, link: Link, operand: str, role: str, source,
                 elements: list):
        self.link, self.elements = link, list(elements)
        self.pieces = (list(source) if isinstance(source, list)
                       else [piece(source, i) for i in range(fields(source)[0].shape[0])])
        per = [fields(p) for p in self.pieces]
        n_fields = len(per[0])
        # a slot holds the largest element of each field
        sizes = [max(f[k].numel() for f in per) for k in range(n_fields)]
        n = dma_schedule.N_SLOTS
        self.bufs = [[torch.empty(size, dtype=t.dtype, device=link.device)
                      for size, t in zip(sizes, per[0])] for _ in range(n)]
        self.held = [None] * n      # the element each slot holds
        self.copied = [None] * n
        self.released = [None] * n
        self.record = RingRecord(
            operand, role, len(self.elements), n_fields,
            source_pinned=(all(t.is_pinned() for f in per for t in f)
                           if link.card else None))

    def _log(self, kind: str, slot: int, elem: int) -> None:
        self.record.ops.extend((kind, slot, f, elem) for f in range(self.record.n_fields))

    def _start(self, slot: int, elem: int) -> None:
        src_piece = self.pieces[self.elements[elem]]
        src = fields(src_piece)
        nbytes = _nbytes(src)
        link = self.link
        views = [buf[:s.numel()].view(s.shape) for buf, s in zip(self.bufs[slot], src)]
        with link.copying("in", nbytes, after=self.released[slot]):
            for view, s in zip(views, src):
                view.copy_(s, non_blocking=link.card)
        if link.card:
            self.copied[slot] = link._event()
            self.copied[slot].record(link.stream)
        self.held[slot] = rebuild(src_piece, views)
        self._log("start", slot, elem)
        link.transfers.append(Transfer(self.record.operand, "in", nbytes))

    def acquire(self, lin: int):
        """Step ``lin``'s piece: the prime copy at step 0, the prefetch of
        element ``lin + 1``, the wait on ``lin``'s copy, its slot read."""
        if dma_schedule.is_prime_step(lin):
            self._start(dma_schedule.prime_slot(), 0)
        if dma_schedule.has_prefetch(lin, self.record.total):
            self._start(dma_schedule.prefetch_slot(lin), lin + 1)
        slot = dma_schedule.read_slot(lin)
        if self.link.card:
            self.link.compute_stream.wait_event(self.copied[slot])
        self._log("wait", slot, lin)
        self._log("read", slot, lin)
        return self.held[slot]

    def release(self, lin: int) -> None:
        """After step ``lin``'s kernels: its slot may be overwritten once
        they end."""
        slot = dma_schedule.read_slot(lin)
        if self.link.card:
            self.released[slot] = self.link._event()
            self.released[slot].record(self.link.compute_stream)
        self._log("release", slot, lin)


def source(link: Link, operand: str, stack, space: str, role: str, elements):
    """Step-indexed ``(get, put)`` of one operand's pieces (a stack or a
    list): a ring's slots when ``space`` is slow, the pieces themselves
    when it is fast."""
    elements = list(elements)
    if space == "slow":
        ring = link.ring(operand, role, stack, elements)
        return ring.acquire, ring.release
    if isinstance(stack, list):
        return (lambda lin: stack[elements[lin]]), (lambda lin: None)
    return (lambda lin: piece(stack, elements[lin])), (lambda lin: None)


def slow_stack(like, n: int, card: bool):
    """An uninitialized stack of ``n`` pieces shaped like ``like`` in slow
    memory: pinned on the card, pageable on the CPU."""
    return rebuild(like, [torch.empty((n, *t.shape), dtype=t.dtype, pin_memory=card)
                          for t in fields(like)])


def piece(stack, i: int):
    """Piece ``i`` of a stack (a view, no copy)."""
    return rebuild(stack, [t[i] for t in fields(stack)])


def staged(pieces: list, space: str, card: bool):
    """``pieces`` (CSRs, dense tensors or tuples of one geometry) as one
    stack: pinned when ``space`` is slow on the card, else where the pieces
    are."""
    st = rebuild(pieces[0], [torch.stack(ts) for ts in zip(*(fields(p) for p in pieces))])
    if space == "slow" and card:
        st = rebuild(st, [t if t.is_pinned() else
                          torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
                          for t in fields(st)])
    return st
