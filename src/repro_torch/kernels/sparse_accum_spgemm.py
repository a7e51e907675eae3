"""CSR-output ranged SpGEMM with the ESC (expand-sort-compress) merge.

The port of the JAX package's ``sparse_accum_spgemm_stream``: over stacked
CSR strips and chunks, every strip's accumulator is a fixed-capacity CSR
triple at capacity ``c_cap`` from the symbolic phase, and each (strip, chunk)
step is the fused ``C = A[:, r0:r1] x B_chunk + C_prev`` of
``repro_torch.core.kkmem.spgemm_ranged_impl``.

On the card this is the CUDA kernel ``csrc/sparse_accum_spgemm.cu`` over the
shared skeleton ``csrc/csr_accum.cuh`` (one warp per strip row); on the CPU
the wrapper runs :func:`sparse_accum_plain`. The skeleton's launch helper,
:func:`launch_csr_accum`, also carries the hash merge
(``repro_torch.kernels.hash_accum_spgemm``).

Where the launch-wide bound :func:`esc_workspace` fits a block's shared
memory every step takes the ``shared`` route: a warp merges a row's step in
shared memory, one launch (chunk1) or one a chunk (chunk2). Otherwise
:func:`esc_launch_plan` counts each step's keys (:func:`step_keys`) and the
call is classed: chunk by chunk, each step class (:data:`STEP_CLASSES`, then
``global``) launches once over its own rows, its shared memory sized by its
own keys; an empty step launches nothing. :data:`ROUTES` names the shared
route and the classes.

Given the card as ``device``, the wrapper also takes operands in pinned host
memory, which the kernels read in place (and, for C, write in place) through
their mapped addresses; the merge's workspaces stay on the card, and the
launch plan is counted on the host when an operand is there.
"""

from __future__ import annotations

import collections
import dataclasses

import torch

from repro_torch.core.kkmem import spgemm_ranged_impl
from repro_torch.kernels import copy_events
from repro_torch.kernels._build import (
    LaunchCounter, alloc_like, launch, pointer, require,
)
from repro_torch.sparse.csr import (
    CSR, csr_on_one_device, csr_row_of_entry, kernel_device, reads_host,
)

LAUNCHES = LaunchCounter()
IN_PLACE = LaunchCounter()   # calls that read an operand in pinned host memory
ORDERS = ("chunk1", "chunk2")
SMEM_PER_BLOCK = 232_448        # bytes of shared memory one block may use (H100)
SMEM_TARGET = 96 * 1024         # per-block target when choosing warps per block
MAX_WARPS_PER_BLOCK = 8
# The step classes of a counted call, (name, kind, most keys a step holds:
# a power of two), in order: a step takes the first class its keys fit,
# past the last one the ``global`` class. "warp": a warp a step, up to 8
# warps a block (the merge's register sorts; one warp's shared-memory sort
# of a few hundred keys is hundreds of dependent rounds, so larger steps
# take a block); "block": a block a step, its threads sorting the step in
# shared memory. ``global`` sorts its step in tiles of the last class's
# keys.
STEP_CLASSES = (("warp128", "warp", 128), ("block512", "block", 512),
                ("block2048", "block", 2048), ("block16384", "block", 16384))
CLASS_KINDS = ("warp", "block", "global")      # the kind codes of the C entry
CLASS_KERNELS = {"warp": "esc_warp_kernel", "block": "esc_block_kernel",
                 "global": "esc_global_kernel"}
BLOCK_THREADS = 1024            # most threads of a block-class or global block
# the block and global kernels' static shared memory, the expand's scratch
# (ptxas's count for sm_90a)
BLOCK_STATIC_SMEM = 12_432
# keys of one step the global class sorts at most: its block indexes a
# step's sort slots with 32-bit ints
GLOBAL_MAX_KEYS = 1 << 30
ROUTES = ("shared", *(name for name, _, _ in STEP_CLASSES), "global")
# kernel launches of each route: "shared" a call on the shared route, a
# class each (chunk, class) launch of a counted call
ROUTE_LAUNCHES = {r: LaunchCounter() for r in ROUTES}
# the ESC merge's sort by size class: a merge step of n keys (the row's
# in-range products plus its accumulator) whose columns fit 32-bit keys sorts
# in registers, holding 1, 2 or 4 keys a lane, when n fits the class; a
# larger step, or one whose columns need 64-bit keys, sorts in shared memory
SORT_CLASSES = (("reg1", 32), ("reg2", 64), ("reg4", 128))


def stack_geometry(Ast: CSR, Bst: CSR, C0st: CSR, order: str) -> dict:
    """Shapes of the stacked operands, checked against each other."""
    if order not in ORDERS:
        raise ValueError(f"unknown streaming order {order!r}")
    batch, n_ac = Ast.indptr.shape[0], Ast.indptr.shape[1]
    n_b = Bst.indptr.shape[1]
    strip_rows, k_cols = Ast.shape
    chunk_rows, n_cols = Bst.shape
    if C0st.shape != (strip_rows, n_cols):
        raise ValueError(f"C0 shape {C0st.shape} != {(strip_rows, n_cols)}")
    caps = {}
    for what, st, lead, rows in (("A", Ast, (batch, n_ac), strip_rows),
                                 ("B", Bst, (batch, n_b), chunk_rows),
                                 ("C0", C0st, (batch, n_ac), strip_rows)):
        cap = st.indices.shape[-1]
        if (tuple(st.indptr.shape) != (*lead, rows + 1)
                or tuple(st.indices.shape) != (*lead, cap)
                or tuple(st.data.shape) != (*lead, cap)):
            raise ValueError(
                f"{what} stack fields {tuple(st.indptr.shape)}, "
                f"{tuple(st.indices.shape)}, {tuple(st.data.shape)} do not "
                f"match leading axes {lead} and {rows} rows")
        caps[what] = cap
    return dict(batch=batch, n_ac=n_ac, n_b=n_b, strip_rows=strip_rows,
                k_cols=k_cols, chunk_rows=chunk_rows, n_cols=n_cols,
                a_cap=caps["A"], chunk_cap=caps["B"], c_cap=caps["C0"])


def _element(st: CSR, b: int, i: int, max_row_nnz: int | None = None) -> CSR:
    return CSR(st.indptr[b, i], st.indices[b, i], st.data[b, i], st.shape,
               st.max_row_nnz if max_row_nnz is None else max_row_nnz)


def sparse_accum_plain(Ast: CSR, Bst: CSR, C0st: CSR, r0s, r1s, *,
                       order: str):
    """Plain version: ``spgemm_ranged_impl`` per (strip, chunk), looped in
    the order's nesting. Returns stacked ``(indptr, indices, data)``."""
    g = stack_geometry(Ast, Bst, C0st, order)
    if copy_events.active():
        # the largest step of a strip: its rows' keys, 12 bytes each
        keys = step_keys(Ast, Bst, C0st, r0s, r1s)
        copy_events.record_csr_stream("sparse_accum_spgemm", Ast, Bst, C0st, order,
                                      12 * int(keys.sum(-1).max()) if keys.numel() else 0)
    r0s = [int(v) for v in torch.as_tensor(r0s).tolist()]
    r1s = [int(v) for v in torch.as_tensor(r1s).tolist()]
    c_cap = g["c_cap"]
    out = [[_element(C0st, b, i, c_cap) for i in range(g["n_ac"])]
           for b in range(g["batch"])]
    if order == "chunk1":
        steps = [(i, j) for i in range(g["n_ac"]) for j in range(g["n_b"])]
    else:
        steps = [(i, j) for j in range(g["n_b"]) for i in range(g["n_ac"])]
    for b in range(g["batch"]):
        for i, j in steps:
            out[b][i] = spgemm_ranged_impl(
                _element(Ast, b, i), _element(Bst, b, j), r0s[j], r1s[j],
                out[b][i], c_cap)
    return tuple(torch.stack([torch.stack([getattr(c, f) for c in row])
                              for row in out])
                 for f in ("indptr", "indices", "data"))


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def _pow2(v: int) -> int:
    return 1 << max(int(v) - 1, 0).bit_length()


def launch_csr_accum(lib: str, fn: str, counter: LaunchCounter, Ast: CSR,
                     Bst: CSR, C0st: CSR, r0s, r1s, *, order: str,
                     row_cap: int, work_cap: int, smem_per_warp: int,
                     extra=(), device: torch.device | None = None):
    """Launch one of the CSR-output accumulator kernels (``csr_accum.cuh``)
    on ``device`` (A's by default) and return the stacked ``(indptr, indices, data)``, in
    ``C0st``'s space (on the card, or pinned host memory the kernel writes
    in place). An operand in pinned host memory is read in place; the
    per-row slabs and the overflow flag stay on the card. ``row_cap`` is the
    per-row accumulator width, ``smem_per_warp`` the merge's shared memory
    for one row; ``extra`` are pointer operands the entry point takes after
    the common ones (the ESC merge's classed launch). Raises when a row's workspace
    exceeds the shared memory of a block, and when the kernel reports a
    capacity overflow (which reads the flag, so the launch has finished)."""
    g = stack_geometry(Ast, Bst, C0st, order)
    dev = Ast.indptr.device if device is None else device
    if smem_per_warp > SMEM_PER_BLOCK:
        raise ValueError(
            f"{fn}: one row needs {smem_per_warp} bytes of shared memory, more "
            f"than the {SMEM_PER_BLOCK} a block has")
    warps = block_warps(smem_per_warp)
    r0s = torch.as_tensor(r0s, dtype=torch.int32).to(dev)
    r1s = torch.as_tensor(r1s, dtype=torch.int32).to(dev)
    for st, what in ((Ast, "A"), (Bst, "B"), (C0st, "C0")):
        require(st.indptr, f"{what}.indptr", torch.int32, dev, in_place=True)
        require(st.indices, f"{what}.indices", torch.int32, dev, in_place=True)
        require(st.data, f"{what}.data", torch.float32, dev, in_place=True)
    for t, what in ((r0s, "r0s"), (r1s, "r1s")):
        require(t, what, torch.int32, dev)
        if t.shape != (g["n_b"],):
            raise ValueError(f"{what} shape {tuple(t.shape)} != ({g['n_b']},)")
    rows = g["batch"] * g["n_ac"] * g["strip_rows"]
    slab_cols = torch.empty(rows * row_cap, dtype=torch.int32, device=dev)
    slab_vals = torch.empty(rows * row_cap, dtype=torch.float32, device=dev)
    slab_cnt = torch.empty(rows, dtype=torch.int32, device=dev)
    out_ip, out_ix, out_d = (alloc_like(t) for t in (C0st.indptr, C0st.indices, C0st.data))
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    operands = [pointer(t) for st in (Ast, Bst, C0st) for t in (st.indptr, st.indices, st.data)]
    launch(lib, fn,
           [*operands, r0s, r1s, slab_cols, slab_vals, slab_cnt,
            *(pointer(t) for t in (out_ip, out_ix, out_d)), overflow, *extra],
           [g["batch"], g["n_ac"], g["n_b"], g["strip_rows"], g["chunk_rows"],
            g["a_cap"], g["chunk_cap"], g["c_cap"], Ast.max_row_nnz,
            Bst.max_row_nnz, row_cap, work_cap, smem_per_warp, warps,
            ORDERS.index(order) + 1])
    counter.bump()
    if int(overflow.item()):
        raise RuntimeError(
            f"{fn}: a row or strip exceeded its capacity (row_cap={row_cap}, "
            f"c_cap={g['c_cap']}); size them from the exact symbolic phase")
    return out_ip, out_ix, out_d


def block_warps(smem_per_warp: int) -> int:
    """Warps (rows) a block of the skeleton's merge kernel holds: as many as
    fit ``SMEM_TARGET`` bytes of shared memory, 1 to 8."""
    return max(1, min(MAX_WARPS_PER_BLOCK, SMEM_TARGET // max(smem_per_warp, 1)))


def block_smem(smem_per_warp: int) -> int:
    """Dynamic shared memory one block of the skeleton's merge kernel asks
    for at ``smem_per_warp`` bytes a row."""
    return block_warps(smem_per_warp) * smem_per_warp


def kernels_per_call(order: str, n_b: int, plan: "EscLaunch | None" = None) -> int:
    """Kernels one call of the skeleton launches: the merge once (chunk1)
    or once a chunk (chunk2), then the scan and the copy. A classed ESC
    ``plan`` launches, for each chunk, each class that has steps there."""
    if plan is not None and plan.split:
        return len(plan.launch_order) + 2
    return (n_b if order == "chunk2" else 1) + 2


def sort_class(n: int, bits: int = 32) -> str:
    """The sort an ESC merge step of ``n`` keys of ``bits`` bits
    (``key_bits``) takes: "none" (no key), the register class
    ``"reg<keys a lane>"`` that 32-bit keys fit, "wide" (64-bit keys, at most
    128, sorted in shared memory) or "shared" (more keys, in shared memory,
    64-bit keys)."""
    if n <= 0:
        return "none"
    for name, cap in SORT_CLASSES:
        if n <= cap:
            return name if bits == 32 else "wide"
    return "shared"


def key_bits(n_cols: int, work_cap: int) -> int:
    """Width of a packed ESC sort key ``(column << pos_bits) | position``,
    ``pos_bits = bits(work_cap - 1)``: 32 where ``bits(n_cols - 1) + pos_bits
    <= 32``, else 64. The kernel applies the rule to each step of at most
    128 keys with the step's largest column + 1 as ``n_cols`` (a warp's
    shared-memory sort packs 64-bit keys ``(column << 32) | position``), and
    to a block or global class's launch with the call's width and the
    class's most slots (:meth:`EscLaunch.key_layout`)."""
    bits = (max(n_cols, 1) - 1).bit_length() + (max(work_cap, 1) - 1).bit_length()
    return 32 if bits <= 32 else 64


def _per_row(m: CSR, values: torch.Tensor, live: torch.Tensor, reduce: str) -> torch.Tensor:
    """Per row of ``m``: the sum or the max (-1 where none) of ``values``
    over the entries ``live`` marks."""
    out = torch.full((m.n_rows,), 0 if reduce == "sum" else -1, dtype=torch.int64,
                     device=m.device)
    return out.scatter_reduce_(0, csr_row_of_entry(m)[live], values[live], reduce)


def plain_steps(Ast: CSR, Bst: CSR, C0st: CSR, r0s, r1s):
    """Every (strip row, chunk) merge step of the ESC kernel, counted from
    the plain version's own steps (the accumulator before a step is the
    plain version's result of the steps before it; both orders run the same
    steps). Yields ``(b, i, j, n, top)``: per row of strip ``i`` of instance
    ``b`` at chunk ``j``, the step's key count (in-range products plus the
    accumulator's entries) and its largest column (-1 where none)."""
    g = stack_geometry(Ast, Bst, C0st, "chunk1")
    r0s = [int(v) for v in torch.as_tensor(r0s).tolist()]
    r1s = [int(v) for v in torch.as_tensor(r1s).tolist()]
    c_cap = g["c_cap"]

    def live(m: CSR, nnz) -> torch.Tensor:
        return torch.arange(m.nnz_pad, device=m.device) < nnz

    for b in range(g["batch"]):
        for i in range(g["n_ac"]):
            A = _element(Ast, b, i)
            acc = _element(C0st, b, i, c_cap)
            for j in range(g["n_b"]):
                B = _element(Bst, b, j)
                b_len = (B.indptr[1:] - B.indptr[:-1]).long().clamp(0, Bst.max_row_nnz)
                b_top = _per_row(B, B.indices.long(), live(B, B.indptr[-1]), "amax")
                col = A.indices.long()
                in_range = live(A, A.indptr[-1]) & (col >= r0s[j]) & (col < r1s[j])
                b_row = (col - r0s[j]).clamp(0, B.n_rows - 1)
                acc_ip = acc.indptr.long().clamp(max=c_cap)
                acc_live = live(acc, acc_ip[-1])
                n = _per_row(A, b_len[b_row], in_range, "sum") + acc_ip[1:] - acc_ip[:-1]
                top = torch.maximum(_per_row(A, b_top[b_row], in_range, "amax"),
                                    _per_row(acc, acc.indices.long(), acc_live, "amax"))
                yield b, i, j, n, top
                acc = spgemm_ranged_impl(A, B, r0s[j], r1s[j], acc, c_cap)


def sort_steps(Ast: CSR, Bst: CSR, C0st: CSR, r0s, r1s, *, row_cap: int) -> dict:
    """How the ESC kernel sorts: the number of (strip row, chunk) merge
    steps of each sort, counted from :func:`plain_steps`. On the shared
    route a step's key is ``"sort/key bits"`` (``sort_class`` of its key
    count and ``key_bits`` of its largest column at the route's
    ``work_cap``); in a classed call a warp class's step is
    ``"class/sort/key bits"`` at the class's ``work_cap``, a block or global
    class's ``"class/key bits"`` (:meth:`EscLaunch.key_layout`). "none" is
    an empty step."""
    plan = esc_launch_plan(Ast, Bst, C0st, r0s, r1s, row_cap=row_cap)
    steps = collections.Counter()
    for *_, n, top in plain_steps(Ast, Bst, C0st, r0s, r1s):
        steps.update(zip(n.tolist(), top.tolist()))
    counts = collections.Counter()
    for (n, top), k in steps.items():
        if n <= 0:
            counts["none"] += k
            continue
        cls = plan.class_of(n) if plan.split else None
        if cls is not None and cls.kind != "warp":
            counts[f"{cls.name}/{plan.key_layout(cls)[0]}"] += k
            continue
        sort = sort_class(n, key_bits(top + 1, plan.work_cap if cls is None else cls.work_cap))
        label = f"{sort}/{32 if sort.startswith('reg') else 64}"
        counts[label if cls is None else f"{cls.name}/{label}"] += k
    return dict(sorted(counts.items()))


def esc_workspace(a_max_row_nnz: int, b_max_row_nnz: int, row_cap: int) -> tuple:
    """(sort slots, shared bytes) of one row's ESC merge: the row's products
    plus its accumulator, rounded up to a power of two for the bitonic sort,
    as 64-bit keys and f32 values, then the accumulator's columns and values."""
    work_cap = _pow2(max(a_max_row_nnz, 0) * max(b_max_row_nnz, 0) + row_cap)
    return work_cap, _align16(work_cap * 12 + row_cap * 8)


@dataclasses.dataclass(frozen=True)
class StepClass:
    """One step class of a counted call and its launch: a step of at most
    ``max_keys`` keys (and more than the previous class's) takes it."""

    name: str
    kind: str            # "warp", "block" or "global"
    max_keys: int        # GLOBAL_MAX_KEYS for the global class
    work_cap: int        # sort slots a step: max_keys; the tile of the global class
    acc_cap: int         # a warp's accumulator slots (warp classes), else 0
    smem_per_warp: int   # warp classes, else 0
    threads: int         # threads a block
    smem: int            # dynamic shared memory a block

    @property
    def kernel(self) -> str:
        return CLASS_KERNELS[self.kind]

    @property
    def block_smem(self) -> int:
        """A block's shared memory, dynamic and the kernel's static."""
        return self.smem + (0 if self.kind == "warp" else BLOCK_STATIC_SMEM)


def block_threads(keys: int) -> int:
    """Threads of a block class's block: a thread per pair of its sort
    slots, 32 to ``BLOCK_THREADS``."""
    return max(32, min(BLOCK_THREADS, keys // 2))


def step_classes(row_cap: int) -> tuple:
    """The step classes (:class:`StepClass`) of a counted call whose rows
    hold at most ``row_cap`` entries, from :data:`STEP_CLASSES`, then the
    global class. Shared memory follows each class's own keys ``W``: a warp
    class ``W`` sort slots (a 64-bit key and an f32 value each, 12 bytes)
    and ``min(row_cap, W)`` accumulator slots (8 bytes) a warp, as many
    warps a block as fit ``SMEM_TARGET`` (``block_warps``); a block class
    ``W`` sort slots, the accumulator read straight into them; the global
    class one tile of the last class's keys (8 bytes a key). The sizes hold
    64-bit keys; a launch whose keys fit 32 bits uses less
    (:meth:`EscLaunch.key_layout`). Raises where a class's block does not
    fit ``SMEM_PER_BLOCK``."""
    out = []
    for name, kind, keys in STEP_CLASSES:
        if keys & (keys - 1) or kind not in ("warp", "block"):
            raise ValueError(f"step class {name}: {kind} of {keys} keys")
        if kind == "warp":
            acc = min(max(int(row_cap), 1), keys)
            spw = _align16(keys * 12 + acc * 8)
            warps = block_warps(spw)
            out.append(StepClass(name, kind, keys, keys, acc, spw, warps * 32, warps * spw))
        else:
            out.append(StepClass(name, kind, keys, keys, 0, 0, block_threads(keys), keys * 12))
    tile = STEP_CLASSES[-1][2]
    out.append(StepClass("global", "global", GLOBAL_MAX_KEYS, tile, 0, 0, BLOCK_THREADS,
                         tile * 8))
    for c in out:
        if c.block_smem > SMEM_PER_BLOCK:
            raise ValueError(f"step class {c.name}: a block asks for {c.block_smem} bytes of "
                             f"shared memory, more than the {SMEM_PER_BLOCK} a block has")
    return tuple(out)


def _stack_entries(st: CSR, strips: int, cap: int):
    """Every slot of a stacked CSR, flattened to ``strips`` elements:
    ``(live, row, col)`` of shape ``[strips, cap]`` (``cap`` slots an
    element, indptr clamped to it)."""
    ip = st.indptr.reshape(strips, -1).long().clamp(max=cap)
    slot = torch.arange(cap, device=ip.device).expand(strips, cap).contiguous()
    live = slot < ip[:, -1:]
    row = (torch.searchsorted(ip.contiguous(), slot, right=True) - 1).clamp(min=0)
    return live, row, st.indices.reshape(strips, cap).long()


def step_keys(Ast: CSR, Bst: CSR, C0st: CSR, r0s, r1s) -> torch.Tensor:
    """Exact key count of every ESC merge step, int64 ``[batch, n_ac, n_b,
    strip_rows]``: the step's in-range products (each B row clamped to
    ``Bst.max_row_nnz``, as the kernel does) plus the accumulator's entries
    before it, which are C_prev's row before the first chunk and, after
    chunk ``j``, the distinct columns of C_prev's row and the products of
    chunks ``0..j``. Counted on the operands' device by expanding every
    product once (the work of one plain product, no merge)."""
    g = stack_geometry(Ast, Bst, C0st, "chunk1")
    dev = Ast.indptr.device
    batch, n_ac, n_b, R = g["batch"], g["n_ac"], g["n_b"], g["strip_rows"]
    S, n_cols = batch * n_ac, g["n_cols"]
    r0s = [int(v) for v in torch.as_tensor(r0s).tolist()]
    r1s = [int(v) for v in torch.as_tensor(r1s).tolist()]
    a_live, a_row, a_col = _stack_entries(Ast, S, g["a_cap"])
    b_ip = Bst.indptr.long()
    b_ix = Bst.indices.reshape(batch, n_b, -1).long()
    prods = torch.zeros(S * R, n_b, dtype=torch.int64, device=dev)
    keys, first = [], []
    for j in range(n_b):
        s_idx, e_idx = (a_live & (a_col >= r0s[j]) & (a_col < r1s[j])).nonzero(as_tuple=True)
        b_row = (a_col[s_idx, e_idx] - r0s[j]).clamp(0, g["chunk_rows"] - 1)
        inst = s_idx // n_ac
        start = b_ip[inst, j, b_row]
        length = (b_ip[inst, j, b_row + 1] - start).clamp(0, Bst.max_row_nnz)
        owner_row = s_idx * R + a_row[s_idx, e_idx]
        prods[:, j].index_add_(0, owner_row, length)
        total = int(length.sum())
        which = torch.repeat_interleave(torch.arange(length.numel(), device=dev), length,
                                        output_size=total)
        offset = torch.arange(total, device=dev) - (torch.cumsum(length, 0) - length)[which]
        src = (start[which] + offset).clamp(max=g["chunk_cap"] - 1)
        keys.append(owner_row[which] * n_cols + b_ix[inst[which], j, src])
        first.append(torch.full((total,), j + 1, dtype=torch.int64, device=dev))
    c_live, c_row, c_col = _stack_entries(C0st, S, g["c_cap"])
    c_owner = (torch.arange(S, device=dev)[:, None] * R + c_row)[c_live]
    acc0 = torch.zeros(S * R, dtype=torch.int64, device=dev).index_add_(
        0, c_owner, torch.ones_like(c_owner))
    keys.append(c_owner * n_cols + c_col[c_live])
    first.append(torch.zeros(c_owner.numel(), dtype=torch.int64, device=dev))
    uniq, inverse = torch.unique(torch.cat(keys), return_inverse=True)
    seen = torch.full((uniq.numel(),), n_b + 1, dtype=torch.int64, device=dev)
    seen.scatter_reduce_(0, inverse, torch.cat(first), "amin")
    # distinct entries of each row first seen in C_prev (column 0) or chunk j
    # (column j + 1); their running sum is the accumulator after each step
    new = torch.zeros(S * R, n_b + 1, dtype=torch.int64, device=dev)
    new.index_put_((uniq // n_cols, seen), torch.ones_like(seen), accumulate=True)
    acc = torch.cumsum(new, 1)[:, :n_b].clone()
    acc[:, 0] = acc0
    return (prods + acc).reshape(batch, n_ac, R, n_b).permute(0, 1, 3, 2).contiguous()


@dataclasses.dataclass(frozen=True)
class EscLaunch:
    """How one ESC call launches (``esc_launch_plan``).

    On the shared route (``classes`` empty) ``work_cap`` and
    ``smem_per_warp`` size every step's merge. A classed call (``split``)
    launches chunk by chunk: for chunk ``j`` and class ``c`` (of
    ``classes``) the items ``starts[j * len(classes) + c]`` up to the next
    start of ``items`` (the step's global row), chunk-major, then by class,
    then by row; the global class's items have sort slots ``offsets[k]:
    offsets[k + 1]`` (a power of two at least the step's keys, in the
    items' order) in a workspace of ``offsets[-1]`` keys. ``routes`` counts
    the steps of each class and the empty ones where the steps were counted
    (``None`` on the shared route); ``n_cols`` is the call's width, which
    picks the block and global classes' key width (:meth:`key_layout`)."""

    work_cap: int = 0
    smem_per_warp: int = 0
    classes: tuple = ()
    items: torch.Tensor | None = None
    starts: tuple = ()
    offsets: torch.Tensor | None = None
    routes: dict | None = None
    n_cols: int = 0

    @property
    def split(self) -> bool:
        return bool(self.classes)

    @property
    def workspace_bytes(self) -> int:
        """Bytes of the global class's workspace: a 64-bit key and an f32
        value per sort slot."""
        return 0 if self.offsets is None else int(self.offsets[-1]) * 12

    def class_of(self, keys: int) -> StepClass:
        """The class of a non-empty step of ``keys`` keys."""
        return next(c for c in self.classes if keys <= c.max_keys)

    @property
    def launch_order(self) -> list:
        """The class of each merge launch of a classed call, in launch
        order (none on the shared route)."""
        n = max(len(self.classes), 1)
        return [c.name for j in range((len(self.starts) - 1) // n)
                for i, c in enumerate(self.classes)
                if self.starts[j * n + i + 1] > self.starts[j * n + i]]

    @property
    def launches(self) -> dict:
        """Merge launches of each class in one call."""
        return dict(collections.Counter(self.launch_order))

    def key_layout(self, cls: StepClass) -> tuple:
        """(key bits, position bits) of a block or global class's sort keys
        ``(column << position bits) | position``: 32-bit keys where
        ``key_bits`` of the call's columns and the class's most slots (a
        block class's ``W``, the call's largest global step's) allows, else
        64-bit keys with the column above bit 32."""
        slots = cls.work_cap
        if cls.kind == "global":
            steps = self.offsets[1:] - self.offsets[:-1]
            slots = int(steps.max()) if steps.numel() else 1
        if key_bits(self.n_cols, slots) == 32:
            return 32, (max(slots, 1) - 1).bit_length()
        return 64, 32

    def host_plan(self) -> torch.Tensor:
        """The C entry's host array: the classes, the global tile, each
        class's kind, work_cap, accumulator slots, smem_per_warp, threads,
        dynamic shared memory and key layout (block and global classes),
        then the (chunk, class) starts."""
        fields = [v for c in self.classes
                  for v in (CLASS_KINDS.index(c.kind), c.work_cap, c.acc_cap,
                            c.smem_per_warp, c.threads, c.smem,
                            *(self.key_layout(c) if c.kind != "warp" else (0, 0)))]
        return torch.tensor([len(self.classes), self.classes[-1].work_cap, *fields,
                             *self.starts], dtype=torch.int32)


def esc_launch_plan(Ast: CSR, Bst: CSR, C0st: CSR, r0s, r1s, *, row_cap: int) -> EscLaunch:
    """How one ESC call launches. Where the launch-wide bound
    (:func:`esc_workspace`) fits a block's shared memory, every step takes
    the shared route at that bound. Otherwise each step's exact key count
    (:func:`step_keys`) picks its class (:func:`step_classes`: the first
    whose ``max_keys`` holds it; an empty step none), and each chunk's
    non-empty steps are listed by class on the card, with no loop over
    rows; the global class's steps get sort slots the next power of two of
    their keys, placed by an exclusive scan in (chunk, row) order. Counting
    and listing the steps reads the operands' device a few times."""
    row_cap = max(int(row_cap), 1)
    work_cap, smem = esc_workspace(Ast.max_row_nnz, Bst.max_row_nnz, row_cap)
    if smem <= SMEM_PER_BLOCK:
        return EscLaunch(work_cap, smem)
    classes = step_classes(row_cap)
    n_cls = len(classes)
    keys = step_keys(Ast, Bst, C0st, r0s, r1s)
    n_b = keys.shape[2]
    per_chunk = keys.permute(2, 0, 1, 3).reshape(n_b, -1)     # [n_b, rows]
    dev = per_chunk.device
    cuts = torch.tensor([c.max_keys for c in classes[:-1]], dtype=torch.int64, device=dev)
    chunk, row = (per_chunk > 0).nonzero(as_tuple=True)       # chunk-major
    n = per_chunk[chunk, row]
    code = chunk * n_cls + torch.bucketize(n, cuts)           # past the last cut: global
    order = torch.argsort(code, stable=True)
    code, n = code[order], n[order]
    counts = torch.bincount(code, minlength=n_b * n_cls)
    starts = torch.zeros(n_b * n_cls + 1, dtype=torch.int64, device=dev)
    starts[1:] = torch.cumsum(counts, 0)
    n = n[code % n_cls == n_cls - 1]
    if n.numel() and int(n.max()) > GLOBAL_MAX_KEYS:
        raise ValueError(
            f"sparse_accum_launch: a merge step holds {int(n.max())} keys, more than "
            f"the {GLOBAL_MAX_KEYS} the global class sorts in one block")
    offsets = torch.zeros(n.numel() + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(2 ** torch.ceil(torch.log2(n.double())).long(), 0)
    by_class = counts.reshape(n_b, n_cls).sum(0).tolist()
    routes = {"empty": int(per_chunk.numel() - chunk.numel()),
              **{c.name: int(v) for c, v in zip(classes, by_class)}}
    return EscLaunch(classes=classes, items=row[order].to(torch.int32).contiguous(),
                     starts=tuple(starts.tolist()), offsets=offsets, routes=routes,
                     n_cols=Bst.shape[1])


def sparse_accum_spgemm_stream(Ast: CSR, Bst: CSR, C0st: CSR, r0s, r1s, *,
                               order: str, row_cap: int, device=None):
    """Streamed sparse-output multiply over stacked CSR strips and chunks.

    Args:
      Ast: doubly-stacked A strips — a :class:`CSR` whose fields carry leading
        ``[batch, n_ac]`` axes, per-element ``shape == (strip_rows, k_cols)``.
      Bst: doubly-stacked B chunks, leading ``[batch, n_b]`` axes,
        per-element ``shape == (chunk_rows, n_cols)``; ``max_row_nnz`` bounds
        the products per A entry.
      C0st: the fused ``C_prev`` per strip, leading ``[batch, n_ac]`` axes;
        its entry capacity is the CSR scratch capacity ``c_cap``.
      r0s, r1s: i32[n_b] global row range of each B chunk.
      order: "chunk1" (strips outer, B streamed) or "chunk2" (chunks outer).
      row_cap: bound on the nnz of any output row (the symbolic
        ``c_max_row_nnz``); sizes the kernel's per-row accumulator.
      device: where it runs (``csr.kernel_device``): ``None`` takes A's
        device (pinned host operands raise: a slow operand reaches the card
        through an entry point), "cpu" the plain version, the card the
        kernels, which read an operand in pinned host memory in place.

    Returns ``(indptr, indices, data)`` with leading ``[batch, n_ac]`` axes,
    in ``C0st``'s space. The kernels launch as :func:`esc_launch_plan` says
    (counted on the host where an operand is there). Raises a
    ``ValueError`` only where the global class's workspace would pass the
    card's free memory or a step passes ``GLOBAL_MAX_KEYS``.
    """
    dev = kernel_device("sparse_accum_spgemm_stream", device, Ast, Bst, C0st)
    if dev is None:
        return sparse_accum_plain(Ast, Bst, C0st, r0s, r1s, order=order)
    row_cap = max(int(row_cap), 1)
    plan = esc_launch_plan(*csr_on_one_device(Ast, Bst, C0st), r0s, r1s, row_cap=row_cap)
    extra = [None] * 5
    if plan.split:
        free, _ = torch.cuda.mem_get_info(dev)
        if plan.workspace_bytes > free:
            raise ValueError(
                f"sparse_accum_launch: the global class's workspace of "
                f"{plan.workspace_bytes} bytes passes the card's {free} free bytes")
        total = int(plan.offsets[-1])
        extra = [plan.items.to(dev), plan.offsets.to(dev),
                 torch.empty(total, dtype=torch.int64, device=dev),
                 torch.empty(total, dtype=torch.float32, device=dev), plan.host_plan()]
    out = launch_csr_accum("sparse_accum_spgemm", "sparse_accum_launch",
                           LAUNCHES, Ast, Bst, C0st, r0s, r1s, order=order,
                           row_cap=row_cap, work_cap=plan.work_cap,
                           smem_per_warp=plan.smem_per_warp, extra=extra, device=dev)
    for route in plan.launch_order if plan.split else ("shared",):
        ROUTE_LAUNCHES[route].bump()
    if reads_host(Ast, Bst, C0st):
        IN_PLACE.bump()
    return out
