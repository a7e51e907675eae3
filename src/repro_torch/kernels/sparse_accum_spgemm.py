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

The merge has two routes (:data:`ROUTES`). ``shared``: a warp merges a row's
step in shared memory. ``global``: a block merges one step whose keys do not
fit a block's shared memory, in a workspace in global memory. Where the
launch-wide bound :func:`esc_workspace` fits shared memory every step takes
the shared route; otherwise :func:`esc_launch_plan` counts each step's keys
(:func:`step_keys`) and routes each step by its own count.
"""

from __future__ import annotations

import collections
import dataclasses

import torch

from repro_torch.core.kkmem import spgemm_ranged_impl
from repro_torch.kernels import copy_events
from repro_torch.kernels._build import LaunchCounter, launch, require
from repro_torch.sparse.csr import CSR, csr_row_of_entry

LAUNCHES = LaunchCounter()
ROUTES = ("shared", "global")
# calls that launched each route's kernel (a call may launch both)
ROUTE_LAUNCHES = {r: LaunchCounter() for r in ROUTES}
ORDERS = ("chunk1", "chunk2")
SMEM_PER_BLOCK = 232_448        # bytes of shared memory one block may use (H100)
SMEM_TARGET = 96 * 1024         # per-block target when choosing warps per block
MAX_WARPS_PER_BLOCK = 8
GLOBAL_THREADS = 512            # threads of the global route's block (one step each)
# keys of one step the global route sorts at most: its block indexes a
# step's sort slots with 32-bit ints
GLOBAL_MAX_KEYS = 1 << 30
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
                     extra=()):
    """Launch one of the CSR-output accumulator kernels (``csr_accum.cuh``)
    and return the stacked ``(indptr, indices, data)``. ``row_cap`` is the
    per-row accumulator width, ``smem_per_warp`` the merge's shared memory
    for one row; ``extra`` are pointer operands the entry point takes after
    the common ones (the ESC merge's routes). Raises when a row's workspace
    exceeds the shared memory of a block, and when the kernel reports a
    capacity overflow."""
    g = stack_geometry(Ast, Bst, C0st, order)
    dev = Ast.indptr.device
    if smem_per_warp > SMEM_PER_BLOCK:
        raise ValueError(
            f"{fn}: one row needs {smem_per_warp} bytes of shared memory, more "
            f"than the {SMEM_PER_BLOCK} a block has")
    warps = block_warps(smem_per_warp)
    r0s = torch.as_tensor(r0s, dtype=torch.int32).to(dev)
    r1s = torch.as_tensor(r1s, dtype=torch.int32).to(dev)
    for st, what in ((Ast, "A"), (Bst, "B"), (C0st, "C0")):
        require(st.indptr, f"{what}.indptr", torch.int32, dev)
        require(st.indices, f"{what}.indices", torch.int32, dev)
        require(st.data, f"{what}.data", torch.float32, dev)
    for t, what in ((r0s, "r0s"), (r1s, "r1s")):
        require(t, what, torch.int32, dev)
        if t.shape != (g["n_b"],):
            raise ValueError(f"{what} shape {tuple(t.shape)} != ({g['n_b']},)")
    rows = g["batch"] * g["n_ac"] * g["strip_rows"]
    slab_cols = torch.empty(rows * row_cap, dtype=torch.int32, device=dev)
    slab_vals = torch.empty(rows * row_cap, dtype=torch.float32, device=dev)
    slab_cnt = torch.empty(rows, dtype=torch.int32, device=dev)
    out_ip = torch.empty_like(C0st.indptr)
    out_ix = torch.empty_like(C0st.indices)
    out_d = torch.empty_like(C0st.data)
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    launch(lib, fn,
           [Ast.indptr, Ast.indices, Ast.data, Bst.indptr, Bst.indices, Bst.data,
            C0st.indptr, C0st.indices, C0st.data, r0s, r1s,
            slab_cols, slab_vals, slab_cnt, out_ip, out_ix, out_d, overflow, *extra],
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
    or once a chunk (chunk2), then the scan and the copy. An ESC call whose
    ``plan`` routes steps to the global route launches, for each chunk, the
    shared merge where the chunk has shared steps and the global merge where
    it has global ones."""
    if plan is not None and plan.split:
        return sum(plan.shared_chunks) + sum(
            int(a < b) for a, b in zip(plan.chunk_items[:-1], plan.chunk_items[1:])) + 2
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
    128 keys with the step's largest column + 1 as ``n_cols``; its
    shared-memory sorts pack 64-bit keys ``(column << 32) | position``."""
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
    steps of each ``"class/key bits"`` (``sort_class`` of the step's key
    count and ``key_bits`` of its largest column at the shared route's
    ``work_cap``; "none" has no key; "global/64" is a step that
    :func:`esc_launch_plan` sends to the global route), counted from
    :func:`plain_steps`."""
    plan = esc_launch_plan(Ast, Bst, C0st, r0s, r1s, row_cap=row_cap)
    steps = collections.Counter()
    for *_, n, top in plain_steps(Ast, Bst, C0st, r0s, r1s):
        steps.update(zip(n.tolist(), top.tolist()))
    counts = collections.Counter()
    for (n, top), k in steps.items():
        if plan.split and n > plan.shared_max_keys:
            counts["global/64"] += k
            continue
        cls = sort_class(n, key_bits(top + 1, plan.work_cap))
        counts[cls if cls == "none" else f"{cls}/{32 if cls.startswith('reg') else 64}"] += k
    return dict(sorted(counts.items()))


def esc_workspace(a_max_row_nnz: int, b_max_row_nnz: int, row_cap: int) -> tuple:
    """(sort slots, shared bytes) of one row's ESC merge: the row's products
    plus its accumulator, rounded up to a power of two for the bitonic sort,
    as 64-bit keys and f32 values, then the accumulator's columns and values."""
    work_cap = _pow2(max(a_max_row_nnz, 0) * max(b_max_row_nnz, 0) + row_cap)
    return work_cap, _align16(work_cap * 12 + row_cap * 8)


def shared_max_keys(row_cap: int) -> int:
    """The most keys one step may hold on the shared route: the largest power
    of two whose sort slots (12 bytes a key) fit a block's shared memory
    beside the row's ``row_cap`` accumulator (8 bytes an entry); 0 when the
    accumulator alone does not fit."""
    w = 1 << 30
    while w and _align16(w * 12 + row_cap * 8) > SMEM_PER_BLOCK:
        w >>= 1
    return w


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

    ``work_cap`` and ``smem_per_warp`` size the shared route; ``split``
    marks a call with steps on the global route, launched chunk by chunk:
    for chunk ``j`` the shared merge over the rows whose step fits
    (``skip[j, row]`` marks the others) where ``shared_chunks[j]``, then the
    global merge over items ``chunk_items[j]:chunk_items[j + 1]`` of
    ``items`` (global row index) with sort slots ``offsets[k]:offsets[k +
    1]`` (a power of two at least the step's keys) in a workspace of
    ``offsets[-1]`` keys. ``routes`` counts the steps of each route where
    the steps were counted (``None`` where the launch-wide bound fits)."""

    work_cap: int
    smem_per_warp: int
    shared_max_keys: int
    split: bool = False
    skip: torch.Tensor | None = None
    items: torch.Tensor | None = None
    offsets: torch.Tensor | None = None
    chunk_items: tuple = ()
    shared_chunks: tuple = ()
    routes: dict | None = None

    @property
    def workspace_bytes(self) -> int:
        """Bytes of the global route's workspace: a 64-bit key and an f32
        value per sort slot."""
        return 0 if self.offsets is None else int(self.offsets[-1]) * 12


def esc_launch_plan(Ast: CSR, Bst: CSR, C0st: CSR, r0s, r1s, *, row_cap: int) -> EscLaunch:
    """Route every merge step of one ESC call. Where the launch-wide bound
    (:func:`esc_workspace`) fits a block's shared memory, every step takes
    the shared route at that bound, unsplit. Otherwise each step's exact key
    count (:func:`step_keys`) decides: a step of at most
    :func:`shared_max_keys` keys stays shared, and the shared route is sized
    by the largest such step; a larger step (every step, where not even the
    accumulator fits shared memory) takes the global route, its sort
    slots the next power of two of its keys, placed by an exclusive scan
    over the global steps in (chunk, row) order. Counting the steps reads
    the operands' device twice (the products' total and the routes)."""
    row_cap = max(int(row_cap), 1)
    work_cap, smem = esc_workspace(Ast.max_row_nnz, Bst.max_row_nnz, row_cap)
    most = shared_max_keys(row_cap)
    if smem <= SMEM_PER_BLOCK:
        return EscLaunch(work_cap, smem, most)
    keys = step_keys(Ast, Bst, C0st, r0s, r1s)
    n_b = keys.shape[2]
    per_chunk = keys.permute(2, 0, 1, 3).reshape(n_b, -1)     # [n_b, rows]
    over = per_chunk > most if most else torch.ones_like(per_chunk, dtype=torch.bool)
    fit = per_chunk.masked_fill(over, 0)
    work_cap = _pow2(max(int(fit.max()) if fit.numel() else 1, 1))
    smem = _align16(work_cap * 12 + row_cap * 8)
    n_global = int(over.sum())
    routes = {"shared": int(over.numel()) - n_global, "global": n_global}
    if not n_global:
        return EscLaunch(work_cap, smem, most, routes=routes)
    chunk, row = over.nonzero(as_tuple=True)                  # chunk-major
    n = per_chunk[chunk, row]
    if int(n.max()) > GLOBAL_MAX_KEYS:
        raise ValueError(
            f"sparse_accum_launch: a merge step holds {int(n.max())} keys, more than "
            f"the {GLOBAL_MAX_KEYS} the global route sorts in one block")
    slots = 2 ** torch.ceil(torch.log2(n.clamp(min=1).double())).long()
    offsets = torch.zeros(n.numel() + 1, dtype=torch.int64, device=n.device)
    offsets[1:] = torch.cumsum(slots, 0)
    starts = torch.searchsorted(chunk.contiguous(), torch.arange(n_b + 1, device=n.device))
    shared = (~over).any(1)
    if not routes["shared"]:
        work_cap, smem = 1, 16
    return EscLaunch(work_cap, smem, most, split=True,
                     skip=over.to(torch.uint8).contiguous(),
                     items=row.to(torch.int32).contiguous(), offsets=offsets,
                     chunk_items=tuple(starts.tolist()),
                     shared_chunks=tuple(bool(v) for v in shared.tolist()),
                     routes=routes)


def sparse_accum_spgemm_stream(Ast: CSR, Bst: CSR, C0st: CSR, r0s, r1s, *,
                               order: str, row_cap: int):
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

    Returns ``(indptr, indices, data)`` with leading ``[batch, n_ac]`` axes.
    CPU tensors take the plain version; CUDA tensors launch the kernel, its
    steps routed by :func:`esc_launch_plan`. Raises a ``ValueError`` only
    where the global route's workspace would pass the card's free memory or
    a step passes ``GLOBAL_MAX_KEYS``.
    """
    if Ast.indptr.device.type == "cpu":
        return sparse_accum_plain(Ast, Bst, C0st, r0s, r1s, order=order)
    row_cap = max(int(row_cap), 1)
    plan = esc_launch_plan(Ast, Bst, C0st, r0s, r1s, row_cap=row_cap)
    dev = Ast.indptr.device
    extra = [None] * 6
    if plan.split:
        free, _ = torch.cuda.mem_get_info(dev)
        if plan.workspace_bytes > free:
            raise ValueError(
                f"sparse_accum_launch: the global route's workspace of "
                f"{plan.workspace_bytes} bytes passes the card's {free} free bytes")
        total = int(plan.offsets[-1])
        host_plan = torch.tensor(list(plan.chunk_items) + [int(v) for v in plan.shared_chunks],
                                 dtype=torch.int32)
        extra = [plan.skip.to(dev), plan.items.to(dev), plan.offsets.to(dev),
                 torch.empty(total, dtype=torch.int64, device=dev),
                 torch.empty(total, dtype=torch.float32, device=dev), host_plan]
    out = launch_csr_accum("sparse_accum_spgemm", "sparse_accum_launch",
                           LAUNCHES, Ast, Bst, C0st, r0s, r1s, order=order,
                           row_cap=row_cap, work_cap=plan.work_cap,
                           smem_per_warp=plan.smem_per_warp, extra=extra)
    if not plan.split or any(plan.shared_chunks):
        ROUTE_LAUNCHES["shared"].bump()
    if plan.split:
        ROUTE_LAUNCHES["global"].bump()
    return out
