"""CSR-output ranged SpGEMM with a linear-probing hash accumulator.

The port of the JAX package's ``hash_accum_spgemm_stream`` and its merge
``hash_merge_impl``: each strip row owns a power-of-two table of
``table_size = planner.hash_table_slots(c_max_row_nnz)`` slots keyed by
column, probed from Knuth's multiplicative hash ``col * 2654435769 mod 2^32``
masked by ``table_size - 1``, at most :func:`probe_step_bound` steps;
extraction sorts each row by column into the fixed-capacity CSR scratch —
the same output as the ESC merge.

On the card this is the CUDA kernel ``csrc/hash_accum_spgemm.cu`` over the
skeleton it shares with the ESC kernel (its extraction sorts by
:func:`extract_class`); on the CPU the wrapper runs
:func:`hash_accum_plain`, which keeps the reference's steps (fresh tables per
chunk, products inserted in entry order, then ``C_prev``, sort on extract),
vectorized across rows, so a table-capacity or probe fault shows on the CPU
too.

The mask-fused variant, ``hash_masked_accum_spgemm_stream`` (the port of
``hash_masked_merge_impl``), seeds every row's table from the mask row and
accumulates probe-only, so C's structure is the mask's: the fused path of
triangle counting. On the card it is ``csrc/hash_masked_accum_spgemm.cu``:
the rows are cut into parts by products (:func:`masked_work`), grouped into
launches by team and by table, sized per row (:func:`masked_launches`); on
the CPU :func:`hash_masked_plain`.

Given the card as ``device``, both wrappers also take operands in pinned
host memory, which the kernels read (and, for C, write) in place through
their mapped addresses; tables, slabs and flags stay on the card, and the
masked work list is cut on the host when an operand is there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.planner import hash_table_slots
from repro_torch.kernels import copy_events
from repro_torch.kernels._build import (
    LaunchCounter, alloc_like, launch, pointer, require,
)
from repro_torch.kernels.sparse_accum_spgemm import (
    SMEM_PER_BLOCK, launch_csr_accum, sort_class, stack_geometry,
)
from repro_torch.sparse.csr import CSR, csr_on_one_device, kernel_device, reads_host

LAUNCHES = LaunchCounter()
MASKED_LAUNCHES = LaunchCounter()
# calls that read an operand in pinned host memory, of each wrapper
IN_PLACE = LaunchCounter()
MASKED_IN_PLACE = LaunchCounter()
_EMPTY = -1           # table key sentinel (column ids are >= 0)
_KNUTH = 2654435769   # Knuth's multiplicative hash constant (2^32 / phi)
_TABLES = None        # the active TableLog, if any


class TableLog:
    """Context manager that records the table size every call of
    :func:`hash_accum_spgemm_stream` is given while it is active
    (``tables``, in call order; the plain version's calls and the kernel's
    alike): what bounds each launch's probe loops, read by the auditor's
    probe-bound pass (``analysis.dma.check_while_bounds``)."""

    def __init__(self):
        self.tables: list = []

    def __enter__(self):
        global _TABLES
        if _TABLES is not None:
            raise RuntimeError("table sizes are already being recorded")
        _TABLES = self
        return self

    def __exit__(self, *exc) -> None:
        global _TABLES
        _TABLES = None


def probe_step_bound(table_size: int) -> int:
    """Step bound of one linear probe: a probe visits every slot at most once."""
    return int(table_size)


def _check_table(table_size: int) -> int:
    if table_size < 1 or table_size != hash_table_slots(table_size):
        raise ValueError(f"table_size={table_size} must be a power of two "
                         ">= 1 (use planner.hash_table_slots)")
    return int(table_size)


def _row_entries(indptr, indices, data, width: int):
    """Per-row padded entries of a stacked CSR with leading ``[S]`` strips:
    ``(cols, vals, valid)``, each ``[S * strip_rows, width]``."""
    n_strips, rows_p1 = indptr.shape
    cap = indices.shape[-1]
    ptr = indptr.long()
    start = ptr[:, :-1].reshape(-1)
    end = ptr[:, 1:].reshape(-1)
    strip = torch.arange(n_strips, device=ptr.device).repeat_interleave(rows_p1 - 1)
    e = start[:, None] + torch.arange(width, device=ptr.device)
    valid = e < end[:, None]
    e = e.clamp(0, max(cap - 1, 0))
    return indices.long()[strip[:, None], e], data[strip[:, None], e], valid


def _insert(keys, vals, cols, v, valid, table_size: int) -> None:
    """Insert-or-accumulate one product per row (rows are distinct, so the
    vectorized step has no conflicts): bounded linear probe from the Knuth
    slot, claim an empty slot or add to the matching key."""
    rows = torch.arange(keys.shape[0], device=keys.device)
    mask = table_size - 1
    slot = (cols * _KNUTH) & mask
    active = valid.clone()
    for _ in range(probe_step_bound(table_size)):
        if not bool(active.any()):
            return
        k = keys[rows, slot]
        empty = active & (k == _EMPTY)
        done = empty | (active & (k == cols))
        keys[rows[empty], slot[empty]] = cols[empty]
        vals[rows[done], slot[done]] += v[done]
        active &= ~done
        slot = torch.where(active, (slot + 1) & mask, slot)
    if bool(active.any()):
        raise RuntimeError(f"hash table of {table_size} slots is full: the "
                           "densest output row exceeds the table")


def _extract(keys, vals, n_strips: int, strip_rows: int, c_cap: int):
    """Sort each row's table by key and compact into stacked CSR strips at
    capacity ``c_cap`` (zero tail)."""
    dev = keys.device
    occupied = keys != _EMPTY
    counts = occupied.sum(1)
    skeys, order = torch.sort(torch.where(occupied, keys, torch.iinfo(torch.int64).max), 1)
    svals = vals.gather(1, order)
    indptr = torch.zeros(n_strips, strip_rows + 1, dtype=torch.int64, device=dev)
    indptr[:, 1:] = torch.cumsum(counts.view(n_strips, strip_rows), 1)
    if bool((indptr[:, -1] > c_cap).any()):
        raise RuntimeError(f"a strip's output exceeds c_cap={c_cap}")
    pos = indptr[:, :-1].reshape(-1, 1) + torch.arange(keys.shape[1], device=dev)
    used = torch.arange(keys.shape[1], device=dev) < counts[:, None]
    strip = (torch.arange(keys.shape[0], device=dev) // strip_rows)[:, None].expand_as(pos)
    indices = torch.zeros(n_strips, c_cap, dtype=torch.int64, device=dev)
    data = torch.zeros(n_strips, c_cap, dtype=vals.dtype, device=dev)
    indices[strip[used], pos[used]] = skeys[used]
    data[strip[used], pos[used]] = svals[used]
    return indptr.to(torch.int32), indices.to(torch.int32), data


def hash_accum_plain(Ast: CSR, Bst: CSR, C0st: CSR, r0s, r1s, *, order: str,
                     table_size: int):
    """Plain version of the hash merge, step by step as the reference takes
    them: for every chunk, fresh tables; each row's in-range products
    inserted in entry order, then its ``C_prev`` entries; sort-on-extract into
    the CSR scratch. Vectorized across all strip rows (both orders give every
    strip the same chunk sequence). Returns stacked ``(indptr, indices, data)``."""
    g = stack_geometry(Ast, Bst, C0st, order)
    T = _check_table(table_size)
    batch, n_ac, strip_rows = g["batch"], g["n_ac"], g["strip_rows"]
    # the kernel's tables of a strip: an int32 key and an f32 value a slot
    copy_events.record_csr_stream("hash_accum_spgemm", Ast, Bst, C0st, order,
                                  strip_rows * T * 8)
    n_strips, c_cap = batch * n_ac, g["c_cap"]
    dev = Ast.indptr.device
    r0s = [int(v) for v in torch.as_tensor(r0s).tolist()]
    r1s = [int(v) for v in torch.as_tensor(r1s).tolist()]
    flat = lambda t: t.reshape(n_strips, t.shape[-1])  # noqa: E731
    a_cols, a_vals, a_valid = _row_entries(
        flat(Ast.indptr), flat(Ast.indices), flat(Ast.data), Ast.max_row_nnz)
    n_rows = n_strips * strip_rows
    row_batch = torch.arange(n_rows, device=dev) // (n_ac * strip_rows)
    bmax = max(Bst.max_row_nnz, 1)
    jj = torch.arange(bmax, device=dev)
    ip, ix, d = flat(C0st.indptr), flat(C0st.indices), flat(C0st.data)
    for j in range(g["n_b"]):
        b_ptr = Bst.indptr[:, j].long()
        in_range = a_valid & (a_cols >= r0s[j]) & (a_cols < r1s[j])
        b_row = (a_cols - r0s[j]).clamp(0, g["chunk_rows"] - 1)
        b_start = b_ptr[row_batch[:, None], b_row]
        b_len = b_ptr[row_batch[:, None], b_row + 1] - b_start
        valid = in_range[..., None] & (jj < b_len[..., None])
        src = (b_start[..., None] + jj).clamp(0, g["chunk_cap"] - 1)
        rb = row_batch[:, None, None]
        p_cols = Bst.indices[:, j].long()[rb, src].reshape(n_rows, -1)
        p_vals = (a_vals[..., None] * Bst.data[:, j][rb, src]).reshape(n_rows, -1)
        valid = valid.reshape(n_rows, -1)
        width = int((ip[:, 1:] - ip[:, :-1]).max()) if n_rows else 0
        c_cols, c_vals, c_valid = _row_entries(ip, ix, d, width)
        keys = torch.full((n_rows, T), _EMPTY, dtype=torch.int64, device=dev)
        vals = torch.zeros(n_rows, T, dtype=Bst.data.dtype, device=dev)
        for col, v, ok in ((p_cols, p_vals, valid), (c_cols, c_vals, c_valid)):
            for t in range(col.shape[1]):
                _insert(keys, vals, col[:, t], v[:, t], ok[:, t], T)
        ip, ix, d = _extract(keys, vals, n_strips, strip_rows, c_cap)
    shape = lambda t: t.reshape(batch, n_ac, t.shape[-1])  # noqa: E731
    return shape(ip), shape(ix), shape(d)


def extract_class(n: int) -> str:
    """How the hash kernel sorts a row's ``n`` occupied slots when it writes
    the row: "none", a register class "reg<keys a lane>" (n <= 32, 64,
    128; the keys are columns, 32 bits, with the values beside them) or
    "shared" (more, in shared memory): the ESC merge's ``sort_class`` of
    32-bit keys."""
    return sort_class(n, 32)


def hash_accum_spgemm_stream(Ast: CSR, Bst: CSR, C0st: CSR, r0s, r1s, *,
                             order: str, table_size: int, device=None):
    """Streamed hash-accumulated multiply over stacked CSR strips and chunks.

    Operand layout, streaming orders, ``device`` and the returned stacked CSR
    triple (in ``C0st``'s space) are those of
    ``sparse_accum_spgemm_stream``; ``table_size`` is the per-row hash-table
    slot count, ``planner.hash_table_slots`` of the symbolic
    ``c_max_row_nnz``. The plain version runs on the host, the kernel on the
    card, reading an operand in pinned host memory in place.
    """
    T = _check_table(table_size)
    if _TABLES is not None:
        _TABLES.tables.append(T)
    dev = kernel_device("hash_accum_spgemm_stream", device, Ast, Bst, C0st)
    if dev is None:
        return hash_accum_plain(Ast, Bst, C0st, r0s, r1s, order=order,
                                table_size=T)
    out = launch_csr_accum("hash_accum_spgemm", "hash_accum_launch", LAUNCHES,
                           Ast, Bst, C0st, r0s, r1s, order=order, row_cap=T,
                           work_cap=0, smem_per_warp=table_smem(T), device=dev)
    if reads_host(Ast, Bst, C0st):
        IN_PLACE.bump()
    return out


def table_smem(table_size: int) -> int:
    """Shared memory of one row's table: an int32 key and an f32 value a
    slot, to 16 bytes."""
    return -(-table_size * 8 // 16) * 16


# ---------------------------------------------------------------------------
# mask-fused variant: tables seeded from the mask, probe-only accumulation
# ---------------------------------------------------------------------------

# The masked kernel's per-row table: a power of two of at least twice the
# row's mask nnz. Probe-only lookups mostly miss (at graph scale 7 of 8
# products fall outside the mask), and a linear-probing miss scans to the
# next empty slot, so the load factor is held at 1/2 or below.
def masked_table_slots(mask_row_nnz: int) -> int:
    return hash_table_slots(2 * int(mask_row_nnz))


# The masked kernel's work (masked_work, masked_launches): the rows are cut
# into parts by products, each part one team's work. A part of at most
# MASKED_WARP_PRODUCTS products whose table holds at most
# MASKED_WARP_TABLE_MAX slots goes to a "warp" team (one warp, its table in
# shared memory, MASKED_WARP_THREADS threads a block); a larger part to a
# "block" team (one block of MASKED_BLOCK_THREADS threads, 1,024 where the
# table leaves room for one block an SM, its table in shared memory); a part
# of a row whose table exceeds MASKED_SHARED_MAX slots (128 KiB) to a
# "global" team (a block of MASKED_BLOCK_THREADS threads; the row's parts
# share one table in global memory). The part size gives each SM about
# MASKED_PARTS_PER_SM parts of the call's products, and at least
# MASKED_PART_MIN products.
MASKED_TEAMS = ("warp", "block", "global")   # the kernel's team codes, in order
MASKED_WARP_THREADS = 256
MASKED_BLOCK_THREADS = 512
MASKED_WARP_TABLE_MAX = 512
MASKED_WARP_PRODUCTS = 2048
MASKED_SHARED_MAX = 16384
MASKED_PARTS_PER_SM = 32
MASKED_PART_MIN = 4096
_MASKED_FIRST, _MASKED_ONLY = 1, 2   # part flags: the row's first / only part
# a 1,024-thread block team's table and its walk's scan (three words a thread)
assert MASKED_SHARED_MAX * 8 + 1024 * 12 + 128 <= SMEM_PER_BLOCK
_PLAIN_SLICE = 1 << 25            # products the plain version expands at once


def _mask_row_counts(Mst: CSR):
    """Per-row nnz of a stacked mask, flattened strip-major."""
    ip = Mst.indptr.reshape(-1, Mst.indptr.shape[-1]).long()
    return (ip[:, 1:] - ip[:, :-1]).reshape(-1)


def check_mask(Mst: CSR, c_cap: int, table_size: int) -> None:
    """What both versions need of a stacked mask: every strip fits the output
    capacity, the densest row fits ``table_size``, and every row holds
    strictly increasing columns inside the output width (a CSR mask from the
    package's constructors always does)."""
    counts = _mask_row_counts(Mst)
    densest = int(counts.max()) if counts.numel() else 0
    if densest > table_size:
        raise ValueError(f"densest mask row ({densest} nnz) exceeds the hash "
                         f"table of {table_size} slots")
    worst = int(Mst.indptr[..., -1].max()) if Mst.indptr.numel() else 0
    if worst > c_cap:
        raise ValueError(f"a mask strip holds {worst} entries, more than the "
                         f"output capacity c_cap={c_cap}")
    ip = Mst.indptr.reshape(-1, Mst.indptr.shape[-1])
    ix = Mst.indices.reshape(ip.shape[0], -1)
    if ix.shape[1] < 1:
        return
    pos = torch.arange(ix.shape[1], device=ix.device, dtype=torch.int32)
    pos = pos.expand(ip.shape[0], -1).contiguous()
    valid = pos < ip[:, -1:]
    row = torch.searchsorted(ip.contiguous(), pos, right=True) - 1
    same_row = valid[:, 1:] & (row[:, 1:] == row[:, :-1])
    bad = same_row & (ix[:, 1:] <= ix[:, :-1])
    out_of_range = valid & ((ix < 0) | (ix >= Mst.n_cols))
    if bool(bad.any()) or bool(out_of_range.any()):
        raise ValueError("mask rows must hold strictly increasing column "
                         "indices inside the output width")


def _flat_entries(st: CSR):
    """Valid entries of a stacked CSR with leading ``[S]`` strips, in entry
    order: ``(strip, row, col, val)`` (int64, int64, int64, data dtype)."""
    ip = st.indptr.reshape(-1, st.indptr.shape[-1])
    ix = st.indices.reshape(ip.shape[0], -1)
    d = st.data.reshape(ip.shape[0], -1)
    pos = torch.arange(ix.shape[1], device=ix.device, dtype=torch.int32)
    pos = pos.expand(ip.shape[0], -1).contiguous()
    valid = pos < ip[:, -1:]
    row = torch.searchsorted(ip.contiguous(), pos, right=True) - 1
    strip = torch.arange(ip.shape[0], device=ix.device)[:, None].expand_as(pos)
    return (strip[valid], row[valid].long(), ix[valid].long(), d[valid])


def hash_masked_plain(Ast: CSR, Bst: CSR, C0st: CSR, Mst: CSR, r0s, r1s, *,
                      order: str, table_size: int):
    """Plain version of the mask-fused hash merge, step by step as the
    reference takes them: for every chunk, the rows' key sets are the mask
    rows' (frozen), the chunk's in-range products add in entry order to the
    keys they hit and are dropped otherwise, then the previous result's
    entries add the same way; extraction is the keys in sorted order. A key
    lookup is a search in the sorted mask keys, not a probe: the key sets
    and sums are the table's. Both orders give every strip the same chunk
    sequence. Returns stacked ``(indptr, indices, data)``."""
    g = stack_geometry(Ast, Bst, C0st, order)
    T = _check_table(table_size)
    check_mask(Mst, g["c_cap"], T)
    batch, n_ac, strip_rows = g["batch"], g["n_ac"], g["strip_rows"]
    n_strips, c_cap, n_cols = batch * n_ac, g["c_cap"], g["n_cols"]
    dev = Ast.indptr.device
    r0s = [int(v) for v in torch.as_tensor(r0s).tolist()]
    r1s = [int(v) for v in torch.as_tensor(r1s).tolist()]
    per_strip = strip_rows * n_cols

    def key(strip, row, col):
        return (strip * strip_rows + row) * n_cols + col

    m_strip, m_row, m_col, _ = _flat_entries(Mst)
    keys = torch.unique(key(m_strip, m_row, m_col))      # sorted, frozen

    def accumulate(vals, k, v):
        if k.numel() == 0:
            return
        at = torch.searchsorted(keys, k).clamp(max=max(keys.numel() - 1, 0))
        hit = keys[at] == k if keys.numel() else torch.zeros_like(k, dtype=torch.bool)
        vals.index_add_(0, at[hit], v[hit])

    a_strip, a_row, a_col, a_val = _flat_entries(Ast)
    prev = _flat_entries(C0st)
    prev_keys, prev_vals = key(prev[0], prev[1], prev[2]), prev[3]
    for j in range(g["n_b"]):
        vals = torch.zeros(keys.numel(), dtype=Bst.data.dtype, device=dev)
        sel = (a_col >= r0s[j]) & (a_col < r1s[j])
        s_, r_, c_, v_ = a_strip[sel], a_row[sel], a_col[sel], a_val[sel]
        b = s_ // n_ac
        b_ptr = Bst.indptr[:, j].long()
        b_start = b_ptr[b, c_ - r0s[j]]
        b_len = (b_ptr[b, c_ - r0s[j] + 1] - b_start).clamp(0, max(Bst.max_row_nnz, 0))
        # expand the products in slices of whole A entries, in entry order,
        # so memory stays bounded at graph scale
        ends = torch.cumsum(b_len, 0)
        total = int(ends[-1]) if ends.numel() else 0
        marks = torch.tensor(range(_PLAIN_SLICE, total, _PLAIN_SLICE), dtype=ends.dtype,
                             device=dev)
        cuts = torch.searchsorted(ends, marks, right=True).tolist()
        for e0, e1 in zip([0, *cuts], [*cuts, b_len.numel()]):
            if e1 <= e0:
                continue
            lens = b_len[e0:e1]
            rep = torch.repeat_interleave(torch.arange(e0, e1, device=dev), lens)
            first = torch.cumsum(lens, 0) - lens
            src = b_start[rep] + (torch.arange(rep.numel(), device=dev) - first[rep - e0])
            src = src.clamp(0, g["chunk_cap"] - 1)
            p_col = Bst.indices[:, j].long()[b[rep], src]
            p_val = v_[rep] * Bst.data[:, j][b[rep], src]
            accumulate(vals, key(s_[rep], r_[rep], p_col), p_val)
        accumulate(vals, prev_keys, prev_vals)
        prev_keys, prev_vals = keys, vals
    strip = keys // per_strip
    row = (keys % per_strip) // n_cols
    counts = torch.bincount(strip * strip_rows + row, minlength=n_strips * strip_rows)
    indptr = torch.zeros(n_strips, strip_rows + 1, dtype=torch.int64, device=dev)
    indptr[:, 1:] = torch.cumsum(counts.view(n_strips, strip_rows), 1)
    start = torch.zeros(n_strips, dtype=torch.int64, device=dev)
    start[1:] = torch.cumsum(indptr[:, -1], 0)[:-1]
    pos = torch.arange(keys.numel(), device=dev) - start[strip]
    indices = torch.zeros(n_strips, c_cap, dtype=torch.int32, device=dev)
    data = torch.zeros(n_strips, c_cap, dtype=Bst.data.dtype, device=dev)
    indices[strip, pos] = (keys % n_cols).to(torch.int32)
    data[strip, pos] = vals
    shape = lambda t: t.reshape(batch, n_ac, t.shape[-1])  # noqa: E731
    return shape(indptr.to(torch.int32)), shape(indices), shape(data)


def masked_entry_products(Ast: CSR, Bst: CSR, r0s, r1s):
    """The products each A entry of a stacked A makes with the B chunks that
    hold its column, as the kernel walks them (B rows cut at B's
    ``max_row_nnz``): ``(valid, row, products)``, each ``[S, a_cap]``."""
    ip = Ast.indptr.reshape(-1, Ast.indptr.shape[-1]).contiguous()
    pos = torch.arange(Ast.indices.shape[-1], device=ip.device, dtype=ip.dtype)
    pos = pos.expand(ip.shape[0], -1).contiguous()
    valid, row = pos < ip[:, -1:], torch.searchsorted(ip, pos, right=True).long() - 1
    n_strips, n_ac = valid.shape[0], Ast.indptr.shape[1]
    ix = Ast.indices.reshape(n_strips, -1).long()
    b = (torch.arange(n_strips, device=ix.device) // n_ac)[:, None]
    products = torch.zeros_like(ix)
    r0s = [int(v) for v in torch.as_tensor(r0s).tolist()]
    r1s = [int(v) for v in torch.as_tensor(r1s).tolist()]
    for j, (r0, r1) in enumerate(zip(r0s, r1s)):
        b_ptr = Bst.indptr[:, j].long()
        b_row = (ix - r0).clamp(0, Bst.n_rows - 1)
        lens = (b_ptr[b, b_row + 1] - b_ptr[b, b_row]).clamp(0, max(Bst.max_row_nnz, 0))
        products += torch.where(valid & (ix >= r0) & (ix < r1), lens, 0)
    return valid, row, products


def masked_part_size(products: int, n_sm: int) -> int:
    """Products a part may hold: the call's ``products`` spread over
    ``MASKED_PARTS_PER_SM`` parts an SM, at least ``MASKED_PART_MIN``."""
    return max(MASKED_PART_MIN, -(-int(products) // (max(int(n_sm), 1) * MASKED_PARTS_PER_SM)))


class MaskedWork(NamedTuple):
    """The masked kernel's parts, heaviest first: each the global strip row
    ``row``, its A entry range ``[e0, e1)`` (entry slots of the row's strip),
    its ``products``, and whether it is its row's ``first`` and ``only``
    part; ``part_size`` is the size the rows were cut at."""
    row: torch.Tensor
    e0: torch.Tensor
    e1: torch.Tensor
    products: torch.Tensor
    first: torch.Tensor
    only: torch.Tensor
    part_size: int


def masked_work(Ast: CSR, Bst: CSR, Mst: CSR, r0s, r1s, n_sm: int,
                part_size: int | None = None) -> MaskedWork:
    """Cut the rows of a masked call into parts by products.

    Every row with a nonempty mask row gets parts that cover its A entries,
    each A entry in exactly one part. A row of at most ``part_size``
    products (:func:`masked_part_size` of the call's products and ``n_sm``,
    unless given) is one part. A longer row is cut at every ``window``
    products of its running sum, ``part_size`` less the most products one
    A entry can make (B's ``max_row_nnz``), at least half the part size;
    an A entry of more than ``part_size - window`` products is a part of
    its own. So no part exceeds ``part_size`` unless it is a single A
    entry. A row with no A entry is one empty part. Built with tensor ops
    on the operands' device; the host reads the call's products and the
    number of parts."""
    valid, row, products = masked_entry_products(Ast, Bst, r0s, r1s)
    n_strips, a_cap = valid.shape
    strip_rows = Ast.indptr.shape[-1] - 1
    dev = row.device
    counts = _mask_row_counts(Mst)
    n_rows = counts.numel()
    g = torch.arange(n_strips, device=dev)[:, None] * strip_rows + row
    keep = valid & (counts[g.clamp(0, max(n_rows - 1, 0))] > 0)
    at = torch.nonzero(keep.flatten()).flatten()   # entry slots of masked rows, in order
    gk, ek, pk = g.flatten()[at], at % max(a_cap, 1), products.flatten()[at]
    if part_size is None:
        part_size = masked_part_size(int(pk.sum()), n_sm)
    # cut every `window` products of a row's running sum; an entry of more
    # than part_size - window products is a part of its own, so a part's
    # products stay below window + (part_size - window)
    window = max(int(part_size) - max(Bst.max_row_nnz, 0), (int(part_size) + 1) // 2, 1)
    total = torch.zeros(n_rows, dtype=torch.int64, device=dev).index_add_(0, gk, pk)
    new_row = torch.ones_like(gk, dtype=torch.bool)
    new_row[1:] = gk[1:] != gk[:-1]
    incl = torch.cumsum(pk, 0)
    excl = incl - pk
    # the running sum within the row: less the sum at the row's first entry
    row_base = torch.zeros(n_rows, dtype=torch.int64, device=dev)
    row_excl = excl - row_base.index_add_(0, gk, torch.where(new_row, excl, 0))[gk]
    split = total[gk] > part_size
    big = split & (pk > part_size - window)
    cut = torch.where(split, row_excl // window, 0)
    boundary = new_row | big
    boundary[1:] |= (cut[1:] != cut[:-1]) | big[:-1]
    # rows with a mask row and no A entry: one empty part at the row's start
    has_entries = torch.zeros(n_rows, dtype=torch.bool, device=dev)
    has_entries[gk] = True
    bare = torch.nonzero((counts > 0) & ~has_entries).flatten()
    heads = torch.nonzero(boundary).flatten()   # each part's first entry
    tails = torch.cat([heads[1:], heads.new_tensor([gk.numel()])]) - 1
    p_row, p_e0, p_e1 = gk[heads], ek[heads], ek[tails] + 1
    p_prod = incl[tails] - excl[heads]
    p_first = new_row[heads]
    ip = Ast.indptr.reshape(-1, strip_rows + 1).long()
    start = ip[bare // strip_rows, bare % strip_rows].clamp(max=a_cap)
    p_row = torch.cat([p_row, bare])
    p_e0, p_e1 = torch.cat([p_e0, start]), torch.cat([p_e1, start])
    p_prod = torch.cat([p_prod, torch.zeros_like(bare)])
    p_first = torch.cat([p_first, torch.ones_like(bare, dtype=torch.bool)])
    per_row = torch.zeros(n_rows, dtype=torch.int64, device=dev)
    p_only = per_row.index_add_(0, p_row, torch.ones_like(p_row))[p_row] == 1
    order = torch.sort(p_prod, descending=True, stable=True).indices
    return MaskedWork(p_row[order], p_e0[order], p_e1[order], p_prod[order],
                      p_first[order], p_only[order], int(part_size))


def _block_threads(slots: int) -> int:
    """A block team's threads: MASKED_BLOCK_THREADS, or 1,024 where its
    table leaves room for one block an SM only."""
    return 1024 if slots * 8 > SMEM_PER_BLOCK // 2 else MASKED_BLOCK_THREADS


class MaskedLaunches(NamedTuple):
    """The parts in launch order (by team, then table size; heaviest first
    within a launch): ``parts`` int32 ``[n, 4]`` (row, e0, e1, flags),
    ``pglob`` int32 (a global part's index among the global rows, else -1),
    each part's table ``slots`` and ``products``; the global rows ``grows``
    (int32) and their tables' offsets ``goff`` (int64, one longer, packed);
    ``groups``,
    one launch each: (team code, table slots, parts, threads), the slots 0
    for the global parts' one launch."""
    parts: torch.Tensor
    pglob: torch.Tensor
    slots: torch.Tensor
    products: torch.Tensor
    grows: torch.Tensor
    goff: torch.Tensor
    groups: list


def masked_launches(work: MaskedWork, Mst: CSR) -> MaskedLaunches:
    """Group a call's parts into the kernel's launches: each part's table is
    :func:`masked_table_slots` of its row's mask nnz, its team follows that
    table and its products (the rule above); one launch per team and table
    size, each reserving exactly that table, and one for the global parts.
    The host reads the distinct mask row sizes and the launches."""
    counts = _mask_row_counts(Mst)
    dev = counts.device
    uniq, inv = torch.unique(counts[work.row], return_inverse=True)
    slots = torch.tensor([masked_table_slots(c) for c in uniq.tolist()], dtype=torch.int64,
                         device=dev)[inv]
    team = torch.where((slots <= MASKED_WARP_TABLE_MAX)
                       & (work.products <= MASKED_WARP_PRODUCTS), 0, 1)
    team = torch.where(slots > MASKED_SHARED_MAX, 2, team)
    key = team * (1 << 40) + torch.where(team == 2, 0, slots)   # one launch of global parts
    order = torch.sort(key, stable=True).indices
    key, slots, team = key[order], slots[order], team[order]
    flags = (work.first.long() * _MASKED_FIRST + work.only.long() * _MASKED_ONLY)[order]
    rows = work.row[order]
    parts = torch.stack([rows, work.e0[order], work.e1[order], flags], 1).to(torch.int32)
    groups = []
    if key.numel():
        _, sizes = torch.unique_consecutive(key, return_counts=True)
        starts = torch.cumsum(sizes, 0) - sizes
        for t, sl, n in zip(*torch.stack([team[starts], slots[starts], sizes]).tolist()):
            threads = (MASKED_WARP_THREADS if t == 0 else
                       _block_threads(sl) if t == 1 else MASKED_BLOCK_THREADS)
            groups.append((t, sl if t < 2 else 0, n, threads))
    n_glob = groups[-1][2] if groups and groups[-1][0] == 2 else 0
    pglob = torch.full_like(rows, -1)
    grows, ginv = torch.unique(rows[rows.numel() - n_glob:], return_inverse=True)
    pglob[rows.numel() - n_glob:] = ginv
    gslots = torch.zeros(grows.numel(), dtype=torch.int64, device=dev)
    gslots[ginv] = slots[rows.numel() - n_glob:]
    goff = torch.zeros(grows.numel() + 1, dtype=torch.int64, device=dev)
    goff[1:] = torch.cumsum(gslots, 0)
    return MaskedLaunches(parts, pglob.to(torch.int32), slots, work.products[order],
                          grows.to(torch.int32), goff, groups)


def masked_plan(Ast: CSR, Bst: CSR, Mst: CSR, r0s, r1s, device=None) -> tuple:
    """``(work, launches)`` of a masked call on the card ``device`` (A's by
    default), cut for its SM count, on the operands' device (all on the
    host where they span the host and the card: ``csr_on_one_device``)."""
    dev = Ast.indptr.device if device is None else device
    Ast, Bst, Mst = csr_on_one_device(Ast, Bst, Mst)
    work = masked_work(Ast, Bst, Mst, r0s, r1s,
                       torch.cuda.get_device_properties(dev).multi_processor_count)
    return work, masked_launches(work, Mst)


def masked_kernels_per_call(Ast: CSR, Bst: CSR, Mst: CSR, r0s, r1s, order: str) -> int:
    """Kernels one call of the masked wrapper launches on the card: one a
    launch group, once (chunk1) or once a chunk (chunk2), and the global
    rows' seed and gather when there are any."""
    _, launches = masked_plan(Ast, Bst, Mst, r0s, r1s)
    steps = Bst.indptr.shape[1] if order == "chunk2" else 1
    return len(launches.groups) * steps + (2 if launches.grows.numel() else 0)


def hash_masked_accum_spgemm_stream(Ast: CSR, Bst: CSR, C0st: CSR, Mst: CSR,
                                    r0s, r1s, *, order: str, table_size: int,
                                    device=None):
    """Streamed mask-fused hash multiply over stacked CSR strips and chunks:
    ``C = ((A[:, r0:r1] x B) + C_prev) ∘ M`` per strip, the output structure
    exactly the mask's (explicit zeros where no product lands).

    Operands as in :func:`hash_accum_spgemm_stream`, plus ``Mst``, the mask's
    stacked strips (leading ``[batch, n_ac]`` axes, the strip shape of
    ``C0st``); ``table_size`` is ``hash_table_slots`` of the densest mask
    row, as in the reference. On the card the rows are cut into parts by
    products (:func:`masked_work`) and each row's table is sized from its own
    mask nnz instead (:func:`masked_launches`). ``device`` is as in
    :func:`hash_accum_spgemm_stream`: the plain version on the host, the
    kernel on the card, reading an operand in pinned host memory in place
    (the work list cut on the host then, and shipped to the card). The
    output is in ``C0st``'s space.
    """
    g = stack_geometry(Ast, Bst, C0st, order)
    T = _check_table(table_size)
    if tuple(Mst.indptr.shape) != tuple(C0st.indptr.shape) or Mst.shape != C0st.shape:
        raise ValueError(f"mask stack {tuple(Mst.indptr.shape)} {Mst.shape} does "
                         f"not match the output strips {tuple(C0st.indptr.shape)} "
                         f"{C0st.shape}")
    dev = kernel_device("hash_masked_accum_spgemm_stream", device, Ast, Bst, C0st, Mst)
    if dev is None:
        return hash_masked_plain(Ast, Bst, C0st, Mst, r0s, r1s, order=order,
                                 table_size=T)
    check_mask(Mst, g["c_cap"], T)
    _, plan = masked_plan(Ast, Bst, Mst, r0s, r1s, dev)
    plan = plan._replace(**{f: getattr(plan, f).to(dev)
                            for f in ("parts", "pglob", "grows", "goff")})
    r0s = torch.as_tensor(r0s, dtype=torch.int32).to(dev)
    r1s = torch.as_tensor(r1s, dtype=torch.int32).to(dev)
    for st, what in ((Ast, "A"), (Bst, "B"), (C0st, "C0"), (Mst, "M")):
        require(st.indptr, f"{what}.indptr", torch.int32, dev, in_place=True)
        require(st.indices, f"{what}.indices", torch.int32, dev, in_place=True)
        if what != "M":
            require(st.data, f"{what}.data", torch.float32, dev, in_place=True)
    n_grows = plan.grows.numel()
    if n_grows > 65535:
        raise ValueError(f"{n_grows} rows need a global table; the seed and gather "
                         "grids take at most 65,535")
    gslots, grow_max_nnz = 1, 0
    if n_grows:
        counts = _mask_row_counts(Mst)
        gslots, grow_max_nnz = (int(plan.goff[-1]),
                                int(counts[plan.grows.to(counts.device).long()].max()))
    gkeys = torch.full((gslots,), _EMPTY, dtype=torch.int32, device=dev)
    gvals = torch.zeros(gslots, dtype=torch.float32, device=dev)
    out_ip = alloc_like(C0st.indptr).copy_(Mst.indptr)
    out_ix = alloc_like(C0st.indices, zero=True)
    out_d = alloc_like(C0st.data, zero=True)
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    groups = torch.tensor(plan.groups, dtype=torch.int32).reshape(-1, 4)
    def nonempty(t):   # a pointer the launch may pass but never reads
        return t if t.numel() else torch.zeros(4, dtype=t.dtype, device=t.device)
    operands = [pointer(t) for st in (Ast, Bst, C0st) for t in (st.indptr, st.indices, st.data)]
    launch("hash_masked_accum_spgemm", "hash_masked_accum_launch",
           [*operands, r0s, r1s, pointer(Mst.indptr), pointer(Mst.indices),
            nonempty(plan.parts), nonempty(plan.pglob), nonempty(plan.grows), plan.goff,
            gkeys, gvals, pointer(out_ix), pointer(out_d), overflow, nonempty(groups)],
           [g["batch"], g["n_ac"], g["n_b"], g["strip_rows"], g["chunk_rows"],
            g["a_cap"], g["chunk_cap"], g["c_cap"], Ast.max_row_nnz,
            Bst.max_row_nnz, Mst.indices.shape[-1], ("chunk1", "chunk2").index(order) + 1,
            len(plan.groups), n_grows, grow_max_nnz])
    MASKED_LAUNCHES.bump()
    if reads_host(Ast, Bst, C0st, Mst):
        MASKED_IN_PLACE.bump()
    if int(overflow.item()):
        raise RuntimeError("hash_masked_accum_launch: a mask key found no slot "
                           "or an output position left its capacity")
    return out_ip, out_ix, out_d
