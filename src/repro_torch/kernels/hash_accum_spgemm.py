"""CSR-output ranged SpGEMM with a linear-probing hash accumulator.

The port of the JAX package's ``hash_accum_spgemm_stream`` and its merge
``hash_merge_impl``: each strip row owns a power-of-two table of
``table_size = planner.hash_table_slots(c_max_row_nnz)`` slots keyed by
column, probed from Knuth's multiplicative hash ``col * 2654435769 mod 2^32``
masked by ``table_size - 1``, at most :func:`probe_step_bound` steps;
extraction sorts each row by column into the fixed-capacity CSR scratch —
the same output as the ESC merge.

On the card this is the CUDA kernel ``csrc/hash_accum_spgemm.cu`` over the
skeleton it shares with the ESC kernel; on the CPU the wrapper runs
:func:`hash_accum_plain`, which keeps the reference's steps (fresh tables per
chunk, products inserted in entry order, then ``C_prev``, sort on extract),
vectorized across rows, so a table-capacity or probe fault shows on the CPU
too.

The mask-fused variant, ``hash_masked_accum_spgemm_stream`` (the port of
``hash_masked_merge_impl``), seeds every row's table from the mask row and
accumulates probe-only, so C's structure is the mask's: the fused path of
triangle counting. On the card it is ``csrc/hash_masked_accum_spgemm.cu``,
whose tables are sized per row; on the CPU :func:`hash_masked_plain`.
"""

from __future__ import annotations

import torch

from repro_torch.core.planner import hash_table_slots
from repro_torch.kernels._build import LaunchCounter, launch, require
from repro_torch.kernels.sparse_accum_spgemm import (
    SMEM_PER_BLOCK, launch_csr_accum, stack_geometry,
)
from repro_torch.sparse.csr import CSR

LAUNCHES = LaunchCounter()
MASKED_LAUNCHES = LaunchCounter()
_EMPTY = -1           # table key sentinel (column ids are >= 0)
_KNUTH = 2654435769   # Knuth's multiplicative hash constant (2^32 / phi)


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


def hash_accum_spgemm_stream(Ast: CSR, Bst: CSR, C0st: CSR, r0s, r1s, *,
                             order: str, table_size: int):
    """Streamed hash-accumulated multiply over stacked CSR strips and chunks.

    Operand layout, streaming orders and the returned stacked CSR triple are
    those of ``sparse_accum_spgemm_stream``; ``table_size`` is the per-row
    hash-table slot count, ``planner.hash_table_slots`` of the symbolic
    ``c_max_row_nnz``. CPU tensors take the plain version; CUDA tensors
    launch the kernel.
    """
    T = _check_table(table_size)
    if Ast.indptr.device.type == "cpu":
        return hash_accum_plain(Ast, Bst, C0st, r0s, r1s, order=order,
                                table_size=T)
    return launch_csr_accum("hash_accum_spgemm", "hash_accum_launch", LAUNCHES,
                            Ast, Bst, C0st, r0s, r1s, order=order, row_cap=T,
                            work_cap=0, smem_per_warp=-(-T * 8 // 16) * 16)


# ---------------------------------------------------------------------------
# mask-fused variant: tables seeded from the mask, probe-only accumulation
# ---------------------------------------------------------------------------

# The masked kernel's per-row table: a power of two of at least twice the
# row's mask nnz. Probe-only lookups mostly miss (at graph scale 7 of 8
# products fall outside the mask), and a linear-probing miss scans to the
# next empty slot, so the load factor is held at 1/2 or below.
def masked_table_slots(mask_row_nnz: int) -> int:
    return hash_table_slots(2 * int(mask_row_nnz))


# Row bins of the masked kernel by table size: (largest table slots, team,
# table memory). A "warp" team is one warp per row with a table of the bin's
# largest size in shared memory; a "block" team is one block of
# MASKED_BLOCK_THREADS threads per row, its table in shared memory while it
# fits a block (16,384 slots of 8 bytes, 128 KiB), in global memory above.
MASKED_BLOCK_THREADS = 512
MASKED_BINS = ((64, "warp", "shared"), (512, "warp", "shared"),
               (2048, "warp", "shared"), (16384, "block", "shared"),
               (None, "block", "global"))
assert MASKED_BINS[3][0] * 8 <= SMEM_PER_BLOCK
_MASKED_SMEM_TARGET = 96 * 1024   # per-block shared-memory target of warp bins
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


def masked_bins(Mst: CSR):
    """The masked kernel's row bins and tables: ``(rows, goff, meta,
    global_slots)``.

    ``rows`` (int32) holds the global strip rows bin after bin, each bin in
    row order; ``goff`` (int64, one longer) is the exclusive prefix sum of
    their tables' slots, :func:`masked_table_slots` of each row's mask nnz,
    so the row at position ``t`` has a table of ``goff[t + 1] - goff[t]``
    slots: the kernel takes every table's size from here. A row goes to the
    first of :data:`MASKED_BINS` whose largest table holds its own; ``meta``
    gives each bin as ``(rows, slots reserved per team in shared memory, or 0
    for the global bin, warps per block)``; the global bin's tables are
    packed at ``goff[t] - goff[first global row]``, ``global_slots`` in all.
    Rows with an empty mask row are in no bin: their output row is empty."""
    counts = _mask_row_counts(Mst)
    dev = counts.device
    uniq, inv = torch.unique(counts, return_inverse=True)
    slots = torch.tensor([masked_table_slots(c) if c else 0 for c in uniq.tolist()],
                         dtype=torch.int64, device=dev)[inv]
    rows, meta, lo = [], [], 1
    for hi, team, where in MASKED_BINS:
        sel = slots >= lo if hi is None else (slots >= lo) & (slots <= hi)
        r = torch.nonzero(sel).flatten()
        rows.append(r)
        if where == "shared":
            warps = (max(1, min(8, _MASKED_SMEM_TARGET // (hi * 8)))
                     if team == "warp" else MASKED_BLOCK_THREADS // 32)
            meta.append((r.numel(), hi, warps))
            lo = hi + 1
        else:
            meta.append((r.numel(), 0, MASKED_BLOCK_THREADS // 32))
    rows = torch.cat(rows)
    goff = torch.zeros(rows.numel() + 1, dtype=torch.int64, device=dev)
    goff[1:] = torch.cumsum(slots[rows], 0)
    global_slots = int(goff[-1] - goff[rows.numel() - meta[-1][0]])
    return rows.to(torch.int32), goff, meta, global_slots


def hash_masked_accum_spgemm_stream(Ast: CSR, Bst: CSR, C0st: CSR, Mst: CSR,
                                    r0s, r1s, *, order: str, table_size: int):
    """Streamed mask-fused hash multiply over stacked CSR strips and chunks:
    ``C = ((A[:, r0:r1] x B) + C_prev) ∘ M`` per strip, the output structure
    exactly the mask's (explicit zeros where no product lands).

    Operands as in :func:`hash_accum_spgemm_stream`, plus ``Mst``, the mask's
    stacked strips (leading ``[batch, n_ac]`` axes, the strip shape of
    ``C0st``); ``table_size`` is ``hash_table_slots`` of the densest mask
    row, as in the reference. On the card each row's table is sized from
    that row's own mask nnz instead (:func:`masked_bins`). CPU tensors take the plain
    version; CUDA tensors launch the kernel.
    """
    g = stack_geometry(Ast, Bst, C0st, order)
    T = _check_table(table_size)
    if tuple(Mst.indptr.shape) != tuple(C0st.indptr.shape) or Mst.shape != C0st.shape:
        raise ValueError(f"mask stack {tuple(Mst.indptr.shape)} {Mst.shape} does "
                         f"not match the output strips {tuple(C0st.indptr.shape)} "
                         f"{C0st.shape}")
    if Ast.indptr.device.type == "cpu":
        return hash_masked_plain(Ast, Bst, C0st, Mst, r0s, r1s, order=order,
                                 table_size=T)
    check_mask(Mst, g["c_cap"], T)
    dev = Ast.indptr.device
    r0s = torch.as_tensor(r0s, dtype=torch.int32).to(dev)
    r1s = torch.as_tensor(r1s, dtype=torch.int32).to(dev)
    for st, what in ((Ast, "A"), (Bst, "B"), (C0st, "C0"), (Mst, "M")):
        require(st.indptr, f"{what}.indptr", torch.int32, dev)
        require(st.indices, f"{what}.indices", torch.int32, dev)
        if what != "M":
            require(st.data, f"{what}.data", torch.float32, dev)
    rows, goff, meta, global_slots = masked_bins(Mst)
    gkeys = torch.empty(max(global_slots, 1), dtype=torch.int32, device=dev)
    gvals = torch.empty(max(global_slots, 1), dtype=torch.float32, device=dev)
    out_ip = Mst.indptr.clone()
    out_ix = torch.zeros_like(C0st.indices)
    out_d = torch.zeros_like(C0st.data)
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    rows = rows if rows.numel() else torch.zeros(1, dtype=torch.int32, device=dev)
    launch("hash_masked_accum_spgemm", "hash_masked_accum_launch",
           [Ast.indptr, Ast.indices, Ast.data, Bst.indptr, Bst.indices, Bst.data,
            C0st.indptr, C0st.indices, C0st.data, r0s, r1s, Mst.indptr,
            Mst.indices, rows, goff, gkeys, gvals, out_ix, out_d, overflow],
           [g["batch"], g["n_ac"], g["n_b"], g["strip_rows"], g["chunk_rows"],
            g["a_cap"], g["chunk_cap"], g["c_cap"], Ast.max_row_nnz,
            Bst.max_row_nnz, Mst.indices.shape[-1], ("chunk1", "chunk2").index(order) + 1,
            *(v for m in meta for v in m)])
    MASKED_LAUNCHES.bump()
    if int(overflow.item()):
        raise RuntimeError("hash_masked_accum_launch: a mask key found no slot "
                           "or an output position left its capacity")
    return out_ip, out_ix, out_d
