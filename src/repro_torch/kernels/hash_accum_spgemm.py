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
"""

from __future__ import annotations

import torch

from repro_torch.core.planner import hash_table_slots
from repro_torch.kernels._build import LaunchCounter
from repro_torch.kernels.sparse_accum_spgemm import (
    launch_csr_accum, stack_geometry,
)
from repro_torch.sparse.csr import CSR

LAUNCHES = LaunchCounter()
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
