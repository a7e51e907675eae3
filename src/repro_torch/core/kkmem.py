"""KKMEM-style two-phase SpGEMM in plain PyTorch (the paper's baseline, §2.1).

KKMEM assigns rows of A to threads and multiplications within a row to vector lanes,
accumulating into sparse hashmap accumulators. This module keeps the *two-phase*
row-wise structure and realizes the accumulator as **sort + segment-reduce** over
the expanded product stream — the same multiset-union semantics, vectorized:

  expand:     every nonzero a_ik fans out into products with B's row k
              (the access pattern of Fig. 1 — A streamed, B gathered)
  accumulate: two stable sorts bring duplicate (row, col) products together;
              a boundary scan + scatter-add coalesces them (== hashmap insert)

The product buffer has capacity nnzA_pad x B.max_row_nnz; the output CSR has a
caller-provided capacity from the symbolic phase. Everything runs on the
operands' device.

``spgemm_ranged_impl`` is the paper's *modified KKMEM sub-procedure* used by the
chunked algorithms: it multiplies only the columns of A inside a B-row-range
[r0, r1) ("skip any columns of A outside of this range" — §3.2.2) and *fuses the
previous partial C into the accumulation*, i.e. C^t = A_t x B_t + C^{t-1}.
It is also the plain version of the ESC kernel
(``repro_torch.kernels.sparse_accum_spgemm``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.sparse.csr import CSR, csr_row_of_entry


@dataclasses.dataclass(frozen=True)
class SpGEMMWorkspace:
    """Output of the symbolic phase: capacities for the numeric phase."""

    c_nnz: int          # exact nnz of C
    c_pad: int          # padded capacity (>= c_nnz)
    c_max_row_nnz: int  # densest row of C
    flops: int          # 2 * (number of scalar products)


# ---------------------------------------------------------------------------
# symbolic phase (host, NumPy — the paper computes structure ahead of numerics)
# ---------------------------------------------------------------------------


def spgemm_symbolic_host(A: CSR, B: CSR, pad_multiple: int = 64) -> SpGEMMWorkspace:
    """Exact structure of C = A x B on host: nnz, densest row, flops."""
    from repro_torch.core.symbolic import spgemm_structure_host

    s = spgemm_structure_host(A, B)
    return SpGEMMWorkspace(
        c_nnz=s.c_nnz,
        c_pad=-(-max(s.c_nnz, 1) // pad_multiple) * pad_multiple,
        c_max_row_nnz=s.c_max_row_nnz,
        flops=s.flops,
    )


# ---------------------------------------------------------------------------
# numeric phase
# ---------------------------------------------------------------------------


def _expand_products(A: CSR, B: CSR, r0, r1):
    """Fan every (valid, in-range) A entry out into its products with B's rows.

    Returns int64 rows, int64 cols and values, each of length
    nnzA_pad * B.max_row_nnz; invalid slots get row = A.n_rows (sorts to the
    tail) and val = 0.

    ``r0, r1`` bound the *global* column range of A handled by this call; B is the
    CSR of exactly that row range (local row r_global - r0). For the unchunked case
    pass r0=0, r1=A.n_cols with B the full matrix.
    """
    bmax = max(B.max_row_nnz, 1)
    dev = A.device
    t = torch.arange(A.nnz_pad, device=dev)
    row_a = csr_row_of_entry(A)
    col_a = A.indices.long()
    valid_t = t < A.indptr[-1]
    in_range = (col_a >= r0) & (col_a < r1) & valid_t
    b_ptr = B.indptr.long()
    b_row = (col_a - r0).clamp(0, B.n_rows - 1)
    b_start = b_ptr[b_row]
    b_len = b_ptr[b_row + 1] - b_start
    j = torch.arange(bmax, device=dev)
    valid = in_range[:, None] & (j[None, :] < b_len[:, None])
    src = (b_start[:, None] + j[None, :]).clamp(0, B.nnz_pad - 1)
    cols = torch.where(valid, B.indices.long()[src], 0)
    vals = torch.where(valid, A.data[:, None] * B.data[src],
                       torch.zeros((), dtype=A.dtype, device=dev))
    rows = torch.where(valid, row_a[:, None], A.n_rows)
    return rows.reshape(-1), cols.reshape(-1), vals.reshape(-1)


def _accumulate(rows, cols, vals, m: int, _n: int, c_pad: int):
    """Sort-based accumulator: coalesce duplicate (row, col) into CSR arrays.

    Two stable sorts == lexsort by (row, col). The boundary scan assigns each
    distinct key a dense output slot; the slots run in order, so a segmented
    sum over them (``segment_reduce``) realizes the "hashmap" accumulation
    in a fixed order on the card too, where ``scatter_add_``'s atomics sum a
    slot's values in whatever order they land (two calls on the same pieces
    then differ in their last bits); ``scatter_reduce_`` (amax/amin) places
    columns and rows.
    Slots past ``c_pad`` fall into a dropped bucket. Returns int32
    indptr[m+1], int32 indices[c_pad], data[c_pad].
    """
    dev = vals.device
    order_c = torch.sort(cols, stable=True).indices
    rows_c, cols_c, vals_c = rows[order_c], cols[order_c], vals[order_c]
    order_r = torch.sort(rows_c, stable=True).indices
    rows_s, cols_s, vals_s = rows_c[order_r], cols_c[order_r], vals_c[order_r]
    valid = rows_s < m
    new_key = torch.ones_like(valid)
    new_key[1:] = (rows_s[1:] != rows_s[:-1]) | (cols_s[1:] != cols_s[:-1])
    new_key &= valid
    slot = torch.cumsum(new_key, 0) - 1
    slot = torch.where(valid, slot.clamp(max=c_pad), c_pad)
    lengths = torch.bincount(slot, minlength=c_pad + 1)
    data = torch.segment_reduce(vals_s, "sum", lengths=lengths, unsafe=True, initial=0)
    indices = torch.zeros(c_pad + 1, dtype=torch.int64, device=dev)
    indices.scatter_reduce_(0, slot, torch.where(valid, cols_s, 0), "amax")
    out_rows = torch.full((c_pad + 1,), m, dtype=torch.int64, device=dev)
    out_rows.scatter_reduce_(0, slot, torch.where(valid, rows_s, m), "amin")
    # rows are sorted ascending over slots -> indptr by binary search
    indptr = torch.searchsorted(out_rows[:c_pad].contiguous(),
                                torch.arange(m + 1, device=dev))
    return (indptr.to(torch.int32), indices[:c_pad].to(torch.int32),
            data[:c_pad].contiguous())


def spgemm(A: CSR, B: CSR, c_pad: int, c_max_row_nnz: int = 0) -> CSR:
    """Numeric phase of C = A x B. ``c_pad`` comes from ``spgemm_symbolic_host``."""
    rows, cols, vals = _expand_products(A, B, 0, A.n_cols)
    indptr, indices, data = _accumulate(rows, cols, vals, A.n_rows, B.n_cols, c_pad)
    return CSR(indptr, indices, data, (A.n_rows, B.n_cols),
               c_max_row_nnz or c_pad)


def spgemm_ranged_impl(A: CSR, B_chunk: CSR, r0, r1, C_prev: CSR, c_pad: int,
                       c_max_row_nnz: int = 0) -> CSR:
    """Fused multiply-add over a B row-range: C = A[:, r0:r1] x B_chunk + C_prev.

    The previous partial result's entries join the product stream before
    accumulation — the paper's fused-add into the hashmap accumulators. A is NOT
    physically column-partitioned; out-of-range entries are masked ("skipped").
    """
    rows, cols, vals = _expand_products(A, B_chunk, r0, r1)
    dev = A.device
    prev_entry = torch.arange(C_prev.nnz_pad, device=dev)
    prev_valid = prev_entry < C_prev.indptr[-1]
    prev_rows = torch.where(prev_valid, csr_row_of_entry(C_prev), A.n_rows)
    prev_cols = torch.where(prev_valid, C_prev.indices.long(), 0)
    prev_vals = torch.where(prev_valid, C_prev.data,
                            torch.zeros((), dtype=C_prev.dtype, device=dev))
    rows = torch.cat([rows, prev_rows])
    cols = torch.cat([cols, prev_cols])
    vals = torch.cat([vals, prev_vals])
    indptr, indices, data = _accumulate(rows, cols, vals, A.n_rows, B_chunk.n_cols, c_pad)
    return CSR(indptr, indices, data, (A.n_rows, B_chunk.n_cols),
               c_max_row_nnz or c_pad)


# the loop executors' entry point (the reference jits it; PyTorch runs eagerly)
spgemm_ranged = spgemm_ranged_impl


def spgemm_full(A: CSR, B: CSR) -> CSR:
    """Convenience: symbolic + numeric in one call."""
    ws = spgemm_symbolic_host(A, B)
    return spgemm(A, B, ws.c_pad, ws.c_max_row_nnz)


# ---------------------------------------------------------------------------
# reference oracle
# ---------------------------------------------------------------------------


def spgemm_dense_oracle(A: CSR, B: CSR) -> torch.Tensor:
    """Trustworthy dense reference: densify and matmul."""
    from repro_torch.sparse.csr import csr_to_dense

    return csr_to_dense(A) @ csr_to_dense(B)
