"""Bytes the streaming kernels touch of each operand in one launch: the
traffic an operand read in place from pinned host memory puts on the link.

Beside :mod:`repro_torch.kernels.copy_events`, which models the copies that
stage pieces into fast memory, this models the other route
(``slow_reads="in_place"``): no piece is staged, and every read of a slow
operand crosses the link as the kernel makes it. The counts follow the
kernels' own loops, reckoned on the host from the operands (no kernel runs):

* The CSR accumulators (``csrc/csr_accum.cuh``: ESC and hash, one warp a
  row). A launch reads each row's indptr pair of A, then for every chunk
  walks the row's A entries (their columns; the values of the in-range
  ones). Every in-range A entry reads the indptr pair of its B row and the
  row's entries (column and value, cut at B's ``max_row_nnz``). C_prev is
  read once (an indptr pair a row and its entries), and C is written once:
  its indptr, which the copy pass reads back, and every slot up to the
  capacity ``c_cap`` (entries, then zeros). Chunk2 launches once a chunk, so
  A's indptr pairs are read once a chunk.
* The masked kernel: A and B as above; each step reads every masked row's
  mask (an indptr pair and its columns) to seed the tables, C_prev once,
  and writes every mask entry of C (chunk2: each chunk, reading the last
  chunk's back).
* The dense slab (``ranged_spgemm.cu``: 128 x 128 tiles of C): every strip's
  chunk columns of A once for each 128-column tile of C, every B slab once
  for each 128-row tile of a strip, and C read (C_prev, then the last
  chunk's output) and written once a chunk.

The in-place executors launch once a strip of the plan, so a call's reads
are the sum of its strip launches'. Every term above is a sum over rows,
entries or strips (A's indptr pairs a row, read once a strip launch or
once a chunk of it in Chunk2; B's rows an in-range A entry; C a strip), so
the strip launches read what one launch over the whole stack would: no
term changes, and the functions below may be given either.

Each is a model: the card may cache a read it repeats, and a read moves at
least a 32-byte sector. It is printed beside a measured time, never held as
a measurement.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.sparse_accum_spgemm import stack_geometry
from repro_torch.sparse.csr import CSR

TILE = 128   # the dense slab's output tile edge (ranged_spgemm.cu: BM = BN)


def _rows_and_entries(st: CSR, cap: int) -> tuple:
    """(rows, live entries) of a stacked CSR, each element's indptr clamped
    to its capacity ``cap``."""
    ip = st.indptr.reshape(-1, st.indptr.shape[-1]).long()
    return ip.shape[0] * (ip.shape[1] - 1), int(ip[:, -1].clamp(0, cap).sum())


def _in_range(Ast: CSR, Bst: CSR, r0s, r1s, g: dict) -> tuple:
    """(in-range A entries, their products): over every chunk, the A
    entries whose column lies in the chunk's rows, and the entries of the B
    rows they read (cut at B's ``max_row_nnz``)."""
    S, a_cap = g["batch"] * g["n_ac"], g["a_cap"]
    ip = Ast.indptr.reshape(S, -1).long().clamp(max=a_cap)
    slot = torch.arange(a_cap, device=ip.device).expand(S, a_cap)
    live = slot < ip[:, -1:]
    col = Ast.indices.reshape(S, a_cap).long()
    inst = (torch.arange(S, device=ip.device) // g["n_ac"])[:, None].expand(S, a_cap)
    entries = products = 0
    for j, (r0, r1) in enumerate(zip(torch.as_tensor(r0s).tolist(),
                                     torch.as_tensor(r1s).tolist())):
        hit = live & (col >= r0) & (col < r1)
        b_row = (col[hit] - r0).clamp(0, g["chunk_rows"] - 1)
        b_ip = Bst.indptr[:, j].long()
        lens = (b_ip[inst[hit], b_row + 1] - b_ip[inst[hit], b_row]).clamp(
            0, max(Bst.max_row_nnz, 0))
        entries += int(hit.sum())
        products += int(lens.sum())
    return entries, products


def csr_reads(Ast: CSR, Bst: CSR, C0st: CSR, r0s, r1s, *, order: str,
              Mst: CSR | None = None) -> dict:
    """Bytes one launch of a CSR accumulator (or, with the mask ``Mst``,
    of the masked kernel) touches of each operand, ``{"A", "B", "C"[,
    "M"]}``, on the stacked operands the wrapper takes (module doc)."""
    g = stack_geometry(Ast, Bst, C0st, order)
    n_b, steps = g["n_b"], (g["n_b"] if order == "chunk2" else 1)
    rows, a_nnz = _rows_and_entries(Ast, g["a_cap"])
    entries, products = _in_range(Ast, Bst, r0s, r1s, g)
    _, c0_nnz = _rows_and_entries(C0st, g["c_cap"])
    out = {"A": 8 * rows * steps + 4 * a_nnz * n_b + 4 * entries,
           "B": 8 * entries + 8 * products}
    strips = g["batch"] * g["n_ac"]
    if Mst is None:
        out["C"] = (8 * rows + 8 * c0_nnz                        # C_prev
                    + 4 * strips * (g["strip_rows"] + 1) + 4 * rows   # indptr, read back
                    + 8 * strips * g["c_cap"])                    # every slot
        return out
    _, m_nnz = _rows_and_entries(Mst, Mst.indices.shape[-1])
    out["M"] = steps * (8 * rows + 4 * m_nnz)
    out["C"] = 8 * rows + 8 * c0_nnz + 8 * m_nnz * (2 * steps - 1)
    return out


def dense_reads(a_shape, b_shape) -> dict:
    """Bytes one launch of the dense slab touches of each operand,
    ``{"A", "B", "C"}``, from the shapes of ``a_dense`` ``[batch, n_ac,
    strip_rows, k_pad]`` and ``b_slabs`` ``[batch, n_b, span, n]`` (module
    doc; both orders read alike)."""
    batch, n_ac, rows, _ = (int(v) for v in a_shape)
    _, n_b, span, n = (int(v) for v in b_shape)
    strips = batch * n_ac
    col_tiles, row_tiles = -(-n // TILE), -(-rows // TILE)
    return {"A": 4 * strips * rows * n_b * span * col_tiles,
            "B": 4 * strips * row_tiles * n_b * span * n,
            "C": 8 * strips * rows * n * n_b}


def slow_total(reads: dict, placement, roles: dict | None = None) -> int:
    """The bytes of ``reads`` that cross the link: those of the operands
    ``placement`` puts slow (``roles`` maps an operand to the placement's
    field, the mask ``"M"`` to C's by default)."""
    roles = {"M": "C", **(roles or {})}
    return sum(b for k, b in reads.items() if getattr(placement, roles.get(k, k)) == "slow")
