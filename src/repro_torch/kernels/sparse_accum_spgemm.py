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
"""

from __future__ import annotations

import torch

from repro_torch.core.kkmem import spgemm_ranged_impl
from repro_torch.kernels._build import LaunchCounter, launch, require
from repro_torch.sparse.csr import CSR

LAUNCHES = LaunchCounter()
ORDERS = ("chunk1", "chunk2")
SMEM_PER_BLOCK = 232_448        # bytes of shared memory one block may use (H100)
SMEM_TARGET = 96 * 1024         # per-block target when choosing warps per block
MAX_WARPS_PER_BLOCK = 8


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
                     row_cap: int, work_cap: int, smem_per_warp: int):
    """Launch one of the CSR-output accumulator kernels (``csr_accum.cuh``)
    and return the stacked ``(indptr, indices, data)``. ``row_cap`` is the
    per-row accumulator width, ``smem_per_warp`` the merge's shared memory
    for one row. Raises when a row's workspace exceeds the shared memory of
    a block, and when the kernel reports a capacity overflow."""
    g = stack_geometry(Ast, Bst, C0st, order)
    dev = Ast.indptr.device
    if smem_per_warp > SMEM_PER_BLOCK:
        raise ValueError(
            f"{fn}: one row needs {smem_per_warp} bytes of shared memory, more "
            f"than the {SMEM_PER_BLOCK} a block has")
    warps = max(1, min(MAX_WARPS_PER_BLOCK, SMEM_TARGET // smem_per_warp))
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
            slab_cols, slab_vals, slab_cnt, out_ip, out_ix, out_d, overflow],
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


def esc_workspace(a_max_row_nnz: int, b_max_row_nnz: int, row_cap: int) -> tuple:
    """(sort slots, shared bytes) of one row's ESC merge: the row's products
    plus its accumulator, rounded up to a power of two for the bitonic sort,
    as 64-bit keys and f32 values, then the accumulator's columns and values."""
    work_cap = _pow2(max(a_max_row_nnz, 0) * max(b_max_row_nnz, 0) + row_cap)
    return work_cap, _align16(work_cap * 12 + row_cap * 8)


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
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if Ast.indptr.device.type == "cpu":
        return sparse_accum_plain(Ast, Bst, C0st, r0s, r1s, order=order)
    row_cap = max(int(row_cap), 1)
    work_cap, smem = esc_workspace(Ast.max_row_nnz, Bst.max_row_nnz, row_cap)
    return launch_csr_accum("sparse_accum_spgemm", "sparse_accum_launch",
                            LAUNCHES, Ast, Bst, C0st, r0s, r1s, order=order,
                            row_cap=row_cap, work_cap=work_cap,
                            smem_per_warp=smem)
