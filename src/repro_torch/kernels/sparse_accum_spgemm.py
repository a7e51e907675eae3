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

import collections

import torch

from repro_torch.core.kkmem import spgemm_ranged_impl
from repro_torch.kernels._build import LaunchCounter, launch, require
from repro_torch.sparse.csr import CSR, csr_row_of_entry

LAUNCHES = LaunchCounter()
ORDERS = ("chunk1", "chunk2")
SMEM_PER_BLOCK = 232_448        # bytes of shared memory one block may use (H100)
SMEM_TARGET = 96 * 1024         # per-block target when choosing warps per block
MAX_WARPS_PER_BLOCK = 8
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


def kernels_per_call(order: str, n_b: int) -> int:
    """Kernels one call of the skeleton launches: the merge once (chunk1)
    or once a chunk (chunk2), then the scan and the copy."""
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


def sort_steps(Ast: CSR, Bst: CSR, C0st: CSR, r0s, r1s, *, row_cap: int) -> dict:
    """How the ESC kernel sorts: the number of (strip row, chunk) merge
    steps of each ``"class/key bits"`` (``sort_class`` of the step's key
    count and ``key_bits`` of its largest column; "none" has no key). The
    accumulator before a step comes from the plain version's steps; both
    orders run the same steps."""
    g = stack_geometry(Ast, Bst, C0st, "chunk1")
    work_cap, _ = esc_workspace(Ast.max_row_nnz, Bst.max_row_nnz, max(int(row_cap), 1))
    r0s = [int(v) for v in torch.as_tensor(r0s).tolist()]
    r1s = [int(v) for v in torch.as_tensor(r1s).tolist()]
    c_cap = g["c_cap"]

    def live(m: CSR, nnz) -> torch.Tensor:
        return torch.arange(m.nnz_pad, device=m.device) < nnz

    steps = collections.Counter()
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
                steps.update(zip(n.tolist(), top.tolist()))
                acc = spgemm_ranged_impl(A, B, r0s[j], r1s[j], acc, c_cap)
    counts = collections.Counter()
    for (n, top), k in steps.items():
        cls = sort_class(n, key_bits(top + 1, work_cap))
        counts[cls if cls == "none" else f"{cls}/{32 if cls.startswith('reg') else 64}"] += k
    return dict(sorted(counts.items()))


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
