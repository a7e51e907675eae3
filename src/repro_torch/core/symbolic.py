"""Symbolic phase for sparse-output chunked SpGEMM: exact C structure on host.

Two-phase (symbolic/numeric) SpGEMM is the standard scheme on manycore
hardware — Deveci et al.'s KKMEM and the hash/ESC variants of Nagasaka & Azad
both first compute the *structure* (or an upper bound) of C, then run the
numeric phase into preallocated storage:

  * the **symbolic phase** (this module) runs on the host, in NumPy, on the
    row pointers and column indices read back from the device: it computes
    the exact per-row nonzero counts of C = A x B, and from them the
    per-strip output capacities a chunk plan needs (:func:`strip_output_caps`);
  * the **numeric phase** (``repro_torch.core.kkmem``,
    ``repro_torch.core.chunk_stream`` and the CUDA kernels under
    ``repro_torch.kernels``) runs into storage sized by those capacities.

The capacities feed :class:`repro_torch.sparse.csr.GeometryEnvelope` through
``repro_torch.core.chunking.instance_envelope``. Everything here is exact (a
full structural expansion, not a probabilistic estimate).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sparse.csr import CSR, _np


@dataclasses.dataclass(frozen=True)
class SymbolicStructure:
    """Exact structure of C = A x B (host-side, all concrete ints)."""

    per_row_nnz: np.ndarray  # int64[n_rows(A)] — exact nnz of every C row
    c_nnz: int               # exact total nnz of C
    c_max_row_nnz: int       # densest C row
    flops: int               # 2 * number of scalar products


def _structure_expand(A: CSR, B: CSR):
    """Shared expansion core: unique C coordinate keys + scalar-product count.

    Returns ``(keys, total)`` where ``keys`` are the sorted unique
    ``row * n_cols + col`` coordinates of C's exact structure and ``total``
    is the number of scalar products (half the flops)."""
    a_ptr = _np(A.indptr).astype(np.int64)
    a_idx = _np(A.indices).astype(np.int64)
    b_ptr = _np(B.indptr).astype(np.int64)
    b_idx = _np(B.indices).astype(np.int64)
    nnz_a = int(a_ptr[-1])
    a_rows = np.repeat(np.arange(A.n_rows, dtype=np.int64),
                       a_ptr[1:] - a_ptr[:-1])
    a_cols = a_idx[:nnz_a]
    lens = b_ptr[a_cols + 1] - b_ptr[a_cols]
    total = int(lens.sum())
    cum = np.concatenate([[0], np.cumsum(lens)])
    p = np.arange(total, dtype=np.int64)
    t = np.searchsorted(cum, p, side="right") - 1
    prod_rows = a_rows[t]
    prod_cols = b_idx[b_ptr[a_cols[t]] + (p - cum[t])]
    keys = np.unique(prod_rows * np.int64(B.n_cols) + prod_cols)
    return keys, total


def spgemm_structure_host(A: CSR, B: CSR) -> SymbolicStructure:
    """Exact per-row structure of C = A x B (the symbolic phase proper)."""
    keys, total = _structure_expand(A, B)
    per_row = np.bincount(keys // B.n_cols, minlength=A.n_rows)
    return SymbolicStructure(
        per_row_nnz=per_row,
        c_nnz=int(keys.size),
        c_max_row_nnz=int(per_row.max()) if per_row.size else 0,
        flops=2 * total,
    )


@dataclasses.dataclass(frozen=True)
class StripOutputCaps:
    """Per-strip output capacities of a chunk plan, from the symbolic phase.

    ``c_pad`` is what every strip's CSR accumulator is allocated to (the
    largest strip's exact nnz, rounded up); ``c_nnz_cap`` bounds the whole
    assembled C; ``c_max_row_nnz`` bounds any single C row. All three fold
    into :class:`repro_torch.sparse.csr.GeometryEnvelope`.
    """

    c_pad: int             # capacity of the largest strip (rounded up)
    c_nnz_cap: int         # whole-C capacity (rounded up)
    c_max_row_nnz: int     # exact densest C row
    strip_nnz: tuple       # exact nnz of each strip's C rows


def _round_up(v: int, multiple: int) -> int:
    return -(-max(int(v), 1) // multiple) * multiple


def strip_output_caps(A: CSR, B: CSR, p_ac: tuple,
                      pad_multiple: int = 64) -> StripOutputCaps:
    """Output capacities for the A/C row partition ``p_ac`` of C = A x B.

    One global symbolic expansion; per-strip capacities are partial sums of
    the per-row counts — identical values to running the symbolic phase on
    each row slice, without re-expanding per strip.
    """
    structure = spgemm_structure_host(A, B)
    cum = np.concatenate([[0], np.cumsum(structure.per_row_nnz)])
    strip_nnz = tuple(
        int(cum[e] - cum[s]) for s, e in zip(p_ac[:-1], p_ac[1:])
    )
    return StripOutputCaps(
        c_pad=_round_up(max(strip_nnz) if strip_nnz else 0, pad_multiple),
        c_nnz_cap=_round_up(structure.c_nnz, pad_multiple),
        c_max_row_nnz=structure.c_max_row_nnz,
        strip_nnz=strip_nnz,
    )


# ---------------------------------------------------------------------------
# composed symbolic phase: two-hop pipelines (Galerkin R x A x P)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PipelineCaps:
    """Output capacities of a two-hop pipeline ``C = R x (A x P)``.

    One host expansion per hop, composed: hop 1's exact structure (the
    intermediate ``T = A x P``) is materialized as a *pattern* CSR and fed
    to hop 2's symbolic phase, so hop 1's **output** caps become hop 2's
    **input** caps — ``t_max_row_nnz`` is hop 2's streamed-operand
    ``b_max_row_nnz`` and ``t_nnz`` sizes the resident intermediate the
    planner budgets fast memory for.
    """

    hop1: StripOutputCaps   # caps of T = A x P under p_ac1
    hop2: StripOutputCaps   # caps of C = R x T under p_ac2
    t_pattern: CSR          # exact structure of T (data = 1.0), on A's device
    t_nnz: int              # exact nnz of the resident intermediate
    t_max_row_nnz: int      # densest T row = hop 2's streamed b_max_row_nnz


def spgemm_pattern_host(A: CSR, B: CSR) -> CSR:
    """Exact structure of ``A x B`` as a pattern CSR (data = 1.0), built on
    the host and placed on A's device. Shared by the composed symbolic phase
    and the pipeline planner, so the expansion runs once per pipeline."""
    from repro_torch.sparse.csr import csr_from_coo

    keys, _ = _structure_expand(A, B)
    rows = keys // np.int64(B.n_cols)
    cols = keys % np.int64(B.n_cols)
    return csr_from_coo(rows, cols, np.ones(keys.size), (A.n_rows, B.n_cols),
                        device=A.device)


def pipeline_output_caps(A: CSR, P: CSR, R: CSR, p_ac1: tuple, p_ac2: tuple,
                         pad_multiple: int = 64,
                         t_pattern: CSR | None = None) -> PipelineCaps:
    """Composed symbolic phase for ``C = R x (A x P)``: hop 1 expanded
    exactly, T's pattern built from the unique coordinate keys, hop 2
    expanded against that pattern (structure only, so the caps equal those
    of the numeric T). Callers that already expanded T pass ``t_pattern``."""
    if t_pattern is None:
        t_pattern = spgemm_pattern_host(A, P)
    t_ptr = _np(t_pattern.indptr).astype(np.int64)
    per_row = t_ptr[1 : A.n_rows + 1] - t_ptr[: A.n_rows]
    hop1 = strip_output_caps(A, P, p_ac1, pad_multiple=pad_multiple)
    hop2 = strip_output_caps(R, t_pattern, p_ac2, pad_multiple=pad_multiple)
    return PipelineCaps(
        hop1=hop1,
        hop2=hop2,
        t_pattern=t_pattern,
        t_nnz=int(per_row.sum()),
        t_max_row_nnz=int(per_row.max()) if per_row.size else 0,
    )


# ---------------------------------------------------------------------------
# masked symbolic phase (fused-mask products: triangle counting)
# ---------------------------------------------------------------------------


def masked_output_caps(mask: CSR, p_ac: tuple,
                       pad_multiple: int = 64) -> StripOutputCaps:
    """Output capacities of a mask-fused product ``C = (A x B) ∘ M``.

    A fused in-kernel mask pins C's structure to ``M``'s, so the caps come
    from the mask alone — no product expansion. ``c_max_row_nnz`` is the
    densest mask row, ``strip_nnz`` the exact mask nnz per strip.
    """
    m_ptr = _np(mask.indptr).astype(np.int64)
    per_row = m_ptr[1:] - m_ptr[:-1]
    cum = np.concatenate([[0], np.cumsum(per_row)])
    strip_nnz = tuple(
        int(cum[e] - cum[s]) for s, e in zip(p_ac[:-1], p_ac[1:])
    )
    return StripOutputCaps(
        c_pad=_round_up(max(strip_nnz) if strip_nnz else 0, pad_multiple),
        c_nnz_cap=_round_up(int(per_row.sum()), pad_multiple),
        c_max_row_nnz=int(per_row.max()) if per_row.size else 0,
        strip_nnz=strip_nnz,
    )


# ---------------------------------------------------------------------------
# block-level symbolic phase (the BSR backend's output-cap analogue)
# ---------------------------------------------------------------------------


def _next_pow2(v: int) -> int:
    p = 1
    while p < v:
        p *= 2
    return p


@dataclasses.dataclass(frozen=True)
class BsrPlanCaps:
    """Block-geometry capacities of a chunk plan at block size ``block_size``.

    ``nbl_a`` bounds the blocks of any staged A strip x chunk-column slice,
    ``nbl_b`` the blocks of any staged B chunk, ``nc`` the C blocks of any
    (strip, chunk) pair's block-level expansion, and ``u`` the contributor
    (k-block) count of any C block. Block counts are quantized to a multiple
    of ``quantum`` and ``u`` to a power of two, so ``as_tuple()`` doubles as
    the envelope's ``bsr_caps`` field.
    """

    block_size: int
    nbl_a: int   # blocks of any staged A (strip x chunk-columns) piece
    nbl_b: int   # blocks of any staged B chunk
    nc: int      # block-expanded C blocks of any (strip, chunk) pair
    u: int       # contributor (A block, B block) pairs of any C block

    def as_tuple(self) -> tuple:
        return (self.block_size, self.nbl_a, self.nbl_b, self.nc, self.u)


def bsr_plan_caps(A: CSR, B: CSR, plan, block_size: int,
                  quantum: int = 8) -> BsrPlanCaps:
    """Exact block-structure capacities of ``plan`` on (A, B) at ``block_size``.

    A pair stages as A's strip rows restricted to the chunk's columns against
    B's chunk rows. ``nc`` and ``u`` bound the *block-level expansion* the
    BSR kernel's symbolic phase performs (C block (i, j) is scheduled when A
    block (i, kb) meets B block (kb, j), even if no element-level product
    lands in it), so they come from the same join, not from C's element
    structure. Counted from the stored entries of the CSR operands.
    """
    bs = int(block_size)
    if bs < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    k, n = B.shape
    kb = -(-k // bs)
    nb = -(-n // bs)
    a_ptr = _np(A.indptr).astype(np.int64)
    a_idx = _np(A.indices).astype(np.int64)
    nnz_a = int(a_ptr[-1])
    rows_a = np.repeat(np.arange(A.n_rows, dtype=np.int64),
                       a_ptr[1:] - a_ptr[:-1])
    cols_a = a_idx[:nnz_a]
    b_ptr = _np(B.indptr).astype(np.int64)
    b_idx = _np(B.indices).astype(np.int64)
    nnz_b = int(b_ptr[-1])
    rows_b = np.repeat(np.arange(B.n_rows, dtype=np.int64),
                       b_ptr[1:] - b_ptr[:-1])
    cols_b = b_idx[:nnz_b]
    strips = list(zip(plan.p_ac[:-1], plan.p_ac[1:]))
    chunks = list(zip(plan.p_b[:-1], plan.p_b[1:]))

    nbl_a = nbl_b = nc = u = 1
    # block-level CSR pattern of each staged B chunk, for the expansion join
    chunk_patterns = []
    for r0, r1 in chunks:
        sel = (rows_b >= r0) & (rows_b < r1)
        keys = np.unique((rows_b[sel] // bs) * nb + cols_b[sel] // bs)
        nbl_b = max(nbl_b, int(keys.size))
        ptr = np.zeros(kb + 1, np.int64)
        np.add.at(ptr, keys // nb + 1, 1)
        chunk_patterns.append((np.cumsum(ptr), keys % nb))

    for s, e in strips:
        sela = (rows_a >= s) & (rows_a < e)
        abr = (rows_a[sela] - s) // bs
        acol = cols_a[sela]
        abc = acol // bs
        for (r0, r1), (bptr, bjb) in zip(chunks, chunk_patterns):
            selp = (acol >= r0) & (acol < r1)
            akeys = np.unique(abr[selp] * kb + abc[selp])
            nbl_a = max(nbl_a, int(akeys.size))
            ai, ak = akeys // kb, akeys % kb
            lens = bptr[ak + 1] - bptr[ak]
            total = int(lens.sum())
            if not total:
                continue
            cum = np.concatenate([[0], np.cumsum(lens)])
            p = np.arange(total, dtype=np.int64)
            t = np.searchsorted(cum, p, side="right") - 1
            ckeys = ai[t] * nb + bjb[bptr[ak[t]] + (p - cum[t])]
            uniq, counts = np.unique(ckeys, return_counts=True)
            nc = max(nc, int(uniq.size))
            u = max(u, int(counts.max()))

    def up(v: int) -> int:
        return -(-int(v) // quantum) * quantum

    return BsrPlanCaps(block_size=bs, nbl_a=up(nbl_a), nbl_b=up(nbl_b),
                       nc=up(nc), u=_next_pow2(u))
