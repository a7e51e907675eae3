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
