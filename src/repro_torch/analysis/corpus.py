"""Geometry corpus for the static backend auditor.

The adversarial geometry classes of the cross-backend conformance suite
(empty rows, skew, zero chunks, single-column B, duplicate-heavy structure,
dense rows, wide sparse output), built by the same NumPy constructors from
the same seeds as the JAX package's corpus, so both packages audit equal
matrices.

Also provides the retrace pair: a second instance that is a *structural
subset* of the first (every other stored entry kept, values rescaled), so
the first instance's envelope dominates both and staging them at the shared
envelope must give one static geometry.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.planner import ChunkPlan
from repro_torch.sparse.csr import CSR, csr_from_dense, csr_to_dense


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def _random_dense(rng, rows: int, cols: int, density: float) -> np.ndarray:
    mask = rng.random((rows, cols)) < density
    vals = rng.standard_normal((rows, cols)).astype(np.float32)
    return np.where(mask, vals, 0.0).astype(np.float32)


def _case_empty_rows(seed):
    rng = _rng(seed)
    a = _random_dense(rng, 13, 10, 0.4)
    a[0] = 0.0
    a[5] = 0.0
    a[12] = 0.0
    b = _random_dense(rng, 10, 8, 0.3)
    return a, b


def _case_skewed_rows(seed):
    rng = _rng(seed)
    a = _random_dense(rng, 11, 14, 0.06)
    a[4] = rng.standard_normal(14).astype(np.float32)  # one dense row
    b = _random_dense(rng, 14, 9, 0.3)
    return a, b


def _case_all_zero_chunk(seed):
    rng = _rng(seed)
    a = _random_dense(rng, 9, 12, 0.3)
    b = _random_dense(rng, 12, 7, 0.35)
    b[4:8] = 0.0  # the middle B-chunk vanishes
    return a, b


def _case_single_col_b(seed):
    rng = _rng(seed)
    a = _random_dense(rng, 8, 11, 0.4)
    b = _random_dense(rng, 11, 1, 0.5)
    return a, b


def _case_all_zero_b(seed):
    rng = _rng(seed)
    a = _random_dense(rng, 7, 9, 0.4)
    b = np.zeros((9, 5), dtype=np.float32)
    return a, b


def _case_wide_sparse_output(seed):
    rng = _rng(seed)
    a = _random_dense(rng, 9, 11, 0.12)
    b = _random_dense(rng, 11, 40, 0.05)
    return a, b


def _case_duplicate_heavy(seed):
    rng = _rng(seed)
    a = _random_dense(rng, 11, 8, 0.2)
    a[:, :3] = rng.standard_normal((11, 3)).astype(np.float32)
    b = _random_dense(rng, 8, 9, 0.25)
    b[:3] = rng.standard_normal((3, 9)).astype(np.float32)
    return a, b


def _case_dense_row(seed):
    rng = _rng(seed)
    a = _random_dense(rng, 9, 7, 0.2)
    a[3] = rng.standard_normal(7).astype(np.float32)
    b = _random_dense(rng, 7, 10, 0.3)
    b[0] = rng.standard_normal(10).astype(np.float32)
    return a, b


# name -> (builder, seed): the JAX package's corpus (seeds 211+, dims
# disjoint from the conformance cases and the trace-count geometries)
CASES = {
    "empty_rows": (_case_empty_rows, 211),
    "skewed_rows": (_case_skewed_rows, 212),
    "all_zero_chunk": (_case_all_zero_chunk, 213),
    "single_col_b": (_case_single_col_b, 214),
    "all_zero_b": (_case_all_zero_b, 215),
    "wide_sparse_output": (_case_wide_sparse_output, 216),
    "duplicate_heavy": (_case_duplicate_heavy, 217),
    "dense_row": (_case_dense_row, 218),
}

# the cheap-but-representative subset the fast lane audits
FAST_CASES = ("skewed_rows", "all_zero_chunk", "wide_sparse_output")


def build_case(name: str, device=None) -> tuple:
    """(A, B) CSR pair of one corpus case on ``device`` (``None`` = the card)."""
    builder, seed = CASES[name]
    a, b = builder(seed)
    return csr_from_dense(a, device=device), csr_from_dense(b, device=device)


def _thirds(n: int) -> tuple:
    if n < 3:
        return (0, n)
    return (0, n // 3, 2 * n // 3, n)


def make_plan(algorithm: str, A: CSR, B: CSR) -> ChunkPlan:
    """The conformance-style plan: knl keeps A whole, chunked algorithms
    split both operands into thirds (cost fields are irrelevant here)."""
    p_ac = (0, A.n_rows) if algorithm == "knl" else _thirds(A.n_rows)
    return ChunkPlan(algorithm, p_ac, _thirds(B.n_rows), 0.0, 0.0)


def structural_subset(M: CSR, seed: int = 0) -> CSR:
    """A second instance dominated by ``M``'s geometry: every other stored
    entry kept (so per-row nnz can only shrink), surviving values rescaled.
    Same shape, different data — the retrace pair."""
    dense = csr_to_dense(M).cpu().numpy()
    rows, cols = np.nonzero(dense)
    keep = np.zeros_like(dense, dtype=bool)
    keep[rows[::2], cols[::2]] = True
    rng = _rng(900 + seed)
    scale = (0.25 + rng.random(dense.shape)).astype(dense.dtype)
    return csr_from_dense(np.where(keep, dense * scale, 0.0).astype(dense.dtype),
                          device=M.device)


def retrace_pair(A: CSR, B: CSR) -> tuple:
    """(A2, B2): structural subsets of (A, B) for the retrace check."""
    return structural_subset(A, seed=1), structural_subset(B, seed=2)
