"""Reuse-distance (LRU stack-distance) analysis of KKMEM's B-access trace.

Paper §3.1: for ``C = A x B`` the trace of *B-row* accesses is exactly the column
stream of A (each nonzero a_ik triggers a read of B row k). Temporal locality is
"overlapping columns in consecutive rows of A"; spatial locality is the density of
B's rows. Both are measurable offline:

  * stack distance of each access  -> miss fraction at any cache capacity
    (one simulation, every capacity; Mattson et al. 1970)
  * delta of B                     -> bytes per discrete access (prefetch amortization)

This module is the quantitative bridge between the matrices and the memory cost
model — it produces the ``b_miss_fraction`` used by repro_torch.core.memory_model and
reproduces the paper's Table 1 / Table 2 / Table 4 locality orderings.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sparse.csr import CSR, _np


class _Fenwick:
    """Binary indexed tree over trace positions (counts most-recent-access marks)."""

    def __init__(self, n: int):
        self.n = n
        self.tree = np.zeros(n + 1, np.int64)

    def add(self, i: int, v: int) -> None:
        i += 1
        while i <= self.n:
            self.tree[i] += v
            i += i & (-i)

    def prefix(self, i: int) -> int:
        """Sum of [0, i)."""
        s = 0
        while i > 0:
            s += self.tree[i]
            i -= i & (-i)
        return int(s)

    def range(self, lo: int, hi: int) -> int:
        """Sum of [lo, hi)."""
        return self.prefix(hi) - self.prefix(lo)


def stack_distances(trace: np.ndarray, n_ids: int) -> np.ndarray:
    """LRU stack distance per access; -1 for cold (first) accesses.

    distance d means: d distinct other ids were touched since the previous access to
    this id -> the access hits an LRU cache holding > d ids.
    """
    trace = np.asarray(trace, np.int64)
    t_len = trace.size
    bit = _Fenwick(t_len)
    last = np.full(n_ids, -1, np.int64)
    out = np.empty(t_len, np.int64)
    for t in range(t_len):
        r = trace[t]
        lt = last[r]
        if lt < 0:
            out[t] = -1
        else:
            out[t] = bit.range(lt + 1, t)
            bit.add(lt, -1)
        bit.add(t, 1)
        last[r] = t
    return out


@dataclasses.dataclass(frozen=True)
class LocalityStats:
    """Locality profile of one SpGEMM's B-access trace."""

    n_accesses: int
    n_cold: int
    distances: np.ndarray        # stack distance histogram support (sorted, cold excl.)
    counts: np.ndarray           # histogram counts
    avg_b_row_bytes: float       # spatial-locality proxy (prefetch amortization)
    mean_reuse: float            # mean stack distance over warm accesses

    def miss_fraction(self, capacity_rows: float) -> float:
        """Fraction of accesses missing an LRU cache holding ``capacity_rows`` rows
        (cold misses always count)."""
        if self.n_accesses == 0:
            return 0.0
        warm_misses = int(self.counts[self.distances >= capacity_rows].sum())
        return (warm_misses + self.n_cold) / self.n_accesses

    def miss_fraction_bytes(self, capacity_bytes: float) -> float:
        rows = max(1.0, capacity_bytes / max(self.avg_b_row_bytes, 1.0))
        return self.miss_fraction(rows)


def b_access_trace(A: CSR) -> np.ndarray:
    """The B-row access trace of C = A x B: A's column stream in row order."""
    indptr = _np(A.indptr)
    indices = _np(A.indices)
    return indices[: int(indptr[-1])]


def analyze(A: CSR, B: CSR, value_bytes: int = 8, index_bytes: int = 4,
            max_trace: int = 200_000, seed: int = 0) -> LocalityStats:
    """Locality profile of C = A x B (subsampled for very long traces: a contiguous
    window keeps the row-to-row overlap structure intact)."""
    trace = b_access_trace(A)
    if trace.size > max_trace:
        rng = np.random.default_rng(seed)
        start = int(rng.integers(0, trace.size - max_trace))
        trace = trace[start : start + max_trace]
    d = stack_distances(trace, B.n_rows)
    cold = int((d < 0).sum())
    warm = d[d >= 0]
    if warm.size:
        support, counts = np.unique(warm, return_counts=True)
        mean_reuse = float(warm.mean())
    else:
        support, counts = np.empty(0, np.int64), np.empty(0, np.int64)
        mean_reuse = float("inf")
    b_lens = _np(B.indptr[1:] - B.indptr[:-1])
    avg_row_bytes = float(b_lens.mean()) * (value_bytes + index_bytes) if b_lens.size else 0.0
    return LocalityStats(
        n_accesses=int(trace.size),
        n_cold=cold,
        distances=support,
        counts=counts,
        avg_b_row_bytes=avg_row_bytes,
        mean_reuse=mean_reuse,
    )


def miss_table(A: CSR, B: CSR, capacities_bytes: dict | None = None) -> dict:
    """Paper Table 1/4 analogue: miss fractions at L1/L2-like capacities."""
    caps = capacities_bytes or {"L1": 32 << 10, "L2": 1 << 20}
    st = analyze(A, B)
    return {name: st.miss_fraction_bytes(cap) for name, cap in caps.items()} | {
        "mean_reuse_rows": st.mean_reuse,
        "avg_b_row_bytes": st.avg_b_row_bytes,
    }
