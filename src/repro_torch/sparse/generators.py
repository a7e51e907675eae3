"""Random sparse matrix generators (paper Table 2: uniform-degree delta RHS).

Host-side NumPy from a seed; outputs land on ``device`` (``None`` = the CUDA card).
"""

from __future__ import annotations

import numpy as np

from repro_torch.sparse.csr import CSR, csr_from_coo


def random_uniform_degree(n_rows: int, n_cols: int, delta: int, seed: int = 0,
                          exact: bool = True, pad_to: int | None = None,
                          device=None) -> CSR:
    """Each row gets ~delta nonzeros in random columns, values U(0, 1).

    With ``exact=True`` every row has exactly delta *distinct* columns (sampled by
    ranking random keys); otherwise columns are sampled with replacement and
    coalesced (degree <= delta) — cheaper for very wide matrices.
    """
    rng = np.random.default_rng(seed)
    delta = int(min(delta, n_cols))
    if exact and n_cols <= 1 << 20:
        # Rank partial random keys: distinct columns per row.
        if delta * 8 >= n_cols:
            keys = rng.random((n_rows, n_cols))
            cols = np.argpartition(keys, delta - 1, axis=1)[:, :delta]
        else:
            # Oversample + dedup refill (vectorized rejection sampling).
            cols = rng.integers(0, n_cols, (n_rows, delta * 2))
            cols.sort(axis=1)
            dup = np.zeros_like(cols, bool)
            dup[:, 1:] = cols[:, 1:] == cols[:, :-1]
            # Replace duplicates by re-rolls until rows have >= delta distinct.
            for _ in range(8):
                n_dup = int(dup.sum())
                if not n_dup:
                    break
                cols[dup] = rng.integers(0, n_cols, n_dup)
                cols.sort(axis=1)
                dup[:, :] = False
                dup[:, 1:] = cols[:, 1:] == cols[:, :-1]
            keep = ~dup
            # Take the first delta distinct columns of each row.
            rank = np.cumsum(keep, axis=1) - 1
            sel = keep & (rank < delta)
            counts = sel.sum(axis=1)
            if (counts < delta).any():  # extremely unlikely; fall back
                return random_uniform_degree(n_rows, n_cols, delta, seed + 1,
                                             exact=True, pad_to=pad_to,
                                             device=device)
            rows = np.repeat(np.arange(n_rows), delta)
            cc = cols[sel]
            vals = rng.random(rows.size)
            return csr_from_coo(rows, cc, vals, (n_rows, n_cols), pad_to=pad_to,
                                sum_duplicates=False, device=device)
        rows = np.repeat(np.arange(n_rows), delta)
        cols = cols.ravel()
        vals = rng.random(rows.size)
        return csr_from_coo(rows, cols, vals, (n_rows, n_cols), pad_to=pad_to,
                            sum_duplicates=False, device=device)
    rows = np.repeat(np.arange(n_rows), delta)
    cols = rng.integers(0, n_cols, rows.size)
    vals = rng.random(rows.size)
    return csr_from_coo(rows, cols, vals, (n_rows, n_cols), pad_to=pad_to,
                        device=device)


def random_banded(n: int, bandwidth: int, density: float, seed: int = 0,
                  pad_to: int | None = None, device=None) -> CSR:
    """Banded random matrix — high spatial locality workload for locality studies."""
    rng = np.random.default_rng(seed)
    per_row = max(1, int(density * (2 * bandwidth + 1)))
    rows = np.repeat(np.arange(n), per_row)
    offs = rng.integers(-bandwidth, bandwidth + 1, rows.size)
    cols = np.clip(rows + offs, 0, n - 1)
    vals = rng.random(rows.size)
    return csr_from_coo(rows, cols, vals, (n, n), pad_to=pad_to, device=device)
