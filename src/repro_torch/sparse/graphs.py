"""Graph generators + triangle-counting preprocessing (paper §4.1.2, Fig 11).

The paper uses twitter-2010 / uk-2005 / graph500-scale25. Offline, we generate
structurally similar synthetic graphs: RMAT (graph500-like, skewed) and a
power-law configuration-style graph (social-network-like).

Host-side NumPy from a seed, with the JAX package's draws in the same order,
so a graph's structure is bit-for-bit the reference's at the same seed;
outputs land on ``device`` (``None`` = the CUDA card).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.sparse.csr import CSR, _np, csr_from_coo


def _binarized(adj: CSR) -> CSR:
    """0/1 values (duplicates were summed by the COO conversion)."""
    return CSR(adj.indptr, adj.indices, torch.clamp(adj.data, max=1.0),
               adj.shape, adj.max_row_nnz)


def rmat(scale: int, edge_factor: int = 16, a: float = 0.57, b: float = 0.19,
         c: float = 0.19, seed: int = 0, device=None) -> CSR:
    """RMAT adjacency matrix (symmetrized, self-loops removed, 0/1 values)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    rows = np.zeros(m, np.int64)
    cols = np.zeros(m, np.int64)
    for bit in range(scale):
        r = rng.random(m)
        # quadrant probabilities: a (0,0), b (0,1), c (1,0), d (1,1)
        right = (r >= a) & (r < a + b) | (r >= a + b + c)
        down = r >= a + b
        rows |= down.astype(np.int64) << bit
        cols |= right.astype(np.int64) << bit
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    r2 = np.concatenate([rows, cols])
    c2 = np.concatenate([cols, rows])
    return _binarized(csr_from_coo(r2, c2, np.ones(r2.size), (n, n), device=device))


def powerlaw(n: int, m_per_node: int = 8, exponent: float = 2.1, seed: int = 0,
             device=None) -> CSR:
    """Configuration-model-ish power-law graph (social-network-like degree skew)."""
    rng = np.random.default_rng(seed)
    # degree ~ zipf, capped
    deg = np.minimum(rng.zipf(exponent, n) * m_per_node // 2, n // 2).astype(np.int64)
    deg = np.maximum(deg, 1)
    stubs = np.repeat(np.arange(n), deg)
    rng.shuffle(stubs)
    if stubs.size % 2:
        stubs = stubs[:-1]
    half = stubs.size // 2
    rows, cols = stubs[:half], stubs[half:]
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    r2 = np.concatenate([rows, cols])
    c2 = np.concatenate([cols, rows])
    return _binarized(csr_from_coo(r2, c2, np.ones(r2.size), (n, n), device=device))


def lower_triangular_degree_sorted(adj: CSR) -> CSR:
    """Wolf et al. triangle-counting preprocessing: permute vertices by ascending
    degree, then take the strictly-lower-triangular part L. Triangles = sum(L.L o L)."""
    indptr = _np(adj.indptr)
    indices = _np(adj.indices)
    data = _np(adj.data)
    n = adj.n_rows
    deg = indptr[1:] - indptr[:-1]
    order = np.argsort(deg, kind="stable")  # old -> sorted position by rank
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    nnz = int(indptr[-1])
    rows = np.repeat(np.arange(n), deg)
    cols = indices[:nnz]
    pr, pc = rank[rows], rank[cols]
    keep = pr > pc  # strictly lower triangular in permuted order
    return csr_from_coo(pr[keep], pc[keep], data[:nnz][keep], (n, n),
                        sum_duplicates=False, device=adj.device)
