"""Multigrid problem generators: the paper's four domains at any scale.

The paper evaluates triple products ``A_c = R x A_f x P`` from multigrid setup, with
``P = R^T``. The A matrices are stencil matrices with nnz/row:

  Laplace3D   7   (7-point 3D Laplacian)
  BigStar2D  13   (13-point 2D star stencil)
  Brick3D    27   (27-point 3D brick stencil)
  Elasticity 81   (27-point 3D stencil x 3x3 dof coupling)

``R`` is the short-and-wide geometric restriction (factor-2 coarsening, full-weighting):
rows have strided column patterns and consecutive rows share little structure — exactly
the low-temporal-locality access pattern the paper analyzes for R x A.

All generation is host-side NumPy; outputs are repro_torch.sparse.CSR on ``device``
(``None`` means the CUDA card).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.sparse.csr import CSR, csr_from_coo, csr_transpose_host

# ---------------------------------------------------------------------------
# stencil machinery
# ---------------------------------------------------------------------------


def _stencil_coo(grid: tuple, offsets: np.ndarray, weights: np.ndarray):
    """COO for a stencil matrix on a structured grid with truncation at boundaries."""
    grid = tuple(int(g) for g in grid)
    d = len(grid)
    n = int(np.prod(grid))
    coords = np.stack(np.unravel_index(np.arange(n), grid), axis=1)  # [n, d]
    rows_all, cols_all, vals_all = [], [], []
    for off, w in zip(offsets, weights):
        nbr = coords + off[None, :]
        ok = np.ones(n, bool)
        for k in range(d):
            ok &= (nbr[:, k] >= 0) & (nbr[:, k] < grid[k])
        r = np.nonzero(ok)[0]
        c = np.ravel_multi_index(tuple(nbr[ok].T), grid)
        rows_all.append(r)
        cols_all.append(c)
        vals_all.append(np.full(r.size, w))
    return (
        np.concatenate(rows_all),
        np.concatenate(cols_all),
        np.concatenate(vals_all),
        n,
    )


def stencil_matrix(grid: tuple, offsets, weights, dof: int = 1,
                   coupling: np.ndarray | None = None, pad_to: int | None = None,
              device=None) -> CSR:
    """General stencil matrix; with dof>1 each scalar entry becomes a dof x dof block
    (Kronecker with ``coupling``)."""
    offsets = np.asarray(offsets, np.int64)
    weights = np.asarray(weights, np.float64)
    rows, cols, vals, n = _stencil_coo(grid, offsets, weights)
    if dof > 1:
        if coupling is None:
            coupling = np.eye(dof)
        bi, bj = np.nonzero(coupling)
        rows = (rows[:, None] * dof + bi[None, :]).ravel()
        cols = (cols[:, None] * dof + bj[None, :]).ravel()
        vals = (vals[:, None] * coupling[bi, bj][None, :]).ravel()
        n *= dof
    return csr_from_coo(rows, cols, vals, (n, n), pad_to=pad_to, device=device)


def _offsets_box(d: int, radius: int = 1) -> np.ndarray:
    """All offsets in {-radius..radius}^d."""
    ax = np.arange(-radius, radius + 1)
    grids = np.meshgrid(*([ax] * d), indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=1)


# ---------------------------------------------------------------------------
# the paper's four A matrices
# ---------------------------------------------------------------------------


def laplace3d(n: int, pad_to: int | None = None,
              device=None) -> CSR:
    """7-point 3D Laplacian on an n^3 grid (nnz/row = 7 in the interior)."""
    offs = [(0, 0, 0)]
    wts = [6.0]
    for k in range(3):
        for s in (-1, 1):
            o = [0, 0, 0]
            o[k] = s
            offs.append(tuple(o))
            wts.append(-1.0)
    return stencil_matrix((n, n, n), offs, wts, pad_to=pad_to, device=device)


def bigstar2d(n: int, pad_to: int | None = None,
              device=None) -> CSR:
    """13-point 2D star stencil on an n^2 grid (nnz/row = 13)."""
    offs = [(0, 0)]
    wts = [12.0]
    for k in range(2):
        for s in (-1, 1, -2, 2):
            o = [0, 0]
            o[k] = s
            offs.append(tuple(o))
            wts.append(-1.0 if abs(s) == 1 else -0.5)
    for sx in (-1, 1):
        for sy in (-1, 1):
            offs.append((sx, sy))
            wts.append(-1.0)
    return stencil_matrix((n, n), offs, wts, pad_to=pad_to, device=device)


def brick3d(n: int, pad_to: int | None = None,
              device=None) -> CSR:
    """27-point 3D brick stencil on an n^3 grid (nnz/row = 27)."""
    offs = _offsets_box(3, 1)
    dist = np.abs(offs).sum(axis=1)
    wts = np.where(dist == 0, 26.0, -1.0 / np.maximum(dist, 1))
    return stencil_matrix((n, n, n), offs, wts, pad_to=pad_to, device=device)


def elasticity3d(n: int, pad_to: int | None = None,
              device=None) -> CSR:
    """3D elasticity-like operator: 27-point stencil x 3 dof/node (nnz/row = 81)."""
    offs = _offsets_box(3, 1)
    dist = np.abs(offs).sum(axis=1)
    wts = np.where(dist == 0, 26.0, -1.0 / np.maximum(dist, 1))
    coupling = np.array(
        [[2.0, 0.3, 0.2],
         [0.3, 2.0, 0.3],
         [0.2, 0.3, 2.0]]
    )
    return stencil_matrix((n, n, n), offs, wts, dof=3, coupling=coupling,
                          pad_to=pad_to, device=device)


# ---------------------------------------------------------------------------
# restriction / prolongation
# ---------------------------------------------------------------------------


def restriction(grid: tuple, dof: int = 1, pad_to: int | None = None,
              device=None) -> CSR:
    """Full-weighting restriction R for factor-2 coarsening on a structured grid.

    Coarse node at fine coords 2*c; row weights are the tensor-product of
    (0.5, 1.0, 0.5) over dimensions, truncated at boundaries. Shape (Nc*dof, Nf*dof):
    short and wide, strided columns — the paper's R access pattern.
    """
    grid = tuple(int(g) for g in grid)
    d = len(grid)
    cgrid = tuple((g + 1) // 2 for g in grid)
    nf = int(np.prod(grid))
    nc = int(np.prod(cgrid))
    ccoords = np.stack(np.unravel_index(np.arange(nc), cgrid), axis=1)  # [nc, d]
    offsets = _offsets_box(d, 1)
    w1 = np.array([0.5, 1.0, 0.5])
    rows_all, cols_all, vals_all = [], [], []
    for off in offsets:
        w = float(np.prod(w1[off + 1]))
        fine = ccoords * 2 + off[None, :]
        ok = np.ones(nc, bool)
        for k in range(d):
            ok &= (fine[:, k] >= 0) & (fine[:, k] < grid[k])
        r = np.nonzero(ok)[0]
        c = np.ravel_multi_index(tuple(fine[ok].T), grid)
        rows_all.append(r)
        cols_all.append(c)
        vals_all.append(np.full(r.size, w))
    rows = np.concatenate(rows_all)
    cols = np.concatenate(cols_all)
    vals = np.concatenate(vals_all)
    if dof > 1:
        k = np.arange(dof)
        rows = (rows[:, None] * dof + k[None, :]).ravel()
        cols = (cols[:, None] * dof + k[None, :]).ravel()
        vals = np.repeat(vals, dof)
        nc *= dof
        nf *= dof
    return csr_from_coo(rows, cols, vals, (nc, nf), pad_to=pad_to, device=device)


# ---------------------------------------------------------------------------
# problem registry: name -> (A, R, P) factory
# ---------------------------------------------------------------------------

PROBLEMS = ("laplace3d", "bigstar2d", "brick3d", "elasticity")


def problem(name: str, n: int, pad_to: int | None = None, device=None):
    """Return (A, R, P) for one of the paper's four problems at grid size n.

    P = R^T (the paper: "P is transpose of R in our examples").
    ``pad_to`` is forwarded to every generator so callers building
    envelope-aligned triple products (``R x A x P`` through one
    :class:`~repro_torch.sparse.csr.GeometryEnvelope`) get nnz storage padded to
    a shared multiple.
    """
    name = name.lower()
    if name == "laplace3d":
        A = laplace3d(n, pad_to=pad_to, device=device)
        R = restriction((n, n, n), pad_to=pad_to, device=device)
    elif name == "bigstar2d":
        A = bigstar2d(n, pad_to=pad_to, device=device)
        R = restriction((n, n), pad_to=pad_to, device=device)
    elif name == "brick3d":
        A = brick3d(n, pad_to=pad_to, device=device)
        R = restriction((n, n, n), pad_to=pad_to, device=device)
    elif name == "elasticity":
        A = elasticity3d(n, pad_to=pad_to, device=device)
        R = restriction((n, n, n), dof=3, pad_to=pad_to, device=device)
    else:
        raise ValueError(f"unknown problem {name!r}; choose from {PROBLEMS}")
    P = csr_transpose_host(R)
    # the P = R^T contract is load-bearing for the fused pipeline's composed
    # symbolic phase (hop-1 caps are computed on (A, P)); pin it bitwise so a
    # future generator change can't silently break it
    check = csr_transpose_host(R)
    if not (torch.equal(P.indptr, check.indptr)
            and torch.equal(P.indices, check.indices)
            and torch.equal(P.data, check.data)):
        raise AssertionError("P must be bitwise csr_transpose_host(R)")
    return A, R, P
