"""Linear-algebra triangle counting (paper §4.1.2, after Wolf et al. HPEC'17).

Vertices are sorted by degree, L = strictly-lower-triangular part of the
permuted adjacency; triangles = sum over nonzeros (i,j) of L of (L x L)[i, j]
— i.e. the SpGEMM result *masked* by L.

Two paths:

* :func:`count_triangles` — the fused path: the product routes through a
  mask-capable registered chunked backend (``BackendSpec.run_masked``, the
  hash accumulator by default), with the L-mask applied **inside** the
  kernel's merge, so no unmasked C is materialized.
* :func:`count_triangles_kkmem` — the unfused baseline: the full C = L x L
  materialized at its symbolic capacity, then masked by matching C's and
  L's (row, col) keys.

Every count is summed in float64: each entry of C is a small integer, exact
in float32, but a total above 2**24 is not (the reference summed in
float32; a graph500 scale-18 graph holds tens of millions of triangles).
"""

from __future__ import annotations

import torch

from repro_torch.core.kkmem import spgemm, spgemm_symbolic_host
from repro_torch.core.planner import ChunkPlan, plan_knl
from repro_torch.sparse.csr import CSR, csr_row_of_entry, csr_to_dense


def count_triangles(L: CSR, plan: ChunkPlan | None = None,
                    backend: str | None = None, caps=None) -> torch.Tensor:
    """Triangles = sum((L @ L) o L) with L strictly lower triangular, 0/1
    values, the mask fused into the chunked kernel. Returns a float64 scalar
    on L's device.

    ``backend`` must be mask-capable (``supports_mask``); ``None`` resolves
    to the first registered one (``backend_registry.masked_backends()``).
    ``plan`` defaults to a single-chunk KNL plan (one kernel launch);
    ``caps`` to the masked symbolic phase at the plan's partitions — both
    are host-only precomputations callers on a timing path hoist out."""
    from repro_torch.core import backend_registry
    from repro_torch.core.symbolic import masked_output_caps

    if backend is None:
        names = backend_registry.masked_backends()
        if not names:
            raise ValueError("no registered backend supports a fused mask")
        backend = names[0]
    spec = backend_registry.get(backend)
    if not spec.supports_mask:
        raise ValueError(
            f"backend {backend!r} does not support a fused output mask; "
            f"mask-capable: {list(backend_registry.masked_backends())}")
    if plan is None:
        plan = plan_knl(L, L, float("inf"))
    if caps is None:
        caps = masked_output_caps(L, plan.p_ac)
    C, _ = spec.run_masked(L, L, L, plan, caps.c_pad, caps=caps)
    # C's structure is exactly L's (explicit zeros where the product has no
    # contribution), so the masked sum is the sum of the stored values
    return C.data.double().sum()


def count_triangles_kkmem(L: CSR, c_pad: int | None = None) -> torch.Tensor:
    """The unfused baseline: materialize C = L x L at ``c_pad`` (defaulting
    to the host symbolic phase's capacity), then keep the entries whose
    (row, col) key L also holds. Returns a float64 scalar."""
    if c_pad is None:
        c_pad = spgemm_symbolic_host(L, L).c_pad
    C = spgemm(L, L, c_pad)
    n = L.n_cols

    def keys(m: CSR):
        live = torch.arange(m.nnz_pad, device=m.device) < m.indptr[-1]
        k = csr_row_of_entry(m) * n + m.indices.long()
        return k[live], m.data[live]

    c_keys, c_vals = keys(C)          # sorted: CSR rows, columns sorted
    l_keys, _ = keys(L)
    if c_keys.numel() == 0 or l_keys.numel() == 0:
        return torch.zeros((), dtype=torch.float64, device=L.device)
    at = torch.searchsorted(c_keys, l_keys).clamp(max=c_keys.numel() - 1)
    hit = c_keys[at] == l_keys
    return c_vals[at[hit]].double().sum()


def count_triangles_dense(L: CSR) -> torch.Tensor:
    """Dense oracle (float64)."""
    Ld = csr_to_dense(L).double()
    return ((Ld @ Ld) * (Ld != 0)).sum()
