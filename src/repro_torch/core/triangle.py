"""Linear-algebra triangle counting (paper §4.1.2, after Wolf et al. HPEC'17).

Vertices are sorted by degree, L = strictly-lower-triangular part of the
permuted adjacency; triangles = sum over nonzeros (i,j) of L of (L x L)[i, j]
— i.e. the SpGEMM result *masked* by L.

Two paths:

* :func:`count_triangles` — the fused path: the product routes through a
  mask-capable registered chunked backend (``BackendSpec.run_masked``, the
  hash accumulator by default), with the L-mask applied **inside** the
  kernel's merge, so no unmasked C is materialized. L may be slow (pinned
  host memory on the card): its roles then stream through the copy ring
  (``run_masked_placed``), or with ``slow_reads="in_place"`` the kernel
  reads them where they lie, one launch a strip (``run_masked_in_place``).
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
from repro_torch.sparse.csr import (
    CSR, csr_residence, csr_row_of_entry, csr_to_dense, resolve_device,
)


def _resolve(L: CSR, placement, device):
    """``(placement, run device)`` of a count: ``device``, the card by
    default (``device="cpu"`` runs the plain versions). On the card a pinned
    L is slow in every role and one on the card fast, unless ``placement``
    is given; a role that ``placement`` puts slow needs L in pinned memory,
    and an L in pageable host memory raises. On the CPU every role is fast
    by default."""
    from repro_torch.core.placement import ALL_FAST, ALL_SLOW

    where = csr_residence(L)
    if torch.device("cuda" if device is None else device).type == "cpu":
        if where == "card":
            raise ValueError("L is on the card in a CPU run")
        return (ALL_FAST if placement is None else placement), resolve_device(device)
    if where == "host":
        raise ValueError(
            "L is in pageable host memory in a run on the card: put it on the card "
            "with place(L, 'fast') or in pinned host memory with place(L, 'slow')")
    if placement is None:
        placement = ALL_SLOW if where == "pinned" else ALL_FAST
    if placement.slow and where != "pinned":
        raise ValueError(f"placement puts {list(placement.slow)} in slow memory but L "
                         "is on the card: move it with place(L, 'slow')")
    return placement, resolve_device(device)


def count_triangles(L: CSR, plan: ChunkPlan | None = None,
                    backend: str | None = None, caps=None, *, placement=None,
                    device=None, slow_reads: str = "ring") -> torch.Tensor:
    """Triangles = sum((L @ L) o L) with L strictly lower triangular, 0/1
    values, the mask fused into the chunked kernel. Returns a float64 scalar
    on the run device, summed there.

    ``backend`` must be mask-capable (``supports_mask``); ``None`` resolves
    to the first registered one (``backend_registry.masked_backends()``).
    ``plan`` defaults to a single-chunk KNL plan (one kernel launch);
    ``caps`` to the masked symbolic phase at the plan's partitions — both
    are host-only precomputations callers on a timing path hoist out.

    ``placement`` (a :class:`repro_torch.core.placement.Placement`) puts
    L's three roles: A (its strips), B (its chunks) and C, with the mask
    beside C. ``device=None`` runs on the card, where a pinned L is slow in
    every role and one on the card fast unless ``placement`` says otherwise;
    ``device="cpu"`` runs the plain versions. A slow role streams L's pieces
    through the copy ring; the fast roles share one whole copy of L on the
    run device, logged as one transfer apart from the events (the paper's
    DP: L as B in fast memory).

    ``slow_reads="in_place"`` (``chunked_spgemm``'s) instead launches the
    masked kernel once a strip, reading every slow role from pinned host
    memory where it lies (``run_masked_in_place``), a slow C written there and summed on
    the host; the fast roles share one copy of L on the run device, made
    with ``place(L, "fast")`` and not through the ring. A backend without an
    in-place masked kernel raises."""
    from repro_torch.core import backend_registry, copy_ring
    from repro_torch.core.chunking import SLOW_READS, in_place_refusal
    from repro_torch.core.placement import place
    from repro_torch.core.symbolic import masked_output_caps

    if slow_reads not in SLOW_READS:
        raise ValueError(f"slow_reads must be one of {SLOW_READS}, not {slow_reads!r}")
    placement, run = _resolve(L, placement, device)
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
    roles = ("A", "B", "C")
    if slow_reads == "in_place":
        if spec.run_masked_in_place is None:
            raise in_place_refusal(f"backend {backend!r} has no masked kernel that does")
        fast = L
        if len(placement.slow) < 3 and csr_residence(L) == "pinned":
            fast = place(L, "fast", run)
        A, B, M = (L if getattr(placement, r) == "slow" else fast for r in roles)
        C, _ = spec.run_masked_in_place(A, B, M, plan, caps.c_pad, caps, placement, run)
        return C.data.double().sum().to(run)
    fast = L
    if len(placement.slow) < 3 and (placement.slow or csr_residence(L) == "pinned"):
        link = copy_ring.Link(run)
        fast = link.copy_in("L", L, apart=True)
        link.finish()
    if not placement.slow:
        C, _ = spec.run_masked(fast, fast, fast, plan, caps.c_pad, caps=caps)
        # C's structure is exactly L's (explicit zeros where the product has
        # no contribution), so the masked sum is the sum of the stored values
        return C.data.double().sum()
    total = torch.zeros((), dtype=torch.float64, device=run)

    def on_strip(_, Ci):
        live = torch.arange(Ci.nnz_pad, device=run) < Ci.indptr[-1]
        total.add_(torch.where(live, Ci.data, 0).double().sum())

    A, B, M = (L if getattr(placement, r) == "slow" else fast for r in roles)
    spec.run_masked_placed(A, B, M, plan, caps.c_pad, caps, placement, run,
                           on_strip=on_strip)
    return total


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
