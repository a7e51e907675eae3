"""Selective data placement (paper §3.2.1, Table 3).

For ``C = A x B``: A is streamed (read once), C is streamed (written once), the
accumulators are cache-resident; only B is gathered irregularly. So when the fast
memory cannot hold the whole problem, placing **only B fast** recovers most of the
fast-memory performance — *iff* B fits ("This method, DP, only works when B fits
into HBM").

The placement is recorded and its performance evaluated through the memory cost
model; the functional result does not depend on it.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.locality import LocalityStats, analyze
from repro_torch.core.memory_model import MemorySystem, SpGEMMCost, spgemm_cost
from repro_torch.sparse.csr import CSR

SPACES = ("fast", "slow")


@dataclasses.dataclass(frozen=True)
class Placement:
    """Memory space per operand of C = A x B."""

    A: str = "slow"
    B: str = "slow"
    C: str = "slow"

    def __post_init__(self):
        for k in ("A", "B", "C"):
            if getattr(self, k) not in SPACES:
                raise ValueError(f"{k} space must be one of {SPACES}")


ALL_FAST = Placement("fast", "fast", "fast")
ALL_SLOW = Placement("slow", "slow", "slow")
DP = Placement("slow", "fast", "slow")  # the paper's recommendation


def dp_recommendation(system: MemorySystem, bytes_A: float, bytes_B: float,
                      bytes_C: float, reserve_fraction: float = 0.0) -> Placement:
    """The paper's DP policy: everything fast if it fits; else B fast if *it* fits;
    else everything slow (chunking territory — see repro_torch.core.planner)."""
    cap = system.fast.capacity_bytes * (1.0 - reserve_fraction)
    if bytes_A + bytes_B + bytes_C <= cap:
        return ALL_FAST
    if bytes_B <= cap:
        return DP
    return ALL_SLOW


def paper_scale_cache(A: CSR, B: CSR, C_bytes: float = 0.0) -> float:
    """On-core cache capacity, scaled to the benchmark problem: the paper's
    problem:cache ratio of ~70x, so a small problem still misses."""
    total = A.nbytes() + B.nbytes() + float(C_bytes)
    return max(2 << 10, total / 70.0)


def placement_cost(system: MemorySystem, placement: Placement, A: CSR, B: CSR,
                   C_bytes: float, flops: float,
                   locality: LocalityStats | None = None,
                   cache_bytes: float | None = None) -> SpGEMMCost:
    """Modeled cost of one multiplication under ``placement`` (Table 3 analogue)."""
    st = locality or analyze(A, B)
    if cache_bytes is None:
        cache_bytes = paper_scale_cache(A, B, C_bytes)
    nnz_a = float(A.indptr[-1])
    return spgemm_cost(
        system,
        bytes_A=A.nbytes(),
        bytes_B=B.nbytes(),
        bytes_C=C_bytes,
        flops=flops,
        b_row_reads=float(nnz_a),
        b_row_bytes=st.avg_b_row_bytes,
        b_miss_fraction=st.miss_fraction_bytes(cache_bytes),
        place_A=placement.A,
        place_B=placement.B,
        place_C=placement.C,
    )
