"""Selective data placement (paper §3.2.1, Table 3).

For ``C = A x B``: A is streamed (read once), C is streamed (written once), the
accumulators are cache-resident; only B is gathered irregularly. So when the fast
memory cannot hold the whole problem, placing **only B fast** recovers most of the
fast-memory performance — *iff* B fits ("This method, DP, only works when B fits
into HBM").

On the card, :func:`place` realizes a placement: a ``"fast"`` operand lives
on the card, a ``"slow"`` one in pinned host memory. ``chunked_spgemm``
with a slow operand stages every piece its ``ChunkStats`` counts across the
link through the two-slot copy ring (``repro_torch.core.copy_ring``); the
kernels never read host memory in place. :func:`resolve_placement` decides
a call's placement and run device. The cost model below prices a placement
without running it.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.locality import LocalityStats, analyze
from repro_torch.core.memory_model import MemorySystem, SpGEMMCost, spgemm_cost
from repro_torch.sparse.csr import (
    CSR, csr_pin, csr_residence, resolve_device, tensor_pin,
)

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

    def fast_bytes(self, bytes_A: float, bytes_B: float, bytes_C: float) -> float:
        return (
            (bytes_A if self.A == "fast" else 0.0)
            + (bytes_B if self.B == "fast" else 0.0)
            + (bytes_C if self.C == "fast" else 0.0)
        )

    @property
    def slow(self) -> tuple:
        """The operands placed in slow memory, in (A, B, C) order."""
        return tuple(k for k in ("A", "B", "C") if getattr(self, k) == "slow")


ALL_FAST = Placement("fast", "fast", "fast")
ALL_SLOW = Placement("slow", "slow", "slow")
DP = Placement("slow", "fast", "slow")  # the paper's recommendation

# the paper's Table 3 placements, by its names
TABLE3 = {
    "HBM": ALL_FAST,
    "A_Pin": Placement("slow", "fast", "fast"),
    "B_Pin": Placement("fast", "slow", "fast"),
    "C_Pin": Placement("fast", "fast", "slow"),
    "HostPin": ALL_SLOW,
    "DP": DP,
}


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


def place(operand, space: str, device=None):
    """Put an operand in a memory space: a :class:`CSR`, a tensor, or a
    tuple, list or dict of them.

    ``"fast"`` moves it to ``device`` (``None`` = the card); ``"slow"`` puts
    it in pinned host memory. On the CPU (``device="cpu"``) nothing can be
    pinned: both spaces are host memory there, and a call names the
    placement explicitly instead (``chunked_spgemm(..., placement=...)``).
    """
    if space not in SPACES:
        raise ValueError(f"space must be one of {SPACES}")
    if isinstance(operand, dict):
        return {k: place(v, space, device) for k, v in operand.items()}
    if isinstance(operand, (tuple, list)):
        return type(operand)(place(v, space, device) for v in operand)
    dev = resolve_device(device)
    if isinstance(operand, CSR):
        if space == "slow" and dev.type == "cuda":
            return csr_pin(operand)
        target = dev if space == "fast" else torch.device("cpu")
        return CSR(operand.indptr.to(target), operand.indices.to(target),
                   operand.data.to(target), operand.shape, operand.max_row_nnz)
    if not isinstance(operand, torch.Tensor):
        raise TypeError(f"cannot place a {type(operand).__name__}")
    if space == "slow" and dev.type == "cuda":
        return tensor_pin(operand)
    return operand.to(dev if space == "fast" else torch.device("cpu"))


def resolve_placement(operands: dict, placement: Placement | None, device):
    """``(placement, run device)`` of one call over ``operands`` (``{"A":
    A, "B": B}``; C is the output).

    The run device is ``device``; ``None`` means the card, and a CPU run
    (the kernels' plain versions) is asked for with ``device="cpu"``. On the
    card, a ``placement`` of ``None`` is read from the operands: a pinned
    operand is slow, one on the card fast, and C takes A's space (its strips
    follow A's); a pageable host operand raises. A given placement must
    agree with where the operands are. On the CPU every operand is host
    memory, and the placement is the one given (all fast by default).
    """
    where = {k: csr_residence(m) for k, m in operands.items()}
    if torch.device("cuda" if device is None else device).type == "cpu":
        if "card" in where.values():
            raise ValueError(f"operands on the card {where} in a CPU run")
        return (ALL_FAST if placement is None else placement), resolve_device(device)
    host = [k for k, w in where.items() if w == "host"]
    if host:
        raise ValueError(
            f"operand(s) {host} are in pageable host memory in a run on the card: "
            "put each on the card with place(x, 'fast') or in pinned host memory "
            "with place(x, 'slow')")
    if placement is None:
        space = {k: "slow" if w == "pinned" else "fast" for k, w in where.items()}
        placement = Placement(space["A"], space["B"], space["A"])
    for k, w in where.items():
        want = "pinned" if getattr(placement, k) == "slow" else "card"
        if w != want:
            raise ValueError(
                f"placement puts {k} in {getattr(placement, k)} memory but it is "
                f"{'on the card' if w == 'card' else 'in pinned host memory'}: "
                f"move it with place({k}, {getattr(placement, k)!r})")
    return placement, resolve_device(device)

