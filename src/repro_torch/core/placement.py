"""Selective data placement (paper §3.2.1, Table 3).

For ``C = A x B``: A is streamed (read once), C is streamed (written once), the
accumulators are cache-resident; only B is gathered irregularly. So when the fast
memory cannot hold the whole problem, placing **only B fast** recovers most of the
fast-memory performance — *iff* B fits ("This method, DP, only works when B fits
into HBM").

On the card, :func:`place` realizes a placement: a ``"fast"`` operand lives
on the card, a ``"slow"`` one in pinned host memory. Every entry point
(``chunked_spgemm``, ``count_triangles``, ``pipeline_spgemm``,
``chunked_spgemm_batched``, ``SpGEMMService``) with a slow operand by
default stages every piece its ``ChunkStats`` counts across the link
through the two-slot copy ring (``repro_torch.core.copy_ring``: the paper's
chunking, ``copy2Fast``). Every entry point also takes
``slow_reads="in_place"``: the streaming kernels (``pallas``, ``sparse``,
``hash`` and the masked hash kernel) then read a slow operand where it
lies, through the address the card maps pinned memory at, one launch a
strip of the plan, as the reference's ``memory_space=ANY`` operands in
``pinned_host`` memory are read (the paper's data placement, Table 3).
:func:`resolve_placement` decides a call's placement and run device,
:func:`resolve_batch_placement` a batch's (one for all its instances) and
:func:`resolve_pipeline_placement` a two-hop pipeline's
(:class:`PipelinePlacement`). :func:`card_bytes` models the card memory a
call holds under either route (:func:`strip_workspace` one in-place
launch's workspace); the cost model below prices a placement without
running it.
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


def card_bytes(plan, placement: Placement, *, a_stage: int, slab: int, c_stage: int,
               workspace: int, c_bytes: int, fast_parts: dict | None = None,
               slow_reads: str = "ring") -> dict:
    """The card's bytes a placed chunked call holds at its peak, by part.

    ``a_stage``, ``slab`` and ``c_stage`` are the staged piece bytes of
    ``chunk_stream.planned_events`` (an A strip, a B chunk, a strip's C),
    ``c_bytes`` those of the assembled C, ``workspace`` one launch's (the
    kernel's slabs, tables and outputs on the card): in place, where the
    kernel launches once a strip, one strip's (:func:`strip_workspace`). A fast operand's parts
    are upper bounds: its stack counted twice, as it is built from its
    pieces (or the live peak of building it, where ``fast_parts`` gives one:
    operand -> bytes).

    Through the copy ring (``slow_reads="ring"``) a slow operand holds its
    two ring slots; C its slots and carried steps in the chunk1 orders
    (chunk2 keeps the whole block and its next version), and its kept strips
    and the assembled C when C is fast. Read in place (``"in_place"``) a slow
    operand, C included, holds no byte of the card; a fast C holds its empty
    C_prev block, the launch's output block and the assembled C."""
    n_ac, n_b = plan.n_ac, plan.n_b
    fast = {k: getattr(placement, k) == "fast" for k in "ABC"}
    if slow_reads == "in_place":
        parts = {"A": 2 * a_stage * n_ac if fast["A"] else 0,
                 "B": 2 * slab * n_b if fast["B"] else 0, **(fast_parts or {})}
        parts.setdefault("C", 2 * n_ac * c_stage + c_bytes if fast["C"] else 0)
    else:
        parts = {"A": 2 * a_stage * (n_ac if fast["A"] else 1),
                 "B": 2 * slab * (n_b if fast["B"] else 1), **(fast_parts or {})}
        if plan.algorithm == "chunk2":
            c = 2 * n_ac * c_stage + (c_bytes if fast["C"] else 0)
        elif not fast["C"]:
            c = 4 * c_stage               # two slots, the carried step and its next
        else:
            c = (n_ac + 2) * c_stage + c_bytes
        parts.setdefault("C", c)
    parts["workspace"] = workspace
    parts["total"] = sum(parts.values())
    return parts


def strip_workspace(backend: str, *, strip_rows: int, n_b: int, row_cap: int = 0,
                    width: int = 1) -> int:
    """The card bytes one in-place launch allocates beside its operands and
    output: one strip of the plan, of ``width`` instances. A CSR
    accumulator (``sparse``, ``hash``) holds a row's slab of ``row_cap``
    columns and values and its count (``8 * row_cap + 4`` bytes a row; the
    hash kernel's ``row_cap`` is its table), the overflow flag and the
    chunk ranges; the ESC merge's counted classes add their work list and
    global workspace (its ``EscLaunch``), which the caller adds. The dense
    slab holds its chunk starts."""
    if backend == "pallas":
        return 4 * n_b
    return width * strip_rows * (8 * row_cap + 4) + 4 + 8 * n_b


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


def _resolve_spaces(operands: dict, given: dict, device, c_from: str) -> dict:
    """The space of each of ``operands`` and of their output ``"C"`` in one
    call, from ``given`` (a space or ``None`` each; ``None`` reads the
    operand, and an unnamed C takes ``c_from``'s space): on the CPU every
    operand is host memory and ``None`` is fast; on the card a pinned
    operand is slow and one on the card fast, a pageable host operand
    raises, and a given space must agree with where the operand is."""
    where = {k: csr_residence(m) for k, m in operands.items()}
    if torch.device("cuda" if device is None else device).type == "cpu":
        if "card" in where.values():
            raise ValueError(f"operands on the card {where} in a CPU run")
        spaces = {k: given.get(k) or "fast" for k in operands}
        return {**spaces, "C": given.get("C") or spaces[c_from]}
    host = [k for k, w in where.items() if w == "host"]
    if host:
        raise ValueError(
            f"operand(s) {host} are in pageable host memory in a run on the card: "
            "put each on the card with place(x, 'fast') or in pinned host memory "
            "with place(x, 'slow')")
    spaces = {k: given.get(k) or ("slow" if w == "pinned" else "fast")
              for k, w in where.items()}
    spaces["C"] = given.get("C") or spaces[c_from]
    for k, w in where.items():
        want = "pinned" if spaces[k] == "slow" else "card"
        if w != want:
            raise ValueError(
                f"placement puts {k} in {spaces[k]} memory but it is "
                f"{'on the card' if w == 'card' else 'in pinned host memory'}: "
                f"move it with place({k}, {spaces[k]!r})")
    return spaces


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
    given = {} if placement is None else dataclasses.asdict(placement)
    spaces = _resolve_spaces(operands, given, device, "A")
    return Placement(spaces["A"], spaces["B"], spaces["C"]), resolve_device(device)


def resolve_batch_placement(As: list, Bs: list, placement: Placement | None, device):
    """:func:`resolve_placement` of a batch, whose instances share one
    placement: a batch that mixes spaces raises."""
    given = {} if placement is None else dataclasses.asdict(placement)
    found = {tuple(_resolve_spaces({"A": A, "B": B}, given, device, "A").values())
             for A, B in zip(As, Bs)}
    if len(found) > 1:
        raise ValueError(
            f"a batch shares one placement, but its instances' operands lie in "
            f"{sorted(found)} (A, B, C): place every instance's operands alike")
    return Placement(*found.pop()), resolve_device(device)


@dataclasses.dataclass(frozen=True)
class PipelinePlacement:
    """Memory space per operand of the two-hop ``C = R x (A x P)``
    (``pipeline_spgemm``); ``None`` reads the space from the operand (on
    the card: pinned is slow, on the card fast, C takes R's space; on the
    CPU: fast). The intermediate T is not placed: it is fast when the plan
    keeps it resident and slow when it spills."""

    A: str | None = None
    P: str | None = None
    R: str | None = None
    C: str | None = None

    def __post_init__(self):
        for k in ("A", "P", "R", "C"):
            if getattr(self, k) not in (*SPACES, None):
                raise ValueError(f"{k} space must be one of {SPACES} or None")

    def hop1(self, t: str) -> Placement:
        """T = A x P with T in space ``t``."""
        return Placement(self.A, self.P, t)

    def hop2(self, t: str) -> Placement:
        """C = R x T with T in space ``t``."""
        return Placement(self.R, t, self.C)


# Table 3's all-fast, all-slow and DP placements of the Galerkin product
PIPELINE_TABLE3 = {
    "HBM": PipelinePlacement("fast", "fast", "fast", "fast"),
    "HostPin": PipelinePlacement("slow", "slow", "slow", "slow"),
    "DP": PipelinePlacement("slow", "fast", "slow", "slow"),
}


def resolve_pipeline_placement(operands: dict, placement: PipelinePlacement | None,
                               device):
    """``(placement, run device)`` of one ``pipeline_spgemm`` over
    ``{"A": A, "P": P, "R": R}``, every field resolved as
    :func:`resolve_placement` resolves a call's, C taking R's space (its
    strips follow R's)."""
    given = {} if placement is None else dataclasses.asdict(placement)
    spaces = _resolve_spaces(operands, given, device, "R")
    return PipelinePlacement(**spaces), resolve_device(device)
