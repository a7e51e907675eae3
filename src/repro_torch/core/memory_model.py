"""Two-level memory cost model (paper §3) with machine presets.

The paper's decisions and relative effects flow from a small analytic model of
each memory level:

  time(op) = bytes_streamed / bandwidth  +  discrete_accesses * latency

per level, where the number of *discrete* accesses to B is derived from a reuse-
distance (LRU stack distance) simulation of KKMEM's access trace
(repro_torch.core.locality). The presets below carry the paper's hardware constants.

Calibration targets from the paper that this model reproduces (validated in the
JAX package's tests/test_memory_model.py):
  * KNL: HBM/DDR differ ~5x in bandwidth, ~equal latency -> bandwidth-bound cases
    (R x A, low delta) benefit from HBM; latency term never dominates.
  * P100: host-pinned differs in BOTH bandwidth (~20x) and latency (~5x) -> B_Pin
    placements collapse 7x-29x (Table 3); chunking becomes essential.
"""

from __future__ import annotations

import dataclasses

GiB = float(1 << 30)


@dataclasses.dataclass(frozen=True)
class MemoryLevel:
    name: str
    capacity_bytes: float
    bandwidth_Bps: float     # streaming bandwidth, bytes/s
    latency_s: float         # per discrete (non-prefetched) access
    granularity_bytes: int = 64   # transfer granularity (cache line / sector)
    concurrency: float = 64.0     # outstanding requests that overlap latency
    random_eff: float = 1.0       # fraction of stream bandwidth achieved by
                                  # scattered granule-sized reads (DRAM row-buffer
                                  # misses; MCDRAM's extra banks fare better)
    # (Little's law: a many-threaded KNL or a GPU HBM hides per-access latency
    # behind hundreds of in-flight misses; a host-pinned NVLink path does not —
    # this is exactly the bandwidth-vs-latency asymmetry the paper studies.)

    def stream_time(self, nbytes: float) -> float:
        return nbytes / self.bandwidth_Bps

    def access_time(self, n_accesses: float, bytes_per_access: float) -> float:
        """Discrete-access cost: every miss moves whole transfer granules and
        pays latency diluted by the level's sustainable concurrency. Only the
        FIRST granule of each access pays the scattered-read penalty; the rest
        of the row streams sequentially — the prefetch amortization of paper
        §3.1 (dense B rows approach stream bandwidth)."""
        lines = max(1.0, bytes_per_access / self.granularity_bytes)
        first = self.granularity_bytes / (self.bandwidth_Bps * self.random_eff)
        rest = (lines - 1.0) * self.granularity_bytes / self.bandwidth_Bps
        lat_term = self.latency_s / self.concurrency
        return n_accesses * (first + rest + lat_term)


@dataclasses.dataclass(frozen=True)
class MemorySystem:
    """A fast + slow memory pair with an explicit copy engine between them."""

    name: str
    fast: MemoryLevel
    slow: MemoryLevel
    copy_bandwidth_Bps: float   # fast<->slow copy engine (DMA / memcpy) bandwidth
    flops_peak: float           # peak FLOP/s of the compute attached to this memory
    spgemm_core_rate: float = 0.0
    # Sustained FLOP/s through the scalar accumulator pipeline (hash inserts,
    # index arithmetic) — SpGEMM never runs at vector peak. The paper's measured
    # ceilings: ~5 GFLOP/s on KNL (Fig 3/4, Table 2), ~23 GFLOP/s on P100
    # (Fig 6/7). This cap is what closes the DDR/HBM gap at high delta (Table 2).

    def copy_time(self, nbytes: float) -> float:
        return nbytes / self.copy_bandwidth_Bps

    def level(self, space: str) -> MemoryLevel:
        if space == "fast":
            return self.fast
        if space == "slow":
            return self.slow
        raise ValueError(f"space must be 'fast'|'slow', got {space!r}")


# ---------------------------------------------------------------------------
# presets
# ---------------------------------------------------------------------------

# Intel Xeon Phi 7250 (paper §3.2): 16 GB MCDRAM ~460 GB/s, 96 GB DDR4 ~90 GB/s.
# Latencies are comparable (MCDRAM slightly *higher*, ~150ns vs ~130ns) and both
# are hidden behind 256 hardware threads' outstanding misses — on KNL the levels
# differ in BANDWIDTH only, the paper's central premise for this machine.
KNL = MemorySystem(
    name="knl",
    fast=MemoryLevel("HBM(MCDRAM)", 16 * GiB, 460e9, 150e-9, concurrency=256,
                     random_eff=0.6),
    slow=MemoryLevel("DDR4", 96 * GiB, 90e9, 130e-9, concurrency=256,
                     random_eff=0.25),
    copy_bandwidth_Bps=90e9,   # copies bottlenecked by the DDR side
    flops_peak=3.0e12,         # ~3 TFLOP/s DP
    spgemm_core_rate=5.5e9,    # paper Fig 3/4 ceiling
)

# NVIDIA P100 + POWER8 over NVLink v1 (paper §3.3): 16 GB HBM2 ~732 GB/s ~400ns
# with thousands of warps in flight; host-pinned over NVLink ~32 GB/s at ~1.5us
# with FEW outstanding transactions — both bandwidth AND latency differ, the
# asymmetry that makes chunking essential on this machine (paper conclusion).
P100 = MemorySystem(
    name="p100",
    fast=MemoryLevel("HBM2", 16 * GiB, 732e9, 400e-9, concurrency=2048,
                     random_eff=0.8),
    slow=MemoryLevel("HostPinned(NVLink)", 512 * GiB, 32e9, 1500e-9,
                     concurrency=32),
    copy_bandwidth_Bps=32e9,
    flops_peak=4.7e12,         # DP
    spgemm_core_rate=25e9,     # paper Fig 6/7 ceiling
)

# ---------------------------------------------------------------------------
# SpGEMM cost: the paper's access-pattern analysis (§3.1) in closed form
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SpGEMMCost:
    """Per-operand time decomposition of one C = A x B under a placement."""

    t_A: float
    t_B: float
    t_C: float
    t_compute: float
    t_copy: float = 0.0

    @property
    def total(self) -> float:
        # A/C streaming overlaps poorly with B gathers in KKMEM (single pass), so
        # the model sums operand terms; compute overlaps with memory on both machines
        # (OoO cores / warps), so total = max(memory, compute) + copies.
        return max(self.t_A + self.t_B + self.t_C, self.t_compute) + self.t_copy


def spgemm_cost(system: MemorySystem, *, bytes_A: float, bytes_B: float, bytes_C: float,
                flops: float, b_row_reads: float, b_row_bytes: float,
                b_miss_fraction: float, place_A: str = "slow", place_B: str = "slow",
                place_C: str = "slow", copy_bytes: float = 0.0) -> SpGEMMCost:
    """Cost of one KKMEM numeric phase.

    The paper's access analysis (§3.1): A is streamed once; C written once; B is
    gathered row-by-row ``b_row_reads`` times of which ``b_miss_fraction`` miss the
    cache hierarchy and go to the memory level holding B (reuse-distance simulation
    provides the fraction — repro_torch.core.locality).
    """
    del bytes_B   # B traffic is the gather term: b_row_reads x b_row_bytes misses
    lA, lB, lC = (system.level(place_A), system.level(place_B), system.level(place_C))
    t_A = lA.stream_time(bytes_A)
    t_C = lC.stream_time(bytes_C)
    misses = b_row_reads * b_miss_fraction
    t_B = lB.access_time(misses, b_row_bytes)
    rate = system.spgemm_core_rate or system.flops_peak
    t_compute = flops / rate
    t_copy = system.copy_time(copy_bytes) if copy_bytes else 0.0
    return SpGEMMCost(t_A=t_A, t_B=t_B, t_C=t_C, t_compute=t_compute, t_copy=t_copy)
