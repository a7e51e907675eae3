"""Drive the PyTorch port's chunked-SpGEMM main path on one H100 and check it.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the CUDA kernels of
``src/repro_torch/kernels/csrc`` (into ``build/repro_torch/``; the dense-slab,
decode-attention, BSR x BSR, ESC and both hash sources must build without
register spills), finds the
tensor-core instructions in the libraries of the two routed kernels
(``cuobjdump -sass``: HMMA in the prefill's, HGMMA and HMMA in the grouped
GEMM's), holds each kernel, in both streaming orders, against its plain PyTorch version at the
shapes the main path stages, at a four-chunk plan with a nonzero C_prev, and
on a small geometry whose dense output row fills its hash table (the dense
slab on its aligned float4 path at the main-path shapes and on its masked
scalar path at the four-chunk plan, its two orders equal bit for bit; the
ESC kernel also where its sort leaves the register classes: shared memory
and 64-bit keys; the hash kernel also where its extraction compacts a wide
table before the register sort and where it sorts in shared memory; the CSR
kernels also timed by the profiler, split by kernel), then runs
the main path — ``multigrid.problem`` on the card, the host
symbolic phase and planner, ``chunked_spgemm`` — on the paper's problems, and
checks every result against the port's plain ``spgemm`` on the card and
against ``scipy.sparse`` in float64. Then the second path: fused-mask
triangle counting on a graph500 scale-18 RMAT graph (``count_triangles``,
the masked hash kernel, one chunk and a chunk2 plan), the two-hop Galerkin
product ``R x (A x P)`` on brick3d n=48 (``pipeline_spgemm`` through the
hash and ESC kernels, intermediate resident and spilled), the ``bsr``
backend on brick3d n=48 and ``ops.bsr_spmm`` of brick3d n=48 by a
110,592 x 128 dense block, each held to scipy in float64, with the masked
(also with its rows cut at a forced small part size, in chunk2 with a
nonzero C_prev; timed by the profiler, launch by launch), BSR x BSR (also
with sentinels inside rows, 40 steps a row, blocks of 4 and 16; timed by
the profiler) and BSR x dense kernels first held to their plain versions.
Then
the third path, serving: the flash-prefill and decode-attention kernels
held to their plain versions in f32 and bf16 (the prefill kernel's FMA and
tensor-core routes) at the serve run's shapes (the decode kernel at both
serve models' shapes, timed by launch events and by the profiler beside
SDPA) and on small ragged cases (GQA groups of 1 and 4 at D = 64, and of 1,
3, 4, 8 and 9 at D = 128; for decode also fewer live positions than cache
splits), then
``serve_batch`` of Llama-3.2-1B at full width
(random weights from a seed, 8 prompts of 128-2048 tokens, 32 new tokens),
its kernel launches counted, and its prefill and per-step logits held,
teacher-forced on its own tokens, to the same model with the two kernels
swapped for their plain versions, and one decode step and one prefill
traced. Then the fourth path, MoE serving: the grouped-GEMM kernel held to
its plain version in bf16 by each of its three routes (tile, small, fma)
and in f32 at the shapes of OLMoE-1B-7B's first expert product (prefill and
decode, from the serve batch's own routing), on ragged edge cases (where a
forced tensor-core route the operands do not fit must raise) and through
the padded ``ops.grouped_matmul``; one full-width MoE layer through the
kernel path and the plain path; ``serve_batch`` of OLMoE-1B-7B at full
width, its launches counted by route, one prefill and one decode step
traced, and its bf16 logits and routes compared with the plain path
(printed); and the same model in f32, teacher-forced through both paths,
its launches all on the fma routes and its logits held to the plain path's.
Every line of output is one JSON object; the last one is
``{"ok": true, "device": ...}``. Any failed check raises, so the exit code
is not 0. Without a CUDA card, or without the package beside this file, it
exits with code 2 and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Data-sheet peaks of the H100 SXM (NVIDIA H100 data sheet: HBM3 bandwidth,
# FP32 outside the tensor cores, dense bf16 on the tensor cores, at 700 W),
# the card nvidia-smi names "NVIDIA H100 80GB HBM3". Another card has no
# peaks here and stops the run.
PEAK = {"part": "H100 SXM", "smi_name": "H100 80GB HBM3",
        "bytes_per_s": 3.35e12, "f32_flops": 67e12, "bf16_flops": 989e12}

# tolerances: float32 sums taken in another order (and, for the hash kernel,
# in atomic order) than the plain version's
KERNEL_ATOL, KERNEL_RTOL = 1e-4, 1e-5
SCIPY_RTOL = 1e-4

ORDERS = ("chunk1", "chunk2")
EDGE_SEED = 108

REPLACES = {
    "ranged_spgemm": "src/repro/kernels/ranged_spgemm.py:131",
    "sparse_accum_spgemm": "src/repro/kernels/sparse_accum_spgemm.py:173",
    "hash_accum_spgemm": "src/repro/kernels/hash_accum_spgemm.py:310",
    "hash_masked_accum_spgemm": "src/repro/kernels/hash_accum_spgemm.py:289",
    "bsr_spgemm": "src/repro/kernels/bsr_spgemm.py:174",
    "bsr_spmm": "src/repro/kernels/bsr_spmm.py:67",
    "flash_prefill": "src/repro/kernels/flash_prefill.py:77",
    "decode_attention": "src/repro/kernels/chunked_attention.py:62",
    "grouped_matmul": "src/repro/kernels/grouped_matmul.py:41",
}
SOURCE_FILE = {"decode_attention": "chunked_attention"}   # kernel -> csrc/<file>.cu
# kernels with several routes (their wrappers count each route's launches),
# the tensor-core instructions their built libraries must hold, and the
# names their CUDA kernels have in a profiler trace
ROUTED = ("flash_prefill", "grouped_matmul")
SASS_OPS = {"flash_prefill": ("HMMA",), "grouped_matmul": ("HGMMA", "HMMA")}
TRACE_NAMES = {"flash_prefill": ("flash_prefill_kernel", "flash_prefill_tc_kernel"),
               "decode_attention": ("decode_split_kernel", "decode_combine_kernel"),
               "grouped_matmul": ("gmm_tile_kernel", "gmm_small_kernel",
                                  "grouped_matmul_kernel"),
               "bsr_spgemm": ("bsr_spgemm",),
               "hash_masked_accum_spgemm": ("masked_part_kernel", "masked_seed_kernel",
                                            "masked_gather_kernel"),
               # the CSR-output skeleton's three kernels (ESC and hash merges)
               "csr_accum": ("accum_rows_kernel", "scan_rows_kernel", "copy_rows_kernel")}
TRACE_TRIES = 3   # traces of one call taken until one holds every expected launch
# sources whose kernels must build without register spills: those whose
# register tiles or sorts were sized to fit (the dense slab's 8 x 8 FMA tile,
# the decode kernel's row tiles, the BSR warp's output tile, the ESC merge's
# register sort), and the two hash sources
NO_SPILL = ("ranged_spgemm", "chunked_attention", "bsr_spgemm", "sparse_accum_spgemm",
            "hash_accum_spgemm", "hash_masked_accum_spgemm")
# the dense slab's load path each of its recorded phases must take: the
# quickstart staging is 16-byte aligned (float4 / cp.async), the chunk1
# staging (k_pad 42,043, span 9,275) is not (masked scalar loads)
DENSE_PATHS = {"brick3d32_quickstart": "vec", "brick3d32_chunk1_c0": "scalar"}

# the attention kernels against their plain versions: in f32 the sums are
# taken in another order; in bf16 both versions sum the same bf16 inputs in
# f32 and round once, so an order difference can move an output by one bf16
# ulp at a rounding boundary (two allowed, plus the f32 tolerance near zero)
ATTN_F32_ATOL = 2e-5
ATTN_BF16_ULPS = 2
# the GQA groups (query heads per KV head) and head widths of the ragged
# attention cases: Llama's D = 64, and D = 128 at the groups of the ported
# configs (1 OLMoE, 3 minitron-4b, 4, 8 deepseek-67b, 9 starcoder2-7b; 9
# does not divide the prefill kernels' 64-row query tile)
ATTN_RAGGED_GQA = ((1, 64), (4, 64), (1, 128), (3, 128), (4, 128), (8, 128), (9, 128))
# the serve run: Llama-3.2-1B at full width, random weights and prompts
LM_ARCH, LM_WEIGHT_SEED, LM_PROMPT_SEED = "llama3.2-1b", 1234, 13
LM_BATCH, LM_PROMPT_LENS, LM_CACHE, LM_NEW = 8, (128, 2048), 4096, 32
# teacher-forced logits, kernel path against the plain path, relative to the
# std of the plain logits: the model computes in bf16, so an f32 summation
# order difference in attention becomes one-ulp rounding flips of the bf16
# hidden state that cascade through 16 layers and shift every logit a
# little; a wrong mask or a wrong length moves them by the order of the std
LOGIT_MAX_TOL, LOGIT_MEAN_TOL = 0.25, 0.03
# the MoE serve run: OLMoE-1B-7B at full width, the Llama run's prompts
# (same seed and lengths), weights from LM_WEIGHT_SEED
MOE_ARCH = "olmoe-1b-7b"
# the grouped GEMM against its plain version: f32 sums in another order
# (the reference's atol with an rtol for the order); bf16 outputs of the
# same f32 sums rounded once, so within two ulps (plus the f32 atol near 0)
GMM_F32_ATOL, GMM_F32_RTOL, GMM_BF16_ULPS = 1e-4, 1e-5, 2
GMM_EDGE_SEED = 14
GMM_PREFILL_LABEL = "serve_prefill_layer0_w1"   # the grouped GEMM's two served shapes
GMM_DECODE_LABEL = "serve_decode_layer0_w1"
# the f32 end-to-end gate: teacher-forced logits of the kernel path against
# the plain path, relative to the plain logits' std (summation order only:
# in f32 no rounding flip of a near-tied route is plausible)
F32_LOGIT_MAX_TOL, F32_LOGIT_MEAN_TOL = 0.01, 0.001
RMAT_SCALE, RMAT_EDGE_FACTOR, RMAT_SEED = 18, 16, 7   # graph500-style, ISSUE size
MASKED_SPLIT_PART = 256   # the part size forced on the masked kernel's split case
BSR_BLOCK = 8
SPMM_COLS, SPMM_SEED = 128, 12
# pipeline fast limits, as fractions of size(A) + size(P) + size(R): at the
# whole size the intermediate stays resident between chunked hops; at half it
# spills (the planner's choice at every brick3d size tried)
PIPE_RESIDENT, PIPE_SPILL = 1.0, 0.5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(torch, fn, reps: int = 5, warmup: int = 1) -> float:
    """Median milliseconds of ``fn`` by CUDA events, after ``warmup`` calls:
    the whole call, host work between its launches included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profiled(torch, fn):
    """A torch.profiler trace of one call of ``fn``."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def device_busy_ms(prof) -> float:
    """Summed durations of a trace's device activities (kernels, copies, fills)."""
    from torch.autograd import DeviceType

    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3


def device_by_name(prof) -> dict:
    """A trace's device activities by name: (summed ms, count) of each."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return by_name


def traced_call(torch, fn, want: dict | None = None, top: int = 8) -> dict:
    """One call of ``fn`` under the profiler: its wall ms (the profiler's
    cost included), the device's busy ms and share of it, the number of
    device activities, the ``top`` names by device ms with their counts, and
    the device ms and launches of each port kernel (``TRACE_NAMES``). The
    profiler loses activities of some calls, so up to ``TRACE_TRIES`` calls
    are traced until one holds the launches ``want`` gives (kernel ->
    count); ``complete`` says whether one did."""
    for tries in range(1, TRACE_TRIES + 1):
        wall = []

        def call():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        by_name = device_by_name(profiled(torch, call))
        kernels = {}
        for kernel, names in TRACE_NAMES.items():
            hits = [v for name, v in by_name.items() if any(n in name for n in names)]
            kernels[kernel] = {"device_ms": sum(ms for ms, _ in hits),
                               "launches": sum(c for _, c in hits)}
        complete = all(kernels[k]["launches"] == n for k, n in (want or {}).items())
        if complete:
            break
    busy = sum(ms for ms, _ in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_ms": wall[0], "device_busy_ms": busy,
            "device_busy_share": busy / wall[0] if busy > 0 else None,
            "device_activities": sum(n for _, n in by_name.values()),
            "port_kernels": kernels, "expected_launches": want, "complete": complete,
            "traces": tries,
            "top_device_ms": {name: ms for name, (ms, _) in ranked},
            "top_device_launches": {name: n for name, (_, n) in ranked}}


def bound_of(moved: int, flops: int, flop_rate: str) -> dict:
    """The least time of a function on this card: its bytes over the memory
    rate or its operations over the peak rate ``flop_rate``, the larger."""
    t_bytes = moved / PEAK["bytes_per_s"] * 1e3
    t_ops = flops / PEAK[flop_rate] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def library_fields(library, bound_ms: float) -> dict:
    """A phase's library yardstick (wall ms, device ms, empty traces, error
    text) for the kernels line. A time under the phase's bound comes from a
    partial measurement (no complete run of the same work can take less),
    so it is recorded as lost, with the reason, as a device time is when
    every trace came back empty."""
    wall, device, empty, error = library
    lost = {}
    if wall is not None and device is None and empty:
        lost["device"] = f"{empty} of {empty} profiler traces held no device activity"
    for key, value in (("wall", wall), ("device", device)):
        if value is not None and value < bound_ms:
            lost[key] = (f"{value} ms is under the {bound_ms} ms bound: the measurement "
                         "saw only part of the work")
    return {"library_ms": None if "wall" in lost else wall,
            "library_device_ms": None if "device" in lost else device,
            "library_lost": lost or None, "library_error": error}


def device_ms(torch, fn, reps: int = 5) -> tuple:
    """Median device milliseconds of one call of a PyTorch function, one
    profiler trace per call, after a warm-up call, and the number of traces
    that saw no device activity at all: the profiler loses some calls whose
    kernel runs for hundreds of milliseconds, and those are left out (None
    when all are)."""
    fn()
    torch.cuda.synchronize()
    times = [device_busy_ms(profiled(torch, fn)) for _ in range(reps)]
    seen = [t for t in times if t > 0]
    return (statistics.median(seen) if seen else None), reps - len(seen)


def kernel_device_split(torch, fn, names, launches: int, reps: int = 5,
                        tries: int = 20) -> tuple:
    """Median device milliseconds of the port kernels (activities whose
    name holds one of ``names``) that one call of ``fn`` launches, over
    ``reps`` profiler traces that hold all ``launches`` of them, after a
    warm-up call; the profiler loses activities of some calls, so up to
    ``tries`` calls are traced. Returns the median (None when no trace was
    complete), the number of incomplete traces, and per name the median of
    its share over the complete traces."""
    fn()
    torch.cuda.synchronize()
    times, split, incomplete = [], {n: [] for n in names}, 0
    while len(times) < reps and len(times) + incomplete < tries:
        by_name = device_by_name(profiled(torch, fn))
        hits = {n: [v for name, v in by_name.items() if n in name] for n in names}
        if sum(c for vs in hits.values() for _, c in vs) == launches:
            times.append(sum(ms for vs in hits.values() for ms, _ in vs))
            for n, vs in hits.items():
                split[n].append(sum(ms for ms, _ in vs))
        else:
            incomplete += 1
    return ((statistics.median(times) if times else None), incomplete,
            {n: statistics.median(v) for n, v in split.items() if v})


def device_launch_list(torch, fn, names, launches: int, tries: int = 10) -> list | None:
    """The device ms of each launch of the port kernels (activities whose
    name holds one of ``names``) in one call of ``fn``, in launch order, from
    the first of up to ``tries`` traces that holds all ``launches`` of them
    (None when none does)."""
    from torch.autograd import DeviceType

    for _ in range(tries):
        events = [e for e in profiled(torch, fn).events()
                  if e.device_type == DeviceType.CUDA and any(n in e.name for n in names)]
        if len(events) == launches:
            events.sort(key=lambda e: e.time_range.start)
            return [e.time_range.elapsed_us() / 1e3 for e in events]
    return None


def kernel_device_ms(torch, fn, names, launches: int, reps: int = 5,
                     tries: int = 20) -> tuple:
    """``kernel_device_split`` without the split: (median, incomplete)."""
    return kernel_device_split(torch, fn, names, launches, reps, tries)[:2]


def launch_ms(torch, timer_cls, fn, reps: int = 5) -> float:
    """Median milliseconds of the kernels one wrapper call launches, from
    events recorded on the stream around each launch, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        with timer_cls() as timer:
            fn()
        times.append(timer.ms())
    check(min(times) > 0, "a timed call launched no kernel")
    return statistics.median(times)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def live_bytes(st) -> int:
    """Bytes of a stacked CSR that a kernel must read: every indptr, and the
    entries each element's indptr bounds (not the padded tails)."""
    nnz = int(st.indptr[..., -1].sum())
    return nbytes(st.indptr) + nnz * (st.indices.element_size() + st.data.element_size())


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        from repro_torch.core import chunking, kkmem, memory_model, planner, symbolic
        from repro_torch.core import chunk_stream, pipeline_spgemm, triangle
        from repro_torch.kernels import (
            _build, bsr_spgemm, bsr_spmm, chunked_attention, flash_prefill, grouped_matmul,
            hash_accum_spgemm, ops, ranged_spgemm, sparse_accum_spgemm,
        )
        from repro_torch.launch import serve
        from repro_torch.models import moe, transformer
        from repro_torch.sparse import bsr, csr, graphs, multigrid

        self.m = dict(chunking=chunking, kkmem=kkmem, memory_model=memory_model,
                      planner=planner, symbolic=symbolic, chunk_stream=chunk_stream,
                      build=_build, csr=csr, multigrid=multigrid, graphs=graphs,
                      bsr=bsr, triangle=triangle, pipeline=pipeline_spgemm, ops=ops,
                      serve=serve, transformer=transformer, moe=moe)
        self.kernels = {"ranged_spgemm": ranged_spgemm,
                        "sparse_accum_spgemm": sparse_accum_spgemm,
                        "hash_accum_spgemm": hash_accum_spgemm,
                        "hash_masked_accum_spgemm": hash_accum_spgemm,
                        "bsr_spgemm": bsr_spgemm, "bsr_spmm": bsr_spmm,
                        "flash_prefill": flash_prefill,
                        "decode_attention": chunked_attention,
                        "grouped_matmul": grouped_matmul}
        # each kernel's launch counter (the masked kernel's wrapper lives in
        # the hash module)
        self.counters = {k: mod.LAUNCHES for k, mod in self.kernels.items()}
        self.counters["hash_masked_accum_spgemm"] = hash_accum_spgemm.MASKED_LAUNCHES
        # the routes of the two kernels that have several, as "kernel/route"
        for kernel in ROUTED:
            for route, counter in self.kernels[kernel].ROUTE_LAUNCHES.items():
                self.counters[f"{kernel}/{route}"] = counter
        self.backend_kernel = {"pallas": "ranged_spgemm",
                               "sparse": "sparse_accum_spgemm",
                               "hash": "hash_accum_spgemm",
                               "bsr": "bsr_spgemm"}
        self.problems = {}
        self.restrictions = {}
        self.phase = {}       # kernel -> numbers of its recorded kernel phase
        self.max_err = {}     # kernel -> largest error against its plain version
        self.launches = {}    # kernel -> launches in its main-path run
        # "kernel/route" -> (the run that launches the route on the main
        # path, its launches there); (kernel, route, shape) -> the numbers of
        # that route's kernels-line row at that shape
        self.route_runs = {}
        self.route_rows = {}

    # -- setup -------------------------------------------------------------

    def card(self) -> dict:
        torch = self.torch
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
        name = torch.cuda.get_device_name(0)
        check(PEAK["smi_name"] in smi,
              f"nvidia-smi names {smi!r}; the bounds need the peaks of that card, "
              f"and only the {PEAK['part']}'s ({PEAK['smi_name']}) are known here")
        info = {"nvidia_smi": smi, "device_name": name,
                "device_count": torch.cuda.device_count(),
                "torch": torch.__version__, "cuda": torch.version.cuda,
                "peaks": PEAK}
        emit({"card": info})
        return info

    def launch_ms(self, fn) -> float:
        return launch_ms(self.torch, self.m["build"].LaunchTimer, fn)

    def reset_counters(self) -> None:
        for counter in self.counters.values():
            counter.reset()

    def read_counters(self) -> dict:
        return {k: c.count for k, c in self.counters.items()}

    def build(self) -> None:
        t0 = time.perf_counter()
        log = self.m["build"].build()
        seconds = time.perf_counter() - t0
        resources = {name: entry["kernels"] for name, entry in log.items()}
        emit({"build": {"seconds": seconds,
                        "per_source_s": {k: v["seconds"] for k, v in log.items()},
                        "ptxas": resources}})
        for name in NO_SPILL:
            for entry, res in resources[name].items():
                check(res["spill_stores"] == 0 and res["spill_loads"] == 0,
                      f"{name}: {entry} spills {res['spill_stores']} / "
                      f"{res['spill_loads']} bytes (stores / loads)")

    def sass_phase(self) -> None:
        """The tensor-core instructions in the built libraries of the routed
        kernels, counted in ``cuobjdump -sass`` (from nvcc's own directory):
        HGMMA is wgmma (the grouped GEMM's tile route), HMMA mma.sync (the
        prefill's tc route, the grouped GEMM's small route)."""
        b = self.m["build"]
        tool = Path(b.nvcc_path()).parent / "cuobjdump"
        check(tool.exists(), f"{tool} is missing: the SASS check cannot run")
        counts = {}
        for name, ops in SASS_OPS.items():
            sass = subprocess.run([str(tool), "-sass", str(b.BUILD_DIR / f"lib{name}.so")],
                                  capture_output=True, text=True, timeout=300,
                                  check=True).stdout
            counts[name] = {op: sass.count(op) for op in ops}
            for op in ops:
                check(counts[name][op] > 0, f"lib{name}.so holds no {op} instruction")
        emit({"sass_phase": counts, "tool": str(tool)})

    def problem(self, name: str, n: int):
        key = (name, n)
        if key not in self.problems:
            t0 = time.perf_counter()
            A, R, P = self.m["multigrid"].problem(name, n, device="cuda")
            self.problems[key] = (A, P, time.perf_counter() - t0)
            self.restrictions[key] = R
        return self.problems[key][:2]

    def quickstart_inputs(self, A, P):
        """examples/quickstart.py's C row-byte estimate and budget."""
        planner = self.m["planner"]
        ws = self.m["kkmem"].spgemm_symbolic_host(A, P)
        crb = np.full(A.n_rows, max(ws.c_nnz / A.n_rows, 1) * 12.0)
        budget = (float(planner.row_bytes_csr(A).sum() + planner.row_bytes_csr(P).sum())
                  + float(crb.sum())) / 4
        return crb, budget

    # -- kernel phases -----------------------------------------------------

    def stage_csr(self, A, P, plan, c0_from=None):
        """The stacked operands ``_sparse_run`` hands the CSR kernels. C_prev
        is empty, as on the main path, unless ``c0_from`` gives a matrix whose
        strips (at the output capacity) become a nonzero C_prev."""
        ch, cs, csr = self.m["chunking"], self.m["chunk_stream"], self.m["csr"]
        strips = ch.a_strips(A, plan.p_ac)
        chunks = ch.b_chunks(P, plan.p_b)
        caps = self.m["symbolic"].strip_output_caps(A, P, plan.p_ac)
        Ast = csr.csr_stack([csr.csr_stack(strips)])
        Bst = csr.csr_stack([csr.csr_stack(chunks)])
        if c0_from is None:
            C0 = cs._sparse_c0_stack(1, plan.n_ac, strips[0].n_rows, P.n_cols,
                                     caps.c_pad, A.dtype, A.device)
        else:
            C0 = csr.csr_stack([csr.csr_stack(
                [csr.csr_pad_to(s, caps.c_pad) for s in ch.a_strips(c0_from, plan.p_ac)])])
        r0s, r1s = plan.b_ranges()
        return Ast, Bst, C0, r0s, r1s, caps

    def library_spgemm(self, A, P):
        """One torch.sparse CSR x CSR product on the card (a yardstick only):
        (wall ms, device ms, empty traces, error text if torch refuses)."""
        torch = self.torch

        def as_torch(m):
            nnz = m.nnz()
            return torch.sparse_csr_tensor(m.indptr, m.indices[:nnz], m.data[:nnz],
                                           size=m.shape, check_invariants=False)
        a, p = as_torch(A), as_torch(P)
        fn = lambda: torch.sparse.mm(a, p)  # noqa: E731
        try:
            return (cuda_ms(torch, fn), *device_ms(torch, fn), None)
        except RuntimeError as err:   # torch refuses: record why, time nothing
            return None, None, None, str(err).splitlines()[0]

    def csr_runners(self, kernel: str, Ast, Bst, C0, r0s, r1s, row_cap: int):
        """(kernel, plain version) of one CSR kernel as functions of the order."""
        mod = self.kernels[kernel]
        if kernel == "hash_accum_spgemm":
            table = self.m["planner"].hash_table_slots(row_cap)
            return (lambda order: mod.hash_accum_spgemm_stream(
                        Ast, Bst, C0, r0s, r1s, order=order, table_size=table),
                    lambda order: mod.hash_accum_plain(
                        Ast, Bst, C0, r0s, r1s, order=order, table_size=table))
        return (lambda order: mod.sparse_accum_spgemm_stream(
                    Ast, Bst, C0, r0s, r1s, order=order, row_cap=row_cap),
                lambda order: mod.sparse_accum_plain(
                    Ast, Bst, C0, r0s, r1s, order=order))

    def hold_csr(self, what: str, got, want) -> dict:
        """Structure exact, values to tolerance, of a stacked CSR triple."""
        self.torch.cuda.synchronize()
        structure = (self.torch.equal(got[0], want[0]) and self.torch.equal(got[1], want[1]))
        err = float((got[2] - want[2]).abs().max()) if got[2].numel() else 0.0
        check(structure, f"{what}: structure differs from the plain version")
        check(bool(self.torch.allclose(got[2], want[2], atol=KERNEL_ATOL, rtol=KERNEL_RTOL)),
              f"{what}: values differ from the plain version by {err}")
        return {"structure_equal": structure, "max_abs_err": err}

    def hold_dense(self, what: str, got, want) -> dict:
        err = float((got - want).abs().max())
        check(err <= KERNEL_ATOL + KERNEL_RTOL * float(want.abs().max()),
              f"{what}: values differ from the plain version by {err}")
        return {"structure_equal": True, "max_abs_err": err}

    def csr_kernel_phase(self, kernel: str, A, P, plan, main_order: str, *,
                         label: str, c0_from=None, record: bool = False) -> None:
        """One CSR kernel in both orders at the staged shapes of ``plan``,
        held against its plain version. ``record`` marks the phase whose
        numbers the kernels line reports; it also times the plain version
        and the library yardstick."""
        torch = self.torch
        Ast, Bst, C0, r0s, r1s, caps = self.stage_csr(A, P, plan, c0_from)
        run, plain = self.csr_runners(kernel, Ast, Bst, C0, r0s, r1s, caps.c_max_row_nnz)
        esc = self.kernels["sparse_accum_spgemm"]
        orders = {}
        for order in ORDERS:
            orders[order] = self.hold_csr(f"{kernel}/{label}/{order}", run(order), plain(order))
            orders[order]["ms"] = self.launch_ms(lambda: run(order))
            orders[order]["wrapper_ms"] = cuda_ms(torch, lambda: run(order))
            # the profiler's device time of the call's kernels, and by kernel
            (orders[order]["device_ms"], orders[order]["device_incomplete_traces"],
             orders[order]["device_split_ms"]) = kernel_device_split(
                torch, lambda: run(order), TRACE_NAMES["csr_accum"],
                esc.kernels_per_call(order, plan.n_b))
            if record:
                orders[order]["plain_ms"] = cuda_ms(torch, lambda: plain(order), reps=3)
        steps = (esc.sort_steps(Ast, Bst, C0, r0s, r1s, row_cap=caps.c_max_row_nnz)
                 if kernel == "sparse_accum_spgemm" else None)
        out = run(main_order)
        extract = self.extract_rows(out[0]) if kernel == "hash_accum_spgemm" else None
        moved = (live_bytes(Ast) + live_bytes(Bst) + live_bytes(C0) + nbytes(*out)
                 + 8 * len(r0s))
        flops = (self.m["symbolic"].spgemm_structure_host(A, P).flops
                 + int(C0.indptr[..., -1].sum()))
        library = self.library_spgemm(A, P) if record else (None,) * 4
        self.finish_phase(kernel, label, orders, main_order, moved, flops, library,
                          {"strips": plan.n_ac, "chunks": plan.n_b,
                           "strip_rows": Ast.n_rows, "a_cap": Ast.nnz_pad,
                           "chunk_cap": Bst.nnz_pad, "c_cap": C0.nnz_pad,
                           "nnz_c0": int(C0.indptr[..., -1].sum()),
                           "c_max_row_nnz": caps.c_max_row_nnz,
                           "esc_sort_steps": steps, "hash_extract_rows": extract}, record)

    def extract_rows(self, indptr) -> dict:
        """Rows of a hash kernel's output by the sort its extraction takes
        (``extract_class`` of each row's nnz)."""
        counts = (indptr[..., 1:] - indptr[..., :-1]).flatten().tolist()
        mod = self.kernels["hash_accum_spgemm"]
        return dict(sorted(collections.Counter(map(mod.extract_class, counts)).items()))

    def dense_stage(self, A, P, plan):
        """The dense strips (``k + span`` columns) and slabs the ``pallas``
        executors stage, with a leading batch axis."""
        ch, cs, csr = self.m["chunking"], self.m["chunk_stream"], self.m["csr"]
        Bs = csr.csr_stack(ch.b_chunks(P, plan.p_b))
        a = cs._dense_stack(csr.csr_stack(ch.a_strips(A, plan.p_ac)), levels=1,
                            pad_cols=Bs.n_rows)[None]
        return a, cs._dense_stack(Bs, levels=1)[None]

    def dense_kernel_phase(self, A, P, plan, *, label: str, c0_seed: int | None = None,
                           record: bool = False) -> None:
        """The dense-slab kernel in both orders at the staged shapes of
        ``plan``; C_prev is zero, as on the main path, or random normal from
        ``c0_seed``."""
        torch = self.torch
        mod = self.kernels["ranged_spgemm"]
        a, slabs = self.dense_stage(A, P, plan)
        shape = a.shape[:3] + (P.n_cols,)
        if c0_seed is None:
            c0 = torch.zeros(shape, dtype=torch.float32, device=a.device)
        else:
            gen = torch.Generator(device=a.device).manual_seed(c0_seed)
            c0 = torch.randn(shape, generator=gen, dtype=torch.float32, device=a.device)
        r0s, _ = plan.b_ranges()
        run = lambda order: mod.ranged_spgemm_stream(a, slabs, c0, r0s, order=order)  # noqa: E731
        plain = lambda order: mod.ranged_spgemm_plain(a, slabs, c0, r0s, order=order)  # noqa: E731
        path = mod.choose_path(a, slabs, c0, r0s)
        check(path == DENSE_PATHS.get(label, path),
              f"ranged_spgemm/{label}: path {path}, expected {DENSE_PATHS.get(label)}")
        orders, outs = {}, {}
        for order in ORDERS:
            before = mod.PATH_LAUNCHES[path].count
            outs[order] = run(order)
            check(mod.PATH_LAUNCHES[path].count == before + 1,
                  f"ranged_spgemm/{label}: the {path} path launched no kernel")
            orders[order] = self.hold_dense(f"ranged_spgemm/{label}/{order}", outs[order],
                                            plain(order))
            orders[order]["ms"] = self.launch_ms(lambda: run(order))
            orders[order]["wrapper_ms"] = cuda_ms(torch, lambda: run(order))
            if record:
                orders[order]["plain_ms"] = cuda_ms(torch, lambda: plain(order))
        bitwise = bool(torch.equal(outs["chunk1"], outs["chunk2"]))
        check(bitwise, f"ranged_spgemm/{label}: chunk1 and chunk2 differ bit for bit")
        del outs
        batch, n_ac, strip_rows, k_pad = a.shape
        n_b, span, n = slabs.shape[1:]
        # the work the real rows need: A's rows x its columns, every B row
        # once, C_prev read and C written at A's rows
        moved = 4 * (A.n_rows * A.n_cols + P.n_rows * n + 2 * A.n_rows * n) + 4 * n_b
        flops = 2 * A.n_rows * P.n_rows * n + n_b * A.n_rows * n
        library = (None,) * 4
        if record:
            def baddbmm():
                out = c0[0]
                for j, r0 in enumerate(r0s.tolist()):
                    out = torch.baddbmm(out, a[0, :, :, r0:r0 + span],
                                        slabs[0, j].expand(n_ac, span, n))
                return out
            library = (cuda_ms(torch, baddbmm), *device_ms(torch, baddbmm), None)
        self.finish_phase("ranged_spgemm", label, orders,
                          "chunk2" if plan.algorithm == "chunk2" else "chunk1",
                          moved, flops, library,
                          {"strips": n_ac, "chunks": n_b, "strip_rows": strip_rows,
                           "k_pad": k_pad, "span": span, "n": n, "path": path,
                           "chunk1_equals_chunk2_bitwise": bitwise,
                           "staged_a_bytes": nbytes(a), "c0": "zero" if c0_seed is None
                           else f"normal(seed={c0_seed})"}, record)
        del a, slabs, c0
        torch.cuda.empty_cache()

    def finish_phase(self, kernel, label, orders, main_order, moved, flops, library,
                     shapes, record, launches_per_call=None, flop_rate="f32_flops") -> None:
        """Emit one kernel phase; ``flop_rate`` names the peak its operations
        are bounded by (the f32 rate, or the bf16 tensor-core rate). A library
        time under the bound is recorded as lost (``library_fields``)."""
        bound = bound_of(moved, flops, flop_rate)
        lib = library_fields(library, bound["bound_ms"])
        err = max(o["max_abs_err"] for o in orders.values())
        self.note_err(kernel, err)
        if record:
            main = orders[main_order]
            self.phase[kernel] = {"ms": main["ms"], "wrapper_ms": main["wrapper_ms"],
                                  **({"device_ms": main["device_ms"]}
                                     if "device_ms" in main else {}),
                                  "plain_ms": main["plain_ms"], **bound,
                                  "library_ms": lib["library_ms"],
                                  "library_device_ms": lib["library_device_ms"],
                                  "library_lost": lib["library_lost"]}
        emit({"kernel_phase": kernel, "label": label, "main_order": main_order,
              "orders": orders, "shapes": shapes, "bytes": moved, "flops": flops, **bound,
              "launches_per_call": launches_per_call, **lib,
              "library_empty_traces": library[2], "peaks_of": PEAK["part"],
              "flop_rate": flop_rate, "ops_ms_at_f32": flops / PEAK["f32_flops"] * 1e3})

    def note_err(self, key: str, err: float) -> None:
        """The largest error of a kernel (or "kernel/route") against its
        plain version so far."""
        self.max_err[key] = max(self.max_err.get(key, 0.0), err)

    def route_row(self, kernel: str, route: str, shape: str, numbers: dict, moved: int,
                  flops: int, flop_rate: str, library, **extra) -> None:
        """File one route's kernels-line numbers at one served shape: its
        ``ms``, ``wrapper_ms`` and ``plain_ms``, the bound of the function in
        the row's dtype, and the library yardstick in that dtype."""
        bound = bound_of(moved, flops, flop_rate)
        self.route_rows[kernel, route, shape] = {
            "ms": numbers["ms"], "wrapper_ms": numbers["wrapper_ms"],
            "plain_ms": numbers["plain_ms"], **bound,
            **library_fields(library, bound["bound_ms"]), **extra}

    def edge_geometry(self, n: int = 128):
        """The full-table geometry: 96 x 32 x ``n`` with one fully dense C
        row (a dense A row reaching a dense B row), so that row's hash table
        has exactly ``n_cols`` slots and fills them all, and a nonzero
        C_prev. Returns A, B, C_prev and the densest output row."""
        csr = self.m["csr"]
        rng = np.random.default_rng(EDGE_SEED)
        rows, k = 96, 32

        def sparse_normal(shape, density):
            vals = rng.standard_normal(shape).astype(np.float32)
            return np.where(rng.random(shape) < density, vals, np.float32(0))
        a, b, c0 = sparse_normal((rows, k), 0.1), sparse_normal((k, n), 0.05), \
            sparse_normal((rows, n), 0.05)
        a[40] = rng.standard_normal(k)   # a dense A row ...
        b[0] = rng.standard_normal(n)    # ... reaching a dense B row
        pattern = ((a != 0).astype(np.int64) @ (b != 0).astype(np.int64) > 0) | (c0 != 0)
        row_cap = int(pattern.sum(1).max())
        A, B, C0m = (csr.csr_from_dense(m, device="cuda") for m in (a, b, c0))
        return A, B, C0m, row_cap

    def stage_edge(self, A, B, C0m, plan, c_cap: int):
        """A, B and C_prev staged as the CSR kernels take them under ``plan``
        (C_prev's strips at capacity ``c_cap``)."""
        csr, ch = self.m["csr"], self.m["chunking"]
        Ast = csr.csr_stack([csr.csr_stack(ch.a_strips(A, plan.p_ac))])
        Bst = csr.csr_stack([csr.csr_stack(ch.b_chunks(B, plan.p_b))])
        C0s = csr.csr_stack([csr.csr_pad_to(s, c_cap) for s in ch.a_strips(C0m, plan.p_ac)])
        return Ast, Bst, C0s, csr.csr_stack([C0s])

    def edge_phase(self) -> None:
        """Every kernel in both orders against its plain version on the
        full-table geometry, A and B cut in thirds (three chunks, three
        strips)."""
        torch = self.torch
        A, B, C0m, row_cap = self.edge_geometry()
        rows, k = A.shape
        n = B.n_cols
        table = self.m["planner"].hash_table_slots(row_cap)
        check(row_cap == n and table == n, f"edge geometry: row cap {row_cap}, "
              f"table {table}, expected a full table of {n}")
        plan = self.m["planner"].ChunkPlan("chunk1", (0, 32, 64, rows), (0, 11, 22, k),
                                          0.0, 0.0)
        Ast, Bst, C0s, C0 = self.stage_edge(A, B, C0m, plan, 32 * n)
        r0s, r1s = plan.b_ranges()
        result = {}
        for kernel in ("hash_accum_spgemm", "sparse_accum_spgemm"):
            run, plain = self.csr_runners(kernel, Ast, Bst, C0, r0s, r1s, row_cap)
            result[kernel] = {order: self.hold_csr(f"{kernel}/edge/{order}", run(order),
                                                   plain(order)) for order in ORDERS}
        hash_run, _ = self.csr_runners("hash_accum_spgemm", Ast, Bst, C0, r0s, r1s, row_cap)
        extract = self.extract_rows(hash_run("chunk1")[0])
        cs, mod = self.m["chunk_stream"], self.kernels["ranged_spgemm"]
        ad, slabs = self.dense_stage(A, B, plan)
        cd = cs._dense_stack(C0s, levels=1)[None]
        dense = {order: mod.ranged_spgemm_stream(ad, slabs, cd, r0s, order=order)
                 for order in ORDERS}
        result["ranged_spgemm"] = {order: self.hold_dense(
            f"ranged_spgemm/edge/{order}", dense[order],
            mod.ranged_spgemm_plain(ad, slabs, cd, r0s, order=order)) for order in ORDERS}
        check(bool(torch.equal(dense["chunk1"], dense["chunk2"])),
              "ranged_spgemm/edge: chunk1 and chunk2 differ bit for bit")
        dense_path = mod.choose_path(ad, slabs, cd, r0s)
        for kernel, orders in result.items():
            self.max_err[kernel] = max(self.max_err.get(kernel, 0.0),
                                       *(o["max_abs_err"] for o in orders.values()))
        emit({"edge_phase": "dense_row_thirds", "shape": [rows, k, n],
              "ranged_spgemm_path": dense_path,
              "c_max_row_nnz": row_cap, "table_size": table,
              "hash_extract_rows": extract,
              "nnz_c0": int(C0.indptr[..., -1].sum()), "kernels": result})

    def hash_class_phase(self) -> None:
        """The hash kernel in both orders against its plain version where
        its extraction leaves the main path's class (a 32-slot table sorted
        in registers): the full-table geometry's tables at 4 and 16 times
        their size (the occupied slots compacted before the register sort),
        and the geometry 256 columns wide, whose dense row's 256 entries sort
        in shared memory."""
        planner, mod = self.m["planner"], self.kernels["hash_accum_spgemm"]
        for label, n, scale, want in (("edge_table_x4", 128, 4, "reg4"),
                                      ("edge_table_x16", 128, 16, "reg4"),
                                      ("dense_row_256", 256, 1, "shared")):
            A, B, C0m, row_cap = self.edge_geometry(n)
            plan = planner.ChunkPlan("chunk1", (0, 32, 64, A.n_rows), (0, 11, 22, A.n_cols),
                                     0.0, 0.0)
            Ast, Bst, _, C0 = self.stage_edge(A, B, C0m, plan, 32 * n)
            r0s, r1s = plan.b_ranges()
            table = planner.hash_table_slots(row_cap) * scale
            orders = {order: self.hold_csr(
                f"hash_accum_spgemm/{label}/{order}",
                mod.hash_accum_spgemm_stream(Ast, Bst, C0, r0s, r1s, order=order,
                                             table_size=table),
                mod.hash_accum_plain(Ast, Bst, C0, r0s, r1s, order=order, table_size=table))
                for order in ORDERS}
            self.note_err("hash_accum_spgemm", max(o["max_abs_err"] for o in orders.values()))
            extract = self.extract_rows(mod.hash_accum_plain(
                Ast, Bst, C0, r0s, r1s, order="chunk1", table_size=table)[0])
            check(extract.get(want, 0) > 0, f"hash_accum_spgemm/{label}: no row extracts "
                  f"as {want} ({extract})")
            emit({"hash_case": label, "shape": [A.n_rows, A.n_cols, n], "c_max_row_nnz": row_cap,
                  "table_size": table, "hash_extract_rows": extract, "wanted": want,
                  "orders": orders})

    def esc_case(self, label: str, Ast, Bst, C0, r0s, r1s, row_cap: int, want: str) -> None:
        """The ESC kernel in both orders against its plain version on staged
        operands whose merge steps must reach the sort ``want`` (a key of
        ``sort_steps``: a size class and key width)."""
        mod = self.kernels["sparse_accum_spgemm"]
        steps = mod.sort_steps(Ast, Bst, C0, r0s, r1s, row_cap=row_cap)
        check(steps.get(want, 0) > 0, f"sparse_accum_spgemm/{label}: no step sorts "
              f"as {want} ({steps})")
        run, plain = self.csr_runners("sparse_accum_spgemm", Ast, Bst, C0, r0s, r1s, row_cap)
        orders = {order: self.hold_csr(f"sparse_accum_spgemm/{label}/{order}", run(order),
                                       plain(order)) for order in ORDERS}
        self.note_err("sparse_accum_spgemm", max(o["max_abs_err"] for o in orders.values()))
        work_cap, _ = mod.esc_workspace(Ast.max_row_nnz, Bst.max_row_nnz, row_cap)
        emit({"esc_case": label, "shape": [Ast.n_rows * Ast.indptr.shape[1], Ast.n_cols,
                                           Bst.n_cols],
              "strips": Ast.indptr.shape[1], "chunks": Bst.indptr.shape[1],
              "c_max_row_nnz": row_cap, "work_cap": work_cap, "sort_steps": steps,
              "wanted": want, "orders": orders})

    def esc_class_phase(self) -> None:
        """The ESC kernel where its sort leaves the main path's register
        classes: the full-table geometry under one chunk (the dense row's
        step holds more keys than the largest register class, so it sorts in
        shared memory), and a geometry 2^25 + 9 columns wide whose columns do
        not fit 32-bit keys beside its positions (64-bit keys, sorted in
        shared memory)."""
        planner, csr = self.m["planner"], self.m["csr"]
        A, B, C0m, row_cap = self.edge_geometry()
        plan = planner.ChunkPlan("chunk1", (0, 32, 64, A.n_rows), (0, A.n_cols), 0.0, 0.0)
        Ast, Bst, _, C0 = self.stage_edge(A, B, C0m, plan, 32 * B.n_cols)
        self.esc_case("edge_one_chunk", Ast, Bst, C0, *plan.b_ranges(), row_cap, "shared/64")

        rng = np.random.default_rng(EDGE_SEED + 2)
        rows, k, n = 64, 48, (1 << 25) + 9

        def coo(n_rows, per_row):
            r = np.repeat(np.arange(n_rows), per_row)
            c = np.concatenate([rng.choice(n, m, replace=False) for m in per_row])
            return r, c, rng.standard_normal(r.size).astype(np.float32)
        a = np.where(rng.random((rows, k)) < 0.2, rng.standard_normal((rows, k)), 0.0)
        b_per_row = rng.integers(0, 9, k)
        b_per_row[0] = 60                  # one long B row
        b_per_row[5] = 0                   # and an empty one
        br, bc, bv = coo(k, b_per_row)
        c0r, c0c, c0v = coo(rows, rng.integers(0, 5, rows))
        A = csr.csr_from_dense(a.astype(np.float32), device="cuda")
        B = csr.csr_from_coo(br, bc, bv, (k, n), device="cuda")
        C0m = csr.csr_from_coo(c0r, c0c, c0v, (rows, n), device="cuda")
        union = [set(c0c[c0r == i]) for i in range(rows)]
        for i, j in zip(*np.nonzero(a)):
            union[i].update(bc[br == j])
        plan = planner.ChunkPlan("chunk1", (0, 22, 44, rows), (0, 16, 32, k), 0.0, 0.0)
        strip_nnz = [sum(len(union[i]) for i in range(s, e))
                     for s, e in zip(plan.p_ac[:-1], plan.p_ac[1:])]
        c_cap = -(-max(strip_nnz) // 8) * 8
        Ast, Bst, _, C0 = self.stage_edge(A, B, C0m, plan, c_cap)
        self.esc_case("wide_columns", Ast, Bst, C0, *plan.b_ranges(),
                      max(len(u) for u in union), "wide/64")

    # -- main path ---------------------------------------------------------

    def main_run(self, label: str, name: str, n: int, backend: str, *,
                 budget_div: float = 4.0, knl_div: float | None = None,
                 expect_algorithm: str | None = None,
                 expect_backend: str | None = None) -> None:
        torch = self.torch
        chunking, planner, kkmem = self.m["chunking"], self.m["planner"], self.m["kkmem"]
        A, P = self.problem(name, n)
        t0 = time.perf_counter()
        crb, budget = self.quickstart_inputs(A, P)
        if knl_div is not None:
            limit = float(planner.row_bytes_csr(P).sum()) / knl_div
            plan = planner.plan_knl(A, P, fast_limit_bytes=limit)
        else:
            limit = budget * 4 / budget_div
            plan = planner.plan_chunks(A, P, crb, self.m["memory_model"].P100,
                                       fast_limit_bytes=limit)
        check(plan.algorithm != "whole_fast", f"{label}: whole_fast bypasses every kernel")
        if expect_algorithm:
            check(plan.algorithm == expect_algorithm,
                  f"{label}: plan is {plan.algorithm}, expected {expect_algorithm}")
        caps = self.m["symbolic"].strip_output_caps(A, P, plan.p_ac)
        chosen = backend
        if backend == "auto":
            env = chunking.instance_envelope(A, P, plan, caps=caps)
            chosen = planner.select_accumulator_backend(plan, env)
        if expect_backend:
            check(chosen == expect_backend, f"{label}: auto chose {chosen}, "
                  f"the reference's planner chooses {expect_backend}")
        plan_s = time.perf_counter() - t0

        self.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        C, stats = chunking.chunked_spgemm(A, P, plan, backend=backend)
        torch.cuda.synchronize()
        exec_s = time.perf_counter() - t0
        launches = self.read_counters()
        kernel = self.backend_kernel.get(chosen)   # scan runs no kernel of its own
        if kernel is not None:
            check(launches[kernel] > 0, f"{label}: {kernel} was not launched")
            self.launches.setdefault(kernel, launches[kernel])

        ws = kkmem.spgemm_symbolic_host(A, P)
        plain = kkmem.spgemm(A, P, ws.c_pad)
        nnz, plain_nnz = C.nnz(), plain.nnz()
        if chosen == "pallas":
            # the dense backend keeps only nonzero sums: compare densified
            d_got, d_want = self.m["csr"].csr_to_dense(C), self.m["csr"].csr_to_dense(plain)
            err = float((d_got - d_want).abs().max())
            structure = nnz <= plain_nnz
            del d_got, d_want
        else:
            structure = (torch.equal(C.indptr, plain.indptr)
                         and torch.equal(C.indices[:nnz], plain.indices[:nnz]))
            err = float((C.data[:nnz] - plain.data[:nnz]).abs().max()) if nnz else 0.0
        check(structure, f"{label}: structure differs from the plain spgemm")
        scale = float(plain.data[:plain_nnz].abs().max())
        check(err <= KERNEL_ATOL + KERNEL_RTOL * scale,
              f"{label}: values differ from the plain spgemm by {err}")
        scipy_err = self.scipy_check(A, P, C)
        check(scipy_err <= SCIPY_RTOL, f"{label}: relative error {scipy_err} vs scipy")
        emit({"run": label, "problem": name, "n": n, "A": list(A.shape),
              "P": list(P.shape), "nnz_A": A.nnz(), "backend": backend,
              "chosen": chosen, "plan": {"algorithm": plan.algorithm,
                                         "n_ac": plan.n_ac, "n_b": plan.n_b,
                                         "fast_limit_bytes": limit},
              "launches": launches, "nnz_C": nnz,
              "stats": {"kernel_calls": stats.kernel_calls,
                        "copy_in_bytes": stats.copy_in_bytes,
                        "copy_out_bytes": stats.copy_out_bytes,
                        "copy_events": len(stats.per_copy_in) + len(stats.per_copy_out)},
              "wall_s": {"problem": self.problems[(name, n)][2], "plan": plan_s,
                         "chunked_spgemm": exec_s},
              "check": {"plain_structure_equal": structure, "plain_max_abs_err": err,
                        "scipy_rel_err": scipy_err}})
        del C, plain
        torch.cuda.empty_cache()

    def breakdown(self, label: str, name: str, n: int, backend: str) -> None:
        """Where one main-path call's time goes, on a repeat of that run:
        cumulative host seconds of the port's stages (cProfile, which slows
        Python code and so inflates the host share a little), then the
        device's busy time (every CUDA activity: kernels, copies, fills) over
        the call's wall time (torch.profiler)."""
        import cProfile
        import pstats

        torch = self.torch
        chunking, planner = self.m["chunking"], self.m["planner"]
        A, P = self.problem(name, n)
        crb, budget = self.quickstart_inputs(A, P)
        plan = planner.plan_chunks(A, P, crb, self.m["memory_model"].P100,
                                   fast_limit_bytes=budget)
        stages = ("chunked_spgemm", "strip_output_caps", "instance_envelope",
                  "a_strips", "b_chunks", "csr_stack", "check_output_caps",
                  "hash_accum_spgemm_stream", "sparse_accum_spgemm_stream",
                  "ranged_spgemm_stream", "_assemble")
        profile = cProfile.Profile()
        torch.cuda.synchronize()
        profile.enable()
        chunking.chunked_spgemm(A, P, plan, backend=backend)
        torch.cuda.synchronize()
        profile.disable()
        host = {}
        for (path, _, fn), row in pstats.Stats(profile).stats.items():
            if fn in stages and "repro_torch" in path:
                host[fn] = max(host.get(fn, 0.0), row[3])
        wall = []

        def call():
            t0 = time.perf_counter()
            chunking.chunked_spgemm(A, P, plan, backend=backend)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        device_ms = device_busy_ms(profiled(torch, call))
        wall_ms = wall[0]
        emit({"breakdown": label, "backend": backend, "plan": plan.algorithm,
              "host_cumulative_s": host, "profiled_wall_ms": wall_ms,
              "device_kernel_ms": device_ms if device_ms > 0 else None,
              "device_busy_share": device_ms / wall_ms if device_ms > 0 else None})

    def scipy_check(self, A, P, C, R=None) -> float:
        """max |C - A @ P| / max |A @ P| (or of ``R @ (A @ P)``) against scipy
        in float64, zeros eliminated on both sides."""
        import scipy.sparse as sp

        def host(m):
            nnz = m.nnz()
            out = sp.csr_matrix((m.data[:nnz].cpu().numpy().astype(np.float64),
                                 m.indices[:nnz].cpu().numpy(),
                                 m.indptr.cpu().numpy()), shape=m.shape)
            out.eliminate_zeros()
            return out
        ref = host(A) @ host(P)
        if R is not None:
            ref = host(R) @ ref
        ref.eliminate_zeros()
        got = host(C)
        scale = abs(ref).max() if ref.nnz else 1.0
        diff = abs(got - ref)
        return float(diff.max() / scale) if diff.nnz else 0.0

    # -- second path: masked products, pipelines, blocked kernels ----------

    def triangle_graph(self):
        """The degree-sorted lower triangle L of the RMAT graph, on the card,
        with its generation seconds and the scipy float64 count of (L L) o L."""
        if not hasattr(self, "_graph"):
            import scipy.sparse as sp

            graphs = self.m["graphs"]
            t0 = time.perf_counter()
            L = graphs.lower_triangular_degree_sorted(
                graphs.rmat(RMAT_SCALE, RMAT_EDGE_FACTOR, seed=RMAT_SEED, device="cuda"))
            self.torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            nnz = L.nnz()
            Ls = sp.csr_matrix((L.data[:nnz].cpu().numpy().astype(np.float64),
                                L.indices[:nnz].cpu().numpy(), L.indptr.cpu().numpy()),
                               shape=L.shape)
            t0 = time.perf_counter()
            want = float((Ls @ Ls).multiply(Ls).sum())
            self._graph = (L, seconds, want, time.perf_counter() - t0)
        return self._graph

    def products(self, A, B) -> int:
        """Scalar products of A x B: the B row length at every A entry."""
        lens = (B.indptr[1:] - B.indptr[:-1]).long()
        return int(lens[A.indices[: A.nnz()].long()].sum())

    def masked_kernel_phase(self, label, A, B, M, plan, main_order, *, c0_from=None,
                            part_size: int | None = None, record=False) -> dict:
        """The masked kernel in both orders against its plain version on the
        staged operands of ``plan``, both timed, the kernel's device time by
        launch. ``part_size`` forces the size its rows are cut at (else the
        wrapper's ``masked_part_size``). Returns the rows split and their
        parts."""
        from unittest import mock

        torch, mod = self.torch, self.kernels["hash_masked_accum_spgemm"]
        caps = self.m["symbolic"].masked_output_caps(M, plan.p_ac)
        args, table, _ = self.m["chunk_stream"].stage_hash_masked(
            A, B, M, plan, caps.c_pad, caps, c_prev=c0_from)
        forced = (contextlib.nullcontext() if part_size is None else
                  mock.patch.object(mod, "masked_part_size", lambda products, n_sm: part_size))
        run = lambda order: mod.hash_masked_accum_spgemm_stream(  # noqa: E731
            *args, order=order, table_size=table)
        plain = lambda order: mod.hash_masked_plain(  # noqa: E731
            *args, order=order, table_size=table)
        Ast, Bst, C0, Mst, r0s, r1s = args
        names = TRACE_NAMES["hash_masked_accum_spgemm"]
        orders = {}
        with forced:
            work, launches = mod.masked_plan(Ast, Bst, Mst, r0s, r1s)
            for order in ORDERS:
                orders[order] = self.hold_csr(f"hash_masked_accum_spgemm/{label}/{order}",
                                              run(order), plain(order))
                orders[order]["ms"] = self.launch_ms(lambda: run(order))
                orders[order]["wrapper_ms"] = cuda_ms(torch, lambda: run(order))
                # the profiler's device time of the call's kernels, and of
                # each launch in launch order
                kernels = mod.masked_kernels_per_call(Ast, Bst, Mst, r0s, r1s, order)
                (orders[order]["device_ms"], orders[order]["device_incomplete_traces"],
                 orders[order]["device_split_ms"]) = kernel_device_split(
                    torch, lambda: run(order), names, kernels)
                orders[order]["device_launches_ms"] = device_launch_list(
                    torch, lambda: run(order), names, kernels)
                orders[order]["kernels_per_call"] = kernels
                orders[order]["plain_ms"] = cuda_ms(torch, lambda: plain(order), reps=3)
            counter = self.counters["hash_masked_accum_spgemm"]
            before = counter.count
            out = run(main_order)
            per_call = counter.count - before
        m_nnz = int(Mst.indptr[..., -1].sum())
        moved = (live_bytes(Ast) + live_bytes(Bst) + live_bytes(C0)
                 + nbytes(Mst.indptr) + 4 * m_nnz + nbytes(*out) + 8 * len(r0s))
        flops = 2 * self.products(A, B) + int(C0.indptr[..., -1].sum())
        # the launches: each one's parts, products and heaviest part, in
        # launch order (the global rows' seed before them, gather after)
        ends = np.cumsum([grp[2] for grp in launches.groups]).tolist()
        groups = [{"team": mod.MASKED_TEAMS[t], "table_slots": sl, "parts": n, "threads": th,
                   "products": int(launches.products[e0:e1].sum()),
                   "heaviest_part": int(launches.products[e0:e1].max())}
                  for (t, sl, n, th), e0, e1 in zip(launches.groups, [0, *ends], ends)]
        split_rows = torch.unique(work.row[~work.only])
        self.finish_phase("hash_masked_accum_spgemm", label, orders, main_order, moved,
                          flops, (None,) * 4,
                          {"strips": plan.n_ac, "chunks": plan.n_b,
                           "strip_rows": Ast.n_rows, "mask_nnz": m_nnz,
                           "densest_mask_row": int(M.max_row_nnz),
                           "reference_table_slots": table,
                           "products": int(work.products.sum()),
                           "part_size": work.part_size, "parts": int(work.row.numel()),
                           "rows_split": int(split_rows.numel()),
                           "parts_of_split_rows": int((~work.only).sum()),
                           "launches": groups,
                           "global_rows": int(launches.grows.numel()),
                           "global_table_slots": int(launches.goff[-1]),
                           "nnz_c0": int(C0.indptr[..., -1].sum())}, record, per_call)
        return {"rows_split": int(split_rows.numel()),
                "parts_of_split_rows": int((~work.only).sum())}

    def masked_edge_phase(self) -> None:
        """A 64 x 48 x 48,000 geometry whose mask rows take every team, two
        of them 20,000 and 40,000 entries (tables of 65,536 and 131,072 slots
        in global memory, their rows cut into parts), with a nonzero C_prev,
        under a 3 x 3 plan and a one-chunk knl plan."""
        csr, planner = self.m["csr"], self.m["planner"]
        rng = np.random.default_rng(EDGE_SEED + 1)
        rows, k, n = 64, 48, 48_000

        def sparse_normal(shape, density):
            vals = rng.standard_normal(shape).astype(np.float32)
            return np.where(rng.random(shape) < density, vals, np.float32(0))
        a, b, c0 = sparse_normal((rows, k), 0.2), sparse_normal((k, n), 0.01), \
            sparse_normal((rows, n), 0.001)
        b[0, :45_000] = rng.standard_normal(45_000)
        a[5, 0], a[9, 0] = 1.5, -0.5
        m = rng.random((rows, n)) < 0.0005
        m[5, rng.choice(n, 40_000, replace=False)] = True
        m[6, :3_000], m[7, :600], m[8, :100], m[9, :20_000] = True, True, True, True
        A, B, M, C0 = (csr.csr_from_dense(x, device="cuda")
                       for x in (a, b, m.astype(np.float32), c0))
        for plan in (planner.ChunkPlan("chunk1", (0, 20, 40, rows), (0, 16, 32, k), 0., 0.),
                     planner.ChunkPlan("knl", (0, rows), (0, k), 0., 0.)):
            self.masked_kernel_phase(f"edge_global_table_{plan.algorithm}", A, B, M, plan,
                                     "chunk1", c0_from=C0)

    def triangle_run(self, label: str, *, chunk2: bool = False) -> None:
        """``count_triangles`` on the RMAT graph's L: the default one-chunk
        knl plan, or a chunk2 plan from ``plan_chunks`` with L's row bytes as
        the C estimate; the count must equal scipy's exactly."""
        torch, planner, tri = self.torch, self.m["planner"], self.m["triangle"]
        L, gen_s, want, scipy_s = self.triangle_graph()
        t0 = time.perf_counter()
        limit = None
        if chunk2:
            # a third of size(A) + size(B) + size(mask) = size(L) plans
            # chunk1; the B-resident chunk2 branch with >= 4 strips needs a
            # limit between 4/3 and 3/2 of size(L)
            size = float(planner.row_bytes_csr(L).sum())
            limit = 1.4 * size
            plan = planner.plan_chunks(L, L, planner.row_bytes_csr(L),
                                       self.m["memory_model"].P100, fast_limit_bytes=limit)
            check(plan.algorithm == "chunk2" and plan.n_ac >= 4,
                  f"{label}: planned {plan.algorithm} {plan.n_ac}x{plan.n_b}")
        else:
            plan = planner.plan_knl(L, L, float("inf"))
        caps = self.m["symbolic"].masked_output_caps(L, plan.p_ac)
        plan_s = time.perf_counter() - t0
        self.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = tri.count_triangles(L, plan=plan, caps=caps)
        torch.cuda.synchronize()
        exec_s = time.perf_counter() - t0
        launches = self.read_counters()
        check(launches["hash_masked_accum_spgemm"] > 0,
              f"{label}: the masked kernel was not launched")
        check(got.dtype == torch.float64 and float(got) == want,
              f"{label}: {float(got)} triangles, scipy counts {want}")
        if not chunk2:
            self.launches["hash_masked_accum_spgemm"] = launches["hash_masked_accum_spgemm"]
        emit({"run": label, "graph": f"rmat({RMAT_SCALE}, {RMAT_EDGE_FACTOR}, "
              f"seed={RMAT_SEED}) -> lower_triangular_degree_sorted",
              "L": list(L.shape), "nnz_L": L.nnz(), "densest_row": L.max_row_nnz,
              "products": self.products(L, L),
              "plan": {"algorithm": plan.algorithm, "n_ac": plan.n_ac, "n_b": plan.n_b,
                       "fast_limit_bytes": limit},
              "launches": launches, "triangles": float(got),
              "wall_s": {"problem": gen_s, "plan": plan_s, "count_triangles": exec_s,
                         "scipy_count": scipy_s},
              "check": {"scipy_float64_triangles": want, "equal": float(got) == want}})

    def galerkin_run(self, label: str, backend: str, frac: float, resident: bool) -> None:
        """``pipeline_spgemm`` of brick3d n=48 through ``backend`` at a fast
        limit of ``frac`` x size(A, P, R): structure equal to the port's
        plain two-hop ``spgemm``, values to scipy's R (A P) in float64."""
        torch, planner, symbolic = self.torch, self.m["planner"], self.m["symbolic"]
        pipe, kkmem = self.m["pipeline"], self.m["kkmem"]
        A, P = self.problem("brick3d", 48)
        R = self.restrictions[("brick3d", 48)]
        t0 = time.perf_counter()
        if not hasattr(self, "_pipe_plans"):
            self._pipe_plans = {"t_pattern": symbolic.spgemm_pattern_host(A, P)}
        tp = self._pipe_plans["t_pattern"]
        limit = frac * float(A.nbytes() + P.nbytes() + R.nbytes())
        if frac not in self._pipe_plans:   # one plan per limit, shared by backends
            plan = planner.plan_pipeline(A, P, R, self.m["memory_model"].P100,
                                         fast_limit_bytes=limit, t_pattern=tp)
            caps = symbolic.pipeline_output_caps(A, P, R, plan.plan1.p_ac,
                                                 plan.plan2.p_ac, t_pattern=tp)
            self._pipe_plans[frac] = (plan, caps)
        plan, caps = self._pipe_plans[frac]
        check(plan.t_resident == resident, f"{label}: t_resident={plan.t_resident}")
        check("whole_fast" not in (plan.plan1.algorithm, plan.plan2.algorithm),
              f"{label}: a whole_fast hop bypasses the kernels")
        plan_s = time.perf_counter() - t0
        self.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        C, stats = pipe.pipeline_spgemm(A, P, R, plan, backend=backend, caps=caps)
        torch.cuda.synchronize()
        exec_s = time.perf_counter() - t0
        launches = self.read_counters()
        kernel = self.backend_kernel[backend]
        check(launches[kernel] > 0, f"{label}: {kernel} was not launched")
        if not hasattr(self, "_rap_plain"):
            self._rap_plain = kkmem.spgemm_full(R, kkmem.spgemm_full(A, P))
        plain = self._rap_plain
        nnz = C.nnz()
        structure = (torch.equal(C.indptr, plain.indptr)
                     and torch.equal(C.indices[:nnz], plain.indices[:nnz]))
        check(structure, f"{label}: structure differs from the plain two-hop spgemm")
        err = float((C.data[:nnz] - plain.data[:nnz]).abs().max()) if nnz else 0.0
        scale = float(plain.data[:nnz].abs().max()) if nnz else 0.0
        check(err <= KERNEL_ATOL + KERNEL_RTOL * scale,
              f"{label}: values differ from the plain two-hop spgemm by {err}")
        scipy_err = self.scipy_check(A, P, C, R=R)
        check(scipy_err <= SCIPY_RTOL, f"{label}: relative error {scipy_err} vs scipy")
        emit({"run": label, "problem": "brick3d", "n": 48, "backend": backend,
              "plan": {"hop1": [plan.plan1.algorithm, plan.plan1.n_ac, plan.plan1.n_b],
                       "hop2": [plan.plan2.algorithm, plan.plan2.n_ac, plan.plan2.n_b],
                       "t_resident": plan.t_resident, "t_bytes": plan.t_bytes,
                       "fast_limit_bytes": limit},
              "launches": launches, "nnz_T": caps.t_nnz, "nnz_C": nnz,
              "stats": {"spilled": stats.spilled, "spill_bytes": stats.spill_bytes,
                        "copy_bytes": stats.copy_bytes,
                        "kernel_calls": [stats.hop1.kernel_calls, stats.hop2.kernel_calls]},
              "wall_s": {"problem": self.problems[("brick3d", 48)][2], "plan": plan_s,
                         "pipeline_spgemm": exec_s},
              "check": {"plain_structure_equal": structure, "plain_max_abs_err": err,
                        "scipy_rel_err": scipy_err}})

    def bsr_pairs(self, A, P, plan, block: int = BSR_BLOCK, first: bool = False):
        """The (strip, chunk) pairs the ``bsr`` executor stages at block size
        ``block`` (only the first with ``first``), as kernel operands and
        metas, with the envelope that capped them."""
        caps = self.m["symbolic"].strip_output_caps(A, P, plan.p_ac)
        env = self.m["chunking"].instance_envelope(A, P, plan, caps=caps,
                                                   block_size=block)
        staged = self.m["chunk_stream"].stage_bsr_pairs(A, P, plan, env)
        if first:
            staged = [next(staged)]
        return [(ops, meta) for _, ops, meta in staged], env

    def hold_tiles(self, what: str, got, want) -> float:
        self.torch.cuda.synchronize()
        err = float((got - want).abs().max()) if got.numel() else 0.0
        check(bool(self.torch.allclose(got, want, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)),
              f"{what}: values differ from the plain version by {err}")
        return err

    def bsr_kernel_phase(self, A, P, plan, *, label: str, record: bool = False) -> None:
        """The BSR x BSR kernel on every staged pair of the ``bsr`` run,
        against its plain version, in f32 and, on the first pair, on the same
        blocks in bf16."""
        torch, mod = self.torch, self.kernels["bsr_spgemm"]
        pairs, env = self.bsr_pairs(A, P, plan)
        _, _, _, nc, u = env.bsr_caps
        run = lambda: [mod.bsr_spgemm_blocks(*ops, nc, u, BSR_BLOCK)  # noqa: E731
                       for ops, _ in pairs]
        plain = lambda: [mod.bsr_spgemm_plain(*ops, nc, u, BSR_BLOCK)  # noqa: E731
                         for ops, _ in pairs]
        err = max(self.hold_tiles(f"bsr_spgemm/{label}/pair{i}", g, w)
                  for i, (g, w) in enumerate(zip(run(), plain())))
        a, b, sa, sb = pairs[0][0]
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        err16 = self.hold_tiles(f"bsr_spgemm/{label}/bf16",
                                mod.bsr_spgemm_blocks(a16, b16, sa, sb, nc, u, BSR_BLOCK),
                                mod.bsr_spgemm_plain(a16, b16, sa, sb, nc, u, BSR_BLOCK))
        cases = self.bsr_cases(A, P, plan, label, pairs[0][0], nc, u)
        numbers = {"max_abs_err": max(err, err16, *(c["max_abs_err"] for c in cases.values())),
                   "bf16_max_abs_err": err16,
                   "ms": self.launch_ms(run), "wrapper_ms": cuda_ms(torch, run)}
        # the profiler's device time of the six launches
        numbers["device_ms"], numbers["device_incomplete_traces"], _ = kernel_device_split(
            torch, run, TRACE_NAMES["bsr_spgemm"], len(pairs))
        if record:
            numbers["plain_ms"] = cuda_ms(torch, plain, reps=3)
        # each pair reads the live blocks its slot tables name and one
        # (a slot, b slot) pair of int32 per contributor pair, once, and
        # writes its real output tiles once
        bs2 = BSR_BLOCK * BSR_BLOCK * 4
        moved = flops = 0
        for (a, b, _, _), meta in pairs:
            live_a = np.unique(meta.a_slots[meta.a_slots < a.shape[0] - 1]).size
            live_b = np.unique(meta.b_slots[meta.b_slots < b.shape[0] - 1]).size
            contributors = meta.flops // (2 * BSR_BLOCK ** 3)
            moved += (live_a + live_b) * bs2 + 8 * contributors + meta.n_c_blocks * bs2
            flops += meta.flops
        library = self.library_spgemm(A, P) if record else (None,) * 4
        self.finish_phase("bsr_spgemm", label, {"chunk2": numbers}, "chunk2", moved,
                          flops, library,
                          {"block": BSR_BLOCK, "pairs": len(pairs),
                           "bsr_caps": list(env.bsr_caps),
                           "c_blocks": [meta.n_c_blocks for _, meta in pairs],
                           "cases": cases},
                          record, len(pairs))

    def bsr_cases(self, A, P, plan, label: str, first, nc: int, u: int) -> dict:
        """The BSR x BSR kernel on tables and block sizes the main path does
        not give it, each against its plain version: the first pair's tables
        with each row's steps shuffled (sentinels inside a row, not only at
        its end), the same widened to 40 steps (two slot passes of a warp),
        and the first pair staged at blocks of 4 and 16."""
        torch, mod = self.torch, self.kernels["bsr_spgemm"]
        a, b, sa, sb = first
        gen = torch.Generator(device="cuda").manual_seed(EDGE_SEED)

        def shuffled(ta, tb, width):
            pad = width - ta.shape[1]
            ta = torch.cat([ta, ta.new_full((nc, pad), a.shape[0] - 1)], 1)
            tb = torch.cat([tb, tb.new_full((nc, pad), b.shape[0] - 1)], 1)
            perm = torch.argsort(torch.rand(nc, width, generator=gen, device="cuda"), 1)
            return ta.gather(1, perm).contiguous(), tb.gather(1, perm).contiguous()
        cases = {}
        for name, width in (("interior_sentinels", u), ("u_max40", 40)):
            ta, tb = shuffled(sa, sb, width)
            interior = int(((ta[:, :-1] == a.shape[0] - 1) & (ta[:, 1:] != a.shape[0] - 1))
                           .any(1).sum())
            past = int((ta[:, 32:] != a.shape[0] - 1).any(1).sum())
            check(interior > 0, f"bsr_spgemm/{label}/{name}: no sentinel inside a row")
            check(width <= 32 or past > 0, f"bsr_spgemm/{label}/{name}: no live step "
                  "in the second slot pass")
            cases[name] = {"u_max": width, "rows_with_interior_sentinels": interior,
                           "rows_live_past_32": past,
                           "max_abs_err": self.hold_tiles(
                               f"bsr_spgemm/{label}/{name}",
                               mod.bsr_spgemm_blocks(a, b, ta, tb, nc, width, BSR_BLOCK),
                               mod.bsr_spgemm_plain(a, b, ta, tb, nc, width, BSR_BLOCK))}
        for block in (4, 16):
            pairs, env = self.bsr_pairs(A, P, plan, block, first=True)
            (ab, bb, ta, tb), meta = pairs[0]
            _, _, _, ncb, ub = env.bsr_caps
            cases[f"bs{block}"] = {"u_max": ub, "nc_pad": ncb, "c_blocks": meta.n_c_blocks,
                                   "max_abs_err": self.hold_tiles(
                                       f"bsr_spgemm/{label}/bs{block}",
                                       mod.bsr_spgemm_blocks(ab, bb, ta, tb, ncb, ub, block),
                                       mod.bsr_spgemm_plain(ab, bb, ta, tb, ncb, ub, block))}
            del pairs
        return cases

    def spmm_inputs(self):
        if not hasattr(self, "_spmm"):
            A, _ = self.problem("brick3d", 48)
            t0 = time.perf_counter()
            Ab = self.m["bsr"].bsr_from_csr(A, BSR_BLOCK)
            gen = self.torch.Generator(device="cuda").manual_seed(SPMM_SEED)
            X = self.torch.randn(A.n_cols, SPMM_COLS, generator=gen, device="cuda")
            self._spmm = (A, Ab, X, time.perf_counter() - t0)
        return self._spmm

    def spmm_kernel_phase(self, *, label: str, record: bool = False) -> None:
        """The BSR x dense kernel at the ``bsr_spmm`` run's shapes against its
        plain version."""
        torch, mod, ops = self.torch, self.kernels["bsr_spmm"], self.m["ops"]
        A, Ab, X, _ = self.spmm_inputs()
        meta = mod.bsr_spmm_symbolic(Ab)
        blocks = ops._with_zero_block(Ab.blocks)
        sl = torch.from_numpy(meta.a_slots).cuda()
        co = torch.from_numpy(meta.a_cols).cuda()
        run = lambda: mod.bsr_spmm_blocks(blocks, X, sl, co, Ab.mb, meta.u_max,  # noqa: E731
                                          BSR_BLOCK, SPMM_COLS)
        plain = lambda: mod.bsr_spmm_plain(blocks, X, sl, co, Ab.mb, meta.u_max,  # noqa: E731
                                           BSR_BLOCK)
        numbers = {"max_abs_err": self.hold_tiles(f"bsr_spmm/{label}", run(), plain()),
                   "ms": self.launch_ms(run), "wrapper_ms": cuda_ms(torch, run)}
        if record:
            numbers["plain_ms"] = cuda_ms(torch, plain, reps=3)
        n_blocks = Ab.n_blocks()
        moved = (n_blocks * BSR_BLOCK * BSR_BLOCK * 4 + nbytes(sl, co) + nbytes(X)
                 + Ab.mb * BSR_BLOCK * SPMM_COLS * 4)
        flops = meta.flops * SPMM_COLS
        library = (None,) * 4
        if record:
            values = Ab.blocks[:n_blocks]
            t = torch.sparse_bsr_tensor(Ab.block_indptr, Ab.block_indices[:n_blocks],
                                        values, size=Ab.shape)
            fn = lambda: t @ X  # noqa: E731
            try:
                library = (cuda_ms(torch, fn), *device_ms(torch, fn), None)
            except RuntimeError as err:   # torch refuses: record why, time nothing
                library = (None, None, None, str(err).splitlines()[0])
        self.finish_phase("bsr_spmm", label, {"dense_x": numbers}, "dense_x", moved,
                          flops, library,
                          {"block": BSR_BLOCK, "mb": Ab.mb, "u_max": meta.u_max,
                           "n_blocks": n_blocks, "x": list(X.shape), "bn": SPMM_COLS},
                          record, 1)

    def bsr_run(self, label: str) -> None:
        """``chunked_spgemm(backend="bsr")`` of brick3d n=48 under the
        quickstart plan: values to scipy's A P in float64, zeros removed."""
        torch, planner = self.torch, self.m["planner"]
        A, P = self.problem("brick3d", 48)
        t0 = time.perf_counter()
        crb, budget = self.quickstart_inputs(A, P)
        plan = planner.plan_chunks(A, P, crb, self.m["memory_model"].P100,
                                   fast_limit_bytes=budget)
        plan_s = time.perf_counter() - t0
        self.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        C, stats = self.m["chunking"].chunked_spgemm(A, P, plan, backend="bsr")
        torch.cuda.synchronize()
        exec_s = time.perf_counter() - t0
        launches = self.read_counters()
        check(launches["bsr_spgemm"] > 0, f"{label}: bsr_spgemm was not launched")
        self.launches["bsr_spgemm"] = launches["bsr_spgemm"]
        scipy_err = self.scipy_check(A, P, C)
        check(scipy_err <= SCIPY_RTOL, f"{label}: relative error {scipy_err} vs scipy")
        emit({"run": label, "problem": "brick3d", "n": 48, "backend": "bsr",
              "block": BSR_BLOCK, "plan": {"algorithm": plan.algorithm, "n_ac": plan.n_ac,
                                           "n_b": plan.n_b},
              "launches": launches, "nnz_C": C.nnz(),
              "stats": {"kernel_calls": stats.kernel_calls,
                        "copy_in_bytes": stats.copy_in_bytes},
              "wall_s": {"problem": self.problems[("brick3d", 48)][2], "plan": plan_s,
                         "chunked_spgemm": exec_s},
              "check": {"scipy_rel_err": scipy_err}})

    def spmm_run(self, label: str) -> None:
        """``ops.bsr_spmm`` of brick3d n=48 as BSR by a seeded dense X:
        values to scipy's A X in float64."""
        import scipy.sparse as sp

        torch, ops = self.torch, self.m["ops"]
        A, Ab, X, stage_s = self.spmm_inputs()
        self.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Y = ops.bsr_spmm(Ab, X, bn=SPMM_COLS)
        torch.cuda.synchronize()
        exec_s = time.perf_counter() - t0
        launches = self.read_counters()
        check(launches["bsr_spmm"] > 0, f"{label}: bsr_spmm was not launched")
        self.launches["bsr_spmm"] = launches["bsr_spmm"]
        nnz = A.nnz()
        As = sp.csr_matrix((A.data[:nnz].cpu().numpy().astype(np.float64),
                            A.indices[:nnz].cpu().numpy(), A.indptr.cpu().numpy()),
                           shape=A.shape)
        ref = As @ X.cpu().numpy().astype(np.float64)
        got = Y.cpu().numpy().astype(np.float64)
        check(got.shape == ref.shape and np.isfinite(got).all(), f"{label}: bad output")
        rel = float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))
        check(rel <= SCIPY_RTOL, f"{label}: relative error {rel} vs scipy")
        emit({"run": label, "problem": "brick3d", "n": 48, "block": BSR_BLOCK,
              "A": list(A.shape), "X": list(X.shape), "n_blocks": Ab.n_blocks(),
              "launches": launches,
              "wall_s": {"problem": self.problems[("brick3d", 48)][2],
                         "plan": stage_s, "bsr_spmm": exec_s},
              "check": {"scipy_rel_err": rel}})

    # -- third path: serving the dense LM ----------------------------------

    def lm_prompts(self, vocab_size: int) -> list:
        """The serve run's requests: lengths and token ids from one seed."""
        rng = np.random.default_rng(LM_PROMPT_SEED)
        lens = rng.integers(LM_PROMPT_LENS[0], LM_PROMPT_LENS[1] + 1, LM_BATCH)
        return [rng.integers(1, vocab_size, int(n)).tolist() for n in lens]

    def hold_close(self, what: str, got, want, atol: float, ulps: int,
                   rtol: float = 0.0) -> float:
        """f32: within atol + rtol |want|; bf16: within ``ulps`` ulps of the
        plain value (plus atol)."""
        torch = self.torch
        torch.cuda.synchronize()
        got32, want32 = got.float(), want.float()
        diff = (got32 - want32).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        check(bool(torch.isfinite(got32).all()), f"{what}: non-finite output")
        if got.dtype == torch.bfloat16:
            # a bf16 value in [2^e, 2^(e+1)) has an ulp of 2^(e-7)
            ulp = torch.exp2(torch.floor(torch.log2(want32.abs().clamp_min(1e-30))) - 7)
            ok = bool((diff <= ulps * ulp + atol).all())
        else:
            ok = bool((diff <= atol + rtol * want32.abs()).all())
        check(ok, f"{what}: differs from the plain version by {err}")
        return err

    def attn_inputs(self, seed: int, *shapes):
        gen = self.torch.Generator(device="cuda").manual_seed(seed)
        return [self.torch.randn(*shape, generator=gen, device="cuda") for shape in shapes]

    def prefill_kernel_phase(self, label: str, b: int, s: int, h: int, hkv: int, d: int,
                             window: int = 0, record: bool = False) -> None:
        """The prefill kernel against its plain version in f32 (the fma
        route) and bf16 (the tc route) on seeded normal q, k, v; ``record``
        times both runs, their plain versions and SDPA (causal, GQA) in their
        dtype: the bf16 numbers are the kernel's recorded phase, and each
        route gets a kernels-line row at this shape."""
        torch, mod = self.torch, self.kernels["flash_prefill"]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        base = self.attn_inputs(s + h + window, (b, s, h, d), (b, s, hkv, d), (b, s, hkv, d))
        # visible (query, key) pairs of one head: min(position + 1, window)
        rows = np.arange(1, s + 1)
        pairs = int(np.minimum(rows, window).sum() if window else rows.sum())
        elems = 2 * b * s * h * d + 2 * b * s * hkv * d   # q, o, k, v
        flops = 4 * d * pairs * b * h
        orders, libraries = {}, {}
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            q, k, v = (x.to(dtype) for x in base)
            run = lambda: mod.flash_prefill(q, k, v, window=window)  # noqa: E731
            plain = lambda: mod.flash_prefill_plain(q, k, v, window=window)  # noqa: E731
            route = mod.choose_route(dtype)
            err = self.hold_close(f"flash_prefill/{label}/{name}", run(), plain(),
                                  ATTN_F32_ATOL, ATTN_BF16_ULPS)
            self.note_err(f"flash_prefill/{route}", err)
            numbers = {"route": route, "max_abs_err": err,
                       "ms": self.launch_ms(run), "wrapper_ms": cuda_ms(torch, run)}
            if record:
                numbers["plain_ms"] = cuda_ms(torch, plain, reps=3)
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                fn = lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)  # noqa: E731
                libraries[name] = (cuda_ms(torch, fn), *device_ms(torch, fn), None)
                size, rate = (2, "bf16_flops") if name == "bf16" else (4, "f32_flops")
                self.route_row("flash_prefill", route, label, numbers, size * elems, flops,
                               rate, libraries[name], dtype=name)
            orders[name] = numbers
        self.finish_phase("flash_prefill", label, orders, "bf16", 2 * elems, flops,
                          libraries.get("bf16", (None,) * 4),
                          {"b": b, "s": s, "h": h, "hkv": hkv, "d": d, "window": window,
                           "visible_pairs_per_head": pairs}, record, 1, "bf16_flops")

    def decode_kernel_phase(self, label: str, b: int, hkv: int, g: int, d: int, s: int,
                            lengths: list, *, timed: bool = False,
                            record: bool = False) -> int:
        """The decode kernel against its plain version in f32 and bf16 over
        a seeded normal cache. ``timed`` (a serve shape) adds each dtype's
        profiler device time of the wrapper call (both kernels it launches),
        and in bf16 the plain version and SDPA (GQA, a length mask); with
        ``record`` the bf16 numbers go into the kernels line. Returns the
        wrapper's split count at this shape."""
        torch, mod = self.torch, self.kernels["decode_attention"]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        base = self.attn_inputs(s + g, (b, hkv, g, d), (b, s, hkv, d), (b, s, hkv, d))
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        n_split = mod.device_split(b, hkv, s, lens.device)
        orders, library = {}, (None,) * 4
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            q, k, v = (x.to(dtype) for x in base)
            run = lambda: mod.decode_attention(q, k, v, lens)  # noqa: E731
            plain = lambda: mod.decode_attention_plain(q, k, v, lens)  # noqa: E731
            numbers = {"max_abs_err": self.hold_close(f"decode_attention/{label}/{name}",
                                                      run(), plain(), ATTN_F32_ATOL,
                                                      ATTN_BF16_ULPS),
                       "ms": self.launch_ms(run), "wrapper_ms": cuda_ms(torch, run)}
            if timed:
                numbers["device_ms"], numbers["device_incomplete_traces"] = kernel_device_ms(
                    torch, run, TRACE_NAMES["decode_attention"], mod.KERNELS_PER_CALL)
            if timed and name == "bf16":
                numbers["plain_ms"] = cuda_ms(torch, plain)
                mask = (torch.arange(s, device="cuda")[None, :] < lens[:, None])[:, None, None]
                qt, kt, vt = q.reshape(b, hkv * g, 1, d), k.transpose(1, 2), v.transpose(1, 2)
                fn = lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)  # noqa: E731
                library = (cuda_ms(torch, fn), *device_ms(torch, fn), None)
            orders[name] = numbers
        live = int(np.minimum(np.asarray(lengths), s).clip(0).sum())
        moved = 2 * (2 * b * hkv * g * d + 2 * live * hkv * d) + 4 * b   # bf16, lengths
        flops = 4 * d * g * hkv * live
        self.finish_phase("decode_attention", label, orders, "bf16", moved, flops, library,
                          {"b": b, "hkv": hkv, "g": g, "d": d, "s": s,
                           "lengths": list(lengths), "n_split": n_split}, record,
                          mod.KERNELS_PER_CALL, "bf16_flops")
        return n_split

    def lm_batch(self, prompts) -> dict:
        """The prompts right-padded into one prefill batch, with their lengths."""
        torch = self.torch
        lens = [len(p) for p in prompts]
        toks = np.zeros((len(prompts), max(lens)), np.int32)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
        return {"tokens": torch.from_numpy(toks).cuda(),
                "lengths": torch.tensor(lens, dtype=torch.int32, device="cuda")}

    def teacher_forced(self, model, cfg, batch, outs) -> tuple:
        """Prefill, then one decode step per generated token, each fed the
        serve run's own token: (the logits of every step, the cache)."""
        tf = self.m["transformer"]
        torch = self.torch
        with torch.inference_mode():
            logits, cache = tf.prefill(model, batch, cfg, LM_CACHE)
            steps = [logits]
            for t in range(LM_NEW - 1):
                logits, cache = tf.decode_step(model, cache, outs[:, t:t + 1], cfg)
                steps.append(logits)
        torch.cuda.synchronize()
        return steps, cache

    @contextlib.contextmanager
    def plain_path(self):
        """The ``ops`` entries the model calls, swapped for the kernels' plain
        versions (the plain path of the serving checks)."""
        from unittest import mock

        ops = self.m["ops"]
        fp, gm = self.kernels["flash_prefill"], self.kernels["grouped_matmul"]

        def plain_prefill(q, k, v, bq=256, bk=512, window=0):
            return fp.flash_prefill_plain(q, k, v, window=window, bq=bq, bk=bk)

        def plain_gmm(x, w, seg_rows, out_dtype=None):
            return gm.grouped_matmul_plain(x, w, seg_rows, out_dtype=out_dtype)
        with mock.patch.object(ops, "flash_prefill", plain_prefill), \
                mock.patch.object(ops, "decode_attention",
                                  self.kernels["decode_attention"].decode_attention_plain), \
                mock.patch.object(ops, "grouped_matmul_ragged", plain_gmm):
            yield

    @contextlib.contextmanager
    def routes(self, model):
        """Every MoE layer's top-k experts (sorted) at every call, recomputed
        from the layer's input by a forward hook: a list of int [B, S, k]."""
        torch, record = self.torch, []

        def hook(module, inputs, output):
            x = inputs[0]
            idx = torch.topk(x.float() @ module.router.float(), module.cfg.top_k, dim=-1).indices
            record.append(torch.sort(idx, dim=-1).values)
        handles = [layer.moe.register_forward_hook(hook)
                   for layer in model.layers if layer.is_moe]
        try:
            yield record
        finally:
            for handle in handles:
                handle.remove()

    def dropped(self, cfg, idx) -> int:
        """Assignments over the per-row capacity in one routing ``idx`` [B, S, k]."""
        torch = self.torch
        b, s, _ = idx.shape
        counts = torch.nn.functional.one_hot(idx.reshape(b, -1), cfg.n_experts).sum(1)
        cap = self.m["moe"].capacity(cfg, s)
        return int((counts - cap).clamp(min=0).sum())

    @staticmethod
    def route_agreement(a: list, b: list) -> float | None:
        """Share of (layer call, token) routes with the same expert set."""
        if not a:
            return None
        check(len(a) == len(b), f"{len(a)} routed calls against {len(b)}")
        same = sum(int((x == y).all(-1).sum()) for x, y in zip(a, b))
        return same / sum(x[..., 0].numel() for x in a)

    def compare_logits(self, label, cfg, kern, plain, out_t) -> dict:
        """Teacher-forced logits, step by step, against the plain path's,
        relative to the plain logits' std."""
        torch = self.torch
        ratios_max, ratios_mean, tf_equal = [], [], []
        for t, (a, w) in enumerate(zip(kern, plain)):
            check(tuple(a.shape) == (LM_BATCH, cfg.vocab_size)
                  and bool(torch.isfinite(a).all()), f"{label}: step {t} logits malformed")
            std = float(w.std())
            diff = (a - w).abs()
            ratios_max.append(float(diff.max()) / std)
            ratios_mean.append(float(diff.mean()) / std)
            tf_equal.append(float((w.argmax(-1) == out_t[:, t]).float().mean()))
        first, first_plain = kern[0].argmax(-1).tolist(), plain[0].argmax(-1).tolist()
        return {"logit_max_over_std": max(ratios_max),
                "logit_mean_over_std": max(ratios_mean),
                "logit_max_over_std_by_step": ratios_max,
                "first_tokens": first, "first_tokens_plain": first_plain,
                "first_tokens_equal": first == first_plain,
                "teacher_forced_greedy_equal_share": float(np.mean(tf_equal))}

    def route_want(self, cfg, passes: int = LM_NEW) -> dict:
        """The launches of every route of the routed kernels in one prefill
        and ``passes - 1`` decode steps of ``cfg``: in bf16 the prefill on the
        tensor cores, the grouped GEMM on the tile route at prefill (B x S x
        k rows) and the small route at decode (B x k rows); in f32 all on the
        fma routes."""
        layers = cfg.n_layers
        n_gmm = 3 * layers if cfg.family == "moe" else 0
        if cfg.compute_dtype == "bfloat16":
            counts = {"flash_prefill/tc": layers, "grouped_matmul/tile": n_gmm,
                      "grouped_matmul/small": n_gmm * (passes - 1)}
        else:
            counts = {"flash_prefill/fma": layers, "grouped_matmul/fma": n_gmm * passes}
        return {f"{kernel}/{route}": counts.get(f"{kernel}/{route}", 0)
                for kernel in ROUTED for route in self.kernels[kernel].ROUTE_LAUNCHES}

    def check_routes(self, label: str, cfg, launches: dict) -> dict:
        """Every route's launches in a main-path run against ``route_want``;
        the first run that launches a route is the one its kernels-line rows
        report."""
        want = self.route_want(cfg)
        for key, n in want.items():
            check(launches[key] == n, f"{label}: {key} launched {launches[key]} times, "
                  f"expected {n}")
            if n:
                self.route_runs.setdefault(key, (label, n))
        return {key: launches[key] for key in want}

    def serve_run(self, label: str, cfg, model, prompts, *, gate: bool) -> list:
        """``serve_batch`` at full width (after a two-token warm-up), its
        launches counted; then the same tokens teacher-forced through the
        kernel path and through the plain path (``ops`` patched to the plain
        versions), logits compared step by step (``gate``: held to
        LOGIT_MAX_TOL / LOGIT_MEAN_TOL, and the first token of every request
        to the plain path's; else printed only, with the share of MoE routes
        that agree); a free-running plain serve gives the share of equal
        greedy tokens (printed). Returns the served tokens."""
        torch = self.torch
        serve = self.m["serve"]
        moe = cfg.family == "moe"
        kwargs = {"cache_len": LM_CACHE, "params": model}
        serve.serve_batch(cfg, prompts, max_new_tokens=2, **kwargs)   # warm-up
        self.reset_counters()
        torch.cuda.reset_peak_memory_stats()
        outs, stats = serve.serve_batch(cfg, prompts, max_new_tokens=LM_NEW, **kwargs)
        launches = self.read_counters()
        peak = torch.cuda.max_memory_allocated()
        want = {"flash_prefill": cfg.n_layers, "decode_attention": cfg.n_layers * (LM_NEW - 1),
                "grouped_matmul": 3 * cfg.n_layers * LM_NEW if moe else 0}
        for kernel, n in want.items():
            check(launches[kernel] == n, f"{label}: {kernel} launched {launches[kernel]} "
                  f"times, expected {n}")
        self.check_routes(label, cfg, launches)
        # the kernels line reports each kernel's launches in the run at the
        # shapes of its recorded phase: attention in the first (dense) run
        for kernel in ("flash_prefill", "decode_attention"):
            self.launches.setdefault(kernel, launches[kernel])
        if moe:
            self.launches["grouped_matmul"] = launches["grouped_matmul"]
        check(len(outs) == LM_BATCH and all(len(o) == LM_NEW for o in outs)
              and all(0 <= t < cfg.vocab_size for o in outs for t in o),
              f"{label}: outputs are not {LM_BATCH} x {LM_NEW} token ids")

        batch = self.lm_batch(prompts)
        out_t = torch.tensor(outs, dtype=torch.int32, device="cuda")
        with self.routes(model) as kern_routes:
            kern, cache = self.teacher_forced(model, cfg, batch, out_t)
        kernel_repeats = bool(torch.equal(torch.stack([x.argmax(-1) for x in kern], 1),
                                          out_t.long()))
        # one more decode step and one prefill, traced: the device's busy
        # share of each and the port kernels' device time in it
        tf = self.m["transformer"]
        n_gmm = 3 * cfg.n_layers if moe else 0

        def step():
            with torch.inference_mode():
                tf.decode_step(model, cache, out_t[:, -1:], cfg)
        per_call = self.kernels["decode_attention"].KERNELS_PER_CALL
        step_trace = traced_call(torch, step, {"decode_attention": per_call * cfg.n_layers,
                                               "grouped_matmul": n_gmm})
        del cache

        def prefill():
            with torch.inference_mode():
                tf.prefill(model, batch, cfg, LM_CACHE)
        prefill_trace = traced_call(torch, prefill, {"flash_prefill": cfg.n_layers,
                                                     "grouped_matmul": n_gmm})

        with self.plain_path():
            with self.routes(model) as plain_routes:
                plain, cache = self.teacher_forced(model, cfg, batch, out_t)
            del cache
            plain_outs, plain_stats = serve.serve_batch(cfg, prompts, max_new_tokens=LM_NEW,
                                                        **kwargs)
        result = self.compare_logits(label, cfg, kern, plain, out_t)
        first = [o[0] for o in outs]
        result.update({"tolerances": [LOGIT_MAX_TOL, LOGIT_MEAN_TOL] if gate else None,
                       "first_tokens_served": first,
                       "free_running_greedy_equal_share":
                           float(np.mean(np.asarray(outs) == np.asarray(plain_outs))),
                       "kernel_path_repeats_serve_tokens": kernel_repeats})
        if gate:
            check(result["logit_max_over_std"] <= LOGIT_MAX_TOL
                  and result["logit_mean_over_std"] <= LOGIT_MEAN_TOL,
                  f"{label}: teacher-forced logits differ from the plain path by up to "
                  f"{result['logit_max_over_std']} (max) / {result['logit_mean_over_std']} "
                  "(mean) of their std")
            check(first == result["first_tokens_plain"],
                  f"{label}: first tokens {first} != plain {result['first_tokens_plain']}")
        moe_numbers = {}
        if moe:
            n_prefill = cfg.n_layers   # the first calls: one per layer at prefill
            moe_numbers = {
                "route_agreement": self.route_agreement(kern_routes, plain_routes),
                "route_agreement_prefill": self.route_agreement(kern_routes[:n_prefill],
                                                                plain_routes[:n_prefill]),
                "prefill_capacity": self.m["moe"].capacity(cfg, kern_routes[0].shape[1]),
                "prefill_dropped_by_layer": [self.dropped(cfg, r)
                                             for r in kern_routes[:n_prefill]],
                "decode_dropped": sum(self.dropped(cfg, r) for r in kern_routes[n_prefill:]),
                "prefill_assignments_per_layer": kern_routes[0].numel()}
            check(moe_numbers["decode_dropped"] == 0, f"{label}: decode dropped assignments")
        decode_steps = LM_NEW - 1
        lens = [len(p) for p in prompts]
        emit({"run": label, "arch": cfg.name, "family": cfg.family,
              "n_layers": cfg.n_layers, "d_model": cfg.d_model,
              "heads": [cfg.n_heads, cfg.n_kv_heads], "d_ff": cfg.d_ff,
              "experts": [cfg.n_experts, cfg.top_k], "vocab": cfg.vocab_size,
              "compute_dtype": cfg.compute_dtype,
              "params": sum(p.numel() for p in model.parameters()),
              "prompt_lens": lens, "padded_len": max(lens), "cache_len": LM_CACHE,
              "new_tokens": LM_NEW, "launches": launches,
              "prefill_ms": stats.prefill_s * 1e3,
              "decode_ms_per_step": stats.decode_s / decode_steps * 1e3,
              "decode_tokens_per_s": LM_BATCH * decode_steps / stats.decode_s,
              "serve_tokens_per_s": stats.tokens_per_s,
              "plain_prefill_ms": plain_stats.prefill_s * 1e3,
              "plain_decode_ms_per_step": plain_stats.decode_s / decode_steps * 1e3,
              "peak_memory_bytes": peak,
              "decode_step_trace": step_trace, "prefill_trace": prefill_trace,
              "moe": moe_numbers or None, "gated": gate, "check": result})
        return outs

    # -- fourth path: MoE serving ----------------------------------------------

    def capture_moe_inputs(self, model, cfg, batch) -> dict:
        """Layer 0's MoE input and the rows and groups of its first expert
        product (w1), at the serve batch's prefill and at the decode step
        after it (fed the prefill's greedy tokens)."""
        from unittest import mock

        torch, ops, tf = self.torch, self.m["ops"], self.m["transformer"]
        layer = model.layers[0].moe
        real, products, inputs = ops.grouped_matmul_ragged, [], []

        def recorder(x, w, seg_rows, out_dtype=None):
            if w is layer.w1:
                products.append((x, seg_rows))
            return real(x, w, seg_rows, out_dtype)
        handle = layer.register_forward_hook(lambda m, i, o: inputs.append(i[0]))
        try:
            with mock.patch.object(ops, "grouped_matmul_ragged", recorder), \
                    torch.inference_mode():
                logits, cache = tf.prefill(model, batch, cfg, LM_CACHE)
                nxt = logits.argmax(-1).to(torch.int32)[:, None]
                tf.decode_step(model, cache, nxt, cfg)
                del cache
        finally:
            handle.remove()
        torch.cuda.synchronize()
        check(len(products) == 2 and len(inputs) == 2,
              f"captured {len(products)} products and {len(inputs)} inputs, expected 2 each")
        return {"prefill": (inputs[0], *products[0]), "decode": (inputs[1], *products[1])}

    def hold_gmm(self, what: str, got, want) -> float:
        return self.hold_close(what, got, want, GMM_F32_ATOL, GMM_BF16_ULPS, GMM_F32_RTOL)

    def library_gmm(self, x, w, seg_rows, n_rows: int) -> tuple:
        """The yardstick of the grouped GEMM on the same operands:
        ``torch._grouped_mm`` where this torch has it and takes them, else
        ``torch.bmm`` over the reference's [E, cap, K] capacity buffer, cap
        the largest group (at the prefill shape at most 2,432 rows: about
        1.3 GB in f32). (name, wall ms, device ms, empty traces, error
        text)."""
        torch = self.torch
        error = None
        if hasattr(torch, "_grouped_mm"):
            offs = seg_rows[1:].to(torch.int32)
            xs = x[:n_rows]
            fn = lambda: torch._grouped_mm(xs, w, offs=offs)  # noqa: E731
            try:
                return ("torch._grouped_mm", cuda_ms(torch, fn), *device_ms(torch, fn), None)
            except RuntimeError as err:   # torch refuses: fall back to bmm
                error = str(err).splitlines()[0]
        sizes = (seg_rows[1:] - seg_rows[:-1]).tolist()
        cap = max(max(sizes), 1)
        buf = x.new_zeros((w.shape[0], cap, x.shape[1]))
        for g, (r0, n) in enumerate(zip(seg_rows[:-1].tolist(), sizes)):
            buf[g, :n] = x[r0:r0 + n]
        fn = lambda: torch.bmm(buf, w)  # noqa: E731
        return ("torch.bmm over the capacity buffer", cuda_ms(torch, fn),
                *device_ms(torch, fn), error)

    def gmm_kernel_phase(self, label: str, x, seg_rows, w) -> None:
        """The grouped GEMM against its plain version on rows ``x`` grouped by
        ``seg_rows`` against ``w``: in bf16 by every route (tile, small, fma)
        and in f32 (the operands widened; the fma route). The plain version
        and the library yardstick are timed in each dtype, and the tile and
        small routes (bf16) and the fma route (f32) each get a kernels-line
        row at this shape. At the prefill shape the wrapper's own choice in
        bf16 is the kernel's recorded phase."""
        torch, gm = self.torch, self.kernels["grouped_matmul"]
        n_rows = int(seg_rows[-1])
        e, k, n = w.shape
        sizes = seg_rows[1:] - seg_rows[:-1]
        used = int((sizes > 0).sum())
        # bytes: x's kept rows, the weights of every expert with a row, y's
        # kept rows (in the dtype), and seg_rows
        elems = n_rows * k + used * k * n + n_rows * n
        flops = 2 * n_rows * k * n
        chosen = gm.choose_route(torch.bfloat16, torch.bfloat16, k, n, x.shape[0])
        orders, plain_ms, libraries = {}, {}, {}
        runs = [(f"bf16_{r}", torch.bfloat16, r) for r in gm.ROUTES] + [
            ("f32", torch.float32, "fma")]
        for dname, dtype, route in runs:
            xd, wd = x.to(dtype), w.to(dtype)
            run = lambda: gm.grouped_matmul_ragged(xd, wd, seg_rows, route=route)  # noqa: E731
            plain = lambda: gm.grouped_matmul_plain(xd, wd, seg_rows)  # noqa: E731
            err = self.hold_gmm(f"grouped_matmul/{label}/{dname}", run()[:n_rows],
                                plain()[:n_rows])
            self.note_err(f"grouped_matmul/{route}", err)
            numbers = {"route": route, "max_abs_err": err, "ms": self.launch_ms(run),
                       "wrapper_ms": cuda_ms(torch, run)}
            tag = str(dtype).removeprefix("torch.")
            if tag not in plain_ms:
                plain_ms[tag] = cuda_ms(torch, plain, reps=3)
                libraries[tag] = self.library_gmm(xd, wd, seg_rows, n_rows)
            numbers["plain_ms"] = plain_ms[tag]
            orders[dname] = numbers
            if dname != "bf16_fma":
                size, rate = (2, "bf16_flops") if tag == "bfloat16" else (4, "f32_flops")
                name, *library = libraries[tag]
                self.route_row("grouped_matmul", route, label, numbers,
                               size * elems + 8 * (e + 1), flops, rate, library,
                               dtype=tag, library_call=name,
                               chosen_at_shape=route == gm.choose_route(
                                   dtype, dtype, k, n, x.shape[0]))
            del xd, wd
        record = label == GMM_PREFILL_LABEL
        name, *library = libraries["bfloat16"]
        self.finish_phase("grouped_matmul", label, orders, f"bf16_{chosen}",
                          2 * elems + 8 * (e + 1), flops, library,
                          {"rows": n_rows, "x_rows": x.shape[0], "k": k, "n": n, "groups": e,
                           "groups_used": used, "largest_group": int(sizes.max()),
                           "route": chosen, "library_call": name,
                           "library_f32": libraries["float32"]}, record, 1, "bf16_flops")
        if record:
            self.phase["grouped_matmul"]["library_call"] = name

    def gmm_edge_phase(self) -> None:
        """The kernel on ragged cases: empty groups, groups of one row, a
        single group, all groups empty, N and K off the tensor-core routes'
        16-byte chunks, rows past the last group. f32 (the fma route), bf16
        by every route the operands fit (tile and small need K and N
        multiples of 8; forcing either on other operands must raise), and
        bf16 to an f32 output (the fma route; forcing a tensor-core route
        must raise); and the padded ``ops.grouped_matmul`` against its CPU
        (plain) run, pad rows zero."""
        torch, gm, ops = self.torch, self.kernels["grouped_matmul"], self.m["ops"]
        gen = torch.Generator(device="cuda").manual_seed(GMM_EDGE_SEED)
        cases = [([37, 0, 91, 12, 0, 300], 2048, 1000), ([1] * 8, 40, 72),
                 ([129], 17, 130), ([0, 0, 0], 64, 64), ([0, 5, 0, 250], 33, 1)]
        result = []
        for sizes, k, n in cases:
            t = sum(sizes)
            seg = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]), dtype=torch.int64,
                               device="cuda")
            x = torch.randn(t + 9, k, generator=gen, device="cuda")
            w = torch.randn(len(sizes), k, n, generator=gen, device="cuda") * k ** -0.5
            fits = k % 8 == 0 and n % 8 == 0
            errs, refused = {}, []
            for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                xd, wd = x.to(dtype), w.to(dtype)
                want = gm.grouped_matmul_plain(xd, wd, seg)[:t]
                routes = tuple(gm.ROUTES) if dtype == torch.bfloat16 and fits else ("fma",)
                for route in routes:
                    errs[f"{dname}_{route}"] = self.hold_gmm(
                        f"grouped_matmul/edge{sizes}/{dname}_{route}",
                        gm.grouped_matmul_ragged(xd, wd, seg, route=route)[:t], want)
                    self.note_err(f"grouped_matmul/{route}", errs[f"{dname}_{route}"])
                outs = [(dtype, f"{dname}_out")]
                if dtype == torch.bfloat16:
                    outs.append((torch.float32, "bf16_f32out"))
                for out_dtype, key in outs:
                    for route in ("tile", "small"):
                        if out_dtype == dtype and route in routes:
                            continue
                        try:
                            gm.grouped_matmul_ragged(xd, wd, seg, out_dtype, route)
                        except ValueError:
                            refused.append(f"{key}_{route}")
                            continue
                        check(False, f"grouped_matmul/edge{sizes}/{key}: the {route} route "
                              "took operands it does not fit")
                if dtype == torch.bfloat16:
                    want32 = gm.grouped_matmul_plain(xd, wd, seg, out_dtype=torch.float32)[:t]
                    got32 = gm.grouped_matmul_ragged(xd, wd, seg, torch.float32)
                    errs["bf16_f32out_fma"] = self.hold_gmm(
                        f"grouped_matmul/edge{sizes}/bf16_f32out", got32[:t], want32)
                    self.note_err("grouped_matmul/fma", errs["bf16_f32out_fma"])
                y, offs = ops.grouped_matmul(xd[:t], wd, sizes, bt=32, bn=1, bk=1)
                y_cpu, offs_cpu = ops.grouped_matmul(xd[:t].cpu(), wd.cpu(), sizes, bt=32,
                                                     bn=1, bk=1)
                check(np.array_equal(offs, offs_cpu), f"padded {sizes}: offsets differ")
                errs[f"padded_{dname}"] = self.hold_gmm(f"ops.grouped_matmul{sizes}/{dname}",
                                                        y, y_cpu.cuda())
                pad = sum(float(y[offs[g] + m: offs[g + 1]].abs().sum())
                          for g, m in enumerate(sizes))
                check(pad == 0, f"padded {sizes}/{dname}: pad rows are not zero")
            result.append({"sizes": sizes, "k": k, "n": n, "max_abs_err": errs,
                           "refused_routes": refused})
            self.note_err("grouped_matmul", max(errs.values()))
        emit({"edge_phase": "grouped_matmul_ragged", "cases": result})

    def moe_layer_phase(self, label: str, layer, x) -> None:
        """One full-width MoE layer on the input ``x`` it saw in the serve
        batch, through the kernel path and the plain path (``ops`` patched),
        in the model's bf16 and in an f32 copy of the layer. The routing is
        the same on both paths, so the outputs differ only by the products'
        summation order: held within two ulps (bf16) or the f32 atol and
        rtol at the scale of the layer's largest output, because a one-ulp
        difference of one product moves an output near zero by many of its
        own ulps."""
        torch, moe = self.torch, self.m["moe"]
        cfg32 = dataclasses.replace(layer.cfg, compute_dtype="float32")
        layer32 = moe.MoE(cfg32, "cuda")
        with torch.no_grad():
            for name in ("router", "w1", "w3", "w2"):
                getattr(layer32, name).copy_(getattr(layer, name))
        numbers = {}
        for dname, mod, xin in (("bf16", layer, x), ("f32", layer32, x.float())):
            with torch.inference_mode():
                y, aux = moe.moe_apply(mod, xin, mod.cfg)
                with self.plain_path():
                    y_plain, aux_plain = moe.moe_apply(mod, xin, mod.cfg)
            torch.cuda.synchronize()
            err = float((y.float() - y_plain.float()).abs().max())
            scale = float(y_plain.float().abs().max())
            if dname == "bf16":
                tol = GMM_BF16_ULPS * 2.0 ** (np.floor(np.log2(scale)) - 7)
            else:
                tol = GMM_F32_ATOL + GMM_F32_RTOL * scale
            check(bool(torch.isfinite(y.float()).all()) and err <= tol,
                  f"moe_layer/{label}/{dname}: differs from the plain path by {err} "
                  f"(allowed {tol})")
            check(float(aux) == float(aux_plain), f"moe_layer/{label}/{dname}: aux differs")
            numbers[dname] = {"max_abs_err": err, "tolerance": tol, "max_abs_out": scale,
                              "ms": cuda_ms(torch, lambda: mod(xin), reps=3)}
        idx = torch.topk(x.float() @ layer.router.float(), layer.cfg.top_k, dim=-1).indices
        emit({"moe_layer_phase": label, "shape": list(x.shape),
              "capacity": moe.capacity(layer.cfg, x.shape[1]),
              "assignments": idx.numel(), "dropped": self.dropped(layer.cfg, idx),
              "dtypes": numbers})
        del layer32

    def f32_check(self, label: str, cfg, prompts, outs) -> None:
        """The model in f32 (the same seed: the bf16 model's weights before
        their rounding) teacher-forced on the served tokens through the
        kernel path and the plain path: every step's logits within
        F32_LOGIT_MAX_TOL (worst element) and F32_LOGIT_MEAN_TOL (mean) of
        the plain logits' std, every first token equal."""
        torch = self.torch
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        model = self.m["transformer"].init_params(
            cfg32, torch.Generator(device="cuda").manual_seed(LM_WEIGHT_SEED), "cuda")
        batch = self.lm_batch(prompts)
        out_t = torch.tensor(outs, dtype=torch.int32, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        self.reset_counters()
        with self.routes(model) as kern_routes:
            kern, cache = self.teacher_forced(model, cfg32, batch, out_t)
        del cache
        peak = torch.cuda.max_memory_allocated()
        route_launches = self.check_routes(label, cfg32, self.read_counters())
        with self.plain_path(), self.routes(model) as plain_routes:
            plain, cache = self.teacher_forced(model, cfg32, batch, out_t)
        del cache, model
        result = self.compare_logits(label, cfg32, kern, plain, out_t)
        result["route_agreement"] = self.route_agreement(kern_routes, plain_routes)
        result["prefill_dropped_by_layer"] = [self.dropped(cfg32, r)
                                              for r in kern_routes[:cfg.n_layers]]
        result["tolerances"] = [F32_LOGIT_MAX_TOL, F32_LOGIT_MEAN_TOL]
        emit({"run": label, "arch": cfg32.name, "compute_dtype": cfg32.compute_dtype,
              "peak_memory_bytes": peak, "route_launches": route_launches,
              "check": result})
        check(result["logit_max_over_std"] <= F32_LOGIT_MAX_TOL
              and result["logit_mean_over_std"] <= F32_LOGIT_MEAN_TOL,
              f"{label}: f32 teacher-forced logits differ from the plain path by up to "
              f"{result['logit_max_over_std']} (max) / {result['logit_mean_over_std']} "
              "(mean) of their std")
        check(result["first_tokens_equal"], f"{label}: first tokens {result['first_tokens']} "
              f"!= plain {result['first_tokens_plain']}")

    def kernels_line(self) -> None:
        """One row per kernel; a routed kernel has one row per route and
        served shape instead (``kernel_route``, ``shape``), whose
        ``launches`` are the route's launches in ``launches_run``, the
        main-path run that launches it (the bf16 serve run, or the f32 check
        for the fma routes); ``chosen_at_shape`` says whether the wrapper
        picks the route at that shape."""
        rows = []
        for kernel, numbers in self.phase.items():
            check(self.launches.get(kernel, 0) > 0,
                  f"{kernel}: launched no time on its main-path run")
            base = {"name": kernel, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/"
                              f"{SOURCE_FILE.get(kernel, kernel)}.cu",
                    "replaces": REPLACES[kernel]}
            if kernel not in ROUTED:
                rows.append({**base, "launches": self.launches[kernel],
                             "max_abs_err": self.max_err[kernel], **numbers})
                continue
            for route in self.kernels[kernel].ROUTE_LAUNCHES:
                key = f"{kernel}/{route}"
                check(key in self.route_runs, f"{key}: launched no time on the main path")
                run, launches = self.route_runs[key]
                shapes = [sh for (k, r, sh) in self.route_rows if (k, r) == (kernel, route)]
                check(bool(shapes), f"{key}: no timed phase")
                for shape in shapes:
                    rows.append({**base, "kernel_route": route, "shape": shape,
                                 "launches": launches, "launches_run": run,
                                 "max_abs_err": self.max_err[key],
                                 **self.route_rows[kernel, route, shape]})
        check({r["name"] for r in rows} == set(self.kernels), "a kernel phase is missing")
        emit({"kernels": rows})


def main() -> int:
    started = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch is missing; run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    smoke = Smoke(torch)
    smoke.card()
    smoke.build()
    smoke.sass_phase()

    # kernel phases at the shapes the main path stages (quickstart budget,
    # chunk2 6x1: these numbers go into the kernels line), then at the chunk1
    # 15x4 plans with a nonzero C_prev, then on the full-table edge geometry
    planner, mm = smoke.m["planner"], smoke.m["memory_model"]
    A48, P48 = smoke.problem("brick3d", 48)
    crb, budget = smoke.quickstart_inputs(A48, P48)
    plan48 = planner.plan_chunks(A48, P48, crb, mm.P100, fast_limit_bytes=budget)
    plan48c1 = planner.plan_chunks(A48, P48, crb, mm.P100, fast_limit_bytes=budget / 3)
    check(plan48c1.algorithm == "chunk1" and plan48c1.n_b > 1,
          f"brick3d48 at budget/3 plans {plan48c1.algorithm} x{plan48c1.n_b}")
    order48 = "chunk2" if plan48.algorithm == "chunk2" else "chunk1"
    for kernel in ("hash_accum_spgemm", "sparse_accum_spgemm"):
        smoke.csr_kernel_phase(kernel, A48, P48, plan48, order48,
                               label="brick3d48_quickstart", record=True)
        smoke.csr_kernel_phase(kernel, A48, P48, plan48c1, "chunk1",
                               label="brick3d48_chunk1_c0", c0_from=P48)
    A32, P32 = smoke.problem("brick3d", 32)
    crb32, budget32 = smoke.quickstart_inputs(A32, P32)
    plan32 = planner.plan_chunks(A32, P32, crb32, mm.P100, fast_limit_bytes=budget32)
    smoke.dense_kernel_phase(A32, P32, plan32, label="brick3d32_quickstart", record=True)
    plan32c1 = planner.plan_chunks(A32, P32, crb32, mm.P100, fast_limit_bytes=budget32 / 3)
    check(plan32c1.n_b > 1, f"brick3d32 at budget/3 plans {plan32c1.n_b} chunk")
    smoke.dense_kernel_phase(A32, P32, plan32c1, label="brick3d32_chunk1_c0",
                             c0_seed=EDGE_SEED)
    smoke.edge_phase()
    smoke.esc_class_phase()
    smoke.hash_class_phase()

    # the main path, counters reset before each run
    smoke.main_run("brick3d48_auto", "brick3d", 48, "auto", expect_backend="hash")
    smoke.main_run("brick3d48_sparse", "brick3d", 48, "sparse")
    smoke.main_run("brick3d48_scan", "brick3d", 48, "scan")
    smoke.main_run("brick3d48_knl_hash", "brick3d", 48, "hash", knl_div=3,
                   expect_algorithm="knl")
    smoke.main_run("brick3d48_chunk1_auto", "brick3d", 48, "auto", budget_div=12,
                   expect_algorithm="chunk1")
    smoke.main_run("brick3d48_chunk1_sparse", "brick3d", 48, "sparse", budget_div=12,
                   expect_algorithm="chunk1")
    smoke.main_run("laplace3d64_auto", "laplace3d", 64, "auto")
    smoke.main_run("elasticity24_auto", "elasticity", 24, "auto")
    smoke.main_run("brick3d32_pallas", "brick3d", 32, "pallas")
    smoke.breakdown("brick3d48_auto", "brick3d", 48, "auto")

    # the second path: its kernels against their plain versions (main-run
    # shapes first: these numbers go into the kernels line), then its runs
    L = smoke.triangle_graph()[0]
    smoke.masked_kernel_phase("tc_rmat18_knl", L, L, L, planner.plan_knl(L, L, float("inf")),
                              "chunk1", record=True)
    graphs, csr = smoke.m["graphs"], smoke.m["csr"]
    L12 = graphs.lower_triangular_degree_sorted(
        graphs.rmat(12, RMAT_EDGE_FACTOR, seed=RMAT_SEED, device="cuda"))
    n12 = L12.n_rows
    thirds = (0, n12 // 3, 2 * n12 // 3, n12)
    smoke.masked_kernel_phase("tc_rmat12_knl", L12, L12, L12,
                              planner.plan_knl(L12, L12, float("inf")), "chunk1")
    gen = torch.Generator(device="cuda").manual_seed(EDGE_SEED)
    c0 = torch.rand(n12, n12, generator=gen, device="cuda")
    c0 = torch.where(c0 < 0.01, c0, 0.0).tril(-1)   # partly inside L's mask
    c0 = csr.csr_from_dense(c0, device="cuda")
    smoke.masked_kernel_phase("tc_rmat12_3x3_c0", L12, L12, L12,
                              planner.ChunkPlan("chunk2", thirds, thirds, 0.0, 0.0),
                              "chunk2", c0_from=c0)
    # rows cut into parts small enough that split rows meet C_prev and
    # chunk2's later launches, which add onto the output
    split = smoke.masked_kernel_phase("tc_rmat12_3x3_c0_split", L12, L12, L12,
                                      planner.ChunkPlan("chunk2", thirds, thirds, 0.0, 0.0),
                                      "chunk2", c0_from=c0, part_size=MASKED_SPLIT_PART)
    check(split["rows_split"] > 0, "tc_rmat12_3x3_c0_split: no row was split")
    smoke.masked_edge_phase()
    smoke.bsr_kernel_phase(A48, P48, plan48, label="brick3d48_bsr", record=True)
    smoke.spmm_kernel_phase(label="bsr_spmm_brick3d48", record=True)

    smoke.triangle_run("tc_rmat18_fused")
    smoke.triangle_run("tc_rmat18_chunk2", chunk2=True)
    for backend in ("hash", "sparse"):
        smoke.galerkin_run(f"galerkin_brick3d48_{backend}_resident", backend,
                           PIPE_RESIDENT, True)
        smoke.galerkin_run(f"galerkin_brick3d48_{backend}_spill", backend, PIPE_SPILL, False)
    smoke.bsr_run("brick3d48_bsr")
    smoke.spmm_run("bsr_spmm_brick3d48")

    # the third path, serving: the attention kernels at the serve run's
    # shapes (these numbers go into the kernels line; decode at a mid-run
    # step), on small ragged cases, then the serve run
    from repro_torch.configs import get_config

    cfg = get_config(LM_ARCH)
    prompts = smoke.lm_prompts(cfg.vocab_size)
    s_pad = max(len(p) for p in prompts)
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    smoke.prefill_kernel_phase("serve_prefill", LM_BATCH, s_pad, h, hkv, d, record=True)
    mid = [s_pad + LM_NEW // 2] * LM_BATCH
    smoke.decode_kernel_phase("serve_decode_mid", LM_BATCH, hkv, h // hkv, d, LM_CACHE, mid,
                              timed=True, record=True)
    moe_cfg = get_config(MOE_ARCH)   # the MoE serve run's decode shape (same prompt lengths)
    smoke.decode_kernel_phase("serve_decode_mid_olmoe", LM_BATCH, moe_cfg.n_kv_heads,
                              moe_cfg.n_heads // moe_cfg.n_kv_heads, moe_cfg.head_dim,
                              LM_CACHE, mid, timed=True)
    for g, dg in ATTN_RAGGED_GQA:
        tag = f"g{g}" if dg == d else f"g{g}_d{dg}"
        for window in (0, 24):
            smoke.prefill_kernel_phase(f"ragged_{tag}_w{window}", 2, 100, 2 * g, 2, dg, window)
        smoke.decode_kernel_phase(f"ragged_{tag}", 4, 2, g, dg, 300, [300, 1, 129, 0])
    # fewer live positions than splits (most splits empty) beside a
    # sequence that fills the cache
    for label, g, dg, lens in (("few_live", 4, 64, [3, LM_CACHE]),
                               ("few_live_g9_d128", 9, 128, [5, LM_CACHE])):
        n_split = smoke.decode_kernel_phase(label, 2, 1, g, dg, LM_CACHE, lens)
        check(min(n for n in lens if n) < n_split,
              f"decode_attention/{label}: {n_split} splits, no fewer live positions")
    # a batch of more (sequence, KV head) pairs than two blocks an SM: one
    # split, still through the combine
    n_split = smoke.decode_kernel_phase("one_split", 32, hkv, h // hkv, d, LM_CACHE,
                                        [LM_CACHE, 1, 0, 1953] * 8)
    check(n_split == 1, f"decode_attention/one_split: {n_split} splits, not 1")
    model = smoke.m["transformer"].init_params(
        cfg, torch.Generator(device="cuda").manual_seed(LM_WEIGHT_SEED), "cuda")
    smoke.serve_run("serve_llama3_2_1b", cfg, model, prompts, gate=True)
    del model
    torch.cuda.empty_cache()

    # the fourth path, MoE serving: the grouped GEMM at the shapes of layer
    # 0's first expert product in the serve batch (prefill: these numbers go
    # into the kernels line; decode), on ragged cases, one full-width MoE
    # layer, the serve run, then the f32 model teacher-forced on its tokens
    cfg = get_config(MOE_ARCH)
    prompts = smoke.lm_prompts(cfg.vocab_size)
    model = smoke.m["transformer"].init_params(
        cfg, torch.Generator(device="cuda").manual_seed(LM_WEIGHT_SEED), "cuda")
    captured = smoke.capture_moe_inputs(model, cfg, smoke.lm_batch(prompts))
    w1 = model.layers[0].moe.w1
    smoke.gmm_kernel_phase(GMM_PREFILL_LABEL, *captured["prefill"][1:], w1)
    smoke.gmm_kernel_phase(GMM_DECODE_LABEL, *captured["decode"][1:], w1)
    smoke.gmm_edge_phase()
    smoke.moe_layer_phase("layer0_prefill", model.layers[0].moe, captured["prefill"][0])
    smoke.moe_layer_phase("layer0_decode", model.layers[0].moe, captured["decode"][0])
    del captured, w1
    torch.cuda.empty_cache()
    outs = smoke.serve_run("serve_olmoe_1b_7b", cfg, model, prompts, gate=False)
    del model
    torch.cuda.empty_cache()
    smoke.f32_check("olmoe_1b_7b_f32_teacher_forced", cfg, prompts, outs)
    torch.cuda.empty_cache()
    emit({"script_seconds": time.perf_counter() - started})
    smoke.kernels_line()
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
