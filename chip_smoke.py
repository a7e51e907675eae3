"""Drive the PyTorch port's chunked-SpGEMM main path on one H100 and check it.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the CUDA kernels of
``src/repro_torch/kernels/csrc`` (into ``build/repro_torch/``; the dense-slab,
decode-attention, BSR x BSR, ESC and both hash sources, and the f32 FMA
kernels of the prefill and grouped-GEMM sources, must build without
register spills), finds the
tensor-core instructions in the libraries of the two routed kernels
(``cuobjdump -sass``: HMMA in the prefill's, HGMMA and HMMA in the grouped
GEMM's), holds each kernel, in both streaming orders, against its plain PyTorch version at the
shapes the main path stages, at a four-chunk plan with a nonzero C_prev, and
on a small geometry whose dense output row fills its hash table (the dense
slab on its aligned float4 path at the main-path shapes and on its masked
scalar path at the four-chunk plan, its two orders equal bit for bit; the
ESC kernel also where its sort leaves the register classes: shared memory
and 64-bit keys, on L x L of an RMAT scale-12 graph, whose merge steps
are counted and launched by step class (a warp, a block or, past a block's
shared memory, the global class a step), and on rows whose steps land on
each class edge; the
hash kernel also where its extraction compacts a wide
table before the register sort and where it sorts in shared memory; the CSR
kernels also timed by the profiler, split by kernel), then runs
the main path — ``multigrid.problem`` on the card, the host
symbolic phase and planner, ``chunked_spgemm`` — on the paper's problems and
on that RMAT product through ``backend="sparse"``, and
checks every result against the port's plain ``spgemm`` on the card and
against ``scipy.sparse`` in float64. Then the second path: fused-mask
triangle counting on a graph500 scale-18 RMAT graph (``count_triangles``,
the masked hash kernel, one chunk and a chunk2 plan), the two-hop Galerkin
product ``R x (A x P)`` on brick3d n=48 (``pipeline_spgemm`` through the
hash and ESC kernels, intermediate resident and spilled), the ``bsr``
backend on brick3d n=48 and ``ops.bsr_spmm`` of brick3d n=48 by a
110,592 x 128 dense block (on the BSR x dense kernel's group path, counted
by path), each held to scipy in float64, with the masked
(also with its rows cut at a forced small part size, in chunk2 with a
nonzero C_prev; timed by the profiler, launch by launch), BSR x BSR (also
with sentinels inside rows, 40 steps a row, blocks of 4 and 16; timed by
the profiler) and BSR x dense kernels first held to their plain versions
(the BSR x dense kernel timed by the profiler and back to back beside
``torch.sparse_bsr_tensor`` and ``torch.sparse.mm`` of A as CSR, and on
edge cases of both its paths in f32 and bf16: bs 4 and 16, nf 64 and 256,
empty and sentinel-only block rows, shuffled tables, bs 5 and a 64-column
tile on the generic path).
Then operands in slow memory (``placement_phase``): brick3d n=48 with A,
P and C placed as the paper's Table 3 says (a slow operand in pinned host
memory), through ``chunked_spgemm``'s ``hash``, ``sparse``, ``scan``,
``loop`` and ``bsr`` executors, the dense slab (``pallas``) on brick3d n=32,
and ``count_triangles`` with L slow, whose slow pieces cross onto the card
through the two-slot copy ring: each call's C (or count) equal bit for bit
to the same plan's all-fast call (the main path's run), its ChunkStats
equal, the bytes the ring moved equal to the slow operands' copy events,
every ring's op log equal to its schedule's program
(``analysis.dma.check_ring_structure``), every slow stack pinned, the
launches one a step, the card's peak allocation within the ring's byte
model plus 10% (below the slow operands' bytes on the chunk1 plans) and
its live tensors' peak within the model plus 1%; copy and compute ms by
CUDA events, GB/s each way, the share of copy time under compute, and a
256 MB pinned copy as the link's yardstick; a pinned stack handed to any
SpGEMM kernel's wrapper without a run device must raise, also beside an
operand on the card. The same phase
reads slow operands in place (``slow_reads="in_place"``): each of the four
streaming wrappers, given pinned stacks and the card, launches once in
place on brick3d n=8, equal bit for bit to the kernel on card stacks and
within tolerance of its plain version; then brick3d n=48's quickstart plan
under hash in five Table 3 placements and under ESC in HostPin, the chunk1
plan under hash in HostPin, the ESC kernel's counted classes on L x L of
RMAT scale 12, the dense slab on brick3d n=16 (HostPin, DP) and the fused
triangle count on the scale-18 graph with L slow, each beside its ring
twin where one runs: C (or the count) equal bit for bit to the all-fast
call's, one wrapper launch a strip of the plan, each in place (the ESC
classes as the all-fast call's), no ring op, and the card's live peak
within the in-place model (no byte of a slow operand, one strip's
workspace) plus 1%; printed: the launches' kernel ms, the modelled bytes
read in place (``kernels/link_reads.py``) and their rate, the wall and the
twin's copy and compute ms. Its capacity run comes first in the
script, right after the build, while the allocator holds nothing else:
brick3d n=80, all slow, under an allocator cap whose headroom is below half
of A's bytes, where placing A on the card must raise ``OutOfMemoryError``
and the all-slow call must equal the uncapped all-fast call, through the
ring and read in place (one launch a strip, the live peak one strip's
workspace, the reserved bytes under the cap). The spilled
Galerkin runs (hash and ESC with the main path's, then ``scan``, ``loop``
and ``bsr`` at n=48 and ``pallas`` at n=32 in the placement phase) stream
T from pinned memory through the same ring and hold the same gates; each
is run again with A, P and R in pinned host memory (hash and ESC at both
plans, HostPin and DP; the others HostPin), its C equal bit for bit to the
all-fast pipeline call's and each hop's ring bytes equal to its slow
operands' events, and under the capacity run's cap brick3d n=80's R (A P)
runs with A, P, R, C and the spilled T all in pinned memory, through the
ring and read in place (C bit for bit the ring's); the spilled hash
product at n=48 is read in place too (``pipeline_spgemm(...,
slow_reads="in_place")``, a spilled T written and read in place).
Then the batched entry point and the SpGEMM service: the ESC, hash,
dense-slab and BSR x BSR kernels on width-8 stacks (brick3d n=16 A x P, one
structure with per-instance values; L x L of eight RMAT scale-12 graphs,
eight structures under their union envelope; the dense slab on the first
only) against their plain versions, each call's launches and ms beside its
width-1 call's; ``chunked_spgemm_batched`` through every batched backend
and ``auto`` on both batches, each C held to scipy and to the unbatched
``chunked_spgemm``, then again with the operands in pinned host memory
(HostPin, and DP under hash on brick3d n=16: each C equal bit for bit to
the all-fast batched call's, one launch a step for the whole batch; the
hash HostPin call on brick3d n=16 again read in place, one launch a strip);
and ``SpGEMMService`` serving 96 requests of three
families in a cold and a warm wave (every response held to scipy, the warm
wave compiling nothing, the buckets within the retrace budget), beside a
naive ``chunked_spgemm`` loop over the first 16 of them, then the same with every operand in pinned
host memory (each response equal bit for bit to the all-fast service's),
through the ring and read in place (``slow_reads="in_place"``, no ring op),
then 24 requests over 8 distinct RMAT graphs.
Then the port's examples (``examples/torch_*.py``) at their default sizes,
their correctness lines checked, and the static auditor
(``repro_torch.analysis.audit_all`` on the fast corpus, on the card, with
the static shared memory of the build log and the probe-bound pass over
every hash launch, and ``audit_pipeline`` of
brick3d n=16's Galerkin product under every audited backend, both hops
staged, hop 2 Chunk2 and chunk1 with several chunks), which must be clean.
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
its launches all on the fma routes (the grouped GEMM's counted by tiling:
tile at prefill, rows-few at decode) and its logits held to the plain
path's, the kernel path's prefill and decode steps timed in a second run.
The f32 rows of both kernels (the prefill kernel also at that model's
shape) are timed by the profiler and by back-to-back CUDA events; a phase
timed by the profiler records what its incomplete traces held. A port
kernel's trace is complete when each of its kernels holds its own count
of launches, a library call's when it holds the call's full count of
device activities (the most any of its traces held); only complete traces
are timed, and the library's kept traces are recorded beside its time.
Then the fifth path, training, which runs no hand-written kernel (the
reference's training forward reaches no Pallas kernel): each of the four LM
kernel wrappers must refuse an input that requires grad under grad mode;
one ``make_train_step`` step of the llama and OLMoE SMOKE configs (f32,
two microbatches; llama again with int8 compression) on the card against
the CPU from the same weights and batch, gradients before the update and
the step's moments and parameters held at stated tolerances; resume of
the training example's config bit for bit (4 steps straight against 2, a
checkpoint, a fresh model and optimizer state, 2 more, under deterministic
algorithms); then ``train_loop`` of Llama-3.2-1B at full width and depth
(f32 masters, bf16 compute, full remat, 8 x 1,024 synthetic tokens, 8
steps) and of OLMoE-1B-7B at full width cut to 2 layers (3 steps), each
step's loss, grad norm, lr and ms printed with tokens/s, the model-FLOP
share and the peak allocation, every loss finite, the last below the
first by a stated margin, and no kernel launched.
Then the sixth path, the SSM and hybrid families at full width and depth:
the prefill and decode kernels at Zamba2-1.2B's serve shapes, in f32 (the
reference's Mamba-2 block returns f32, so the hybrid's stream and its
shared attention are f32 after its first layer), held to their plain
versions and timed beside SDPA; ``serve_batch`` of Zamba2-1.2B (6 prefill
and 186 decode launches, one a site of its shared block), teacher-forced
against the plain path at the f32 gate, and of RWKV6-3B (no kernel
launched, so no plain path); each model's decode path against its
training forward on 2 prompts of 1,024 tokens (RWKV6-3B's bf16 drift at
full depth reported; its bf16 model gated at 8 of 32 layers, its f32
model at full depth). Inside the
training phase: ``train_card_vs_cpu`` of the rwkv6 and zamba2 SMOKE
configs, ``train_loop`` of Zamba2-1.2B and RWKV6-3B at full width and
depth (3 steps each), and the Llama run again with ``precast_params``,
``cast_free_attention`` and both (4 steps each, the last traced), beside
the lever-off run.
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
# timed calls of the SpGEMM kernels' plain versions (65-740 ms a call) after
# a warm-up call: one (three to five before the training phases' cuts)
PLAIN_REPS = 1
# timed calls (CUDA events, launch timers, profiler traces) whose median a
# kernel's ms is, after a warm-up call: three (five before the training
# phases' cuts)
TIMED_REPS = 3

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
ROUTED = ("flash_prefill", "grouped_matmul", "sparse_accum_spgemm")
SASS_OPS = {"flash_prefill": ("HMMA",), "grouped_matmul": ("HGMMA", "HMMA")}
TRACE_NAMES = {"flash_prefill": ("flash_prefill_kernel", "flash_prefill_tc_kernel"),
               "decode_attention": ("decode_split_kernel", "decode_combine_kernel"),
               "grouped_matmul": ("gmm_tile_kernel", "gmm_small_kernel",
                                  "grouped_matmul_kernel", "grouped_matmul_rows_kernel"),
               "bsr_spgemm": ("bsr_spgemm",),
               # both BSR x dense kernels (group and generic); not a
               # substring of the BSR x BSR kernel's name
               "bsr_spmm": ("bsr_spmm",),
               "hash_masked_accum_spgemm": ("masked_part_kernel", "masked_seed_kernel",
                                            "masked_gather_kernel"),
               # the CSR-output skeleton's three kernels (ESC and hash merges)
               # and the ESC merge's class kernels
               "csr_accum": ("accum_rows_kernel", "scan_rows_kernel", "copy_rows_kernel",
                             "esc_warp_kernel", "esc_block_kernel", "esc_global_kernel")}
# the routes of a routed kernel that have kernels-line rows (all of them
# where a kernel is not named): the ESC merge's shared route (row 2) and its
# classed call (row 2b, filed under the global class it needs)
ROW_ROUTES = {"sparse_accum_spgemm": ("shared", "global")}
# the ESC class-edge rows: a row's step holds W or W + 1 keys at each class
# cut W, at the first chunk or at the second with an accumulator, beside
# C_prev entries; and global steps of GLOBAL_EDGE_KEYS keys (more than two
# tiles of slots, so more than one pass over global memory), over 2^20
# columns: 32-bit keys in the block2048 class, 64-bit ones in the
# block16384 and global classes
CLASS_EDGE_SEED, GLOBAL_EDGE_KEYS, CLASS_EDGE_COLS = 116, 40_000, 1 << 20
TRACE_TRIES = 3   # traces of one call taken until one holds every expected launch
# sources whose kernels must build without register spills: those whose
# register tiles or sorts were sized to fit (the dense slab's 8 x 8 FMA tile,
# the decode kernel's row tiles, the BSR warp's output tile, the BSR x dense
# group kernel's bs x 4 tile a lane, the ESC merge's register sort), and the
# two hash sources
NO_SPILL = ("ranged_spgemm", "chunked_attention", "bsr_spgemm", "bsr_spmm",
            "sparse_accum_spgemm", "hash_accum_spgemm", "hash_masked_accum_spgemm")
# and the kernels of the other sources held to no spills: the f32 FMA
# routes' register tiles (names as in the mangled entry)
NO_SPILL_KERNELS = {"grouped_matmul": ("grouped_matmul_kernel", "grouped_matmul_rows_kernel"),
                    "flash_prefill": ("flash_prefill_kernel",)}
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
SPMM_PATH = "group"   # the BSR x dense kernel's path at the bsr_spmm run's shape
SPMM_EDGE_SEED = 21
# pipeline fast limits, as fractions of size(A) + size(P) + size(R): at the
# whole size the intermediate stays resident between chunked hops; at half it
# spills (the planner's choice at every brick3d size tried)
PIPE_RESIDENT, PIPE_SPILL = 1.0, 0.5
# the Galerkin runs with operands in slow memory, under hash and ESC at both
# plans, each in the two placements of PIPELINE_TABLE3 that put operands slow
PIPE_PLACEMENTS = ("HostPin", "DP")
# the batched entry point with its operands in slow memory: HostPin under
# every batched backend, and DP (A slow, B on the card: the batched ring at
# width 8 beside a fast operand) under hash on brick3d16 only; DP under the
# others was cut to pay for the in-place phase (it streams the same slow A
# strips through the same rings)
BATCHED_PLACEMENTS = ("HostPin",)
BATCHED_PLACED_DP = {("brick3d16", "hash")}
# the batched placed calls left out, (batch, backend): auto on the RMAT batch
# resolves to hash, whose placed run it would repeat
BATCHED_PLACED_SKIP = {("rmat12", "auto")}
# audit_pipeline's Galerkin product: its staged cores run on the CPU's plain
# versions, where brick3d n=48's hash hop takes minutes. At n=16 the resident
# plan's hop 2 is Chunk2 4 x 3 (n_b > 1, as n=48's 4 x 4) and the spill plan's
# is chunk1 1 x 3 (n=48's: 1 x 4)
PIPE_AUDIT_N = 16
# the placement phase: operands in slow (pinned host) memory through the copy
# ring. brick3d n=48 under the quickstart plan (chunk2 6 x 1) in all six of
# Table 3's placements (hash), HostPin and DP (ESC, scan, bsr) and HostPin
# (loop), the budget/3 plan (chunk1 15 x 4) in HostPin and DP (hash) and
# HostPin (bsr: a strip's pairs summed on the card across 4 chunks),
# brick3d48_knl_hash's plan in HostPin; then the capacity run: brick3d n=80, all slow, hash, at budget/12
# (chunk1 60 x 15) under an allocator cap of what is reserved plus the
# ring's byte model plus 25% plus one 20 MiB segment
PLACED_RUNS = (("quickstart", "hash", ("HBM", "A_Pin", "B_Pin", "C_Pin", "HostPin", "DP")),
               ("chunk1", "hash", ("HostPin", "DP")),
               ("quickstart", "sparse", ("HostPin", "DP")),
               ("knl", "hash", ("HostPin",)),
               ("quickstart", "scan", ("HostPin", "DP")),
               ("quickstart", "loop", ("HostPin",)),
               ("quickstart", "bsr", ("HostPin", "DP")),
               ("chunk1", "bsr", ("HostPin",)))
# slow operands read in place by the streaming kernels (slow_reads="in_place"),
# beside the ring twins of PLACED_RUNS: (plan, backend) -> placements; then
# the ESC kernel's counted classes on L x L of rmat(12, 16, seed 100) and the
# dense slab on brick3d n=16 (at n=32 A's dense strips, about 10 GB, would
# cross the link once a 128-column tile of C: minutes), and the fused
# triangle count with L slow
IN_PLACE_RUNS = {("quickstart", "hash"): ("A_Pin", "B_Pin", "C_Pin", "HostPin", "DP"),
                 ("quickstart", "sparse"): ("HostPin",),
                 ("chunk1", "hash"): ("HostPin",)}
IN_PLACE_DENSE_N, IN_PLACE_DENSE = 16, ("HostPin", "DP")
# the other entry points read in place, each beside its ring twin: the
# spilled Galerkin product (backend, placement, plan) and the batched call
# (batch, backend), both all slow; the placed service runs again with
# slow_reads="in_place"
GALERKIN_IN_PLACE = ("hash", "HostPin", "spill")
BATCHED_IN_PLACE = ("brick3d16", "hash")
# the placed services (through the ring and in place) serve the first 33 of
# the all-fast service's 96 requests (11 a family): the 96 took 14.8 s in
# place and 17.8 s through the ring
IN_PLACE_SERVICE_PER_FAMILY = 11
# the dense slab's load path read in place: its 16-byte cp.async of B from a
# mapped host address (the staging at n=16 is 16-byte aligned)
IN_PLACE_DENSE_PATH = "vec"
# the small problem on which each streaming wrapper, handed pinned stacks and
# the card, is held to the same kernel on card stacks and to its plain version
IN_PLACE_CHECK_N = 8
# the dense slab with slow operands: brick3d n=32 under the brick3d32_pallas
# plan (chunk2 6 x 1), both calls on one set of pinned operands
PLACED_DENSE_N, PLACED_DENSE = 32, ("HostPin", "DP")
# triangle counting with L slow: (label, the chunk2 plan, placement)
PLACED_TRIANGLES = (("tc_rmat18_fused_HostPin", False, "HostPin"),
                    ("tc_rmat18_chunk2_DP", True, "DP"))
# the spilled Galerkin product under the scan, loop, bsr and pallas backends
# (brick3d n, by backend: the dense slabs of n=48 would need about 50 GB)
SPILL_BACKENDS = (("scan", 48), ("loop", 48), ("bsr", 48), ("pallas", 32))
CAPACITY_N, CAPACITY_DIV, CAPACITY_PLAN = 80, 12, ("chunk1", 60, 15)
# the capacity Galerkin run's fast limit, budget / CAPACITY_GALERKIN_DIV: a
# Chunk2 hop 2 keeps C's whole block (13 MB) on the card, and at budget/12
# its 2.8 MB T chunks take a 20 MiB allocator segment beside it (36 MiB, past
# the cap); at budget/40 every staged piece is under the allocator's 1 MiB
# small-block size and the hop lives in 2 MiB pages
CAPACITY_GALERKIN_DIV = 40
CAP_MARGIN, CAP_SEGMENT = 1.25, 20 << 20
PEAK_MARGIN = 1.10          # a placed call's peak allocation over the ring's byte model
# a placed call's peak of live tensor bytes (the allocator's trace) over the
# model: the allocation's peak counts whole allocator blocks, which can pass
# a request by up to 1 MB
LIVE_MARGIN = 1.01
LINK_YARDSTICK_BYTES = 256 << 20
# the batched entry point: width-8 batches, (a) brick3d n=16 with values from
# numpy seeds BATCH_SEED + instance, (b) L x L of eight RMAT graphs of scale 12
BATCH_WIDTH, BATCH_SEED = 8, 300
BATCH_RMAT_SCALE, BATCH_RMAT_SEEDS = 12, range(100, 108)
BATCHED_BACKENDS = ("scan", "pallas", "sparse", "hash", "bsr", "auto")
# the SpGEMM service: three families of 32 requests (values from numpy seeds
# SERVICE_SEED + request), F = the largest L's row bytes / SERVICE_CHUNK_DIV;
# the gated run serves L x L of four RMAT graphs in turn, the churn run the
# 8 graphs of seeds 200-207, one request each, 8 a family (cut from 32
# graphs and 32 a family to pay for the placed runs, the pipeline audit and
# the in-place service: with the two other families still more than the
# retrace budget's 8 buckets)
SERVICE = {"backend": "auto", "max_batch": 8, "quantum": 32, "retrace_budget": 8,
           "eviction_hysteresis": 4, "slo_s": 0.002}
SERVICE_PER_FAMILY, SERVICE_SEED, SERVICE_CHUNK_DIV = 32, 400, 5
CHURN_PER_FAMILY = 8
HASH_PLAIN_MAX = 1 << 28   # product entries the hash plain version may table at once
SERVICE_RMAT_SEEDS, CHURN_RMAT_SEEDS = range(200, 204), range(200, 208)

# the fifth path, training: the reference's training forward reaches no
# pl.pallas_call, so the port's runs no hand-written kernel (its wrappers
# refuse autograd). Llama-3.2-1B at full width and depth, f32 masters, bf16
# compute, remat "full"; SyntheticLM batches of 8 x 1,024 from seed 0,
# weights from LM_WEIGHT_SEED, TrainConfig(3e-4, warmup 1, total = steps);
# OLMoE-1B-7B at full width, cut to 2 of its 16 layers so that it fits the
# time. (label, arch, layers or None for all, steps)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_DATA_SEED, TRAIN_LR = 8, 1024, 0, 3e-4
TRAIN_RUNS = (("train_llama3_2_1b", LM_ARCH, None, 8),
              ("train_olmoe_1b_7b_l2", MOE_ARCH, 2, 3))
# the gate, stated before the first run: the last step's loss below the
# first step's by this much (nats)
TRAIN_LOSS_DROP = {"train_llama3_2_1b": 0.5, "train_olmoe_1b_7b_l2": 0.1}
TRAIN_TIMED_FROM = 2   # steps timed for the median: the first two carry warm-up
TRAIN_TRACED = "train_llama3_2_1b"   # its last step runs under the profiler (not timed)
# card against CPU: one make_train_step step of the llama and OLMoE SMOKE
# configs in f32 (microbatches 2; llama once more with int8) from the same
# weights and batch. Every gradient before the update within
# TRAIN_GRAD_ATOL (the CPU tests' tolerance of each parameter's gradient
# against the reference: f32 sums in another order), the loss within
# TRAIN_LOSS_ATOL, grad_norm within rtol TRAIN_NORM_RTOL, mu and nu within
# TRAIN_MU_ATOL and TRAIN_NU_ATOL. Parameters: at step 1 AdamW moves one by
# lr * g / (|g| + eps), eps 1e-8, so a gradient within ~1e-6 of zero can
# swing it by up to 2 lr on a difference of summation order: every
# parameter within 2 lr + TRAIN_PARAM_ATOL of the CPU's, and every one
# further than TRAIN_PARAM_ATOL has a CPU gradient within TRAIN_HAZARD_GRAD
# of zero. Under int8 a gradient can cross a rounding boundary of its code
# (one quantum), wherever it lies: there the parameters, mu, nu and the
# residual are held at TRAIN_SHARE of all their entries.
TRAIN_CMP_BATCH, TRAIN_CMP_SEQ, TRAIN_CMP_LR = 4, 64, 1e-3
TRAIN_CMP_RUNS = (("llama3_2_1b", "none"), ("olmoe_1b_7b", "none"), ("llama3_2_1b", "int8"))
TRAIN_GRAD_ATOL, TRAIN_LOSS_ATOL, TRAIN_NORM_RTOL = 1e-5, 1e-5, 1e-5
TRAIN_MU_ATOL, TRAIN_NU_ATOL, TRAIN_PARAM_ATOL, TRAIN_SHARE = 1e-6, 1e-8, 1e-6, 0.99
TRAIN_HAZARD_GRAD = 1e-5
# resume: the example's config (examples/torch_train_lm.py: d 512, 8
# layers, vocab 32,768), seq 256, batch 8, microbatches 2; 4 steps straight
# against 2, a checkpoint, a fresh model and state, 2 more, under
# torch.use_deterministic_algorithms(True): losses and the step-4
# checkpoints equal bit for bit
TRAIN_RESUME_STEPS, TRAIN_RESUME_SPLIT = 4, 2

# the sixth path, the SSM and hybrid families at full width and depth,
# random weights from LM_WEIGHT_SEED, the Llama run's prompts (ids below
# each vocabulary): Zamba2-1.2B (38 Mamba-2 layers; its shared attention
# block after layers 5, 11, ..., 35, one KV slab a site) and RWKV6-3B (no
# attention). The reference's Mamba-2 block returns f32, so Zamba2's
# residual stream, its products and its shared attention run in f32 after
# its first layer: its attention kernels take f32 (the prefill's fma
# route), and those launches' phases are rows 8d and 9c
ZAMBA_ARCH, RWKV_ARCH = "zamba2_1p2b", "rwkv6_3b"
ZAMBA_PREFILL_LABEL, ZAMBA_DECODE_LABEL = "serve_prefill_zamba2", "serve_decode_mid_zamba2"
# decode matches forward, on the card at full width: DMF_BATCH prompts of
# DMF_LEN ids from LM_PROMPT_SEED; the prefill of the first DMF_LEN -
# DMF_STEPS tokens, then DMF_STEPS decode steps fed the prompt's own
# tokens, each step's logits against the training forward's (plain, no
# kernel) at its position, and the prefill of all DMF_LEN tokens (the
# chunked SSM forms) against the last decode step and the forward's last.
# Relative to the forward's logit std: Zamba2's bf16 model at the bf16
# serve gate's tolerances (its first layer and its decode-time Mamba-2
# scans round in bf16). RWKV6-3B in bf16 drifts from the forward by up to
# 1.27-1.45 of the logit std over 4 steps at its 32 layers (reported, not
# gated): random weights at full width amplify bf16 rounding flips with
# depth, and the reference's own decode path drifts as far on the CPU. So
# its bf16 gate runs the first RWKV_DMF_LAYERS layers at full width, where
# the CPU read up to 0.27 (worst) in both packages: within RWKV_DMF_TOL,
# stated before its first card run (the worst at 1.85 times the CPU's, the
# mean at the full depth's mean-to-worst share, 0.16, of that); and its
# f32 model at full depth (the same seed) at the f32 serve gate's, where
# both packages agree within 9e-5 at 8 layers
DMF_BATCH, DMF_LEN, DMF_STEPS = 2, 1024, 4
RWKV_DMF_LAYERS, RWKV_DMF_TOL = 8, (0.5, 0.08)
# training runs of both families at full width: f32 masters, bf16 compute,
# remat "full", the Llama run's batches, 3 steps, (label, arch, layers, steps,
# lr); RWKV6-3B at its full depth (32 layers: masters, gradients and moments
# 49.5 GB, peak 62.1 GB). Zamba2's gate: the last loss below the first by
# TRAIN_LOSS_DROP, at lr 1e-4 (at 3e-4 its first Adam step spikes the loss,
# 10.68 -> 14.71, and three steps end at 11.08).
# RWKV6-3B's loss is reported, not gated: at the reference's random init its
# gradient norm is 8e8 (it grows about 6x every 4 layers, in both packages),
# and three clipped Adam steps leave the loss flat (11.575 -> 11.577)
TRAIN_SSM_RUNS = (("train_zamba2_1p2b", ZAMBA_ARCH, None, 3, 1e-4),
                  ("train_rwkv6_3b", RWKV_ARCH, None, 3, TRAIN_LR))
TRAIN_LOSS_DROP.update({"train_zamba2_1p2b": 0.1})
TRAIN_CMP_RUNS += (("rwkv6_3b", "none"), ("zamba2_1p2b", "none"))
# nu of the ssm row (RWKV-6): its gradients differ by up to 6.2e-6 between
# card and CPU (f32 sums in another order through the chunked time mix),
# and nu = (1 - beta2) g^2 differs by up to (1 - beta2)(2 max|g| a + a^2)
# where the gradients differ by a = TRAIN_GRAD_ATOL: its nu bound is that
# (it read 1.07e-8 and 8.3e-9 on the card); every other row keeps
# TRAIN_NU_ATOL
TRAIN_NU_FROM_GRAD = {"ssm"}
# the single-card levers on the Llama run: precast_params, cast_free_attention
# and both, TRAIN_LEVER_STEPS steps each (the last traced), beside the
# lever-off run of the same call. Gate: finite losses and grad norms, step
# 0's loss within TRAIN_LEVER_LOSS_ATOL of the lever-off run's (bf16: the
# levers round the norm scales, which are 1 at init, and P to bf16), no
# kernel launched
TRAIN_LEVER_RUNS = (("train_llama3_2_1b_precast", {"precast_params": True}),
                    ("train_llama3_2_1b_cast_free", {"cast_free_attention": True}),
                    ("train_llama3_2_1b_both", {"precast_params": True,
                                                "cast_free_attention": True}))
TRAIN_LEVER_STEPS, TRAIN_LEVER_LOSS_ATOL = 4, 0.05
# weights that enter no product (gathered, or elementwise), left out of the
# model-FLOP count by their last name
NOT_IN_PRODUCTS = ("scale", "mix_mu", "w0", "u", "ln_x", "cm_mu_k", "cm_mu_r", "conv_w",
                   "conv_b", "A_log", "dt_bias", "D", "norm_scale")


_STARTED = time.perf_counter()


def emit(obj) -> None:
    """One JSON line, with ``t_s``, the script's seconds so far (the gaps
    between lines say where the wall goes), on every line but the kernels
    line and the last, which keep the contract's keys."""
    if not {"kernels", "ok"} & obj.keys():
        obj = {**obj, "t_s": round(time.perf_counter() - _STARTED, 3)}
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(torch, fn, reps: int = TIMED_REPS, warmup: int = 1) -> float:
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


def queued_ms(torch, fn, reps: int = 5) -> float:
    """Milliseconds a call by CUDA events around ``reps`` calls issued back
    to back after a warm-up call: the device's time of a call whose kernels
    outlast the host's issue of the next, without the profiler (which loses
    the traces of some calls)."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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


def train_trace(by_name: dict, wall_ms: float, top: int = 12) -> dict:
    """A traced training step's device time: busy ms and share of the
    step's wall, ms by kernel class (cuBLAS and CUTLASS products, named
    ``nvjet``, ``gemm``, ``xmma`` or ``cutlass``; PyTorch's elementwise,
    reduction, softmax and indexing kernels; copies and fills; the rest),
    the ``top`` kernels."""
    kinds = (("gemm", ("nvjet", "gemm", "xmma", "cutlass")), ("elementwise", ("elementwise",)),
             ("reduce", ("reduce",)), ("softmax", ("softmax",)),
             ("index", ("index", "scatter", "gather")), ("copy_fill", ("memcpy", "memset")))
    classes = collections.Counter()
    for name, (ms, _) in by_name.items():
        low = name.lower()
        classes[next((k for k, keys in kinds if any(w in low for w in keys)), "other")] += ms
    busy = sum(classes.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"step_wall_ms": wall_ms, "device_busy_ms": busy,
            "device_busy_share": busy / wall_ms if wall_ms else None,
            "by_class_ms": dict(classes),
            "top": [{"name": n[:120], "ms": ms, "count": c} for n, (ms, c) in ranked]}


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


def err_key(kernel: str, route: str, dtype, tiling: str | None = None) -> str:
    """The ``max_err`` key of one route of a routed kernel in one operand
    dtype (a torch dtype or its name; "f32" and "bf16" as "float32" and
    "bfloat16"), and for the grouped GEMM's fma route one tiling:
    "kernel/route/dtype[/tiling]"."""
    name = str(dtype).removeprefix("torch.")
    name = {"f32": "float32", "bf16": "bfloat16"}.get(name, name)
    return "/".join([kernel, route, name] + ([tiling] if tiling else []))


def library_fields(library, bound_ms: float) -> dict:
    """A phase's library yardstick (wall ms, device ms, the traces behind
    the device ms, error text) for the kernels line. The device ms comes
    from the traces that held the call's full kernel count
    (:func:`device_ms`); where none did it is recorded as lost. A time under
    the phase's bound comes from a partial measurement (no complete run of
    the same work can take less), so it is recorded as lost, with the
    reason, too."""
    wall, device, traces, error = library
    lost = {}
    if wall is not None and device is None and traces:
        lost["device"] = (f"none of {traces['traces']} profiler traces held a "
                          "device activity")
    for key, value in (("wall", wall), ("device", device)):
        if value is not None and value < bound_ms:
            lost[key] = (f"{value} ms is under the {bound_ms} ms bound: the measurement "
                         "saw only part of the work")
    return {"library_ms": None if "wall" in lost else wall,
            "library_device_ms": None if "device" in lost else device,
            "library_device_traces": traces,
            "library_lost": lost or None, "library_error": error}


def device_ms(torch, fn, reps: int = TIMED_REPS) -> tuple:
    """Median device milliseconds of one call of a PyTorch function, one
    profiler trace per call, after a warm-up call, over the complete traces
    only. The profiler loses whole calls and parts of calls, and a part
    never holds more activities than the whole, so a trace is complete when
    it holds the call's full count of device activities: the most that any
    of the ``reps`` traces held. Returns the median (None when every trace
    was empty) and ``{"kept": complete traces, "traces": reps, "activities":
    the full count}``."""
    fn()
    torch.cuda.synchronize()
    traces = [device_by_name(profiled(torch, fn)) for _ in range(reps)]
    counts = [sum(n for _, n in t.values()) for t in traces]
    full = max(counts)
    kept = [sum(ms for ms, _ in t.values())
            for t, n in zip(traces, counts) if full and n == full]
    return ((statistics.median(kept) if kept else None),
            {"kept": len(kept), "traces": reps, "activities": full})


def trace_summary(by_name: dict, names) -> dict:
    """What one profiler trace held: its device activities and their summed
    ms, the activities whose name holds one of ``names`` (full name ->
    count), and the three names with the most device ms (name -> [ms,
    count])."""
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:3]
    return {"activities": sum(n for _, n in by_name.values()),
            "busy_ms": sum(ms for ms, _ in by_name.values()),
            "matched": {name: n for name, (_, n) in by_name.items()
                        if any(k in name for k in names)},
            "top": {name: [ms, n] for name, (ms, n) in top}}


def kernel_device_split(torch, fn, names, launches, reps: int = TIMED_REPS,
                        tries: int = 20) -> tuple:
    """Median device milliseconds of the port kernels (activities whose
    name holds one of ``names``) that one call of ``fn`` launches, over
    ``reps`` profiler traces that hold all ``launches`` of them, after a
    warm-up call; the profiler loses activities of some calls, so up to
    ``tries`` calls are traced. ``launches`` is each name's own count a call
    (a dict: a trace is complete only when every name holds its count), or,
    where a call's split by name is not known before it runs, their total
    (an int). Returns the median (None when no trace was complete), the
    number of incomplete traces, per name the median of its share over the
    complete traces, and ``trace_summary`` of every incomplete trace (what
    it held instead)."""
    fn()
    torch.cuda.synchronize()
    times, split, incomplete, held = [], {n: [] for n in names}, 0, []
    while len(times) < reps and len(times) + incomplete < tries:
        by_name = device_by_name(profiled(torch, fn))
        hits = {n: [v for name, v in by_name.items() if n in name] for n in names}
        counts = {n: sum(c for _, c in vs) for n, vs in hits.items()}
        complete = (all(counts[n] == launches.get(n, 0) for n in names)
                    if isinstance(launches, dict) else sum(counts.values()) == launches)
        if complete:
            times.append(sum(ms for vs in hits.values() for ms, _ in vs))
            for n, vs in hits.items():
                split[n].append(sum(ms for ms, _ in vs))
        else:
            incomplete += 1
            held.append(trace_summary(by_name, names))
    return ((statistics.median(times) if times else None), incomplete,
            {n: statistics.median(v) for n, v in split.items() if v}, held)


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


def launch_ms(torch, timer_cls, fn, reps: int = TIMED_REPS) -> float:
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


def class_edge_rows(cuts, global_keys: int, seed: int, n_cols: int | None = None):
    """COO triples of A (rows x k), B (k x n_cols) and C_prev whose ESC merge
    steps land on each class cut W of ``cuts``: per W a row whose first step
    holds W keys and one of W + 1 (one A entry each, on a B row of that many
    distinct columns), a row whose second step holds W and one W + 1 (an
    entry in each chunk, on B rows of disjoint columns, the second step
    adding the first's accumulator), and a row whose first step adds C_prev
    entries to its products; then two global rows of ``global_keys`` keys
    (one at the first chunk, one at the second) and a few small rows and
    empty ones. Each A entry has its own B row: rows < k0 are chunk 0's,
    and a row's B rows and C_prev entries have disjoint columns of
    ``n_cols`` (at least enough for them). Returns the COO triples of A, B
    and C_prev, the shape ``(n_rows, k, k0, n_cols)`` and each output row's
    entries."""
    rng = np.random.default_rng(seed)
    n_cols = max(n_cols or 0, 2 * global_keys + 4 * max(cuts) + 64)
    spec = []   # per A row: (keys from chunk 0's B row, from chunk 1's, C_prev entries)
    for w in cuts:
        spec += [(w, 0, 0), (w + 1, 0, 0), (w // 2, w - w // 2, 0),
                 (w // 2, w + 1 - w // 2, 0), (w - w // 4, 0, w // 4)]
    spec += [(global_keys, 0, 0), (global_keys // 2, global_keys - global_keys // 2, 0),
             (5, 3, 2), (0, 7, 0), (0, 0, 0), (1, 0, 0), (0, 0, 3)]
    rng.shuffle(spec)
    firsts = [(i, n0) for i, (n0, _, _) in enumerate(spec) if n0]
    seconds = [(i, n1) for i, (_, n1, _) in enumerate(spec) if n1]
    k0 = len(firsts)
    a_rows, a_cols, b_rows, b_cols, c_rows, c_cols = [], [], [], [], [], []
    cols_of = {}
    for t, (i, n) in enumerate(firsts + seconds):
        # columns disjoint from the row's other B row and C_prev entries
        taken = cols_of.setdefault(i, set())
        pool = np.setdiff1d(rng.choice(n_cols, n + len(taken) + 8, replace=False),
                            list(taken))[:n]
        taken.update(int(c) for c in pool)
        a_rows.append(i)
        a_cols.append(t)
        b_rows += [t] * n
        b_cols += sorted(int(c) for c in pool)
    for i, (_, _, nc) in enumerate(spec):
        if nc:
            taken = cols_of.setdefault(i, set())
            pool = np.setdiff1d(rng.choice(n_cols, nc + len(taken) + 8, replace=False),
                                list(taken))[:nc]
            c_rows += [i] * nc
            c_cols += sorted(int(c) for c in pool)
    def coo(r, c):
        return (np.asarray(r, np.int64), np.asarray(c, np.int64),
                rng.standard_normal(len(r)).astype(np.float32))
    return (coo(a_rows, a_cols), coo(b_rows, b_cols), coo(c_rows, c_cols),
            (len(spec), len(firsts) + len(seconds), k0, n_cols), [sum(v) for v in spec])


def host_meminfo() -> dict:
    """The host's ``/proc/meminfo`` in bytes (read only)."""
    out = {}
    for line in Path("/proc/meminfo").read_text().splitlines():
        key, _, value = line.partition(":")
        parts = value.split()
        if parts and parts[0].isdigit():
            out[key] = int(parts[0]) * (1024 if parts[1:] == ["kB"] else 1)
    return out


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def live_bytes(st) -> int:
    """Bytes of a stacked CSR that a kernel must read: every indptr, and the
    entries each element's indptr bounds (not the padded tails)."""
    nnz = int(st.indptr[..., -1].sum())
    return nbytes(st.indptr) + nnz * (st.indices.element_size() + st.data.element_size())


def trace_length(snapshot) -> int:
    """Entries in an allocator snapshot's trace of device 0."""
    return len(snapshot["device_traces"][0])


def live_peak(snapshot, start: int) -> int:
    """The most bytes the tensors allocated after the first ``start`` entries
    of the allocator's trace (device 0) held at once: its ``alloc`` and
    ``free_completed`` entries replayed in order (their sizes are the bytes
    requested)."""
    live, total, peak = {}, 0, 0
    for entry in snapshot["device_traces"][0][start:]:
        if entry["action"] == "alloc":
            live[entry["addr"]] = entry["size"]
            total += entry["size"]
            peak = max(peak, total)
        elif entry["action"] == "free_completed" and entry["addr"] in live:
            total -= live.pop(entry["addr"])
    return peak


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        from repro_torch.core import chunking, kkmem, memory_model, planner, symbolic
        from repro_torch.analysis import dma
        from repro_torch.core import chunk_stream, copy_ring, pipeline_spgemm, placement, triangle
        from repro_torch.kernels import (
            _build, bsr_spgemm, bsr_spmm, chunked_attention, flash_prefill, grouped_matmul,
            hash_accum_spgemm, link_reads, ops, ranged_spgemm, sparse_accum_spgemm,
        )
        from repro_torch.data import pipeline as data_pipeline
        from repro_torch.launch import serve
        from repro_torch.launch import train as train_launch
        from repro_torch.models import moe, transformer
        from repro_torch.train import optim as train_optim
        from repro_torch.train import step as train_step
        from repro_torch.serve import spgemm_service
        from repro_torch.sparse import bsr, csr, graphs, multigrid

        self.m = dict(chunking=chunking, kkmem=kkmem, memory_model=memory_model,
                      planner=planner, symbolic=symbolic, chunk_stream=chunk_stream,
                      build=_build, csr=csr, multigrid=multigrid, graphs=graphs,
                      bsr=bsr, triangle=triangle, pipeline=pipeline_spgemm, ops=ops,
                      serve=serve, transformer=transformer, moe=moe,
                      service=spgemm_service, placement=placement, copy_ring=copy_ring,
                      dma=dma, link_reads=link_reads, data=data_pipeline,
                      train=train_launch, optim=train_optim, train_step=train_step)
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
        # the grouped GEMM's fma launches by tiling, as "grouped_matmul/fma/tiling"
        for tiling, counter in grouped_matmul.TILING_LAUNCHES.items():
            self.counters[f"grouped_matmul/fma/{tiling}"] = counter
        # the BSR x dense kernel's launches by path, as "bsr_spmm/path"
        for path, counter in bsr_spmm.PATH_LAUNCHES.items():
            self.counters[f"bsr_spmm/{path}"] = counter
        # the streaming kernels' calls that read an operand in place from
        # pinned host memory, as "kernel/in_place"
        for kernel, counter in (("ranged_spgemm", ranged_spgemm.IN_PLACE),
                                ("sparse_accum_spgemm", sparse_accum_spgemm.IN_PLACE),
                                ("hash_accum_spgemm", hash_accum_spgemm.IN_PLACE),
                                ("hash_masked_accum_spgemm", hash_accum_spgemm.MASKED_IN_PLACE)):
            self.counters[f"{kernel}/in_place"] = counter
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
        # path, its launches there; "kernel@shape": at that shape only);
        # (kernel, route, shape) -> the numbers of that route's kernels-line
        # row at that shape (route None: a non-routed kernel's row at a
        # further served shape, row 9c)
        self.route_runs = {}
        self.route_rows = {}
        # the batched phases: kernel -> its width-8 numbers (the kernels
        # line's "batched" field) and its launches in the batched run of
        # batch (a); each batch's union envelope
        self.batched = {}
        self.batched_launches = {}
        self.batch_envs = {}
        # the ESC kernel's route launches at the last note_err of its errors
        self.esc_routes_noted = {r: 0 for r in sparse_accum_spgemm.ROUTES}
        # (problem, n, plan, backend) -> (C, stats, wall s, peak allocation) of
        # a main-path run: the placement phase's all-fast calls; chunk2 ->
        # (plan, caps, wall s) of the triangle runs
        self.fast_runs = {}
        self.tc_runs = {}
        # the pipeline runs' plans by brick3d size and the plain R (A P); the
        # placed calls' envelope and step workspace by (step kind, plan)
        self._pipe_plans, self._rap_plain, self._probes = {}, {}, {}
        # the plain spgemm and quickstart_inputs of a main-path problem
        self._plain, self._quickstart = {}, {}
        # (n, fraction, backend) -> (C, PipelineStats, wall s) of a pipeline
        # run with every operand on the card: the placed runs' reference
        self._pipe_fast = {}
        # scipy's products by name (scipy_check's key); (batch, backend) ->
        # (Cs, stats, wall s) of the all-fast batched calls; the gated
        # service's responses' C by (wave, request)
        self._scipy_refs, self._batched_fast, self._service_fast = {}, {}, {}
        self._bsr_c_sizes = {}   # plan -> (a strip's summed blocks, its CSR) bytes
        # the in-place route: kernel -> its first in-place call's numbers (the
        # kernels line's "in_place" field) and the small wrapper checks';
        # rmat12_sparse's L, plan and all-fast (C, stats, wall s, launches)
        self.in_place = {}
        self._rmat12 = None
        self._in_place_models = {}   # (plan, backend, operands) -> (workspace, reads)

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
        self.smi = smi
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
        self.esc_routes_noted = dict.fromkeys(self.esc_routes_noted, 0)

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
        for name, entries in resources.items():
            for entry, res in entries.items():
                if name in NO_SPILL or any(k in entry for k in NO_SPILL_KERNELS.get(name, ())):
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
        """examples/quickstart.py's C row-byte estimate and budget, once a
        problem of :meth:`problem` (its runs share them; other operands,
        the capacity run's, are not held)."""
        key = next((k for k, v in self.problems.items() if v[0] is A and v[1] is P), None)
        if key in self._quickstart:
            return self._quickstart[key]
        planner = self.m["planner"]
        ws = self.m["kkmem"].spgemm_symbolic_host(A, P)
        crb = np.full(A.n_rows, max(ws.c_nnz / A.n_rows, 1) * 12.0)
        budget = (float(planner.row_bytes_csr(A).sum() + planner.row_bytes_csr(P).sum())
                  + float(crb.sum())) / 4
        if key is not None:
            self._quickstart[key] = (crb, budget)
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
        (wall ms, device ms, its traces, error text if torch refuses)."""
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
            if record:
                # the profiler's device time of the call's kernels, and by
                # kernel (the recorded phase only: the others' traces were
                # cut to pay for the training phases)
                (orders[order]["device_ms"], orders[order]["device_incomplete_traces"],
                 orders[order]["device_split_ms"], _) = kernel_device_split(
                    torch, lambda: run(order), TRACE_NAMES["csr_accum"],
                    esc.kernels_per_call(order, plan.n_b))
                orders[order]["plain_ms"] = cuda_ms(torch, lambda: plain(order), reps=PLAIN_REPS)
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
                orders[order]["plain_ms"] = cuda_ms(torch, lambda: plain(order), reps=PLAIN_REPS)
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
        if record and kernel == "sparse_accum_spgemm":   # the shared route's row
            self.route_row(kernel, "shared", label, orders[main_order], moved, flops,
                           flop_rate, library, dtype="float32")
        if record:
            main = orders[main_order]
            self.phase[kernel] = {"ms": main["ms"], "wrapper_ms": main["wrapper_ms"],
                                  **{k: main[k] for k in ("device_ms", "device_split_ms")
                                     if k in main},
                                  "plain_ms": main["plain_ms"], **bound,
                                  "library_ms": lib["library_ms"],
                                  "library_device_ms": lib["library_device_ms"],
                                  "library_device_traces": lib["library_device_traces"],
                                  "library_lost": lib["library_lost"]}
        emit({"kernel_phase": kernel, "label": label, "main_order": main_order,
              "orders": orders, "shapes": shapes, "bytes": moved, "flops": flops, **bound,
              "launches_per_call": launches_per_call, **lib,
              "peaks_of": PEAK["part"],
              "flop_rate": flop_rate, "ops_ms_at_f32": flops / PEAK["f32_flops"] * 1e3})

    def note_err(self, key: str, err: float) -> None:
        """The largest error of a kernel (or of one route, dtype and tiling
        of it, ``err_key``) against its plain version so far. An ESC error
        also counts for each route and class the ESC kernel launched since
        its last note (a classed call counts for each class it launched)."""
        self.max_err[key] = max(self.max_err.get(key, 0.0), err)
        if key == "sparse_accum_spgemm":
            for route, counter in self.kernels[key].ROUTE_LAUNCHES.items():
                if counter.count > self.esc_routes_noted[route]:
                    self.note_err(err_key(key, route, "float32"), err)
                self.esc_routes_noted[route] = counter.count

    def route_row(self, kernel: str, route: str, shape: str, numbers: dict, moved: int,
                  flops: int, flop_rate: str, library, **extra) -> None:
        """File one route's kernels-line numbers at one served shape: its
        ``ms``, ``wrapper_ms`` (``device_ms``, ``queued_ms`` and
        ``fma_tiling`` where measured or chosen) and ``plain_ms``, the
        bound of the function in
        the row's dtype, and the library yardstick in that dtype."""
        bound = bound_of(moved, flops, flop_rate)
        self.route_rows[kernel, route, shape] = {
            "ms": numbers["ms"], "wrapper_ms": numbers["wrapper_ms"],
            **{k: numbers[k] for k in ("device_ms", "queued_ms", "fma_tiling") if k in numbers},
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
            self.note_err(kernel, max(o["max_abs_err"] for o in orders.values()))
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
            outs = {order: mod.hash_accum_spgemm_stream(Ast, Bst, C0, r0s, r1s, order=order,
                                                        table_size=table)
                    for order in ORDERS}
            orders = {order: self.hold_csr(
                f"hash_accum_spgemm/{label}/{order}", outs[order],
                mod.hash_accum_plain(Ast, Bst, C0, r0s, r1s, order=order, table_size=table))
                for order in ORDERS}
            self.note_err("hash_accum_spgemm", max(o["max_abs_err"] for o in orders.values()))
            # the rows by extraction class, from the kernel's output, whose
            # structure was just held equal to the plain version's
            extract = self.extract_rows(outs["chunk1"][0])
            del outs
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
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        C, stats = chunking.chunked_spgemm(A, P, plan, backend=backend, caps=caps)
        torch.cuda.synchronize()
        exec_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - before
        launches = self.read_counters()
        kernel = self.backend_kernel.get(chosen)   # scan runs no kernel of its own
        if kernel is not None:
            check(launches[kernel] > 0, f"{label}: {kernel} was not launched")
            self.launches.setdefault(kernel, launches[kernel])
        self.note_esc_routes(label, launches)

        self.fast_runs[(name, n, plan, chosen)] = (C, stats, exec_s, peak)
        if (name, n) not in self._plain:   # the runs of one problem share it
            ws = kkmem.spgemm_symbolic_host(A, P)
            self._plain[name, n] = kkmem.spgemm(A, P, ws.c_pad)
        plain = self._plain[name, n]
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
        scipy_err = self.scipy_check(A, P, C, key=("ap", name, n))
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
                         "chunked_spgemm": exec_s}, "peak_alloc_bytes": peak,
              "check": {"plain_structure_equal": structure, "plain_max_abs_err": err,
                        "scipy_rel_err": scipy_err}})
        del C, plain
        torch.cuda.empty_cache()

    def note_esc_routes(self, label: str, launches: dict) -> None:
        """The first main-path run that launches each ESC route is the one
        its kernels-line row reports."""
        for route in self.kernels["sparse_accum_spgemm"].ROUTES:
            key = f"sparse_accum_spgemm/{route}"
            if launches[key]:
                self.route_runs.setdefault(key, (label, launches[key]))

    def rmat_plan(self, L):
        """``plan_knl`` of L x L at a third of L's row bytes: the chunks the
        batched RMAT phases use, a one-strip plan."""
        planner = self.m["planner"]
        return planner.plan_knl(L, L, float(planner.row_bytes_csr(L).sum()) / 3)

    def esc_routes_run(self, label: str, run, launch) -> tuple:
        """One call of an ESC runner and the launches of each route it
        made, which must be the classed ``launch``'s own (no shared-route
        launch)."""
        esc = self.kernels["sparse_accum_spgemm"]
        before = {r: c.count for r, c in esc.ROUTE_LAUNCHES.items()}
        got = run()
        routes = {r: c.count - before[r] for r, c in esc.ROUTE_LAUNCHES.items()}
        want = {r: launch.launches.get(r, 0) for r in esc.ROUTES}
        check(routes == want, f"sparse_accum_spgemm/{label}: launches by route {routes}, "
              f"the launch plan's {want}")
        return got, routes

    def esc_class_ms(self, run, launch) -> dict | None:
        """Device ms of a classed ESC call's merge launches summed by class,
        from the first profiler trace that holds all of them (launches in
        the plan's order; None when none does)."""
        esc = self.kernels["sparse_accum_spgemm"]
        order = launch.launch_order
        times = device_launch_list(self.torch, run, tuple(esc.CLASS_KERNELS.values()),
                                   len(order))
        if times is None:
            return None
        out = dict.fromkeys(order, 0.0)
        for name, ms in zip(order, times):
            out[name] += ms
        return out

    def esc_global_phase(self, label: str, L, plan) -> None:
        """The ESC kernel where its steps pass a block's shared memory: L x L
        of an RMAT scale-12 graph (densest row 1,311 entries; the launch-wide
        bound asks for 25 MB of shared memory a row). ``esc_launch_plan``
        counts each step's keys and launches each chunk's steps by class
        (empty steps launch nothing; the largest take the global class).
        Both orders against the plain version, the launches by class
        checked; the classed call's kernels-line row (``ms``, ``device_ms``
        by kernel and by class, ``plain_ms``, the bound of the whole
        product, and ``torch.sparse.mm`` of L x L)."""
        torch, esc = self.torch, self.kernels["sparse_accum_spgemm"]
        Ast, Bst, C0, r0s, r1s, caps = self.stage_csr(L, L, plan)
        row_cap = caps.c_max_row_nnz
        launch = esc.esc_launch_plan(Ast, Bst, C0, r0s, r1s, row_cap=row_cap)
        check(launch.split and launch.routes["global"] > 0,
              f"sparse_accum_spgemm/{label}: no step takes the global class ({launch.routes})")
        run, plain = self.csr_runners("sparse_accum_spgemm", Ast, Bst, C0, r0s, r1s, row_cap)
        orders = {}
        for order in ORDERS:
            got, routes = self.esc_routes_run(f"{label}/{order}", lambda: run(order), launch)
            orders[order] = self.hold_csr(f"sparse_accum_spgemm/{label}/{order}", got,
                                          plain(order))
            orders[order]["launches_by_route"] = routes
            del got
            orders[order]["ms"] = self.launch_ms(lambda: run(order))
            orders[order]["wrapper_ms"] = cuda_ms(torch, lambda: run(order))
            (orders[order]["device_ms"], orders[order]["device_incomplete_traces"],
             orders[order]["device_split_ms"], _) = kernel_device_split(
                torch, lambda: run(order), TRACE_NAMES["csr_accum"],
                esc.kernels_per_call(order, plan.n_b, launch))
            orders[order]["device_class_ms"] = self.esc_class_ms(lambda: run(order), launch)
            orders[order]["plain_ms"] = cuda_ms(torch, lambda: plain(order), reps=PLAIN_REPS)
        self.note_err("sparse_accum_spgemm", max(o["max_abs_err"] for o in orders.values()))
        out = run("chunk1")
        moved = (live_bytes(Ast) + live_bytes(Bst) + live_bytes(C0) + nbytes(*out)
                 + 8 * len(r0s))
        flops = self.m["symbolic"].spgemm_structure_host(L, L).flops
        library = self.library_spgemm(L, L)
        main = orders["chunk1"]
        self.route_row("sparse_accum_spgemm", "global", label, main, moved, flops,
                       "f32_flops", library, dtype="float32",
                       device_split_ms=main["device_split_ms"],
                       device_class_ms=main["device_class_ms"],
                       class_kernels={c.name: c.kernel for c in launch.classes})
        emit({"esc_global_phase": label, "shape": list(L.shape), "nnz_L": L.nnz(),
              "plan": {"algorithm": plan.algorithm, "n_b": plan.n_b},
              "c_max_row_nnz": row_cap, "steps_by_class": launch.routes,
              "launches_by_class": launch.launches, "classes": self.esc_classes(launch),
              "global_workspace_bytes": launch.workspace_bytes,
              "bound_row_smem_bytes": esc.esc_workspace(Ast.max_row_nnz, Bst.max_row_nnz,
                                                        row_cap)[1],
              "kernels_per_call": esc.kernels_per_call("chunk1", plan.n_b, launch),
              "orders": orders, "bytes": moved, "flops": flops,
              **bound_of(moved, flops, "f32_flops"),
              **library_fields(library, bound_of(moved, flops, "f32_flops")["bound_ms"])})
        del out, Ast, Bst, C0
        torch.cuda.empty_cache()

    @staticmethod
    def esc_classes(launch) -> dict:
        """Each class of a classed ESC call: its kernel, most keys, threads
        and shared memory a block."""
        return {c.name: {"kernel": c.kernel, "max_keys": c.max_keys, "threads": c.threads,
                         "block_smem": c.block_smem,
                         **({"key_bits": launch.key_layout(c)[0]} if c.kind != "warp"
                            else {})} for c in launch.classes}

    def class_edge_geometry(self, global_keys: int = GLOBAL_EDGE_KEYS,
                            n_cols: int | None = CLASS_EDGE_COLS, device: str = "cuda"):
        """Rows whose merge steps land on each ESC class edge
        (``class_edge_rows`` at the module's class cuts), staged for two
        strips and two chunks: (A, B, C_prev stacks, plan, c_max_row_nnz,
        shape)."""
        esc, csr, ch = self.kernels["sparse_accum_spgemm"], self.m["csr"], self.m["chunking"]
        cuts = [keys for _, _, keys in esc.STEP_CLASSES]
        a, b, c0, (rows, k, k0, n_cols), row_nnz = class_edge_rows(
            cuts, global_keys, CLASS_EDGE_SEED, n_cols)
        A = csr.csr_from_coo(*a, (rows, k), device=device)
        B = csr.csr_from_coo(*b, (k, n_cols), device=device)
        C0m = csr.csr_from_coo(*c0, (rows, n_cols), device=device)
        plan = self.m["planner"].ChunkPlan("chunk1", (0, rows // 2, rows), (0, k0, k), 0.0, 0.0)
        c_cap = -(-max(sum(row_nnz[s:e]) for s, e in zip(plan.p_ac[:-1], plan.p_ac[1:]))
                  // 8) * 8
        Ast, Bst, _, C0 = self.stage_edge(A, B, C0m, plan, c_cap)
        return Ast, Bst, C0, plan, max(row_nnz), (rows, k, n_cols)

    def esc_class_edge_phase(self) -> None:
        """The ESC kernel's classed launch against its plain version in both
        orders on rows whose steps hold exactly W and W + 1 keys at each
        class cut W (at the first chunk, and at the second with an
        accumulator from the first), rows whose step joins C_prev entries,
        and global steps of ``GLOBAL_EDGE_KEYS`` keys (65,536 slots: three
        passes over global memory), keys of both widths. Every class must
        take steps, the launches by class must be the plan's."""
        esc = self.kernels["sparse_accum_spgemm"]
        Ast, Bst, C0, plan, row_cap, shape = self.class_edge_geometry()
        r0s, r1s = plan.b_ranges()
        launch = esc.esc_launch_plan(Ast, Bst, C0, r0s, r1s, row_cap=row_cap)
        check(launch.split, "class_edge: the call is not classed")
        keys = esc.step_keys(Ast, Bst, C0, r0s, r1s)
        edges = {}
        for c in launch.classes[:-1]:
            edges[c.name] = {w: int((keys == w).sum()) for w in (c.max_keys, c.max_keys + 1)}
            check(all(edges[c.name].values()), f"class_edge: no step of {c.max_keys} or "
                  f"{c.max_keys + 1} keys ({edges[c.name]})")
        check(all(launch.routes[c.name] for c in launch.classes),
              f"class_edge: a class takes no step ({launch.routes})")
        run, plain = self.csr_runners("sparse_accum_spgemm", Ast, Bst, C0, r0s, r1s, row_cap)
        orders = {}
        for order in ORDERS:
            got, routes = self.esc_routes_run(f"class_edge/{order}", lambda: run(order), launch)
            orders[order] = {**self.hold_csr(f"sparse_accum_spgemm/class_edge/{order}", got,
                                             plain(order)), "launches_by_route": routes}
        self.note_err("sparse_accum_spgemm", max(o["max_abs_err"] for o in orders.values()))
        emit({"esc_class_edge_phase": "class_edges", "shape": list(shape),
              "c_max_row_nnz": row_cap,
              "nnz_c0": int(C0.indptr[..., -1].sum()), "steps_by_class": launch.routes,
              "steps_at_edges": edges, "launches_by_class": launch.launches,
              "key_bits": {c.name: launch.key_layout(c)[0] for c in launch.classes
                           if c.kind != "warp"},
              "global_slots": int(launch.offsets[-1]), "classes": self.esc_classes(launch),
              "orders": orders})

    def rmat_run(self, label: str, L, plan) -> None:
        """The main path on L x L of an RMAT scale-12 graph through
        ``backend="sparse"`` (counters reset before, read after): the ESC
        kernel computes it by step class, every class launched, its largest
        steps on the global class; C against the port's plain ``spgemm`` on
        the card (structure exact) and scipy."""
        torch, chunking, kkmem = self.torch, self.m["chunking"], self.m["kkmem"]
        self.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        C, stats = chunking.chunked_spgemm(L, L, plan, backend="sparse")
        torch.cuda.synchronize()
        exec_s = time.perf_counter() - t0
        launches = self.read_counters()
        esc = self.kernels["sparse_accum_spgemm"]
        for route in esc.ROUTES[1:]:
            check(launches[f"sparse_accum_spgemm/{route}"] > 0,
                  f"{label}: the ESC kernel's {route} class was not launched")
        self.note_esc_routes(label, launches)
        self._rmat12 = (L, plan, (C, stats, exec_s, launches))
        plain = kkmem.spgemm(L, L, kkmem.spgemm_symbolic_host(L, L).c_pad)
        nnz = C.nnz()
        structure = (nnz == plain.nnz() and torch.equal(C.indptr, plain.indptr)
                     and torch.equal(C.indices[:nnz], plain.indices[:nnz]))
        err = float((C.data[:nnz] - plain.data[:nnz]).abs().max()) if nnz else 0.0
        check(structure, f"{label}: structure differs from the plain spgemm")
        scale = float(plain.data[:nnz].abs().max()) if nnz else 0.0
        check(err <= KERNEL_ATOL + KERNEL_RTOL * scale,
              f"{label}: values differ from the plain spgemm by {err}")
        scipy_err = self.scipy_check(L, L, C)
        check(scipy_err <= SCIPY_RTOL, f"{label}: relative error {scipy_err} vs scipy")
        Ast, Bst, C0, r0s, r1s, caps = self.stage_csr(L, L, plan)
        steps = esc.esc_launch_plan(Ast, Bst, C0, r0s, r1s, row_cap=caps.c_max_row_nnz).routes
        del Ast, Bst, C0
        emit({"run": label, "A": list(L.shape), "nnz_A": L.nnz(), "backend": "sparse",
              "plan": {"algorithm": plan.algorithm, "n_ac": plan.n_ac, "n_b": plan.n_b},
              "launches": launches, "esc_steps_by_class": steps, "nnz_C": nnz,
              "stats": {"kernel_calls": stats.kernel_calls,
                        "copy_in_bytes": stats.copy_in_bytes},
              "wall_s": {"chunked_spgemm": exec_s},
              "check": {"plain_structure_equal": structure, "plain_max_abs_err": err,
                        "scipy_rel_err": scipy_err}})
        del C, plain
        torch.cuda.empty_cache()

    def examples_phase(self) -> None:
        """The port's three examples (``examples/torch_*.py``) on the card at
        their default sizes (the multigrid driver through every backend and
        ``auto``), their output captured: quickstart's ``chunked ==
        unchunked == oracle`` line, every ``correct=`` of the multigrid
        driver True, the triangle driver's ``agrees: True`` and dense-oracle
        line. Counters reset before each, read after."""
        import contextlib
        import importlib
        import io

        sys.path.insert(0, str(ROOT))
        runs = (("torch_quickstart", lambda mod: mod.main()),
                ("torch_multigrid_spgemm", lambda mod: mod.main(["--backends", "all"])),
                ("torch_triangle_count", lambda mod: mod.main([])))
        for name, call in runs:
            mod = importlib.import_module(f"examples.{name}")
            buf = io.StringIO()
            self.reset_counters()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                call(mod)
            self.torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            lines = buf.getvalue().splitlines()
            launches = {k: v for k, v in self.read_counters().items() if v}
            if name == "torch_quickstart":
                check(any(ln.startswith("chunked == unchunked == oracle") for ln in lines),
                      f"examples/{name}: no 'chunked == unchunked == oracle' line")
            elif name == "torch_multigrid_spgemm":
                correct = [ln for ln in lines if "correct=" in ln]
                check(len(correct) >= 8 and all("correct=True" in ln for ln in correct),
                      f"examples/{name}: {[ln for ln in correct if 'correct=True' not in ln]}")
                for kernel in ("ranged_spgemm", "sparse_accum_spgemm", "hash_accum_spgemm",
                               "bsr_spgemm"):
                    check(launches.get(kernel, 0) > 0, f"examples/{name}: {kernel} not launched")
            else:
                check(any("agrees: True" in ln and "kkmem baseline" in ln for ln in lines)
                      and "[tc] dense oracle agrees: True" in lines,
                      f"examples/{name}: the counts disagree")
                check(launches.get("hash_masked_accum_spgemm", 0) > 0,
                      f"examples/{name}: the masked kernel was not launched")
            emit({"examples_phase": name, "seconds": seconds, "launches": launches,
                  "lines": lines})

    def audit_phase(self) -> None:
        """The static auditor on the card: ``audit_all(cases="fast",
        device="cuda")``, the corpus on the card, the shared-memory requests
        with the static bytes of the build log, the probe-bound pass over
        every hash record's launches (staged, ring, in place, batched in
        place: every table the planner's), then ``audit_pipeline`` of
        the Galerkin product at the resident and spill plans
        (:meth:`pipeline_audit`). Must be clean."""
        from repro_torch.analysis import audit_all

        t0 = time.perf_counter()
        rep = audit_all(cases="fast", device="cuda")
        seconds = time.perf_counter() - t0
        self.pipeline_audit()
        requests = {}
        for r in rep["records"]:
            for q in r.get("smem", {}).get("requests", ()):
                key = f"{q['source']}/{q['kernel']}"
                requests[key] = max(requests.get(key, 0), q["total"])
                check(q["static"] is not None, f"audit: {key} has no build-log entry")
        probes = [r["while"] for r in rep["records"] if r["while"]["checked"]]
        check(len(probes) == sum(r["backend"] == "hash" for r in rep["records"]) > 0,
              f"audit: the probe-bound pass checked {len(probes)} hash records")
        emit({"audit_phase": "fast", "seconds": seconds, "ok": rep["ok"],
              "records": len(rep["records"]), "skipped": rep["skipped"],
              "violations": rep["violations"], "largest_smem_requests": requests,
              "probe_bound_pass": {"records": len(probes),
                                   "hash_launches": sum(p["launches"] for p in probes)}})
        check(rep["ok"], f"audit: {len(rep['violations'])} violations: {rep['violations'][:3]}")

    def pipeline_audit(self) -> None:
        """``audit_pipeline`` under every backend with an ``audit_trace``, on
        brick3d ``PIPE_AUDIT_N``'s Galerkin product (built on the card) at
        the ``PIPE_RESIDENT`` and ``PIPE_SPILL`` plans: no violation, each
        chunked hop's staged step within its byte model and the composed
        model covering the peak plus a resident T. Both hops must be staged,
        and hop 2 must be Chunk2 with several chunks at one plan and chunk1
        with several chunks at the other. The staged cores run on the CPU's
        plain versions (the auditor records their copy events), so the size
        is cut from the Galerkin runs' n=48 (PERF.md)."""
        pipe, planner, symbolic = self.m["pipeline"], self.m["planner"], self.m["symbolic"]
        registry = self.m["chunk_stream"].backend_registry
        t0 = time.perf_counter()
        A, R, P = self.m["multigrid"].problem("brick3d", PIPE_AUDIT_N, device="cuda")
        size = float(A.nbytes() + P.nbytes() + R.nbytes())
        records = []
        for frac, resident in ((PIPE_RESIDENT, True), (PIPE_SPILL, False)):
            plan = planner.plan_pipeline(A, P, R, self.m["memory_model"].P100,
                                         fast_limit_bytes=frac * size)
            check(plan.t_resident == resident, f"pipeline audit: t_resident at {frac}")
            caps = symbolic.pipeline_output_caps(A, P, R, plan.plan1.p_ac, plan.plan2.p_ac)
            for spec in registry.specs():
                if not spec.supports_audit:
                    continue
                record, violations = pipe.audit_pipeline(A, P, R, plan, backend=spec.name,
                                                         caps=caps)
                check(not violations, f"pipeline audit {spec.name} at {frac}: {violations[:2]}")
                check(sorted(record["hops"]) == ["hop1", "hop2"],
                      f"pipeline audit {spec.name} at {frac}: staged hops {sorted(record['hops'])}")
                records.append({"backend": spec.name, "fraction": frac,
                                "plan": [[h.algorithm, h.n_ac, h.n_b]
                                         for h in (plan.plan1, plan.plan2)],
                                **{k: record[k] for k in ("t_resident", "t_bytes",
                                                          "fast_bytes_needed",
                                                          "traced_peak", "n_violations")},
                                "hops": {h: {"step_bytes": v["step_bytes"],
                                             "model_bytes": v["model_bytes"]}
                                         for h, v in record["hops"].items()}})
        hop2 = {(r["plan"][1][0], r["plan"][1][2] > 1) for r in records}
        check(("chunk2", True) in hop2 and ("chunk1", True) in hop2,
              f"pipeline audit: hop 2 plans {sorted(hop2)}, want Chunk2 and chunk1 with n_b > 1")
        emit({"audit_phase": "pipeline", "n": PIPE_AUDIT_N,
              "seconds": time.perf_counter() - t0, "records": records, "card": self.smi})

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

    def scipy_check(self, A, P, C, R=None, key=None) -> float:
        """max |C - A @ P| / max |A @ P| (or of ``R @ (A @ P)``) against scipy
        in float64, zeros eliminated on both sides. ``key`` names the
        product, so later checks against it reuse scipy's."""
        import scipy.sparse as sp

        def host(m):
            nnz = m.nnz()
            out = sp.csr_matrix((m.data[:nnz].cpu().numpy().astype(np.float64),
                                 m.indices[:nnz].cpu().numpy(),
                                 m.indptr.cpu().numpy()), shape=m.shape)
            out.eliminate_zeros()
            return out
        ref = self._scipy_refs.get(key)
        if ref is None:
            ref = host(A) @ host(P)
            if R is not None:
                ref = host(R) @ ref
            ref.eliminate_zeros()
            if key is not None:
                self._scipy_refs[key] = ref
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
                 orders[order]["device_split_ms"], _) = kernel_device_split(
                    torch, lambda: run(order), names, kernels)
                orders[order]["device_launches_ms"] = device_launch_list(
                    torch, lambda: run(order), names, kernels)
                orders[order]["kernels_per_call"] = kernels
                orders[order]["plain_ms"] = cuda_ms(torch, lambda: plain(order), reps=PLAIN_REPS)
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
        self.tc_runs[chunk2] = (plan, caps, exec_s)
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

    def galerkin_run(self, label: str, backend: str, frac: float, resident: bool,
                     n: int = 48) -> None:
        """``pipeline_spgemm`` of brick3d ``n`` through ``backend`` at a fast
        limit of ``frac`` x size(A, P, R): structure equal to the port's
        plain two-hop ``spgemm``, values to scipy's R (A P) in float64. On
        the spill path T streams from pinned memory into hop 2 through the
        backend's ring, its bytes hop 2's B events."""
        torch, planner, symbolic = self.torch, self.m["planner"], self.m["symbolic"]
        pipe, kkmem = self.m["pipeline"], self.m["kkmem"]
        A, P = self.problem("brick3d", n)
        R = self.restrictions[("brick3d", n)]
        t0 = time.perf_counter()
        plans = self._pipe_plans.setdefault(
            n, {"t_pattern": symbolic.spgemm_pattern_host(A, P)})
        tp = plans["t_pattern"]
        limit = frac * float(A.nbytes() + P.nbytes() + R.nbytes())
        if frac not in plans:   # one plan per size and limit, shared by backends
            plan = planner.plan_pipeline(A, P, R, self.m["memory_model"].P100,
                                         fast_limit_bytes=limit, t_pattern=tp)
            caps = symbolic.pipeline_output_caps(A, P, R, plan.plan1.p_ac,
                                                 plan.plan2.p_ac, t_pattern=tp)
            plans[frac] = (plan, caps)
        plan, caps = plans[frac]
        check(plan.t_resident == resident, f"{label}: t_resident={plan.t_resident}")
        check("whole_fast" not in (plan.plan1.algorithm, plan.plan2.algorithm),
              f"{label}: a whole_fast hop bypasses the kernels")
        plan_s = time.perf_counter() - t0
        self.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with self.m["copy_ring"].RingLog(timed=True) as log:
            C, stats = pipe.pipeline_spgemm(A, P, R, plan, backend=backend, caps=caps)
        torch.cuda.synchronize()
        exec_s = time.perf_counter() - t0
        launches = self.read_counters()
        kernel = self.backend_kernel.get(backend)   # scan and loop launch no kernel
        if kernel is not None:
            check(launches[kernel] > 0, f"{label}: {kernel} was not launched")
        ring = {}
        if not resident:   # T stays in pinned memory and streams into hop 2 as B
            check([r.operand for r in log.rings] == ["B"],
                  f"{label}: rings {[r.operand for r in log.rings]}, expected T's alone")
            ring = self.ring_gates(label, log, plan.plan2, stats.hop2,
                                   self.m["placement"].Placement("fast", "slow", "fast"),
                                   backend)
            ring["times"] = log.times()
        else:
            check(not log.transfers, f"{label}: the resident path crossed the link")
        if n not in self._rap_plain:
            self._rap_plain[n] = kkmem.spgemm_full(R, kkmem.spgemm_full(A, P))
        plain = self._rap_plain[n]
        nnz = C.nnz()
        structure = (torch.equal(C.indptr, plain.indptr)
                     and torch.equal(C.indices[:nnz], plain.indices[:nnz]))
        if backend == "pallas":   # the dense backend keeps only nonzero sums
            csr = self.m["csr"]
            err = float((csr.csr_to_dense(C) - csr.csr_to_dense(plain)).abs().max())
            structure = nnz <= plain.nnz()
        else:
            err = float((C.data[:nnz] - plain.data[:nnz]).abs().max()) if nnz else 0.0
        check(structure, f"{label}: structure differs from the plain two-hop spgemm")
        scale = float(plain.data[:plain.nnz()].abs().max()) if plain.nnz() else 0.0
        check(err <= KERNEL_ATOL + KERNEL_RTOL * scale,
              f"{label}: values differ from the plain two-hop spgemm by {err}")
        scipy_err = self.scipy_check(A, P, C, R=R, key=("rap", n))
        check(scipy_err <= SCIPY_RTOL, f"{label}: relative error {scipy_err} vs scipy")
        self._pipe_fast[n, frac, backend] = (C, stats, exec_s)
        emit({"run": label, "problem": "brick3d", "n": n, "backend": backend,
              "plan": {"hop1": [plan.plan1.algorithm, plan.plan1.n_ac, plan.plan1.n_b],
                       "hop2": [plan.plan2.algorithm, plan.plan2.n_ac, plan.plan2.n_b],
                       "t_resident": plan.t_resident, "t_bytes": plan.t_bytes,
                       "fast_limit_bytes": limit},
              "launches": launches, "nnz_T": caps.t_nnz, "nnz_C": nnz,
              "stats": {"spilled": stats.spilled, "spill_bytes": stats.spill_bytes,
                        "copy_bytes": stats.copy_bytes,
                        "kernel_calls": [stats.hop1.kernel_calls, stats.hop2.kernel_calls]},
              "wall_s": {"problem": self.problems[("brick3d", n)][2], "plan": plan_s,
                         "pipeline_spgemm": exec_s}, "t_ring": ring, "card": self.smi,
              "check": {"plain_structure_equal": structure, "plain_max_abs_err": err,
                        "scipy_rel_err": scipy_err}})

    def placed_hops(self, label: str, log, plan, caps, stats, where, backend: str) -> dict:
        """The ring gates of each hop of one placed pipeline call: hop 1 under
        (A, P, T), hop 2 under (R, T, C), T slow when the plan spills it; a
        hop with a slow operand is one executor call of ``log.calls``, whose
        bytes must equal its slow operands' tagged events
        (:meth:`ring_gates`). Returns each such hop's rings, bytes, copy and
        compute ms and share of copy time under compute."""
        chunking = self.m["chunking"]
        t = "fast" if plan.t_resident else "slow"
        hops = [("hop1", plan.plan1, caps.hop1, stats.hop1,
                 where.hop1(t) if where.hop1("fast").slow else None),
                ("hop2", plan.plan2, caps.hop2, stats.hop2, where.hop2(t))]
        placed = [h for h in hops if h[4] is not None and h[4].slow]
        check(len(log.calls) == len(placed),
              f"{label}: {len(log.calls)} ring calls, {len(placed)} placed hops")
        out = {}
        for (hop, hplan, hcaps, hstats, hwhere), call in zip(placed, log.calls):
            if backend == "bsr":   # a strip's CSR at the hop's c_pad crosses once
                check(not (hplan.algorithm == "chunk2" and hplan.n_b > 1),
                      f"{label}/{hop}: Chunk2 partials are not sized here")
                rows = max(e - s for s, e in zip(hplan.p_ac[:-1], hplan.p_ac[1:]))
                self._bsr_c_sizes.setdefault(hplan, (0, chunking._c_strip_nbytes(
                    rows, hcaps.c_pad, self.torch.float32)))
            ring = self.ring_gates(f"{label}/{hop}", call, hplan, hstats, hwhere, backend)
            out[hop] = {"placement": dict(zip("ABC", (hwhere.A, hwhere.B, hwhere.C))),
                        "plan": [hplan.algorithm, hplan.n_ac, hplan.n_b],
                        "steps": hplan.n_ac * hplan.n_b,
                        **ring, "times": call.times()}
        return out

    def galerkin_placed(self, label: str, backend: str, frac: float, name: str,
                        n: int = 48) -> None:
        """``pipeline_spgemm`` of brick3d ``n`` with A, P and R where
        ``PIPELINE_TABLE3[name]`` puts them (a slow operand in pinned host
        memory; C in R's space), at :meth:`galerkin_run`'s plan at ``frac``
        through ``backend``: C equal bit for bit to that plan's all-fast
        call, the PipelineStats equal, one launch a step of each hop, each
        hop's ring moving its slow operands' events (:meth:`placed_hops`),
        and C within SCIPY_RTOL of scipy's R (A P)."""
        torch, pipe, placement = self.torch, self.m["pipeline"], self.m["placement"]
        A, P = self.problem("brick3d", n)
        R = self.restrictions[("brick3d", n)]
        plan, caps = self._pipe_plans[n][frac]
        C_fast, stats_fast, wall_fast = self._pipe_fast[n, frac, backend]
        where = placement.PIPELINE_TABLE3[name]
        ops = [placement.place(m, getattr(where, k)) for k, m in (("A", A), ("P", P), ("R", R))]
        self.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with self.m["copy_ring"].RingLog(timed=True) as log:
            C, stats = pipe.pipeline_spgemm(*ops, plan, backend=backend, caps=caps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = self.read_counters()
        self.hold_pipeline(label, C, stats, C_fast, stats_fast, where)
        hops = self.placed_hops(label, log, plan, caps, stats, where, backend)
        kernel = self.backend_kernel.get(backend)   # scan and loop launch no kernel
        if kernel is not None:
            steps = sum(h["steps"] for h in hops.values())
            check(launches[kernel] == steps,
                  f"{label}: {launches[kernel]} {kernel} launches, {steps} placed steps")
        scipy_err = self.scipy_check(A, P, C, R=R, key=("rap", n))
        check(scipy_err <= SCIPY_RTOL, f"{label}: relative error {scipy_err} vs scipy")
        emit({"placed_run": {
            "run": label, "problem": "brick3d", "n": n, "backend": backend,
            "placement": dataclasses.asdict(where),
            "plan": {"hop1": [plan.plan1.algorithm, plan.plan1.n_ac, plan.plan1.n_b],
                     "hop2": [plan.plan2.algorithm, plan.plan2.n_ac, plan.plan2.n_b],
                     "t_resident": plan.t_resident},
            "launches": {k: v for k, v in launches.items() if v}, "hops": hops,
            "wall_s": wall, "all_fast_wall_s": wall_fast, "bit_equal": True,
            "scipy_rel_err": scipy_err, "card": self.smi}})
        del C, ops

    def galerkin_in_place(self, label: str, backend: str, frac: float, name: str,
                          n: int = 48) -> None:
        """:meth:`galerkin_placed`'s call read in place
        (``pipeline_spgemm(..., slow_reads="in_place")``): C equal bit for
        bit to the all-fast pipeline call's (to which the ring twin is held
        bit for bit) and in R's space, the PipelineStats equal, each hop
        with a slow operand (a spilled T among them) launching once a strip,
        each in place, a hop without one once, and no ring op or transfer.
        Prints the launches' kernel ms, the live tensors' peak on the card
        and the wall."""
        torch, pipe, placement = self.torch, self.m["pipeline"], self.m["placement"]
        A, P = self.problem("brick3d", n)
        R = self.restrictions[("brick3d", n)]
        plan, caps = self._pipe_plans[n][frac]
        C_fast, stats_fast, wall_fast = self._pipe_fast[n, frac, backend]
        where = placement.PIPELINE_TABLE3[name]
        ops = [placement.place(m, getattr(where, k)) for k, m in (("A", A), ("P", P), ("R", R))]
        with self.m["copy_ring"].RingLog() as log, self.m["build"].LaunchTimer() as timer:
            (C, stats), wall, peak, live = self.memory_traced(lambda: pipe.pipeline_spgemm(
                *ops, plan, backend=backend, caps=caps, slow_reads="in_place"))
        kernel_ms = timer.ms()
        launches = self.read_counters()
        self.hold_pipeline(label, C, stats, C_fast, stats_fast, where)
        t = "fast" if plan.t_resident else "slow"
        hops = ((plan.plan1, where.hop1(t) if where.hop1("fast").slow else placement.ALL_FAST),
                (plan.plan2, where.hop2(t)))
        want = sum(h.n_ac if w.slow else 1 for h, w in hops)
        slow = sum(h.n_ac for h, w in hops if w.slow)
        kernel = self.backend_kernel[backend]
        check(launches[kernel] == want and launches[f"{kernel}/in_place"] == slow,
              f"{label}: {launches[kernel]} {kernel} launches, "
              f"{launches[f'{kernel}/in_place']} in place; {want} and {slow} expected")
        check(not log.rings and not log.transfers,
              f"{label}: {len(log.rings)} rings, {len(log.transfers)} transfers in place")
        emit({"in_place_run": {
            "run": label, "problem": "brick3d", "n": n, "backend": backend,
            "placement": dataclasses.asdict(where),
            "plan": {"hop1": [plan.plan1.algorithm, plan.plan1.n_ac, plan.plan1.n_b],
                     "hop2": [plan.plan2.algorithm, plan.plan2.n_ac, plan.plan2.n_b],
                     "t_resident": plan.t_resident},
            "launches": {k: v for k, v in launches.items() if v}, "bit_equal": True,
            "kernel_ms": kernel_ms, "peak_alloc_bytes": peak, "peak_live_bytes": live,
            "wall_s": wall, "all_fast_wall_s": wall_fast, "card": self.smi}})
        del C, ops

    def hold_pipeline(self, label: str, C, stats, C_fast, stats_fast, where) -> None:
        """A placed pipeline call's C in R's space and equal bit for bit to
        the all-fast call's ``C_fast``, its PipelineStats equal."""
        torch, csr = self.torch, self.m["csr"]
        check(csr.csr_residence(C) == ("pinned" if where.C == "slow" else "card"),
              f"{label}: C is in {csr.csr_residence(C)} memory, placed {where.C}")
        for f in ("indptr", "indices", "data"):
            check(torch.equal(getattr(C, f).cpu(), getattr(C_fast, f).cpu()),
                  f"{label}: C.{f} differs from the all-fast pipeline call's")
        check((stats.hop1, stats.hop2, stats.spilled, stats.spill_bytes)
              == (stats_fast.hop1, stats_fast.hop2, stats_fast.spilled,
                  stats_fast.spill_bytes), f"{label}: PipelineStats differ from the all-fast call's")

    # -- placement: operands in slow (pinned host) memory ---------------------

    def link_yardstick(self) -> dict:
        """The link's rate: one 256 MB pinned copy each way, CUDA events
        around each (median of three, after a warm-up)."""
        torch = self.torch
        host = torch.empty(LINK_YARDSTICK_BYTES, dtype=torch.uint8, pin_memory=True)
        dev = torch.empty(LINK_YARDSTICK_BYTES, dtype=torch.uint8, device="cuda")
        out = {}
        for direction, fn in (("h2d", lambda: dev.copy_(host, non_blocking=True)),
                              ("d2h", lambda: host.copy_(dev, non_blocking=True))):
            ms = cuda_ms(torch, fn, reps=3)
            out[direction] = {"ms": ms, "gb_s": LINK_YARDSTICK_BYTES / ms / 1e6}
        del host, dev
        torch.cuda.empty_cache()
        emit({"link_yardstick": out, "bytes": LINK_YARDSTICK_BYTES})
        return out

    @staticmethod
    def stage_sizes(plan, stats) -> tuple:
        """(slab, a_stage, c_stage): the staged piece bytes of a call's plan
        under ``chunk_stream.planned_events`` (the CSR accumulators, the
        dense slab, and the masked and BSR pipelines' ChunkStats), read off
        its ChunkStats."""
        ins = stats.per_copy_in
        if plan.algorithm == "chunk2":
            return int(ins[0]), int(ins[2]), int(ins[1]) // plan.n_ac
        return int(ins[2]), int(ins[0]), int(ins[1])

    def placed_events(self, backend: str, plan, stats) -> list:
        """The tagged copy events of one call with slow operands under
        ``backend``, at the piece sizes its ChunkStats give: the loop
        executors' own (``planned_events_ranged``) for ``scan`` and
        ``loop``, a pair's pieces and a strip's summed blocks and CSR
        (``planned_events_bsr``, at the sizes :meth:`step_workspace` read
        off the plan's staging; C's are 0 where no probe ran) for ``bsr``,
        and ``planned_events`` otherwise."""
        cs = self.m["chunk_stream"]
        ins, outs = stats.per_copy_in, stats.per_copy_out
        if backend in ("scan", "loop"):
            ranged = self.m["chunking"].planned_events_ranged
            if plan.algorithm == "knl":
                return ranged(plan, int(ins[0]), 0, 0)
            chunk, strip = ((ins[2], ins[0]) if plan.algorithm == "chunk1"
                            else (ins[0], ins[1]))
            return ranged(plan, int(chunk), int(strip), int(outs[-1]))
        slab, a_stage, c_stage = self.stage_sizes(plan, stats)
        if backend == "bsr":
            c_part, c_strip = self._bsr_c_sizes.get(plan, (0, 0))
            return cs.planned_events_bsr(plan, slab, a_stage, c_part, c_strip)
        return cs.planned_events(plan, slab, a_stage, c_stage)

    def ring_gates(self, label: str, log, plan, stats, where, backend: str,
                   events: list | None = None, roles: dict | None = None) -> dict:
        """The ring's gates on one call: the bytes it moved equal the slow
        operands' tagged events (``placed_events``, or ``events``),
        operand for operand and event for event, with nothing crossing
        outside them; every ring's log is its schedule's program and the
        schedule replays clean; every slow stack is pinned. ``roles`` maps
        an operand of the events to the placement's operand it follows (the
        mask follows C)."""
        dma = self.m["dma"]
        if events is None:
            events = self.placed_events(backend, plan, stats)
        roles = {"A": "A", "B": "B", "C": "C", **(roles or {})}
        for operand, role in roles.items():
            for direction in ("in", "out"):
                want = ([b for o, d, b in events if o == operand and d == direction]
                        if getattr(where, role) == "slow" else [])
                check(log.moved(operand, direction) == want,
                      f"{label}: the ring moved {sum(log.moved(operand, direction))} "
                      f"bytes of {operand} {direction}, the events {sum(want)}")
        for ring in log.rings:
            bad = (dma.check_ring_structure(ring.ops, ring.total, ring.n_fields)
                   + dma.simulate_schedule(ring.total))
            check(not bad, f"{label}: ring {ring.operand}: {bad[:2]}")
            check(ring.source_pinned, f"{label}: ring {ring.operand}'s stack is not pinned")
        return {"rings": [{"operand": r.operand, "role": r.role, "total": r.total,
                           "fields": r.n_fields, "ops": len(r.ops)} for r in log.rings],
                "moved_in": sum(t.nbytes for t in log.transfers if t.direction == "in"),
                "moved_out": sum(t.nbytes for t in log.transfers if t.direction == "out"),
                "whole": [dataclasses.asdict(t) for t in log.transfers if t.apart]}

    def live_of(self, fn) -> int:
        """The most bytes the tensors ``fn`` allocates hold at once (the
        allocator's trace, :func:`live_peak`), its result included."""
        torch = self.torch
        torch.cuda.synchronize()
        torch.cuda.memory._record_memory_history(context=None, max_entries=1 << 20)
        start = trace_length(torch.cuda.memory._snapshot())
        out = fn()
        torch.cuda.synchronize()
        live = live_peak(torch.cuda.memory._snapshot(), start)
        torch.cuda.memory._record_memory_history(enabled=None)
        del out
        return live

    def memory_traced(self, fn) -> tuple:
        """``(fn(), wall s, peak allocation, live tensors' peak)`` of one
        call, the counters reset before it and the card synchronized after."""
        torch = self.torch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        torch.cuda.memory._record_memory_history(context=None, max_entries=1 << 20)
        start = trace_length(torch.cuda.memory._snapshot())
        self.reset_counters()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - before
        live = live_peak(torch.cuda.memory._snapshot(), start)
        torch.cuda.memory._record_memory_history(enabled=None)
        return out, wall, peak, live

    def step_workspace(self, A, B, plan, backend: str, env) -> int:
        """One step's workspace on the card, its output included, where no
        formula gives it: the largest live peak of the plan's ranged
        multiply-adds on card pieces (``scan``, ``loop``), or
        :meth:`bsr_workspace` (``bsr``). ``env`` is the call's block-capped
        envelope."""
        ch, kkmem = self.m["chunking"], self.m["kkmem"]
        c_pad = env.c_pad
        if backend == "bsr":
            return self.bsr_workspace(A, B, plan, env)
        strips = ch.a_strips(A, plan.p_ac) if plan.algorithm != "knl" else [A]
        chunks = ch.b_chunks(B, plan.p_b)
        r0s, r1s = plan.b_ranges()
        most = 0
        for Ai in strips:
            C0 = ch._empty_like_c(Ai.n_rows, B.n_cols, c_pad, A.dtype, A.device)
            for j, Bj in enumerate(chunks):
                most = max(most, self.live_of(lambda: kkmem.spgemm_ranged_impl(
                    Ai, Bj, int(r0s[j]), int(r1s[j]), C0, c_pad)))
        return most

    def bsr_workspace(self, A, B, plan, env) -> int:
        """The ``bsr`` executor's workspace on card operands: the largest
        live peak of one pair's launch and its add into its strip's summed
        blocks (the output blocks, the slot tables, the rows), and of
        turning the strip with the most blocks into its CSR at ``c_pad``
        (``_bsr_strip_csr``), past the summed blocks themselves. Records
        the plan's C sizes (a strip's summed blocks, its CSR) in
        ``_bsr_c_sizes``."""
        torch, cs = self.torch, self.m["chunk_stream"]
        mod, with_sentinel = self.kernels["bsr_spgemm"], self.m["bsr"].bsr_blocks_with_sentinel
        bs, _, _, _, u_cap = env.bsr_caps
        n = B.n_cols
        pairs, a_bsr, b_bsr, metas, layouts = cs._bsr_stage_placed(A, B, plan, env)
        part = cs._bsr_part_nbytes(layouts, bs)
        self._bsr_c_sizes[plan] = (part, self.m["chunking"]._c_strip_nbytes(
            env.strip_rows, env.c_pad, A.dtype))
        ia = max(range(len(layouts)), key=lambda i: layouts[i][0].size)
        acc = torch.zeros(part // (bs * bs * 4), bs, bs, device=A.device)
        most, k = 0, 0
        for p, (i, jb) in enumerate(pairs):
            if i != ia:
                continue
            a, b, meta, pos = (with_sentinel(a_bsr[p]), with_sentinel(b_bsr[jb]), metas[p],
                               layouts[ia][1][k])
            k += 1

            def launch():
                a_slots = torch.from_numpy(meta.a_slots).to(A.device)
                b_slots = torch.from_numpy(meta.b_slots).to(A.device)
                out = mod.bsr_spgemm_blocks(a, b, a_slots, b_slots, a_slots.shape[0],
                                            u_cap, bs)
                cs._bsr_add(acc, pos, out[:meta.n_c_blocks])

            most = max(most, self.live_of(launch))
        s, e = list(zip(plan.p_ac[:-1], plan.p_ac[1:]))[ia]
        most = max(most, self.live_of(lambda: cs._bsr_strip_csr(
            acc, layouts[ia][0], e - s, env.strip_rows, n, bs, -(-n // bs), A.dtype,
            env.c_pad)))
        return most

    def bsr_c_bytes(self, plan, where, c_bytes: int) -> int:
        """C's bytes on the card under ``bsr`` past the workspace: the
        strips' summed blocks (every strip's at once in Chunk2 with C fast;
        with C slow in Chunk2 the partial coming in beside the two going
        out; one strip's otherwise) and the strips' CSRs (two in flight to
        slow memory when C is slow, else the kept strips and the assembled
        C, ``c_bytes`` each)."""
        part, strip = self._bsr_c_sizes[plan]
        chunk2 = plan.algorithm == "chunk2"
        if where.C == "fast":
            return (plan.n_ac if chunk2 else 1) * part + 2 * c_bytes
        return (3 if chunk2 and plan.n_b > 1 else 1) * part + 2 * strip

    def bsr_fast_staging(self, A, B, plan, where, env) -> dict:
        """The live peak of building a fast operand's BSR pieces on the
        card as the placed ``bsr`` executor builds them (the staged stack
        and, while it is built, its blocks, sentinel copies and the
        staging's index arrays), by operand."""
        cs, copy_ring = self.m["chunk_stream"], self.m["copy_ring"]
        bs, nbl_a_cap, nbl_b_cap, _, _ = env.bsr_caps
        k, n = B.shape
        kpad, npad = -(-k // bs) * bs, -(-n // bs) * bs
        srpad = -(-env.strip_rows // bs) * bs
        strips = list(zip(plan.p_ac[:-1], plan.p_ac[1:]))
        chunks = list(zip(plan.p_b[:-1], plan.p_b[1:]))

        def piece(m):
            return cs.BsrPiece(m.block_indptr, m.block_indices,
                               self.m["bsr"].bsr_blocks_with_sentinel(m))

        out = {}
        if where.B == "fast":
            out["B"] = self.live_of(lambda: copy_ring.staged(
                [piece(cs._stage_bsr(B, r0, r1, 0, n, 0, (kpad, npad), bs, nbl_b_cap))
                 for r0, r1 in chunks], "fast", True))
        if where.A == "fast":
            out["A"] = self.live_of(lambda: copy_ring.staged(
                [piece(cs._stage_bsr(A, s, e, r0, r1, s, (srpad, kpad), bs, nbl_a_cap))
                 for s, e in strips for r0, r1 in chunks], "fast", True))
        return out

    def placed_model(self, plan, stats, where, backend: str, C, *, A=None, B=None) -> dict:
        """``placement.card_bytes`` of one call: the staged piece bytes
        from its events, one launch's workspace (the CSR accumulators' from
        the plan's strip rows and C's densest row; none for the dense slab;
        :meth:`step_workspace` for ``scan``, ``loop`` and ``bsr``, on the
        card operands ``A`` and ``B``), C's assembled bytes, and under
        ``bsr`` a fast operand's measured staging (:meth:`bsr_fast_staging`)
        in place of its stack."""
        planner = self.m["planner"]
        events = self.placed_events(backend, plan, stats)
        first = {}
        for o, d, b in events:
            first.setdefault((o, d), b)
        a_stage, slab = first[("A", "in")], first[("B", "in")]
        c_stage = first.get(("C", "out"), 0)
        if backend in ("hash", "sparse", "pallas"):
            slab, a_stage, c_stage = self.stage_sizes(plan, stats)
        fast_parts = {}
        if backend in ("hash", "sparse"):
            rows = max(e - s for s, e in zip(plan.p_ac[:-1], plan.p_ac[1:]))
            row_cap = (planner.hash_table_slots(C.max_row_nnz) if backend == "hash"
                       else max(C.max_row_nnz, 1))
            workspace = rows * (row_cap * 8 + 4)
        elif backend == "pallas":
            workspace = 0
        else:   # measured once a plan (scan and loop share their steps)
            kind = "bsr" if backend == "bsr" else "ranged"
            if (kind, plan) not in self._probes:
                env = self.m["chunking"].instance_envelope(
                    A, B, plan, block_size=BSR_BLOCK if kind == "bsr" else None)
                self._probes[kind, plan] = (env, self.step_workspace(A, B, plan, backend, env))
            env, workspace = self._probes[kind, plan]
            if backend == "bsr":
                fast_parts = {**self.bsr_fast_staging(A, B, plan, where, env),
                              "C": self.bsr_c_bytes(plan, where, C.nbytes())}
        return self.m["placement"].card_bytes(
            plan, where, a_stage=a_stage, slab=slab, c_stage=c_stage, workspace=workspace,
            c_bytes=C.nbytes(), fast_parts=fast_parts)

    def placed_call(self, label: str, A, B, plan, backend: str, where, fast,
                    card_ops=None, caps=None) -> dict:
        """One ``chunked_spgemm`` with operands placed as ``where`` says
        (pinned host memory for a slow one), gated against the same plan's
        all-fast call ``fast = (C, stats, wall_s[, peak])``: C equal bit
        for bit and where ``where`` puts it, ChunkStats equal, the ring's
        gates, one launch a step (a kernel's launches by route), and the
        card's peak allocation within the ring's byte model plus 10% (and,
        on the chunk1 plans, below the slow operands' own bytes), and its
        tensors' live peak (:func:`live_peak`) within the model plus 1%.
        ``card_ops`` are the operands on the card, for the workspace probes;
        ``caps`` the plan's symbolic phase, hoisted out of the call. Prints
        the copy and compute times, the rates each way and the share
        of copy time under compute."""
        torch = self.torch
        chunking, csr, copy_ring = self.m["chunking"], self.m["csr"], self.m["copy_ring"]
        C_fast, stats_fast, wall_fast = fast[:3]
        kernel = self.backend_kernel.get(backend)   # scan and loop launch no kernel
        slow = bool(where.slow)
        model = None
        if slow:   # the workspace probes run before the measured call
            model = self.placed_model(plan, stats_fast, where, backend, C_fast,
                                      **dict(zip("AB", card_ops or ())))
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.memory._record_memory_history(context=None, max_entries=1 << 20)
        start = trace_length(torch.cuda.memory._snapshot())
        self.reset_counters()
        t0 = time.perf_counter()
        with copy_ring.RingLog(timed=True) as log:
            C, stats = chunking.chunked_spgemm(A, B, plan, backend=backend, placement=where,
                                               caps=caps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - before
        live = live_peak(torch.cuda.memory._snapshot(), start)
        torch.cuda.memory._record_memory_history(enabled=None)
        launches = self.read_counters()
        check(csr.csr_residence(C) == ("pinned" if where.C == "slow" else "card"),
              f"{label}: C is in {csr.csr_residence(C)} memory, placed {where.C}")
        for f in ("indptr", "indices", "data"):
            check(torch.equal(getattr(C, f).cpu(), getattr(C_fast, f).cpu()),
                  f"{label}: C.{f} differs from the all-fast call's")
        check(stats == stats_fast, f"{label}: ChunkStats differ from the all-fast call's")
        steps = plan.n_ac * plan.n_b
        if kernel is not None:
            want = steps if slow or backend == "bsr" else 1
            check(launches[kernel] == want,
                  f"{label}: {launches[kernel]} {kernel} launches, {want} expected")
        if kernel == "sparse_accum_spgemm":   # the brick3d steps fit the shared route
            routed = sum(launches[f"{kernel}/{r}"] for r in self.kernels[kernel].ROUTES)
            check(routed == launches[f"{kernel}/shared"] == launches[kernel],
                  f"{label}: ESC routes {routed} launches, {launches[kernel]} calls")
        out = {"run": label, "placement": dict(zip("ABC", (where.A, where.B, where.C))),
               "backend": backend, "plan": [plan.algorithm, plan.n_ac, plan.n_b],
               "steps": steps, "launches": {k: v for k, v in launches.items() if v},
               "wall_s": wall, "all_fast_wall_s": wall_fast, "bit_equal": True,
               "peak_alloc_bytes": peak, "peak_live_bytes": live, "card": self.smi}
        if len(fast) > 3:
            out["all_fast_peak_alloc_bytes"] = fast[3]
        if slow:
            out.update(self.ring_gates(label, log, plan, stats, where, backend))
            check(peak <= model["total"] * PEAK_MARGIN,
                  f"{label}: peak allocation {peak} passes the ring's model "
                  f"{model['total']} + 10%")
            check(live <= model["total"] * LIVE_MARGIN,
                  f"{label}: live tensors' peak {live} passes the ring's model "
                  f"{model['total']} + 1%")
            out["model_bytes"] = model
            if plan.algorithm == "chunk1":
                slow_bytes = sum(m.nbytes() for k, m in (("A", A), ("B", B))
                                 if getattr(where, k) == "slow")
                slow_bytes += C.nbytes() if where.C == "slow" else 0
                check(peak < slow_bytes, f"{label}: peak allocation {peak} is not below "
                      f"the slow operands' {slow_bytes} bytes")
                out["slow_operand_bytes"] = slow_bytes
            out["times"] = log.times()
        emit({"placed_run": out})
        return out

    def placement_phase(self) -> None:
        """Operands in slow (pinned host) memory on the main path: every
        backend's executor through the copy ring on brick3d n=48
        (PLACED_RUNS), each against its plan's all-fast call and the
        all-fast calls against scipy once; then the dense slab on brick3d
        n=32 (:meth:`dense_placement`), the triangle counts with L slow
        (:meth:`triangle_placement`) and the spilled Galerkin runs under
        scan, loop, bsr and pallas (SPILL_BACKENDS); a pinned operand
        handed straight to a kernel's wrapper must raise. The capacity run
        (:meth:`capacity_run`) runs first in the script, where the allocator
        holds nothing else."""
        torch = self.torch
        planner, chunking, placement = self.m["planner"], self.m["chunking"], self.m["placement"]
        t_phase = time.perf_counter()
        self.link_yardstick()
        A, P = self.problem("brick3d", 48)
        crb, budget = self.quickstart_inputs(A, P)
        p100 = self.m["memory_model"].P100
        plans = {"quickstart": planner.plan_chunks(A, P, crb, p100, fast_limit_bytes=budget),
                 # main_run's budget_div=12 limit, so its run of this plan is found
                 "chunk1": planner.plan_chunks(A, P, crb, p100, fast_limit_bytes=budget * 4 / 12),
                 "knl": planner.plan_knl(A, P, fast_limit_bytes=float(
                     planner.row_bytes_csr(P).sum()) / 3)}
        shapes = {k: (p.algorithm, p.n_ac, p.n_b) for k, p in plans.items()}
        check(shapes["quickstart"] == ("chunk2", 6, 1) and shapes["chunk1"] == ("chunk1", 15, 4)
              and shapes["knl"][0] == "knl", f"placement plans {shapes}")
        # the symbolic phase of each plan, once: every call of the plan takes it
        caps = {k: self.m["symbolic"].strip_output_caps(A, P, p.p_ac) for k, p in plans.items()}
        pinned = placement.place({"A": A, "B": P}, "slow")
        self.refusal_check(A, P, plans["quickstart"], pinned)
        scipy_done = False
        for plan_name, backend, names in PLACED_RUNS:
            plan = plans[plan_name]
            # the main path's run of this plan and backend is the all-fast call
            fast = self.fast_runs.get(("brick3d", 48, plan, backend))
            computed = fast is None
            if computed:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fast = chunking.chunked_spgemm(A, P, plan, backend=backend,
                                               caps=caps[plan_name])
                torch.cuda.synchronize()
                fast = (*fast, time.perf_counter() - t0)
            if not scipy_done or computed:
                err = self.scipy_check(A, P, fast[0], key=("ap", "brick3d", 48))
                check(err <= SCIPY_RTOL, f"placement brick3d48 {backend}: relative "
                      f"error {err} vs scipy")
                emit({"placement_scipy": f"brick3d48_{backend}", "rel_err": err})
                scipy_done = True
            twins = {}
            for name in names:
                where = placement.TABLE3[name]
                ops = [pinned[k] if getattr(where, k) == "slow" else m
                       for k, m in (("A", A), ("B", P))]
                twins[name] = self.placed_call(f"brick3d48_{plan_name}_{backend}_{name}",
                                               *ops, plan, backend, where, fast,
                                               card_ops=(A, P), caps=caps[plan_name])
            # the same placements read in place, beside their ring twins
            for name in IN_PLACE_RUNS.get((plan_name, backend), ()):
                where = placement.TABLE3[name]
                ops = [pinned[k] if getattr(where, k) == "slow" else m
                       for k, m in (("A", A), ("B", P))]
                self.in_place_call(f"brick3d48_{plan_name}_{backend}_inplace_{name}", *ops,
                                   plan, backend, where, fast, host=pinned, card_ops=(A, P),
                                   twin=twins.get(name), caps=caps[plan_name])
            del fast, twins
        del pinned
        self.fast_runs = {k: v for k, v in self.fast_runs.items() if k[1] != 48}
        torch.cuda.empty_cache()
        self.in_place_rmat12()
        self.dense_placement()
        self.in_place_dense()
        self.triangle_placement()
        self.in_place_launched()
        for backend, n in SPILL_BACKENDS:
            self.galerkin_run(f"galerkin_brick3d{n}_{backend}_spill", backend, PIPE_SPILL,
                              False, n=n)
            self.galerkin_placed(f"galerkin_brick3d{n}_{backend}_HostPin_spill", backend,
                                 PIPE_SPILL, "HostPin", n=n)
        self._pipe_fast.clear()
        torch.cuda.empty_cache()
        emit({"placement_phase_s": time.perf_counter() - t_phase})

    def dense_placement(self) -> None:
        """The dense slab with slow operands: brick3d n=32 under the
        brick3d32_pallas plan (chunk2 6 x 1) in HostPin and DP, each
        against that plan's all-fast call (the main path's run). Both calls
        read one set of pinned operands, and each builds its dense pieces
        where its placement puts them. The host's free memory is printed
        before the pinned stacks are made."""
        torch = self.torch
        planner, placement = self.m["planner"], self.m["placement"]
        n = PLACED_DENSE_N
        A, P = self.problem("brick3d", n)
        crb, budget = self.quickstart_inputs(A, P)
        plan = planner.plan_chunks(A, P, crb, self.m["memory_model"].P100,
                                   fast_limit_bytes=budget)
        check((plan.algorithm, plan.n_ac, plan.n_b) == ("chunk2", 6, 1),
              f"brick3d{n} dense plan {(plan.algorithm, plan.n_ac, plan.n_b)}")
        fast = self.fast_runs.pop(("brick3d", n, plan, "pallas"))   # brick3d32_pallas
        emit({"host_memory": {k: v for k, v in host_meminfo().items()
                              if k in ("MemTotal", "MemAvailable")}})
        pinned = placement.place({"A": A, "B": P}, "slow")
        caps = self.m["symbolic"].strip_output_caps(A, P, plan.p_ac)
        for name in PLACED_DENSE:
            where = placement.TABLE3[name]
            ops = [pinned[k] if getattr(where, k) == "slow" else m
                   for k, m in (("A", A), ("B", P))]
            self.placed_call(f"brick3d{n}_chunk2_pallas_{name}", *ops, plan, "pallas",
                             where, fast, card_ops=(A, P), caps=caps)
        del pinned, fast
        torch.cuda.empty_cache()
        # hand the pinned stacks' host memory back (the host allocator keeps
        # freed pinned blocks cached)
        getattr(torch._C, "_host_emptyCache", lambda: None)()

    def triangle_placement(self) -> None:
        """``count_triangles`` with L slow (PLACED_TRIANGLES): each role
        that the placement puts slow streams from pinned memory through the
        ring, the fast ones share one whole copy of L on the card; the count
        equal to scipy's, the bytes equal to the masked events, one masked
        launch a step, and the peaks within the ring's model. Then the fused
        count with L read in place (:meth:`in_place_triangle`), beside its
        ring twin."""
        twins = {label: self.triangle_placed(label, chunk2, name)
                 for label, chunk2, name in PLACED_TRIANGLES}
        self.in_place_triangle(twins["tc_rmat18_fused_HostPin"])

    def masked_workspace(self, L, plan, caps) -> int:
        """The largest live peak of one masked launch of the plan on card
        pieces (its outputs and the kernel's tables and work lists)."""
        cs, hmod = self.m["chunk_stream"], self.kernels["hash_masked_accum_spgemm"]
        (Ast, Bst, C0, Mst, r0s, r1s), table, _ = cs.stage_hash_masked(
            L, L, L, plan, caps.c_pad, caps)
        order = "chunk2" if plan.algorithm == "chunk2" else "chunk1"
        csr = self.m["csr"]

        def one(st, k):   # element k of a [1, n] stack, as a [1, 1] stack
            return csr.CSR(st.indptr[:, k:k + 1], st.indices[:, k:k + 1],
                           st.data[:, k:k + 1], st.shape, st.max_row_nnz)

        most = 0
        for i in range(plan.n_ac):
            for j in range(plan.n_b):
                most = max(most, self.live_of(lambda: hmod.hash_masked_accum_spgemm_stream(
                    one(Ast, i), one(Bst, j), one(C0, i), one(Mst, i),
                    r0s[j:j + 1], r1s[j:j + 1], order=order, table_size=table)))
        del Ast, Bst, C0, Mst
        return most

    def triangle_placed(self, label: str, chunk2: bool, name: str) -> None:
        torch, tri, ch = self.torch, self.m["triangle"], self.m["chunking"]
        cs, placement, csr = self.m["chunk_stream"], self.m["placement"], self.m["csr"]
        L, _, want, _ = self.triangle_graph()
        plan, caps, wall_fast = self.tc_runs[chunk2]   # the second path's run
        where = placement.TABLE3[name]
        strips, chunks = ch.a_strips(L, plan.p_ac), ch.b_chunks(L, plan.p_b)
        strip_rows = strips[0].n_rows
        a_stage, slab = strips[0].nbytes(), chunks[0].nbytes()
        m_struct = (strip_rows + 1) * 4 + strips[0].indices.shape[-1] * 4
        c_stage = cs._c_strip_nbytes(strip_rows, caps.c_pad, L.dtype)
        del strips, chunks
        events = cs.planned_events_masked(plan, slab, a_stage, c_stage, m_struct)
        workspace = self.masked_workspace(L, plan, caps)
        m_data = m_struct - (strip_rows + 1) * 4   # the mask's values' placeholder
        Lp = csr.csr_pin(L)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.memory._record_memory_history(context=None, max_entries=1 << 20)
        start = trace_length(torch.cuda.memory._snapshot())
        self.reset_counters()
        t0 = time.perf_counter()
        with self.m["copy_ring"].RingLog(timed=True) as log:
            got = tri.count_triangles(Lp, plan=plan, caps=caps, placement=where)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - before
        live = live_peak(torch.cuda.memory._snapshot(), start)
        torch.cuda.memory._record_memory_history(enabled=None)
        launches = self.read_counters()
        steps = plan.n_ac * plan.n_b
        check(got.dtype == torch.float64 and got.device.type == "cuda" and float(got) == want,
              f"{label}: {float(got)} triangles on {got.device}, scipy counts {want}")
        check(launches["hash_masked_accum_spgemm"] == steps,
              f"{label}: {launches['hash_masked_accum_spgemm']} masked launches, "
              f"{steps} steps")
        mixed = 0 < len(where.slow) < 3
        check(log.moved("L", "in", apart=True) == ([L.nbytes()] if mixed else []),
              f"{label}: L's whole copies {log.moved('L', 'in', apart=True)}")
        ring = self.ring_gates(label, log, plan, None, where, "hash", events=events,
                               roles={"M": "C"})
        # the card's bytes at the peak: two slots a slow role, a fast role's
        # stack and its pieces beside the whole copy of L, C's slots and
        # steps (chunk2: its block and the strips' results), the mask's
        # slots (chunk2: its block) and its values' placeholder, one step's
        # workspace (its output included)
        n_ac, n_b = plan.n_ac, plan.n_b
        parts = {"A": 2 * a_stage * (1 if where.A == "slow" else n_ac),
                 "B": 2 * slab * (1 if where.B == "slow" else n_b),
                 "C": (2 * n_ac if chunk2 else 4) * c_stage,
                 "M": (n_ac if chunk2 else 2) * m_struct + m_data,
                 "L": L.nbytes() if mixed else 0, "workspace": workspace}
        parts["total"] = sum(parts.values())
        check(peak <= parts["total"] * PEAK_MARGIN,
              f"{label}: peak allocation {peak} passes the ring's model {parts['total']} + 10%")
        check(live <= parts["total"] * LIVE_MARGIN,
              f"{label}: live tensors' peak {live} passes the ring's model "
              f"{parts['total']} + 1%")
        out = {"run": label, "placement": dict(zip("ABC", (where.A, where.B, where.C))),
               "backend": "hash (masked)", "plan": [plan.algorithm, n_ac, n_b], "steps": steps,
               "launches": {k: v for k, v in launches.items() if v}, "triangles": float(got),
               "wall_s": wall, "all_fast_wall_s": wall_fast, "equal_to_scipy": True,
               "peak_alloc_bytes": peak, "peak_live_bytes": live, "model_bytes": parts,
               "card": self.smi, **ring, "times": log.times()}
        emit({"placed_run": out})
        del Lp
        torch.cuda.empty_cache()
        return out

    def refusal_check(self, A, P, plan, pinned) -> None:
        """A pinned stack handed straight to any of the five SpGEMM kernels'
        wrappers without a run device raises, whether every operand is
        pinned or the first lies on the card: without ``device=`` a wrapper
        reads only the card. Given the card, the four streaming wrappers
        read it in place (:meth:`in_place_wrappers`); the BSR x BSR wrapper
        takes no run device and refuses it still."""
        torch, cs = self.torch, self.m["chunk_stream"]
        ch, csr = self.m["chunking"], self.m["csr"]
        Ast = csr.csr_pin(csr.csr_stack([csr.csr_stack(ch.a_strips(pinned["A"], plan.p_ac))]))
        Bst = csr.csr_pin(csr.csr_stack([csr.csr_stack(ch.b_chunks(pinned["B"], plan.p_b))]))
        C0 = csr.csr_pin(cs._sparse_c0_stack(1, plan.n_ac, Ast.n_rows, P.n_cols, 16,
                                             torch.float32, "cpu"))
        pinned_first = {"A": Ast, "a_dense": torch.zeros(1, 1, 4, 8, pin_memory=True),
                        "a_blocks": torch.zeros(2, 4, 4, pin_memory=True)}
        card_first = {"A": csr.CSR(*(t.cuda() for t in (Ast.indptr, Ast.indices, Ast.data)),
                                   Ast.shape, Ast.max_row_nnz),
                      "a_dense": pinned_first["a_dense"].cuda(),
                      "a_blocks": pinned_first["a_blocks"].cuda()}
        r0s, r1s = plan.b_ranges()
        esc, hmod = self.kernels["sparse_accum_spgemm"], self.kernels["hash_accum_spgemm"]
        calls = {
            "sparse_accum_spgemm": lambda f: esc.sparse_accum_spgemm_stream(
                f["A"], Bst, C0, r0s, r1s, order="chunk2", row_cap=16),
            "hash_accum_spgemm": lambda f: hmod.hash_accum_spgemm_stream(
                f["A"], Bst, C0, r0s, r1s, order="chunk2", table_size=16),
            "hash_masked_accum_spgemm": lambda f: hmod.hash_masked_accum_spgemm_stream(
                f["A"], Bst, C0, C0, r0s, r1s, order="chunk2", table_size=16),
            "ranged_spgemm": lambda f: self.kernels["ranged_spgemm"].ranged_spgemm_stream(
                f["a_dense"], *(torch.zeros(*shape, pin_memory=True) for shape in
                                ((1, 2, 4, 4), (1, 1, 4, 4))),
                np.array([0, 4], np.int32), order="chunk1"),
            "bsr_spgemm": lambda f: self.kernels["bsr_spgemm"].bsr_spgemm_blocks(
                f["a_blocks"], torch.zeros(2, 4, 4, pin_memory=True),
                np.zeros((1, 1), np.int32), np.zeros((1, 1), np.int32), nc_pad=1,
                u_max=1, bs=4),
        }
        refused = {"pinned": {}, "first_on_card": {}}
        for kernel, call in calls.items():
            for case, first in (("pinned", pinned_first), ("first_on_card", card_first)):
                try:
                    call(first)
                except ValueError as err:
                    refused[case][kernel] = str(err).split(";")[0]
                # the BSR wrapper's card launch refuses any host operand
                why = ("is on cpu" if (kernel, case) == ("bsr_spgemm", "first_on_card")
                       else "an operand is in pinned host memory")
                check(why in refused[case].get(kernel, ""),
                      f"{kernel}: a pinned operand was not refused ({case})")
        emit({"pinned_refused": refused})
        self.in_place_wrappers()

    # -- slow operands read in place (slow_reads="in_place") ----------------

    def in_place_wrappers(self) -> None:
        """Each of the four streaming wrappers handed pinned stacks and the
        card (``device=``) launches once in place: on brick3d n=8 A x P
        (the masked kernel: A x A masked by A) under a chunk2 2 x 2 plan,
        its result equal bit for bit to the same kernel on card stacks and
        within the stated tolerance of its plain version on the host, its
        launch and in-place counts one each. Pageable host memory has no
        device address (raises); an address inside a pinned allocation
        maps to the same offset in the card's view."""
        torch, b = self.torch, self.m["build"]
        cs, csr, planner = self.m["chunk_stream"], self.m["csr"], self.m["planner"]
        A, _, P = self.m["multigrid"].problem("brick3d", IN_PLACE_CHECK_N, device="cuda")
        half = lambda m: (0, m // 2, m)  # noqa: E731
        plan = planner.ChunkPlan("chunk2", half(A.n_rows), half(A.n_cols), 0.0, 0.0)
        host = lambda st: csr.CSR(*(t.cpu() for t in (st.indptr, st.indices, st.data)),  # noqa: E731
                                  st.shape, st.max_row_nnz)
        Ast, Bst, C0, r0s, r1s, caps = self.stage_csr(A, P, plan)
        table = planner.hash_table_slots(caps.c_max_row_nnz)
        esc, hmod = self.kernels["sparse_accum_spgemm"], self.kernels["hash_accum_spgemm"]
        (mA, mB, mC0, mM, mr0, mr1), mtable, _ = cs.stage_hash_masked(
            A, A, A, plan, self.m["symbolic"].masked_output_caps(A, plan.p_ac).c_pad)
        a, slabs = self.dense_stage(A, P, plan)
        c0 = torch.zeros(a.shape[:3] + (P.n_cols,), device="cuda")
        calls = {
            "sparse_accum_spgemm": (lambda ops, **kw: esc.sparse_accum_spgemm_stream(
                *ops, r0s, r1s, order="chunk2", row_cap=caps.c_max_row_nnz, **kw),
                (Ast, Bst, C0)),
            "hash_accum_spgemm": (lambda ops, **kw: hmod.hash_accum_spgemm_stream(
                *ops, r0s, r1s, order="chunk2", table_size=table, **kw), (Ast, Bst, C0)),
            "hash_masked_accum_spgemm": (lambda ops, **kw: hmod.hash_masked_accum_spgemm_stream(
                *ops, mr0, mr1, order="chunk2", table_size=mtable, **kw), (mA, mB, mC0, mM)),
            "ranged_spgemm": (lambda ops, **kw: self.kernels["ranged_spgemm"].ranged_spgemm_stream(
                *ops, r0s, order="chunk2", **kw), (a, slabs, c0)),
        }
        out = {}
        for kernel, (call, ops) in calls.items():
            dense = kernel == "ranged_spgemm"
            pinned = [csr.tensor_pin(t.cpu()) if dense else csr.csr_pin(host(t)) for t in ops]
            card = call(ops)
            self.reset_counters()
            got = call(pinned, device="cuda")
            launches = self.read_counters()
            check(launches[kernel] == 1 and launches[f"{kernel}/in_place"] == 1,
                  f"{kernel}: in place launched {launches[kernel]} / "
                  f"{launches[f'{kernel}/in_place']} times, once expected")
            plain = call([t.cpu() for t in ops] if dense else [host(t) for t in ops],
                         device="cpu")
            got, card, plain = ([got], [card], [plain]) if dense else (got, card, plain)
            check(all(g.device.type == "cpu" and g.is_pinned() for g in got),
                  f"{kernel}: the in-place output is not in pinned host memory")
            check(all(torch.equal(g, c.cpu()) for g, c in zip(got, card)),
                  f"{kernel}: in place differs from the kernel on card stacks")
            held = (self.hold_dense(f"{kernel}/in_place", got[0], plain[0]) if dense else
                    self.hold_csr(f"{kernel}/in_place", got, plain))
            out[kernel] = {"launches": launches[kernel], **held}
            self.in_place.setdefault(kernel, {})["max_abs_err"] = held["max_abs_err"]
        pinned = torch.zeros(1024, pin_memory=True)
        check(b.device_address(pinned[256:]) == b.device_address(pinned) + 1024,
              "an address inside a pinned allocation maps to another offset")
        try:
            b.device_address(torch.zeros(1024))
            check(False, "pageable host memory was given a device address")
        except ValueError as err:
            out["pageable_refused"] = str(err).split(":")[0]
        emit({"in_place_wrappers": out, "n": IN_PLACE_CHECK_N, "card": self.smi})

    def in_place_models(self, plan, stats, where, backend: str, C, host) -> tuple:
        """(card bytes, link reads) of one in-place call: the card's bytes
        at its peak (``placement.card_bytes`` under ``slow_reads="in_place"``,
        one strip launch's workspace, ``placement.strip_workspace``: the
        merge's slabs a row of the strip and, for a counted ESC launch, its
        work list and global workspace, the most of any strip's; the chunk
        starts), and the bytes its kernels touch of each operand
        (``link_reads``, on ``host``'s pinned operands staged as the
        executor stages them: the sum of the strip launches' reads, which
        is the whole stack's)."""
        key = (plan, backend, id(host["A"]), id(host["B"]))
        if key in self._in_place_models:   # the placements of one plan share them
            workspace, reads = self._in_place_models[key]
            return self.in_place_card(plan, stats, where, C, workspace), reads
        ch, cs, csr = self.m["chunking"], self.m["chunk_stream"], self.m["csr"]
        planner, reads_mod = self.m["planner"], self.m["link_reads"]
        slab, a_stage, c_stage = self.stage_sizes(plan, stats)
        n_ac, n_b = plan.n_ac, plan.n_b
        strips = ch.a_strips(host["A"], plan.p_ac)
        chunks = ch.b_chunks(host["B"], plan.p_b)
        strip_rows, span = strips[0].n_rows, chunks[0].n_rows
        strip_workspace = self.m["placement"].strip_workspace
        if backend == "pallas":
            reads = reads_mod.dense_reads((1, n_ac, strip_rows, host["A"].n_cols + span),
                                          (1, n_b, span, host["B"].n_cols))
            workspace = strip_workspace("pallas", strip_rows=strip_rows, n_b=n_b)
        else:
            one = lambda pieces: (lambda st: csr.CSR(  # noqa: E731
                st.indptr[None], st.indices[None], st.data[None], st.shape,
                st.max_row_nnz))(csr.csr_stack(pieces))
            Ast, Bst = one(strips), one(chunks)
            c_pad = (c_stage - 4 * (strip_rows + 1)) // 8
            C0 = cs._sparse_c0_stack(1, n_ac, strip_rows, host["B"].n_cols, c_pad,
                                     C.dtype, "cpu")
            r0s, r1s = plan.b_ranges()
            order = "chunk2" if plan.algorithm == "chunk2" else "chunk1"
            reads = reads_mod.csr_reads(Ast, Bst, C0, r0s, r1s, order=order)
            row_cap = (planner.hash_table_slots(C.max_row_nnz) if backend == "hash"
                       else max(C.max_row_nnz, 1))
            workspace = strip_workspace(backend, strip_rows=strip_rows, n_b=n_b,
                                        row_cap=row_cap)
            if backend == "sparse":   # each strip launch's own classes
                strip = lambda st, i: csr.CSR(  # noqa: E731
                    st.indptr[:, i:i + 1], st.indices[:, i:i + 1], st.data[:, i:i + 1],
                    st.shape, st.max_row_nnz)
                extra = 0
                for i in range(n_ac):
                    launch = self.kernels["sparse_accum_spgemm"].esc_launch_plan(
                        strip(Ast, i), Bst, strip(C0, i), r0s, r1s, row_cap=row_cap)
                    if launch.split:
                        extra = max(extra, 4 * launch.items.numel()
                                    + 8 * launch.offsets.numel() + launch.workspace_bytes)
                workspace += extra
        self._in_place_models[key] = (workspace, reads)
        return self.in_place_card(plan, stats, where, C, workspace), reads

    def in_place_card(self, plan, stats, where, C, workspace: int) -> dict:
        """``placement.card_bytes`` of an in-place call."""
        slab, a_stage, c_stage = self.stage_sizes(plan, stats)
        return self.m["placement"].card_bytes(
            plan, where, a_stage=a_stage, slab=slab, c_stage=c_stage, workspace=workspace,
            c_bytes=C.nbytes(), slow_reads="in_place")

    def in_place_call(self, label: str, A, B, plan, backend: str, where, fast, *, host,
                      card_ops=None, twin=None, want_routes=None, caps=None,
                      record: bool = True) -> dict:
        """One ``chunked_spgemm(..., slow_reads="in_place")`` with operands
        placed as ``where`` says (pinned host memory for a slow one), gated
        against the same plan's all-fast call ``fast = (C, stats, wall_s)``:
        C equal bit for bit (so within the tolerance of the plain version
        the all-fast call was held to) and where ``where`` puts it, the
        ChunkStats equal, one wrapper launch a strip of the plan, each read
        in place (the ESC kernel's launches by route ``want_routes``, the
        all-fast call's for a one-strip plan, or one a strip on the shared
        route), no ring op and no transfer, and the live tensors' peak on
        the card within the in-place card model plus 1% (for HostPin: less
        the workspace, below A's bytes); the dense slab on its
        ``IN_PLACE_DENSE_PATH``. ``caps`` is the plan's symbolic phase,
        hoisted out of the call. Prints the launches' kernel ms (CUDA
        events, summed over the strips) beside the same kernel's on the card
        operands ``card_ops`` (the all-fast call, again; none given under
        the capacity cap), the modelled bytes read in place and their rate,
        the wall, and the ring twin's copy and compute ms. The first HostPin
        call of a kernel with ``record`` is its in-place row of the kernels
        line. Returns the printed record."""
        torch = self.torch
        chunking, csr, copy_ring = self.m["chunking"], self.m["csr"], self.m["copy_ring"]
        C_fast, stats_fast, wall_fast = fast[:3]
        kernel = self.backend_kernel[backend]
        model, reads = self.in_place_models(plan, stats_fast, where, backend, C_fast, host)
        slow_bytes = self.m["link_reads"].slow_total(reads, where)
        paths = self.kernels["ranged_spgemm"].PATH_LAUNCHES
        path_before = {p: c.count for p, c in paths.items()}
        with copy_ring.RingLog() as log, self.m["build"].LaunchTimer() as timer:
            (C, stats), wall, peak, live = self.memory_traced(
                lambda: chunking.chunked_spgemm(A, B, plan, backend=backend, placement=where,
                                                slow_reads="in_place", caps=caps))
        kernel_ms = timer.ms()
        launches = self.read_counters()
        check(csr.csr_residence(C) == ("pinned" if where.C == "slow" else "card"),
              f"{label}: C is in {csr.csr_residence(C)} memory, placed {where.C}")
        for f in ("indptr", "indices", "data"):
            check(torch.equal(getattr(C, f).cpu(), getattr(C_fast, f).cpu()),
                  f"{label}: C.{f} differs from the all-fast call's")
        check(stats == stats_fast, f"{label}: ChunkStats differ from the all-fast call's")
        n_ac = plan.n_ac   # one launch a strip, each reading in place
        check(launches[kernel] == n_ac
              and launches[f"{kernel}/in_place"] == n_ac * int(bool(where.slow)),
              f"{label}: {launches[kernel]} {kernel} launches, "
              f"{launches[f'{kernel}/in_place']} in place; {n_ac} each (one a strip) expected")
        if kernel == "sparse_accum_spgemm":
            esc = self.kernels[kernel]
            routes = {r: launches[f"{kernel}/{r}"] for r in esc.ROUTES}
            want = want_routes or {r: n_ac * int(r == "shared") for r in esc.ROUTES}
            check(routes == want, f"{label}: ESC launches by route {routes}, the all-fast "
                  f"call's {want}")
        check(not log.rings and not log.transfers,
              f"{label}: {len(log.rings)} rings, {len(log.transfers)} transfers in place")
        check(live <= model["total"] * LIVE_MARGIN,
              f"{label}: live tensors' peak {live} passes the in-place model "
              f"{model['total']} + 1%")
        if len(where.slow) == 3:
            check(live - model["workspace"] < A.nbytes(),
                  f"{label}: live peak {live} less the workspace {model['workspace']} is not "
                  f"below A's {A.nbytes()} bytes")
        path = None
        if backend == "pallas":
            path = [p for p, c in paths.items() if c.count > path_before[p]]
            check(path == [IN_PLACE_DENSE_PATH],
                  f"{label}: the dense slab took {path}, not {IN_PLACE_DENSE_PATH}")
        fast_ms = None
        if card_ops is not None:   # none under the capacity run's cap
            with self.m["build"].LaunchTimer() as fast_timer:
                chunking.chunked_spgemm(*card_ops, plan, backend=backend, caps=caps)
            fast_ms = fast_timer.ms()
        out = {"run": label, "placement": dict(zip("ABC", (where.A, where.B, where.C))),
               "backend": backend, "plan": [plan.algorithm, plan.n_ac, plan.n_b],
               "launches": {k: v for k, v in launches.items() if v},
               "launches_per_call": n_ac, "bit_equal": True,
               "wall_s": wall, "all_fast_wall_s": wall_fast, "kernel_ms": kernel_ms,
               "all_fast_kernel_ms": fast_ms, "dense_path": path,
               "link_read_bytes_model": reads, "slow_read_bytes_model": slow_bytes,
               "slow_read_gb_s": slow_bytes / kernel_ms / 1e6 if kernel_ms > 0 else None,
               "peak_alloc_bytes": peak, "peak_live_bytes": live, "model_bytes": model,
               "card": self.smi}
        if twin is not None:
            times = twin.get("times", {})
            out["ring_twin"] = {"run": twin["run"], "wall_s": twin["wall_s"],
                                "copy_ms": times.get("copy_ms"),
                                "compute_ms": times.get("compute_ms")}
        emit({"in_place_run": out})
        row = self.in_place.setdefault(kernel, {})
        if record and "run" not in row and len(where.slow) == 3:
            row.update({"run": label, "launches": launches[f"{kernel}/in_place"],
                        "ms": kernel_ms, "all_fast_ms": out["all_fast_kernel_ms"],
                        "slow_read_bytes_model": slow_bytes,
                        "slow_read_gb_s": out["slow_read_gb_s"]})
        return out

    def in_place_launched(self) -> None:
        """Each of the four streaming kernels launched in place in an
        in-place call of the placement phase."""
        for kernel in ("ranged_spgemm", "sparse_accum_spgemm", "hash_accum_spgemm",
                       "hash_masked_accum_spgemm"):
            check(self.in_place.get(kernel, {}).get("launches", 0) > 0,
                  f"{kernel}: launched no time in place in the placement phase")

    def in_place_rmat12(self) -> None:
        """The ESC kernel's counted classes read in place: rmat12_sparse's
        L x L (knl, 4 chunks) with L slow in both roles, against that main
        path run."""
        L, plan, (C, stats, wall, launches) = self._rmat12
        esc = self.kernels["sparse_accum_spgemm"]
        routes = {r: launches[f"sparse_accum_spgemm/{r}"] for r in esc.ROUTES}
        Lp = self.m["csr"].csr_pin(L)
        self.in_place_call("rmat12_sparse_inplace_HostPin", Lp, Lp, plan, "sparse",
                           self.m["placement"].TABLE3["HostPin"], (C, stats, wall),
                           host={"A": Lp, "B": Lp}, card_ops=(L, L), want_routes=routes)
        self._rmat12 = None
        del Lp, C
        self.torch.cuda.empty_cache()

    def in_place_dense(self) -> None:
        """The dense slab read in place: brick3d n=16 under its quickstart
        plan (chunk2 6 x 1) in HostPin and DP, against that plan's all-fast
        call, made here."""
        torch = self.torch
        planner, placement, chunking = self.m["planner"], self.m["placement"], self.m["chunking"]
        A, P = self.problem("brick3d", IN_PLACE_DENSE_N)
        crb, budget = self.quickstart_inputs(A, P)
        plan = planner.plan_chunks(A, P, crb, self.m["memory_model"].P100,
                                   fast_limit_bytes=budget)
        check((plan.algorithm, plan.n_ac, plan.n_b) == ("chunk2", 6, 1),
              f"brick3d{IN_PLACE_DENSE_N} dense plan {(plan.algorithm, plan.n_ac, plan.n_b)}")
        caps = self.m["symbolic"].strip_output_caps(A, P, plan.p_ac)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fast = chunking.chunked_spgemm(A, P, plan, backend="pallas", caps=caps)
        torch.cuda.synchronize()
        fast = (*fast, time.perf_counter() - t0)
        pinned = placement.place({"A": A, "B": P}, "slow")
        for name in IN_PLACE_DENSE:
            where = placement.TABLE3[name]
            ops = [pinned[k] if getattr(where, k) == "slow" else m
                   for k, m in (("A", A), ("B", P))]
            self.in_place_call(f"brick3d{IN_PLACE_DENSE_N}_chunk2_pallas_inplace_{name}",
                               *ops, plan, "pallas", where, fast, host=pinned, card_ops=(A, P),
                               caps=caps)
        del pinned, fast
        torch.cuda.empty_cache()

    def in_place_triangle(self, twin=None) -> None:
        """``count_triangles(..., slow_reads="in_place")`` with L slow in
        every role (HostPin), the one-chunk plan of tc_rmat18_fused: the
        count equal to scipy's, one masked launch a strip (one here), each
        in place, no ring op, the card's live peak within the launch's workspace (its work
        list, global tables and flags) plus 1% and, less it, below L's
        bytes. Prints the kernel ms, the modelled bytes read in place and
        the ring twin's times."""
        torch, tri, cs = self.torch, self.m["triangle"], self.m["chunk_stream"]
        csr, placement = self.m["csr"], self.m["placement"]
        L, _, want, _ = self.triangle_graph()
        plan, caps, wall_fast = self.tc_runs[False]
        where = placement.TABLE3["HostPin"]
        Lp = csr.csr_pin(L)
        (Ast, Bst, C0, Mst, r0s, r1s), _, _ = cs.stage_hash_masked(Lp, Lp, Lp, plan,
                                                                   caps.c_pad, caps)
        order = "chunk2" if plan.algorithm == "chunk2" else "chunk1"
        reads = self.m["link_reads"].csr_reads(Ast, Bst, C0, r0s, r1s, order=order, Mst=Mst)
        _, launches_plan = self.kernels["hash_masked_accum_spgemm"].masked_plan(
            Ast, Bst, Mst, r0s, r1s, torch.device("cuda"))
        n_parts, n_grows = launches_plan.parts.shape[0], launches_plan.grows.numel()
        gslots = int(launches_plan.goff[-1]) if n_grows else 1
        placeholders = sum(16 for n in (n_parts, n_parts, n_grows) if n == 0)
        workspace = (20 * n_parts + 4 * n_grows + 8 * (n_grows + 1) + 8 * gslots + 4
                     + 8 * plan.n_b + placeholders)
        model = {"A": 0, "B": 0, "C": 0, "M": 0, "workspace": workspace, "count": 8}
        model["total"] = sum(model.values())
        del Ast, Bst, C0, Mst, launches_plan
        with self.m["copy_ring"].RingLog() as log, self.m["build"].LaunchTimer() as timer:
            got, wall, peak, live = self.memory_traced(lambda: tri.count_triangles(
                Lp, plan=plan, caps=caps, placement=where, slow_reads="in_place"))
        kernel_ms = timer.ms()
        launches = self.read_counters()
        label = "tc_rmat18_fused_inplace_HostPin"
        check(got.dtype == torch.float64 and got.device.type == "cuda" and float(got) == want,
              f"{label}: {float(got)} triangles on {got.device}, scipy counts {want}")
        kernel = "hash_masked_accum_spgemm"
        check(launches[kernel] == plan.n_ac and launches[f"{kernel}/in_place"] == plan.n_ac,
              f"{label}: {launches[kernel]} masked launches, "
              f"{launches[f'{kernel}/in_place']} in place; {plan.n_ac} each (one a strip) "
              "expected")
        check(not log.rings and not log.transfers,
              f"{label}: {len(log.rings)} rings, {len(log.transfers)} transfers in place")
        check(live <= model["total"] * LIVE_MARGIN,
              f"{label}: live tensors' peak {live} passes the in-place model "
              f"{model['total']} + 1%")
        check(live - workspace < L.nbytes(),
              f"{label}: live peak {live} less the workspace {workspace} is not below "
              f"L's {L.nbytes()} bytes")
        slow_bytes = self.m["link_reads"].slow_total(reads, where)
        with self.m["build"].LaunchTimer() as fast_timer:   # the all-fast call, again
            tri.count_triangles(L, plan=plan, caps=caps)
        out = {"run": label, "placement": dict(zip("ABC", (where.A, where.B, where.C))),
               "backend": "hash (masked)", "plan": [plan.algorithm, plan.n_ac, plan.n_b],
               "launches": {k: v for k, v in launches.items() if v}, "triangles": float(got),
               "equal_to_scipy": True, "wall_s": wall, "all_fast_wall_s": wall_fast,
               "kernel_ms": kernel_ms, "all_fast_kernel_ms": fast_timer.ms(),
               "link_read_bytes_model": reads,
               "slow_read_bytes_model": slow_bytes,
               "slow_read_gb_s": slow_bytes / kernel_ms / 1e6 if kernel_ms > 0 else None,
               "peak_alloc_bytes": peak, "peak_live_bytes": live, "model_bytes": model,
               "card": self.smi}
        if twin is not None:
            times = twin.get("times", {})
            out["ring_twin"] = {"run": twin["run"], "wall_s": twin["wall_s"],
                                "copy_ms": times.get("copy_ms"),
                                "compute_ms": times.get("compute_ms")}
        emit({"in_place_run": out})
        self.in_place.setdefault(kernel, {}).update(
            {"run": label, "launches": launches[f"{kernel}/in_place"], "ms": kernel_ms,
             "all_fast_ms": out["all_fast_kernel_ms"], "slow_read_bytes_model": slow_bytes,
             "slow_read_gb_s": out["slow_read_gb_s"]})
        del Lp
        torch.cuda.empty_cache()

    def capacity_run(self) -> None:
        """brick3d n=80 all slow through the hash ring at budget/12 under an
        allocator cap whose headroom over what is reserved is the ring's
        byte model plus 25% plus one 20 MiB segment, below half of A's
        bytes: placing A on the card must raise OutOfMemoryError, and the
        all-slow call must complete and equal the uncapped all-fast call;
        then the same call read in place (:meth:`in_place_call`: one launch
        a strip, the live peak within one strip's workspace plus 1%, the
        reserved bytes under the cap), and the Galerkin product through the
        ring and in place (:meth:`capacity_galerkin`,
        :meth:`capacity_galerkin_in_place`).
        It runs before every other phase: what the allocator reserves is
        then what it holds, so the cap leaves no cached segment that A could
        fit into. The all-fast C waits in pinned memory."""
        torch = self.torch
        planner, chunking, placement = self.m["planner"], self.m["chunking"], self.m["placement"]
        t_run = t0 = time.perf_counter()
        A, R, P = self.m["multigrid"].problem("brick3d", CAPACITY_N, device="cuda")
        problem_s = time.perf_counter() - t0
        crb, budget = self.quickstart_inputs(A, P)
        plan = planner.plan_chunks(A, P, crb, self.m["memory_model"].P100,
                                   fast_limit_bytes=budget / CAPACITY_DIV)
        check((plan.algorithm, plan.n_ac, plan.n_b) == CAPACITY_PLAN,
              f"brick3d{CAPACITY_N} at budget/{CAPACITY_DIV} plans "
              f"{(plan.algorithm, plan.n_ac, plan.n_b)}")
        # the symbolic phase once, for both calls
        caps = self.m["symbolic"].strip_output_caps(A, P, plan.p_ac)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        C_fast, stats_fast = chunking.chunked_spgemm(A, P, plan, backend="hash", caps=caps)
        torch.cuda.synchronize()
        wall_fast = time.perf_counter() - t0
        err = self.scipy_check(A, P, C_fast)
        check(err <= SCIPY_RTOL, f"brick3d{CAPACITY_N}: relative error {err} vs scipy")
        pinned = placement.place({"A": A, "B": P, "C": C_fast, "R": R}, "slow")
        a_bytes = A.nbytes()
        model = self.placed_model(plan, stats_fast, placement.ALL_SLOW, "hash", C_fast)
        galerkin = self.capacity_galerkin_plan(A, P, R, budget / CAPACITY_GALERKIN_DIV)
        del A, P, R, C_fast
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        check(torch.cuda.memory_allocated() == 0,
              f"capacity run: {torch.cuda.memory_allocated()} bytes stay allocated on "
              "the card under the cap")
        headroom = model["total"] * CAP_MARGIN + CAP_SEGMENT
        check(headroom < a_bytes / 2, f"capacity run: headroom {headroom} is not below "
              f"half of A's {a_bytes} bytes")
        total = torch.cuda.get_device_properties(0).total_memory
        label = f"brick3d{CAPACITY_N}_capacity_hash_HostPin"
        torch.cuda.set_per_process_memory_fraction((reserved + headroom) / total)
        try:
            oom = None
            try:
                placement.place(pinned["A"], "fast")
            except torch.OutOfMemoryError as exc:
                oom = str(exc).splitlines()[0]
            check(oom is not None, "capacity run: A fits on the card under the cap")
            out = self.placed_call(label, pinned["A"], pinned["B"], plan, "hash",
                                   placement.ALL_SLOW, (pinned["C"], stats_fast, wall_fast),
                                   caps=caps)
            peak_reserved = torch.cuda.max_memory_reserved()
            # the same call read in place: one launch a strip, one strip's
            # workspace on the card; C held to the all-fast C, which the
            # ring's was held to bit for bit
            torch.cuda.reset_peak_memory_stats()
            in_place = self.in_place_call(f"{label}_inplace", pinned["A"], pinned["B"], plan,
                                          "hash", placement.ALL_SLOW,
                                          (pinned["C"], stats_fast, wall_fast), host=pinned,
                                          twin=out, caps=caps, record=False)
            in_place_reserved = torch.cuda.max_memory_reserved()
            check(in_place_reserved <= reserved + headroom,
                  f"{label}_inplace: reserved {in_place_reserved} passes the cap "
                  f"{reserved + headroom}")
            C_ring = self.capacity_galerkin(pinned, galerkin, reserved + headroom, oom)
            self.capacity_galerkin_in_place(pinned, galerkin, reserved + headroom, C_ring)
            del C_ring
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)
        emit({"capacity_run": label, "A_bytes": a_bytes, "reserved_before": reserved,
              "headroom_bytes": headroom, "cap_bytes": reserved + headroom,
              "peak_reserved_bytes": peak_reserved, "oom_on_place_A_fast": oom,
              "peak_alloc_bytes": out["peak_alloc_bytes"], "problem_s": problem_s,
              "in_place_peak_live_bytes": in_place["peak_live_bytes"],
              "in_place_model_bytes": in_place["model_bytes"]["total"],
              "in_place_peak_reserved_bytes": in_place_reserved,
              "scipy_rel_err": err, "capacity_run_s": time.perf_counter() - t_run,
              "card": self.smi})
        del pinned
        torch.cuda.empty_cache()

    def capacity_galerkin_plan(self, A, P, R, limit: float) -> dict:
        """The capacity Galerkin run's plan, caps and per-hop ring models,
        made on the card operands before the cap: ``plan_pipeline`` at
        ``limit`` (budget / ``CAPACITY_GALERKIN_DIV``), which must spill T and
        chunk both hops, and each hop's ``placement.card_bytes`` with
        every operand slow (hash: the strips' rows times the hop's table of
        8-byte slots plus a row pointer), from its planned events, through
        the ring and read in place (one strip launch's workspace)."""
        planner, symbolic, cs = self.m["planner"], self.m["symbolic"], self.m["chunk_stream"]
        t0 = time.perf_counter()
        tp = symbolic.spgemm_pattern_host(A, P)
        plan = planner.plan_pipeline(A, P, R, self.m["memory_model"].P100,
                                     fast_limit_bytes=limit, t_pattern=tp)
        caps = symbolic.pipeline_output_caps(A, P, R, plan.plan1.p_ac, plan.plan2.p_ac,
                                             t_pattern=tp)
        plan_s = time.perf_counter() - t0
        check(not plan.t_resident, "capacity Galerkin: the plan keeps T resident")
        check("whole_fast" not in (plan.plan1.algorithm, plan.plan2.algorithm),
              "capacity Galerkin: a whole_fast hop would need its operands whole")
        models, in_place = {}, {}
        for hop, hplan, hcaps, (X, Y) in (("hop1", plan.plan1, caps.hop1, (A, P)),
                                          ("hop2", plan.plan2, caps.hop2, (R, tp))):
            env = self.m["chunking"].instance_envelope(X, Y, hplan, caps=hcaps)
            strip = (env.strip_rows + 1) * 4 + env.strip_nnz_cap * 8
            slab = (env.chunk_rows + 1) * 4 + env.chunk_nnz_cap * 8
            c_stage = cs._c_strip_nbytes(env.strip_rows, hcaps.c_pad, A.dtype)
            rows = max(e - s for s, e in zip(hplan.p_ac[:-1], hplan.p_ac[1:]))
            table = planner.hash_table_slots(hcaps.c_max_row_nnz)
            models[hop] = self.m["placement"].card_bytes(
                hplan, self.m["placement"].ALL_SLOW, a_stage=strip, slab=slab,
                c_stage=c_stage, workspace=rows * (table * 8 + 4), c_bytes=0)
            in_place[hop] = self.m["placement"].card_bytes(
                hplan, self.m["placement"].ALL_SLOW, a_stage=strip, slab=slab,
                c_stage=c_stage, c_bytes=0, slow_reads="in_place",
                workspace=self.m["placement"].strip_workspace(
                    "hash", strip_rows=env.strip_rows, n_b=hplan.n_b, row_cap=table))
        # T's pattern (on A's device) leaves the card before the cap
        caps = dataclasses.replace(caps, t_pattern=self.m["csr"].csr_pin(caps.t_pattern))
        del tp
        return {"plan": plan, "caps": caps, "plan_s": plan_s, "models": models,
                "in_place_models": in_place, "t_nnz": caps.t_nnz}

    def capacity_galerkin(self, pinned: dict, galerkin: dict, cap_bytes: int, oom) -> None:
        """``brick3d80_capacity_galerkin_hash_HostPin``: R (A P) of brick3d
        n=80 with A, P, R and C in pinned host memory and T spilled there,
        through the hash ring, under the capacity run's allocator cap (where
        placing A on the card raised ``oom``): the plan chunks both hops, C
        is within SCIPY_RTOL of scipy's R (A P), each hop's ring moves its
        slow operands' events, and the peak allocation stays under the cap.
        Prints the plan, the bytes each way, copy and compute ms, the share
        of copy time under compute, the peak against each hop's
        ``placement.card_bytes`` and the wall."""
        torch, pipe, placement = self.torch, self.m["pipeline"], self.m["placement"]
        label = f"brick3d{CAPACITY_N}_capacity_galerkin_hash_HostPin"
        plan, caps = galerkin["plan"], galerkin["caps"]
        check(oom is not None, f"{label}: A fits on the card under the cap")
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        self.reset_counters()
        t0 = time.perf_counter()
        with self.m["copy_ring"].RingLog(timed=True) as log:
            C, stats = pipe.pipeline_spgemm(pinned["A"], pinned["B"], pinned["R"], plan,
                                            backend="hash", caps=caps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - before
        peak_reserved = torch.cuda.max_memory_reserved()
        launches = self.read_counters()
        check(self.m["csr"].csr_residence(C) == "pinned", f"{label}: C is not pinned")
        check(peak_reserved <= cap_bytes and before + peak <= cap_bytes,
              f"{label}: peak {before + peak} (reserved {peak_reserved}) passes the cap "
              f"{cap_bytes}")
        hops = self.placed_hops(label, log, plan, caps, stats, placement.PIPELINE_TABLE3[
            "HostPin"], "hash")
        steps = sum(h["steps"] for h in hops.values())
        check(launches["hash_accum_spgemm"] == steps,
              f"{label}: {launches['hash_accum_spgemm']} hash launches, {steps} steps")
        t0 = time.perf_counter()
        err = self.scipy_check(pinned["A"], pinned["B"], C, R=pinned["R"])
        scipy_s = time.perf_counter() - t0
        check(err <= SCIPY_RTOL, f"{label}: relative error {err} vs scipy")
        emit({"placed_run": {
            "run": label, "problem": "brick3d", "n": CAPACITY_N, "backend": "hash",
            "placement": dataclasses.asdict(placement.PIPELINE_TABLE3["HostPin"]),
            "plan": {"hop1": [plan.plan1.algorithm, plan.plan1.n_ac, plan.plan1.n_b],
                     "hop2": [plan.plan2.algorithm, plan.plan2.n_ac, plan.plan2.n_b],
                     "t_resident": plan.t_resident, "t_bytes": plan.t_bytes},
            "nnz_T": galerkin["t_nnz"], "nnz_C": C.nnz(), "cap_bytes": cap_bytes,
            "oom_on_place_A_fast": oom, "peak_alloc_bytes": peak,
            "peak_reserved_bytes": peak_reserved,
            "model_bytes": {h: m["total"] for h, m in galerkin["models"].items()},
            "launches": {k: v for k, v in launches.items() if v}, "hops": hops,
            "spill_bytes": stats.spill_bytes, "wall_s": wall, "plan_s": galerkin["plan_s"],
            "scipy_s": scipy_s, "scipy_rel_err": err, "card": self.smi}})
        return C

    def capacity_galerkin_in_place(self, pinned: dict, galerkin: dict, cap_bytes: int,
                                   C_ring) -> None:
        """``brick3d80_capacity_galerkin_hash_HostPin_inplace``: the capacity
        Galerkin call read in place (``slow_reads="in_place"``), under the
        same cap: C equal bit for bit to the ring run's ``C_ring`` and
        pinned, one hash launch a strip of each hop, each in place, no ring
        op, the live tensors' peak within the larger hop's in-place model
        (one strip's workspace) plus 1%, and the reserved bytes under the
        cap. Prints the launches' kernel ms beside the ring run's wall."""
        torch, pipe = self.torch, self.m["pipeline"]
        label = f"brick3d{CAPACITY_N}_capacity_galerkin_hash_HostPin_inplace"
        plan, caps = galerkin["plan"], galerkin["caps"]
        torch.cuda.reset_peak_memory_stats()
        with self.m["copy_ring"].RingLog() as log, self.m["build"].LaunchTimer() as timer:
            (C, stats), wall, peak, live = self.memory_traced(lambda: pipe.pipeline_spgemm(
                pinned["A"], pinned["B"], pinned["R"], plan, backend="hash", caps=caps,
                slow_reads="in_place"))
        kernel_ms = timer.ms()
        peak_reserved = torch.cuda.max_memory_reserved()
        launches = self.read_counters()
        check(self.m["csr"].csr_residence(C) == "pinned", f"{label}: C is not pinned")
        for f in ("indptr", "indices", "data"):
            check(torch.equal(getattr(C, f), getattr(C_ring, f)),
                  f"{label}: C.{f} differs from the ring run's")
        want = plan.plan1.n_ac + plan.plan2.n_ac
        check(launches["hash_accum_spgemm"] == want
              and launches["hash_accum_spgemm/in_place"] == want,
              f"{label}: {launches['hash_accum_spgemm']} hash launches, "
              f"{launches['hash_accum_spgemm/in_place']} in place; {want} (the strips) expected")
        check(not log.rings and not log.transfers,
              f"{label}: {len(log.rings)} rings, {len(log.transfers)} transfers in place")
        model = max(m["total"] for m in galerkin["in_place_models"].values())
        check(live <= model * LIVE_MARGIN,
              f"{label}: live tensors' peak {live} passes the in-place model {model} + 1%")
        check(peak_reserved <= cap_bytes,
              f"{label}: reserved {peak_reserved} passes the cap {cap_bytes}")
        emit({"in_place_run": {
            "run": label, "problem": "brick3d", "n": CAPACITY_N, "backend": "hash",
            "plan": {"hop1": [plan.plan1.algorithm, plan.plan1.n_ac, plan.plan1.n_b],
                     "hop2": [plan.plan2.algorithm, plan.plan2.n_ac, plan.plan2.n_b]},
            "launches": {k: v for k, v in launches.items() if v}, "bit_equal_to_ring": True,
            "cap_bytes": cap_bytes, "peak_alloc_bytes": peak, "peak_live_bytes": live,
            "peak_reserved_bytes": peak_reserved,
            "model_bytes": {h: m["total"] for h, m in galerkin["in_place_models"].items()},
            "kernel_ms": kernel_ms, "wall_s": wall, "card": self.smi}})
        del C

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
        numbers["device_ms"], numbers["device_incomplete_traces"], _, _ = kernel_device_split(
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
        plain version, on the ``SPMM_PATH`` path (chosen and counted): times by
        launch events, of the wrapper call (its table work included), by the
        profiler over complete traces (``device_ms``) and by CUDA events
        around five back-to-back calls (``queued_ms``). ``record`` adds the
        plain version and two library yardsticks: ``torch.sparse_bsr_tensor``
        times X (the blocks' zeros included) and ``torch.sparse.mm`` of A as
        CSR by X (the same Y without them)."""
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
        path = mod.choose_path(blocks, X, BSR_BLOCK, SPMM_COLS)
        check(path == SPMM_PATH, f"bsr_spmm/{label}: path {path}, expected {SPMM_PATH}")
        before = mod.PATH_LAUNCHES[path].count
        got = run()
        check(mod.PATH_LAUNCHES[path].count == before + 1,
              f"bsr_spmm/{label}: the {path} path launched no kernel")
        numbers = {"path": path, "warps": mod.GROUP_WARPS,
                   "max_abs_err": self.hold_tiles(f"bsr_spmm/{label}", got, plain()),
                   "ms": self.launch_ms(run), "wrapper_ms": cuda_ms(torch, run)}
        del got
        (numbers["device_ms"], numbers["device_incomplete_traces"], _,
         numbers["incomplete_traces_held"]) = kernel_device_split(
            torch, run, TRACE_NAMES["bsr_spmm"], 1)
        numbers["queued_ms"] = queued_ms(torch, run)
        if record:
            numbers["plain_ms"] = cuda_ms(torch, plain, reps=3)
        n_blocks = Ab.n_blocks()
        moved = (n_blocks * BSR_BLOCK * BSR_BLOCK * 4 + nbytes(sl, co) + nbytes(X)
                 + Ab.mb * BSR_BLOCK * SPMM_COLS * 4)
        flops = meta.flops * SPMM_COLS
        library = library_csr = (None,) * 4
        if record:
            values = Ab.blocks[:n_blocks]
            t = torch.sparse_bsr_tensor(Ab.block_indptr, Ab.block_indices[:n_blocks],
                                        values, size=Ab.shape)
            nnz = A.nnz()
            t_csr = torch.sparse_csr_tensor(A.indptr, A.indices[:nnz], A.data[:nnz],
                                            size=A.shape)
            library, library_csr = (self.library_call(lambda: t @ X),
                                    self.library_call(lambda: torch.sparse.mm(t_csr, X)))
        self.finish_phase("bsr_spmm", label, {"dense_x": numbers}, "dense_x", moved,
                          flops, library,
                          {"block": BSR_BLOCK, "mb": Ab.mb, "u_max": meta.u_max,
                           "n_blocks": n_blocks, "x": list(X.shape), "bn": SPMM_COLS,
                           "library_csr": library_csr},
                          record, 1)
        if record:
            bound = self.phase["bsr_spmm"]["bound_ms"]
            csr = library_fields(library_csr, bound)
            self.phase["bsr_spmm"].update(
                {k: numbers[k] for k in ("queued_ms", "path", "warps")},
                library_call="torch.sparse_bsr_tensor @ X",
                library_csr_call="torch.sparse.mm(A as CSR, X)",
                library_csr_ms=csr["library_ms"],
                library_csr_device_ms=csr["library_device_ms"],
                library_csr_lost=csr["library_lost"])

    def library_call(self, fn) -> tuple:
        """One library yardstick: (wall ms, device ms, its traces, error
        text if torch refuses)."""
        try:
            return (cuda_ms(self.torch, fn), *device_ms(self.torch, fn), None)
        except RuntimeError as err:   # torch refuses: record why, time nothing
            return None, None, None, str(err).splitlines()[0]

    def spmm_edge_phase(self) -> None:
        """The BSR x dense kernel against its plain version off the main
        path's shape, in f32 and bf16, each case's path chosen and counted:
        the group path at bs 4 (nf 64: half a column tile) and at bs 16 (nf
        256: two tiles); at bs 8 on a matrix with empty block rows, a run of
        sentinel-only rows that fills a whole group at G 2, 3, 8 or 12, and
        mb a multiple of none of them, also with every row's table shuffled
        (sentinels inside rows, columns out of order). The generic path at
        bs 5 and at a 64-column tile."""
        torch, mod, ops = self.torch, self.kernels["bsr_spmm"], self.m["ops"]
        rng = np.random.default_rng(SPMM_EDGE_SEED)
        empty = [3, *range(12, 36)]   # rows 12-35 hold a whole group of 2, 3, 8 or 12
        # (label, bs, block rows, block columns, nf, tile width, empty rows, shuffle)
        cases = [("bs4_nf64", 4, 29, 23, 64, 128, [], False),
                 ("bs16_nf256", 16, 19, 17, 256, 128, [], False),
                 ("bs8_empty_rows", 8, 67, 41, 128, 128, empty, False),
                 ("bs8_shuffled", 8, 67, 41, 128, 128, empty, True),
                 ("bs5_generic", 5, 21, 19, 96, 128, [2], False),
                 ("bs8_bn64_generic", 8, 23, 17, 128, 64, [], False)]
        result = []
        for label, bs, mb, kb, nf, bn, rows_empty, shuffle in cases:
            mask = rng.random((mb, kb)) < 0.3
            mask[rows_empty] = False
            dense = (np.kron(mask, np.ones((bs, bs))) * rng.standard_normal((mb * bs, kb * bs))
                     / np.sqrt(bs * max(mask.sum(1).max(), 1))).astype(np.float32)
            Ab = self.m["bsr"].bsr_from_dense(dense, bs, device="cuda")
            meta = mod.bsr_spmm_symbolic(Ab)
            sl, co = meta.a_slots, meta.a_cols
            if shuffle:
                perm = np.argsort(rng.random(sl.shape), axis=1)
                sl, co = np.take_along_axis(sl, perm, 1), np.take_along_axis(co, perm, 1)
            sl, co = torch.from_numpy(sl).cuda(), torch.from_numpy(co).cuda()
            x = torch.from_numpy(rng.standard_normal((kb * bs, nf)).astype(np.float32)).cuda()
            blocks = ops._with_zero_block(Ab.blocks)
            errs, paths = {}, {}
            for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                b_d, x_d = blocks.to(dtype), x.to(dtype)
                want = mod.bsr_spmm_plain(b_d, x_d, sl, co, mb, meta.u_max, bs)
                path = mod.choose_path(b_d, x_d, bs, bn)
                check(path == ("generic" if label.endswith("generic") else "group"),
                      f"bsr_spmm/edge/{label}: path {path}")
                paths[dname] = path
                before = mod.PATH_LAUNCHES[path].count
                got = mod.bsr_spmm_blocks(b_d, x_d, sl, co, mb, meta.u_max, bs, bn)
                check(mod.PATH_LAUNCHES[path].count == before + 1,
                      f"bsr_spmm/edge/{label}/{dname}: the {path} path launched nothing")
                errs[dname] = self.hold_tiles(f"bsr_spmm/edge/{label}/{dname}", got, want)
            self.note_err("bsr_spmm", max(errs.values()))
            live = meta.a_slots != blocks.shape[0] - 1
            result.append({"label": label, "bs": bs, "mb": mb, "block_cols": kb, "nf": nf,
                           "bn": bn, "u_max": meta.u_max, "n_blocks": Ab.n_blocks(),
                           "empty_block_rows": int((~live.any(1)).sum()),
                           "shuffled": shuffle, "paths": paths, "max_abs_err": errs})
        emit({"edge_phase": "bsr_spmm", "cases": result})

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
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        C, stats = self.m["chunking"].chunked_spgemm(A, P, plan, backend="bsr")
        torch.cuda.synchronize()
        exec_s = time.perf_counter() - t0
        self.fast_runs[("brick3d", 48, plan, "bsr")] = (
            C, stats, exec_s, torch.cuda.max_memory_allocated() - before)
        launches = self.read_counters()
        check(launches["bsr_spgemm"] > 0, f"{label}: bsr_spgemm was not launched")
        self.launches["bsr_spgemm"] = launches["bsr_spgemm"]
        scipy_err = self.scipy_check(A, P, C, key=("ap", "brick3d", 48))
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
        check(launches[f"bsr_spmm/{SPMM_PATH}"] == launches["bsr_spmm"],
              f"{label}: {launches['bsr_spmm']} bsr_spmm launches, "
              f"{launches[f'bsr_spmm/{SPMM_PATH}']} on the {SPMM_PATH} path")
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

    # -- the batched entry point and the SpGEMM service --------------------

    def rescaled(self, m, rng):
        """``m`` with each value scaled by a factor in [0.5, 1.5) from
        ``rng``: the same structure, the values of another instance."""
        factors = rng.uniform(0.5, 1.5, m.nnz_pad).astype(np.float32)
        return dataclasses.replace(m, data=m.data * self.torch.from_numpy(factors).to(m.device))

    def rmat_l(self, seed: int):
        """L of rmat(12, 16, seed), degree-sorted lower triangle, on the card."""
        graphs = self.m["graphs"]
        return graphs.lower_triangular_degree_sorted(
            graphs.rmat(BATCH_RMAT_SCALE, RMAT_EDGE_FACTOR, seed=seed, device="cuda"))

    def batches(self) -> dict:
        """The two width-8 batches: (a) brick3d n=16 A x P, one structure,
        values rescaled per instance (numpy seeds BATCH_SEED + w), under a
        chunk1 plan of 4 strips over ``plan_knl``'s chunks at |P| / 3; (b)
        L x L of eight RMAT graphs (``BATCH_RMAT_SEEDS``), eight structures,
        under a one-strip chunk2 plan over ``plan_knl``'s chunks of the
        first graph at |L| / 3 (the scan backend expands a strip's padded
        entries times the densest B row a step: one strip is the fewest
        entries)."""
        planner = self.m["planner"]
        A, P = self.problem("brick3d", 16)
        pairs_a = []
        for w in range(BATCH_WIDTH):
            rng = np.random.default_rng(BATCH_SEED + w)
            pairs_a.append((self.rescaled(A, rng), self.rescaled(P, rng)))
        n = A.n_rows
        p_b = planner.plan_knl(A, P, float(planner.row_bytes_csr(P).sum()) / 3).p_b
        plan_a = planner.ChunkPlan("chunk1", (0, n // 4, n // 2, 3 * n // 4, n), p_b, 0.0, 0.0)
        Ls = [self.rmat_l(s) for s in BATCH_RMAT_SEEDS]
        n = Ls[0].n_rows
        plan_b = planner.ChunkPlan("chunk2", (0, n), self.rmat_plan(Ls[0]).p_b, 0.0, 0.0)
        return {"brick3d16": ([a for a, _ in pairs_a], [p for _, p in pairs_a], plan_a),
                "rmat12": (Ls, Ls, plan_b)}

    def device_kernel_counts(self, fn, names, expected: int, tries: int = 6) -> list:
        """Device activities whose name holds one of ``names`` in traces of
        one call of ``fn``, until a trace holds ``expected`` of them (up to
        ``tries``; traces with no device activity at all are dropped ones
        and not counted). A lost activity makes a count smaller, an extra
        launch larger."""
        counts = []
        for _ in range(tries):
            by_name = device_by_name(profiled(self.torch, fn))
            if not by_name:
                continue
            counts.append(sum(n for name, (_, n) in by_name.items()
                              if any(k in name for k in names)))
            if counts[-1] == expected:
                break
        return counts

    def width_pair(self, kernel: str, label: str, order: str, run8, run1, names,
                   expected) -> dict:
        """One kernel call at width 8 and the same call at width 1: launches
        by the wrapper's count, which must be equal, and by the profiler's
        device activities, which must pass ``expected`` kernels (the
        width-1 call's by construction; or a pair, width 8's and width 1's,
        where the ESC merge routes steps by their keys) in no trace of
        either width, and ms by launch events. The profiler loses
        activities of some calls, so a count under ``expected`` is
        recorded, not refused."""
        expect8, expect1 = expected if isinstance(expected, tuple) else (expected, expected)
        counter = self.counters[kernel]
        calls = []
        for fn in (run8, run1):
            before = counter.count
            fn()
            calls.append(counter.count - before)
        check(calls[0] == calls[1] > 0, f"{kernel}/batched/{label}/{order}: {calls[0]} "
              f"wrapper launches at width {BATCH_WIDTH}, {calls[1]} at width 1")
        device = [self.device_kernel_counts(fn, names, want)
                  for fn, want in ((run8, expect8), (run1, expect1))]
        for width, counts, want in zip((BATCH_WIDTH, 1), device, (expect8, expect1)):
            check(max(counts, default=0) <= want,
                  f"{kernel}/batched/{label}/{order}: device kernels per call at width "
                  f"{width} {counts}, more than {want}")
        ms8, ms1 = self.launch_ms(run8), self.launch_ms(run1)
        return {"wrapper_launches": calls[0], "device_kernels": [expect8, expect1],
                "device_counts": {"width8": device[0], "width1": device[1]},
                "device_complete": [want in c for c, want in zip(device, (expect8, expect1))],
                "ms": ms8, "ms_per_instance": ms8 / BATCH_WIDTH, "ms_width1": ms1}

    def note_batched(self, kernel: str, label: str, err: float, numbers: dict) -> None:
        self.note_err(kernel, err)
        row = self.batched.setdefault(kernel, {"width": BATCH_WIDTH, "max_abs_err": 0.0,
                                               "ms": {}, "ms_per_instance": {}})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["ms"][label] = numbers["ms"]
        row["ms_per_instance"][label] = numbers["ms_per_instance"]

    def batched_kernel_phase(self, label: str, As, Bs, plan, dense: bool) -> None:
        """The four sparse kernels (the dense slab only where ``dense``) on
        the width-8 stacks ``chunked_spgemm_batched`` stages for ``plan``
        (the batch's union envelope), in both orders, against their plain
        versions at width 8; launches and ms beside the width-1 call of
        instance 0 at the same envelope (``width_pair``)."""
        torch, ch, cs = self.torch, self.m["chunking"], self.m["chunk_stream"]
        csr = self.m["csr"]
        t0 = time.perf_counter()
        env = ch.batch_envelope(As, Bs, plan)
        benv = ch.batch_envelope(As, Bs, plan, block_size=BSR_BLOCK)
        self.batch_envs[label] = env
        Ast, _ = cs._stage_strips_batched(As, plan, env)
        Bst, _ = cs._stage_chunks_batched(Bs, plan, env)
        C0 = cs._sparse_c0_stack(len(As), plan.n_ac, env.strip_rows, Bs[0].n_cols,
                                 env.c_pad, As[0].dtype, As[0].device)
        stage_s = time.perf_counter() - t0
        r0s, r1s = plan.b_ranges()
        row_cap = env.c_max_row_nnz
        first = lambda st: csr.CSR(st.indptr[:1], st.indices[:1], st.data[:1],  # noqa: E731
                                   st.shape, st.max_row_nnz)
        esc = self.kernels["sparse_accum_spgemm"]
        result = {}
        # the hash plain version tables every row's products at once (rows x
        # a_mrn x b_mrn entries): past HASH_PLAIN_MAX the kernel is held to
        # the ESC plain version instead, whose output is the same stacked CSR
        products = Ast.indptr.shape[0] * plan.n_ac * Ast.n_rows * Ast.max_row_nnz \
            * Bst.max_row_nnz
        for kernel in ("sparse_accum_spgemm", "hash_accum_spgemm"):
            run, plain = self.csr_runners(kernel, Ast, Bst, C0, r0s, r1s, row_cap)
            run1, _ = self.csr_runners(kernel, first(Ast), first(Bst), first(C0), r0s, r1s,
                                       row_cap)
            plain_of = kernel
            if kernel == "hash_accum_spgemm" and products > HASH_PLAIN_MAX:
                _, plain = self.csr_runners("sparse_accum_spgemm", Ast, Bst, C0, r0s, r1s,
                                            row_cap)
                plain_of = "sparse_accum_spgemm"
            routes = None
            if kernel == "sparse_accum_spgemm":
                # the steps counted and launched by class where the launch-wide
                # bound passes shared memory (the RMAT batch's)
                launch8 = esc.esc_launch_plan(Ast, Bst, C0, r0s, r1s, row_cap=row_cap)
                launch1 = esc.esc_launch_plan(first(Ast), first(Bst), first(C0), r0s, r1s,
                                              row_cap=row_cap)
                routes = {"width8": launch8.routes, "width1": launch1.routes,
                          "launches_by_class": {"width8": launch8.launches,
                                                "width1": launch1.launches},
                          "work_cap": launch8.work_cap,
                          "global_workspace_bytes": launch8.workspace_bytes,
                          "bound_row_smem_bytes": esc.esc_workspace(
                              Ast.max_row_nnz, Bst.max_row_nnz, max(row_cap, 1))[1]}
                global_before = esc.ROUTE_LAUNCHES["global"].count
            # the plain versions add every strip's chunks in the same sequence in
            # both orders: one plain result holds both
            want = plain("chunk1")
            orders = {}
            for order in ORDERS:
                if routes is not None:
                    expected = (esc.kernels_per_call(order, plan.n_b, launch8),
                                esc.kernels_per_call(order, plan.n_b, launch1))
                else:
                    expected = esc.kernels_per_call(order, plan.n_b)
                orders[order] = self.hold_csr(f"{kernel}/batched/{label}/{order}", run(order),
                                              want)
                orders[order].update(self.width_pair(
                    kernel, label, order, lambda: run(order), lambda: run1(order),
                    TRACE_NAMES["csr_accum"], expected))
            if routes is not None:
                routes["global_launches"] = esc.ROUTE_LAUNCHES["global"].count - global_before
                if label == "rmat12":
                    check(routes["global_launches"] > 0,
                          f"{kernel}/batched/{label}: the global class launched no time")
            err = max(o["max_abs_err"] for o in orders.values())
            self.note_batched(kernel, label, err, orders["chunk1" if plan.algorithm != "chunk2"
                                                        else "chunk2"])
            result[kernel] = {**orders, "plain_of": plain_of, "row_products_bound": products,
                              "esc_routes": routes}
            del want
        if dense:
            mod = self.kernels["ranged_spgemm"]
            a = cs._dense_stack(Ast, levels=2, pad_cols=Bst.n_rows)
            slabs = cs._dense_stack(Bst, levels=2)
            c0 = torch.zeros(a.shape[:3] + (Bst.n_cols,), dtype=torch.float32, device=a.device)
            orders, outs = {}, {}
            for order in ORDERS:
                outs[order] = mod.ranged_spgemm_stream(a, slabs, c0, r0s, order=order)
                orders[order] = self.hold_dense(
                    f"ranged_spgemm/batched/{label}/{order}", outs[order],
                    mod.ranged_spgemm_plain(a, slabs, c0, r0s, order=order))
                orders[order].update(self.width_pair(
                    "ranged_spgemm", label, order,
                    lambda: mod.ranged_spgemm_stream(a, slabs, c0, r0s, order=order),
                    lambda: mod.ranged_spgemm_stream(a[:1], slabs[:1], c0[:1], r0s,
                                                     order=order),
                    ("ranged_dense_kernel",), 1 if order == "chunk1" else plan.n_b))
            check(bool(torch.equal(outs["chunk1"], outs["chunk2"])),
                  f"ranged_spgemm/batched/{label}: chunk1 and chunk2 differ bit for bit")
            orders["path"] = mod.choose_path(a, slabs, c0, r0s)
            del outs, a, slabs, c0
            main = orders["chunk2" if plan.algorithm == "chunk2" else "chunk1"]
            self.note_batched("ranged_spgemm", label,
                              max(orders[o]["max_abs_err"] for o in ORDERS), main)
            result["ranged_spgemm"] = orders
        mod = self.kernels["bsr_spgemm"]
        bs, _, _, nc, u = benv.bsr_caps
        folded = [ops for _, ops, _ in cs.stage_bsr_pairs_batched(As, Bs, plan, benv)]
        single = [ops for _, ops, _ in cs.stage_bsr_pairs(As[0], Bs[0], plan, benv)]
        run = lambda: [mod.bsr_spgemm_blocks(*ops, BATCH_WIDTH * nc, u, bs)  # noqa: E731
                       for ops in folded]
        run1 = lambda: [mod.bsr_spgemm_blocks(*ops, nc, u, bs) for ops in single]  # noqa: E731
        plain = [mod.bsr_spgemm_plain(*ops, BATCH_WIDTH * nc, u, bs) for ops in folded]
        err = max(self.hold_tiles(f"bsr_spgemm/batched/{label}/pair{i}", g, w)
                  for i, (g, w) in enumerate(zip(run(), plain)))
        del plain
        numbers = {"max_abs_err": err, "pairs": len(folded), "nc_pad": BATCH_WIDTH * nc,
                   "u_max": u, "blocks_a": int(folded[0][0].shape[0]),
                   **self.width_pair("bsr_spgemm", label, "pairs", run, run1,
                                     TRACE_NAMES["bsr_spgemm"], len(folded))}
        self.note_batched("bsr_spgemm", label, err, numbers)
        result["bsr_spgemm"] = numbers
        del folded, single
        emit({"batched_kernel_phase": label, "width": BATCH_WIDTH,
              "plan": {"algorithm": plan.algorithm, "n_ac": plan.n_ac, "n_b": plan.n_b},
              "shapes": {"A": list(As[0].shape), "B": list(Bs[0].shape),
                         "nnz_A": [A.nnz() for A in As],
                         "envelope": dataclasses.asdict(env),
                         "bsr_caps": list(benv.bsr_caps)},
              "stage_s": stage_s, "kernels": result})
        torch.cuda.empty_cache()

    def batched_run(self, label: str, As, Bs, plan, backend: str) -> None:
        """``chunked_spgemm_batched`` of one width-8 batch through
        ``backend`` (counters reset before, read after): every C against
        scipy in float64, and against the port's unbatched
        ``chunked_spgemm`` of the instance (structure exactly for the CSR
        outputs, densified values to the kernel tolerance for ``pallas`` and
        ``bsr``), and the wall seconds of both."""
        torch, ch, cs = self.torch, self.m["chunking"], self.m["chunk_stream"]
        csr = self.m["csr"]
        env = self.batch_envs[label]
        chosen = (self.m["planner"].select_accumulator_backend(plan, env)
                  if backend == "auto" else backend)
        name = f"batched_run_{backend}"
        self.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Cs, stats = cs.chunked_spgemm_batched(As, Bs, plan, backend=backend)
        torch.cuda.synchronize()
        batched_s = time.perf_counter() - t0
        self._batched_fast[label, backend] = (Cs, stats, batched_s)
        launches = self.read_counters()
        kernel = self.backend_kernel.get(chosen)
        if kernel is not None:
            check(launches[kernel] > 0, f"{name}/{label}: {kernel} was not launched")
            if label == "brick3d16":
                self.batched_launches[kernel] = launches[kernel]
        scipy_errs = [self.scipy_check(A, B, C, key=("batch", label, i))
                      for i, (A, B, C) in enumerate(zip(As, Bs, Cs))]
        check(max(scipy_errs) <= SCIPY_RTOL,
              f"{name}/{label}: relative error {max(scipy_errs)} vs scipy")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        singles = [ch.chunked_spgemm(A, B, plan, backend=chosen)[0] for A, B in zip(As, Bs)]
        torch.cuda.synchronize()
        unbatched_s = time.perf_counter() - t0
        errs, exact = [], chosen in ("scan", "sparse", "hash")
        for i, (C, S) in enumerate(zip(Cs, singles)):
            if exact:
                nnz = S.nnz()
                check(C.nnz() == nnz and torch.equal(C.indptr, S.indptr)
                      and torch.equal(C.indices[:nnz], S.indices[:nnz]),
                      f"{name}/{label}/{i}: structure differs from the unbatched call")
                got, want = C.data[:nnz], S.data[:nnz]
            else:
                got, want = csr.csr_to_dense(C), csr.csr_to_dense(S)
            err = float((got - want).abs().max()) if want.numel() else 0.0
            scale = float(want.abs().max()) if want.numel() else 0.0
            check(err <= KERNEL_ATOL + KERNEL_RTOL * scale,
                  f"{name}/{label}/{i}: values differ from the unbatched call by {err}")
            errs.append(err)
        emit({"run": name, "batch": label, "backend": backend, "chosen": chosen,
              "width": len(As), "plan": {"algorithm": plan.algorithm, "n_ac": plan.n_ac,
                                         "n_b": plan.n_b},
              "launches": launches, "nnz_C": [C.nnz() for C in Cs],
              "stats": {"kernel_calls": stats.kernel_calls,
                        "copy_in_bytes": stats.copy_in_bytes},
              "wall_s": {"batched": batched_s, "unbatched_loop": unbatched_s},
              "check": {"scipy_rel_err": max(scipy_errs),
                        "unbatched_structure_equal": exact or None,
                        "unbatched_max_abs_err": max(errs)}})
        del Cs, singles

    def batched_placed(self, label: str, As, Bs, plan, backend: str, name: str,
                       slow_reads: str = "ring") -> None:
        """``chunked_spgemm_batched`` of one width-8 batch with its operands
        where ``TABLE3[name]`` puts them (a slow one in pinned host memory),
        through ``backend``: every C equal bit for bit to the all-fast
        batched call's (:meth:`batched_run`) and in C's space, the ChunkStats
        equal, one kernel launch a (strip, chunk) step for the whole batch
        (not one an instance), and every ring's stack pinned and its log its
        schedule's program. The call takes the batch's union envelope, as
        the all-fast call built it, so its wall holds no symbolic phase
        (the all-fast wall does). With ``slow_reads="in_place"`` the kernel
        reads the slow stacks where they lie instead: one launch a strip
        for the whole batch, each in place, and no ring op or transfer."""
        torch, cs, placement = self.torch, self.m["chunk_stream"], self.m["placement"]
        csr, dma = self.m["csr"], self.m["dma"]
        where = placement.TABLE3[name]
        Cs_fast, stats_fast, wall_fast = self._batched_fast[label, backend]
        pinned = {}

        def put(m, space):   # one pinned copy a matrix (the RMAT batch is L x L)
            if space == "fast":
                return m
            if id(m) not in pinned:
                pinned[id(m)] = placement.place(m, "slow")
            return pinned[id(m)]

        ops_a = [put(A, where.A) for A in As]
        ops_b = [put(B, where.B) for B in Bs]
        env = self.batch_envs[label]
        chosen = (self.m["planner"].select_accumulator_backend(plan, env)
                  if backend == "auto" else backend)
        if backend == "bsr":   # the all-fast call's default: block-capped
            if (label, BSR_BLOCK) not in self.batch_envs:
                self.batch_envs[label, BSR_BLOCK] = self.m["chunking"].batch_envelope(
                    As, Bs, plan, block_size=BSR_BLOCK)
            env = self.batch_envs[label, BSR_BLOCK]
        in_place = slow_reads == "in_place"
        run = f"batched_placed_{label}_{backend}_{name}" + ("_inplace" if in_place else "")
        self.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with self.m["copy_ring"].RingLog(timed=True) as log, \
                self.m["build"].LaunchTimer() as timer:
            # the all-fast call's union envelope, given as a service bucket
            # gives its own, and validated there: no symbolic phase runs
            Cs, stats = cs.chunked_spgemm_batched(ops_a, ops_b, plan, envelope=env,
                                                  backend=backend, validate_caps=False,
                                                  slow_reads=slow_reads)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = self.read_counters()
        check(stats == stats_fast, f"{run}: ChunkStats differ from the all-fast call's")
        for i, (C, W) in enumerate(zip(Cs, Cs_fast)):
            check(csr.csr_residence(C) == ("pinned" if where.C == "slow" else "card"),
                  f"{run}/{i}: C is in {csr.csr_residence(C)} memory, placed {where.C}")
            for f in ("indptr", "indices", "data"):
                check(torch.equal(getattr(C, f).cpu(), getattr(W, f).cpu()),
                      f"{run}/{i}: C.{f} differs from the all-fast batched call's")
        steps = plan.n_ac * plan.n_b
        kernel = self.backend_kernel.get(chosen)
        want = plan.n_ac if in_place else steps
        if kernel is not None:
            check(launches[kernel] == want, f"{run}: {launches[kernel]} {kernel} launches "
                  f"for {len(As)} instances, {want} expected")
        if in_place:
            check(launches[f"{kernel}/in_place"] == want,
                  f"{run}: {launches[f'{kernel}/in_place']} launches in place, {want} expected")
            check(not log.rings and not log.transfers,
                  f"{run}: {len(log.rings)} rings, {len(log.transfers)} transfers in place")
        for ring in log.rings:
            bad = (dma.check_ring_structure(ring.ops, ring.total, ring.n_fields)
                   + dma.simulate_schedule(ring.total))
            check(not bad, f"{run}: ring {ring.operand}: {bad[:2]}")
            check(ring.source_pinned, f"{run}: ring {ring.operand}'s stack is not pinned")
        check({r.operand for r in log.rings} <= set(where.slow),
              f"{run}: rings {[r.operand for r in log.rings]} for slow {where.slow}")
        emit({"placed_run": {
            "run": run, "placement": dict(zip("ABC", (where.A, where.B, where.C))),
            "backend": backend, "chosen": chosen, "width": len(As),
            "plan": [plan.algorithm, plan.n_ac, plan.n_b], "steps": steps,
            "launches": {k: v for k, v in launches.items() if v}, "bit_equal": True,
            "moved_in": sum(t.nbytes for t in log.transfers if t.direction == "in"),
            "moved_out": sum(t.nbytes for t in log.transfers if t.direction == "out"),
            "rings": [{"operand": r.operand, "role": r.role, "total": r.total,
                       "fields": r.n_fields} for r in log.rings],
            "times": log.times(), "kernel_ms": timer.ms(), "wall_s": wall,
            "all_fast_wall_s": wall_fast, "card": self.smi}})
        del Cs, ops_a, ops_b, pinned

    def service_requests(self, rmat_seeds, per_family: int = SERVICE_PER_FAMILY) -> tuple:
        """The service's requests, interleaved over three families of
        ``per_family`` (96 requests at the default 32):
        brick3d n=16 A x P and laplace3d n=24 A x P with values rescaled per
        request (numpy seeds), and L x L of the RMAT graphs of
        ``rmat_seeds`` in turn (rescaled when a graph repeats). Returns the
        requests, the fast limit F (the largest L's row bytes over
        ``SERVICE_CHUNK_DIV``) and the chunks ``plan_knl`` gives each family."""
        planner = self.m["planner"]
        Ls = [self.rmat_l(s) for s in rmat_seeds]
        families = [self.problem("brick3d", 16), self.problem("laplace3d", 24)]
        limit = max(float(planner.row_bytes_csr(L).sum()) for L in Ls) / SERVICE_CHUNK_DIV
        chunks = {}
        reqs = []
        for i in range(per_family):
            rng = np.random.default_rng(SERVICE_SEED + i)
            for fam, (A, B) in zip(("brick3d16", "laplace3d24"), families):
                reqs.append((fam, self.rescaled(A, rng), self.rescaled(B, rng)))
            L = Ls[i % len(Ls)]
            if i >= len(Ls):
                L = self.rescaled(L, rng)
            reqs.append(("rmat12", L, L))
        for fam, A, B in reqs:
            chunks.setdefault(fam, set()).add(planner.plan_knl(A, B, limit).n_b)
        for fam, n_b in chunks.items():
            check(min(n_b) >= 2 and max(n_b) <= 6,
                  f"service: plan_knl at F={limit} gives {fam} {sorted(n_b)} chunks, not 2-6")
        return reqs, limit, {k: sorted(v) for k, v in chunks.items()}

    def service_run(self, label: str, rmat_seeds, gate: bool, placed: bool = False,
                    per_family: int = SERVICE_PER_FAMILY, slow_reads: str = "ring") -> None:
        """``SpGEMMService`` on the card: the requests of
        ``service_requests`` (96 at the default ``per_family``) submitted in a cold wave, then resubmitted (the
        same CSR objects) in a warm wave, ``poll()`` after every 8 submits
        (each poll ``slo_s`` after the last submit, so a poll flushes every
        queued bucket in both waves), then ``drain()``. Every response is
        held to scipy; with ``gate`` the warm wave must compile nothing,
        ``n_buckets`` stay within ``retrace_budget`` and each bucket compile
        at most once a width it used. Counters reset before the cold wave
        and read after the warm one. With ``placed`` every operand is
        submitted from pinned host memory (one pinned copy a matrix, made
        before the waves), and every response must equal the gated
        all-fast run's response to the same request bit for bit and lie in
        pinned memory (C takes A's space). ``slow_reads`` is the service's:
        under ``"in_place"`` the waves must log no ring op and no transfer,
        and every bucket's kernel must have read in place."""
        torch, svc_mod = self.torch, self.m["service"]
        cs, place = self.m["chunk_stream"], self.m["placement"].place
        t0 = time.perf_counter()
        reqs, limit, chunks = self.service_requests(rmat_seeds, per_family)
        if placed:
            pinned = {}
            for _, A, B in reqs:
                for m in (A, B):
                    if id(m) not in pinned:
                        pinned[id(m)] = place(m, "slow")
            reqs = [(fam, pinned[id(A)], pinned[id(B)]) for fam, A, B in reqs]
            del pinned
        setup_s = time.perf_counter() - t0
        svc = svc_mod.SpGEMMService(fast_limit_bytes=limit, **SERVICE, slow_reads=slow_reads)
        traces0 = sum(v for k, v in cs.TRACE_COUNTS.items() if k.endswith("_batched"))
        self.reset_counters()
        waves, backend_of, worst = {}, {}, 0.0
        ring_log = self.m["copy_ring"].RingLog()
        for wave in ("cold", "warm"):
            before = dataclasses.asdict(svc.stats)
            out = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with ring_log:
                for i, (_, A, B) in enumerate(reqs):
                    svc.submit(A, B)
                    if (i + 1) % 8 == 0:
                        time.sleep(SERVICE["slo_s"])
                        out += svc.poll()
                out += svc.drain()
            wall = time.perf_counter() - t0
            after = dataclasses.asdict(svc.stats)
            delta = {k: after[k] - before[k] for k in after}
            check(len(out) == len(reqs), f"{label}/{wave}: {len(out)} responses")
            families = collections.Counter()
            for r in out:
                fam, A, B = reqs[r.req_id % len(reqs)]
                err = self.scipy_check(A, B, r.C, key=(
                    "service", tuple(rmat_seeds), r.req_id % len(reqs)))
                check(err <= SCIPY_RTOL, f"{label}/{wave}: request {r.req_id} ({fam}) "
                      f"relative error {err} vs scipy")
                worst = max(worst, err)
                bucket = svc._buckets.get(r.bucket_key)
                if bucket is not None:
                    backend_of[r.req_id % len(reqs)] = bucket.backend
                families[fam, r.padded_batch] += 1
                key = (wave, r.req_id % len(reqs))
                if placed:
                    want = self._service_fast[key]
                    check(self.m["csr"].csr_residence(r.C) == "pinned",
                          f"{label}/{wave}: request {r.req_id}'s C is not pinned")
                    check(all(torch.equal(getattr(r.C, f).cpu(), getattr(want, f).cpu())
                              for f in ("indptr", "indices", "data")),
                          f"{label}/{wave}: request {r.req_id} differs from the all-fast "
                          "service's response")
                elif gate:
                    self._service_fast[key] = r.C
            lat = np.array([r.latency_s for r in out])
            waves[wave] = {
                "wall_s": wall, "exec_s": delta["exec_s"], "compile_s": delta["compile_s"],
                "compiles": delta["compiles"],
                "requests_per_s_exec": len(out) / delta["exec_s"],
                "requests_per_s_wall": len(out) / wall,
                "latency_p50_s": float(np.percentile(lat, 50)),
                "latency_p95_s": float(np.percentile(lat, 95)),
                "widths": {f"{fam}/{w}": n for (fam, w), n in sorted(families.items())},
                "stats_delta": delta, "n_buckets": svc.n_buckets}
            if gate:
                check(svc.n_buckets <= svc.retrace_budget,
                      f"{label}/{wave}: {svc.n_buckets} buckets > {svc.retrace_budget}")
        launches = self.read_counters()
        traces = sum(v for k, v in cs.TRACE_COUNTS.items() if k.endswith("_batched")) - traces0
        check(traces == svc.stats.compiles, f"{label}: {traces} core traces, the service "
              f"counted {svc.stats.compiles} compiles")
        buckets = [{"family": f"{b.envelope.a_shape}x{b.envelope.b_shape}",
                    "algorithm": b.plan.algorithm, "n_b": b.plan.n_b, "backend": b.backend,
                    "compiles": b.compiles, "executions": b.executions, "served": b.served,
                    "widths_used": sorted(b.widths_used)} for b in svc._buckets.values()]
        for b in buckets:
            if b["backend"] in self.backend_kernel:
                kernel = self.backend_kernel[b["backend"]]
                check(launches[kernel] > 0, f"{label}: {kernel} was not launched")
                if slow_reads == "in_place":
                    check(launches[f"{kernel}/in_place"] > 0,
                          f"{label}: {kernel} read nothing in place")
        if slow_reads == "in_place":
            check(not ring_log.rings and not ring_log.transfers,
                  f"{label}: {len(ring_log.rings)} rings, {len(ring_log.transfers)} "
                  "transfers in place")
        if gate:
            check(waves["warm"]["compiles"] == 0,
                  f"{label}: the warm wave compiled {waves['warm']['compiles']} times")
            for b in buckets:
                check(b["compiles"] <= len(b["widths_used"]),
                      f"{label}: a bucket compiled {b['compiles']} times over widths "
                      f"{b['widths_used']}")
        result = {"run": label, "service": {**SERVICE, "fast_limit_bytes": limit,
                                            "slow_reads": slow_reads},
                  "rmat_seeds": [min(rmat_seeds), max(rmat_seeds)],
                  "plan_chunks": chunks, "requests": len(reqs), "setup_s": setup_s,
                  "waves": waves, "stats": dataclasses.asdict(svc.stats),
                  "n_buckets": svc.n_buckets, "buckets": buckets, "launches": launches,
                  "check": {"scipy_rel_err": worst}, "card": self.smi}
        if placed:
            result["bit_equal_to_all_fast"] = True
        elif gate:
            result["traced_flush"] = self.traced_flush(svc, reqs)
            # a yardstick: the first third of the requests (the three
            # families interleaved), cut from all 96 to pay for the placed
            # runs, so its rate is not the service's over the same requests
            # the yardstick loop over the first sixth of the requests (a third
            # before the training phases' cuts)
            result["naive_loop"] = self.naive_loop(reqs[:len(reqs) // 6], limit, backend_of)
            result["naive_loop"]["of_requests"] = len(reqs)
        emit(result)
        del svc, reqs
        torch.cuda.empty_cache()

    def traced_flush(self, svc, reqs) -> dict:
        """One warm flush of brick3d requests under the profiler, as many as
        the widest microbatch the waves gave that family's bucket: its
        wall, the device's busy ms and share."""
        shape = reqs[0][1].shape
        width = max(w for b in svc._buckets.values() if b.envelope.a_shape == shape
                    for w in b.widths_used)
        bricks = [(A, B) for fam, A, B in reqs if fam == "brick3d16"][:width]

        def flush():
            for A, B in bricks:
                svc.submit(A, B)
            check(len(svc.drain()) == len(bricks), "traced flush: responses missing")
        return traced_call(self.torch, flush)

    def naive_loop(self, reqs, limit: float, backend_of: dict) -> dict:
        """The service's requests one ``chunked_spgemm`` each, with the plan
        and backend the service gave them: requests a second by wall."""
        torch, planner, ch = self.torch, self.m["planner"], self.m["chunking"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, (_, A, B) in enumerate(reqs):
            ch.chunked_spgemm(A, B, planner.plan_knl(A, B, limit), backend=backend_of[i])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return {"requests": len(reqs), "wall_s": wall, "requests_per_s": len(reqs) / wall,
                "backends": dict(collections.Counter(backend_of.values()))}

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
                             window: int = 0, record: bool = False,
                             dtypes: tuple = ("f32", "bf16")) -> None:
        """The prefill kernel against its plain version in f32 (the fma
        route) and bf16 (the tc route), or in ``dtypes`` only, on seeded
        normal q, k, v; ``record`` times each run (f32 also by the
        profiler and by ``queued_ms``), its plain version and SDPA (causal, GQA) in its dtype,
        and each route gets a kernels-line row at this shape; the bf16
        numbers, where bf16 runs, are the kernel's recorded phase."""
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
            if name not in dtypes:
                continue
            q, k, v = (x.to(dtype) for x in base)
            run = lambda: mod.flash_prefill(q, k, v, window=window)  # noqa: E731
            plain = lambda: mod.flash_prefill_plain(q, k, v, window=window)  # noqa: E731
            route = mod.choose_route(dtype)
            err = self.hold_close(f"flash_prefill/{label}/{name}", run(), plain(),
                                  ATTN_F32_ATOL, ATTN_BF16_ULPS)
            self.note_err(err_key("flash_prefill", route, name), err)
            numbers = {"route": route, "max_abs_err": err,
                       "ms": self.launch_ms(run), "wrapper_ms": cuda_ms(torch, run)}
            if record:
                if name == "f32":
                    (numbers["device_ms"], numbers["device_incomplete_traces"], _,
                     numbers["incomplete_traces_held"]) = kernel_device_split(
                        torch, run, TRACE_NAMES["flash_prefill"], 1)
                    numbers["queued_ms"] = queued_ms(torch, run)
                numbers["plain_ms"] = cuda_ms(torch, plain, reps=3)
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                fn = lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)  # noqa: E731
                libraries[name] = (cuda_ms(torch, fn), *device_ms(torch, fn), None)
                size, rate = (2, "bf16_flops") if name == "bf16" else (4, "f32_flops")
                self.route_row("flash_prefill", route, label, numbers, size * elems, flops,
                               rate, libraries[name], dtype=name)
            orders[name] = numbers
        main = "bf16" if "bf16" in orders else "f32"
        size, rate = (2, "bf16_flops") if main == "bf16" else (4, "f32_flops")
        self.finish_phase("flash_prefill", label, orders, main, size * elems, flops,
                          libraries.get(main, (None,) * 4),
                          {"b": b, "s": s, "h": h, "hkv": hkv, "d": d, "window": window,
                           "visible_pairs_per_head": pairs}, record and main == "bf16", 1,
                          rate)

    def decode_kernel_phase(self, label: str, b: int, hkv: int, g: int, d: int, s: int,
                            lengths: list, *, timed: bool = False,
                            record: bool = False, main: str = "bf16",
                            shape_row: bool = False) -> int:
        """The decode kernel against its plain version in f32 and bf16 over
        a seeded normal cache. ``timed`` (a serve shape) adds each dtype's
        profiler device time of the wrapper call (both kernels it launches),
        and in the ``main`` dtype (the served model's) the plain version and
        SDPA (GQA, a length mask); with ``record`` the main dtype's numbers
        are the kernel's kernels-line row, with ``shape_row`` a row of their
        own at this shape (``label``). Returns the wrapper's split count at
        this shape."""
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
            if timed:   # one split and one combine kernel a call
                (numbers["device_ms"], numbers["device_incomplete_traces"],
                 numbers["device_split_ms"], _) = kernel_device_split(
                    torch, run, TRACE_NAMES["decode_attention"],
                    dict.fromkeys(TRACE_NAMES["decode_attention"], 1))
            if timed and name == main:
                numbers["plain_ms"] = cuda_ms(torch, plain)
                mask = (torch.arange(s, device="cuda")[None, :] < lens[:, None])[:, None, None]
                qt, kt, vt = q.reshape(b, hkv * g, 1, d), k.transpose(1, 2), v.transpose(1, 2)
                fn = lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)  # noqa: E731
                library = (cuda_ms(torch, fn), *device_ms(torch, fn), None)
            orders[name] = numbers
        live = int(np.minimum(np.asarray(lengths), s).clip(0).sum())
        size, rate = (2, "bf16_flops") if main == "bf16" else (4, "f32_flops")
        moved = size * (2 * b * hkv * g * d + 2 * live * hkv * d) + 4 * b   # q, o, cache, lengths
        flops = 4 * d * g * hkv * live
        self.finish_phase("decode_attention", label, orders, main, moved, flops, library,
                          {"b": b, "hkv": hkv, "g": g, "d": d, "s": s,
                           "lengths": list(lengths), "n_split": n_split}, record,
                          mod.KERNELS_PER_CALL, rate)
        if shape_row:
            numbers = orders[main]
            bound = bound_of(moved, flops, rate)
            self.route_rows["decode_attention", None, label] = {
                "dtype": main, "max_abs_err": numbers["max_abs_err"],
                **{k: numbers[k] for k in ("ms", "wrapper_ms", "device_ms", "device_split_ms",
                                           "plain_ms") if k in numbers}, **bound,
                **library_fields(library, bound["bound_ms"])}
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

    def teacher_forced(self, model, cfg, batch, outs, times: dict | None = None) -> tuple:
        """Prefill, then one decode step per generated token, each fed the
        serve run's own token: (the logits of every step, the cache). With
        ``times``, CUDA events around the prefill and around the decode steps
        fill in ``prefill_ms`` and ``decode_ms_per_step``."""
        tf = self.m["transformer"]
        torch = self.torch
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        with torch.inference_mode():
            marks[0].record()
            logits, cache = tf.prefill(model, batch, cfg, LM_CACHE)
            marks[1].record()
            steps = [logits]
            for t in range(LM_NEW - 1):
                logits, cache = tf.decode_step(model, cache, outs[:, t:t + 1], cfg)
                steps.append(logits)
            marks[2].record()
        torch.cuda.synchronize()
        if times is not None:
            times["prefill_ms"] = marks[0].elapsed_time(marks[1])
            times["decode_ms_per_step"] = marks[1].elapsed_time(marks[2]) / (LM_NEW - 1)
        return steps, cache

    @contextlib.contextmanager
    def plain_path(self):
        """The ``ops`` entries the model calls, swapped for the kernels' plain
        versions (the plain path of the serving checks)."""
        from unittest import mock

        ops = self.m["ops"]
        fp, gm = self.kernels["flash_prefill"], self.kernels["grouped_matmul"]

        def plain_prefill(q, k, v, bq=256, bk=512, window=0, cast_free=False):
            return fp.flash_prefill_plain(q, k, v, window=window, bq=bq, bk=bk,
                                          cast_free=cast_free)

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
                   for layer in model.layers if getattr(layer, "is_moe", False)]
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

    def attention_sites(self, cfg) -> int:
        """The attention calls of one pass: a layer's (dense, MoE), one a
        site of the shared block (hybrid), none (ssm)."""
        if cfg.family == "hybrid":
            return len(self.m["transformer"]._hybrid_sites(cfg))
        return 0 if cfg.family == "ssm" else cfg.n_layers

    @staticmethod
    def attention_f32(cfg) -> bool:
        """Whether the served attention runs in f32: an f32 model's, and the
        hybrid's (its residual stream is f32 after the first Mamba-2
        block)."""
        return cfg.compute_dtype == "float32" or cfg.family == "hybrid"

    def route_want(self, cfg, passes: int = LM_NEW) -> dict:
        """The launches of every route of the routed kernels in one prefill
        and ``passes - 1`` decode steps of ``cfg``: in bf16 the prefill on the
        tensor cores, the grouped GEMM on the tile route at prefill (B x S x
        k rows) and the small route at decode (B x k rows); in f32 all on the
        fma routes, the grouped GEMM's by its tile tiling at prefill and
        its rows-few tiling at decode (``attention_f32``)."""
        sites = self.attention_sites(cfg)
        n_gmm = 3 * cfg.n_layers if cfg.family == "moe" else 0
        if not self.attention_f32(cfg):
            counts = {"flash_prefill/tc": sites, "grouped_matmul/tile": n_gmm,
                      "grouped_matmul/small": n_gmm * (passes - 1)}
        else:
            counts = {"flash_prefill/fma": sites, "grouped_matmul/fma": n_gmm * passes,
                      "grouped_matmul/fma/tile": n_gmm,
                      "grouped_matmul/fma/rows_few": n_gmm * (passes - 1)}
        keys = [f"{kernel}/{route}" for kernel in ROUTED
                for route in self.kernels[kernel].ROUTE_LAUNCHES]
        keys += [f"grouped_matmul/fma/{t}"
                 for t in self.kernels["grouped_matmul"].TILING_LAUNCHES]
        return {key: counts.get(key, 0) for key in keys}

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
        versions), logits compared step by step (``gate``: held to the
        tolerances of the attention's dtype, F32_LOGIT_MAX_TOL /
        F32_LOGIT_MEAN_TOL where it runs in f32, else LOGIT_MAX_TOL /
        LOGIT_MEAN_TOL, and the first token of every request to the plain
        path's; else printed only, with the share of MoE routes that agree).
        A model that launches no kernel (ssm) has no plain path to hold it
        to: its check is null. Returns the served tokens."""
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
        sites = self.attention_sites(cfg)
        want = {"flash_prefill": sites, "decode_attention": sites * (LM_NEW - 1),
                "grouped_matmul": 3 * cfg.n_layers * LM_NEW if moe else 0}
        for kernel, n in want.items():
            check(launches[kernel] == n, f"{label}: {kernel} launched {launches[kernel]} "
                  f"times, expected {n}")
        self.check_routes(label, cfg, launches)
        # the kernels line reports each kernel's launches in the run at the
        # shapes of its recorded phase: attention in the first (dense) run
        for kernel in ("flash_prefill", "decode_attention"):
            self.launches.setdefault(kernel, launches[kernel])
        if cfg.family == "hybrid":   # rows 8d and 9c: the shared block's launches
            self.route_runs[f"flash_prefill/fma@{ZAMBA_PREFILL_LABEL}"] = (
                label, launches["flash_prefill/fma"])
            self.route_runs[f"decode_attention@{ZAMBA_DECODE_LABEL}"] = (
                label, launches["decode_attention"])
        if moe:
            self.launches["grouped_matmul"] = launches["grouped_matmul"]
        check(len(outs) == LM_BATCH and all(len(o) == LM_NEW for o in outs)
              and all(0 <= t < cfg.vocab_size for o in outs for t in o),
              f"{label}: outputs are not {LM_BATCH} x {LM_NEW} token ids")

        batch = self.lm_batch(prompts)
        out_t = torch.tensor(outs, dtype=torch.int32, device="cuda")
        tf = self.m["transformer"]
        kernels_run = bool(sites or moe)
        kernel_repeats = None
        if kernels_run:
            with self.routes(model) as kern_routes:
                kern, cache = self.teacher_forced(model, cfg, batch, out_t)
            kernel_repeats = bool(torch.equal(torch.stack([x.argmax(-1) for x in kern], 1),
                                              out_t.long()))
        else:   # no kernel on the path, so no plain path: the traced step's cache
            with torch.inference_mode():
                _, cache = tf.prefill(model, batch, cfg, LM_CACHE)
        cache_bytes = {k: v.numel() * v.element_size() for k, v in cache.items() if k != "pos"}
        # one more decode step and one prefill, traced: the device's busy
        # share of each and the port kernels' device time in it
        n_gmm = 3 * cfg.n_layers if moe else 0

        def step():
            with torch.inference_mode():
                tf.decode_step(model, cache, out_t[:, -1:], cfg)
        per_call = self.kernels["decode_attention"].KERNELS_PER_CALL
        step_trace = traced_call(torch, step, {"decode_attention": per_call * sites,
                                               "grouped_matmul": n_gmm})
        del cache

        def prefill():
            with torch.inference_mode():
                tf.prefill(model, batch, cfg, LM_CACHE)
        prefill_trace = traced_call(torch, prefill, {"flash_prefill": sites,
                                                     "grouped_matmul": n_gmm})

        result, tols = None, None
        if kernels_run:
            with self.plain_path():
                with self.routes(model) as plain_routes:
                    plain, cache = self.teacher_forced(model, cfg, batch, out_t)
                del cache
            result = self.compare_logits(label, cfg, kern, plain, out_t)
            if gate:
                tols = ((F32_LOGIT_MAX_TOL, F32_LOGIT_MEAN_TOL) if self.attention_f32(cfg)
                        else (LOGIT_MAX_TOL, LOGIT_MEAN_TOL))
            result.update({"tolerances": tols, "first_tokens_served": [o[0] for o in outs],
                           "kernel_path_repeats_serve_tokens": kernel_repeats})
        else:
            check(not gate, f"{label}: launches no kernel, so no plain path to gate it on")
        if tols:
            first = result["first_tokens_served"]
            check(result["logit_max_over_std"] <= tols[0]
                  and result["logit_mean_over_std"] <= tols[1],
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
              "n_layers": cfg.n_layers, "d_model": cfg.d_model, "attention_sites": sites,
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
              "peak_memory_bytes": peak,
              "cache_bytes": cache_bytes,
              "decode_step_trace": step_trace, "prefill_trace": prefill_trace,
              "moe": moe_numbers or None, "gated": gate, "check": result,
              "check_note": None if kernels_run else "no kernel launched: no plain path"})
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
        1.3 GB in f32). (name, wall ms, device ms, its traces, error
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
        and in f32 (the operands widened; the fma route, its tiling named,
        also timed by the profiler and by ``queued_ms``). The plain version
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
            tiling = gm.fma_tiling(x.shape[0]) if route == "fma" else None
            self.note_err(err_key("grouped_matmul", route, dtype, tiling), err)
            numbers = {"route": route, "max_abs_err": err, "ms": self.launch_ms(run),
                       "wrapper_ms": cuda_ms(torch, run)}
            if route == "fma":
                numbers["fma_tiling"] = tiling
            if dname == "f32":
                (numbers["device_ms"], numbers["device_incomplete_traces"], _,
                 numbers["incomplete_traces_held"]) = kernel_device_split(
                    torch, run, TRACE_NAMES["grouped_matmul"], 1)
                numbers["queued_ms"] = queued_ms(torch, run)
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
        16-byte chunks, rows past the last group, each fma tiling (named in
        the phase line). f32 (the fma route), bf16
        by every route the operands fit (tile and small need K and N
        multiples of 8; forcing either on other operands must raise), and
        bf16 to an f32 output (the fma route; forcing a tensor-core route
        must raise); and the padded ``ops.grouped_matmul`` against its CPU
        (plain) run, pad rows zero."""
        torch, gm, ops = self.torch, self.kernels["grouped_matmul"], self.m["ops"]
        gen = torch.Generator(device="cuda").manual_seed(GMM_EDGE_SEED)
        # the first five take the fma route's rows-few tiling, the last two
        # (more than SMALL_ROWS_MAX rows) its tile tiling
        cases = [([37, 0, 91, 12, 0, 300], 2048, 1000), ([1] * 8, 40, 72),
                 ([129], 17, 130), ([0, 0, 0], 64, 64), ([0, 5, 0, 250], 33, 1),
                 ([300, 0, 1, 257, 64], 36, 98), ([700, 5], 2048, 1000)]
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
                    self.note_err(err_key("grouped_matmul", route, dtype,
                                          gm.fma_tiling(t + 9) if route == "fma" else None),
                                  errs[f"{dname}_{route}"])
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
                    self.note_err(err_key("grouped_matmul", "fma", dtype, gm.fma_tiling(t + 9)),
                                  errs["bf16_f32out_fma"])
                y, offs = ops.grouped_matmul(xd[:t], wd, sizes, bt=32, bn=1, bk=1)
                y_cpu, offs_cpu = ops.grouped_matmul(xd[:t].cpu(), wd.cpu(), sizes, bt=32,
                                                     bn=1, bk=1)
                check(np.array_equal(offs, offs_cpu), f"padded {sizes}: offsets differ")
                errs[f"padded_{dname}"] = self.hold_gmm(f"ops.grouped_matmul{sizes}/{dname}",
                                                        y, y_cpu.cuda())
                pad = sum(float(y[offs[g] + m: offs[g + 1]].abs().sum())
                          for g, m in enumerate(sizes))
                check(pad == 0, f"padded {sizes}/{dname}: pad rows are not zero")
            result.append({"sizes": sizes, "k": k, "n": n, "fma_tiling": gm.fma_tiling(t + 9),
                           "max_abs_err": errs, "refused_routes": refused})
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
        the plain logits' std, every first token equal. The kernel path's
        prefill and decode steps are timed by CUDA events in a second,
        warm run (``kernel_path_ms``)."""
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
        kernel_path_ms = {}
        self.teacher_forced(model, cfg32, batch, out_t, kernel_path_ms)
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
              "kernel_path_ms": kernel_path_ms, "check": result})
        check(result["logit_max_over_std"] <= F32_LOGIT_MAX_TOL
              and result["logit_mean_over_std"] <= F32_LOGIT_MEAN_TOL,
              f"{label}: f32 teacher-forced logits differ from the plain path by up to "
              f"{result['logit_max_over_std']} (max) / {result['logit_mean_over_std']} "
              "(mean) of their std")
        check(result["first_tokens_equal"], f"{label}: first tokens {result['first_tokens']} "
              f"!= plain {result['first_tokens_plain']}")

    # -- the sixth path: the SSM and hybrid families ----------------------

    def ssm_model(self, arch: str, **changes):
        """The serving model of ``arch`` (with ``changes`` to its config,
        else at full width and depth), random weights from LM_WEIGHT_SEED, on the
        card."""
        from repro_torch.configs import get_config

        cfg = dataclasses.replace(get_config(arch), **changes)
        model = self.m["transformer"].init_params(
            cfg, self.torch.Generator(device="cuda").manual_seed(LM_WEIGHT_SEED), "cuda")
        return cfg, model

    def decode_matches_forward(self, label: str, cfg, model, tolerances) -> None:
        """The decode path against the training forward at full width: the
        prefill of DMF_LEN - DMF_STEPS prompt tokens and DMF_STEPS decode
        steps fed the prompt's own tokens, each step's logits against the
        forward's at that position; the prefill of all DMF_LEN tokens against
        the last decode step and the forward's last position. Gated at
        ``tolerances`` (worst, mean) of the forward logits' std, or reported
        only where None."""
        torch, tf = self.torch, self.m["transformer"]
        rng = np.random.default_rng(LM_PROMPT_SEED)
        toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (DMF_BATCH, DMF_LEN))
                                .astype(np.int32)).cuda()
        n_pre = DMF_LEN - DMF_STEPS
        t0 = time.perf_counter()
        with torch.inference_mode():
            full, _ = tf.prefill(model, {"tokens": toks}, cfg, DMF_LEN)
            lg, cache = tf.prefill(model, {"tokens": toks[:, :n_pre]}, cfg, DMF_LEN)
            steps = [lg]
            for t in range(n_pre, DMF_LEN):
                lg, cache = tf.decode_step(model, cache, toks[:, t:t + 1], cfg)
                steps.append(lg)
            del cache
            fwd = tf.forward(model, {"tokens": toks}, dataclasses.replace(cfg, remat=False))[0]
            fwd = fwd[:, n_pre - 1:]
        torch.cuda.synchronize()

        def ratios(a, w):
            check(bool(torch.isfinite(a).all()), f"{label}: non-finite logits")
            diff, std = (a - w).abs(), float(w.std())
            return float(diff.max()) / std, float(diff.mean()) / std

        # the prefill's last logits (position n_pre - 1), then one a decode step
        by_step = [ratios(a, fwd[:, j]) for j, a in enumerate(steps)]
        full_vs_decode = ratios(full, steps[-1])
        full_vs_forward = ratios(full, fwd[:, -1])
        worst = max([r[0] for r in by_step] + [full_vs_decode[0], full_vs_forward[0]])
        worst_mean = max([r[1] for r in by_step] + [full_vs_decode[1], full_vs_forward[1]])
        emit({"decode_matches_forward": label, "arch": cfg.name, "batch": DMF_BATCH,
              "prompt_len": DMF_LEN, "decode_steps": DMF_STEPS,
              "decode_vs_forward_over_std": by_step,
              "prefill_vs_last_decode_over_std": full_vs_decode,
              "prefill_vs_forward_over_std": full_vs_forward,
              "compute_dtype": cfg.compute_dtype, "tolerances": tolerances,
              "seconds": time.perf_counter() - t0})
        check(tolerances is None or (worst <= tolerances[0] and worst_mean <= tolerances[1]),
              f"{label}: decode and prefill differ from the forward by up to {worst} (max) / "
              f"{worst_mean} (mean) of the logit std")
        del full, steps, fwd
        torch.cuda.empty_cache()

    def ssm_serving(self) -> None:
        """The sixth path's serving: the attention kernels at Zamba2's serve
        shapes in f32 (rows 8d and 9c: the kernels line's numbers), Zamba2's
        serve run and its decode-matches-forward gate, then RWKV6-3B's."""
        torch = self.torch
        cfg, model = self.ssm_model(ZAMBA_ARCH)
        prompts = self.lm_prompts(cfg.vocab_size)
        s_pad = max(len(p) for p in prompts)
        h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.prefill_kernel_phase(ZAMBA_PREFILL_LABEL, LM_BATCH, s_pad, h, hkv, d,
                                  record=True, dtypes=("f32",))
        self.decode_kernel_phase(ZAMBA_DECODE_LABEL, LM_BATCH, hkv, h // hkv, d, LM_CACHE,
                                 [s_pad + LM_NEW // 2] * LM_BATCH, timed=True, main="f32",
                                 shape_row=True)
        self.serve_run("serve_zamba2_1p2b", cfg, model, prompts, gate=True)   # f32 attention
        self.decode_matches_forward("decode_matches_forward_zamba2_1p2b", cfg, model,
                                    (LOGIT_MAX_TOL, LOGIT_MEAN_TOL))
        del model
        torch.cuda.empty_cache()
        cfg, model = self.ssm_model(RWKV_ARCH)
        self.serve_run("serve_rwkv6_3b", cfg, model, self.lm_prompts(cfg.vocab_size),
                       gate=False)   # no kernel, so no plain path
        self.decode_matches_forward("decode_matches_forward_rwkv6_3b", cfg, model, None)
        del model
        torch.cuda.empty_cache()
        # RWKV6-3B's gates: bf16 at RWKV_DMF_LAYERS, f32 at full depth (see DMF_LEN)
        cfg8, model = self.ssm_model(RWKV_ARCH, n_layers=RWKV_DMF_LAYERS)
        self.decode_matches_forward(f"decode_matches_forward_rwkv6_3b_l{RWKV_DMF_LAYERS}",
                                    cfg8, model, RWKV_DMF_TOL)
        del model
        torch.cuda.empty_cache()
        cfg32, model = self.ssm_model(RWKV_ARCH, compute_dtype="float32")
        self.decode_matches_forward("decode_matches_forward_rwkv6_3b_f32", cfg32, model,
                                    (F32_LOGIT_MAX_TOL, F32_LOGIT_MEAN_TOL))
        del model
        torch.cuda.empty_cache()

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
            # the in-place route: its first call on the main path's placements
            in_place = {"in_place": self.in_place[kernel]} if kernel in self.in_place else {}
            if kernel not in ROUTED:
                extra = dict(in_place)
                if kernel in self.batched:
                    check(self.batched_launches.get(kernel, 0) > 0,
                          f"{kernel}: launched no time in its batched run")
                    extra["batched"] = {**self.batched[kernel],
                                        "launches": self.batched_launches[kernel]}
                rows.append({**base, "launches": self.launches[kernel],
                             "max_abs_err": self.max_err[kernel], **numbers, **extra})
                for (k, route, shape), row in self.route_rows.items():
                    if (k, route) == (kernel, None):   # a further served shape
                        run, launches = self.route_runs.get(f"{kernel}@{shape}", (None, 0))
                        check(launches > 0, f"{kernel}/{shape}: launched no time on its "
                              "main-path run")
                        rows.append({**base, "shape": shape, "launches": launches,
                                     "launches_run": run, **row})
                continue
            for route in ROW_ROUTES.get(kernel, self.kernels[kernel].ROUTE_LAUNCHES):
                shapes = [sh for (k, r, sh) in self.route_rows if (k, r) == (kernel, route)]
                check(bool(shapes), f"{kernel}/{route}: no timed phase")
                for shape in shapes:
                    row = self.route_rows[kernel, route, shape]
                    # the launches of the row's route, or of its fma tiling
                    tiling = row.get("fma_tiling")
                    key = "/".join([kernel, route] + ([tiling] if tiling else []))
                    check(key in self.route_runs, f"{key}: launched no time on the main path")
                    # a shape's own run where one launches the route there (row 8d)
                    run, launches = self.route_runs.get(f"{key}@{shape}", self.route_runs[key])
                    extra = dict(in_place)
                    if tiling:   # bf16 operands through the same tiling: a field of its own
                        extra["bf16_operands_max_abs_err"] = self.max_err.get(
                            err_key(kernel, route, "bfloat16", tiling))
                    if (kernel, route) == ("sparse_accum_spgemm", "global"):
                        # the classed call: the launches of every class in
                        # the main-path run of its global class
                        extra["class_launches"] = {}
                        for name in self.kernels[kernel].ROUTES[1:]:
                            check(f"{kernel}/{name}" in self.route_runs,
                                  f"{kernel}/{name}: launched no time on the main path")
                            extra["class_launches"][name] = self.route_runs[
                                f"{kernel}/{name}"][1]
                    if kernel in self.batched:   # the ESC kernel at width 8
                        check(self.batched_launches.get(kernel, 0) > 0,
                              f"{kernel}: launched no time in its batched run")
                        extra["batched"] = {**self.batched[kernel],
                                            "launches": self.batched_launches[kernel]}
                    rows.append({**base, "kernel_route": route, "shape": shape,
                                 "launches": launches, "launches_run": run,
                                 "max_abs_err": self.max_err[err_key(kernel, route,
                                                                     row["dtype"], tiling)],
                                 **row, **extra})
        check({r["name"] for r in rows} == set(self.kernels), "a kernel phase is missing")
        emit({"kernels": rows})

    # -- the fifth path: training ----------------------------------------

    def train_guard(self) -> None:
        """Each of the four LM kernel wrappers, given an input on the card
        that requires grad under grad mode, raises (naming the training
        forward) before it launches."""
        torch = self.torch
        ops = self.m["ops"]
        g = torch.Generator(device="cuda").manual_seed(EDGE_SEED)

        def r(*shape, grad=False):
            return torch.randn(*shape, generator=g, device="cuda").requires_grad_(grad)

        calls = {
            "flash_prefill": lambda: ops.flash_prefill(r(1, 64, 4, 64, grad=True),
                                                       r(1, 64, 2, 64), r(1, 64, 2, 64)),
            "decode_attention": lambda: ops.decode_attention(
                r(2, 2, 2, 64), r(2, 64, 2, 64, grad=True), r(2, 64, 2, 64),
                torch.tensor([3, 64], dtype=torch.int32, device="cuda")),
            "grouped_matmul": lambda: ops.grouped_matmul(r(16, 64), r(2, 64, 64, grad=True),
                                                         [7, 9]),
            "grouped_matmul_ragged": lambda: ops.grouped_matmul_ragged(
                r(16, 64, grad=True), r(2, 64, 64),
                torch.tensor([0, 7, 16], device="cuda")),
        }
        self.reset_counters()
        refused = {}
        for name, call in calls.items():
            try:
                call()
                refused[name] = False
            except RuntimeError as err:
                refused[name] = "transformer.forward" in str(err)
        launched = {k: v for k, v in self.read_counters().items() if v}
        emit({"train_guard": refused, "launches": launched})
        check(all(refused.values()) and not launched,
              f"train_guard: refused {refused}, launched {launched}")

    def train_card_vs_cpu(self) -> None:
        """One ``make_train_step`` step of the SMOKE configs on the card and
        on the CPU from the same weights and batch (TRAIN_CMP_RUNS): the
        gradients before the update, then the step's loss, grad_norm, moments
        and parameters, at the tolerances stated with TRAIN_CMP_RUNS."""
        torch = self.torch
        tf, step_mod, optim = self.m["transformer"], self.m["train_step"], self.m["optim"]
        from repro_torch.configs import get_config

        def worst(a: dict, b: dict) -> float:
            return max(float((a[n].detach().cpu() - b[n].detach()).abs().max()) for n in b)

        def share(a: dict, b: dict, atol: float) -> float:
            """The share of all entries within ``atol``."""
            close = sum(int(((a[n].detach().cpu() - b[n].detach()).abs() <= atol).sum())
                        for n in b)
            return close / sum(b[n].numel() for n in b)

        for arch, comp in TRAIN_CMP_RUNS:
            label = f"train_card_vs_cpu_{arch}_{comp}"
            cfg = get_config(arch, smoke=True)
            tcfg = optim.TrainConfig(learning_rate=TRAIN_CMP_LR, warmup_steps=1, total_steps=4,
                                     microbatches=2, grad_compression=comp)
            models = {"cpu": tf.init_params(cfg, torch.Generator().manual_seed(LM_WEIGHT_SEED),
                                            "cpu", dtype=torch.float32)}
            models["cuda"] = tf.Transformer(cfg, "cuda", torch.float32)
            models["cuda"].load_state_dict(models["cpu"].state_dict())
            host = self.m["data"].SyntheticLM(cfg, TRAIN_CMP_BATCH, TRAIN_CMP_SEQ,
                                              seed=TRAIN_DATA_SEED).batch(0)
            batches = {dev: {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
                       for dev in models}
            grads, losses = {}, {}
            for dev, model in models.items():
                loss, _ = tf.loss_fn(model, batches[dev], cfg, aux_weight=tcfg.aux_weight)
                names, tensors = zip(*model.named_parameters())
                grads[dev] = dict(zip(names, torch.autograd.grad(loss, tensors)))
                losses[dev] = float(loss.detach())
            grad_err = worst(grads["cuda"], grads["cpu"])
            outs = {}
            for dev, model in models.items():
                opt = step_mod.init_opt_state(cfg, tcfg, model)
                outs[dev] = step_mod.make_train_step(cfg, tcfg)(model, opt, batches[dev])
            (pc, oc, mc), (ph, oh, mh) = outs["cuda"], outs["cpu"]
            params_c, params_h = dict(pc.named_parameters()), dict(ph.named_parameters())
            # the parameters that moved apart, and the CPU gradient's size there
            apart = {n: (params_c[n].detach().cpu() - params_h[n].detach()).abs()
                     > TRAIN_PARAM_ATOL for n in params_h}
            hazard = {n: float(grads["cpu"][n][m].abs().max()) for n, m in apart.items()
                      if bool(m.any())}
            row = {"train_card_vs_cpu": label, "grad_max_abs_err": grad_err,
                   "loss_err": abs(losses["cuda"] - losses["cpu"]),
                   "step_loss_err": abs(float(mc["loss"]) - float(mh["loss"])),
                   "grad_norm_rel_err": abs(float(mc["grad_norm"]) / float(mh["grad_norm"]) - 1),
                   "mu_max_abs_err": worst(oc["mu"], oh["mu"]),
                   "nu_max_abs_err": worst(oc["nu"], oh["nu"]),
                   "param_max_abs_err": worst(params_c, params_h),
                   "param_share_within_atol": share(params_c, params_h, TRAIN_PARAM_ATOL),
                   "params_apart": {n: int(m.sum()) for n, m in apart.items() if bool(m.any())},
                   "cpu_grad_max_where_apart": hazard,
                   "nu_atol": TRAIN_NU_ATOL}
            if cfg.family in TRAIN_NU_FROM_GRAD:
                g_max = max(float(g.abs().max()) for g in grads["cpu"].values())
                row["nu_atol"] = (1 - tcfg.beta2) * (2 * g_max * TRAIN_GRAD_ATOL
                                                     + TRAIN_GRAD_ATOL ** 2)
            int8 = comp == "int8"
            if int8:
                row.update({f"{k}_share_within_atol": share(oc[k], oh[k], atol) for k, atol in
                            (("mu", TRAIN_MU_ATOL), ("nu", TRAIN_NU_ATOL), ("ef", TRAIN_MU_ATOL))})
            emit(row)
            check(grad_err <= TRAIN_GRAD_ATOL and row["loss_err"] <= TRAIN_LOSS_ATOL
                  and row["step_loss_err"] <= TRAIN_LOSS_ATOL,
                  f"{label}: gradients or loss off the CPU's: {row}")
            check(row["param_max_abs_err"] <= 2 * TRAIN_CMP_LR + TRAIN_PARAM_ATOL,
                  f"{label}: parameters off the CPU's by more than a step: {row}")
            if int8:
                check(min(row[f"{k}_share_within_atol"] for k in ("param", "mu", "nu", "ef"))
                      >= TRAIN_SHARE, f"{label}: int8 state off the CPU's: {row}")
            else:
                check(row["grad_norm_rel_err"] <= TRAIN_NORM_RTOL
                      and row["mu_max_abs_err"] <= TRAIN_MU_ATOL
                      and row["nu_max_abs_err"] <= row["nu_atol"],
                      f"{label}: optimizer state off the CPU's: {row}")
                check(all(g <= TRAIN_HAZARD_GRAD for g in hazard.values()),
                      f"{label}: parameters apart where the gradient is not near zero: {row}")
            del models, outs, grads

    def _train_loop(self, *args, **kwargs):
        """``train_loop`` with its prints captured (every output line stays
        JSON) and the process's SIGTERM handler restored after (a checkpoint
        manager installs its own)."""
        import io
        import signal

        previous = signal.getsignal(signal.SIGTERM)
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                stats = self.m["train"].train_loop(*args, **kwargs)
        finally:
            signal.signal(signal.SIGTERM, previous)
        return stats, buf.getvalue().splitlines()

    def train_resume(self) -> None:
        """The example's config, 4 steps straight against 2 + a checkpoint +
        a fresh model and optimizer state restored + 2 more, under
        deterministic algorithms: the losses and the step-4 checkpoints
        (parameters, moments, step) equal bit for bit."""
        import importlib
        import tempfile

        torch = self.torch
        sys.path.insert(0, str(ROOT))
        cfg = importlib.import_module("examples.torch_train_lm").lm_config()
        tcfg = self.m["optim"].TrainConfig(learning_rate=6e-4, warmup_steps=1,
                                           total_steps=TRAIN_RESUME_STEPS, microbatches=2)
        kw = dict(device="cuda", batch_size=8, seq_len=256, log_every=10 ** 9,
                  seed=TRAIN_DATA_SEED)
        t0 = time.perf_counter()
        torch.use_deterministic_algorithms(True)
        try:
            with tempfile.TemporaryDirectory() as tmp:
                a, b = Path(tmp) / "straight", Path(tmp) / "resumed"
                straight, _ = self._train_loop(cfg, tcfg, steps=TRAIN_RESUME_STEPS,
                                               ckpt_dir=str(a),
                                               ckpt_every=TRAIN_RESUME_STEPS, **kw)
                first, _ = self._train_loop(cfg, tcfg, steps=TRAIN_RESUME_SPLIT,
                                            ckpt_dir=str(b), ckpt_every=TRAIN_RESUME_SPLIT, **kw)
                resumed, log = self._train_loop(cfg, tcfg, steps=TRAIN_RESUME_STEPS,
                                                ckpt_dir=str(b),
                                                ckpt_every=TRAIN_RESUME_SPLIT, **kw)
                step = f"step_{TRAIN_RESUME_STEPS:08d}"
                files = sorted(p.name for p in (a / step).glob("arr_*.npy"))
                differ = [f for f in files
                          if not np.array_equal(np.load(a / step / f), np.load(b / step / f))]
                equal_files = files == sorted(p.name for p in (b / step).glob("arr_*.npy"))
        finally:
            torch.use_deterministic_algorithms(False)
        losses = [h["loss"] for h in straight.history]
        split = [h["loss"] for h in first.history + resumed.history]
        emit({"train_resume": "examples/torch_train_lm.py config", "params":
              sum(p.numel() for p in self.m["transformer"].Transformer(
                  cfg, "meta", torch.float32).parameters()),
              "resumed_from": resumed.resumed_from, "losses_straight": losses,
              "losses_resumed": split, "checkpoint_leaves": len(files),
              "leaves_differing": differ, "log": log, "seconds": time.perf_counter() - t0})
        check(resumed.resumed_from == TRAIN_RESUME_SPLIT and losses == split
              and equal_files and files and not differ,
              f"train_resume: resume is not bit for bit ({len(differ)} leaves differ)")
        torch.cuda.empty_cache()

    def product_weights(self, model, cfg) -> tuple:
        """(the parameters that enter a product, the weights one token's
        products use): not the embedding table or the elementwise weights
        (``NOT_IN_PRODUCTS``); the hybrid's shared block once a site; of the
        MoE's experts the top-k."""
        unique = per_token = 0
        for name, p in model.named_parameters():
            if name == "embed.embedding" or name.rsplit(".", 1)[-1] in NOT_IN_PRODUCTS:
                continue
            unique += p.numel()
            per_token += p.numel() * (self.attention_sites(cfg)
                                      if name.startswith("shared_attn.") else 1)
        if cfg.is_moe:
            per_token -= cfg.n_layers * (cfg.n_experts - cfg.top_k) * 3 * cfg.d_model * cfg.d_ff
        return unique, per_token

    def train_run(self, label: str, arch: str, layers, steps: int, trace: bool,
                  levers: dict | None = None, lr: float = TRAIN_LR) -> list:
        """``train_loop`` on the card at full width (``layers`` cuts the
        depth; ``levers`` sets config levers): each step's loss, grad_norm,
        lr, moe_aux and ms, the median step ms from step TRAIN_TIMED_FROM
        on, tokens/s, the model-FLOP share (6 N T over the bf16 peak, N the
        weights one token's products use: ``product_weights``), the peak
        allocation; with ``trace`` the last step runs under the profiler
        (left out of the median): its device busy ms by kernel class and its
        top kernels. Gates: finite losses and gradient norms, the last loss
        TRAIN_LOSS_DROP below the first (a lever run: step 0's loss within
        TRAIN_LEVER_LOSS_ATOL of the lever-off run's), and no kernel wrapper
        launched. Returns the step records."""
        torch = self.torch
        from repro_torch.configs import get_config

        cfg = dataclasses.replace(get_config(arch), **(levers or {}))
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        tcfg = self.m["optim"].TrainConfig(learning_rate=lr, warmup_steps=1, total_steps=steps)
        meta = self.m["transformer"].Transformer(cfg, "meta", torch.float32)
        n_params = sum(p.numel() for p in meta.parameters())
        n_unique, n_active = self.product_weights(meta, cfg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        self.reset_counters()
        traced = []

        def hook(step):   # the last step under the profiler, stopped after the loop
            if trace and step == steps - 1:
                traced.append(torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]))
                traced[0].__enter__()

        t0 = time.perf_counter()
        stats, log = self._train_loop(cfg, tcfg, device="cuda", batch_size=TRAIN_BATCH,
                                      seq_len=TRAIN_SEQ, steps=steps, log_every=1,
                                      seed=TRAIN_DATA_SEED, weight_seed=LM_WEIGHT_SEED,
                                      _step_hook=hook)
        wall = time.perf_counter() - t0
        step_trace = None
        if traced:
            torch.cuda.synchronize()
            traced[0].__exit__(None, None, None)
            step_trace = train_trace(device_by_name(traced[0]), stats.history[-1]["ms"])
        launched = {k: v for k, v in self.read_counters().items() if v}
        peak = torch.cuda.max_memory_allocated()
        hist = stats.history
        timed = [h["ms"] for h in hist[TRAIN_TIMED_FROM:len(hist) - len(traced)]]
        median_ms = statistics.median(timed)
        tokens = TRAIN_BATCH * TRAIN_SEQ
        losses = [h["loss"] for h in hist]
        emit({"run": label, "arch": arch, "layers": cfg.n_layers, "levers": levers, "lr": lr,
              "params": n_params, "params_in_products": n_unique,
              "product_weights_per_token": n_active, "batch": [TRAIN_BATCH, TRAIN_SEQ],
              "remat": cfg.remat_policy if cfg.remat else "off", "compute": cfg.compute_dtype,
              "steps": hist, "median_step_ms": median_ms,
              "timed_steps": f"{TRAIN_TIMED_FROM}-{len(hist) - 1 - len(traced)}",
              "traced_step": step_trace,
              "tokens_per_s": tokens / (median_ms / 1e3),
              "model_flop_share": 6 * n_active * tokens / (median_ms / 1e3) / PEAK["bf16_flops"],
              "peak_allocated_bytes": peak, "wall_s": wall, "kernel_launches": launched,
              "loss_drop": losses[0] - losses[-1], "gate_drop": TRAIN_LOSS_DROP.get(label),
              "card": self.smi})
        check(len(hist) == steps and all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
                                         and np.isfinite(h["moe_aux"]) for h in hist),
              f"{label}: a loss, grad norm or moe_aux is not finite: {hist}")
        if label in TRAIN_LOSS_DROP:
            check(losses[-1] < losses[0] - TRAIN_LOSS_DROP[label],
                  f"{label}: the loss fell {losses[0] - losses[-1]:.4f}, not "
                  f"{TRAIN_LOSS_DROP[label]}")
        check(not launched, f"{label}: the training path launched kernels {launched}")
        torch.cuda.empty_cache()
        return hist

    def train_levers(self, off: list) -> None:
        """The Llama run with each of TRAIN_LEVER_RUNS (``off``: the
        lever-off run's step records, from the same call), the last step
        traced: step 0's loss within TRAIN_LEVER_LOSS_ATOL of the lever-off
        run's; the step ms beside the lever-off run's median."""
        off_ms = statistics.median(h["ms"] for h in off[TRAIN_TIMED_FROM:-1])
        for label, levers in TRAIN_LEVER_RUNS:
            hist = self.train_run(label, LM_ARCH, None, TRAIN_LEVER_STEPS, trace=True,
                                  levers=levers)
            err = abs(hist[0]["loss"] - off[0]["loss"])
            emit({"lever_run": label, "levers": levers, "step0_loss": hist[0]["loss"],
                  "step0_loss_off": off[0]["loss"], "step0_loss_err": err,
                  "tolerance": TRAIN_LEVER_LOSS_ATOL,
                  "step_ms": [h["ms"] for h in hist], "off_median_step_ms": off_ms})
            check(err <= TRAIN_LEVER_LOSS_ATOL,
                  f"{label}: step 0's loss {hist[0]['loss']} is {err} off the lever-off "
                  f"run's {off[0]['loss']}")


def main() -> int:
    started = time.perf_counter()
    # cuBLAS reads its workspace setting once: the training resume phase runs
    # under torch.use_deterministic_algorithms(True), which needs this one
    import os

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    laps = {}

    def lap(name: str) -> None:   # the seconds since the last lap
        laps[name] = time.perf_counter() - started - sum(laps.values())

    smoke.card()
    smoke.build()
    smoke.sass_phase()
    lap("build")
    # the placement phase's capacity run comes first, while the allocator
    # holds nothing else (its cap is lifted before the next phase)
    smoke.capacity_run()
    lap("capacity")

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
    # the ESC kernel's classed launch: L x L of an RMAT scale-12 graph (these
    # numbers go into the kernels line's global row), then the class edges
    L12 = smoke.rmat_l(BATCH_RMAT_SEEDS[0])
    plan_l12 = smoke.rmat_plan(L12)
    smoke.esc_global_phase("rmat12_knl", L12, plan_l12)
    smoke.esc_class_edge_phase()
    lap("kernel_phases")

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
    smoke.rmat_run("rmat12_sparse", L12, plan_l12)
    del L12
    smoke.breakdown("brick3d48_auto", "brick3d", 48, "auto")
    smoke._plain.clear()
    lap("main_path")

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
    smoke.spmm_edge_phase()

    smoke.triangle_run("tc_rmat18_fused")
    smoke.triangle_run("tc_rmat18_chunk2", chunk2=True)
    for backend in ("hash", "sparse"):
        for frac, kind in ((PIPE_RESIDENT, "resident"), (PIPE_SPILL, "spill")):
            smoke.galerkin_run(f"galerkin_brick3d48_{backend}_{kind}", backend, frac,
                               kind == "resident")
            # A, P and R in slow memory, against this all-fast run
            for name in PIPE_PLACEMENTS:
                smoke.galerkin_placed(f"galerkin_brick3d48_{backend}_{name}_{kind}",
                                      backend, frac, name)
                if (backend, name, kind) == GALERKIN_IN_PLACE:   # and read in place
                    smoke.galerkin_in_place(f"galerkin_brick3d48_{backend}_{name}_{kind}"
                                            "_inplace", backend, frac, name)
    smoke.bsr_run("brick3d48_bsr")
    smoke.spmm_run("bsr_spmm_brick3d48")
    lap("second_path")

    # operands in slow (pinned host) memory through the copy ring
    smoke.placement_phase()
    lap("placement")

    # the batched entry point and the SpGEMM service: the four sparse
    # kernels at width 8 against their plain versions (the dense slab on
    # batch (a) only: 70 MB an instance), chunked_spgemm_batched through
    # every batched backend, then the service (gated), then the service on
    # 8 distinct graphs (churn, reported)
    batches = smoke.batches()
    for label, (As, Bs, plan) in batches.items():
        smoke.batched_kernel_phase(label, As, Bs, plan, dense=label == "brick3d16")
    for label, (As, Bs, plan) in batches.items():
        for backend in BATCHED_BACKENDS:
            if backend != "pallas" or label == "brick3d16":
                smoke.batched_run(label, As, Bs, plan, backend)
                # the same batch with its operands in slow memory
                if (label, backend) not in BATCHED_PLACED_SKIP:
                    dp = ("DP",) if (label, backend) in BATCHED_PLACED_DP else ()
                    for name in BATCHED_PLACEMENTS + dp:
                        smoke.batched_placed(label, As, Bs, plan, backend, name)
                    if (label, backend) == BATCHED_IN_PLACE:   # and read in place
                        smoke.batched_placed(label, As, Bs, plan, backend, "HostPin",
                                             slow_reads="in_place")
    del batches
    smoke._batched_fast.clear()
    lap("batched")
    smoke.service_run("spgemm_service_run", SERVICE_RMAT_SEEDS, gate=True)
    smoke.service_run("spgemm_service_placed", SERVICE_RMAT_SEEDS, gate=True, placed=True,
                      per_family=IN_PLACE_SERVICE_PER_FAMILY)
    smoke.service_run("spgemm_service_placed_inplace", SERVICE_RMAT_SEEDS, gate=True,
                      placed=True, per_family=IN_PLACE_SERVICE_PER_FAMILY,
                      slow_reads="in_place")
    smoke._service_fast.clear()
    smoke.service_run("spgemm_service_churn", CHURN_RMAT_SEEDS, gate=False,
                      per_family=CHURN_PER_FAMILY)
    torch.cuda.empty_cache()
    lap("service")

    # the port's examples at their default sizes, then the static auditor
    smoke.examples_phase()
    smoke.audit_phase()
    torch.cuda.empty_cache()
    lap("examples_audit")

    # the third path, serving: the attention kernels at the serve run's
    # shapes (these numbers go into the kernels line; decode at a mid-run
    # step), on small ragged cases, then the serve run
    from repro_torch.configs import get_config

    cfg = get_config(LM_ARCH)
    prompts = smoke.lm_prompts(cfg.vocab_size)
    s_pad = max(len(p) for p in prompts)
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    smoke.prefill_kernel_phase("serve_prefill", LM_BATCH, s_pad, h, hkv, d, record=True)
    moe_cfg = get_config(MOE_ARCH)
    # the f32 OLMoE check's prefill shape (its fma launches come from there)
    smoke.prefill_kernel_phase("serve_prefill_olmoe", LM_BATCH, s_pad, moe_cfg.n_heads,
                               moe_cfg.n_kv_heads, moe_cfg.head_dim, record=True,
                               dtypes=("f32",))
    mid = [s_pad + LM_NEW // 2] * LM_BATCH
    smoke.decode_kernel_phase("serve_decode_mid", LM_BATCH, hkv, h // hkv, d, LM_CACHE, mid,
                              timed=True, record=True)
    # the MoE serve run's decode shape (same prompt lengths)
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
    lap("serving_llama")

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
    del outs
    torch.cuda.empty_cache()
    lap("serving_moe")

    # the sixth path, the SSM and hybrid families: Zamba2's attention
    # kernels at its serve shapes (rows 8d and 9c), then both serve runs and
    # their decode-matches-forward gates
    smoke.ssm_serving()
    lap("serving_ssm")

    # the fifth path, training: no hand-written kernel (the wrappers refuse
    # autograd), the card against the CPU, resume, the runs of every family,
    # then the levers on the Llama run
    smoke.train_guard()
    smoke.train_card_vs_cpu()
    smoke.train_resume()
    history = {}
    for label, arch, layers, steps in TRAIN_RUNS:
        history[label] = smoke.train_run(label, arch, layers, steps,
                                         trace=label == TRAIN_TRACED)
    for label, arch, layers, steps, lr in TRAIN_SSM_RUNS:
        smoke.train_run(label, arch, layers, steps, trace=False, lr=lr)
    smoke.train_levers(history[TRAIN_TRACED])
    lap("training")
    emit({"phase_seconds": laps, "card": smoke.smi})
    emit({"script_seconds": time.perf_counter() - started})
    smoke.kernels_line()
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
