"""Time variants of the BSR x dense kernel on one H100, alternated in one call.

    python3 bsr_spmm_variant_ablation.py [--rounds 3] [--parent DIR]

Run from the root of a checkout, on a CUDA card. The shape is the one
``chip_smoke.py``'s ``bsr_spmm_brick3d48`` run gives the kernel: brick3d
n=48 as BSR with 8 x 8 blocks (322,624 blocks, u_max 27) by a seeded X of
110,592 x 128 f32, 128-column tiles. The variants:

* ``shipped``: the group path as the wrapper launches it (G = 2 block rows
  a block, a warp each; a three-stage ring);
* ``g1`` ... ``g12``: the same kernel built from a copy of
  ``csrc/bsr_spmm.cu`` with ``kGroupWarps`` set to 1, 3, 4, 6, 8 or 12;
* ``stages4``: a four-stage ring; ``regs64`` and ``regs80``: registers
  capped by the launch bounds (16 or 12 blocks of 64 threads an SM: 64 or
  80 registers a thread), each at G = 2;
* ``generic``: the generic path at this shape;
* with ``--parent DIR`` (a checkout of another commit, e.g. the parent one
  unpacked by ``git archive`` into a gitignored directory), ``parent``: that
  checkout's ``csrc/bsr_spmm.cu`` through its ``bsr_spmm_launch``.

The copies are exact-string edits of the shipped source (``EDITS``): an
edit of one of those lines stops the script on its first target. Each
variant is built in parallel, its register counts printed (a variant that
spills would fail ``chip_smoke.py``'s ``NO_SPILL``), then held to
``bsr_spmm_plain`` at ``chip_smoke.py``'s kernel tolerance and timed: CUDA
events around a run of back-to-back launches, the variants alternated
A B ... B A over ``--rounds`` rounds, medians reported. Every line of
output is one JSON object; the last one is ``{"ok": true, ...}``.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

import chip_smoke
from chip_smoke import check, emit

REPS = 20   # launches a timing
GROUP = "constexpr int kGroupWarps = 2;"
BOUNDS = "__launch_bounds__(kGroupThreads, 1)"
# variant -> (group size, [(text of the shipped source, its replacement)])
EDITS = {**{f"g{g}": (g, [(GROUP, f"constexpr int kGroupWarps = {g};")])
            for g in (1, 3, 4, 6, 8, 12)},
         "stages4": (2, [("constexpr int kStages = 3;", "constexpr int kStages = 4;")]),
         "regs64": (2, [(BOUNDS, "__launch_bounds__(kGroupThreads, 16)")]),
         "regs80": (2, [(BOUNDS, "__launch_bounds__(kGroupThreads, 12)")])}
LAUNCH_ARGS = {"bsr_spmm_launch": (5, 7), "bsr_spmm_group_launch": (5, 7)}


def build_libs(b, parent: Path | None) -> dict:
    """variant -> loaded library, the edited copies and the parent's source
    built in parallel."""
    out_dir = b.BUILD_DIR / "bsr_spmm_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    shipped = (b.CSRC / "bsr_spmm.cu").read_text()
    sources = {}
    for name, (_, edits) in EDITS.items():
        text = shipped
        for old, new in edits:
            check(text.count(old) == 1, f"{name}: {old!r} is not in bsr_spmm.cu once")
            text = text.replace(old, new)
        sources[name] = out_dir / f"bsr_spmm_{name}.cu"
        sources[name].write_text(text)
    if parent is not None:
        sources["parent"] = parent / "src" / "repro_torch" / "kernels" / "csrc" / "bsr_spmm.cu"
        check(sources["parent"].exists(), f"{sources['parent']} is missing")
    procs = {}
    for name, path in sources.items():
        cmd = [b.nvcc_path(), *b.NVCC_FLAGS, "-I", str(b.CSRC if name != "parent"
                                                    else path.parent),
               "-o", str(out_dir / f"libbsr_spmm_{name}.so"), str(path)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True)
    libs = {"shipped": b.library("bsr_spmm")}
    emit({"variant": "shipped", "ptxas": b.BUILD_LOG["bsr_spmm"]["kernels"]})
    for name, proc in procs.items():
        stdout, stderr = proc.communicate()
        check(proc.returncode == 0, f"{name}: nvcc failed\n{stdout}{stderr}")
        emit({"variant": name, "ptxas": b.ptxas_resources(stderr)})
        libs[name] = ctypes.CDLL(str(out_dir / f"libbsr_spmm_{name}.so"))
    return libs


def entry(lib, fn: str):
    f = getattr(lib, fn)
    n_ptr, n_int = LAUNCH_ARGS[fn]
    f.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def distinct_slabs(slots, cols, a_zero: int, warps: int) -> int:
    """X slabs a group path stages: the distinct block columns of each group
    of ``warps`` block rows, summed over the groups."""
    rows, _ = np.nonzero(slots != a_zero)
    n_cols = int(cols.max()) + 1
    return int(np.unique(rows // warps * n_cols + cols[slots != a_zero]).size)


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--parent", type=Path, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bsr_spmm_variant_ablation: this needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(chip_smoke.ROOT / "src"))
    smoke = chip_smoke.Smoke(torch)
    info = smoke.card()
    b, mod, ops = smoke.m["build"], smoke.kernels["bsr_spmm"], smoke.m["ops"]
    libs = build_libs(b, args.parent)
    A, Ab, X, _ = smoke.spmm_inputs()
    bs, bn = chip_smoke.BSR_BLOCK, chip_smoke.SPMM_COLS
    meta = mod.bsr_spmm_symbolic(Ab)
    blocks = ops._with_zero_block(Ab.blocks)
    sl = torch.from_numpy(meta.a_slots).cuda()
    co = torch.from_numpy(meta.a_cols).cuda()
    mb, nf, a_zero = Ab.mb, X.shape[1], blocks.shape[0] - 1
    check(mod.choose_path(blocks, X, bs, bn) == "group", "the shape is not on the group path")
    y = torch.empty(mb * bs, nf, device="cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def generic(lib):
        f = entry(lib, "bsr_spmm_launch")
        return lambda: f(blocks.data_ptr(), X.data_ptr(), sl.data_ptr(), co.data_ptr(),
                         y.data_ptr(), mb, meta.u_max, bs, nf, bn, a_zero, 0, stream())

    def group(lib, g: int):
        f = entry(lib, "bsr_spmm_group_launch")
        return lambda: f(blocks.data_ptr(), X.data_ptr(), co.data_ptr(), sl.data_ptr(),
                         y.data_ptr(), mb, meta.u_max, g, bs, nf, a_zero, 0, stream())

    variants = {"shipped": group(libs["shipped"], mod.GROUP_WARPS),
                **{name: group(libs[name], g) for name, (g, _) in EDITS.items()},
                "generic": generic(libs["shipped"])}
    if "parent" in libs:
        variants["parent"] = generic(libs["parent"])

    want = mod.bsr_spmm_plain(blocks, X, sl, co, mb, meta.u_max, bs)
    errs = {}
    for name, fn in variants.items():
        y.fill_(float("nan"))
        check(fn() == 0, f"{name}: the launch failed")
        errs[name] = smoke.hold_tiles(f"bsr_spmm/{name}", y, want)
    del want
    emit({"checked": errs, "shape": {"block": bs, "mb": mb, "u_max": meta.u_max,
                                     "n_blocks": Ab.n_blocks(), "x": list(X.shape), "bn": bn},
          "x_slabs_staged": {g: distinct_slabs(meta.a_slots, meta.a_cols, a_zero, g)
                             for g in (1, 2, 3, 4, 6, 8, 12)}})

    def events_ms(fn) -> float:
        """Milliseconds a launch, CUDA events around REPS launches."""
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / REPS

    names = list(variants)
    times = {name: [] for name in names}
    for _ in range(args.rounds):
        for name in names + names[::-1]:
            times[name].append(events_ms(variants[name]))
    medians = {n: statistics.median(t) for n, t in times.items()}
    emit({"bsr_spmm_variants": "kernel_ms", "launches_per_timing": REPS,
          "median_ms": medians, "spread_ms": {n: max(t) - min(t) for n, t in times.items()},
          "ranked": sorted(medians, key=medians.get), "runs_ms": times})
    emit({"ok": True, "device": info["device_name"], "nvidia_smi": info["nvidia_smi"]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
