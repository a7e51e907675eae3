"""Time variants of the two f32 FMA kernels on one H100, alternated in one call.

    python3 f32_variant_ablation.py [--rounds 2] [--parent DIR]

Run from the root of a checkout, on a CUDA card. Variants of
``csrc/grouped_matmul.cu`` are built beside the shipped one by its
compile-time sizes, and each is run on the fma route (f32 x and w, f32 y):

* ``few_bn64`` / ``few_bn128``: the rows-few tiling's weight slab 64 or 128
  columns wide (``GMM_FMA_FEW_BN``);
* ``tile_bn128_bk8`` ... ``tile_bn256_bk32``: the tile tiling's width
  (``GMM_FMA_BN``: 128 x 128 tiles of 256 threads or 128 x 256 of 512)
  and K step (``GMM_FMA_BK`` 8, 16 or 32);
* ``tile_everywhere`` / ``rows_few_everywhere``: the shipped library with
  one tiling forced at every shape, the evidence for ``fma_tiling``.

With ``--parent DIR`` (a checkout of another commit, e.g. the parent one
unpacked by ``git archive`` into a gitignored directory), that checkout's
``grouped_matmul.cu`` and ``flash_prefill.cu`` are built too, as
``parent``; its grouped GEMM takes route 0 at every shape (it had one fma
tiling). The shapes: one OLMoE-1B-7B decode step's expert products (w1
``[64, 2048, 1024]`` and w2 ``[64, 1024, 2048]``, 64 rows over 28 experts
of 1 to 7 rows, as ``gmm_route_ablation.py`` draws them), the prefill's w1
product (87,983 rows over 64 experts, sizes drawn from a seed), and the f32
prefill attention at the Llama-3.2-1B serve shape (8 x 1,937, 32 / 8
heads, D 64) and the OLMoE one (16 / 16 heads, D 128). Every variant is
first held to the plain versions at ``chip_smoke.py``'s gates on those
shapes and on ragged cases (K and N off 4, rows past 512), then timed: CUDA
events around a run of launches (each launch's device time, the host's
issue hidden behind the queue), the variants alternated A B ... B A over
``--rounds`` rounds. With ``--parent``, last, OLMoE-1B-7B in f32 at full
width teacher-forced through the shipped kernels and the parent's,
alternated: the prefill's and the decode steps' milliseconds by CUDA
events. Every line of output is one JSON object; the last one is
``{"ok": true, ...}``.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import statistics
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np

import chip_smoke
from chip_smoke import check, emit

SEED = 5
EXPERTS, D_MODEL, D_FF, DECODE_ROWS, DECODE_USED = 64, 2048, 1024, 64, 28
PREFILL_ROWS = 87_983
GMM_VARIANTS = {
    "few_bn64": ["-DGMM_FMA_FEW_BN=64"], "few_bn128": ["-DGMM_FMA_FEW_BN=128"],
    "tile_bn128_bk8": ["-DGMM_FMA_BN=128", "-DGMM_FMA_BK=8"],
    "tile_bn128_bk16": ["-DGMM_FMA_BN=128", "-DGMM_FMA_BK=16"],
    "tile_bn128_bk32": ["-DGMM_FMA_BN=128", "-DGMM_FMA_BK=32"],
    "tile_bn256_bk8": ["-DGMM_FMA_BN=256", "-DGMM_FMA_BK=8"],
    "tile_bn256_bk16": ["-DGMM_FMA_BN=256", "-DGMM_FMA_BK=16"],
    "tile_bn256_bk32": ["-DGMM_FMA_BN=256", "-DGMM_FMA_BK=32"],
}
# the shipped library with one tiling forced at every shape (C route codes)
FORCED = {"tile_everywhere": 0, "rows_few_everywhere": 3}
# (label, B, S, H, Hkv, D) of the f32 prefill attention
ATTN_SHAPES = (("llama_prefill", 8, 1937, 32, 8, 64), ("olmoe_prefill", 8, 1937, 16, 16, 128))
LAUNCH_ARGS = {"grouped_matmul_launch": (5, 8), "flash_prefill_launch": (4, 7)}


def build_libs(b, parent: Path | None) -> dict:
    """(source, variant) -> loaded library, built in parallel."""
    jobs = {("grouped_matmul", name): (b.CSRC / "grouped_matmul.cu", flags)
            for name, flags in GMM_VARIANTS.items()}
    if parent is not None:
        csrc = parent / "src" / "repro_torch" / "kernels" / "csrc"
        for src in ("grouped_matmul", "flash_prefill"):
            jobs[src, "parent"] = (csrc / f"{src}.cu", [])
    out_dir = b.BUILD_DIR / "f32_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for (src, name), (path, flags) in jobs.items():
        check(path.exists(), f"{path} is missing")
        cmd = [b.nvcc_path(), *b.NVCC_FLAGS, *flags, "-I", str(path.parent), "-o",
               str(out_dir / f"lib{src}_{name}.so"), str(path)]
        procs[src, name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True)
    libs = {}
    for (src, name), proc in procs.items():
        stdout, stderr = proc.communicate()
        check(proc.returncode == 0, f"{src}/{name}: nvcc failed\n{stdout}{stderr}")
        emit({"variant": name, "source": src,
              "ptxas": {k: v for k, v in b.ptxas_resources(stderr).items()
                        if "tc_kernel" not in k and "gmm_" not in k}})
        libs[src, name] = ctypes.CDLL(str(out_dir / f"lib{src}_{name}.so"))
    for src in ("grouped_matmul", "flash_prefill"):
        libs[src, "shipped"] = b.library(src)
    for name in FORCED:
        libs["grouped_matmul", name] = libs["grouped_matmul", "shipped"]
    return libs


def entry(lib, fn: str):
    f = getattr(lib, fn)
    n_ptr, n_int = LAUNCH_ARGS[fn]
    f.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def grouping(rng, rows: int, used: int, most: int | None) -> np.ndarray:
    """seg_rows of ``rows`` rows over ``used`` of EXPERTS experts, at most
    ``most`` rows each (None: any)."""
    while True:
        sizes = np.zeros(EXPERTS, np.int64)
        chosen = rng.choice(EXPERTS, used, replace=False)
        sizes[chosen] = 1 + rng.multinomial(rows - used, rng.dirichlet(np.ones(used) * 8))
        if most is None or sizes.max() <= most:
            return np.concatenate([[0], np.cumsum(sizes)])


def f32_model_phase(torch, smoke, libs, rounds: int) -> None:
    """OLMoE-1B-7B in f32 at full width (``chip_smoke.py``'s weights and
    prompts; random teacher-forced tokens) through the shipped kernels and
    the parent's, alternated A B B A over ``rounds`` rounds after a warm-up
    run of each: the prefill's and the decode steps' milliseconds by CUDA
    events (``Smoke.teacher_forced``), both kernels swapped together."""
    from repro_torch.configs import get_config

    b, gm = smoke.m["build"], smoke.kernels["grouped_matmul"]
    cfg = dataclasses.replace(get_config(chip_smoke.MOE_ARCH), compute_dtype="float32")
    model = smoke.m["transformer"].init_params(
        cfg, torch.Generator(device="cuda").manual_seed(chip_smoke.LM_WEIGHT_SEED), "cuda")
    batch = smoke.lm_batch(smoke.lm_prompts(cfg.vocab_size))
    outs = torch.randint(1, cfg.vocab_size, (chip_smoke.LM_BATCH, chip_smoke.LM_NEW),
                         generator=torch.Generator(device="cuda").manual_seed(SEED),
                         device="cuda", dtype=torch.int32)

    def run(name) -> dict:
        for src in ("grouped_matmul", "flash_prefill"):
            b._LIBS[src] = libs[src, name]
            b._BOUND.pop((src, f"{src}_launch"), None)
        # the parent's grouped GEMM had one fma tiling, route 0
        tiling = {"rows_few": 0} if name == "parent" else {}
        times = {}
        with mock.patch.dict(gm.FMA_TILINGS, tiling):
            smoke.teacher_forced(model, cfg, batch, outs, times)
        return times

    names = ["shipped", "parent"]
    for name in names:
        run(name)
    times = {name: [] for name in names}
    for _ in range(rounds):
        for name in names + names[::-1]:
            times[name].append(run(name))
    run("shipped")
    emit({"f32_model": cfg.name, "compute_dtype": cfg.compute_dtype,
          "median_prefill_ms": {n: statistics.median(t["prefill_ms"] for t in v)
                                for n, v in times.items()},
          "median_decode_ms_per_step": {n: statistics.median(t["decode_ms_per_step"]
                                                             for t in v)
                                        for n, v in times.items()},
          "runs": times})


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--parent", type=Path, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("f32_variant_ablation: this needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(chip_smoke.ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full f32
    smoke = chip_smoke.Smoke(torch)
    info = smoke.card()
    smoke.build()
    b = smoke.m["build"]
    gm, fp = smoke.kernels["grouped_matmul"], smoke.kernels["flash_prefill"]
    libs = build_libs(b, args.parent)
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def weights(k, n):
        return torch.randn(EXPERTS, k, n, generator=gen, device="cuda") * k ** -0.5

    # the grouped GEMM's cases: (x, w, seg_rows); the timed ones first
    w1, w2 = weights(D_MODEL, D_FF), weights(D_FF, D_MODEL)
    dec = torch.tensor(grouping(rng, DECODE_ROWS, DECODE_USED, 7), device="cuda")
    pre = torch.tensor(grouping(rng, PREFILL_ROWS, EXPERTS, None), device="cuda")
    gmm_cases = {
        "decode_w1": (torch.randn(DECODE_ROWS, D_MODEL, generator=gen, device="cuda"), w1, dec),
        "decode_w2": (torch.randn(DECODE_ROWS, D_FF, generator=gen, device="cuda"), w2, dec),
        "prefill_w1": (torch.randn(PREFILL_ROWS, D_MODEL, generator=gen, device="cuda"), w1,
                       pre),
    }
    for label, sizes, k, n in (("ragged_few", [37, 0, 91, 12, 0, 300], 33, 98),
                               ("ragged_tile", [300, 0, 1, 257, 64], 36, 98),
                               ("ragged_tile_k17", [600, 129], 17, 130)):
        seg = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]), device="cuda")
        gmm_cases[label] = (torch.randn(sum(sizes) + 9, k, generator=gen, device="cuda"),
                            torch.randn(len(sizes), k, n, generator=gen, device="cuda"), seg)

    def gmm_call(name, x, w, seg):
        f = entry(libs["grouped_matmul", name], "grouped_matmul_launch")
        e, k, n = w.shape
        y = torch.empty(x.shape[0], n, device="cuda")
        code = 0 if name == "parent" else FORCED.get(
            name, gm.FMA_TILINGS[gm.fma_tiling(x.shape[0])])
        n_tiles = -(-x.shape[0] // gm.TILE_ROWS) + e
        return lambda: (f(x.data_ptr(), w.data_ptr(), y.data_ptr(), seg.data_ptr(), None, e,
                          n_tiles, k, n, e, 0, 0, code, stream()), y)

    attn = {}
    for label, bb, s, h, hkv, d in ATTN_SHAPES:
        attn[label] = [torch.randn(*shape, generator=gen, device="cuda")
                       for shape in ((bb, s, h, d), (bb, s, hkv, d), (bb, s, hkv, d))]
    for label, g, d, window in (("ragged_g9_d128_w24", 9, 128, 24), ("ragged_g3_d128", 3, 128, 0),
                                ("ragged_g4_d64_w24", 4, 64, 24)):
        attn[label] = [torch.randn(*shape, generator=gen, device="cuda")
                       for shape in ((2, 100, 2 * g, d), (2, 100, 2, d), (2, 100, 2, d))]
    windows = {"ragged_g9_d128_w24": 24, "ragged_g4_d64_w24": 24}

    def attn_call(name, q, k, v, window):
        f = entry(libs["flash_prefill", name], "flash_prefill_launch")
        bb, s, h, d = q.shape
        out = torch.empty_like(q)
        return lambda: (f(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bb, s, h,
                          k.shape[2], d, window, 0, stream()), out)

    gmm_names = [n for (src, n) in libs if src == "grouped_matmul"]
    attn_names = [n for (src, n) in libs if src == "flash_prefill"]
    errs = {}
    for label, (x, w, seg) in gmm_cases.items():
        n_rows = int(seg[-1])
        want = gm.grouped_matmul_plain(x, w, seg)[:n_rows]
        for name in gmm_names:
            code, y = gmm_call(name, x, w, seg)()
            check(code == 0, f"grouped_matmul/{name}/{label}: CUDA error {code}")
            errs[f"grouped_matmul/{name}/{label}"] = smoke.hold_gmm(
                f"grouped_matmul/{name}/{label}", y[:n_rows], want)
    for label, (q, k, v) in attn.items():
        want = fp.flash_prefill_plain(q, k, v, window=windows.get(label, 0))
        for name in attn_names:
            code, out = attn_call(name, q, k, v, windows.get(label, 0))()
            check(code == 0, f"flash_prefill/{name}/{label}: CUDA error {code}")
            errs[f"flash_prefill/{name}/{label}"] = smoke.hold_close(
                f"flash_prefill/{name}/{label}", out, want, chip_smoke.ATTN_F32_ATOL, 0)
        del want
    emit({"checked": errs})

    def events_ms(fn, reps: int) -> float:
        """Milliseconds a launch, CUDA events around ``reps`` launches."""
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    timed = [("grouped_matmul", label, gmm_names, 40 if label.startswith("decode") else 3)
             for label in ("decode_w1", "decode_w2", "prefill_w1")]
    timed += [("flash_prefill", label, attn_names, 3) for label, *_ in ATTN_SHAPES]
    for src, label, names, reps in timed:
        times = {name: [] for name in names}
        for _ in range(args.rounds):
            for name in names + names[::-1]:
                if src == "grouped_matmul":
                    fn = gmm_call(name, *gmm_cases[label])
                else:
                    fn = attn_call(name, *attn[label], 0)
                times[name].append(events_ms(fn, reps))
        emit({"f32_variants": src, "shape": label, "launches_per_timing": reps,
              "median_ms": {n: statistics.median(t) for n, t in times.items()},
              "spread_ms": {n: max(t) - min(t) for n, t in times.items()}, "runs_ms": times})
    if args.parent is not None:
        del gmm_cases, attn, w1, w2
        torch.cuda.empty_cache()
        f32_model_phase(torch, smoke, libs, args.rounds)
    emit({"ok": True, "device": info["device_name"], "nvidia_smi": info["nvidia_smi"]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
