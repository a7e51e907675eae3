"""Time the decode kernel's split counts and dense-slab kernel variants on one H100.

    python3 kernel_variant_ablation.py [--rounds 2]

Run from the root of a checkout, on a CUDA card. Two parts:

* Decode split count. The decode-attention kernel at both serve decode
  shapes (Llama-3.2-1B: B 8, Hkv 8, g 4, D 64; OLMoE-1B-7B: B 8, Hkv 16,
  g 1, D 128; lengths 1,953 of a 4,096 cache; bf16, seed 7) with the split
  count forced to each of 1-8 (``chunked_attention.device_split``
  patched), each held to the plain version at ``chip_smoke.py``'s bf16
  gate and timed by the profiler over traces that hold both its kernels;
  the count the wrapper chooses is marked.
* Dense-slab variants. Text-edited copies of ``csrc/ranged_spgemm.cu``,
  built beside the shipped one and swapped into the wrapper, timed at the
  brick3d n=32 quickstart staging shape (random f32 strips 6 x 6,351 x
  65,536 against one 32,768 x 4,096 slab, seed 0) by launch events, the
  variants alternated A B ... B A over ``--rounds`` rounds: ``no_slices``
  loads only the first two k-slices (the inner product loop alone),
  ``no_global_reads`` zero-fills every slice (staging without global
  reads), ``bk32`` takes 32-deep slices with coalesced A loads into an
  XOR-swizzled tile (dynamic shared memory). The two variants without
  loads compute wrong results by design; the shipped kernel and ``bk32``
  are held to the plain version at ``chip_smoke.py``'s gate first.
  The edits are exact strings of ``csrc/ranged_spgemm.cu`` as of commit
  c7c22c5; a later edit of that file makes them fail loudly, and the
  variants are then rebuilt from that commit's file, not from HEAD's.

Every line of output is one JSON object; the last one is
``{"ok": true, ...}``.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys

import chip_smoke
from chip_smoke import ATTN_BF16_ULPS, ATTN_F32_ATOL, check, emit

DECODE_SHAPES = {"llama3_2_1b": (8, 8, 4, 64), "olmoe_1b_7b": (8, 16, 1, 128)}
CACHE, LENGTH, SPLITS = 4096, 1953, range(1, 9)
DENSE_SHAPE = (1, 6, 6351, 65536, 1, 32768, 4096)   # batch, strips, rows, k_pad, n_b, span, n
LOOP = "      if (more) load((kt + 1) * BK, cur ^ 1);"
STORE = "      if (more) store(cur ^ 1);"
VARIANTS = {
    "no_slices": [(LOOP, LOOP.replace("more)", "more && kt < 1)")),
                  (STORE, STORE.replace("more)", "more && kt < 1)"))],
    "no_global_reads": [("if (a_ok && kk < span) x", "if (a_ok && kk < 0) x"),
                        ("const bool valid = kr < span && b_col < n;",
                         "const bool valid = false;")],
    "bk32": [
        ("BK = 16, THREADS = 256;\nconstexpr int AS = BM + 4;   // As row stride: the "
         "transposing stores hit 32 banks",
         "BK = 32, THREADS = 256;\nconstexpr int SMEM = 2 * BK * (BM + BN) * (int)sizeof(float);\n"
         "__device__ __forceinline__ int as_col(int k, int m) { return m ^ (((k >> 2) & 7) << 2); }"),
        ("  __shared__ __align__(16) float As[2][BK][AS];\n"
         "  __shared__ __align__(16) float Bs[2][BK][BN];",
         "  extern __shared__ __align__(16) float smem[];\n"
         "  float (*As)[BK][BM] = reinterpret_cast<float (*)[BK][BM]>(smem);\n"
         "  float (*Bs)[BK][BN] = reinterpret_cast<float (*)[BK][BN]>(smem + 2 * BK * BM);"),
        ("  const int a_row = (tid / 32) * 16 + tid % 16;\n"
         "  const int a_kq = ((tid % 32) / 16) * 4;",
         "  const int a_row = warp * 4 + lane / 8;\n  const int a_kq = (lane % 8) * 4;"),
        ("  const bool a_ok = row0 + a_row < strip_rows;\n"
         "  const float* a_src = A + (long long)(a_ok ? row0 + a_row : 0) * k_pad;",
         "  const int a_rows = strip_rows - row0 - a_row;\n"
         "  const float* a_src = A + (long long)min(row0 + a_row, strip_rows - 1) * k_pad;"),
        ("        const int kk = k0 + a_kq + 8 * l;\n",
         "        const int kk = k0 + a_kq;\n        const bool a_ok = 32 * l < a_rows;\n"
         "        const float* a_l = a_src + (a_ok ? 32 * l * (long long)k_pad : 0);\n"),
        ("x = *reinterpret_cast<const float4*>(a_src + r0 + kk);",
         "x = *reinterpret_cast<const float4*>(a_l + r0 + kk);"),
        ("? a_src[r0 + kk + e] : 0.f;", "? a_l[r0 + kk + e] : 0.f;"),
        ("As[buf][a_kq + 8 * l + e][a_row] = areg[l][e];",
         "As[buf][a_kq + e][as_col(a_kq + e, a_row + 32 * l)] = areg[l][e];"),
        ("&As[cur][kk][wm0 + lm * 4]", "&As[cur][kk][as_col(kk, wm0 + lm * 4)]"),
        ("&As[cur][kk][wm0 + 16 + lm * 4]", "&As[cur][kk][as_col(kk, wm0 + 16 + lm * 4)]"),
        ("  if (order == 1) {\n    ranged_dense_kernel<VEC><<<grid, THREADS, 0, s>>>",
         "  tc::allow_smem(ranged_dense_kernel<VEC>, SMEM);\n"
         "  if (order == 1) {\n    ranged_dense_kernel<VEC><<<grid, THREADS, SMEM, s>>>"),
        ("ranged_dense_kernel<VEC><<<grid, THREADS, 0, s>>>(a, b, j == 0",
         "ranged_dense_kernel<VEC><<<grid, THREADS, SMEM, s>>>(a, b, j == 0"),
    ],
}


def build_variants(b) -> dict:
    """Each variant's library, built in parallel beside the shipped one."""
    src = (b.CSRC / "ranged_spgemm.cu").read_text()
    out_dir = b.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            check(text.count(old) == 1, f"{name}: the edit target {old!r} is not unique")
            text = text.replace(old, new)
        (out_dir / f"{name}.cu").write_text(text)
        cmd = [b.nvcc_path(), *b.NVCC_FLAGS, "-I", str(b.CSRC), "-o",
               str(out_dir / f"lib{name}.so"), str(out_dir / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate()
        check(proc.returncode == 0, f"{name}: nvcc failed\n{stdout}{stderr}")
        emit({"variant": name, "ptxas": list(b.ptxas_resources(stderr).values())})
        libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
    return libs


def decode_part(torch, smoke) -> None:
    mod = smoke.kernels["decode_attention"]
    chosen_split = mod.device_split
    for label, (b, hkv, g, d) in DECODE_SHAPES.items():
        q, k, v = (x.bfloat16() for x in smoke.attn_inputs(
            7, (b, hkv, g, d), (b, CACHE, hkv, d), (b, CACHE, hkv, d)))
        lens = torch.full((b,), LENGTH, dtype=torch.int32, device="cuda")
        want = mod.decode_attention_plain(q, k, v, lens)
        chosen = chosen_split(b, hkv, CACHE, lens.device)
        rows = {}
        for n in SPLITS:
            mod.device_split = lambda *_, n=n: n
            run = lambda: mod.decode_attention(q, k, v, lens)  # noqa: E731
            smoke.hold_close(f"decode_attention/{label}/split{n}", run(), want,
                             ATTN_F32_ATOL, ATTN_BF16_ULPS)
            ms, incomplete = chip_smoke.kernel_device_ms(
                torch, run, chip_smoke.TRACE_NAMES["decode_attention"], mod.KERNELS_PER_CALL)
            rows[n] = {"device_ms": ms, "incomplete_traces": incomplete,
                       "blocks": b * hkv * n}
        mod.device_split = chosen_split
        emit({"decode_splits": label, "shape": [b, hkv, g, d], "cache": CACHE,
              "length": LENGTH, "chosen": chosen, "by_split": rows})


def dense_part(torch, smoke, rounds: int) -> None:
    b, mod = smoke.m["build"], smoke.kernels["ranged_spgemm"]
    libs = {"shipped": b.library("ranged_spgemm"), **build_variants(b)}

    def use(name):
        b._LIBS["ranged_spgemm"] = libs[name]
        b._BOUND.pop(("ranged_spgemm", "ranged_spgemm_launch"), None)

    batch, n_ac, rows, k_pad, n_b, span, n = DENSE_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(batch, n_ac, rows, k_pad, generator=gen, device="cuda")
    slabs = torch.randn(batch, n_b, span, n, generator=gen, device="cuda")
    c0 = torch.zeros(batch, n_ac, rows, n, device="cuda")
    r0s = [0]
    run = lambda: mod.ranged_spgemm_stream(a, slabs, c0, r0s, order="chunk1")  # noqa: E731
    want = mod.ranged_spgemm_plain(a, slabs, c0, r0s, order="chunk1")
    for name in ("shipped", "bk32"):
        use(name)
        smoke.hold_dense(f"ranged_spgemm/{name}", run(), want)
    del want
    times = {name: [] for name in libs}
    order = list(libs)
    for _ in range(rounds):
        for name in order + order[::-1]:
            use(name)
            times[name].append(smoke.launch_ms(run))
    use("shipped")
    emit({"dense_variants": "brick3d32_quickstart_shape", "shape": list(DENSE_SHAPE),
          "path": mod.choose_path(a, slabs, c0, r0s), "ms": times,
          "median_ms": {name: statistics.median(t) for name, t in times.items()}})


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variant_ablation: this needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(chip_smoke.ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version in full f32
    smoke = chip_smoke.Smoke(torch)
    info = smoke.card()
    smoke.build()
    decode_part(torch, smoke)
    dense_part(torch, smoke, args.rounds)
    emit({"ok": True, "device": info["device_name"], "nvidia_smi": info["nvidia_smi"]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
