"""Time variants of the hash merge kernel on one H100, where its time goes.

    python3 hash_variant_ablation.py [--rounds 2]

Run from the root of a checkout, on a CUDA card. Text-edited copies of
``csrc/hash_accum_spgemm.cu`` are built beside the shipped one and swapped
into the wrapper, then run at the main path's staging of brick3d n=48 (the
quickstart budget, chunk2 6 x 1, an empty C_prev) and at its four-chunk plan
(chunk1 15 x 4, C_prev = P's strips), each timed by the profiler (device ms
of the call's merge, scan and copy kernels, over traces that hold all of
them), the variants alternated A B ... B A over ``--rounds`` rounds:

* ``low_bits``: each probe starts at the reference's slot, the low
  log2(T) bits of the Knuth hash, instead of its top bits;
* ``blocks4``: the 32-slot tables' kernel asks for 4 blocks of 8 warps an
  SM instead of 8, so up to 64 registers a thread (48 used) instead of 32;
* ``no_sort``: the extraction writes the table's occupied slots unsorted
  (the output is wrong by design: the time of the register sort);
* ``expand_only``: the merge loads every product and inserts none (wrong
  by design: the time of the expand).

The shipped kernel and the variants that keep the output are held to the
plain version first (structure equal, values at ``chip_smoke.py``'s
tolerance). The edits are exact strings of ``csrc/hash_accum_spgemm.cu`` as
committed with this script; a later edit of that file makes them fail
loudly. Every line of output is one JSON object; the last one is
``{"ok": true, ...}``.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys

import chip_smoke
from chip_smoke import check, emit

SOURCE = "hash_accum_spgemm"
INSERT = "        if (src >= 0) ok &= insert(b_ix[src], a * b_d[src]);"
VARIANTS = {
    "low_bits": [("__umulhi((unsigned)col * kKnuth, (unsigned)table);",
                  "((unsigned)col * kKnuth) & mask;")],
    "blocks4": [("kMinBlocksPerSM = kMaxK == 1 ? 8 :", "kMinBlocksPerSM = kMaxK == 1 ? 4 :")],
    "no_sort": [("    csr_accum::bitonic_regs_kv<K>(key, val, lane);\n", "")],
    "expand_only": [(INSERT, "        if (src >= 0)"
                             " ok &= (b_ix[src] ^ __float_as_int(a * b_d[src])) != 0x7fffffff;")],
}
CHECKED = ("shipped", "low_bits", "blocks4")


def build_variants(b) -> dict:
    """Each variant's library, built in parallel beside the shipped one."""
    src = (b.CSRC / f"{SOURCE}.cu").read_text()
    out_dir = b.BUILD_DIR / "hash_variants"
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
        emit({"variant": name, "ptxas": {k: v for k, v in b.ptxas_resources(stderr).items()
                                         if "accum_rows_kernel" in k}})
        libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
    return libs


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("hash_variant_ablation: this needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(chip_smoke.ROOT / "src"))
    smoke = chip_smoke.Smoke(torch)
    info = smoke.card()
    smoke.build()
    b = smoke.m["build"]
    esc = smoke.kernels["sparse_accum_spgemm"]
    libs = {"shipped": b.library(SOURCE), **build_variants(b)}

    def use(name):
        b._LIBS[SOURCE] = libs[name]
        b._BOUND.pop((SOURCE, "hash_accum_launch"), None)

    planner, mm = smoke.m["planner"], smoke.m["memory_model"]
    A, P = smoke.problem("brick3d", 48)
    crb, budget = smoke.quickstart_inputs(A, P)
    plans = {"brick3d48_quickstart": (planner.plan_chunks(A, P, crb, mm.P100,
                                                          fast_limit_bytes=budget), None),
             "brick3d48_chunk1_c0": (planner.plan_chunks(A, P, crb, mm.P100,
                                                         fast_limit_bytes=budget / 3), P)}
    for label, (plan, c0_from) in plans.items():
        Ast, Bst, C0, r0s, r1s, caps = smoke.stage_csr(A, P, plan, c0_from)
        run, plain = smoke.csr_runners(SOURCE, Ast, Bst, C0, r0s, r1s, caps.c_max_row_nnz)
        order = "chunk2" if plan.algorithm == "chunk2" else "chunk1"
        want = plain(order)
        for name in CHECKED:
            use(name)
            smoke.hold_csr(f"{SOURCE}/{name}/{label}", run(order), want)
        del want
        times = {name: [] for name in libs}
        names = list(libs)
        for _ in range(args.rounds):
            for name in names + names[::-1]:
                use(name)
                ms, incomplete, split = chip_smoke.kernel_device_split(
                    torch, lambda: run(order), chip_smoke.TRACE_NAMES["csr_accum"],
                    esc.kernels_per_call(order, plan.n_b))
                check(ms is not None, f"{name}/{label}: no complete trace")
                times[name].append({"device_ms": ms, "split_ms": split,
                                    "incomplete_traces": incomplete})
        use("shipped")
        emit({"hash_variants": label, "order": order,
              "plan": [plan.algorithm, plan.n_ac, plan.n_b],
              "median_device_ms": {n: statistics.median(t["device_ms"] for t in v)
                                   for n, v in times.items()},
              "median_merge_ms": {n: statistics.median(t["split_ms"]["accum_rows_kernel"]
                                                       for t in v)
                                  for n, v in times.items()},
              "runs": times})
    emit({"ok": True, "device": info["device_name"], "nvidia_smi": info["nvidia_smi"]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
