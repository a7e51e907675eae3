"""Time variants of the ESC merge kernel on one H100, where its time goes.

    python3 esc_variant_ablation.py [--rounds 2]
    python3 esc_variant_ablation.py --parent DIR [--rounds 2]

Run from the root of a checkout, on a CUDA card. Text-edited copies of
``csrc/sparse_accum_spgemm.cu`` are built beside the shipped one and swapped
into the wrapper, then run at the main path's staging of brick3d n=48 (the
quickstart budget, chunk2 6 x 1, an empty C_prev) and at its four-chunk plan
(chunk1 15 x 4, C_prev = P's strips), each timed by the profiler (device ms
of the call's merge, scan and copy kernels, over traces that hold all of
them), the variants alternated A B ... B A over ``--rounds`` rounds:

* ``blocks3``: 3 blocks of 8 warps an SM asked for instead of 4, so up to 80
  registers a thread and 24 warps an SM instead of 64 and 32;
* ``smem_compress``: the sorted keys stored to shared memory and compressed
  there, one lane walking each run (the parent kernel's compress), instead
  of compressing from the registers;
* ``no_compress``: the merge stops after the register sort (the output is
  wrong by design: the time of expand and sort);
* ``expand_only``: the merge stops after the expand (wrong by design).

The shipped kernel and the variants that keep the output are held to the
plain version first (structure equal, values at ``chip_smoke.py``'s
tolerance). The edits are exact strings of ``csrc/sparse_accum_spgemm.cu``
as committed with this script; a later edit of that file makes them fail
loudly.

With ``--parent DIR`` (a checkout of another commit, e.g. the parent one
unpacked by ``git archive`` into a gitignored directory) it times instead
the ESC call of this checkout against that checkout's, each tree's whole
package (wrapper, launch plan, kernels) in a worker process of its own
(``PYTHONPATH=<tree>/src``; this script's ``chip_smoke.py`` stages the
operands, and the wrapper's signature is the same in both): L x L of
rmat(12, 16, seed 100) under ``plan_knl`` at a third of L's row bytes (4
chunks, chunk1: PERF.md row 2b) and the brick3d n=48 quickstart staging
(chunk2 6 x 1: row 2). Each worker first holds its call to the plain
version, then answers timing requests: launch-event ms, the profiler's
device ms of the call's kernels (over traces that hold them all, the
tree's own ``kernels_per_call``) and CUDA events around five calls back to
back, the trees alternated A B B A over ``--rounds`` rounds.

Every line of output is one JSON object; the last one is ``{"ok": true,
...}``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import chip_smoke
from chip_smoke import check, emit

SORT = """    if ((unsigned long long)top < (1ull << (32 - pos_bits(*s.p))))
      sort_keys<K>(s, cols);
    else
      sort_wide<K>(s, cols);"""
COMPRESS = "    compress_regs<K>(*s.p, key, s.n, pos_bits(*s.p), lane);"
VARIANTS = {
    "blocks3": [("kMinBlocksPerSM = 4;", "kMinBlocksPerSM = 3;")],
    "smem_compress": [(COMPRESS, """    unsigned* k = reinterpret_cast<unsigned*>(keys);
#pragma unroll
    for (int r = 0; r < K; ++r)
      if (lane * K + r < s.n) k[lane * K + r] = key[r];
    __syncwarp();
    compress(*s.p, k, s.n, pos_bits(*s.p), lane);""")],
    "no_compress": [(COMPRESS, "    acc_n = __any_sync(kFull, key[0] == 0u);")],
    "expand_only": [(SORT, "    acc_n = top == 0xffffffffu;")],
}
CHECKED = ("shipped", "blocks3", "smem_compress")


def build_variants(b) -> dict:
    """Each variant's library, built in parallel beside the shipped one."""
    src = (b.CSRC / "sparse_accum_spgemm.cu").read_text()
    out_dir = b.BUILD_DIR / "esc_variants"
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


def worker() -> int:
    """One tree's ESC calls (the ``repro_torch`` on ``PYTHONPATH``): build,
    hold each call to its plain version, print ``{"ready": ...}``, then
    time the call each line of standard input names until "quit"."""
    import torch

    smoke = chip_smoke.Smoke(torch)
    smoke.m["build"].build(("sparse_accum_spgemm",))
    mod = smoke.kernels["sparse_accum_spgemm"]
    L = smoke.rmat_l(chip_smoke.BATCH_RMAT_SEEDS[0])
    A, P = smoke.problem("brick3d", 48)
    crb, budget = smoke.quickstart_inputs(A, P)
    quick = smoke.m["planner"].plan_chunks(A, P, crb, smoke.m["memory_model"].P100,
                                           fast_limit_bytes=budget)
    calls, ready = {}, {"ready": mod.__file__}
    for label, (a, b, plan) in {"rmat12_knl": (L, L, smoke.rmat_plan(L)),
                                "brick3d48_quickstart": (A, P, quick)}.items():
        Ast, Bst, C0, r0s, r1s, caps = smoke.stage_csr(a, b, plan)
        run, plain = smoke.csr_runners("sparse_accum_spgemm", Ast, Bst, C0, r0s, r1s,
                                       caps.c_max_row_nnz)
        order = "chunk2" if plan.algorithm == "chunk2" else "chunk1"
        launch = mod.esc_launch_plan(Ast, Bst, C0, r0s, r1s, row_cap=caps.c_max_row_nnz)
        kernels = mod.kernels_per_call(order, plan.n_b, launch)
        ready[label] = {"order": order, "kernels_per_call": kernels,
                        **smoke.hold_csr(f"{label}/{order}", run(order), plain(order))}
        calls[label] = (lambda run=run, order=order: run(order), kernels)
    print(json.dumps(ready), flush=True)
    for line in sys.stdin:
        label = line.strip()
        if label == "quit":
            break
        fn, kernels = calls[label]
        device, incomplete, split, _ = chip_smoke.kernel_device_split(
            torch, fn, chip_smoke.TRACE_NAMES["csr_accum"], kernels)
        print(json.dumps({"ms": smoke.launch_ms(fn), "device_ms": device,
                          "incomplete_traces": incomplete, "split_ms": split,
                          "queued_ms": chip_smoke.queued_ms(torch, fn)}), flush=True)
    return 0


def parent_mode(parent: Path, rounds: int) -> None:
    """This checkout's ESC calls against ``parent``'s, alternated."""
    check((parent / "src" / "repro_torch").is_dir(), f"{parent}/src/repro_torch is missing")
    trees = {"parent": parent.resolve(), "change": chip_smoke.ROOT}
    workers = {}
    for name, tree in trees.items():
        env = dict(os.environ, PYTHONPATH=str(tree / "src"))
        workers[name] = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--worker"], env=env,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=chip_smoke.ROOT)

    def ask(name: str, line: str | None = None) -> dict:
        proc = workers[name]
        if line is not None:
            proc.stdin.write(line + "\n")
            proc.stdin.flush()
        out = proc.stdout.readline()
        check(bool(out), f"{name}: the worker ended (exit {proc.poll()})")
        return json.loads(out)

    try:
        for name in trees:
            emit({"tree": name, "root": str(trees[name]), **ask(name)})
        labels = ("rmat12_knl", "brick3d48_quickstart")
        runs = {label: {name: [] for name in trees} for label in labels}
        for _ in range(rounds):
            for name in ("parent", "change", "change", "parent"):
                for label in labels:
                    runs[label][name].append(ask(name, label))
        for proc in workers.values():
            proc.stdin.write("quit\n")
            proc.stdin.flush()
            check(proc.wait(timeout=120) == 0, "a worker failed")
    finally:
        for proc in workers.values():
            if proc.poll() is None:
                proc.kill()
    for label, by_tree in runs.items():
        med = {name: {key: statistics.median(r[key] for r in rs if r[key] is not None)
                      if any(r[key] is not None for r in rs) else None
                      for key in ("ms", "device_ms", "queued_ms")}
               for name, rs in by_tree.items()}
        emit({"esc_parent_ablation": label, "median": med,
              "change_over_parent": {key: (med["change"][key] / med["parent"][key]
                                           if med["change"][key] and med["parent"][key]
                                           else None)
                                     for key in ("ms", "device_ms", "queued_ms")},
              "runs": by_tree})


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--parent", type=Path, default=None)
    parser.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("esc_variant_ablation: this needs a CUDA card", file=sys.stderr)
        return 2
    if args.worker:
        return worker()
    if args.parent is not None:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip()
        emit({"card": {"nvidia_smi": smi, "device_name": torch.cuda.get_device_name(0)}})
        parent_mode(args.parent, args.rounds)
        emit({"ok": True, "device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
        return 0
    sys.path.insert(0, str(chip_smoke.ROOT / "src"))
    smoke = chip_smoke.Smoke(torch)
    info = smoke.card()
    smoke.build()
    b, mod = smoke.m["build"], smoke.kernels["sparse_accum_spgemm"]
    libs = {"shipped": b.library("sparse_accum_spgemm"), **build_variants(b)}

    def use(name):
        b._LIBS["sparse_accum_spgemm"] = libs[name]
        b._BOUND.pop(("sparse_accum_spgemm", "sparse_accum_launch"), None)

    planner, mm = smoke.m["planner"], smoke.m["memory_model"]
    A, P = smoke.problem("brick3d", 48)
    crb, budget = smoke.quickstart_inputs(A, P)
    plans = {"brick3d48_quickstart": (planner.plan_chunks(A, P, crb, mm.P100,
                                                          fast_limit_bytes=budget), None),
             "brick3d48_chunk1_c0": (planner.plan_chunks(A, P, crb, mm.P100,
                                                         fast_limit_bytes=budget / 3), P)}
    for label, (plan, c0_from) in plans.items():
        Ast, Bst, C0, r0s, r1s, caps = smoke.stage_csr(A, P, plan, c0_from)
        run, plain = smoke.csr_runners("sparse_accum_spgemm", Ast, Bst, C0, r0s, r1s,
                                       caps.c_max_row_nnz)
        order = "chunk2" if plan.algorithm == "chunk2" else "chunk1"
        want = plain(order)
        for name in CHECKED:
            use(name)
            smoke.hold_csr(f"sparse_accum_spgemm/{name}/{label}", run(order), want)
        del want
        times = {name: [] for name in libs}
        names = list(libs)
        for _ in range(args.rounds):
            for name in names + names[::-1]:
                use(name)
                ms, incomplete, split, _ = chip_smoke.kernel_device_split(
                    torch, lambda: run(order), chip_smoke.TRACE_NAMES["csr_accum"],
                    mod.kernels_per_call(order, plan.n_b))
                check(ms is not None, f"{name}/{label}: no complete trace")
                times[name].append({"device_ms": ms, "split_ms": split,
                                    "incomplete_traces": incomplete})
        use("shipped")
        emit({"esc_variants": label, "order": order,
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
