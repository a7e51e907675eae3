"""Time the in-place route of this checkout against another's on one H100.

    python3 inplace_strip_ablation.py --parent DIR [--rounds 3]

Run from the root of a checkout, on a CUDA card, with ``DIR`` a checkout of
another commit (e.g. the parent one, unpacked by ``git archive`` into a
gitignored directory). Each tree's whole package runs in a worker process
of its own (``PYTHONPATH=<tree>/src``; this checkout's ``chip_smoke.py``
builds the problems), and each times ``chunked_spgemm(...,
slow_reads="in_place")`` with every operand in pinned host memory on the
placement phase's calls: brick3d n=48 under the quickstart plan (chunk2 6 x
1) through ``hash`` and ``sparse`` and under the budget/3 plan (chunk1 15 x
4) through ``hash``, and brick3d n=16 under its quickstart plan through the
dense slab (``pallas``). Each worker first holds each call's C to its own
all-fast call, bit for bit, then answers timing requests: the kernels' ms
(CUDA events around each launch, ``LaunchTimer``, summed over the call's
launches), the wall with the card synchronized, the launches and the
peak allocation, each the median of three calls; the trees alternate A B
B A over ``--rounds`` rounds. A parent that launches once a call against a
change that launches once a strip is the cost of the split.

Every line of output is one JSON object; the last one is ``{"ok": true,
...}``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import chip_smoke
from chip_smoke import check, emit

CALLS = (("brick3d48_quickstart_hash", 48, 1, "hash"),
         ("brick3d48_quickstart_sparse", 48, 1, "sparse"),
         ("brick3d48_chunk1_hash", 48, 3, "hash"),
         ("brick3d16_quickstart_pallas", 16, 1, "pallas"))
REPEATS = 3


def worker() -> int:
    """One tree's in-place calls (the ``repro_torch`` on ``PYTHONPATH``):
    hold each to the all-fast call, print ``{"ready": ...}``, then time
    the call each line of standard input names until "quit"."""
    import torch

    smoke = chip_smoke.Smoke(torch)
    smoke.m["build"].build(("ranged_spgemm", "sparse_accum_spgemm", "hash_accum_spgemm",
                            "host_map"))
    planner, chunking, placement = smoke.m["planner"], smoke.m["chunking"], smoke.m["placement"]
    counters = smoke.counters
    calls, ready = {}, {"ready": chunking.__file__}
    for label, n, div, backend in CALLS:
        A, P = smoke.problem("brick3d", n)
        crb, budget = smoke.quickstart_inputs(A, P)
        plan = planner.plan_chunks(A, P, crb, smoke.m["memory_model"].P100,
                                   fast_limit_bytes=budget / div)
        caps = smoke.m["symbolic"].strip_output_caps(A, P, plan.p_ac)
        want, _ = chunking.chunked_spgemm(A, P, plan, backend=backend, caps=caps)
        pinned = placement.place({"A": A, "B": P}, "slow")

        def call(pinned=pinned, plan=plan, backend=backend, caps=caps):
            return chunking.chunked_spgemm(pinned["A"], pinned["B"], plan, backend=backend,
                                           placement=placement.ALL_SLOW,
                                           slow_reads="in_place", caps=caps)[0]

        got = call()
        for f in ("indptr", "indices", "data"):
            check(torch.equal(getattr(got, f).cpu(), getattr(want, f).cpu()),
                  f"{label}: C.{f} in place differs from the all-fast call's")
        del got, want
        calls[label] = call
        ready[label] = {"plan": [plan.algorithm, plan.n_ac, plan.n_b]}
    print(json.dumps(ready), flush=True)
    for line in sys.stdin:
        label = line.strip()
        if label == "quit":
            break
        runs = []
        for _ in range(REPEATS):
            for counter in counters.values():
                counter.reset()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            with smoke.m["build"].LaunchTimer() as timer:
                calls[label]()
            torch.cuda.synchronize()
            runs.append({"wall_s": time.perf_counter() - t0, "kernel_ms": timer.ms(),
                         "launches": sum(c.count for k, c in counters.items() if "/" not in k),
                         "peak_alloc_bytes": torch.cuda.max_memory_allocated() - before})
        print(json.dumps({k: statistics.median(r[k] for r in runs) for k in runs[0]}),
              flush=True)
    return 0


def parent_mode(parent: Path, rounds: int) -> None:
    """This checkout's in-place calls against ``parent``'s, alternated."""
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
        labels = [label for label, *_ in CALLS]
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
        med = {name: {key: statistics.median(r[key] for r in rs)
                      for key in ("kernel_ms", "wall_s", "launches", "peak_alloc_bytes")}
               for name, rs in by_tree.items()}
        emit({"inplace_strip_ablation": label, "median": med,
              "change_over_parent": {key: med["change"][key] / med["parent"][key]
                                     for key in ("kernel_ms", "wall_s", "peak_alloc_bytes")},
              "runs": by_tree})


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--parent", type=Path, required=False)
    parser.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("inplace_strip_ablation: this needs a CUDA card", file=sys.stderr)
        return 2
    if args.worker:
        return worker()
    if args.parent is None:
        parser.error("--parent DIR is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    emit({"card": {"nvidia_smi": smi, "device_name": torch.cuda.get_device_name(0)}})
    parent_mode(args.parent, args.rounds)
    emit({"ok": True, "device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
