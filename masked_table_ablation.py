"""Time the masked hash kernel at two table load factors on one H100.

    python3 masked_table_ablation.py

Run from the root of a checkout, on a CUDA card. On L of rmat(18, 16,
seed=7), degree-sorted lower triangle (the graph of ``chip_smoke.py``'s
``tc_rmat18_fused`` run), under a one-chunk knl plan, it launches
``hash_masked_accum_spgemm_stream`` with every row's table sized two ways:
at least twice the row's mask nnz (load factor at most 1/2, the shipped
``masked_table_slots``) and the row's mask nnz rounded up to a power of two
(load factor up to 1). The two sizes alternate (shipped, full, full,
shipped), each timed as the median launch milliseconds of
``chip_smoke.TIMED_REPS`` calls, and the full-table output must equal the
shipped one in structure and agree in value. Every line of output is one JSON object; the last one is
``{"ok": true, ...}``.
"""

from __future__ import annotations

import sys

import chip_smoke
from chip_smoke import KERNEL_ATOL, KERNEL_RTOL, RMAT_EDGE_FACTOR, RMAT_SCALE, RMAT_SEED, \
    check, emit


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("masked_table_ablation: this needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(chip_smoke.ROOT / "src"))
    smoke = chip_smoke.Smoke(torch)
    smoke.card()
    smoke.build()
    mod, planner = smoke.kernels["hash_masked_accum_spgemm"], smoke.m["planner"]
    L = smoke.m["graphs"].lower_triangular_degree_sorted(
        smoke.m["graphs"].rmat(RMAT_SCALE, RMAT_EDGE_FACTOR, seed=RMAT_SEED, device="cuda"))
    plan = planner.plan_knl(L, L, float("inf"))
    caps = smoke.m["symbolic"].masked_output_caps(L, plan.p_ac)
    args, table, _ = smoke.m["chunk_stream"].stage_hash_masked(L, L, L, plan, caps.c_pad,
                                                               caps)
    run = lambda: mod.hash_masked_accum_spgemm_stream(  # noqa: E731
        *args, order="chunk1", table_size=table)
    shipped = mod.masked_table_slots
    sizes = {"load_le_half": shipped, "load_le_one": planner.hash_table_slots}
    times = {name: [] for name in sizes}
    outputs = {}
    for name in ("load_le_half", "load_le_one", "load_le_one", "load_le_half"):
        mod.masked_table_slots = sizes[name]
        try:
            outputs[name] = run()
            times[name].append(smoke.launch_ms(run))
            _, launches = mod.masked_plan(*args[:2], *args[3:])
        finally:
            mod.masked_table_slots = shipped
        emit({"variant": name, "ms": times[name][-1], "launches": launches.groups,
              "global_table_slots": int(launches.goff[-1])})
    got, want = outputs["load_le_one"], outputs["load_le_half"]
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "the full tables give another structure")
    check(bool(torch.allclose(got[2], want[2], atol=KERNEL_ATOL, rtol=KERNEL_RTOL)),
          "the full tables give other values")
    emit({"masked_table_ablation": {
        "graph": f"rmat({RMAT_SCALE}, {RMAT_EDGE_FACTOR}, seed={RMAT_SEED})",
        "nnz_L": L.nnz(), "plan": plan.algorithm,
        "ms": times, "max_abs_diff": float((got[2] - want[2]).abs().max())}})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
