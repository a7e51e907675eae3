"""Time the grouped GEMM's bf16 routes at the OLMoE-1B-7B decode shape on one H100.

    python3 gmm_route_ablation.py [--rounds 12]

Run from the root of a checkout, on a CUDA card. It builds the kernels and
lays out the expert products of one OLMoE-1B-7B decode step of the serve
batch: 16 layers of w1 and w3 ``[64, 2048, 1024]`` and w2 ``[64, 1024,
2048]`` in bf16 (random, seed 5; 12.9 GB, so a step reads its weights from
HBM as the served step does), and 64 rows (8 tokens x top-8) a layer,
grouped into 28 experts of 1 to 7 rows (a grouping of its own a layer; the
serve run's layer 0 had 28 experts, the largest 7 rows). Every bf16 route
of ``grouped_matmul_ragged`` runs the step's 48 products; the routes
alternate in each round (A B B A), each step timed as the summed
milliseconds of its launches (CUDA events around each launch, as
``chip_smoke.py``'s ``ms``), the w1 / w3 and w2 launches summed apart. Each
route's outputs on layer 0 are held to the plain version at
``chip_smoke.py``'s grouped-GEMM gates. Every line of output is one JSON
object; the last one is ``{"ok": true, ...}``.
"""

from __future__ import annotations

import argparse
import statistics
import sys

import numpy as np

import chip_smoke
from chip_smoke import check, emit

LAYERS, EXPERTS, D_MODEL, D_FF = 16, 64, 2048, 1024
ROWS, USED, SEED = 64, 28, 5


def grouping(rng) -> np.ndarray:
    """seg_rows of ROWS rows over USED of EXPERTS experts, 1 to 7 rows each."""
    while True:
        sizes = np.zeros(EXPERTS, np.int64)
        chosen = rng.choice(EXPERTS, USED, replace=False)
        sizes[chosen] = 1 + rng.multinomial(ROWS - USED, rng.dirichlet(np.ones(USED)))
        if sizes.max() <= 7:
            return np.concatenate([[0], np.cumsum(sizes)])


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=12)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("gmm_route_ablation: this needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(chip_smoke.ROOT / "src"))
    smoke = chip_smoke.Smoke(torch)
    smoke.card()
    smoke.build()
    gm, timer_cls = smoke.kernels["grouped_matmul"], smoke.m["build"].LaunchTimer
    routes = [r for r in gm.ROUTES if r != "fma"]
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf = torch.bfloat16

    def weights(k, n):
        return (torch.randn(EXPERTS, k, n, generator=gen, device="cuda") * k ** -0.5).to(bf)
    seg = [torch.tensor(grouping(rng), device="cuda") for _ in range(LAYERS)]
    w1 = [weights(D_MODEL, D_FF) for _ in range(LAYERS)]
    w3 = [weights(D_MODEL, D_FF) for _ in range(LAYERS)]
    w2 = [weights(D_FF, D_MODEL) for _ in range(LAYERS)]
    x = torch.randn(ROWS, D_MODEL, generator=gen, device="cuda").to(bf)
    h = torch.randn(ROWS, D_FF, generator=gen, device="cuda").to(bf)

    def step(route):
        for layer in range(LAYERS):
            for xs, w in ((x, w1), (x, w3), (h, w2)):
                gm.grouped_matmul_ragged(xs, w[layer], seg[layer], route=route)

    errs = {}
    for route in routes:
        for name, xs, w in (("w1", x, w1[0]), ("w2", h, w2[0])):
            errs[f"{route}/{name}"] = smoke.hold_gmm(
                f"grouped_matmul/{route}/{name}",
                gm.grouped_matmul_ragged(xs, w, seg[0], route=route),
                gm.grouped_matmul_plain(xs, w, seg[0]))
        step(route)   # warm-up
    torch.cuda.synchronize()
    times = {r: {"w1_w3": [], "w2": [], "step": []} for r in routes}
    order = routes + routes[::-1]
    for _ in range(args.rounds):
        for route in order:
            with timer_cls() as timer:
                step(route)
            torch.cuda.synchronize()
            ms = [s.elapsed_time(e) for s, e in timer.events]
            check(len(ms) == 3 * LAYERS, f"{route}: {len(ms)} launches timed")
            t = times[route]
            t["w2"].append(sum(ms[2::3]))
            t["w1_w3"].append(sum(ms) - t["w2"][-1])
            t["step"].append(sum(ms))
    summary = {}
    for route, t in times.items():
        summary[route] = {k: {"median": statistics.median(v), "min": min(v), "max": max(v),
                              "spread": (max(v) - min(v)) / statistics.median(v)}
                          for k, v in t.items()}
    if len(routes) == 2:
        a, b = routes
        summary[f"{b}_over_{a}"] = {k: summary[b][k]["median"] / summary[a][k]["median"]
                                    for k in times[a]}
    emit({"gmm_route_ablation": {
        "layers": LAYERS, "rows": ROWS, "experts_used": USED, "rounds": args.rounds,
        "order": order, "max_abs_err": errs, "ms": times, "summary": summary}})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
