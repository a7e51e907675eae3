"""Paper-reproduction driver of the PyTorch port: the multigrid SpGEMM study.

Runs the paper's experiment grid — 4 problems x {A x P, R x A} x memory modes x
placements x chunked variants — and prints the same comparisons the paper plots
(Figs 3/4/6/7, Table 3, Figs 12/13), using the calibrated memory model for the
machine-dependent numbers and real execution, on the card, for all
algorithmic results.

The chunked section runs through the ``chunked_spgemm`` backend dispatch:
every backend in ``--backends`` (comma-separated; ``all`` = every registered
backend plus ``auto``) executes the same plan and is checked against the
dense oracle — the host loop oracle, the device loop (``scan``), the
dense-slab kernel (``pallas``), the ESC and hash CSR-output kernels, the
BSR kernel, and the planner-driven ``auto`` dispatch. The roster comes from
``repro_torch.core.backend_registry``.

  PYTHONPATH=src python examples/torch_multigrid_spgemm.py [--problem brick3d]
      [--size 6] [--backends scan,hash] [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core import backend_registry
from repro_torch.core.chunking import chunked_spgemm
from repro_torch.core.kkmem import spgemm, spgemm_dense_oracle, spgemm_symbolic_host
from repro_torch.core.locality import analyze, miss_table
from repro_torch.core.memory_model import KNL, P100
from repro_torch.core.pipeline_spgemm import pipeline_spgemm
from repro_torch.core.placement import (
    ALL_FAST, ALL_SLOW, DP, dp_recommendation, placement_cost,
)
from repro_torch.core.planner import plan_chunks, row_bytes_csr
from repro_torch.sparse import multigrid
from repro_torch.sparse.csr import csr_to_dense

ALL_BACKENDS = (*backend_registry.all_backends(), "auto")


def study(problem: str, n: int, backends=("scan",), device: str = "cuda"):
    A, R, P = multigrid.problem(problem, n, device=device)
    print(f"\n=== {problem} (n={n}) — A {A.shape} nnz={int(A.nnz())} ===")
    for tag, (L, Rt) in {"AxP": (A, P), "RxA": (R, A)}.items():
        ws = spgemm_symbolic_host(L, Rt)
        st = analyze(L, Rt)
        C = spgemm(L, Rt, ws.c_pad)
        ok = bool(torch.allclose(csr_to_dense(C), spgemm_dense_oracle(L, Rt), atol=1e-4))
        locality = miss_table(L, Rt)
        print(f"\n-- {tag}: correct={ok} flops={ws.flops} "
              f"L2miss~{locality['L2']:.2f} reuse={locality['mean_reuse_rows']:.0f}")
        print(f"   {'mode':22s} {'GFLOP/s':>9s}")
        for sys_name, system in (("KNL", KNL), ("P100", P100)):
            for mode, pl in (("all-fast(HBM)", ALL_FAST), ("all-slow", ALL_SLOW),
                             ("DP(B fast)", DP)):
                c = placement_cost(system, pl, L, Rt, ws.c_nnz * 12.0, ws.flops,
                                   st)
                print(f"   {sys_name}/{mode:17s} {c.gflops(ws.flops):9.3f}")
        rec = dp_recommendation(P100, L.nbytes(), Rt.nbytes(), ws.c_nnz * 12.0)
        print(f"   DP recommendation: B -> {rec.B}")
        # chunked under half/quarter fast budgets, through every backend
        crb = np.full(L.n_rows, max(ws.c_nnz / L.n_rows, 1) * 12.0)
        total = float(row_bytes_csr(L).sum() + row_bytes_csr(Rt).sum()
                      + crb.sum())
        ref = spgemm_dense_oracle(L, Rt)
        for frac in (0.5, 0.25):
            plan = plan_chunks(L, Rt, crb, P100, fast_limit_bytes=total * frac)
            for backend in backends:
                C2, stats = chunked_spgemm(L, Rt, plan, backend=backend, device=device)
                ok2 = bool(torch.allclose(csr_to_dense(C2), ref, atol=1e-4))
                print(f"   chunked@{frac:.2f}/{backend:6s}: {plan.algorithm} "
                      f"[{plan.n_ac}x{plan.n_b}] correct={ok2} "
                      f"staged={stats.copy_bytes/1e3:.0f}KB")
    # the fused two-hop Galerkin product C = R x (A x P) through the pipeline
    # executor: the intermediate T = A x P stays resident in fast memory when
    # the planner's budget allows, spills to slow otherwise
    rap = csr_to_dense(R) @ spgemm_dense_oracle(A, P)
    total = float(row_bytes_csr(A).sum() + row_bytes_csr(P).sum()
                  + row_bytes_csr(R).sum())
    print("\n-- RAP: fused two-hop pipeline (T = AxP resident when it fits)")
    for frac in (1.0, 0.25):
        for backend in ("sparse", "hash"):
            C3, pstats = pipeline_spgemm(A, P, R, system=P100,
                                         fast_limit_bytes=total * frac,
                                         backend=backend, device=device)
            ok3 = bool(torch.allclose(csr_to_dense(C3), rap, atol=1e-4))
            pp = pstats.plan
            print(f"   pipeline@{frac:.2f}/{backend:6s}: "
                  f"{pp.plan1.algorithm}+{pp.plan2.algorithm} "
                  f"resident={pp.t_resident} correct={ok3} "
                  f"copied={pstats.copy_bytes/1e3:.0f}KB")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", choices=list(multigrid.PROBLEMS) + ["all"],
                    default="all")
    ap.add_argument("--size", type=int, default=None,
                    help="override the per-problem default size")
    ap.add_argument("--backends", default="scan",
                    help="comma-separated chunked_spgemm backends, or 'all'")
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    backends = (ALL_BACKENDS if args.backends == "all"
                else tuple(args.backends.split(",")))
    unknown = set(backends) - set(ALL_BACKENDS)
    if unknown:
        ap.error(f"unknown backends {sorted(unknown)}; have {ALL_BACKENDS}")
    sizes = {"laplace3d": 12, "bigstar2d": 40, "brick3d": 10, "elasticity": 6}
    probs = multigrid.PROBLEMS if args.problem == "all" else [args.problem]
    for p in probs:
        study(p, args.size or sizes[p], backends=backends, device=args.device)


if __name__ == "__main__":
    main()
