"""Quickstart of the PyTorch port: the paper's technique in 60 lines.

Builds a multigrid triple-product problem on the card, plans a
two-level-memory chunked SpGEMM with the paper's Algorithm-4 heuristic,
executes it, and verifies the chunk-invariance against the dense oracle.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core.chunking import chunked_spgemm
from repro_torch.core.kkmem import spgemm_dense_oracle, spgemm_full, spgemm_symbolic_host
from repro_torch.core.memory_model import P100
from repro_torch.core.placement import dp_recommendation
from repro_torch.core.planner import plan_chunks, plan_knl, row_bytes_csr
from repro_torch.sparse import multigrid
from repro_torch.sparse.csr import csr_to_dense


def main(device: str = "cuda"):
    # 1. a Brick3D multigrid problem: A_c = R x A_f x P, P = R^T
    A, R, P = multigrid.problem("brick3d", 8, device=device)
    print(f"A: {A.shape} nnz={int(A.nnz())}, R: {R.shape} nnz={int(R.nnz())}")

    # 2. one-level baseline (KKMEM numeric phase)
    C = spgemm_full(A, P)
    ref = spgemm_dense_oracle(A, P)
    assert torch.allclose(csr_to_dense(C), ref, atol=1e-4)
    print(f"baseline A x P ok: C nnz={int(C.nnz())}")

    # 3. what would the paper place where? (selective data placement, §3.2.1)
    ws = spgemm_symbolic_host(A, P)
    rec = dp_recommendation(P100, A.nbytes(), P.nbytes(), ws.c_nnz * 12.0)
    print(f"DP recommendation on P100-like memory: A={rec.A} B={rec.B} C={rec.C}")

    # 4. chunked execution under a tight fast memory (Algorithm 4 plans it)
    crb = np.full(A.n_rows, max(ws.c_nnz / A.n_rows, 1) * 12.0)
    budget = (float(row_bytes_csr(A).sum() + row_bytes_csr(P).sum())
              + float(crb.sum())) / 4
    plan = plan_chunks(A, P, crb, P100, fast_limit_bytes=budget)
    print(f"plan: {plan.algorithm} with {plan.n_ac} A/C strips x {plan.n_b} B "
          f"chunks, modeled copy = {plan.copy_bytes/1e3:.1f} KB")
    C2, stats = chunked_spgemm(A, P, plan, device=device)
    assert torch.allclose(csr_to_dense(C2), ref, atol=1e-4)
    print(f"chunked == unchunked == oracle; actual staged bytes = "
          f"{stats.copy_bytes/1e3:.1f} KB in {stats.kernel_calls} kernel calls")

    # 5. KNL-style single-level-B chunking (Algorithm 1)
    plan_k = plan_knl(A, P, fast_limit_bytes=float(row_bytes_csr(P).sum()) / 3)
    C3, stats_k = chunked_spgemm(A, P, plan_k, device=device)
    assert torch.allclose(csr_to_dense(C3), ref, atol=1e-4)
    print(f"Alg-1 chunking ok: {plan_k.n_b} B chunks, "
          f"{stats_k.kernel_calls} fused multiply-add calls")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    main(device=ap.parse_args().device)
