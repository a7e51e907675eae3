"""Graph-analytics example of the PyTorch port: linear-algebra triangle
counting (paper §4.1.2).

The fused path: triangles = sum((L @ L) o L) with the L-mask applied inside
the chunked backend's merge (``BackendSpec.run_masked``: the masked hash
kernel on the card), so the unmasked product is never materialized. Every
mask-capable registered backend runs and is checked against the unfused
kkmem sort-merge baseline and (at scale 11 or below) the dense oracle.

  PYTHONPATH=src python examples/torch_triangle_count.py --scale 12 [--device cpu]
"""

import argparse
import time

import torch

from repro_torch.core import backend_registry
from repro_torch.core.memory_model import KNL
from repro_torch.core.placement import dp_recommendation
from repro_torch.core.triangle import (
    count_triangles, count_triangles_dense, count_triangles_kkmem,
)
from repro_torch.sparse import graphs


def _timed(fn, device: str):
    """``fn()`` as a float and its wall milliseconds, the device's work
    included."""
    t0 = time.time()
    value = float(fn())
    if device != "cpu":
        torch.cuda.synchronize()
    return value, (time.time() - t0) * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=11,
                    help="RMAT scale (2^scale vertices)")
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args(argv)

    G = graphs.rmat(args.scale, args.edge_factor, seed=7, device=args.device)
    L = graphs.lower_triangular_degree_sorted(G)
    print(f"[tc] graph: {G.shape[0]} vertices, {int(G.nnz())//2} edges; "
          f"L nnz={int(L.nnz())}")
    tri = None
    for backend in backend_registry.masked_backends():
        tri, ms = _timed(lambda b=backend: count_triangles(L, backend=b, device=args.device),
                          args.device)
        print(f"[tc] fused/{backend:6s}: triangles = {tri:.0f} in "
              f"{ms:.0f} ms (mask inside the kernel, no unmasked C)")
    base, ms = _timed(lambda: count_triangles_kkmem(L), args.device)
    print(f"[tc] kkmem baseline: {base:.0f} in {ms:.0f} ms "
          f"(unfused, C at full symbolic capacity); agrees: {base == tri}")
    if args.scale <= 11:
        want = float(count_triangles_dense(L))
        print(f"[tc] dense oracle agrees: {abs(tri - want) < 1e-3}")
    rec = dp_recommendation(KNL, 0.0, L.nbytes(), 0.0)
    print(f"[tc] DP (paper: place compressed L fast): L -> {rec.B}")


if __name__ == "__main__":
    main()
