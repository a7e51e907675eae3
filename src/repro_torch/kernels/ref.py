"""Dense oracles of the BSR kernels (the ground truth of their tests).

The port of the JAX package's ``kernels/ref.py`` for ``bsr_spgemm_ref`` and
``bsr_spmm_ref``; the LM-stack oracles are not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.sparse.bsr import BSR, bsr_to_dense


def bsr_spgemm_ref(A: BSR, B: BSR) -> torch.Tensor:
    """Dense C = A @ B (fp32 accumulation)."""
    return bsr_to_dense(A).float() @ bsr_to_dense(B).float()


def bsr_spmm_ref(A: BSR, x: torch.Tensor) -> torch.Tensor:
    return bsr_to_dense(A).float() @ x.float()
