"""Plain oracles of the kernels (the ground truth of their tests).

The port of the JAX package's ``kernels/ref.py``: ``bsr_spgemm_ref``,
``bsr_spmm_ref``, ``grouped_matmul_ref`` and ``decode_attention_ref``.
"""

from __future__ import annotations

import torch

from repro_torch.sparse.bsr import BSR, bsr_to_dense


def bsr_spgemm_ref(A: BSR, B: BSR) -> torch.Tensor:
    """Dense C = A @ B (fp32 accumulation)."""
    return bsr_to_dense(A).float() @ bsr_to_dense(B).float()


def bsr_spmm_ref(A: BSR, x: torch.Tensor) -> torch.Tensor:
    return bsr_to_dense(A).float() @ x.float()


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                       token_group: torch.Tensor) -> torch.Tensor:
    """y[t] = x[t] @ w[token_group[t]] — per-token gather of the expert weight
    (a [T, K, N] copy: small inputs only)."""
    wt = w[token_group.long()]  # [T, K, N]
    return torch.einsum("tk,tkn->tn", x.float(), wt.float())


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """Naive masked softmax attention. q: [B,Hkv,G,D]; k,v: [B,S,Hkv,D]."""
    d = q.shape[-1]
    scores = torch.einsum("bhgd,bshd->bhgs", q.float(), k.float()) * (1.0 / (d ** 0.5))
    pos = torch.arange(k.shape[1], device=q.device)[None, None, None, :]
    mask = pos < lengths.to(q.device)[:, None, None, None]
    p = torch.softmax(torch.where(mask, scores, -torch.inf), dim=-1)
    return torch.einsum("bhgs,bshd->bhgd", p, v.float()).to(q.dtype)
