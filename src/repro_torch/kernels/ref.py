"""Plain oracles of the kernels (the ground truth of their tests).

The port of the JAX package's ``kernels/ref.py``: ``bsr_spgemm_ref``,
``bsr_spmm_ref``, ``grouped_matmul_ref`` and ``decode_attention_ref``; and
``chunked_attention``, the JAX package's pure ``flash_attention``: one body
for the prefill kernel's plain version and the training forward's attention.
"""

from __future__ import annotations

import torch

from repro_torch.sparse.bsr import BSR, bsr_to_dense

NEG_INF = -1e30


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


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0, q_chunk: int = 1024,
                      kv_chunk: int = 1024, q_offset: int = 0) -> torch.Tensor:
    """Causal (plus an optional sliding ``window``) GQA attention as the
    reference's doubly chunked online softmax in f32. q: [B, Sq, H, D]; k, v:
    [B, Sk, Hkv, D]; returns [B, Sq, H, D] in q's dtype.

    A loop over Q chunks, each streaming the KV chunks it can see (causal:
    none past its last row; a window: none wholly before its first row minus
    the window), ragged tails padded to chunk multiples (padded K positions
    masked, padded Q rows sliced off), ``acc / max(l, 1e-30)``. GQA is
    folded: query head ``h`` reads KV head ``h // (H / Hkv)``. ``q_offset``
    is the global position of q[0] relative to k[0] (prefill: 0); ``causal``
    off attends to every key (within the window). Differentiable by autograd.
    """
    b, sq, h, d = q.shape
    _, sk, hkv, _ = k.shape
    g = h // hkv
    scale = 1.0 / (d ** 0.5)
    q_chunk = min(q_chunk, sq) or sq
    kv_chunk = min(kv_chunk, sk) or sk
    sq_orig, sk_valid = sq, sk
    sq = -(-sq // q_chunk) * q_chunk
    sk = -(-sk // kv_chunk) * kv_chunk
    if sq != sq_orig:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, sq - sq_orig))
    if sk != sk_valid:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, sk - sk_valid))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, sk - sk_valid))
    nk = sk // kv_chunk
    qg = q.reshape(b, sq, hkv, g, d)
    dev = q.device

    def q_block(qi: int) -> torch.Tensor:
        q_blk = qg[:, qi * q_chunk:(qi + 1) * q_chunk].float()
        q0 = q_offset + qi * q_chunk
        qpos = q0 + torch.arange(q_chunk, device=dev)
        m = torch.full((b, hkv, g, q_chunk), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, hkv, g, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, g, q_chunk, d), dtype=torch.float32, device=dev)
        # causal: no KV chunk beyond this Q block's last row is visible
        hi = min((q0 + q_chunk + kv_chunk - 1) // kv_chunk, nk) if causal else nk
        # sliding window: no KV chunk entirely before (first q row - window)
        lo = max((q0 - window + 1) // kv_chunk, 0) if window else 0
        for ki in range(lo, max(hi, lo + 1)):
            k_blk = k[:, ki * kv_chunk:(ki + 1) * kv_chunk].float()
            v_blk = v[:, ki * kv_chunk:(ki + 1) * kv_chunk].float()
            kpos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            s = torch.einsum("bqhgd,bkhd->bhgqk", q_blk, k_blk) * scale
            mask = (kpos < sk_valid)[None, :]
            if causal:
                mask = mask & (qpos[:, None] >= kpos[None, :])
            if window:
                mask = mask & (qpos[:, None] - kpos[None, :] < window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, v_blk)
            m = m_new
        o = acc / torch.clamp(l[..., None], min=1e-30)
        # [b, hkv, g, qc, d] -> [b, qc, h, d]
        return o.permute(0, 3, 1, 2, 4).reshape(b, q_chunk, h, d)

    out = torch.cat([q_block(qi) for qi in range(sq // q_chunk)], dim=1)
    return out[:, :sq_orig].to(q.dtype)
