"""GQA attention: RoPE, causal masking, sliding windows, KV caches.

The port of the JAX package's ``models/attention.py``. The weights keep the
reference's layouts, ``wq [d, h, hd]``, ``wk``/``wv [d, hkv, hd]``, ``wo
[h, hd, d]``, so carrying them across needs no transposes; ``qkv`` and
``out_proj`` cast them to the compute dtype at use (a no-op for the serving
weights, which are held in it).

Training (``attn_forward``) runs ``flash_attention``, the reference's
doubly chunked online softmax in f32, in plain PyTorch, which autograd
differentiates: the reference's training path reaches no Pallas kernel,
and the hand-written kernels below neither record autograd history nor
take part in it (their wrappers refuse a tensor that requires grad).

Serving: prefill attention goes through ``ops.flash_prefill`` and decode
attention (without a sliding window) through ``ops.decode_attention``: on
the card the hand-written CUDA kernels, on the CPU their plain versions.
Decode with a sliding window runs the reference's ring-buffer mask in plain
PyTorch on the CPU and is not ported to the card (its mask is not a
length). ``attention_ref`` is the reference's naive oracle.

The KV cache is updated in place: ``attn_prefill`` and ``attn_decode`` write
into the cache slabs they are given.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops, ref
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, cdtype, draw_normal, weight, weight_dtypes

NEG_INF = -1e30


class Attention(nn.Module):
    """The attention weights of one layer, in the reference's shapes."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        dt, grad = weight_dtypes(cfg, dtype)[0], dtype is not None
        self.wq = weight((d, h, hd), dt, device, grad)
        self.wk = weight((d, hkv, hd), dt, device, grad)
        self.wv = weight((d, hkv, hd), dt, device, grad)
        self.wo = weight((h, hd, d), dt, device, grad)

    def init_weights(self, generator: torch.Generator) -> None:
        d, h, hd = self.wq.shape
        for w in (self.wq, self.wk, self.wv):
            draw_normal(w, d ** -0.5, generator)
        draw_normal(self.wo, (h * hd) ** -0.5, generator)


def _heads(x: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w.astype(dt))`` as one matrix product."""
    d, h, k = w.shape
    return (x @ w.to(dt).reshape(d, h * k)).unflatten(-1, (h, k))


def qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    dt = cdtype(cfg)
    q, k, v = _heads(x, p.wq, dt), _heads(x, p.wk, dt), _heads(x, p.wv, dt)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def out_proj(p: Attention, o: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h, hd, d = p.wo.shape
    return o.flatten(-2) @ p.wo.to(cdtype(cfg)).reshape(h * hd, d)


# ---------------------------------------------------------------------------
# flash attention (plain PyTorch, chunk-streamed) and the naive oracle
# ---------------------------------------------------------------------------


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_chunk: int = 1024, kv_chunk: int = 1024,
                    q_offset: int = 0, cast_free: bool = False) -> torch.Tensor:
    """q: [B, Sq, H, D]; k, v: [B, Sk, Hkv, D]. Returns [B, Sq, H, D].

    The reference's doubly chunked online softmax in f32
    (``ref.chunked_attention``, whose body the prefill kernel's plain version
    shares), differentiable by autograd.

    ``q_offset``: global position of q[0] relative to k[0] (prefill: 0)."""
    if cast_free:
        raise NotImplementedError(
            "cast_free attention (a lever of the reference) is not ported; "
            "see ROADMAP.md Queue 1 item 9")
    return ref.chunked_attention(q, k, v, causal=causal, window=window, q_chunk=q_chunk,
                                 kv_chunk=kv_chunk, q_offset=q_offset)


def attention_ref(q, k, v, *, causal=True, window=0, q_offset=0):
    """Naive oracle for flash_attention (tests only)."""
    b, sq, h, d = q.shape
    _, sk, hkv, _ = k.shape
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / (d ** 0.5)
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window:
        mask &= qpos[:, None] - kpos[None, :] < window
    s = torch.where(mask, s, NEG_INF)
    o = torch.einsum("bhgqk,bkhd->bhgqd", torch.softmax(s, dim=-1), v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# block-level entry points
# ---------------------------------------------------------------------------


def attn_forward(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor) -> torch.Tensor:
    """Training self-attention over the full sequence, differentiable (no
    hand-written kernel)."""
    q, k, v = qkv(p, x, cfg, positions)
    o = flash_attention(q, k, v, causal=True, window=cfg.sliding_window,
                        q_chunk=cfg.q_chunk or q.shape[1],
                        kv_chunk=cfg.attn_chunk or k.shape[1],
                        cast_free=cfg.cast_free_attention)
    return out_proj(p, o, cfg)


def attn_prefill(p: Attention, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                 cache_k: torch.Tensor, cache_v: torch.Tensor) -> torch.Tensor:
    """Prefill of one layer: returns y and writes the prompt's K and V into
    the (zeroed) cache slabs ``[B, eff, Hkv, hd]`` in place. With a sliding
    window the cache is a ring buffer of ``eff = min(cache_len, window)``
    slots, slot = position % eff."""
    q, k, v = qkv(p, x, cfg, positions)
    o = ops.flash_prefill(q, k, v, bq=cfg.q_chunk or q.shape[1],
                          bk=cfg.attn_chunk or k.shape[1], window=cfg.sliding_window)
    y = out_proj(p, o, cfg)
    b, s = k.shape[:2]
    eff = cache_k.shape[1]
    if cfg.sliding_window and s > eff:
        # keep the last `eff` tokens, ring-aligned so slot = pos % eff
        pos_tail = positions[:, -eff:] if positions.dim() == 2 else \
            positions[-eff:].expand(b, eff)
        rows = torch.arange(b, device=k.device)[:, None]
        slots = pos_tail % eff
        cache_k[rows, slots] = k[:, -eff:]
        cache_v[rows, slots] = v[:, -eff:]
    else:
        n = min(s, eff)
        cache_k[:, :n] = k[:, :n]
        cache_v[:, :n] = v[:, :n]
    return y


def _window_decode_plain(qg, cache_k, cache_v, pos, window: int) -> torch.Tensor:
    """The reference's ring-buffer decode attention: slot i holds position p
    iff p % s_cache == i, p <= pos and p > pos - window."""
    s_cache, hd = cache_k.shape[1], cache_k.shape[-1]
    scores = torch.einsum("bhgd,bshd->bhgs", qg.float(), cache_k.float()) / (hd ** 0.5)
    slot_ids = torch.arange(s_cache, device=qg.device)[None, :]
    newest = pos[:, None] - ((pos[:, None] - slot_ids) % s_cache)
    valid = (newest >= 0) & (newest > pos[:, None] - window)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    return torch.einsum("bhgs,bshd->bhgd", torch.softmax(scores, dim=-1), cache_v.float())


def attn_decode(p: Attention, x: torch.Tensor, cfg: ModelConfig, cache_k: torch.Tensor,
                cache_v: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """One-token decode. x: [B, 1, d]; pos: int [B], the current position
    (0-based), which must lie inside the cache unless the window rings it.
    Writes this token's K and V into the cache slabs in place; returns
    y [B, 1, d]."""
    b = x.shape[0]
    q, k, v = qkv(p, x, cfg, pos[:, None])
    s_cache = cache_k.shape[1]
    slot = pos % s_cache if cfg.sliding_window else pos
    rows = torch.arange(b, device=x.device)
    cache_k[rows, slot] = k[:, 0]
    cache_v[rows, slot] = v[:, 0]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qg = q.reshape(b, hkv, h // hkv, hd)
    if cfg.sliding_window:
        if x.device.type != "cpu":
            raise NotImplementedError(
                "sliding-window decode on the card is not ported (its ring-buffer "
                "mask is not a length); see ROADMAP.md Queue 1 item 8")
        o = _window_decode_plain(qg, cache_k, cache_v, pos, cfg.sliding_window)
    else:
        o = ops.decode_attention(qg, cache_k, cache_v, (pos + 1).to(torch.int32))
    return out_proj(p, o.reshape(b, 1, h, hd).to(x.dtype), cfg)
