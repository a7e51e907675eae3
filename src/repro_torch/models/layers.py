"""Shared layer primitives: RMSNorm, RoPE, the SwiGLU MLP, embeddings.

The port of the JAX package's ``models/layers.py`` (its frontend stubs wait
for the frontend slice). Weights keep the reference's layouts. Serving
never updates weights, so the modules hold them in ``cfg.compute_dtype``,
cast once at load, which gives the values of the reference's per-use
``.astype``; the RMSNorm scales stay in ``cfg.param_dtype``, as the
reference reads them in f32. Normalization statistics and RoPE run in f32.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.config import ModelConfig


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def weight(shape, dtype, device) -> nn.Parameter:
    """An uninitialised serving weight (no gradient)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


def draw_normal(param: nn.Parameter, scale: float, generator: torch.Generator) -> None:
    """Fill ``param`` with f32 standard normals times ``scale``, cast to its
    dtype (the reference draws in its f32 param dtype)."""
    with torch.no_grad():
        param.copy_(torch.randn(param.shape, generator=generator, dtype=torch.float32,
                                device=param.device) * scale)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.scale = weight((cfg.d_model,), pdtype(cfg), device)

    def init_weights(self, generator: torch.Generator) -> None:
        del generator   # ones, as the reference
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(self.scale, x)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: [..., S] (broadcastable integers)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                     # [D/2]
    angles = positions[..., None].float() * freqs              # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]                      # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, ff, dt = cfg.d_model, cfg.d_ff, cdtype(cfg)
        self.w1 = weight((d, ff), dt, device)   # gate
        self.w3 = weight((d, ff), dt, device)   # up
        self.w2 = weight((ff, d), dt, device)   # down

    def init_weights(self, generator: torch.Generator) -> None:
        d, ff = self.w1.shape
        draw_normal(self.w1, d ** -0.5, generator)
        draw_normal(self.w3, d ** -0.5, generator)
        draw_normal(self.w2, ff ** -0.5, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (torch.nn.functional.silu(x @ self.w1) * (x @ self.w3)) @ self.w2


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


class Embed(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.logit_softcap = cfg.logit_softcap
        dt = cdtype(cfg)
        self.embedding = weight((cfg.vocab_size, cfg.d_model), dt, device)
        self.head = weight((cfg.d_model, cfg.vocab_size), dt, device)

    def init_weights(self, generator: torch.Generator) -> None:
        d = self.head.shape[0]
        draw_normal(self.embedding, d ** -0.5, generator)
        draw_normal(self.head, d ** -0.5, generator)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embedding[tokens]

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        """f32 logits, soft-capped when the config asks."""
        logits = (x @ self.head).float()
        if self.logit_softcap:
            logits = self.logit_softcap * torch.tanh(logits / self.logit_softcap)
        return logits
