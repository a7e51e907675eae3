"""Shared layer primitives: RMSNorm, RoPE, the SwiGLU MLP, embeddings.

The port of the JAX package's ``models/layers.py`` (its frontend stubs wait
for the frontend slice). Weights keep the reference's layouts. Each module
takes ``dtype``: with ``None`` (serving, which never updates weights) it
holds its weights in ``cfg.compute_dtype``, cast once at load, which gives
the values of the reference's per-use ``.astype``, and the RMSNorm scales
(and the MoE router) in ``cfg.param_dtype``, as the reference reads them in
f32; none of them takes a gradient. With a dtype (training: ``pdtype(cfg)``)
every weight is a trainable master in that dtype. The modules cast their
weights to the compute dtype at each use, as the reference does (a no-op
for the serving weights). Both draw the same f32
normals from the same generator, so the masters cast to the compute dtype
equal the serving weights bit for bit. Normalization statistics and RoPE
run in f32.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.config import ModelConfig


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def weight(shape, dtype, device, trainable: bool = False) -> nn.Parameter:
    """An uninitialised weight: a serving weight takes no gradient."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=trainable)


def weight_dtypes(cfg: ModelConfig, dtype) -> tuple:
    """(the dtype of the product weights, of the f32-read weights: norm
    scales and the router) for a module built with ``dtype``."""
    return (cdtype(cfg), pdtype(cfg)) if dtype is None else (dtype, dtype)


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
    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        self.scale = weight((cfg.d_model,), weight_dtypes(cfg, dtype)[1], device,
                            dtype is not None)

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
    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        d, ff, dt, grad = cfg.d_model, cfg.d_ff, weight_dtypes(cfg, dtype)[0], dtype is not None
        self.w1 = weight((d, ff), dt, device, grad)   # gate
        self.w3 = weight((d, ff), dt, device, grad)   # up
        self.w2 = weight((ff, d), dt, device, grad)   # down

    def init_weights(self, generator: torch.Generator) -> None:
        d, ff = self.w1.shape
        draw_normal(self.w1, d ** -0.5, generator)
        draw_normal(self.w3, d ** -0.5, generator)
        draw_normal(self.w2, ff ** -0.5, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x in the compute dtype, the weights cast to it."""
        dt = x.dtype
        h = torch.nn.functional.silu(x @ self.w1.to(dt)) * (x @ self.w3.to(dt))
        return h @ self.w2.to(dt)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


class Embed(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        self.logit_softcap = cfg.logit_softcap
        self.compute_dtype = cdtype(cfg)
        dt, grad = weight_dtypes(cfg, dtype)[0], dtype is not None
        self.embedding = weight((cfg.vocab_size, cfg.d_model), dt, device, grad)
        self.head = weight((cfg.d_model, cfg.vocab_size), dt, device, grad)

    def init_weights(self, generator: torch.Generator) -> None:
        d = self.head.shape[0]
        draw_normal(self.embedding, d ** -0.5, generator)
        draw_normal(self.head, d ** -0.5, generator)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """The rows gathered, then cast to the compute dtype (the reference
        casts the table, then gathers: the same values)."""
        return self.embedding[tokens].to(self.compute_dtype)

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        """f32 logits of the compute-dtype product, soft-capped when the
        config asks."""
        logits = (x @ self.head.to(x.dtype)).float()
        if self.logit_softcap:
            logits = self.logit_softcap * torch.tanh(logits / self.logit_softcap)
        return logits

