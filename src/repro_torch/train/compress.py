"""Gradient compression with error feedback.

The port of the JAX package's ``train/compress.py``: int8 symmetric
quantization per tensor (scale ``max|g| / 127``), with an error-feedback
buffer that re-injects the quantization residual into the next step's
gradient. Trees are dicts ``{name: tensor}`` (the model's parameter names).
A "tensor" is a leaf of the reference's tree, whose layers are stacked: the
tensors of one name in every layer (``layers.<i>.attn.wq`` for all i) share
one scale, their joint ``max|g| / 127``, so the codes equal the reference's.

Enabled by ``TrainConfig(grad_compression="int8")``.
"""

from __future__ import annotations

import re

import torch

_LAYER = re.compile(r"^layers\.\d+\.")


def leaf_of(name: str) -> str:
    """The reference's leaf a parameter belongs to: its name with the layer
    index taken out."""
    return _LAYER.sub("layers.*.", name)


def ef_init(params: dict) -> dict:
    """Error-feedback buffers (zero residuals), one f32 tensor a parameter."""
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax, min=1e-12) / 127.0


def _quant(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@torch.no_grad()
def compress_grads(grads: dict, ef: dict):
    """Returns ({name: (int8 tensor, f32 scale)}, new error-feedback buffers)."""
    g32 = {name: g.float() + ef[name] for name, g in grads.items()}
    amax = {}
    for name, g in g32.items():
        leaf = leaf_of(name)
        m = torch.max(torch.abs(g))
        amax[leaf] = m if leaf not in amax else torch.maximum(amax[leaf], m)
    qtree, ef2 = {}, {}
    for name, g in g32.items():
        s = _scale(amax[leaf_of(name)])
        q = _quant(g, s)
        qtree[name] = (q, s)
        ef2[name] = g - _dequant(q, s)
    return qtree, ef2


def decompress_grads(qtree: dict) -> dict:
    return {name: _dequant(q, s) for name, (q, s) in qtree.items()}


def roundtrip(grads: dict, ef: dict):
    """compress -> decompress in one step (what the reduction endpoint sees)."""
    q, ef2 = compress_grads(grads, ef)
    return decompress_grads(q), ef2
