"""Carry the JAX package's model weights across into the port's model.

``params_from_jax(tree, cfg, device)`` takes the reference's params tree
(nested dicts of NumPy arrays, e.g. ``jax.tree.map(np.asarray, params)``):
``embed/{embedding [V, d], head [d, V]}``, ``layers/...`` stacked on a
leading L axis (the reference's vmapped layer init; ``layers/mlp`` for the
dense family, ``layers/moe/{router, w1, w3, w2}`` for the MoE family,
``layers/rwkv/*`` for the SSM family, ``layers/mamba/*`` for the hybrid),
``final_norm/scale``, and the hybrid's ``shared_attn/{norm1, attn, norm2,
mlp}``, one block, not stacked.
Every array is checked against the port's shape and cast to the port's
dtype: ``dtype=None`` builds the serving model, ``dtype=pdtype(cfg)`` the
trainable one, which carries the reference's f32 tree across unchanged. (``kernels/convert.py`` carries the sparse objects.)
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import mamba2, rwkv6
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer
from repro_torch.sparse.csr import resolve_device

_LAYER_FIELDS = {"norm1": ("scale",), "attn": ("wq", "wk", "wv", "wo"),
                 "norm2": ("scale",)}
_FFN_FIELDS = {"dense": {"mlp": ("w1", "w3", "w2")},
               "moe": {"moe": ("router", "w1", "w3", "w2")}}
_SSM_FIELDS = {"ssm": {"norm1": ("scale",), "rwkv": rwkv6.FIELDS, "norm2": ("scale",)},
               "hybrid": {"norm1": ("scale",), "mamba": mamba2.FIELDS}}
SHARED_FIELDS = {**_LAYER_FIELDS, "mlp": ("w1", "w3", "w2")}


def layer_fields(cfg: ModelConfig) -> dict:
    """{block: weight names} of one layer of ``cfg``'s family."""
    if cfg.family in _SSM_FIELDS:
        return _SSM_FIELDS[cfg.family]
    return {**_LAYER_FIELDS, **_FFN_FIELDS[cfg.family]}


def _load(param: torch.nn.Parameter, array, what: str) -> None:
    array = np.asarray(array)
    if tuple(array.shape) != tuple(param.shape):
        raise ValueError(f"{what}: shape {array.shape}, the port's {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(torch.from_numpy(np.array(array, dtype=np.float32)))


def params_from_jax(tree: dict, cfg: ModelConfig, device=None, dtype=None) -> Transformer:
    """The port's :class:`Transformer` holding the reference's weights
    (``dtype`` as ``transformer.init_params``'s)."""
    model = Transformer(cfg, resolve_device(device), dtype)
    _load(model.embed.embedding, tree["embed"]["embedding"], "embed/embedding")
    _load(model.embed.head, tree["embed"]["head"], "embed/head")
    _load(model.final_norm.scale, tree["final_norm"]["scale"], "final_norm/scale")
    for i, layer in enumerate(model.layers):
        for block, names in layer_fields(cfg).items():
            for name in names:
                stacked = tree["layers"][block][name]
                _load(getattr(getattr(layer, block), name), np.asarray(stacked)[i],
                      f"layers/{block}/{name}[{i}]")
    if model.shared_attn is not None:
        for block, names in SHARED_FIELDS.items():
            for name in names:
                _load(getattr(getattr(model.shared_attn, block), name),
                      tree["shared_attn"][block][name], f"shared_attn/{block}/{name}")
    return model
