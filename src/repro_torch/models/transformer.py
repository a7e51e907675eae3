"""Decoder assembly of the dense and MoE families, for training and serving.

The port of the dense and MoE, frontend-free parts of the JAX package's
``models/transformer.py``:
  init_params(cfg, generator, device, dtype) -> Transformer
  forward(params, batch, cfg)                -> (logits, aux)   [training]
  loss_fn(params, batch, cfg)                -> (loss, metrics)
  init_cache(cfg, batch_size, cache_len)     -> cache dict
  prefill(params, batch, cfg, cache_len)     -> (last_logits, cache)
  decode_step(params, cache, tokens, cfg)    -> (logits, cache)

``params`` is a :class:`Transformer`, an ``nn.Module`` with a ModuleList of
decoder layers in place of the reference's scanned, stacked layer tree.
Serving never updates weights, so the serving model (``dtype=None``) holds
them in ``cfg.compute_dtype``, cast once at load (the reference casts its
f32 master weights at every use, which gives the same values), without
gradients; the RMSNorm scales stay f32. The training model
(``dtype=pdtype(cfg)``) holds trainable f32 masters, which the modules cast
at each use as the reference does. The KV cache is updated in place:
``decode_step`` writes the new token's K and V into the cache it is given
and returns that same dict with ``pos`` advanced.

``forward`` is plain PyTorch end to end (``attention.flash_attention``,
``moe.moe_apply_einsum``), since the reference's training path reaches no
Pallas kernel; the serving path's hand-written kernels refuse autograd.
Each layer is rematerialized per ``cfg.remat`` / ``cfg.remat_policy``
(``_remat``). A layer of the MoE family holds an ``MoE``
(``models/moe.py``) in place of the MLP; serving discards its
load-balancing auxiliary, as the reference's does. The reference's sharding
constraints are identities on one device and are left out; its levers
``precast_params``, ``cast_free_attention``, ``shard_activations``,
``dp_axes`` and ``tp_axis`` raise ``NotImplementedError`` when set. The
SSM and hybrid families and the modality frontends raise
``NotImplementedError``; they are queued in ROADMAP.md.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from repro_torch.models import attention as att
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MLP, Embed, RMSNorm, cdtype
from repro_torch.models.moe import MoE, moe_apply_einsum
from repro_torch.sparse.csr import resolve_device


def check_ported(cfg: ModelConfig) -> None:
    """Raise for a configuration whose family or frontend is not ported."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported to repro_torch "
            "(only 'dense' and 'moe'); see ROADMAP.md Queue 1 item 9")
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: frontend {cfg.frontend!r} is not ported to repro_torch; "
            "see ROADMAP.md Queue 1 item 9")


# the reference's perf levers, not ported: each raises when set
_LEVERS = ("precast_params", "cast_free_attention", "shard_activations", "dp_axes", "tp_axis")


def check_levers(cfg: ModelConfig) -> None:
    """Raise for a configuration that sets a lever the port does not have."""
    for lever in _LEVERS:
        if getattr(cfg, lever):
            raise NotImplementedError(
                f"{cfg.name}: the lever {lever}={getattr(cfg, lever)!r} is not ported to "
                "repro_torch (its sharding and cast levers need parallel/); see ROADMAP.md "
                "Queue 1 item 9")


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        self.norm1 = RMSNorm(cfg, device, dtype)
        self.attn = att.Attention(cfg, device, dtype)
        self.norm2 = RMSNorm(cfg, device, dtype)
        self.is_moe = cfg.family == "moe"
        if self.is_moe:
            self.moe = MoE(cfg, device, dtype)
        else:
            self.mlp = MLP(cfg, device, dtype)

    def train_forward(self, x, cfg, positions):
        """(x + attention + FFN, the MoE auxiliary or 0): the reference's
        scanned layer body, differentiable."""
        x = x + att.attn_forward(self.attn, self.norm1(x), cfg, positions)
        if self.is_moe:
            y, aux = moe_apply_einsum(self.moe, self.norm2(x), cfg)
        else:
            y, aux = self.mlp(self.norm2(x)), torch.zeros((), device=x.device)
        return x + y, aux

    def ffn(self, x):
        return self.moe(x) if self.is_moe else self.mlp(x)

    def prefill(self, x, cfg, positions, cache_k, cache_v):
        x = x + att.attn_prefill(self.attn, self.norm1(x), cfg, positions, cache_k, cache_v)
        return x + self.ffn(self.norm2(x))

    def decode(self, x, cfg, cache_k, cache_v, pos):
        x = x + att.attn_decode(self.attn, self.norm1(x), cfg, cache_k, cache_v, pos)
        return x + self.ffn(self.norm2(x))


class Transformer(nn.Module):
    """The decoder: embedding and head, ``n_layers`` decoder layers,
    the final norm. Weights are allocated uninitialised; fill them with
    :meth:`init_weights` or ``convert.params_from_jax``."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.embed = Embed(cfg, device, dtype)
        self.layers = nn.ModuleList(DecoderLayer(cfg, device, dtype)
                                    for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg, device, dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        """The reference's initialisation: normals at its scales (drawn in
        f32, then cast), norm scales of one."""
        for module in self.modules():
            if module is not self and hasattr(module, "init_weights"):
                module.init_weights(generator)


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None, dtype=None) -> Transformer:
    """A model with the reference's shapes and scales, drawn from
    ``generator`` (a fresh one seeded 0 when None), on the card unless
    ``device`` says otherwise. The generator must live on that device.

    ``dtype=None`` gives the serving model (weights in the compute dtype,
    no gradients); a dtype, ``pdtype(cfg)`` for the reference's f32
    masters, gives the trainable model. From the same generator state the
    two draw the same values: the masters cast to the compute dtype equal
    the serving weights bit for bit."""
    device = resolve_device(device)
    model = Transformer(cfg, device, dtype)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    model.init_weights(generator)
    return model


# ---------------------------------------------------------------------------
# forward (training)
# ---------------------------------------------------------------------------


def _save_mm(ctx, func, *args, **kwargs):
    """The "dots" policy: keep the outputs of products without batch dims
    (``aten.mm``, as ``dots_with_no_batch_dims_saveable``), recompute the rest."""
    del ctx, args, kwargs
    return (_ckpt.CheckpointPolicy.MUST_SAVE if func is torch.ops.aten.mm.default
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, cfg: ModelConfig):
    """Apply the configured rematerialization policy to a layer body:
    ``remat=False`` saves everything; policy ``"full"`` recomputes the whole
    layer in the backward (``torch.utils.checkpoint``, non-reentrant);
    ``"dots"`` saves the products' outputs and recomputes the rest."""
    if not cfg.remat:
        return fn
    if cfg.remat_policy == "dots":
        context_fn = functools.partial(_ckpt.create_selective_checkpoint_contexts, _save_mm)
        return functools.partial(_ckpt.checkpoint, fn, use_reentrant=False,
                                 context_fn=context_fn)
    if cfg.remat_policy != "full":
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r} (full, dots)")
    return functools.partial(_ckpt.checkpoint, fn, use_reentrant=False)


def forward(params: Transformer, batch: dict, cfg: ModelConfig):
    """Returns (logits [B, S, vocab] f32, aux dict): the training forward,
    differentiable, through no hand-written kernel. ``aux["moe_aux"]`` is
    the MoE auxiliary averaged over the layers (0 for the dense family)."""
    check_ported(cfg)
    check_levers(cfg)
    h = params.embed.embed(batch["tokens"])
    b, s, _ = h.shape
    pos = torch.arange(s, dtype=torch.int32, device=h.device).expand(b, s)
    aux_loss = torch.zeros((), device=h.device)
    for layer in params.layers:
        h, aux = _remat(functools.partial(layer.train_forward, cfg=cfg, positions=pos), cfg)(h)
        aux_loss = aux_loss + aux
    logits = params.embed.unembed(params.final_norm(h))
    return logits, {"moe_aux": aux_loss / max(cfg.n_layers, 1)}


def loss_fn(params: Transformer, batch: dict, cfg: ModelConfig, aux_weight: float = 0.01):
    """(the masked mean NLL + ``aux_weight`` x the MoE auxiliary, metrics):
    labels below 0 are masked out."""
    logits, aux = forward(params, batch, cfg)
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    loss = torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.0)
    total = loss + aux_weight * aux["moe_aux"]
    return total, {"loss": loss, **aux}


# ---------------------------------------------------------------------------
# serve: prefill + decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch_size: int, cache_len: int, device=None) -> dict:
    """Empty decode cache: ``pos`` int32 [B] and per-layer K and V
    ``[L, B, eff, Hkv, hd]`` in the compute dtype (``eff`` is the window
    when the config slides one)."""
    check_ported(cfg)
    device = resolve_device(device)
    eff = min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len
    shape = (cfg.n_layers, batch_size, eff, cfg.n_kv_heads, cfg.head_dim)
    return {"pos": torch.zeros(batch_size, dtype=torch.int32, device=device),
            "k": torch.zeros(shape, dtype=cdtype(cfg), device=device),
            "v": torch.zeros(shape, dtype=cdtype(cfg), device=device)}


def prefill(params: Transformer, batch: dict, cfg: ModelConfig, cache_len: int):
    """Run the prompt, return (next-token logits [B, vocab] f32, cache).

    With uneven right-padded prompts, ``batch["lengths"]`` (int [B], true
    prompt lengths) selects each sequence's logits at its own last real token
    instead of the padded final position; without it, the last position is
    used for every sequence (uniform-length prompts)."""
    tokens = batch["tokens"]
    h = params.embed.embed(tokens)
    b, s, _ = h.shape
    pos = torch.arange(s, dtype=torch.int32, device=h.device).expand(b, s)
    cache = init_cache(cfg, b, cache_len, device=h.device)
    cache["pos"].fill_(s)
    for i, layer in enumerate(params.layers):
        h = layer.prefill(h, cfg, pos, cache["k"][i], cache["v"][i])
    lengths = batch.get("lengths")
    if lengths is None:
        h_last = h[:, -1:]
    else:
        last = torch.clamp(torch.as_tensor(lengths, device=h.device).long() - 1, 0, s - 1)
        h_last = h[torch.arange(b, device=h.device), last][:, None]
    # the norm is per position, so gathering first gives the reference's values
    logits = params.embed.unembed(params.final_norm(h_last))
    return logits[:, 0], cache


def decode_step(params: Transformer, cache: dict, tokens: torch.Tensor, cfg: ModelConfig):
    """One token for every sequence. tokens: int [B, 1]. Returns
    (logits [B, vocab] f32, the cache, updated in place)."""
    h = params.embed.embed(tokens)
    pos = cache["pos"]
    for i, layer in enumerate(params.layers):
        h = layer.decode(h, cfg, cache["k"][i], cache["v"][i], pos)
    logits = params.embed.unembed(params.final_norm(h))
    cache["pos"] = pos + 1
    return logits[:, 0], cache
