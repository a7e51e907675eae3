"""Decoder assembly of all four families (dense / moe / ssm / hybrid), for
training and serving.

The port of the frontend-free parts of the JAX package's
``models/transformer.py``:
  init_params(cfg, generator, device, dtype) -> Transformer
  forward(params, batch, cfg)                -> (logits, aux)   [training]
  loss_fn(params, batch, cfg)                -> (loss, metrics)
  init_cache(cfg, batch_size, cache_len)     -> cache dict
  prefill(params, batch, cfg, cache_len)     -> (last_logits, cache)
  decode_step(params, cache, tokens, cfg)    -> (logits, cache)

``params`` is a :class:`Transformer`, an ``nn.Module`` with a ModuleList of
the family's layers in place of the reference's scanned, stacked layer
tree: attention and an MLP or MoE (dense, moe), RWKV-6 time and channel
mixing (ssm, ``models/rwkv6.py``), a Mamba-2 block (hybrid,
``models/mamba2.py``), and for the hybrid one top-level shared attention
block (``shared_attn``: attention and an MLP) run after every
``attn_every``-th layer, the same weights at every site. Serving never
updates weights, so the serving model (``dtype=None``) holds them in
``cfg.compute_dtype``, cast once at load (the reference casts its f32
master weights at every use, which gives the same values), without
gradients; the weights the reference reads in f32 (norm scales, the
router, the SSM blocks' constants) stay f32. The training model
(``dtype=pdtype(cfg)``) holds trainable f32 masters, which the modules cast
at each use as the reference does. The caches are updated in place:
``decode_step`` writes the new token's K and V, SSM and conv states into
the cache it is given and returns that same dict with ``pos`` advanced.

``forward`` is plain PyTorch end to end (``attention.flash_attention``,
``moe.moe_apply_einsum``, the SSM blocks' chunked forms), since the
reference's training path reaches no Pallas kernel; the serving path's
hand-written kernels refuse autograd. Each layer, and each site of the
hybrid's shared block, is rematerialized per ``cfg.remat`` /
``cfg.remat_policy`` (``_remat``). Serving discards the MoE
load-balancing auxiliary, as the reference's does. Prefill runs the SSM
blocks' chunked forms, decode their sequential forms on the carried
states.

The levers ``precast_params`` (``_precast``: every f32 weight of the
layers and of the shared block cast to the compute dtype once a call,
outside the layer loop) and ``cast_free_attention`` (``models/attention``)
are ported and default to off. The reference's sharding constraints are
identities on one device and are left out; its sharding levers
``shard_activations``, ``dp_axes`` and ``tp_axis`` raise
``NotImplementedError`` when set, as do the modality frontends; they are
queued in ROADMAP.md.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from repro_torch.models import attention as att
from repro_torch.models import mamba2, rwkv6
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MLP, Embed, RMSNorm, cdtype
from repro_torch.models.moe import MoE, moe_apply_einsum
from repro_torch.sparse.csr import resolve_device

RWKV_CHUNK = 32   # the reference's chunks of the rwkv6 and SSD chunked forms
SSD_CHUNK = 64


def check_ported(cfg: ModelConfig) -> None:
    """Raise for a configuration whose frontend is not ported."""
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: frontend {cfg.frontend!r} is not ported to repro_torch; "
            "see ROADMAP.md Queue 1 item 9c")


# the reference's sharding levers, not ported: each raises when set
_LEVERS = ("shard_activations", "dp_axes", "tp_axis")


def check_levers(cfg: ModelConfig) -> None:
    """Raise for a configuration that sets a lever the port does not have."""
    for lever in _LEVERS:
        if getattr(cfg, lever):
            raise NotImplementedError(
                f"{cfg.name}: the lever {lever}={getattr(cfg, lever)!r} is not ported to "
                "repro_torch (the sharding levers need parallel/); see ROADMAP.md Queue 1 "
                "item 9e")


def _hybrid_sites(cfg: ModelConfig) -> tuple:
    """Layer indices after which the shared attention block runs."""
    if not cfg.attn_every:
        return ()
    return tuple(range(cfg.attn_every - 1, cfg.n_layers, cfg.attn_every))


class _Block(nn.Module):
    """A block whose methods ``_call`` runs, on the block's own weights or
    on precast copies of them (``torch.func.functional_call`` calls
    ``forward``, which names the method)."""

    def forward(self, method: str, *args, **kwargs):
        return getattr(self, method)(*args, **kwargs)


def _call(block: _Block, cast: dict | None, method: str, *args, **kwargs):
    """``block.<method>(*args, **kwargs)``, on the tensors of ``cast`` (by
    parameter name) in place of the block's own where given."""
    if cast is None:
        return getattr(block, method)(*args, **kwargs)
    return torch.func.functional_call(block, cast, (method, *args), kwargs)


def _precast(block: nn.Module | None, cfg: ModelConfig) -> dict | None:
    """The reference's ``_maybe_precast`` lever: every f32 weight of the
    block cast to the compute dtype once, outside the layer loop (and so
    outside each layer's checkpointed body); norm scales, the router and
    the SSM constants included. Autograd carries the gradient through the
    cast to the f32 masters. None when the lever is off or the compute
    dtype is f32 (the cast is then the identity)."""
    dt = cdtype(cfg)
    if block is None or not cfg.precast_params or dt == torch.float32:
        return None
    return {n: p.to(dt) for n, p in block.named_parameters() if p.dtype == torch.float32}


class DecoderLayer(_Block):
    """A layer of the dense and MoE families: attention, then the MLP or
    the MoE."""

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

    def prefill(self, x, cfg, positions, cache, i):
        x = x + att.attn_prefill(self.attn, self.norm1(x), cfg, positions, cache["k"][i],
                                 cache["v"][i])
        return x + self.ffn(self.norm2(x))

    def decode(self, x, cfg, cache, i):
        x = x + att.attn_decode(self.attn, self.norm1(x), cfg, cache["k"][i], cache["v"][i],
                                cache["pos"])
        return x + self.ffn(self.norm2(x))


class RWKVLayer(_Block):
    """A layer of the SSM family (RWKV-6): time mixing, then channel mixing."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        self.norm1 = RMSNorm(cfg, device, dtype)
        self.rwkv = rwkv6.RWKV(cfg, device, dtype)
        self.norm2 = RMSNorm(cfg, device, dtype)

    def train_forward(self, x, cfg, positions):
        del positions   # RWKV has no positional encoding
        y, _, _ = rwkv6.time_mix_chunked(self.rwkv, self.norm1(x), cfg, chunk=RWKV_CHUNK)
        x = x + y
        return x + rwkv6.channel_mix(self.rwkv, self.norm2(x), cfg)[0]

    def prefill(self, x, cfg, positions, cache, i):
        """The chunked form; writes the layer's state S and both token
        shifts' last inputs into the cache."""
        del positions
        y, S, xa = rwkv6.time_mix_chunked(self.rwkv, self.norm1(x), cfg, chunk=RWKV_CHUNK)
        x = x + y
        y2, xc = rwkv6.channel_mix(self.rwkv, self.norm2(x), cfg)
        cache["S"][i].copy_(S)
        cache["x_att"][i].copy_(xa)
        cache["x_cm"][i].copy_(xc)
        return x + y2

    def decode(self, x, cfg, cache, i):
        """The sequential form on one token and the carried state."""
        y, S, xa = rwkv6.time_mix(self.rwkv, self.norm1(x), cfg, state=cache["S"][i],
                                  x_prev_in=cache["x_att"][i])
        x = x + y
        y2, xc = rwkv6.channel_mix(self.rwkv, self.norm2(x), cfg, x_prev_in=cache["x_cm"][i])
        cache["S"][i].copy_(S)
        cache["x_att"][i].copy_(xa)
        cache["x_cm"][i].copy_(xc)
        return x + y2


class MambaLayer(_Block):
    """A Mamba-2 layer of the hybrid family."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        self.norm1 = RMSNorm(cfg, device, dtype)
        self.mamba = mamba2.Mamba2(cfg, device, dtype)

    def train_forward(self, x, cfg, positions):
        del positions
        return x + mamba2.ssd_chunked(self.mamba, self.norm1(x), cfg, chunk=SSD_CHUNK)[0]

    def prefill(self, x, cfg, positions, cache, i):
        """The chunked form; writes the SSM state and the conv state."""
        del positions
        y, h, conv = mamba2.ssd_chunked(self.mamba, self.norm1(x), cfg, chunk=SSD_CHUNK)
        cache["h"][i].copy_(h)
        cache["conv"][i].copy_(conv)
        return x + y

    def decode(self, x, cfg, cache, i):
        """The sequential form on one token and the carried states."""
        y, h, conv = mamba2.ssd_scan(self.mamba, self.norm1(x), cfg, state=cache["h"][i],
                                     conv_state=cache["conv"][i])
        cache["h"][i].copy_(h)
        cache["conv"][i].copy_(conv)
        return x + y


class SharedAttn(_Block):
    """The hybrid's shared transformer block: one weight set run at every
    site of ``_hybrid_sites``, one KV slab a site."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        self.norm1 = RMSNorm(cfg, device, dtype)
        self.attn = att.Attention(cfg, device, dtype)
        self.norm2 = RMSNorm(cfg, device, dtype)
        self.mlp = MLP(cfg, device, dtype)

    def train_forward(self, x, cfg, positions):
        x = x + att.attn_forward(self.attn, self.norm1(x), cfg, positions)
        return x + self.mlp(self.norm2(x))

    def prefill(self, x, cfg, positions, cache, site):
        x = x + att.attn_prefill(self.attn, self.norm1(x), cfg, positions, cache["k"][site],
                                 cache["v"][site])
        return x + self.mlp(self.norm2(x))

    def decode(self, x, cfg, cache, site):
        x = x + att.attn_decode(self.attn, self.norm1(x), cfg, cache["k"][site],
                                cache["v"][site], cache["pos"])
        return x + self.mlp(self.norm2(x))


_LAYERS = {"dense": DecoderLayer, "moe": DecoderLayer, "ssm": RWKVLayer, "hybrid": MambaLayer}


class Transformer(nn.Module):
    """The decoder: embedding and head, ``n_layers`` layers of the config's
    family, the hybrid's shared attention block (``shared_attn``, when the
    config has sites), the final norm. Weights are allocated
    uninitialised; fill them with :meth:`init_weights` or
    ``convert.params_from_jax``."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.embed = Embed(cfg, device, dtype)
        self.layers = nn.ModuleList(_LAYERS[cfg.family](cfg, device, dtype)
                                    for _ in range(cfg.n_layers))
        self.shared_attn = SharedAttn(cfg, device, dtype) \
            if cfg.family == "hybrid" and cfg.attn_every else None
        self.final_norm = RMSNorm(cfg, device, dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        """The reference's initialisation: normals at its scales (drawn in
        f32, then cast), norm scales of one, the SSM blocks' constants."""
        for module in self.modules():
            if module is not self and hasattr(module, "init_weights"):
                module.init_weights(generator)


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None, dtype=None) -> Transformer:
    """A model with the reference's shapes and scales, drawn from
    ``generator`` (a fresh one seeded 0 when None), on the card unless
    ``device`` says otherwise. The generator must live on that device.

    ``dtype=None`` gives the serving model (weights in the compute dtype,
    no gradients; the weights the reference reads in f32 stay f32); a
    dtype, ``pdtype(cfg)`` for the reference's f32 masters, gives the
    trainable model. From the same generator state the two draw the same
    values: the masters cast to the compute dtype equal the serving
    weights bit for bit."""
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


def _casts(params: Transformer, cfg: ModelConfig) -> tuple:
    """(each layer's precast weights, the shared block's): all None with
    the lever off."""
    return [_precast(layer, cfg) for layer in params.layers], _precast(params.shared_attn, cfg)


def forward(params: Transformer, batch: dict, cfg: ModelConfig):
    """Returns (logits [B, S, vocab] f32, aux dict): the training forward,
    differentiable, through no hand-written kernel. ``aux["moe_aux"]`` is
    the MoE auxiliary averaged over the layers (0 for the other families).
    The hybrid runs a Python loop over its layers with the shared block
    after each site, each rematerialized on its own."""
    check_ported(cfg)
    check_levers(cfg)
    h = params.embed.embed(batch["tokens"])
    b, s, _ = h.shape
    pos = torch.arange(s, dtype=torch.int32, device=h.device).expand(b, s)
    casts, shared_cast = _casts(params, cfg)
    sites = _hybrid_sites(cfg)
    aux_loss = torch.zeros((), device=h.device)
    for i, layer in enumerate(params.layers):
        out = _remat(functools.partial(_call, layer, casts[i], "train_forward", cfg=cfg,
                                       positions=pos), cfg)(h)
        if cfg.family in ("dense", "moe"):
            h, aux = out
            aux_loss = aux_loss + aux
        else:
            h = out
        if i in sites:
            h = _remat(functools.partial(_call, params.shared_attn, shared_cast,
                                         "train_forward", cfg=cfg, positions=pos), cfg)(h)
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
    """Empty decode cache of the config's family: ``pos`` int32 [B] and

    * dense, MoE: K and V ``[L, B, eff, Hkv, hd]`` in the compute dtype
      (``eff`` is the window when the config slides one);
    * ssm: the f32 states ``S [L, B, nh, P, P]`` and the token shifts' last
      inputs ``x_att``, ``x_cm [L, B, d]`` in the compute dtype;
    * hybrid: the f32 SSM states ``h [L, B, nh, P, N]``, the conv states
      ``conv [L, B, 3, conv_ch]`` and K and V ``[sites, B, eff, Hkv, hd]``
      (at least one slab). The reference's prefill returns the conv states
      of every layer after the first, and K and V, in f32 (its residual
      stream is f32 after the first Mamba-2 block), so they are f32 here."""
    check_ported(cfg)
    device = resolve_device(device)
    cdt = cdtype(cfg)
    L, b = cfg.n_layers, batch_size
    eff = min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len
    cache = {"pos": torch.zeros(b, dtype=torch.int32, device=device)}

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    if cfg.family in ("dense", "moe"):
        cache["k"] = zeros((L, b, eff, cfg.n_kv_heads, cfg.head_dim), cdt)
        cache["v"] = zeros((L, b, eff, cfg.n_kv_heads, cfg.head_dim), cdt)
    elif cfg.family == "ssm":
        hp = cfg.ssm_head_dim
        cache["S"] = zeros((L, b, cfg.d_model // hp, hp, hp), torch.float32)
        cache["x_att"] = zeros((L, b, cfg.d_model), cdt)
        cache["x_cm"] = zeros((L, b, cfg.d_model), cdt)
    else:
        d_inner, hp, nh, n = mamba2.mamba_dims(cfg)
        stream = torch.promote_types(cdt, torch.float32)   # after the first block
        sites = _hybrid_sites(cfg)
        cache["h"] = zeros((L, b, nh, hp, n), torch.float32)
        cache["conv"] = zeros((L, b, mamba2.CONV_W - 1, d_inner + 2 * n),
                              stream if L > 1 else cdt)
        kv = (max(len(sites), 1), b, eff, cfg.n_kv_heads, cfg.head_dim)
        cache["k"] = zeros(kv, stream if sites else cdt)
        cache["v"] = zeros(kv, stream if sites else cdt)
    return cache


def _run_layers(params: Transformer, cfg: ModelConfig, method: str, h, *args):
    """Every layer's ``method`` (``prefill`` or ``decode``) in turn, the
    hybrid's shared block after each site, each on its precast weights
    when the lever is on."""
    casts, shared_cast = _casts(params, cfg)
    sites = _hybrid_sites(cfg)
    for i, layer in enumerate(params.layers):
        h = _call(layer, casts[i], method, h, cfg, *args, i)
        if i in sites:
            h = _call(params.shared_attn, shared_cast, method, h, cfg, *args,
                      sites.index(i))
    return h


def prefill(params: Transformer, batch: dict, cfg: ModelConfig, cache_len: int):
    """Run the prompt, return (next-token logits [B, vocab] f32, cache).

    With uneven right-padded prompts, ``batch["lengths"]`` (int [B], true
    prompt lengths) selects each sequence's logits at its own last real token
    instead of the padded final position; without it, the last position is
    used for every sequence (uniform-length prompts). As in the reference,
    the pads of shorter prompts enter the SSM and conv states and the KV
    cache."""
    tokens = batch["tokens"]
    h = params.embed.embed(tokens)
    b, s, _ = h.shape
    pos = torch.arange(s, dtype=torch.int32, device=h.device).expand(b, s)
    cache = init_cache(cfg, b, cache_len, device=h.device)
    cache["pos"].fill_(s)
    h = _run_layers(params, cfg, "prefill", h, pos, cache)
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
    h = _run_layers(params, cfg, "decode", h, cache)
    logits = params.embed.unembed(params.final_norm(h))
    cache["pos"] = cache["pos"] + 1
    return logits[:, 0], cache
