"""RWKV-6 "Finch": linear attention with data-dependent decay (arXiv:2404.05892).

The port of the JAX package's ``models/rwkv6.py``. Time mixing (per head,
head size P = cfg.ssm_head_dim):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t          (matrix state, P x P per head)
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)      (bonus u for the current token)
with w_t = exp(-exp(w0 + lora_w(x'_t))), the data-dependent decay, and
data-dependent token-shift interpolation (ddlerp) feeding every projection.
Channel mixing is the RWKV squared-ReLU FFN over token-shifted inputs.

``time_mix`` is the sequential form (decode, one token on the carried
state); ``time_mix_chunked`` the chunked parallel form (prefill and
training), in f32 at the reference's chunk. The reference scans its chunks
with ``lax.scan``; here the in-chunk terms of every chunk are batched
products and only the state's recurrence runs chunk by chunk. The in-chunk
decays are taken pairwise in log space, where the reference factors them
into two exponentials that overflow for strong decays (see
``time_mix_chunked``). Neither form reaches a hand-written kernel: the
reference's are plain products too.

The weights keep the reference's names and shapes. In the serving model
(``dtype=None``) the weights the reference reads in f32 (``w0``, ``u``,
``ln_x``) stay in the param dtype; the rest are held in the compute dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import cdtype, draw_normal, weight, weight_dtypes

LORA_R = 32
MIX_NAMES = ("w", "k", "v", "r", "g")
# the weights in the reference's order, and those it reads in f32
FIELDS = ("mix_mu", "mix_A", "mix_B", "wr", "wk", "wv", "wg", "wo", "w0", "w_A", "w_B", "u",
          "ln_x", "cm_mu_k", "cm_mu_r", "cm_k", "cm_v", "cm_r")
F32_READ = ("w0", "u", "ln_x")


class RWKV(nn.Module):
    """The time-mix and channel-mix weights of one layer."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        d, ff, hp = cfg.d_model, cfg.d_ff, cfg.ssm_head_dim
        nh, m = d // hp, len(MIX_NAMES)
        (dt, fdt), grad = weight_dtypes(cfg, dtype), dtype is not None
        shapes = {"mix_mu": (m, d), "mix_A": (m, d, LORA_R), "mix_B": (m, LORA_R, d),
                  "wr": (d, d), "wk": (d, d), "wv": (d, d), "wg": (d, d), "wo": (d, d),
                  "w0": (d,), "w_A": (d, LORA_R), "w_B": (LORA_R, d), "u": (nh, hp),
                  "ln_x": (d,), "cm_mu_k": (d,), "cm_mu_r": (d,), "cm_k": (d, ff),
                  "cm_v": (ff, d), "cm_r": (d, d)}
        for name, shape in shapes.items():
            setattr(self, name, weight(shape, fdt if name in F32_READ else dt, device, grad))

    def init_weights(self, generator: torch.Generator) -> None:
        """The reference's: mus 0.5, ``w0`` -0.6, ``ln_x`` 1, normals at its
        scales."""
        d, ff = self.wr.shape[0], self.cm_k.shape[1]
        with torch.no_grad():
            for name, value in (("mix_mu", 0.5), ("w0", -0.6), ("ln_x", 1.0),
                                ("cm_mu_k", 0.5), ("cm_mu_r", 0.5)):
                getattr(self, name).fill_(value)
        for name, scale in (("mix_A", d ** -0.5), ("mix_B", LORA_R ** -0.5),
                            ("wr", d ** -0.5), ("wk", d ** -0.5), ("wv", d ** -0.5),
                            ("wg", d ** -0.5), ("wo", d ** -0.5), ("w_A", d ** -0.5),
                            ("w_B", LORA_R ** -0.5), ("u", 0.1), ("cm_k", d ** -0.5),
                            ("cm_v", ff ** -0.5), ("cm_r", d ** -0.5)):
            draw_normal(getattr(self, name), scale, generator)


def _shift(x: torch.Tensor, x_prev_in: torch.Tensor | None) -> torch.Tensor:
    """The token shift: [x_prev_in (zeros when None), x[:, :-1]]."""
    first = x.new_zeros((x.shape[0], 1, x.shape[2])) if x_prev_in is None \
        else x_prev_in[:, None, :]
    return torch.cat([first, x[:, :-1]], dim=1)


def _mix_inputs(p: RWKV, x, x_prev, dt) -> dict:
    """Name -> mixed input [B, S, d] (RWKV-6 ddlerp)."""
    mu, A, B = p.mix_mu.to(dt), p.mix_A.to(dt), p.mix_B.to(dt)
    delta = x_prev - x
    out = {}
    for i, name in enumerate(MIX_NAMES):
        xx = x + delta * mu[i]
        adj = torch.tanh(xx @ A[i]) @ B[i]      # low-rank data-dependent term
        out[name] = x + delta * (mu[i] + adj)
    return out


def _decay(p: RWKV, xw, dt) -> torch.Tensor:
    """w_t in (0, 1): exp(-exp(w0 + lora(x))) per channel, f32."""
    lora = torch.tanh(xw @ p.w_A.to(dt)) @ p.w_B.to(dt)
    return torch.exp(-torch.exp(p.w0.float() + lora.float()))


def _group_norm(x, scale, nh: int, hp: int, eps: float = 1e-5) -> torch.Tensor:
    """Per-head layer norm over the head dim (RWKV ln_x), f32."""
    shape = x.shape
    xh = x.reshape(*shape[:-1], nh, hp).float()
    mean = xh.mean(dim=-1, keepdim=True)
    var = ((xh - mean) ** 2).mean(dim=-1, keepdim=True)
    xh = ((xh - mean) * torch.rsqrt(var + eps)).reshape(shape)
    return xh * scale.float()


def _projections(p: RWKV, x, x_prev, cfg: ModelConfig):
    """r, k, v [B, S, nh, P] and w (f32) in heads; the gate g [B, S, d]."""
    b, s, d = x.shape
    hp = cfg.ssm_head_dim
    dt = cdtype(cfg)
    mixed = _mix_inputs(p, x, x_prev, dt)
    r = (mixed["r"] @ p.wr.to(dt)).reshape(b, s, d // hp, hp)
    k = (mixed["k"] @ p.wk.to(dt)).reshape(b, s, d // hp, hp)
    v = (mixed["v"] @ p.wv.to(dt)).reshape(b, s, d // hp, hp)
    g = F.silu(mixed["g"] @ p.wg.to(dt))
    w = _decay(p, mixed["w"], dt).reshape(b, s, d // hp, hp)
    return r, k, v, w, g


def _output(p: RWKV, y, g, cfg: ModelConfig) -> torch.Tensor:
    """ln_x, the gate, the output projection: y [B, S, d] f32 in."""
    d, hp, dt = cfg.d_model, cfg.ssm_head_dim, cdtype(cfg)
    y = _group_norm(y, p.ln_x, d // hp, hp)
    y = (y * g.float()).to(dt)
    return y @ p.wo.to(dt)


def time_mix(p: RWKV, x: torch.Tensor, cfg: ModelConfig, state=None, x_prev_in=None):
    """Sequential form. x: [B, S, d]. state: [B, nh, P, P] f32 (or None ->
    zeros). Returns (y [B, S, d], state_out, x_last [B, d])."""
    b, s, d = x.shape
    hp = cfg.ssm_head_dim
    r, k, v, w, g = _projections(p, x, _shift(x, x_prev_in), cfg)
    u = p.u.float()                                            # [nh, P]
    S = x.new_zeros((b, d // hp, hp, hp), dtype=torch.float32) if state is None else state
    ys = []
    for t in range(s):
        kv = k[:, t].float()[..., :, None] * v[:, t].float()[..., None, :]
        St = S + u[None, :, :, None] * kv
        ys.append(torch.einsum("bhp,bhpq->bhq", r[:, t].float(), St))
        S = w[:, t][..., :, None] * S + kv
    y = torch.stack(ys, dim=1).reshape(b, s, d)                # f32
    return _output(p, y, g, cfg), S, x[:, -1, :]


def time_mix_chunked(p: RWKV, x: torch.Tensor, cfg: ModelConfig, chunk: int = 64,
                     state=None, x_prev_in=None):
    """Chunked parallel form, equal to ``time_mix``. Within a chunk the
    contribution of in-chunk tokens is masked products of queries, keys and
    their pairwise decays (differences of in-chunk cumulative log-decays);
    across chunks the state S is carried. Padded tail steps get decay 1 and
    contribution 0. Every term in f32. Returns (y, state_out, x_last) as
    ``time_mix``.

    The reference factors the pairwise decay into r_t prod_{i<t} w_i and
    k_j / prod_{i<=j} w_i, whose second factor overflows f32 once a chunk's
    decays pass e^-88 (a decay rate -log w above 2.75 a step at chunk 32),
    and then returns inf or NaN where its sequential form is finite; the
    pairwise form here stays finite and equal to the sequential form. Where
    the reference's is finite the two agree to f32 summation order."""
    b, s, d = x.shape
    hp = cfg.ssm_head_dim
    nh = d // hp
    pad = (-s) % chunk
    x_padded = F.pad(x, (0, 0, 0, pad)) if pad else x
    sp = s + pad
    r, k, v, w, g = _projections(p, x_padded, _shift(x_padded, x_prev_in), cfg)
    u = p.u.float()
    if pad:
        valid = (torch.arange(sp, device=x.device) < s)[None, :, None, None]
        w = torch.where(valid, w, 1.0)
        k = torch.where(valid, k, 0.0)
    nc = sp // chunk

    def chunks(t):   # [B, sp, nh, P] -> [nc, B, nh, c, P]
        return t.reshape(b, nc, chunk, nh, hp).permute(1, 0, 3, 2, 4)

    rc, kc, vc, wc = chunks(r).float(), chunks(k).float(), chunks(v).float(), chunks(w)
    logw = torch.log(torch.clamp(wc, min=1e-30))
    cum_incl = torch.cumsum(logw, dim=3)              # prod w_1..w_t (inclusive)
    cum_excl = cum_incl - logw                        # prod w_1..w_{t-1} (exclusive)
    total = cum_incl[:, :, :, -1:, :]                 # prod over the whole chunk
    # in-chunk terms of every chunk at once: the decay from key j to query
    # t > j, prod_{j<i<t} w_i per channel, taken pairwise in log space and
    # masked before the exponent (the reference's r_t prod_{i<t} w_i times
    # k_j / prod_{i<=j} w_i overflows once a chunk's decays pass e^-88)
    diff = cum_excl[:, :, :, :, None, :] - cum_incl[:, :, :, None, :, :]   # [nc,B,nh,t,j,P]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device), -1)
    pair = torch.exp(torch.where(tri[:, :, None], diff, -1e30))   # strictly lower: j < t
    att = torch.einsum("cbhtp,cbhtjp->cbhtj", rc, pair * kc[:, :, :, None, :, :])
    y = torch.einsum("cbhtj,cbhjq->cbhtq", att, vc)
    r_dec = rc * torch.exp(cum_excl)                  # r_t * prod_{i<t} w_i
    diag = torch.einsum("cbhtp,cbhtp->cbht", rc, u[None, None, :, None, :] * kc)
    y = y + diag[..., None] * vc                      # the u-bonus diagonal
    k_tail = kc * torch.exp(total - cum_incl)         # prod_{j<i<=C} w_i
    kv = torch.einsum("cbhjp,cbhjq->cbhpq", k_tail, vc)
    decay = torch.exp(total).squeeze(3)[..., :, None]   # [nc, B, nh, P, 1]
    # the state entering each chunk, then its contribution
    S = x.new_zeros((b, nh, hp, hp), dtype=torch.float32) if state is None else state
    states = []
    for c in range(nc):
        states.append(S)
        S = decay[c] * S + kv[c]
    y = y + torch.einsum("cbhtp,cbhpq->cbhtq", r_dec, torch.stack(states))
    y = y.permute(1, 0, 3, 2, 4).reshape(b, sp, d)
    y = _output(p, y, g, cfg)[:, :s]
    return y, S, x_padded[:, s - 1, :]


def channel_mix(p: RWKV, x: torch.Tensor, cfg: ModelConfig, x_prev_in=None):
    """RWKV squared-ReLU FFN with token shift. Returns (y, x_last)."""
    dt = cdtype(cfg)
    x_prev = _shift(x, x_prev_in)
    xk = x + (x_prev - x) * p.cm_mu_k.to(dt)
    xr = x + (x_prev - x) * p.cm_mu_r.to(dt)
    h = torch.square(torch.relu(xk @ p.cm_k.to(dt)))
    y = torch.sigmoid(xr @ p.cm_r.to(dt)) * (h @ p.cm_v.to(dt))
    return y, x[:, -1, :]
