"""Mamba-2 (SSD) block for the Zamba2 hybrid (arXiv:2411.15242 / 2405.21060).

The port of the JAX package's ``models/mamba2.py``. Per head h (P = head
dim, N = state dim):
    h_t = exp(A * dt_t) h_{t-1} + dt_t * x_t  B_t^T        (state: P x N)
    y_t = h_t C_t + D * x_t
with scalar A < 0 per head, dt_t = softplus(dt_proj(u_t) + dt_bias), and
B_t, C_t shared across heads (n_groups = 1). A causal depthwise conv (width
4) precedes the SSM on (x, B, C), and a SiLU gate z wraps the output.

``ssd_scan`` is the sequential form (decode: one token on the carried
state), ``ssd_chunked`` the chunked parallel form (prefill and training):
in-chunk masked products plus the state's recurrence across chunks, the
pairwise log-decays masked before the exponent (their upper triangle is
positive and overflows; exp(inf) * 0 poisons the backward). The reference
scans its chunks with ``lax.scan``; here the in-chunk terms of every chunk
are batched products and only the state's recurrence runs chunk by chunk.
Neither form reaches a hand-written kernel: the reference's are plain
products too.

As in the reference, the block's output is f32 (the scan's output keeps
its dtype through the gated norm, and its product with the compute-dtype
``out_proj`` promotes), so the hybrid's residual stream is f32 after its
first block. In the serving model (``dtype=None``) the weights the
reference reads in f32 (``A_log``, ``dt_bias``, ``D``, ``norm_scale``) stay
in the param dtype; the rest are held in the compute dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import cdtype, draw_normal, matmul, weight, weight_dtypes

CONV_W = 4
EXPAND = 2
# the weights in the reference's order, and those it reads in f32
FIELDS = ("in_proj", "conv_w", "conv_b", "A_log", "dt_bias", "D", "norm_scale", "out_proj")
F32_READ = ("A_log", "dt_bias", "D", "norm_scale")


def mamba_dims(cfg: ModelConfig):
    d_inner = EXPAND * cfg.d_model
    p = cfg.ssm_head_dim
    return d_inner, p, d_inner // p, cfg.ssm_state


class Mamba2(nn.Module):
    """The weights of one Mamba-2 block."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        d = cfg.d_model
        d_inner, _, nh, n = mamba_dims(cfg)
        conv_ch = d_inner + 2 * n   # the conv runs over (x, B, C)
        (dt, fdt), grad = weight_dtypes(cfg, dtype), dtype is not None
        shapes = {"in_proj": (d, 2 * d_inner + 2 * n + nh), "conv_w": (CONV_W, conv_ch),
                  "conv_b": (conv_ch,), "A_log": (nh,), "dt_bias": (nh,), "D": (nh,),
                  "norm_scale": (d_inner,), "out_proj": (d_inner, d)}
        for name, shape in shapes.items():
            setattr(self, name, weight(shape, fdt if name in F32_READ else dt, device, grad))

    def init_weights(self, generator: torch.Generator) -> None:
        """The reference's: ``A_log = log(linspace(1, 16, nh))`` (A =
        -exp(A_log)), ``dt_bias`` -2, ``D`` 1, ``norm_scale`` 1, ``conv_b``
        0, normals at its scales."""
        d, d_inner = self.in_proj.shape[0], self.out_proj.shape[0]
        nh = self.A_log.shape[0]
        with torch.no_grad():
            self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, nh, device=self.A_log.device)))
            for name, value in (("dt_bias", -2.0), ("D", 1.0), ("norm_scale", 1.0),
                                ("conv_b", 0.0)):
                getattr(self, name).fill_(value)
        draw_normal(self.in_proj, d ** -0.5, generator)
        draw_normal(self.conv_w, 0.5, generator)
        draw_normal(self.out_proj, d_inner ** -0.5, generator)


def _split_proj(p: Mamba2, u, cfg: ModelConfig, dt):
    d_inner, _, _, n = mamba_dims(cfg)
    zxbcdt = matmul(u, p.in_proj, dt)
    return (zxbcdt[..., :d_inner], zxbcdt[..., d_inner:2 * d_inner + 2 * n],
            zxbcdt[..., 2 * d_inner + 2 * n:])


def _causal_conv(p: Mamba2, xbc, dt, conv_state=None, valid_len=None):
    """Depthwise causal conv of width CONV_W. xbc: [B, S, C]; conv_state:
    [B, W-1, C]. Returns (y, new_conv_state). ``valid_len`` marks the last
    real (unpadded) position, so the carried state holds no chunk padding."""
    b, s, c = xbc.shape
    w = p.conv_w.to(dt)   # [W, C]
    if conv_state is None:
        conv_state = xbc.new_zeros((b, CONV_W - 1, c))
    ext = torch.cat([conv_state, xbc], dim=1)   # [B, W-1+S, C]
    out = sum(ext[:, i:i + s, :] * w[i] for i in range(CONV_W)) + p.conv_b.to(dt)
    end = (valid_len if valid_len is not None else s) + (CONV_W - 1)
    return F.silu(out), ext[:, end - (CONV_W - 1):end, :]


def _gated_norm(p: Mamba2, y, z, eps: float = 1e-5):
    """The gated RMSNorm before the output projection, in f32, back to y's
    dtype."""
    y32 = y.float()
    var = torch.mean(y32 * y32, dim=-1, keepdim=True)
    y32 = y32 * torch.rsqrt(var + eps) * p.norm_scale.float()
    return (y32 * F.silu(z.float())).to(y.dtype)


def _prep(p: Mamba2, u, cfg: ModelConfig, conv_state=None, valid_len=None):
    d_inner, hp, nh, n = mamba_dims(cfg)
    dt = cdtype(cfg)
    b, s, _ = u.shape
    z, xbc, dt_raw = _split_proj(p, u, cfg, dt)
    xbc, conv_state = _causal_conv(p, xbc, dt, conv_state, valid_len=valid_len)
    x = xbc[..., :d_inner].reshape(b, s, nh, hp)
    bmat = xbc[..., d_inner:d_inner + n]               # [B, S, N]
    cmat = xbc[..., d_inner + n:]                      # [B, S, N]
    delta = F.softplus(dt_raw.float() + p.dt_bias.float())   # [B, S, nh]
    a = -torch.exp(p.A_log.float())                    # [nh]
    decay = torch.exp(delta * a[None, None, :])        # [B, S, nh]
    return z, x, bmat, cmat, delta, decay, conv_state


def ssd_scan(p: Mamba2, u: torch.Tensor, cfg: ModelConfig, state=None, conv_state=None):
    """Sequential form. u: [B, S, d]; state: [B, nh, P, N] f32. Returns
    (y [B, S, d], state, conv_state)."""
    d_inner, hp, nh, n = mamba_dims(cfg)
    b, s, _ = u.shape
    z, x, bmat, cmat, delta, decay, conv_state = _prep(p, u, cfg, conv_state)
    dfac = p.D.float()
    h = u.new_zeros((b, nh, hp, n), dtype=torch.float32) if state is None else state
    ys = []
    for t in range(s):
        xt = x[:, t].float()                                   # [B, nh, P]
        dx = delta[:, t, :, None] * xt
        h = decay[:, t, :, None, None] * h + dx[..., :, None] * bmat[:, t, None, None, :]
        yt = torch.einsum("bhpn,bn->bhp", h, cmat[:, t].float())
        ys.append(yt + dfac[None, :, None] * xt)
    y = torch.stack(ys, dim=1).reshape(b, s, d_inner)          # f32
    y = _gated_norm(p, y, z)
    return matmul(y, p.out_proj, cdtype(cfg)), h, conv_state


def ssd_chunked(p: Mamba2, u: torch.Tensor, cfg: ModelConfig, chunk: int = 64, state=None,
                conv_state=None):
    """The SSD chunked parallel form, equal to ``ssd_scan``. Padded tail
    steps get decay 1 and contribution 0; the conv state is taken at the
    last real position."""
    d_inner, hp, nh, n = mamba_dims(cfg)
    b, s, _ = u.shape
    pad = (-s) % chunk
    if pad:
        u = F.pad(u, (0, 0, 0, pad))
    sp = s + pad
    z, x, bmat, cmat, delta, decay, conv_state = _prep(p, u, cfg, conv_state, valid_len=s)
    dfac = p.D.float()
    if pad:
        valid = (torch.arange(sp, device=u.device) < s)[None, :, None]
        decay = torch.where(valid, decay, 1.0)
        delta = torch.where(valid, delta, 0.0)
    nc = sp // chunk
    xc = x.reshape(b, nc, chunk, nh, hp).permute(1, 0, 3, 2, 4).float()   # [nc,B,nh,c,P]
    bc = bmat.reshape(b, nc, chunk, n).permute(1, 0, 2, 3).float()       # [nc,B,c,N]
    cc = cmat.reshape(b, nc, chunk, n).permute(1, 0, 2, 3).float()
    dl = delta.reshape(b, nc, chunk, nh).permute(1, 0, 3, 2)             # [nc,B,nh,c]
    la = torch.log(torch.clamp(decay, min=1e-37)).reshape(b, nc, chunk, nh) \
        .permute(1, 0, 3, 2)
    ci = torch.cumsum(la, dim=-1)          # inclusive cumulative log-decay in a chunk
    tot = ci[..., -1:]
    # in-chunk: y_t += sum_{j<=t} exp(ci_t - ci_j) dl_j x_j B_j^T C_t, the
    # pairwise log-decay masked before the exponent
    diff = ci[..., :, None] - ci[..., None, :]                 # [nc,B,nh,c,c]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=u.device))
    L = torch.exp(torch.where(tri, diff, -1e30))
    gram = torch.einsum("cbtn,cbjn->cbtj", cc, bc)             # [nc,B,c,c]
    att = L * gram[:, :, None]
    dx = dl[..., :, None] * xc                                 # [nc,B,nh,c,P]
    y = torch.einsum("cbhtj,cbhjp->cbhtp", att, dx)
    # the state's update a chunk: h' = exp(tot) h + sum_j exp(tot - ci_j) dl_j x_j B_j^T
    k_tail = torch.exp(tot - ci)[..., None] * dx
    kb = torch.einsum("cbhjp,cbjn->cbhpn", k_tail, bc)
    h = u.new_zeros((b, nh, hp, n), dtype=torch.float32) if state is None else state
    states = []
    for c in range(nc):
        states.append(h)
        h = torch.exp(tot[c])[..., None] * h + kb[c]
    # across chunks: y_t += C_t . exp(ci_t) h_in
    y = y + torch.einsum("cbhpn,cbtn,cbht->cbhtp", torch.stack(states), cc, torch.exp(ci))
    y = y + dfac[None, None, :, None, None] * xc
    y = y.permute(1, 0, 3, 2, 4).reshape(b, sp, d_inner)[:, :s]
    y = _gated_norm(p, y, z[:, :s] if pad else z)
    return matmul(y, p.out_proj, cdtype(cfg)), h, conv_state

