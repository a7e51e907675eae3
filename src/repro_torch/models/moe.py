"""Mixture-of-Experts layer: top-k router + sort-based capacity dispatch.

The port of the JAX package's ``models/moe.py``. The dispatch is the
reference's: the router in f32, softmax over the top-k logits, and per-row
capacity (``capacity(cfg, S)`` slots an expert in each batch row, pad
positions included); within a row and an expert, assignments are ordered by
``position * k + j`` and those past the capacity are dropped.

The expert compute differs in layout, not in value. The reference scatters
the kept assignments into a dense ``[B, E, cap, d]`` buffer, runs three
einsums over it and gathers back; the buffer's empty slots hold zeros that
are never gathered. Here the kept assignments alone, grouped by expert over
all rows, go through ``ops.grouped_matmul_ragged`` (on the card the CUDA
kernel ``kernels/csrc/grouped_matmul.cu``, on the CPU its plain version):
w1 and w3, ``silu(h1) * h3``, then w2, each product rounded to the compute
dtype as the reference's einsums are. The expert groups are planned on the
device, so a decode step never waits on the host. The weighted
contributions of a token's k assignments are summed in a fixed order, in
the compute dtype (the reference scatter-adds them; in f32 both are the
same sum up to order). That is serving's ``moe_apply``.

Training runs ``moe_apply_einsum``, the reference's ``moe_apply`` itself:
the same routing, the dense ``[B, E, cap, d]`` buffer and the three expert
einsums (``becd,edf->becf``) as plain products, which autograd
differentiates, with the Switch auxiliary. The grouped-GEMM kernel records
no autograd history, so its wrapper refuses a tensor that requires grad.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import cdtype, draw_normal, weight, weight_dtypes


class MoE(nn.Module):
    """The MoE weights of one layer in the reference's shapes: ``router [d,
    E]`` in the param dtype (the reference reads it in f32), ``w1``/``w3 [E,
    d, ff]`` and ``w2 [E, ff, d]`` in the compute dtype. Calling the module
    gives the layer's output y without the auxiliary (serving's path)."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        (dt, rdt), grad = weight_dtypes(cfg, dtype), dtype is not None
        self.router = weight((d, e), rdt, device, grad)
        self.w1 = weight((e, d, ff), dt, device, grad)
        self.w3 = weight((e, d, ff), dt, device, grad)
        self.w2 = weight((e, ff, d), dt, device, grad)

    def init_weights(self, generator: torch.Generator) -> None:
        d, ff = self.cfg.d_model, self.cfg.d_ff
        draw_normal(self.router, d ** -0.5, generator)
        draw_normal(self.w1, d ** -0.5, generator)
        draw_normal(self.w3, d ** -0.5, generator)
        draw_normal(self.w2, ff ** -0.5, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _route_and_run(self, x, self.cfg)[0]


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    cap = int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-cap // 8) * 8)


def moe_apply(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """x: [B, S, d] -> (y [B, S, d] in the compute dtype, aux_loss). Tokens
    over capacity are dropped (the residual stream carries them unchanged)."""
    y, logits, top_idx = _route_and_run(p, x, cfg)
    return y, _switch_aux(logits, top_idx, cfg)


def _switch_aux(logits: torch.Tensor, top_idx: torch.Tensor, cfg: ModelConfig):
    """The Switch-style load-balancing auxiliary of the router logits [B, S,
    E] and the chosen experts [B, S, k]."""
    b, s, e = logits.shape
    sk = s * cfg.top_k
    frac_tokens = torch.zeros(b, e, device=logits.device).scatter_add_(
        1, top_idx.reshape(b, sk), torch.ones(b, sk, device=logits.device)) / sk
    mean_prob = torch.softmax(logits, dim=-1).mean(dim=1)     # [B, E]
    return e * torch.mean(torch.sum(frac_tokens * mean_prob, dim=-1))


def moe_apply_einsum(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """The training MoE layer: x [B, S, d] -> (y [B, S, d] in the compute
    dtype, aux_loss), the reference's per-row sort-based capacity dispatch
    into a dense ``[B, E, cap, d]`` buffer and its expert einsums as plain
    products (no hand-written kernel), differentiable. Weights are cast to
    the compute dtype at use; the router runs in f32."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, s)          # per row
    dt = cdtype(cfg)
    dev = x.device

    logits = x.float() @ p.router.float()                     # [B, S, E]
    top_logit, top_idx = torch.topk(logits, k, dim=-1)        # [B, S, k]
    top_w = torch.softmax(top_logit, dim=-1)                  # renormalized over k

    # ---- per-row sort-based dispatch -----------------------------------------
    sk = s * k
    expert_flat = top_idx.reshape(b, sk)                      # [B, S*k]
    w_flat = top_w.reshape(b, sk)
    order = torch.argsort(expert_flat, dim=-1, stable=True)   # group by expert
    e_sorted = torch.gather(expert_flat, 1, order)
    tok_sorted = order // k                                   # token within row
    w_sorted = torch.gather(w_flat, 1, order)
    starts = torch.searchsorted(e_sorted, torch.arange(e, device=dev).expand(b, e).contiguous())
    pos_in_grp = torch.arange(sk, device=dev)[None, :] - torch.gather(starts, 1, e_sorted)
    keep = pos_in_grp < cap
    slot = torch.where(keep, e_sorted * cap + pos_in_grp, e * cap)   # [B, S*k]

    bidx = torch.arange(b, device=dev)[:, None].expand(b, sk)
    gathered = torch.gather(x.to(dt), 1, tok_sorted[..., None].expand(b, sk, d))
    # dropped assignments all land in the spare slot e * cap, sliced off
    buf = x.new_zeros((b, e * cap + 1, d), dtype=dt).index_put((bidx, slot), gathered)
    he = buf[:, : e * cap].reshape(b, e, cap, d)

    # ---- expert FFN (batched over experts) --------------------------------------
    h = F.silu(torch.einsum("becd,edf->becf", he, p.w1.to(dt)))
    h = h * torch.einsum("becd,edf->becf", he, p.w3.to(dt))
    ye = torch.einsum("becf,efd->becd", h, p.w2.to(dt))

    # ---- weighted scatter-back ------------------------------------------------
    ye_flat = torch.cat([ye.reshape(b, e * cap, d), ye.new_zeros((b, 1, d))], dim=1)
    contrib = ye_flat[bidx, slot] * (w_sorted[..., None].to(dt) * keep[..., None])
    y = x.new_zeros((b, s, d), dtype=dt).index_put((bidx, tok_sorted), contrib,
                                                   accumulate=True)
    return y, _switch_aux(logits, top_idx, cfg)


def _route_and_run(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """The router and the experts: (y, the router logits [B, S, E] in f32,
    the top-k experts [B, S, k])."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, s)          # per row
    dt = cdtype(cfg)
    dev = x.device

    logits = x.float() @ p.router.float()                     # [B, S, E]
    top_logit, top_idx = torch.topk(logits, k, dim=-1)        # [B, S, k]
    top_w = torch.softmax(top_logit, dim=-1)                  # renormalized over k

    # ---- per-row sort-based dispatch -----------------------------------------
    n = b * s * k
    ids = torch.arange(n, device=dev)
    expert = top_idx.reshape(n)                               # assignment order
    # a stable sort by (expert, row) keeps position * k + j order within both
    key, order = torch.sort(expert * b + ids // (s * k), stable=True)
    keep = ids - torch.searchsorted(key, key) < cap           # rank in (row, expert)
    # the kept assignments first, still grouped by expert: the GEMM rows
    perm = torch.sort((~keep).to(torch.int8), stable=True).indices
    rows, keep_row = order[perm], keep[perm]                  # row -> assignment
    row_expert = torch.where(keep_row, expert[rows], e)       # ascending
    seg_rows = torch.searchsorted(row_expert, torch.arange(e + 1, device=dev))
    xe = x.reshape(b * s, d).to(dt)[rows // k]                # [n, d]

    # ---- expert FFN over the kept rows (grouped GEMM) --------------------------
    h = F.silu(ops.grouped_matmul_ragged(xe, p.w1, seg_rows, dt))
    h = h * ops.grouped_matmul_ragged(xe, p.w3, seg_rows, dt)
    ye = ops.grouped_matmul_ragged(h, p.w2, seg_rows, dt)     # dropped rows unwritten

    # ---- weighted gather-back, in assignment order ---------------------------
    slot = torch.empty_like(rows)
    slot[rows] = ids                                          # GEMM row of each assignment
    contrib = torch.where(keep_row[slot, None], ye[slot] * top_w.reshape(n, 1).to(dt), 0)
    return contrib.reshape(b, s, k, d).sum(dim=2), logits, top_idx


def moe_apply_dense_oracle(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Oracle: every token through every chosen expert, no capacity drops, in
    f32. Tests compare moe_apply against this with capacity_factor large
    enough that nothing drops."""
    b, s, d = x.shape
    xf = x.reshape(-1, d).float()
    top_logit, top_idx = torch.topk(xf @ p.router.float(), cfg.top_k, dim=-1)
    top_w = torch.softmax(top_logit, dim=-1)
    y = torch.zeros_like(xf)
    for j in range(cfg.top_k):
        idx = top_idx[:, j]
        xt = xf[:, None, :]
        h = F.silu(xt @ p.w1[idx].float()) * (xt @ p.w3[idx].float())
        y = y + (h @ p.w2[idx].float())[:, 0] * top_w[:, j, None]
    return y.reshape(b, s, d)
