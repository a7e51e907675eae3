"""AdamW with a cosine schedule and global-norm clipping (no torch.optim).

The port of the JAX package's ``train/optim.py``, with its f32 math. The
optimizer state is ``{"mu": {name: tensor}, "nu": {name: tensor}, "step":
int32 tensor}``, keyed by the model's ``named_parameters()`` (or by a dict
of named tensors). ``step`` stays on the host, so the schedule never waits
on the card. ``adamw_update`` updates the parameters and the moments in
place, under ``torch.no_grad()``, and returns them, as the reference
returns its new trees.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    min_lr_fraction: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    microbatches: int = 1
    grad_compression: str = "none"    # "none" | "int8"
    aux_weight: float = 0.01


def named(params) -> dict:
    """{name: tensor} of a module's parameters, or a dict as it is."""
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)


def lr_schedule(tcfg: TrainConfig, step) -> torch.Tensor:
    """Linear warmup to the peak, then a cosine down to ``min_lr_fraction``
    of it: an f32 scalar on the host."""
    step = torch.as_tensor(step, dtype=_F32)
    warm = step / max(tcfg.warmup_steps, 1)
    t = torch.clamp((step - tcfg.warmup_steps) / max(tcfg.total_steps - tcfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = tcfg.min_lr_fraction + (1 - tcfg.min_lr_fraction) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return tcfg.learning_rate * torch.where(step < tcfg.warmup_steps, warm, cos)


def adamw_init(params) -> dict:
    ps = named(params)
    return {"mu": {n: torch.zeros_like(p, memory_format=torch.contiguous_format)
                   for n, p in ps.items()},
            "nu": {n: torch.zeros_like(p, memory_format=torch.contiguous_format)
                   for n, p in ps.items()},
            "step": torch.zeros((), dtype=torch.int32)}


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum over tensors of their f32 sums of squares."""
    sq = [torch.sum(g.float() ** 2) for g in tree.values()]
    return torch.sqrt(torch.stack(sq).sum() if sq else torch.zeros((), dtype=_F32))


@torch.no_grad()
def adamw_update(tcfg: TrainConfig, params, grads: dict, opt_state: dict):
    """One AdamW step. Returns (params, opt_state, metrics), parameters and
    moments updated in place."""
    ps = named(params)
    step = opt_state["step"] + 1
    lr = lr_schedule(tcfg, step)
    stepf = step.to(_F32)
    # the reference's f32 scalars, as host floats
    decay = float(1 - lr * tcfg.weight_decay)
    lr_f = float(lr)
    bc1 = float(1 - torch.tensor(tcfg.beta1, dtype=_F32) ** stepf)
    bc2 = float(1 - torch.tensor(tcfg.beta2, dtype=_F32) ** stepf)
    gnorm = global_norm(grads)
    scale = torch.clamp(tcfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    for name, p in ps.items():
        g = grads[name].float() * scale
        mu, nu = opt_state["mu"][name], opt_state["nu"][name]
        mu.mul_(tcfg.beta1).add_(g, alpha=1 - tcfg.beta1)
        nu.mul_(tcfg.beta2).add_((1 - tcfg.beta2) * g * g)
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + tcfg.eps)
        p.copy_((p.float() * decay - lr_f * delta).to(p.dtype))
    return params, {"mu": opt_state["mu"], "nu": opt_state["nu"], "step": step}, {
        "grad_norm": gnorm, "lr": lr}
