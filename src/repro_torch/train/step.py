"""Step factories: the port of the JAX package's ``train/step.py``.

``make_train_step``: microbatch gradient accumulation, optional int8
gradient compression with error feedback, AdamW. The global batch is split
into ``tcfg.microbatches`` microbatches along its batch dim; their
gradients (``torch.autograd.grad`` of ``transformer.loss_fn``) are summed
in f32 and divided by their count, as the reference's scan does. The serve
factories ``make_prefill`` and ``make_serve_step`` run the serving path.
PyTorch runs eagerly, so the factories return plain functions where the
reference returned functions to jit.
"""

from __future__ import annotations

import torch

from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.train.compress import ef_init, roundtrip
from repro_torch.train.optim import TrainConfig, adamw_init, adamw_update, named


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), ``params`` a trainable ``Transformer`` updated in place;
    metrics ``loss`` (with the auxiliary term), ``grad_norm`` and ``lr``, as
    the reference's, and ``moe_aux`` (the MoE auxiliary, 0 for a dense
    model), averaged over the microbatches as the loss is.

    ``opt_state`` carries {"mu", "nu", "step"} (+ "ef" when compression is on)."""
    use_ef = tcfg.grad_compression == "int8"

    def grads_of(names, tensors, params, mb):
        loss, metrics = tf.loss_fn(params, mb, cfg, aux_weight=tcfg.aux_weight)
        grads = dict(zip(names, torch.autograd.grad(loss, tensors)))
        return loss.detach(), metrics["moe_aux"].detach(), grads

    def train_step(params, opt_state, batch):
        names, tensors = zip(*named(params).items())
        n_micro = tcfg.microbatches
        if n_micro == 1:
            loss, aux, grads = grads_of(names, tensors, params, batch)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % n_micro:
                raise ValueError(f"batch {b} does not split into {n_micro} microbatches")
            per = b // n_micro
            grads = {n: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                     for n, t in zip(names, tensors)}
            loss = aux = 0.0
            for i in range(n_micro):
                mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
                l, a, g = grads_of(names, tensors, params, mb)
                for n in names:
                    grads[n] += g[n].float()
                loss, aux = loss + l, aux + a
                del g
            grads = {n: g / n_micro for n, g in grads.items()}
            loss, aux = loss / n_micro, aux / n_micro

        if use_ef:
            grads, ef2 = roundtrip(grads, opt_state["ef"])
        params, opt2, om = adamw_update(
            tcfg, params, grads, {k: opt_state[k] for k in ("mu", "nu", "step")})
        if use_ef:
            opt2 = dict(opt2, ef=ef2)
        return params, opt2, {"loss": loss, **om, "moe_aux": aux}

    return train_step


def init_opt_state(cfg: ModelConfig, tcfg: TrainConfig, params) -> dict:
    del cfg   # uniform init(cfg, tcfg, params) signature; state is shaped by params
    state = adamw_init(params)
    if tcfg.grad_compression == "int8":
        state["ef"] = ef_init(named(params))
    return state


def make_prefill(cfg: ModelConfig, cache_len: int):
    def prefill_fn(params, batch):
        return tf.prefill(params, batch, cfg, cache_len)

    return prefill_fn


def make_serve_step(cfg: ModelConfig, greedy: bool = True):
    """serve_step(params, cache, tokens[B,1]) -> (next_tokens[B,1] int32, cache).

    One new token against the full KV cache, updated in place."""
    del greedy   # only greedy (argmax) decode exists; the flag is the serve API

    def serve_step(params, cache, tokens):
        logits, cache = tf.decode_step(params, cache, tokens, cfg)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt[:, None], cache

    return serve_step
