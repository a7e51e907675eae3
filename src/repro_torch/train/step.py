"""Serve-step factories: the port of ``make_prefill`` and ``make_serve_step``
of the JAX package's ``train/step.py``. ``make_train_step`` waits for the
training slice. PyTorch runs eagerly, so the factories return plain
functions where the reference returned functions to jit."""

from __future__ import annotations

import torch

from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig


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
