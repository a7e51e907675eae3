"""Deterministic synthetic LM data pipeline.

The port of the JAX package's ``data/pipeline.py``: a structured
pseudo-text stream (a Zipf unigram mixture with short-range repetition, so
models have something learnable) from a counter-based PRNG. Batch ``i`` is
reproducible from ``(seed, i)`` alone, which makes checkpoint-resume exactly
replayable: the restored step index fully determines the remaining stream.
The NumPy draws are the reference's, so its batches are equal value for
value. The frontend configs' embedding batches are not ported (the port's
forward has no frontend either).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.sparse.csr import resolve_device


@dataclasses.dataclass
class SyntheticLM:
    cfg: ModelConfig
    batch_size: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.3
    repeat_p: float = 0.3

    def __post_init__(self):
        if self.cfg.frontend != "none":
            raise NotImplementedError(
                f"{self.cfg.name}: frontend {self.cfg.frontend!r} batches (embeddings) are "
                "not ported to repro_torch; see ROADMAP.md Queue 1 item 9c")

    def batch(self, index: int) -> dict:
        """Batch ``index`` as NumPy arrays (stateless: any index at any time)."""
        rng = np.random.default_rng((self.seed, index))
        v = self.cfg.vocab_size
        b, s = self.batch_size, self.seq_len
        base = rng.zipf(self.zipf_a, size=(b, s + 1)) % v
        # short-range repetition: with prob repeat_p, copy the token 2 back
        rep = rng.random((b, s + 1)) < self.repeat_p
        toks = base.copy()
        toks[:, 2:] = np.where(rep[:, 2:], toks[:, :-2], toks[:, 2:])
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :s], "labels": toks[:, 1 : s + 1]}


def make_batch_iterator(cfg: ModelConfig, batch_size: int, seq_len: int, seed: int = 0,
                        start_index: int = 0, device=None):
    """Infinite iterator of ``(index, batch)`` from ``start_index``, the
    batch's tensors on the card unless ``device`` says otherwise."""
    device = resolve_device(device)
    src = SyntheticLM(cfg, batch_size, seq_len, seed)
    i = start_index
    while True:
        yield i, {k: torch.from_numpy(v).to(device) for k, v in src.batch(i).items()}
        i += 1
