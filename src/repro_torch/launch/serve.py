"""Serving launcher: batched prefill + greedy decode on one card.

The port of the JAX package's ``launch/serve.py``. Requests are prompts of
uneven length; the scheduler right-pads them into one prefill batch, runs
prefill, then decodes greedily until every sequence emits EOS or hits
``max_new_tokens``. Finished sequences keep decoding dead tokens until the
batch drains (static shapes). One card holds the model whole, so there is
no mesh and no sharding. On the card, prefill and decode attention run the
hand-written CUDA kernels (``kernels/csrc/flash_prefill.cu``,
``kernels/csrc/chunked_attention.cu``), and the experts of an MoE model
run the grouped-GEMM kernel (``kernels/csrc/grouped_matmul.cu``).

    python -m repro_torch.launch.serve --arch llama3.2-1b
    python -m repro_torch.launch.serve --arch olmoe-1b-7b
    python -m repro_torch.launch.serve --arch olmoe-1b-7b --smoke --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import transformer as tf
from repro_torch.sparse.csr import resolve_device
from repro_torch.train.step import make_prefill, make_serve_step


@dataclasses.dataclass
class ServeStats:
    prompts: int = 0
    generated_tokens: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.generated_tokens / self.decode_s if self.decode_s else 0.0


def serve_batch(cfg, prompts: list, *, max_new_tokens: int = 16,
                cache_len: int = 256, eos_id: int | None = None,
                pad_id: int = 0, params: tf.Transformer | None = None,
                seed: int = 0, device="cuda") -> tuple:
    """Generate greedily for a batch of token-id prompts. Returns
    (list of generated id lists, ServeStats).

    ``params`` is the port's :class:`~repro_torch.models.transformer.Transformer`
    on ``device``; when None, one is drawn by ``init_params`` from a generator
    seeded ``seed``. ``device`` is the card unless ``"cpu"`` is asked for;
    without a card that raises.

    Prompts are right-padded with ``pad_id`` to the longest prompt's length;
    the true lengths are threaded into prefill so each sequence's first
    generated token is predicted from its own last real token, never from
    padding. ``eos_id`` is opt-in (default: no early stop). The padded prompt
    and the generated tokens must fit ``cache_len`` (the reference drops the
    cache writes past its end instead).

    Known limitation (the reference's): the prefill cache still holds K/V for
    the pad positions of shorter prompts, and decode appends after the padded
    length, so tokens after the first can still attend to pads."""
    device = resolve_device(device)
    b = len(prompts)
    max_len = max(len(p) for p in prompts)
    if max_len + max_new_tokens - 1 > cache_len:
        raise ValueError(f"a padded prompt of {max_len} tokens and {max_new_tokens} new "
                         f"tokens do not fit cache_len={cache_len}")
    lengths = np.array([len(p) for p in prompts], np.int32)
    toks = np.full((b, max_len), pad_id, np.int32)
    for i, p in enumerate(prompts):
        toks[i, : len(p)] = p          # right-pad (static prefill shape)

    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = tf.init_params(cfg, gen, device)

    prefill_fn = make_prefill(cfg, cache_len)
    step_fn = make_serve_step(cfg)
    stats = ServeStats(prompts=b)

    with torch.inference_mode():
        batch = {"tokens": torch.from_numpy(toks).to(device),
                 "lengths": torch.from_numpy(lengths).to(device)}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        logits, cache = prefill_fn(params, batch)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        first = nxt[:, 0].tolist()     # waits for the device
        stats.prefill_s = time.perf_counter() - t0

        outs = [[t] for t in first]
        done = np.array([eos_id is not None and o[-1] == eos_id for o in outs])
        t0 = time.perf_counter()
        for _ in range(max_new_tokens - 1):
            nxt, cache = step_fn(params, cache, nxt)
            arr = nxt[:, 0].tolist()
            for i in range(b):
                if not done[i]:
                    outs[i].append(arr[i])
                    done[i] = eos_id is not None and arr[i] == eos_id
            if done.all():
                break
        stats.decode_s = time.perf_counter() - t0
    stats.generated_tokens = sum(len(o) for o in outs)
    return outs, stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size,
                            rng.integers(4, args.prompt_len)).tolist()
               for _ in range(args.batch)]
    outs, stats = serve_batch(cfg, prompts, max_new_tokens=args.max_new_tokens,
                              cache_len=args.cache_len, device=args.device)
    for i, o in enumerate(outs):
        print(f"[serve] seq {i}: {len(o)} tokens -> {o[:12]}...")
    print(f"[serve] prefill {stats.prefill_s*1e3:.0f}ms, "
          f"{stats.tokens_per_s:.1f} tok/s decode")


if __name__ == "__main__":
    main()
