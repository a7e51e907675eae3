"""The PyTorch port's training path end to end: train a
~100M-parameter LM for a few hundred steps on the card.

A scaled-down llama-family config (~100M parameters) on the synthetic
pipeline, with checkpointing, microbatch accumulation and the straggler
watchdog: the port of ``examples/train_lm.py``.

  PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] [--d-model 512]
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 20 --d-model 128
"""

import argparse

import torch

from repro_torch.launch.train import train_loop
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer
from repro_torch.train.optim import TrainConfig


def lm_config(d_model: int = 512, layers: int = 8) -> ModelConfig:
    """The example's model: d_model / 64 heads, d_model / 256 KV heads,
    d_ff 4 d_model, a 32,768-token vocabulary, 128-token attention chunks."""
    return ModelConfig(
        name="lm100m", family="dense",
        n_layers=layers, d_model=d_model,
        n_heads=d_model // 64, n_kv_heads=max(d_model // 256, 1),
        d_ff=d_model * 4, vocab_size=32768,
        q_chunk=128, attn_chunk=128,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--grad-compression", choices=("none", "int8"), default="none")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (none by default)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = lm_config(args.d_model, args.layers)
    n = sum(p.numel() for p in Transformer(cfg, "meta", torch.float32).parameters())
    print(f"[train_lm] {cfg.name}: {n/1e6:.1f}M params, "
          f"{args.steps} steps of {args.batch_size}x{args.seq_len}")

    tcfg = TrainConfig(
        learning_rate=6e-4, warmup_steps=max(args.steps // 20, 5),
        total_steps=args.steps, microbatches=args.microbatches,
        grad_compression=args.grad_compression,
    )
    stats = train_loop(
        cfg, tcfg, device=args.device, batch_size=args.batch_size, seq_len=args.seq_len,
        steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=50, log_every=10)
    print(f"[train_lm] finished: {stats}")
    return stats


if __name__ == "__main__":
    main()
