"""Minitron-4B [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000, pruned nemotron. [arXiv:2407.14679; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, d_ff=9216,
    vocab_size=256000, rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="minitron-smoke", family="dense",
    n_layers=2, d_model=48, n_heads=6, n_kv_heads=2, d_ff=96,
    vocab_size=512, q_chunk=16, attn_chunk=16, compute_dtype="float32",
)
