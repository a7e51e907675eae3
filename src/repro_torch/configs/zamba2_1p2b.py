"""Zamba2-1.2B [hybrid] — 38L d_model=2048 32H (GQA kv=32) d_ff=8192
ssm_state=64, Mamba2 blocks + shared attention blocks. [arXiv:2411.15242; hf]

The shared transformer block (one weight set) runs every 6 Mamba2 layers.
Decode state is O(1) per mamba layer + O(S) KV only at the 6 shared-attn sites,
keeping long_500k decode linear — the cell RUNS."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid", ssm_family="mamba2",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=32000, ssm_state=64, ssm_head_dim=64, attn_every=6,
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid", ssm_family="mamba2",
    n_layers=4, d_model=64, n_heads=8, n_kv_heads=8, d_ff=128,
    vocab_size=256, ssm_state=8, ssm_head_dim=16, attn_every=2,
    q_chunk=16, attn_chunk=16, compute_dtype="float32",
)
