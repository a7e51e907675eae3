"""RWKV-6 (Finch) 3B [ssm] — 32L d_model=2560 attn-free d_ff=8960 vocab=65536,
data-dependent decay. [arXiv:2404.05892; hf]

Attention-free: O(1) decode state (per-head matrix states), which is why the
long_500k cell RUNS for this arch. Head size 64 -> 40 heads."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm", ssm_family="rwkv6",
    n_layers=32, d_model=2560, d_ff=8960, vocab_size=65536,
    ssm_head_dim=64,
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", family="ssm", ssm_family="rwkv6",
    n_layers=2, d_model=64, d_ff=128, vocab_size=256,
    ssm_head_dim=16, compute_dtype="float32",
)
