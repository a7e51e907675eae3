"""StarCoder2-7B [dense] — 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152, GQA + RoPE. [arXiv:2402.19173; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, d_ff=18432,
    vocab_size=49152, rope_theta=100000.0,
)

SMOKE = ModelConfig(
    name="starcoder2-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=4, d_ff=192,
    vocab_size=256, q_chunk=16, attn_chunk=16, compute_dtype="float32",
)
