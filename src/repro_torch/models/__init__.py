"""repro_torch.models — the decoder LM stack of the JAX package, in PyTorch.

Ported: all four families without a frontend, for serving and training
(``config``, ``layers``, ``attention``, ``moe``, ``rwkv6``, ``mamba2``,
``transformer``, and ``convert``, which carries the JAX package's weights
across). The frontends are queued in ROADMAP.md.
"""
