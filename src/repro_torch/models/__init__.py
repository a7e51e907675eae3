"""repro_torch.models — the decoder LM stack of the JAX package, in PyTorch.

Ported so far: the dense and MoE families without a frontend, for serving
(``config``, ``layers``, ``attention``, ``moe``, ``transformer``, and
``convert``, which carries the JAX package's weights across). The SSM and
hybrid families, the frontends and the training path are queued in
ROADMAP.md.
"""
