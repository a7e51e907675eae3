"""Model configuration: one dataclass covering the ten architectures of the
JAX package, field for field.

The port of the JAX package's ``models/config.py`` (which imports nothing of
JAX; the port keeps its own copy). The sharding and training levers
(``shard_activations``, ``dp_axes``, ``tp_axis``, ``precast_params``,
``cast_free_attention``, ``remat``, ``remat_policy``) are carried as data so
that a config compares equal to the reference's; the serving path reads none
of them.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # "dense" | "moe" | "ssm" | "hybrid"
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    n_heads: int = 0            # 0 for attention-free families
    n_kv_heads: int = 0
    head_dim: int = 0           # 0 -> d_model // n_heads

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # attention flavor
    sliding_window: int = 0     # 0 = full causal attention
    rope_theta: float = 500000.0

    # SSM / hybrid
    ssm_family: str = ""        # "rwkv6" | "mamba2"
    ssm_state: int = 0          # N (state dim per head) for mamba2
    ssm_head_dim: int = 64      # P for mamba2 / head size for rwkv6
    attn_every: int = 0         # hybrid: shared attention block every N layers

    # modality frontend ("none" | "vision_stub" | "audio_stub")
    frontend: str = "none"

    # numerics / implementation knobs
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    attn_chunk: int = 1024      # kv-chunk of the plain flash attention (0 = full)
    q_chunk: int = 1024         # q-chunk of the plain flash attention
    remat: bool = True
    logit_softcap: float = 0.0

    # sharding and training levers of the reference, carried as data only
    shard_activations: bool = False
    dp_axes: tuple = ()
    tp_axis: str = ""
    precast_params: bool = False
    cast_free_attention: bool = False
    remat_policy: str = "full"

    def __post_init__(self):
        if self.n_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads and not self.n_kv_heads:
            object.__setattr__(self, "n_kv_heads", self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def has_attention(self) -> bool:
        return self.n_heads > 0 and self.family != "ssm"

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def param_count(self) -> int:
        """Approximate parameter count N (for 6ND model-flops accounting),
        with an untied output head."""
        d, ff, v, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        n = 2 * v * d   # embedding and the untied output head
        per_layer = 0
        if self.family in ("dense", "moe"):
            hd = self.head_dim
            per_layer += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                + self.n_heads * hd * d  # q, k, v, o
            if self.is_moe:
                per_layer += d * self.n_experts  # router
                per_layer += self.n_experts * 3 * d * ff  # w1, w3, w2 per expert
            else:
                per_layer += 3 * d * ff
            per_layer += 2 * d  # norms
        elif self.family == "ssm" and self.ssm_family == "rwkv6":
            per_layer += 6 * d * d        # r,k,v,g,o,w projections (approx)
            per_layer += 3 * d * ff // 2  # channel mix (k, v, r)
            per_layer += 2 * d
        elif self.family == "hybrid":
            # mamba2 blocks on every layer + one shared attention block
            p, ns = self.ssm_head_dim, self.ssm_state
            nh = d // p
            per_layer += 2 * d * 2 * d            # in_proj (x, z)
            per_layer += d * (2 * ns + nh)        # B, C, dt projections
            per_layer += 2 * d * d                # out_proj approx + conv
            per_layer += 3 * d * ff               # MLP
            per_layer += 2 * d
        n += L * per_layer
        if self.family == "hybrid" and self.attn_every:
            hd = self.head_dim
            n += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                + self.n_heads * hd * d  # the single shared attn block
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.param_count()
        d, ff, L = self.d_model, self.d_ff, self.n_layers
        total = self.param_count()
        moe_all = L * self.n_experts * 3 * d * ff
        moe_active = L * self.top_k * 3 * d * ff
        return total - moe_all + moe_active
