"""Unified model configuration covering every assigned architecture family.

A copy of the JAX package's ``models/config.py`` (plain data, no JAX), with
the settings of the port's own architectures as fields at the end.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """YaRN's rotary scaling (``rope_scaling`` of type "yarn" in a model's
    config.json): frequencies blended between interpolated (over ``factor``)
    and extrapolated across the correction range that ``beta_fast`` and
    ``beta_slow`` rotations give at ``original_max_position_embeddings``."""

    factor: float
    original_max_position_embeddings: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None  # defaults to d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 1e4
    tie_embeddings: bool = False

    # -- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 2
    expert_d_ff: int = 0          # per-expert hidden (arctic: 4864)
    moe_dense_residual: bool = False  # arctic's parallel dense MLP
    capacity_factor: float = 1.25

    # -- SSM / RWKV ----------------------------------------------------------
    ssm_state: int = 0            # mamba2 state dim per head
    ssm_head_dim: int = 64
    ssm_chunk: int = 64           # chunked-scan block length
    chunk_dtype: str = "float32"  # intra-chunk decay/score tensor dtype

    # -- hybrid (zamba2) -----------------------------------------------------
    attn_every: int = 0           # shared attention block period

    # -- modality stubs (vlm / audio) ----------------------------------------
    frontend_len: int = 0         # patches / frames in train shapes
    encoder_layers: int = 0       # whisper encoder depth
    max_target_len: int = 0       # whisper decoder train length

    # -- numerics / systems ---------------------------------------------------
    dtype: str = "bfloat16"
    remat: bool = True
    use_pruned_frontend: bool = False  # the paper's technique on continuous inputs
    frontend_adc_bits: int = 4
    vocab_pad_multiple: int = 256
    attention_impl: str = "auto"  # auto | plain | flash | pallas (TPU)
    flash_p_dtype: str = "float32"  # flash-attention probability dtype
    flash_block_k: int = 2048       # flash-attention KV block length (§Perf C3)

    # -- settings only the port's own architectures change -------------------
    # a configuration the JAX package also has holds these defaults, which are
    # its semantics
    rms_norm_eps: float = 1e-6
    # sliding-window attention (0: none); layer i is global where
    # window_pattern[i % len] == "G", and with a window global layers take
    # no RoPE (EXAONE 4.0's rule)
    window: int = 0
    window_pattern: str = "L"
    post_norm: bool = False         # ln1 / ln2 norm the attention / MLP outputs
    first_dense_layers: int = 0     # MoE family: leading layers with a dense SwiGLU of d_ff
    # the dropless, sigmoid-routed expert layer of one card of an
    # expert-parallel pool: the router scores all n_experts, this card
    # computes experts [0, experts_held) for every token routed to them (0:
    # all experts, by the capacity dispatch)
    experts_held: int = 0
    routed_scale: float = 1.0       # the routed experts' weights, times this
    n_shared_experts: int = 0       # always-on experts of expert_d_ff each
    # group-limited routing (DeepSeek-V3's noaux_tc): the experts in n_group
    # groups, the top-k chosen from the topk_group groups whose two best
    # biased scores sum highest (1, 1: no limit)
    n_group: int = 1
    topk_group: int = 1
    # multi-head latent attention (DeepSeek-V2/V3; kv_lora_rank 0: none): q
    # through a rank-q_lora_rank bottleneck, k and v from a cached latent of
    # kv_lora_rank values and one shared rotary key of qk_rope_head_dim; a
    # head's q/k take qk_nope_head_dim + qk_rope_head_dim, its v v_head_dim
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    rope_scaling: RopeScaling | None = None  # YaRN (None: plain RoPE)

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def qk_head_dim(self) -> int:
        """A head's q/k width: MLA's nope + rope dims, else ``hd``."""
        return self.qk_nope_head_dim + self.qk_rope_head_dim if self.kv_lora_rank else self.hd

    @property
    def rope_dim(self) -> int:
        """The rotated width of a head: MLA's rope dims, else ``hd``."""
        return self.qk_rope_head_dim if self.kv_lora_rank else self.hd

    def windowed(self, i: int) -> bool:
        """Whether layer ``i`` attends through the sliding window."""
        p = self.window_pattern
        return self.window > 0 and p[i % len(p)] != "G"

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """long_500k runs only for sub-quadratic (SSM/hybrid) families."""
        return self.family in ("ssm", "hybrid")


def n_params(cfg: ModelConfig) -> int:
    """Analytic parameter count (for MODEL_FLOPS = 6*N*D roofline term)."""
    d, hd = cfg.d_model, cfg.hd
    q = d * cfg.n_heads * hd
    kv = 2 * d * cfg.n_kv_heads * hd
    o = cfg.n_heads * hd * d
    attn = q + kv + o
    dense_mlp = 3 * d * cfg.d_ff
    per_layer = 0
    if cfg.family in ("dense", "vlm"):
        per_layer = attn + dense_mlp
    elif cfg.family == "moe":
        moe = cfg.n_experts * 3 * d * (cfg.expert_d_ff or cfg.d_ff)
        per_layer = attn + moe + (dense_mlp if cfg.moe_dense_residual else 0)
    elif cfg.family == "ssm":  # rwkv6
        per_layer = 5 * d * d + 3 * d * cfg.d_ff  # r,k,v,g,o + channel-mix
    elif cfg.family == "hybrid":
        dim_in = 2 * d + 2 * cfg.n_heads * cfg.ssm_state + cfg.n_heads
        per_layer = d * dim_in + d * d + 3 * d * cfg.d_ff // 2
    elif cfg.family == "audio":
        per_layer = attn + dense_mlp  # decoder; encoder added below
    emb = cfg.padded_vocab * d * (1 if cfg.tie_embeddings else 2)
    total = cfg.n_layers * per_layer + emb
    if cfg.family == "audio":
        total += cfg.encoder_layers * (attn + dense_mlp)  # encoder stack
        total += cfg.n_layers * (attn)  # decoder cross-attention
    if cfg.family == "hybrid" and cfg.attn_every:
        total += attn  # one shared attention block
    return int(total)


def n_active_params(cfg: ModelConfig) -> int:
    """Active params per token (MoE: top_k of n_experts)."""
    if cfg.family != "moe":
        return n_params(cfg)
    d = cfg.d_model
    moe_all = cfg.n_layers * cfg.n_experts * 3 * d * (cfg.expert_d_ff or cfg.d_ff)
    moe_active = cfg.n_layers * cfg.top_k * 3 * d * (cfg.expert_d_ff or cfg.d_ff)
    return n_params(cfg) - moe_all + moe_active
