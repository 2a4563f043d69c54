"""Configuration dataclasses of the port: the model and the VFL protocol.

``ModelConfig`` describes one architecture's *global* model (client
embedding + server backbone) and ``reduced()`` its smoke-size variant;
``ShapeConfig`` one of the four input shapes; ``VFLConfig`` the party
plane (number of clients, optimization method per party, ZOO
hyper-parameters); ``TrainConfig`` the top-level launcher config. All are
copies of the JAX package's, field for field, so a run is configured
identically in both.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return int(math.ceil(x / m) * m)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity ---------------------------------------------------------
    arch_id: str = "unnamed"
    family: str = "dense"          # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""               # citation (arXiv / hf card)

    # transformer trunk -------------------------------------------------
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0              # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    act: str = "swiglu"            # swiglu | gelu | relu2
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    pos: str = "rope"              # rope | learned | none
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    attn_logit_softcap: float = 0.0
    qk_norm: bool = False

    # attention variants -------------------------------------------------
    causal: bool = True
    window_size: int = 0           # 0 = full attention; >0 = sliding window

    # MoE -----------------------------------------------------------------
    n_experts: int = 0             # 0 = dense MLP
    top_k: int = 0
    moe_d_ff: int = 0              # per-expert hidden size
    n_shared_experts: int = 0
    first_k_dense: int = 0         # leading dense layers (deepseek)
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    load_balance_coef: float = 0.01
    moe_groups: int = 16           # dispatch groups per row (= model-axis
                                   # size: local dispatch + all-to-all EP)

    # MLA (deepseek) ------------------------------------------------------
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    n_mtp: int = 0                 # multi-token-prediction depth

    # SSM / Mamba2 ---------------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128

    # RWKV6 -----------------------------------------------------------------
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 128

    # hybrid (zamba2) ---------------------------------------------------------
    attn_every: int = 0            # shared attention block period; 0 = never
    n_shared_blocks: int = 1

    # encoder-decoder (whisper) --------------------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 0           # precomputed frame count (stub frontend)

    # modality frontend stubs ------------------------------------------------
    n_vision_tokens: int = 0       # VLM: patch-embedding count per sample
    frontend_dim: int = 0          # stub embedding dim fed by input_specs()

    # numerics -----------------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"     # full | dots (save no-batch-dim matmul
                                   # outputs: backward skips re-gathers at
                                   # the cost of saved projections)
    scan_layers: bool = True       # False: unrolled (cost-model probes)
    seq_shard_acts: bool = True    # sequence-parallel residual boundaries
    # §Perf variants (baseline = False; see EXPERIMENTS.md §Perf)
    iota_embed: bool = False       # one-hot-matmul embedding lookup: avoids
                                   # GSPMD's involuntary full remat on the
                                   # vocab-sharded gather
    rs_outputs: bool = False       # constrain attn/mlp outputs to the
                                   # seq-sharded layout so GSPMD emits
                                   # reduce-scatter instead of all-reduce
    mla_absorb: bool = False       # MLA decode scores in latent space
                                   # (never expands the cache to per-head
                                   # k/v — S·H·(nd+vd) -> S·(r+rd) reads)

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        # pad so the vocab dim shards over the model axis (16) and lanes (128)
        return _round_up(self.vocab_size, 256)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_decode(self) -> bool:
        """True if a 500k-token decode is meaningful & sub-quadratic here."""
        if self.is_encoder_decoder:
            return False               # whisper skip (see DESIGN.md)
        return True                    # ssm/hybrid native; attention via SWA

    @property
    def n_ssm_heads(self) -> int:
        return (self.ssm_expand * self.d_model) // self.ssm_head_dim

    @property
    def n_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def param_count(self) -> int:
        """Analytic parameter count of the *global* model (approx, counts
        padded vocab). Used for roofline MODEL_FLOPS = 6·N·D."""
        d, L = self.d_model, self.n_layers
        hd = self.resolved_head_dim
        n = 0
        n += self.padded_vocab * d                     # embed
        if not self.tie_embeddings:
            n += self.padded_vocab * d                 # lm head
        if self.frontend_dim:
            n += self.frontend_dim * d                 # modality projector
        per_layer = 0
        if self.family == "ssm":                        # rwkv6
            per_layer += 4 * d * d + d * d // 2         # r,k,v,o + gates approx
            per_layer += 2 * d * self.d_ff              # channel mix
        else:
            if self.use_mla:
                per_layer += d * self.q_lora_rank
                per_layer += self.q_lora_rank * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                per_layer += d * (self.kv_lora_rank + self.qk_rope_dim)
                per_layer += self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                per_layer += self.n_heads * self.v_head_dim * d
            else:
                per_layer += d * self.n_heads * hd          # q
                per_layer += 2 * d * self.n_kv_heads * hd   # k,v
                per_layer += self.n_heads * hd * d          # o
            if self.n_experts:
                ff_mults = 3 if self.act == "swiglu" else 2
                per_layer += d * self.n_experts * self.moe_d_ff * ff_mults
                per_layer += d * self.n_experts             # router
                if self.n_shared_experts:
                    per_layer += d * self.n_shared_experts * self.moe_d_ff * ff_mults
            else:
                ff_mults = 3 if self.act == "swiglu" else 2
                per_layer += d * self.d_ff * ff_mults
        if self.family == "hybrid":                     # mamba2 layers
            d_in = self.ssm_expand * d
            per_layer = 2 * d * d_in + d_in * d + d_in * self.ssm_state * 2  # in/out proj + B,C
        n += per_layer * L
        if self.family == "hybrid" and self.attn_every:
            # shared attention+mlp block(s)
            shared = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
            shared += 3 * d * self.d_ff
            n += shared * self.n_shared_blocks
        if self.first_k_dense and self.n_experts:
            ff_mults = 3 if self.act == "swiglu" else 2
            n += self.first_k_dense * (d * self.d_ff * ff_mults - d * self.n_experts * self.moe_d_ff * ff_mults)
        if self.is_encoder_decoder:
            # encoder layers + decoder cross-attention
            enc = self.n_encoder_layers * (4 * d * d + 2 * d * self.d_ff)
            cross = L * (4 * d * d)
            n += enc + cross
        return int(n)

    def active_param_count(self) -> int:
        """Activated params per token (MoE-aware) for MODEL_FLOPS."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        ff_mults = 3 if self.act == "swiglu" else 2
        moe_layers = self.n_layers - self.first_k_dense
        all_experts = moe_layers * self.d_model * self.n_experts * self.moe_d_ff * ff_mults
        active = moe_layers * self.d_model * (self.top_k + self.n_shared_experts) * self.moe_d_ff * ff_mults
        return int(full - all_experts + active)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


INPUT_SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,   32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",  524_288,    1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class VFLConfig:
    """Party-plane configuration (the paper's protocol)."""
    n_clients: int = 1
    client_opt: str = "zoo"        # zoo | foo  (paper: zoo)
    server_opt: str = "foo"        # foo | zoo  (paper: foo; zoo-vfl: zoo)
    asynchronous: bool = True
    # ZOO hyper-parameters (paper §III-B, §VI-A)
    mu: float = 1e-3               # smoothing parameter μ
    zoo_dist: str = "sphere"       # sphere (φ=d) | normal (φ=1)
    zoo_queries: int = 1           # q-point averaging (beyond-paper)
    active_rows_only: bool = False # perturb only touched embedding rows
    # async simulation
    max_delay: int = 16            # τ bound (assumption IV.7)
    activation_probs: Optional[Tuple[float, ...]] = None  # p_m; None=uniform
    # learning rates (paper tunes server/client separately)
    lr_server: float = 0.01
    lr_client: float = 0.01
    # §Perf: the clean + q perturbed forwards run as ONE vmapped server
    # pass over stacked lanes (FSDP weight all-gathers happen once instead
    # of 1+q times; compile time constant in q). False selects the unrolled
    # per-query oracle — test-only numerical reference, never production.
    fused_dual: bool = True
    # test-only: route zoo_gradient through the original per-query Python
    # loop instead of the vectorized lane stack (oracle for equality tests)
    zoo_unrolled_oracle: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    vfl: VFLConfig = dataclasses.field(default_factory=VFLConfig)
    shape: ShapeConfig = dataclasses.field(default_factory=lambda: INPUT_SHAPES["train_4k"])
    optimizer: str = "sgd"         # paper uses vanilla SGD for all frameworks
    momentum: float = 0.0
    weight_decay: float = 0.0      # λ g(w) regularizer of Eq. 1
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    steps: int = 100
    log_every: int = 10
    seed: int = 0
    grad_clip: float = 0.0
    multi_pod: bool = False
    use_pallas: bool = False       # never read, as in the JAX package: the
                                   # port's models take the kernels on CUDA


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A smoke-test variant of the same family: 2 layers, d_model<=512,
    <=4 experts, tiny vocab — runs a real fwd/train step on CPU."""
    small = dict(
        n_layers=2,
        d_model=min(cfg.d_model, 128),
        n_heads=min(cfg.n_heads, 4),
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=32 if cfg.head_dim else 0,
        d_ff=min(cfg.d_ff, 256),
        vocab_size=min(cfg.vocab_size, 512),
    )
    if cfg.n_experts:
        small.update(n_experts=4, top_k=2, moe_d_ff=64,
                     n_shared_experts=min(cfg.n_shared_experts, 1),
                     first_k_dense=min(cfg.first_k_dense, 1),
                     moe_groups=4)
    if cfg.use_mla:
        small.update(q_lora_rank=32, kv_lora_rank=32, qk_nope_dim=16,
                     qk_rope_dim=16, v_head_dim=32, n_mtp=min(cfg.n_mtp, 1))
    if cfg.family in ("ssm", "hybrid"):
        small.update(ssm_state=min(cfg.ssm_state, 16) or 16,
                     ssm_head_dim=32, ssm_chunk=16, rwkv_head_dim=32,
                     rwkv_chunk=16)
    if cfg.attn_every:
        small.update(attn_every=2)
    if cfg.is_encoder_decoder:
        small.update(n_encoder_layers=2, encoder_seq=16)
    if cfg.n_vision_tokens:
        small.update(n_vision_tokens=4, frontend_dim=64)
    if cfg.frontend_dim and not cfg.n_vision_tokens:
        small.update(frontend_dim=64)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
