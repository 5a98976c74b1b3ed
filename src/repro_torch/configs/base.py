"""Configuration system of the port (a copy of `repro.configs.base`).

A single frozen dataclass (`ModelConfig`) describes every assigned
architecture family: dense decoder-only, GQA/MQA, sliding-window attention,
MoE, encoder-decoder, VLM backbone, SSM (mamba1/mamba2) and hybrids.

The port keeps its own copy of the dataclasses so that it imports nothing
of the JAX package; the fields and defaults are the same, so a config
built here describes the same model as its JAX counterpart. Configs are
registered by id in `REGISTRY`; `get_config(arch_id)` returns the full
published config, `get_config(arch_id, reduced=True)` a CPU-test-sized
config of the same family.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

# ---------------------------------------------------------------------------
# Block kinds — a model is a sequence of blocks; dense transformers repeat one
# kind, hybrids (zamba2) interleave kinds.
# ---------------------------------------------------------------------------
ATTN = "attn"          # full (or windowed) self-attention + MLP/MoE
MAMBA1 = "mamba1"      # mamba-1 selective SSM block
MAMBA2 = "mamba2"      # mamba-2 (SSD) block
SHARED_ATTN = "shared_attn"  # zamba2's shared attention block (tied params)


@dataclasses.dataclass(frozen=True)
class HadesConfig:
    """Frontend (paper technique) configuration."""
    enabled: bool = True
    # object granularity: KV blocks of this many tokens
    kv_block_tokens: int = 16
    # superblock = contiguous run of this many slots (the "huge page" unit)
    superblock_slots: int = 64
    # collector cadence (collector runs every N serve/train steps)
    collect_every: int = 8
    # CIW demotion threshold C_t (initial; adapted by MIAD)
    ciw_threshold: int = 3
    ciw_min: int = 1
    ciw_max: int = 16
    # MIAD: promotion-rate target and control gains
    promotion_target: float = 0.01
    miad_mult: float = 2.0        # multiplicative increase of C_t
    miad_add: int = 1             # additive decrease of C_t
    # fraction of pool slots reserved for the NEW heap
    new_frac: float = 0.125
    # tiering backend: any name registered in `core.backend`
    # ("reactive" / "proactive" / "cap" / "null" / "mglru" / "promote",
    # see backend.names()); runtimes build it via backend.make(name),
    # which rejects typos at construction time
    backend: str = "reactive"
    # hot-tier capacity as a fraction of total pool (cap backend analog)
    hot_capacity_frac: float = 0.5
    # embedding tiering: number of hot rows kept in HBM (0 = disabled)
    embed_hot_rows: int = 0
    # int8-quantize cold-tier KV (beyond-paper optimization, off by default
    # so the paper-faithful baseline stays bit-exact)
    cold_quantize: bool = False
    # --- §Perf hillclimb variants (beyond-paper, off by default) ---
    # decode-time MoE: gather only the routed experts' weights (the HADES
    # hot-expert principle applied to the weight stream)
    expert_gather_decode: bool = False
    # KV cache store precision for decode (16 = bf16 baseline; 8 = int8
    # + per-block scales, halving the dominant decode HBM term)
    kv_quant_bits: int = 16


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # moe | dense | audio | vlm | hybrid | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    # --- attention flavour ---
    sliding_window: int = 0          # 0 = full attention; >0 = SWA window
    rope_theta: float = 10000.0
    rope_style: str = "rope"         # rope | mrope | rope2d | none
    attn_logit_softcap: float = 0.0
    # --- FFN ---
    mlp_gated: bool = True           # SwiGLU (3 mats) vs GELU MLP (2 mats)
    # --- MoE ---
    num_experts: int = 0             # 0 = dense FFN
    experts_per_token: int = 0
    moe_d_ff: int = 0                # expert hidden dim (olmoe: 1024)
    # --- encoder-decoder ---
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq_len: int = 0         # frame/patch count from stub frontend
    # --- SSM / hybrid ---
    block_pattern: Tuple[str, ...] = ()   # per-layer block kinds; () = all ATTN
    ssm_state_dim: int = 0
    ssm_conv_dim: int = 4
    ssm_expand: int = 2
    shared_attn_every: int = 0       # zamba2: shared attn block period
    # --- modality frontend stub ---
    frontend: str = "none"           # none | audio | vision
    # --- norm / misc ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # --- paper technique ---
    hades: HadesConfig = dataclasses.field(default_factory=HadesConfig)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def blocks(self) -> Tuple[str, ...]:
        if self.block_pattern:
            return self.block_pattern
        return (ATTN,) * self.num_layers

    @property
    def is_attention_free(self) -> bool:
        return all(b in (MAMBA1, MAMBA2) for b in self.blocks)

    @property
    def subquadratic(self) -> bool:
        """True if decode memory for attention state is o(seq) or windowed."""
        if self.is_attention_free:
            return True
        if self.family == "hybrid":
            return True
        return self.sliding_window > 0

    def param_count(self) -> int:
        """Approximate parameter count (used for roofline MODEL_FLOPS)."""
        d, h = self.d_model, self.resolved_head_dim
        n_q = self.num_heads * h
        n_kv = self.num_kv_heads * h
        total = 0
        for kind in self.blocks:
            if kind in (ATTN, SHARED_ATTN):
                n_ff_mats = 3 if self.mlp_gated else 2
                attn = d * n_q + 2 * d * n_kv + n_q * d
                if self.num_experts:
                    ff = n_ff_mats * d * (self.moe_d_ff or self.d_ff) * self.num_experts
                    ff += d * self.num_experts  # router
                else:
                    ff = n_ff_mats * d * self.d_ff
                total += attn + ff + 2 * d
            else:  # mamba block
                d_in = d * self.ssm_expand
                n = self.ssm_state_dim
                # in_proj (x,z), conv, dt/B/C proj, out_proj
                total += d * 2 * d_in + d_in * self.ssm_conv_dim
                total += d_in * (n * 2 + 1) + d_in * d + 2 * d
        if self.is_encoder_decoder:
            # encoder self-attn+ff and decoder cross-attn
            enc = self.num_encoder_layers * (
                2 * (d * n_q + 2 * d * n_kv + n_q * d) // 2 + 3 * d * self.d_ff + 2 * d
            )
            cross = self.num_layers * (d * n_q + 2 * d * n_kv + n_q * d)
            total += enc + cross
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.num_experts:
            return self.param_count()
        d = self.d_model
        eff = self.moe_d_ff or self.d_ff
        n_ff_mats = 3 if self.mlp_gated else 2
        inactive = n_ff_mats * d * eff * (self.num_experts - self.experts_per_token)
        n_moe_layers = sum(1 for k in self.blocks if k in (ATTN, SHARED_ATTN))
        return self.param_count() - inactive * n_moe_layers


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
REDUCED_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(arch_id: str, full: Callable[[], ModelConfig],
             reduced: Callable[[], ModelConfig]) -> None:
    REGISTRY[arch_id] = full
    REDUCED_REGISTRY[arch_id] = reduced


def get_config(arch_id: str, reduced: bool = False) -> ModelConfig:
    # importing the configs package populates the registry
    import repro_torch.configs  # noqa: F401
    reg = REDUCED_REGISTRY if reduced else REGISTRY
    if arch_id not in reg:
        raise KeyError(
            f"unknown arch {arch_id!r}; known: {sorted(REGISTRY)}")
    return reg[arch_id]()


def list_archs() -> Tuple[str, ...]:
    import repro_torch.configs  # noqa: F401
    return tuple(sorted(REGISTRY))
