"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]
"""
from repro_torch.configs.base import HadesConfig, ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", family="moe",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=14336, vocab_size=32000, head_dim=128,
        sliding_window=4096, rope_theta=1e6,
        num_experts=8, experts_per_token=2, moe_d_ff=14336,
        hades=HadesConfig(embed_hot_rows=4096),
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
        sliding_window=32, rope_theta=1e6,
        num_experts=4, experts_per_token=2, moe_d_ff=128,
        hades=HadesConfig(kv_block_tokens=4, superblock_slots=4,
                          embed_hot_rows=32),
    )


register("mixtral-8x7b", full, reduced)
