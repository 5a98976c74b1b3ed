"""olmoe-1b-7b [moe] — 16L d_model=2048 16H (GQA kv=16) per-expert
d_ff=1024 vocab=50304, MoE 64 experts top-8. [arXiv:2409.02060; hf]
"""
from repro_torch.configs.base import HadesConfig, ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", family="moe",
        num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=1024, vocab_size=50304, head_dim=128,
        rope_theta=10000.0,
        num_experts=64, experts_per_token=8, moe_d_ff=1024,
        hades=HadesConfig(embed_hot_rows=4096),
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=32, vocab_size=256, head_dim=16,
        num_experts=8, experts_per_token=2, moe_d_ff=32,
        hades=HadesConfig(kv_block_tokens=4, superblock_slots=4,
                          embed_hot_rows=32),
    )


register("olmoe-1b-7b", full, reduced)
