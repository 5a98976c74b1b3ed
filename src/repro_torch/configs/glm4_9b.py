"""glm4-9b [dense] — 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552 — RoPE, GQA. [hf:THUDM/glm-4-9b; hf]
"""
from repro_torch.configs.base import HadesConfig, ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b", family="dense",
        num_layers=40, d_model=4096, num_heads=32, num_kv_heads=2,
        d_ff=13696, vocab_size=151552, head_dim=128,
        rope_theta=10000.0,
        hades=HadesConfig(embed_hot_rows=8192),
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
        hades=HadesConfig(kv_block_tokens=4, superblock_slots=4,
                          embed_hot_rows=32),
    )


register("glm4-9b", full, reduced)
