"""chatglm3-6b [dense] — 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024 — 2d-RoPE, GQA. [arXiv:2406.12793; hf]
"""
from repro_torch.configs.base import HadesConfig, ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b", family="dense",
        num_layers=28, d_model=4096, num_heads=32, num_kv_heads=2,
        d_ff=13696, vocab_size=65024, head_dim=128,
        rope_style="rope2d", rope_theta=10000.0,
        hades=HadesConfig(embed_hot_rows=4096),
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
        rope_style="rope2d",
        hades=HadesConfig(kv_block_tokens=4, superblock_slots=4,
                          embed_hot_rows=32),
    )


register("chatglm3-6b", full, reduced)
