"""qwen2-vl-72b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE, dynamic resolution. Vision frontend is a STUB:
input_specs() provides precomputed patch embeddings. [arXiv:2409.12191; hf]
"""
from repro_torch.configs.base import HadesConfig, ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b", family="vlm",
        num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=29568, vocab_size=152064, head_dim=128,
        rope_style="mrope", rope_theta=1e6,
        frontend="vision",
        hades=HadesConfig(embed_hot_rows=8192),
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b-smoke", family="vlm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
        rope_style="mrope",
        frontend="vision",
        hades=HadesConfig(kv_block_tokens=4, superblock_slots=4,
                          embed_hot_rows=32),
    )


register("qwen2-vl-72b", full, reduced)
