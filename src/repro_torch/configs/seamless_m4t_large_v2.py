"""seamless-m4t-large-v2 [audio] — 24L d_model=1024 16H (kv=16) d_ff=8192
vocab=256206 — encoder-decoder, multimodal. Audio frontend is a STUB:
input_specs() provides precomputed frame embeddings. [arXiv:2308.11596; hf]
"""
from repro_torch.configs.base import HadesConfig, ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2", family="audio",
        num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
        d_ff=8192, vocab_size=256206, head_dim=64,
        rope_style="none",  # learned/sinusoidal positions in m4t; none for backbone
        is_encoder_decoder=True, num_encoder_layers=24,
        encoder_seq_len=1024, frontend="audio",
        hades=HadesConfig(embed_hot_rows=8192),  # 256k vocab: biggest embed win
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2-smoke", family="audio",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=512, head_dim=16,
        rope_style="none",
        is_encoder_decoder=True, num_encoder_layers=2,
        encoder_seq_len=16, frontend="audio",
        hades=HadesConfig(kv_block_tokens=4, superblock_slots=4,
                          embed_hot_rows=64),
    )


register("seamless-m4t-large-v2", full, reduced)
