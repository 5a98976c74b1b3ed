"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (kv=32) d_ff=10240
vocab=32000, ssm_state=64 — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; hf]

Block pattern: every 6th block is the SHARED attention block (tied params
across occurrences, as in the published architecture); the rest are Mamba2.
"""
from repro_torch.configs.base import (HadesConfig, MAMBA2, ModelConfig,
                                      SHARED_ATTN, register)


def _pattern(n_layers: int, every: int):
    return tuple(SHARED_ATTN if (i + 1) % every == 0 else MAMBA2
                 for i in range(n_layers))


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid",
        num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
        d_ff=10240, vocab_size=32000, head_dim=80,
        block_pattern=_pattern(54, 6), shared_attn_every=6,
        ssm_state_dim=64, ssm_conv_dim=4, ssm_expand=2,
        hades=HadesConfig(embed_hot_rows=4096),
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b-smoke", family="hybrid",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256, head_dim=16,
        block_pattern=_pattern(4, 2), shared_attn_every=2,
        ssm_state_dim=16, ssm_conv_dim=4, ssm_expand=2,
        hades=HadesConfig(kv_block_tokens=4, superblock_slots=4,
                          embed_hot_rows=32),
    )


register("zamba2-2.7b", full, reduced)
