"""falcon-mamba-7b [ssm] — 64L d_model=4096 (attention-free) vocab=65024,
ssm_state=16 — mamba1 architecture. [arXiv:2410.05355; unverified]

Attention-free: HADES KV-cache tiering is inapplicable:
the recurrent state is a single always-hot object. HADES still manages the
embedding table for this arch.
"""
from repro_torch.configs.base import HadesConfig, MAMBA1, ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b", family="ssm",
        num_layers=64, d_model=4096, num_heads=1, num_kv_heads=1,
        d_ff=0, vocab_size=65024, head_dim=64,
        rope_style="none",
        block_pattern=(MAMBA1,) * 64,
        ssm_state_dim=16, ssm_conv_dim=4, ssm_expand=2,
        hades=HadesConfig(embed_hot_rows=4096),
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b-smoke", family="ssm",
        num_layers=2, d_model=64, num_heads=1, num_kv_heads=1,
        d_ff=0, vocab_size=256, head_dim=16,
        rope_style="none",
        block_pattern=(MAMBA1,) * 2,
        ssm_state_dim=8, ssm_conv_dim=4, ssm_expand=2,
        hades=HadesConfig(kv_block_tokens=4, superblock_slots=4,
                          embed_hot_rows=32),
    )


register("falcon-mamba-7b", full, reduced)
