"""granite-34b [dense] — 88L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152 — llama-arch, code. [arXiv:2405.04324; hf]
"""
from repro_torch.configs.base import HadesConfig, ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-34b", family="dense",
        num_layers=88, d_model=6144, num_heads=48, num_kv_heads=1,
        d_ff=24576, vocab_size=49152, head_dim=128,
        rope_theta=10000.0, mlp_gated=False,
        hades=HadesConfig(embed_hot_rows=4096),
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-34b-smoke", family="dense",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=1,
        d_ff=128, vocab_size=256, head_dim=16, mlp_gated=False,
        hades=HadesConfig(kv_block_tokens=4, superblock_slots=4,
                          embed_hot_rows=32),
    )


register("granite-34b", full, reduced)
