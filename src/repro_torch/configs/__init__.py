"""Architecture configs of the port. Importing this package populates the
registry: the dense configs (chatglm3-6b, glm4-9b, granite-20b,
granite-34b), the MoE configs (olmoe-1b-7b, mixtral-8x7b), the ssm
config falcon-mamba-7b, the hybrid zamba2-2.7b, the encoder-decoder
seamless-m4t-large-v2 and the VLM qwen2-vl-72b: the JAX registry's ten.
`shapes` holds the assigned input shapes."""
from repro_torch.configs.base import (REGISTRY, HadesConfig,  # noqa: F401
                                      ModelConfig, get_config, list_archs)
from repro_torch.configs import shapes  # noqa: F401
from repro_torch.configs import (  # noqa: F401
    chatglm3_6b, falcon_mamba_7b, glm4_9b, granite_20b, granite_34b,
    mixtral_8x7b, olmoe_1b_7b, qwen2_vl_72b, seamless_m4t_large_v2,
    zamba2_2_7b)
