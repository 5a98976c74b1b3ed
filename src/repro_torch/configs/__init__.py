"""Architecture configs of the port. Importing this package populates the
registry: the dense configs (chatglm3-6b, glm4-9b, granite-20b,
granite-34b), the MoE configs (olmoe-1b-7b, mixtral-8x7b), the ssm
config falcon-mamba-7b and the hybrid zamba2-2.7b."""
from repro_torch.configs.base import (REGISTRY, HadesConfig,  # noqa: F401
                                      ModelConfig, get_config, list_archs)
from repro_torch.configs import (  # noqa: F401
    chatglm3_6b, falcon_mamba_7b, glm4_9b, granite_20b, granite_34b,
    mixtral_8x7b, olmoe_1b_7b, zamba2_2_7b)
