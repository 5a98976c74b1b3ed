"""Architecture configs of the port. Importing this package populates the
registry (chatglm3-6b and falcon-mamba-7b are ported so far)."""
from repro_torch.configs.base import (REGISTRY, HadesConfig,  # noqa: F401
                                      ModelConfig, get_config, list_archs)
from repro_torch.configs import chatglm3_6b, falcon_mamba_7b  # noqa: F401
