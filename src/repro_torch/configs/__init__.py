"""Architecture configs of the port. Importing this package populates the
registry (only chatglm3-6b is ported so far)."""
from repro_torch.configs.base import (REGISTRY, HadesConfig,  # noqa: F401
                                      ModelConfig, get_config, list_archs)
from repro_torch.configs import chatglm3_6b  # noqa: F401
