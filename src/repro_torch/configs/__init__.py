"""Architecture configs of the port (this slice: stablelm-3b).

``get_config(name)`` returns the full configuration;
``get_config(name, reduced=True)`` the smoke-test variant (2 layers,
d_model <= 256) of the same family, as in ``repro.configs``.
"""

from repro_torch.configs.base import (
    ModelConfig,
    MoEConfig,
    SSMConfig,
    get_config,
    list_configs,
    register_config,
)

__all__ = [
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "get_config",
    "list_configs",
    "register_config",
]
