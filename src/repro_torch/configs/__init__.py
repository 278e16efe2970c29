"""Architecture configs of the port (stablelm-3b, hymba-1.5b, xlstm-125m,
glm4-9b, qwen3-14b, gemma3-27b, dbrx-132b, deepseek-v3-671b, musicgen-large
and internvl2-1b) and the reference's named input shapes.

``get_config(name)`` returns the full configuration;
``get_config(name, reduced=True)`` the smoke-test variant (2 layers,
d_model <= 256) of the same family, as in ``repro.configs``.
"""

from repro_torch.configs.base import (
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    get_config,
    list_configs,
    register_config,
)

__all__ = [
    "INPUT_SHAPES",
    "InputShape",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "get_config",
    "list_configs",
    "register_config",
]
