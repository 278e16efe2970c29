"""glm4-9b [dense] — RoPE, GQA kv=2.

40L d_model=4096 32H (kv=2) d_ff=13696 vocab=151552  [hf:THUDM/glm-4-9b]
The same values as ``repro.configs.glm4_9b``.
"""

from repro_torch.configs.base import ModelConfig, register_config

register_config(
    ModelConfig(
        name="glm4-9b",
        family="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=2,
        d_ff=13696,
        vocab=151552,
        rope_fraction=0.5,          # GLM uses partial (2D) rotary
        mlp_activation="swiglu",
        source="hf:THUDM/glm-4-9b",
    )
)
