"""stablelm-3b [dense] — partial RoPE, MHA.

32L d_model=2560 32H (kv=32) d_ff=6912 vocab=50304
[hf:stabilityai/stablelm-2-1_6b]  LayerNorm + GeLU MLP + 25% rotary, per
the StableLM-2 card.  The same values as ``repro.configs.stablelm_3b``.
"""

from repro_torch.configs.base import ModelConfig, register_config

register_config(
    ModelConfig(
        name="stablelm-3b",
        family="dense",
        n_layers=32,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=6912,
        vocab=50304,
        rope_fraction=0.25,
        norm="layernorm",
        mlp_activation="gelu",
        source="hf:stabilityai/stablelm-2-1_6b",
    )
)
