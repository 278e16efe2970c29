"""qwen3-14b [dense] — qk_norm, GQA.

40L d_model=5120 40H (kv=8) d_ff=17408 vocab=151936  [hf:Qwen/Qwen3-8B]
head_dim=128 (Qwen3 keeps 128 regardless of d_model/n_heads).
The same values as ``repro.configs.qwen3_14b``.
"""

from repro_torch.configs.base import ModelConfig, register_config

register_config(
    ModelConfig(
        name="qwen3-14b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=17408,
        vocab=151936,
        head_dim=128,
        qk_norm=True,
        rope_theta=1e6,
        mlp_activation="swiglu",
        source="hf:Qwen/Qwen3-8B",
    )
)
