"""gemma3-27b [dense] — 5:1 local:global sliding-window pattern, 128k.

62L d_model=5376 32H (kv=16) d_ff=21504 vocab=262144
[hf:google/gemma-3-1b-pt]  Local layers: 1024-token sliding window,
theta=10k; global layers: full attention, theta=1M.  Tied embeddings
with sqrt(d) input scaling.
The same values as ``repro.configs.gemma3_27b``.
"""

from repro_torch.configs.base import ModelConfig, register_config

register_config(
    ModelConfig(
        name="gemma3-27b",
        family="dense",
        n_layers=62,
        d_model=5376,
        n_heads=32,
        n_kv_heads=16,
        d_ff=21504,
        vocab=262144,
        head_dim=128,
        sliding_window=1024,
        layer_pattern="LLLLLG",
        rope_theta=10_000.0,
        rope_theta_global=1_000_000.0,
        tie_embeddings=True,
        mlp_activation="geglu",
        source="hf:google/gemma-3-1b-pt",
    )
)
