"""internvl2-1b [vlm] — InternViT + InternLM2; the LM backbone.

24L d_model=896 14H (kv=2) d_ff=4864 vocab=151655  [arXiv:2404.16821]
The vision tower and its projector are not modelled: 256 precomputed
patch embeddings at d_model are prepended to the text tokens, and the
loss is masked to the text positions.  The same values as
``repro.configs.internvl2_1b``.
"""

from repro_torch.configs.base import ModelConfig, register_config

register_config(
    ModelConfig(
        name="internvl2-1b",
        family="vlm",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        d_ff=4864,
        vocab=151655,
        head_dim=64,
        input_mode="vlm",
        n_patches=256,
        mlp_activation="swiglu",
        source="arXiv:2404.16821",
    )
)
