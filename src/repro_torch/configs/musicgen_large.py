"""musicgen-large [audio] — decoder-only over EnCodec tokens.

48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048  [arXiv:2306.05284]
The EnCodec frontend is not modelled: the inputs are precomputed frame
embeddings at d_model, and the decoder predicts EnCodec codes (vocab
2048).  The same values as ``repro.configs.musicgen_large``.
"""

from repro_torch.configs.base import ModelConfig, register_config

register_config(
    ModelConfig(
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab=2048,
        norm="layernorm",
        mlp_activation="gelu",
        input_mode="frames",
        source="arXiv:2306.05284",
    )
)
