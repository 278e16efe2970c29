"""hymba-1.5b [hybrid] — parallel attention + Mamba heads per layer.

32L d_model=1600 25H (kv=5) d_ff=5504 vocab=32001 ssm_state=16
[arXiv:2411.13676]  Sliding-window attention everywhere except 3 global
layers (first / middle / last), per the Hymba paper.  The same values as
``repro.configs.hymba_1_5b``.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig, register_config

_PATTERN = "".join("G" if i in (0, 15, 31) else "L" for i in range(32))

register_config(
    ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        d_ff=5504,
        vocab=32001,
        head_dim=64,
        block_type="hymba",
        ssm=SSMConfig(d_state=16, conv_kernel=4, chunk=256, family="mamba"),
        sliding_window=1024,
        layer_pattern=_PATTERN,
        mlp_activation="swiglu",
        source="arXiv:2411.13676",
    )
)
