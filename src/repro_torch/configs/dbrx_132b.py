"""dbrx-132b [moe] — 16 experts top-4, fine-grained routing.

40L d_model=6144 48H (kv=8) d_ff(expert)=10752 vocab=100352
[hf:databricks/dbrx-base]
The same values as ``repro.configs.dbrx_132b``.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig, register_config

register_config(
    ModelConfig(
        name="dbrx-132b",
        family="moe",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=10752,
        vocab=100352,
        moe=MoEConfig(
            n_experts=16, top_k=4, d_expert=10752, n_shared=0,
            capacity_factor=1.25, impl="capacity",
        ),
        mlp_activation="swiglu",
        source="hf:databricks/dbrx-base",
    )
)
