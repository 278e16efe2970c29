"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP.

61L d_model=7168 128H d_ff(expert)=2048 vocab=129280  [arXiv:2412.19437]
MLA dims per the paper: q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64,
v_head=128.  All layers MoE per the assigned config (DeepSeek's first 3
dense layers folded into the uniform stack — DESIGN.md §5).
The same values as ``repro.configs.deepseek_v3_671b``.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig, register_config

register_config(
    ModelConfig(
        name="deepseek-v3-671b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,
        d_ff=2048,
        vocab=129280,
        use_mla=True,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        moe=MoEConfig(
            n_experts=256, top_k=8, d_expert=2048, n_shared=1,
            capacity_factor=1.25, impl="capacity",
        ),
        mtp=True,
        mlp_activation="swiglu",
        source="arXiv:2412.19437",
    )
)
