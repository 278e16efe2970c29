"""Model configs, ported from ``repro.configs.base``.

Frozen dataclasses with the reference's field lists, so one config reads
the same in both packages.  Each architecture registers itself from its
own module under ``repro_torch.configs``; ``get_config`` imports them
lazily.  The port registers what it runs: stablelm-3b (dense attention)
and hymba-1.5b (attention in parallel with Mamba heads).  Any other name
raises with the slice that brings it.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, replace

__all__ = [
    "MoEConfig",
    "SSMConfig",
    "ModelConfig",
    "register_config",
    "get_config",
    "list_configs",
]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int                 # routed experts
    top_k: int
    d_expert: int                  # per-expert FFN hidden dim
    n_shared: int = 0              # always-on shared experts (deepseek)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001   # load-balance aux loss
    impl: str = "dense"            # dense | capacity (shard_map expert parallel)


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    conv_kernel: int = 4
    expand: int = 2                # d_inner = expand * d_ssm_in (mamba)
    n_heads: int = 4               # xlstm heads
    chunk: int = 256               # chunked-scan length
    family: str = "mamba"          # mamba | xlstm
    fuse_contraction: bool = True  # §Perf: contract C inside the chunk loop
                                   # (False = paper-faithful baseline layout)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 → d_model // n_heads
    # --- attention ---
    rope_theta: float = 10000.0
    rope_theta_global: float = 0.0   # gemma3: separate theta for global layers
    rope_fraction: float = 1.0       # partial rotary (stablelm)
    qk_norm: bool = False            # qwen3
    sliding_window: int = 0          # 0 → full attention on "local" layers too
    layer_pattern: str = "G"         # repeating pattern, L=local-window G=global
    attn_logit_softcap: float = 0.0
    # --- MLA (deepseek) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # --- block structure ---
    block_type: str = "attn"         # attn | hymba (attn ∥ mamba) | xlstm
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    mlp_activation: str = "swiglu"   # swiglu | geglu | gelu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    tie_embeddings: bool = False
    mtp: bool = False                # deepseek multi-token-prediction aux head
    mtp_weight: float = 0.3
    # --- modality ---
    input_mode: str = "tokens"       # tokens | frames (audio) | vlm
    n_patches: int = 0               # vlm image-prefix length
    # --- numerics / runtime ---
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    attn_impl: str = "chunked"       # chunked | naive
    attn_chunk: int = 512
    loss_chunk: int = 512            # CE computed over seq chunks of this size
    remat: bool = True
    scan_unroll: int = 1             # layer-scan unroll (cost-probe lowers use 2)
    act_shard: str = ""              # ""|"dp_all"|"dp_data": per-layer activation
                                     # sharding constraint (§Perf iteration 2)
    source: str = ""                 # citation

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model ≤ 512, ≤ 4 experts —
        same family / block structure / attention flavour."""
        d = min(self.d_model, 256)
        heads = min(self.n_heads, 4)
        kv = max(1, min(self.n_kv_heads, heads))
        hd = max(16, d // heads)
        moe = None
        if self.moe is not None:
            moe = replace(
                self.moe,
                n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_expert=min(self.moe.d_expert, 128),
                n_shared=min(self.moe.n_shared, 1),
                impl="dense",
            )
        ssm = None
        if self.ssm is not None:
            ssm = replace(self.ssm, n_heads=min(self.ssm.n_heads, 2), chunk=64)
        kw = {}
        if self.use_mla:
            kw = dict(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=hd,
                      qk_rope_head_dim=16, v_head_dim=hd)
        return replace(
            self,
            name=self.name + "-reduced",
            n_layers=2,
            d_model=d,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            n_patches=min(self.n_patches, 8) if self.n_patches else 0,
            moe=moe,
            ssm=ssm,
            attn_chunk=64,
            loss_chunk=64,
            dtype="float32",
            **kw,
        )


_REGISTRY: dict[str, ModelConfig] = {}

_ARCH_MODULES = ["stablelm_3b", "hymba_1_5b"]

# The reference's other architectures, each with the slice of the port that
# brings the blocks it needs.
_LATER = {
    "xlstm-125m": "the next slice (xlstm: mLSTM and sLSTM blocks)",
    "dbrx-132b": "the MoE slice",
    "deepseek-v3-671b": "the MoE and MLA slices",
    "glm4-9b": "a later slice (dense attention with its own options)",
    "qwen3-14b": "a later slice (qk-norm)",
    "gemma3-27b": "a later slice (local/global rope thetas and logit soft-capping)",
    "musicgen-large": "a later slice (frame inputs)",
    "internvl2-1b": "a later slice (image-patch inputs)",
}


def register_config(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def _load_all() -> None:
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    if name not in _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        if name in _LATER:
            raise ValueError(
                f"repro_torch does not implement model {name!r} yet; it arrives in "
                f"{_LATER[name]} (the JAX package repro runs it; ported: {sorted(_REGISTRY)})"
            )
        raise KeyError(f"unknown config {name!r}; available: {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]
    return cfg.reduced() if reduced else cfg


def list_configs() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)
