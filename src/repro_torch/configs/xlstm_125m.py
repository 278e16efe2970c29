"""xlstm-125m [ssm] — sLSTM + mLSTM blocks.

12L d_model=768 4H d_ff=0 vocab=50304  [arXiv:2405.04517]
Blocks alternate 3 mLSTM : 1 sLSTM (pattern "MMMS"); d_ff=0 means the
recurrent core carries its own projections (no separate FFN).
The same values as ``repro.configs.xlstm_125m``.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig, register_config

register_config(
    ModelConfig(
        name="xlstm-125m",
        family="ssm",
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=50304,
        block_type="xlstm",
        layer_pattern="MMMS",
        ssm=SSMConfig(n_heads=4, chunk=256, family="xlstm"),
        source="arXiv:2405.04517",
    )
)
