"""Models of the port: the paper's MLP (``mlp``) and the decoder stack
(``transformer``) with its attention (``attention``: GQA and MLA),
mixture-of-experts (``moe``) and recurrent (``ssm``: Mamba heads, mLSTM
and sLSTM) blocks."""

from repro_torch.models.mlp import cross_entropy_loss, init_mlp, mlp_apply

__all__ = ["init_mlp", "mlp_apply", "cross_entropy_loss"]
