"""Models of the port: the paper's MLP (``mlp``) and the decoder stack
(``transformer``) with its attention (``attention``) and Mamba (``ssm``)
blocks."""
