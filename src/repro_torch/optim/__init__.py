"""Local-objective modifiers of the paper's regularization baselines
(``fedmods``: FedProx, FedDyn), ported from ``repro.optim``."""
