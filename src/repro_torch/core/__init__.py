"""Selection science of the port: Hellinger geometry, OPTICS clustering,
Algorithm 1 and the communication ledger.

- ``hellinger``   — pairwise Hellinger distances (the strip kernel on the card)
- ``clustering``  — OPTICS ordering, cluster extraction, k-medoids
- ``selection``   — Algorithm 1 on the host and as device masks
- ``strategies``  — the ten selection strategies behind one interface
- ``comm_model``  — per-round communication accounting (Table III)
"""

from repro_torch.core.clustering import cluster_label_histograms, extract_clusters, optics
from repro_torch.core.comm_model import CommModel
from repro_torch.core.hellinger import hellinger_distance, hellinger_matrix
from repro_torch.core.selection import fedlecc_select, selection_weights

__all__ = [
    "hellinger_matrix",
    "hellinger_distance",
    "optics",
    "extract_clusters",
    "cluster_label_histograms",
    "fedlecc_select",
    "selection_weights",
    "get_strategy",
    "STRATEGIES",
    "CommModel",
]


def __getattr__(name):
    # the strategies register themselves with the engine's registry, and the
    # engine imports this package: load them on first use
    if name in ("get_strategy", "STRATEGIES"):
        from repro_torch.core import strategies

        return getattr(strategies, name)
    raise AttributeError(f"module 'repro_torch.core' has no attribute {name!r}")
