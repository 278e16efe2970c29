from repro_torch.data.partition import (
    calibrate_alpha,
    calibrate_shards,
    dirichlet_partition,
    label_histograms,
    pack_clients,
    shard_partition,
)
from repro_torch.data.pipeline import batch_iterator
from repro_torch.data.synthetic import Dataset, make_classification, make_token_stream

__all__ = [
    "Dataset", "make_classification", "make_token_stream", "dirichlet_partition", "shard_partition",
    "calibrate_alpha", "calibrate_shards", "pack_clients", "label_histograms", "batch_iterator",
]
