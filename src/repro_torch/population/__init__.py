"""``repro_torch.population`` — population-scale federated learning, ported
from ``repro.population``.

Makes a round's cost follow the cohort, not the population, so the
cross-device setting FedLECC is pitched at (K up to 10⁶) runs on one card:

- ``store``     — ``ClientStore`` and its ``InMemoryStore`` /
  ``ShardedStore``: client data lives on the host or is synthesized shard
  by shard; only polled and dispatched rows reach the device.
- ``hierarchy`` — ``HierarchicalSelector``: Algorithm 1 one level up
  (shards clustered by summary histogram, ranked by mean polled loss)
  picks the round's resident shards; the registered strategy then selects
  inside them unchanged.
- ``config``    — ``PopulationConfig``, the validated slot behind
  ``FLConfig.population``.

The blocked Hellinger build behind the shard clustering is
``repro_torch.core.hellinger`` (``hellinger_blocked`` / ``hellinger_rows``,
the strip kernel on the card).
"""

from repro_torch.population.config import PopulationConfig
from repro_torch.population.hierarchy import (
    POPULATION_SELECT_STREAM,
    HierarchicalSelector,
)
from repro_torch.population.store import (
    POPULATION_DATA_STREAM,
    ClientStore,
    InMemoryStore,
    ShardData,
    ShardedStore,
    ShardLoader,
    SyntheticShardLoader,
    materialize_store,
    shard_layout,
)

__all__ = [
    "PopulationConfig",
    "HierarchicalSelector",
    "ClientStore",
    "InMemoryStore",
    "ShardedStore",
    "ShardData",
    "ShardLoader",
    "SyntheticShardLoader",
    "materialize_store",
    "shard_layout",
    "POPULATION_DATA_STREAM",
    "POPULATION_SELECT_STREAM",
]
