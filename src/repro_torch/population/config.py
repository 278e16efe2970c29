"""``PopulationConfig`` — the validated, JSON-safe slot behind
``FLConfig.population``, ported from ``repro.population.config``.

Plain scalars, so it survives ``FLConfig.to_dict()`` / ``from_dict``; the
client store and the shard hierarchy are built at engine construction.

The axis makes a round's cost proportional to the cohort: the population
is split into ``n_shards`` contiguous shards, each round polls, gathers
and trains only the ``shards_per_round`` resident shards (picked by the
shard-level Algorithm 1 in ``repro_torch.population.hierarchy``), and
the strategy's own selection runs inside them.  ``n_shards=1`` keeps
every client resident and gives the flat engine's bits.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

__all__ = ["PopulationConfig"]


@dataclass
class PopulationConfig:
    """The population axis of one federated experiment.

    - ``n_shards`` — contiguous, near-equal shards the K clients are
      split into (``np.array_split`` layout, owned by the store).
    - ``shards_per_round`` — shards resident a round; polling, gathering
      and training touch only their members.
    - ``j_shards`` — Algorithm 1's J at the shard level: shards are
      clustered by summary histogram, shard clusters ranked by mean
      estimated loss, and the resident set drawn from the top
      ``j_shards`` clusters.
    - ``min_samples`` — OPTICS ``min_samples`` for the shard-summary
      clustering (clamped to the shard count).
    """

    n_shards: int = 1
    shards_per_round: int = 1
    j_shards: int = 3
    min_samples: int = 3

    def __post_init__(self) -> None:
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if not 1 <= self.shards_per_round <= self.n_shards:
            raise ValueError(
                f"shards_per_round must be in [1, n_shards="
                f"{self.n_shards}], got {self.shards_per_round}"
            )
        if self.j_shards < 1:
            raise ValueError(f"j_shards must be >= 1, got {self.j_shards}")
        if self.min_samples < 1:
            raise ValueError(
                f"min_samples must be >= 1, got {self.min_samples}"
            )

    @classmethod
    def from_dict(cls, d: dict) -> "PopulationConfig":
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown PopulationConfig keys: {sorted(unknown)}"
            )
        return cls(**d)
