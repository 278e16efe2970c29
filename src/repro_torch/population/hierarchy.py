"""Two-level hierarchical selection, ported from
``repro.population.hierarchy``.

FedLECC's Algorithm 1 — cluster, rank clusters by mean loss, pick within
the top clusters — applied one level up, with shards in place of clients.
``HierarchicalSelector`` owns that level:

1. Shard clustering, once at construction, over the shards' summary
   histograms: OPTICS over the blocked Hellinger matrix up to
   ``_OPTICS_MAX_SHARDS`` shards, ``kmedoids_hists`` (one strip at a
   time, never S x S) beyond; every strip is the Hellinger strip kernel
   on the card.
2. Shard ranking, each round: shards carry a running mean-loss estimate
   from the round's polled resident losses.  Unexplored shards hold
   ``+inf``, so Algorithm 1's descending rank polls every shard before it
   revisits one.  Loss-blind strategies draw per-round shard scores from
   their own child stream instead, never the engine's selection stream.
3. The resident set: ``fedlecc_select`` over (shard labels, shard scores)
   picks ``shards_per_round`` shards; their members are the only clients
   polled, gathered or trained this round, and the engine gates everyone
   else to ``-inf`` through the admission gate the systems and fault axes
   use, so every strategy composes unchanged.

With one shard there is nothing to rank: no stream is drawn, every client
is resident, and the round gives the flat engine's bits.  Host-side numpy
with the reference's streams, so labels, shard choices and estimates are
the reference's.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.selection import fedlecc_select
from repro_torch.population.config import PopulationConfig
from repro_torch.population.store import ClientStore

__all__ = ["HierarchicalSelector", "POPULATION_SELECT_STREAM"]

# Child-stream tag for loss-blind per-round shard scores:
# default_rng([seed, POPULATION_SELECT_STREAM, round]).
POPULATION_SELECT_STREAM = 0x5E3D_0006

# OPTICS consumes the dense S x S matrix; past this shard count the
# hierarchy switches to k-medoids over distances computed on demand.
_OPTICS_MAX_SHARDS = 2048


class HierarchicalSelector:
    """The shard level of the two-level Algorithm 1; the Hellinger strips
    of the shard clustering run on the store's device."""

    def __init__(self, cfg: PopulationConfig, store: ClientStore, *,
                 seed: int = 0, needs_losses: bool = True):
        if store.n_shards != cfg.n_shards:
            raise ValueError(
                f"store has {store.n_shards} shards but PopulationConfig "
                f"says {cfg.n_shards}"
            )
        self.cfg = cfg
        self.store = store
        self.seed = int(seed) & 0xFFFF_FFFF
        self.needs_losses = bool(needs_losses)
        s = cfg.n_shards
        if s == 1:
            self.shard_labels = np.zeros(1, np.int64)
        elif s <= _OPTICS_MAX_SHARDS:
            from repro_torch.core.clustering import cluster_label_histograms

            self.shard_labels, _ = cluster_label_histograms(
                store.shard_hists(), min_samples=min(cfg.min_samples, s),
                device=store.device,
            )
        else:
            from repro_torch.core.clustering import kmedoids_hists

            self.shard_labels = kmedoids_hists(
                store.shard_hists(), k=max(8, s // 64), seed=seed, device=store.device
            )
        self.n_shard_clusters = int(self.shard_labels.max()) + 1
        # running mean-loss estimate a shard; +inf = never polled, which
        # ranks first under Algorithm 1's descending order
        self.estimates = np.full(s, np.inf, np.float64)
        self._resident_shards: np.ndarray | None = None
        self._resident_members: np.ndarray | None = None

    def choose_shards(self, rnd: int) -> np.ndarray:
        """Sorted shard ids resident at round ``rnd``."""
        s, r = self.cfg.n_shards, self.cfg.shards_per_round
        if r >= s:
            return np.arange(s, dtype=np.int64)
        if self.needs_losses:
            scores = self.estimates
        else:
            rng = np.random.default_rng(
                [self.seed, POPULATION_SELECT_STREAM, int(rnd)]
            )
            scores = rng.random(s)
        return fedlecc_select(
            self.shard_labels, scores, m=r,
            J=min(self.cfg.j_shards, self.n_shard_clusters),
        )

    def begin_round(self, rnd: int) -> tuple[np.ndarray, np.ndarray]:
        """Pick the round's resident shards; returns ``(shards, members)``,
        ``members`` the sorted global client indices (sorted: shards are
        contiguous index blocks)."""
        shards = self.choose_shards(rnd)
        members = np.concatenate(
            [self.store.shard_members(int(s)) for s in shards]
        )
        self._resident_shards = shards
        self._resident_members = members
        return shards, members

    def resident_mask(self) -> np.ndarray:
        """(K,) bool — this round's resident clients (the extra admission
        gate the engine ANDs into ``_gated_losses``)."""
        if self._resident_members is None:
            raise RuntimeError("resident_mask before begin_round")
        mask = np.zeros(self.store.n_clients, bool)
        mask[self._resident_members] = True
        return mask

    def observe(self, losses: np.ndarray) -> None:
        """Fold the round's polled (K,) losses into the resident shards'
        running estimates; only finite member losses count, so a shard
        with no finite loss keeps its previous estimate."""
        if not self.needs_losses or self._resident_shards is None:
            return
        for s in self._resident_shards:
            ls = np.asarray(losses)[self.store.shard_members(int(s))]
            finite = np.isfinite(ls)
            if finite.any():
                self.estimates[int(s)] = float(ls[finite].mean())

    def select_cohort(self, losses_members: np.ndarray, m: int
                      ) -> np.ndarray:
        """Resident-local top-m by loss: the O(resident) path a production
        server runs (and the population rows time), never touching a
        K-length vector.  The engine's strategy-generic path gates the
        full loss vector instead; both pick the same cohort for the
        loss-ranked rule."""
        if self._resident_members is None:
            raise RuntimeError("select_cohort before begin_round")
        members = self._resident_members
        m = min(int(m), len(members))
        part = np.argpartition(-np.asarray(losses_members), m - 1)[:m]
        return np.sort(members[part])

    # -- checkpoint contract --------------------------------------------
    def state_dict(self) -> dict:
        """JSON-safe round carry: the shard loss estimates (``None`` for
        never-polled shards).  The shard clusters are a pure function of
        the store's summaries and the loss-blind stream one of ``(seed,
        round)``, so neither is carried."""
        return {
            "estimates": [
                None if not np.isfinite(e) else float(e)
                for e in self.estimates
            ]
        }

    def load_state_dict(self, state: dict) -> None:
        est = state.get("estimates")
        if est is None or len(est) != self.cfg.n_shards:
            raise ValueError(
                f"population checkpoint carries "
                f"{None if est is None else len(est)} shard estimates, "
                f"expected {self.cfg.n_shards}"
            )
        self.estimates = np.array(
            [np.inf if e is None else float(e) for e in est], np.float64
        )
