"""Sharded client-dataset stores, ported from ``repro.population.store``.

Without a population the engine keeps the packed (K, N_max, ...) client
stacks on the device: a round's compute follows the cohort, its memory
the population.  A ``ClientStore`` keeps the population on the host (or
synthesizes it shard by shard), and ``gather`` is the only path by which
client rows reach the device: the resident shards' poll rows and the
dispatched cohort.

- ``InMemoryStore`` — the packed numpy arrays, kept in host memory.
- ``ShardedStore``  — shards materialized lazily through a
  ``ShardLoader`` (deterministic per ``(seed, shard)``, so reloading an
  evicted shard gives the same bits), with an optional LRU bound on the
  cached shards.  ``summary()`` gives per-client sizes and label
  histograms without synthesizing features, which is what the hierarchy
  clusters on.

The shard layout is contiguous ``np.array_split`` blocks, shared by both
stores, so a ``ShardedStore`` and the ``InMemoryStore`` over its
materialized union gather the same cohorts bit for bit.  The numpy
streams are the reference's (``POPULATION_DATA_STREAM``), so shard
contents are bit-identical to its.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = [
    "ClientStore",
    "InMemoryStore",
    "ShardedStore",
    "ShardData",
    "ShardLoader",
    "SyntheticShardLoader",
    "shard_layout",
    "materialize_store",
    "POPULATION_DATA_STREAM",
]

# Child-stream tag for per-shard data synthesis: shard s of a run seeded
# ``seed`` draws from default_rng([seed, POPULATION_DATA_STREAM, s, ...]),
# independent of the engine's streams and of the shard-selection stream
# (repro_torch.population.hierarchy.POPULATION_SELECT_STREAM).
POPULATION_DATA_STREAM = 0x5E3D_0005


def shard_layout(n_clients: int, n_shards: int) -> list[np.ndarray]:
    """Contiguous near-equal shard membership (sizes differ by <= 1)."""
    if not 1 <= n_shards <= n_clients:
        raise ValueError(
            f"n_shards must be in [1, n_clients={n_clients}], got {n_shards}"
        )
    return [
        np.asarray(a, np.int64)
        for a in np.array_split(np.arange(n_clients, dtype=np.int64), n_shards)
    ]


class ShardData(NamedTuple):
    """One materialized shard: packed member rows (``pack_clients``
    layout: padding repeats the first sample, the mask zeroes it out)."""

    xs: np.ndarray     # (n, N_max, ...) features
    ys: np.ndarray     # (n, N_max, ...) labels
    mask: np.ndarray   # (n, N_max) float32 validity
    sizes: np.ndarray  # (n,) int64 true sample counts
    hists: np.ndarray  # (n, C) normalized label histograms


def _to_device(arrays, device: torch.device) -> tuple[torch.Tensor, ...]:
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)


class ClientStore:
    """Shard membership, per-client summaries and cohort gathers: all the
    engine and the hierarchy ask of a population, so the flat in-memory
    population and the lazily synthesized one are interchangeable."""

    n_clients: int
    n_shards: int
    device: torch.device

    def shard_members(self, shard: int) -> np.ndarray:
        """(n,) global client indices of ``shard``."""
        raise NotImplementedError

    def client_sizes(self) -> np.ndarray:
        """(K,) per-client sample counts (a summary: no features)."""
        raise NotImplementedError

    def client_hists(self) -> np.ndarray:
        """(K, C) normalized label histograms (a summary)."""
        raise NotImplementedError

    def shard_hists(self) -> np.ndarray:
        """(S, C) shard summary histograms: the size-weighted mix of the
        member histograms, renormalized — what the hierarchy clusters."""
        sizes = np.asarray(self.client_sizes(), np.float64)
        hists = np.asarray(self.client_hists(), np.float64)
        out = np.stack(
            [
                (hists[m] * sizes[m, None]).sum(axis=0)
                for m in (self.shard_members(s) for s in range(self.n_shards))
            ]
        )
        return out / np.maximum(out.sum(axis=1, keepdims=True), 1e-12)

    def gather(self, indices) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(xs, ys, mask)`` rows of the given global client indices, in
        the given order, as tensors on the store's ``device``, each with
        leading axis ``len(indices)``: the only path by which client rows
        reach the device."""
        raise NotImplementedError

    def materialized_shards(self) -> tuple[int, ...]:
        """Shards whose feature data was ever materialized (sorted): under
        hierarchical selection the union of the resident sets, not the
        whole shard range."""
        raise NotImplementedError


class InMemoryStore(ClientStore):
    """The packed arrays behind the store interface, kept on the host."""

    def __init__(self, xs, ys, mask, sizes, hists, n_shards: int = 1, *,
                 device: str | torch.device = "cuda"):
        self._xs = np.asarray(xs)
        self._ys = np.asarray(ys)
        self._mask = np.asarray(mask)
        self._sizes = np.asarray(sizes, np.int64)
        self._hists = np.asarray(hists)
        self.device = resolve_device(device)
        self.n_clients = int(self._xs.shape[0])
        for name, arr in (("ys", self._ys), ("mask", self._mask),
                          ("sizes", self._sizes), ("hists", self._hists)):
            if arr.shape[0] != self.n_clients:
                raise ValueError(
                    f"InMemoryStore {name} leading axis {arr.shape[0]} != "
                    f"n_clients {self.n_clients}"
                )
        self._shards = shard_layout(self.n_clients, n_shards)
        self.n_shards = len(self._shards)

    def shard_members(self, shard: int) -> np.ndarray:
        return self._shards[shard]

    def client_sizes(self) -> np.ndarray:
        return self._sizes

    def client_hists(self) -> np.ndarray:
        return self._hists

    def gather(self, indices):
        idx = np.asarray(indices, np.int64)
        return _to_device((self._xs[idx], self._ys[idx], self._mask[idx]), self.device)

    def materialized_shards(self) -> tuple[int, ...]:
        # the whole population is held by construction
        return tuple(range(self.n_shards))


class ShardLoader:
    """Materializes one shard's client data, deterministically per
    ``(seed, shard)``.  ``summary`` returns the per-client ``(sizes,
    hists)`` without features: the default derives it from ``load``;
    loaders that can separate the label stream from the feature stream
    (``SyntheticShardLoader``) override it, which keeps unselected shards
    unmaterialized."""

    def load(self, shard: int, members: np.ndarray) -> ShardData:
        raise NotImplementedError

    def summary(
        self, shard: int, members: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        d = self.load(shard, members)
        return d.sizes, d.hists


class SyntheticShardLoader(ShardLoader):
    """Label-skewed synthetic clients, synthesized shard by shard.

    Each client gets a dominant class (drawn per client) and a sample
    count in ``samples``; a sample is its class prototype plus Gaussian
    noise (prototypes fixed by ``proto_seed`` and shared across shards, so
    all shards pose one task).  Labels and features draw from separate
    child streams of ``(seed, shard)``:

    - labels:   ``default_rng([seed, POPULATION_DATA_STREAM, shard, 0])``
    - features: ``default_rng([seed, POPULATION_DATA_STREAM, shard, 1])``

    so ``summary`` replays only the label stream, bit-identical to the
    labels inside ``load``.
    """

    def __init__(self, *, n_features: int = 64, n_classes: int = 10,
                 samples: tuple[int, int] = (8, 16), skew: float = 0.8,
                 noise: float = 0.3, seed: int = 0, proto_seed: int = 1234):
        if not 1 <= samples[0] <= samples[1]:
            raise ValueError(
                f"samples must be (lo, hi) with 1 <= lo <= hi, got {samples}"
            )
        if not 0.0 <= skew <= 1.0:
            raise ValueError(f"skew must be in [0, 1], got {skew}")
        self.n_features = int(n_features)
        self.n_classes = int(n_classes)
        self.samples = (int(samples[0]), int(samples[1]))
        self.skew = float(skew)
        self.noise = float(noise)
        self.seed = int(seed) & 0xFFFF_FFFF
        proto_rng = np.random.default_rng(proto_seed)
        self.protos = proto_rng.normal(
            0.0, 1.0, size=(self.n_classes, self.n_features)
        ).astype(np.float32)

    def _label_rng(self, shard: int) -> np.random.Generator:
        return np.random.default_rng(
            [self.seed, POPULATION_DATA_STREAM, int(shard), 0]
        )

    def _feature_rng(self, shard: int) -> np.random.Generator:
        return np.random.default_rng(
            [self.seed, POPULATION_DATA_STREAM, int(shard), 1]
        )

    def _labels(
        self, shard: int, n: int
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(sizes, ys, mask) for the shard's n clients — the label-only
        prefix shared bit for bit by ``summary`` and ``load``."""
        rng = self._label_rng(shard)
        lo, hi = self.samples
        sizes = rng.integers(lo, hi + 1, size=n).astype(np.int64)
        dom = rng.integers(0, self.n_classes, size=n)
        ys = np.where(
            rng.random((n, hi)) < self.skew,
            dom[:, None],
            rng.integers(0, self.n_classes, size=(n, hi)),
        ).astype(np.int32)
        mask = (np.arange(hi)[None, :] < sizes[:, None]).astype(np.float32)
        # pack_clients convention: padding repeats the first sample
        ys = np.where(mask > 0, ys, ys[:, :1])
        return sizes, ys, mask

    def _hists(self, ys: np.ndarray, mask: np.ndarray) -> np.ndarray:
        n = ys.shape[0]
        hists = np.zeros((n, self.n_classes), np.float64)
        rows = np.repeat(np.arange(n), ys.shape[1])
        np.add.at(hists, (rows, ys.ravel()), mask.ravel())
        return hists / np.maximum(hists.sum(axis=1, keepdims=True), 1e-12)

    def summary(self, shard: int, members: np.ndarray):
        sizes, ys, mask = self._labels(shard, len(members))
        return sizes, self._hists(ys, mask)

    def load(self, shard: int, members: np.ndarray) -> ShardData:
        n = len(members)
        sizes, ys, mask = self._labels(shard, n)
        frng = self._feature_rng(shard)
        xs = self.protos[ys] + frng.normal(
            0.0, self.noise, size=(n, self.samples[1], self.n_features)
        ).astype(np.float32)
        return ShardData(xs=xs.astype(np.float32), ys=ys, mask=mask, sizes=sizes,
                         hists=self._hists(ys, mask))


class ShardedStore(ClientStore):
    """Lazy shard materialization with an optional LRU cache bound.

    Summaries (sizes, histograms) come from ``ShardLoader.summary`` for
    every shard up front (the O(K·C) metadata clients ship the server
    once; the comm ledger counts it), but feature data materializes only
    when ``gather`` touches a shard.  Reloading an evicted shard gives the
    same bits, so the cache bound trades host memory for reload compute
    without changing any result."""

    def __init__(self, loader: ShardLoader, n_clients: int, n_shards: int,
                 max_cached_shards: int | None = None, *,
                 device: str | torch.device = "cuda"):
        if max_cached_shards is not None and max_cached_shards < 1:
            raise ValueError(
                f"max_cached_shards must be >= 1 or None, got "
                f"{max_cached_shards}"
            )
        self.loader = loader
        self.device = resolve_device(device)
        self.n_clients = int(n_clients)
        self._shards = shard_layout(self.n_clients, n_shards)
        self.n_shards = len(self._shards)
        self.max_cached_shards = max_cached_shards
        self._cache: OrderedDict[int, ShardData] = OrderedDict()
        self._ever_loaded: set[int] = set()
        self.load_count = 0
        # global index -> (shard, local row)
        self._shard_of = np.empty(self.n_clients, np.int64)
        self._local_of = np.empty(self.n_clients, np.int64)
        for s, m in enumerate(self._shards):
            self._shard_of[m] = s
            self._local_of[m] = np.arange(len(m))
        sizes, hists = [], []
        for s, m in enumerate(self._shards):
            sz, h = loader.summary(s, m)
            sizes.append(np.asarray(sz, np.int64))
            hists.append(np.asarray(h))
        self._sizes = np.concatenate(sizes)
        self._hists = np.concatenate(hists, axis=0)

    def shard_members(self, shard: int) -> np.ndarray:
        return self._shards[shard]

    def client_sizes(self) -> np.ndarray:
        return self._sizes

    def client_hists(self) -> np.ndarray:
        return self._hists

    def _materialize(self, shard: int) -> ShardData:
        if shard in self._cache:
            self._cache.move_to_end(shard)
            return self._cache[shard]
        data = self.loader.load(shard, self._shards[shard])
        if data.xs.shape[0] != len(self._shards[shard]):
            raise ValueError(
                f"loader returned {data.xs.shape[0]} rows for shard "
                f"{shard} with {len(self._shards[shard])} members"
            )
        self._cache[shard] = data
        self._ever_loaded.add(shard)
        self.load_count += 1
        if (self.max_cached_shards is not None
                and len(self._cache) > self.max_cached_shards):
            self._cache.popitem(last=False)
        return data

    def gather(self, indices):
        idx = np.asarray(indices, np.int64)
        shards = self._shard_of[idx]
        locals_ = self._local_of[idx]
        out = None
        for s in np.unique(shards):
            data = self._materialize(int(s))
            pos = np.flatnonzero(shards == s)
            parts = (data.xs, data.ys, data.mask)
            if out is None:
                out = tuple(np.empty((len(idx),) + a.shape[1:], a.dtype) for a in parts)
            for o, a in zip(out, parts):
                o[pos] = a[locals_[pos]]
        return _to_device(out, self.device)

    def cached_shards(self) -> tuple[int, ...]:
        """Shards currently held in the LRU cache (sorted)."""
        return tuple(sorted(self._cache))

    def materialized_shards(self) -> tuple[int, ...]:
        return tuple(sorted(self._ever_loaded))


def materialize_store(store: ShardedStore, n_shards: int | None = None
                      ) -> InMemoryStore:
    """Load every shard of a ``ShardedStore`` into one ``InMemoryStore``
    on the same device (the reference path for the cohort bit-identity
    property; it defeats laziness)."""
    parts = [store._materialize(s) for s in range(store.n_shards)]
    return InMemoryStore(
        xs=np.concatenate([p.xs for p in parts]),
        ys=np.concatenate([p.ys for p in parts]),
        mask=np.concatenate([p.mask for p in parts]),
        sizes=np.concatenate([p.sizes for p in parts]),
        hists=np.concatenate([p.hists for p in parts]),
        n_shards=n_shards if n_shards is not None else store.n_shards,
        device=store.device,
    )
