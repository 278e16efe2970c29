"""The federated engine's shared state and round protocol, ported from
``repro.engine.base`` (the lock-step loop with the systems, fault and
population axes, and the checkpoint and emission seams).

``Engine`` owns the non-IID partition, the packed client tensors on the
device, the selection strategy, the aggregator, the client mode (with
FedDyn's (K, P) per-client state), the comm ledger and, when configured,
the ``SystemsRuntime`` (availability, deadlines, over-selection, the
simulated clock), the ``FaultRuntime`` (injection, the validation gate,
quarantine) and the population axis: the packed stacks then stay on the
host in an ``InMemoryStore`` (``repro_torch.population``), the device
holds only (K,) vectors, and a ``HierarchicalSelector`` picks each
round's resident shards, whose members alone are polled (their rows
gathered from the store), admitted to selection and billed.  One
canonical round loop:

    [resident shards] → poll_losses → [observe] → gate → select →
    local_train → [outcome, faults] → aggregate → evaluate

``HostEngine`` (``repro_torch.engine.host``) and ``ScaleoutEngine``
(``repro_torch.engine.scaleout``) implement ``select`` / ``local_train`` /
``aggregate``; ``CompiledEngine``
(``repro_torch.engine.compiled``) replaces the whole round step with one
on the device, its selection a mask (``MaskSelectionMixin``), and
``FusedEngine`` (``repro_torch.engine.fused``) runs chunks of such rounds
with no host read between them; ``AsyncHostEngine`` and
``AsyncCompiledEngine`` (``repro_torch.engine.async_engine``) drive the
hooks from an event loop.  ``rounds()`` yields one frozen ``RoundResult``
per round; ``run()`` drains it into the history dict.

Every random draw of the model's training goes through ``self.draws``
(``repro_torch.engine.draws``), keyed by a *draw index*: the round in the
lock-step loop, the dispatch count under the async runtime (the
reference's one key split a dispatch); the axes draw on their own numpy
streams, keyed by the round (the async step).

Each committed round goes through ``_emit``: history, callback, trackers
(``self.trackers``), then the checkpoint policy (``self.checkpointer``).
``save`` / ``restore`` write and read the whole round carry
(``repro_torch.checkpoint``): the params, the aggregator's state, FedDyn's
per-client state, the draws' state, the numpy selection stream, the
ledger, the clock, the history, the axes' state (the population's: its
shard loss estimates) and the config's fingerprint, which ``restore``
checks.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Callable, Iterator, NamedTuple

import numpy as np
import torch

from repro_torch.convert import leaf_segments
from repro_torch.core.comm_model import CommModel, count_params
from repro_torch.data.partition import (
    calibrate_alpha,
    calibrate_shards,
    dirichlet_partition,
    pack_clients,
    shard_partition,
)
from repro_torch.device import pin_fp32_matmul, resolve_device
from repro_torch.engine.aggregators import get_aggregator
from repro_torch.engine.client_modes import get_client_mode
from repro_torch.engine.config import (
    FLConfig,
    mask_backend_aggregator_error,
    mask_backend_client_mode_error,
    mask_backend_strategy_error,
)
from repro_torch.engine.draws import TorchDraws
from repro_torch.engine.registry import STRATEGY_REGISTRY, mask_selection_strategies
from repro_torch.engine.tasks import build_task

__all__ = ["Engine", "MaskSelectionMixin", "RoundResult", "mask_selection_strategies",
           "rounds_to_accuracy"]


def _mean_loss(sel_losses) -> float:
    """Mean local-training loss over the cohort; ``nan`` when nobody was
    selected."""
    ls = np.asarray(sel_losses)
    return float(ls.mean()) if ls.size else float("nan")


@dataclass(frozen=True)
class RoundResult:
    """One completed federated round.

    - ``round``              — 0-based absolute round index.
    - ``selected``           — sorted tuple of the participating clients.
    - ``mean_selected_loss`` — mean local training loss over the cohort.
    - ``comm_mb``            — cumulative communication ledger in MB up
      to and including this round.
    - ``test_loss``/``test_acc`` — global-model evaluation on the held-out
      set; ``None`` on rounds skipped by the ``eval_every`` cadence.
    - ``sim_time``/``sim_clock`` — simulated wall-clock seconds of this
      round / cumulative since round 0, from the systems axis; 0.0
      without one.
    - ``n_dropped``          — dispatched-but-not-aggregated clients this
      round (offline at dispatch, or past the deadline); ``selected``
      lists the *survivors*, whose updates were aggregated.
    - ``metrics``            — the task's extra held-out metrics on
      evaluated rounds (the LM task's ``ppl`` and ``ppl_per_cluster``);
      ``None`` otherwise.  Energy-tracking runs add the round's battery
      spend (``energy_mah``, ``energy_total_mah``, ``n_depleted``) on
      every round.
    - ``staleness``          — mean staleness (in params versions) of the
      updates aggregated this round: 0.0 on the lock-step engines, > 0
      only under the async runtime.
    - ``params_version``     — server params version after this round (the
      lock-step engines: round + 1; the async runtime's lags the step
      whenever a step's buffer was empty or fully stale).
    - ``n_faulty``/``n_quarantined`` — the fault axis: arrived updates that
      carried an injected fault this round, and clients serving a
      quarantine after it; 0 without a fault config.
    """

    round: int
    selected: tuple[int, ...]
    mean_selected_loss: float
    comm_mb: float
    test_loss: float | None = None
    test_acc: float | None = None
    sim_time: float = 0.0
    sim_clock: float = 0.0
    n_dropped: int = 0
    metrics: dict | None = None
    staleness: float = 0.0
    params_version: int = 0
    n_faulty: int = 0
    n_quarantined: int = 0

    @property
    def evaluated(self) -> bool:
        return self.test_acc is not None


class _Step(NamedTuple):
    """What one round did, before billing and evaluation: the dispatched
    cohort, the survivors (aggregated) and their local losses, and the
    axes' accounting (``n_reached``: dispatched and online, who paid the
    download; ``uploaded``: the upload count the ledger bills, None
    without an axis)."""

    dispatched: np.ndarray
    survivors: np.ndarray
    losses: np.ndarray
    n_reached: int
    uploaded: float | None = None
    sim_time: float = 0.0
    n_dropped: int = 0
    n_faulty: int = 0
    n_quarantined: int = 0


class Engine:
    """Shared state + the canonical round loop; backends fill in hooks.

    ``device`` (default ``"cuda"``) holds the client data, the model and
    every kernel launch; it raises when no card is present unless the
    caller asks for ``"cpu"``.  ``draws`` replaces the default
    ``TorchDraws(cfg.seed, device)``.  ``partition_labels`` is a (N,)
    integer array the non-IID partitioner splits on instead of the task's
    derived labels (e.g. ground-truth topic ids for an LM corpus)."""

    backend = "base"

    def __init__(self, cfg: FLConfig, train, test, n_classes: int, *,
                 device: str | torch.device = "cuda", draws: Any = None,
                 partition_labels=None):
        if not isinstance(cfg, FLConfig):
            raise TypeError(
                "cfg must be a repro_torch.engine.FLConfig (build one from the "
                f"reference's config with FLConfig.from_dict(cfg.to_dict())); got "
                f"{type(cfg).__name__}"
            )
        self.device = resolve_device(device)
        pin_fp32_matmul()
        self.cfg = cfg
        self.n_classes = n_classes
        self.rng = np.random.default_rng(cfg.seed)
        self.task = build_task(cfg)
        self.draws = TorchDraws(cfg.seed, self.device) if draws is None else draws

        # --- non-IID partition (calibrated to the paper's HD regime) ---
        if partition_labels is None:
            labels = np.asarray(self.task.partition_labels(train))
        else:
            labels = np.asarray(partition_labels)
            if labels.shape != (len(train.x),):
                raise ValueError(
                    f"partition_labels must be ({len(train.x)},); got shape {labels.shape}"
                )
        part_classes = self.task.partition_classes(n_classes)
        if partition_labels is not None and (labels.min() < 0 or labels.max() >= part_classes):
            raise ValueError(
                f"partition_labels values must lie in [0, {part_classes}) (the task's "
                f"partition-label space); got range [{labels.min()}, {labels.max()}]"
            )
        if cfg.partition == "shards":
            s = calibrate_shards(labels, cfg.n_clients, cfg.target_hd,
                                 part_classes, seed=cfg.seed)
            self.alpha = float(s)  # records shards/client in the alpha slot
            self.client_idx = shard_partition(labels, cfg.n_clients, s, seed=cfg.seed)
        else:
            alpha = cfg.alpha_dirichlet
            if alpha is None:
                alpha = calibrate_alpha(labels, cfg.n_clients, cfg.target_hd,
                                        part_classes, seed=cfg.seed)
            self.alpha = float(alpha)
            self.client_idx = dirichlet_partition(
                labels, cfg.n_clients, self.alpha, seed=cfg.seed
            )
        self.hists = self.task.client_features(train, self.client_idx, n_classes)
        xs, ys, mask = pack_clients(train.x, train.y, self.client_idx)
        self.sizes = np.array([len(ix) for ix in self.client_idx])
        # --- population axis: the packed stacks stay on the host behind a
        # ClientStore, and only the rows a round touches (the resident
        # shards' poll rows, the dispatched cohort) reach the device ---
        self._store: Any = None       # InMemoryStore with a population
        self._population: Any = None  # HierarchicalSelector, built after the strategy
        self._pop_members: np.ndarray | None = None  # this round's residents
        if cfg.population is not None:
            from repro_torch.population.store import InMemoryStore

            self._store = InMemoryStore(xs, ys, mask, self.sizes, np.asarray(self.hists),
                                        n_shards=cfg.population.n_shards, device=self.device)
            self.xs = self.ys = None
        else:
            self.xs = torch.from_numpy(xs).to(self.device)
            self.ys = torch.from_numpy(ys).to(self.device)
        # Row-sampling probabilities per client (validity mask normalized),
        # kept on the host; without a population the draws build their row
        # table from them once, with one from the rows each draw is given.
        mask_t = torch.from_numpy(mask)
        self.sample_probs = mask_t / torch.clamp(mask_t.sum(-1, keepdim=True), min=1e-9)
        if cfg.population is None and hasattr(self.draws, "bind_rows"):
            self.draws.bind_rows(self.sample_probs)
        self.test_x = torch.from_numpy(np.asarray(test.x)).to(self.device)
        self.test_y = torch.from_numpy(np.asarray(test.y)).to(self.device)

        # --- model (task-owned) / optimizer-free local SGD ---
        self.params = self.task.init_params(self.draws, train, n_classes).to(self.device)
        self.n_params = count_params(self.params)

        # --- local step budgets ---
        taus = np.ceil(self.sizes * cfg.local_epochs / cfg.batch_size).astype(np.int32)
        self.taus = np.maximum(taus, 1)
        self.max_steps = int(min(cfg.max_steps_cap, self.taus.max()))

        # --- systems axis (device profiles, the simulated clock, the
        # deadline): the strategy dispatches the over-selected cohort m_eff
        # and the deadline policy drops stragglers down to the survivors ---
        self._systems: Any = None  # SystemsRuntime with a systems config
        self.m_eff = cfg.m
        if cfg.systems is not None:
            from repro_torch.systems.runtime import SystemsRuntime

            self._systems = SystemsRuntime(
                cfg.systems, n_clients=cfg.n_clients,
                steps=np.minimum(self.taus, self.max_steps), n_params=self.n_params,
                upload_bytes_per_param=cfg.compress_bits / 8.0 if cfg.compress_bits else 4.0,
                seed=cfg.seed,
            )
            self.m_eff = cfg.systems.m_effective(cfg.m, cfg.n_clients)
        self.sim_clock = 0.0

        # --- pluggable components, via the registries ---
        self.strategy = STRATEGY_REGISTRY.build(cfg.strategy, m=self.m_eff,
                                                **cfg.strategy_kwargs)
        self.strategy.setup(
            self.hists, self.sizes, seed=cfg.seed,
            latency=None if self._systems is None else self._systems.latency_hint(),
            device=self.device)
        # --- hierarchical shard selection: after the strategy, whose
        # needs_losses decides whether shards rank by their polled loss
        # estimates or by the loss-blind stream ---
        if cfg.population is not None:
            from repro_torch.population.hierarchy import HierarchicalSelector

            self._population = HierarchicalSelector(
                cfg.population, self._store, seed=cfg.seed,
                needs_losses=self.strategy.needs_losses)
            shard_sizes = np.sort([len(self._store.shard_members(s))
                                   for s in range(cfg.population.n_shards)])
            worst = int(shard_sizes[:cfg.population.shards_per_round].sum())
            if worst < self.m_eff:
                raise ValueError(
                    f"population.shards_per_round={cfg.population.shards_per_round} resident "
                    f"shards can hold as few as {worst} clients but the round needs "
                    f"m_eff={self.m_eff} — raise shards_per_round or lower n_shards/m"
                )
        self.aggregator = get_aggregator(cfg.aggregator, cfg)
        self.agg_state = self.aggregator.init_state(self.params)
        # FedDyn's h_i: (K, P) fp32 on the device — 80 MB at the paper's
        # MLP, too large at LM width
        self.client_mode = get_client_mode(cfg.client_mode)
        self.h_clients = self.client_mode.init_client_state(self.params, cfg.n_clients)

        # --- communication ledger (quantized uploads bill bits / 8 a parameter) ---
        self.comm = CommModel(
            self.n_params, cfg.n_clients, self.hists.shape[1],
            upload_bytes_per_param=cfg.compress_bits / 8.0 if cfg.compress_bits else None,
        )
        self.comm_mb = self.comm.one_time_mb(self.strategy.needs_histograms)

        # --- fault axis: injection on its own numpy stream, the validation
        # gate and the quarantine ledger ---
        self._faults: Any = None  # FaultRuntime with a fault config
        if cfg.faults is not None:
            from repro_torch.faults.runtime import FaultRuntime

            self._faults = FaultRuntime(
                cfg.faults, n_clients=cfg.n_clients, seed=cfg.seed,
                params_template=self.params,
                leaves=leaf_segments(self.task.layout(train, n_classes)),
            )

        self._apply_fn, self._loss_fn, self._metric_fn = self.task.build_fns(train, n_classes)
        self._eval_extra = self.task.build_eval_extra(test, n_classes)
        self._round = 0
        self.history: dict[str, list] = {
            "round": [], "test_acc": [], "test_loss": [], "comm_mb": [],
            "mean_selected_loss": [], "selected": [],
        }
        # the emission seams: trackers get every committed RoundResult; a
        # Checkpointer here is consulted after each round
        self.trackers: list[Any] = []
        self.checkpointer: Any = None

    # -- hooks (backend contract) --------------------------------------
    def poll_losses(self, d: int) -> np.ndarray:
        """(K,) subsampled local empirical loss of the *global* model on
        every client (Algorithm 1 lines 2–4), its rows from draw index
        ``d``; zeros when the strategy never polls.  With a population
        only the round's resident members are polled (the others stay 0
        here and are gated to ``-inf`` before selection)."""
        out = np.zeros(self.cfg.n_clients, np.float32)
        if not self.strategy.needs_losses:
            return out
        if self._population is not None:
            members = self._pop_members
            out[members] = self._poll_members(self.params, d, members).cpu().numpy()
            return out
        idx = self.draws.poll_indices(d, self.sample_probs, self.cfg.eval_samples)
        return self._poll(self.params, idx).cpu().numpy()

    def _poll(self, params: torch.Tensor, idx: torch.Tensor, xs: torch.Tensor | None = None,
              ys: torch.Tensor | None = None) -> torch.Tensor:
        """(n,) losses of ``params`` on each client's sampled rows ``idx``
        (n, eval_samples) of ``xs`` / ``ys`` (default: every client's device
        stacks), on the device."""
        xs = self.xs if xs is None else xs
        ys = self.ys if ys is None else ys
        rows = torch.arange(idx.shape[0], device=self.device)[:, None]
        with torch.no_grad():
            out = self._apply_fn(params, xs[rows, idx])
            return self._loss_fn(out, ys[rows, idx], None)

    def _poll_members(self, params: torch.Tensor, d: int, members: np.ndarray) -> torch.Tensor:
        """(len(members),) polled losses of the resident ``members``, their
        rows gathered from the store and sampled as the flat poll samples
        them (the draws are keyed by global client id)."""
        xs, ys, _ = self._store.gather(members)
        idx = self.draws.poll_indices(d, self.sample_probs[torch.as_tensor(members)],
                                      self.cfg.eval_samples, clients=members)
        return self._poll(params, idx, xs, ys)

    def select(self, rnd: int, losses: np.ndarray) -> np.ndarray:
        """Sorted indices of this round's participants."""
        raise NotImplementedError

    def local_train(self, d: int, sel: np.ndarray):
        """Run local training of the clients ``sel``, their minibatch rows
        from draw index ``d``.  Returns ``(payload, sel_losses)``:
        ``payload`` is a tuple whose first item is the (len(sel), P)
        trained cohort, threaded into ``aggregate``; ``sel_losses`` is a
        (len(sel),) array of local training losses."""
        raise NotImplementedError

    def aggregate(self, rnd: int, sel: np.ndarray, payload,
                  survivors: np.ndarray | None = None) -> None:
        """Fold the payload into ``self.params`` (and any server state).
        ``survivors`` (a subset of ``sel``, with an axis active) restricts
        it to the updates that arrived and passed the gate; ``None``:
        everyone arrived."""
        raise NotImplementedError

    def evaluate(self) -> tuple[float, float]:
        with torch.no_grad():
            out = self._apply_fn(self.params, self.test_x)
            loss = self._loss_fn(out, self.test_y, None)
            metric = self._metric_fn(out, self.test_y)
        return float(loss), float(metric)

    def eval_metrics(self) -> dict | None:
        """The task's extra metrics on the held-out set (None when the task
        has none), computed on the ``eval_every`` cadence only."""
        if self._eval_extra is None:
            return None
        return self._eval_extra(self.params, self.test_x, self.test_y)

    def _record_history(self, r: RoundResult) -> None:
        """Evaluated rounds land in the in-memory history dict."""
        if not r.evaluated:
            return
        self.history["round"].append(r.round)
        self.history["test_acc"].append(r.test_acc)
        self.history["test_loss"].append(r.test_loss)
        self.history["comm_mb"].append(r.comm_mb)
        self.history["mean_selected_loss"].append(r.mean_selected_loss)
        self.history["selected"].append(list(r.selected))
        # the axes' keys appear only when the axis is active
        if self._systems is not None:
            self.history.setdefault("sim_clock", []).append(r.sim_clock)
            self.history.setdefault("n_dropped", []).append(r.n_dropped)
        if self._faults is not None:
            self.history.setdefault("n_faulty", []).append(r.n_faulty)
            self.history.setdefault("n_quarantined", []).append(r.n_quarantined)
        for k, v in (r.metrics or {}).items():
            self.history.setdefault(k, []).append(v)

    def _emit(self, result: RoundResult, callback: Callable[[RoundResult], None] | None,
              allow_save: bool = True) -> None:
        """What follows a committed round, in durability order: history row,
        callback, trackers, checkpoint policy.  The engine's state is
        already committed, so a checkpoint taken here resumes *after* this
        round; trackers log before the save (at-least-once delivery).
        ``allow_save`` is the fused chunk's gate: its state commits per
        chunk, so only a chunk's last round may save."""
        self._record_history(result)
        if callback is not None:
            callback(result)
        for t in self.trackers:
            t.log_round(result)
        if allow_save and self.checkpointer is not None:
            self.checkpointer.maybe_save(self, result.round)

    def close_trackers(self) -> None:
        for t in self.trackers:
            t.close()

    # -- checkpoint / restore ------------------------------------------
    _STATE_VERSION = 1

    def _state_pytree(self) -> dict:
        """The array-valued round carry, the checkpoint's tree (its
        structure is the restore's ``like``): params, the aggregator's
        state (FedDyn's h), the per-client state (FedDyn's h_i), the
        draws' state (where the draws have one), the strategy's state, and
        stale_replay's cache where it is configured."""
        state = {
            "params": self.params,
            "agg_state": self.agg_state,
            "h_clients": self.h_clients,
            "strategy": self.strategy.state_dict(),
        }
        if hasattr(self.draws, "state"):
            state["draws"] = self.draws.state()
        if self._faults is not None and self._faults.has_stale:
            state["fault_stale"] = self._faults.stale_state()
        return state

    def _config_fingerprint(self) -> dict:
        from repro_torch.checkpoint.tracker import _to_builtin

        return _to_builtin(self.cfg.to_dict())

    def save(self, path: str) -> None:
        """Write the whole round carry to ``path`` (atomic and fsync'd,
        ``repro_torch.checkpoint.serializer``): the state tree, the scalar
        carry (``_round``, ``comm_mb``, ``sim_clock``), the numpy selection
        stream's bit-generator state (as JSON: PCG64 holds 128-bit
        integers), the history, the systems state and the ``FLConfig``
        fingerprint that ``restore`` checks."""
        from repro_torch.checkpoint.serializer import save_checkpoint
        from repro_torch.checkpoint.tracker import _to_builtin

        meta: dict[str, Any] = {
            "state_version": self._STATE_VERSION,
            "backend": self.backend,
            "round": int(self._round),
            "comm_mb": float(self.comm_mb),
            "sim_clock": float(self.sim_clock),
            "rng_state": json.dumps(self.rng.bit_generator.state),
            "history": _to_builtin(self.history),
            "config": self._config_fingerprint(),
        }
        if self._systems is not None:
            meta["systems"] = self._systems.state_dict()
        if self._population is not None:
            meta["population"] = self._population.state_dict()
        meta.update(self._extra_meta())
        save_checkpoint(path, self._state_pytree(), meta=meta)

    def _extra_meta(self) -> dict:
        """Extra JSON meta of an execution mode or backend (the async
        runtime's ledger structure, the compiled backend's last
        quantization error); the base's is the fault axis's health ledger,
        so a run killed mid-quarantine resumes bit-identically."""
        meta: dict[str, Any] = {}
        if self._faults is not None:
            meta["faults"] = self._faults.meta_state()
        return meta

    def restore(self, path: str) -> dict:
        """Install a checkpoint written by ``save``.  The engine must be
        freshly built from the *same* ``FLConfig`` (its fingerprint is
        compared; a mismatch is rejected — resuming into another config
        would silently change the experiment).  Returns the meta."""
        from repro_torch.checkpoint.serializer import load_checkpoint

        state, meta = load_checkpoint(path, like=self._state_pytree(), device=self.device)
        if meta.get("state_version") != self._STATE_VERSION:
            raise ValueError(
                f"engine checkpoint state_version {meta.get('state_version')!r} unsupported "
                f"(expected {self._STATE_VERSION}) — was {path!r} written by Engine.save?"
            )
        want, got = self._config_fingerprint(), meta.get("config") or {}
        if got != want:
            diff = [k for k in sorted(set(want) | set(got)) if got.get(k) != want.get(k)]
            raise ValueError(
                f"checkpoint config does not match this engine's FLConfig (differing "
                f"fields: {diff}) — resuming would change the experiment; rebuild the "
                f"engine with the original config"
            )
        self._install_state(state, meta)
        return meta

    def _install_state(self, state: dict, meta: dict) -> None:
        """Install a verified checkpoint's arrays and scalar carry (split
        from ``restore`` so execution modes extend it: the async runtime
        adds its in-flight ledger).  Tensors are new, so nothing that held
        the old ones (a fused engine's captured graphs copy ``params`` in
        at each chunk) sees a change."""
        self.params = state["params"]
        self.agg_state = state["agg_state"]
        self.h_clients = state["h_clients"]
        if "draws" in state:
            self.draws.load_state(state["draws"])
        self.strategy.load_state_dict(state["strategy"])
        self._round = int(meta["round"])
        self.comm_mb = float(meta["comm_mb"])
        self.sim_clock = float(meta["sim_clock"])
        self.rng.bit_generator.state = json.loads(meta["rng_state"])
        self.history = {k: list(v) for k, v in meta["history"].items()}
        if self._systems is not None:
            self._systems.load_state_dict(meta.get("systems", {}))
        if self._faults is not None:
            self._faults.load_meta_state(meta["faults"])
            if self._faults.has_stale:
                self._faults.load_stale_state(state["fault_stale"])
        if self._population is not None:
            self._population.load_state_dict(meta["population"])

    # -- the admission gate (systems availability, fault quarantine) ----
    def _selection_gate(self, rnd: int) -> np.ndarray | None:
        """(K,) bool admission gate for round ``rnd`` — systems
        availability ∧ fault-ledger health; ``None`` when ungated."""
        gate: np.ndarray | None = None
        if self._systems is not None:
            gate = np.asarray(self._systems.available(rnd), bool)
        if self._faults is not None:
            admit = self._faults.health.admitted(rnd)
            gate = admit if gate is None else gate & admit
        return gate

    def _gated_losses(self, rnd: int, losses: np.ndarray,
                      extra_gate: np.ndarray | None = None) -> np.ndarray:
        """The admission gate applied to the polled losses as ``-inf`` —
        the one place where offline or quarantined clients leave
        selection.  ``extra_gate`` is a caller's AND (the async runtime's
        not-in-flight mask)."""
        gate = self._selection_gate(rnd)
        if extra_gate is not None:
            gate = extra_gate if gate is None else gate & extra_gate
        if gate is None:
            return losses
        return np.where(gate, losses, -np.inf).astype(np.float32)

    def _aggregate_state(self, sel: np.ndarray) -> tuple:
        """What ``aggregate`` changes, for the optimistic aggregation's
        undo: ``params`` and ``agg_state`` are rebound (their old tensors
        are a complete snapshot), FedDyn's per-client rows are written in
        place (copied here)."""
        h_rows = None
        if self.client_mode.needs_h:
            h_rows = self.h_clients[torch.as_tensor(sel, device=self.device)].clone()
        return self.params, self.agg_state, sel, h_rows

    def _restore_aggregate_state(self, saved: tuple) -> None:
        self.params, self.agg_state, sel, h_rows = saved
        if h_rows is not None:
            self.h_clients[torch.as_tensor(sel, device=self.device)] = h_rows

    def _begin_population_round(self, rnd: int) -> np.ndarray | None:
        """Pick round ``rnd``'s resident shards (they bound what is polled
        and gathered) and return the (K,) resident mask; ``None`` without
        a population."""
        if self._population is None:
            return None
        _, self._pop_members = self._population.begin_round(rnd)
        return self._population.resident_mask()

    # -- the canonical round loop --------------------------------------
    def _round_step(self, rnd: int) -> _Step:
        """One round through the hooks, with the reference's systems, fault
        and population seams: the resident shards before the poll, their
        raw polled losses into the shard estimates, the gate (offline,
        quarantined and non-resident clients) before selection, the
        deadline outcome of the dispatched cohort, injection and the
        validation gate on the arrived uploads, and an optimistic
        aggregation that is redone over the true survivors on a round
        whose gate flags someone."""
        resident = self._begin_population_round(rnd)
        losses = self.poll_losses(rnd)
        if self._population is not None:
            self._population.observe(losses)
        losses = self._gated_losses(rnd, losses, extra_gate=resident)
        sel = np.asarray(self.select(rnd, losses))
        payload, sel_losses = self.local_train(rnd, sel)
        if self._systems is None and self._faults is None:
            self.aggregate(rnd, sel, payload)
            return _Step(sel, sel, sel_losses, len(sel))
        surv, n_reached, sim_time, n_dropped = sel, len(sel), 0.0, 0
        if self._systems is not None:
            out = self._systems.outcome(rnd, sel)
            surv, n_reached = out.survivors, out.n_reached
            sim_time, n_dropped = out.sim_time, out.n_dropped
        uploaded, n_faulty, n_quarantined = float(len(surv)), 0, 0
        if self._faults is not None:
            # quarantined clients picked anyway (loss-blind strategies) are
            # dropped like stragglers, before their update reaches the server
            surv = np.asarray(surv, np.int64)
            surv = surv[self._faults.health.admitted(rnd)[surv]]
            arrived = np.isin(sel, surv)
            injected, pending = self._faults.process_begin(rnd, sel, arrived, payload[0],
                                                           self.params)
            payload = (injected,) + tuple(payload[1:])
            # aggregate as if the gate flags nobody (true on honest rounds),
            # so the aggregation is queued before the verdict is read; on a
            # flagged round, undo and redo over the true survivors
            optimistic = sel[arrived]
            saved = self._aggregate_state(sel)
            self.aggregate(rnd, sel, payload, survivors=optimistic)
            info = self._faults.process_finish(pending)
            surv = info.survivors
            if len(surv) != len(optimistic):
                self._restore_aggregate_state(saved)
                self.aggregate(rnd, sel, payload, survivors=surv)
            uploaded, n_faulty, n_quarantined = info.uploaded, info.n_faulty, info.n_quarantined
        else:
            self.aggregate(rnd, sel, payload, survivors=surv)
        keep = np.isin(sel, surv)  # the server observes the survivors' losses only
        return _Step(sel, np.asarray(surv, np.int64), np.asarray(sel_losses)[keep], n_reached,
                     uploaded, sim_time, n_dropped, n_faulty, n_quarantined)

    def _finish_round(self, rnd: int, step: _Step) -> RoundResult:
        """Bill round ``rnd``, advance the simulated clock and the battery
        ledger, evaluate the round when due and commit it (``_round``)."""
        cfg = self.cfg
        # a population polls only the resident members: the rest are free
        n_polled = None if self._pop_members is None else len(self._pop_members)
        if step.uploaded is None:
            self.comm_mb += self.comm.round_mb(len(step.dispatched), self.strategy.needs_losses,
                                               n_polled=n_polled)
        else:
            self.comm_mb += self.comm.round_mb(step.n_reached, self.strategy.needs_losses,
                                               m_uploaded=step.uploaded, n_polled=n_polled)
        if self._systems is not None:
            self.sim_clock += step.sim_time
        energy = None
        if self._systems is not None and self._systems.tracks_energy:
            energy = self._systems.spend_energy(rnd, step.dispatched)
        test_loss = test_acc = metrics = None
        # absolute cadence keyed to the configured terminal round, so
        # chunked rounds() calls evaluate on one contiguous schedule
        if rnd % cfg.eval_every == 0 or rnd == cfg.rounds - 1:
            test_loss, test_acc = self.evaluate()
            metrics = self.eval_metrics()
        if energy is not None:
            metrics = {**(metrics or {}), **energy}
        self._round = rnd + 1
        result = RoundResult(
            round=rnd,
            selected=tuple(int(i) for i in step.survivors),
            mean_selected_loss=_mean_loss(step.losses),
            comm_mb=float(self.comm_mb),
            test_loss=test_loss,
            test_acc=test_acc,
            sim_time=float(step.sim_time),
            sim_clock=float(self.sim_clock),
            n_dropped=int(step.n_dropped),
            metrics=metrics,
            params_version=rnd + 1,
            n_faulty=int(step.n_faulty),
            n_quarantined=int(step.n_quarantined),
        )
        return result

    def rounds(
        self,
        n_rounds: int | None = None,
        callback: Callable[[RoundResult], None] | None = None,
    ) -> Iterator[RoundResult]:
        """Stream ``RoundResult`` records, one per federated round.

        ``n_rounds=None`` runs the rounds remaining to reach
        ``cfg.rounds``; pass an explicit count to run chunks."""
        if n_rounds is None:
            n_rounds = max(self.cfg.rounds - self._round, 0)
        start = self._round
        for rnd in range(start, start + n_rounds):
            result = self._finish_round(rnd, self._round_step(rnd))
            self._emit(result, callback)
            yield result

    def run(self, rounds: int | None = None, log_every: int = 0) -> dict[str, list]:
        """Drain ``rounds()`` and return the history dict (evaluated
        rounds only)."""
        for r in self.rounds(rounds):
            if r.evaluated and log_every and (r.round % log_every == 0):
                print(
                    f"[{self.cfg.strategy}] round {r.round:4d} "
                    f"acc={r.test_acc:.4f} loss={r.test_loss:.4f} "
                    f"comm={r.comm_mb:.1f}MB"
                )
        return self.history


class MaskSelectionMixin:  # tracecheck: disable=capability-flags (an engine's hook)
    """Selection of the mask-gated backends: the strategy's ``select_mask``
    on the polled losses, any randomness drawn from ``self.rng``, the same
    numpy stream ``HostEngine`` consumes, so a host run and a compiled run
    of one config select in lockstep.  ``_check_mask_backend`` repeats
    ``FLConfig``'s checks at engine build (for hand-built or mutated
    configs)."""

    # backends whose aggregation is the weighted sum itself (scaleout) run
    # fedavg only
    requires_fedavg_aggregator = False

    def _check_mask_backend(self) -> None:
        if not getattr(self.strategy, "supports_compiled_selection", False):
            raise ValueError(mask_backend_strategy_error(self.cfg.strategy, self.backend))
        if self.cfg.client_mode != "plain":
            raise ValueError(mask_backend_client_mode_error(self.cfg.client_mode, self.backend))
        if self.requires_fedavg_aggregator and self.cfg.aggregator != "fedavg":
            raise ValueError(mask_backend_aggregator_error(self.cfg.aggregator))

    def select_mask(self, rnd: int, losses: torch.Tensor) -> torch.Tensor:
        """(K,) bool participation mask on the device."""
        return self.strategy.select_mask(losses, self.rng)

    def select(self, rnd: int, losses: np.ndarray) -> np.ndarray:
        """Sorted indices of the mask ``select_mask`` draws on ``losses``."""
        mask = self.select_mask(rnd, torch.as_tensor(losses, device=self.device))
        return np.flatnonzero(mask.cpu().numpy())


def rounds_to_accuracy(history: dict[str, list], target: float) -> int | None:
    """First evaluated round reaching ``target`` test accuracy (the paper's
    rounds-to-accuracy comparison); None if never reached."""
    for rnd, acc in zip(history["round"], history["test_acc"]):
        if acc >= target:
            return rnd
    return None
