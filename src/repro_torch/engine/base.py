"""The federated engine's shared state and round protocol, ported from
``repro.engine.base`` (this slice: the lock-step loop with no systems,
faults, population, async or checkpoint seams — ``FLConfig`` rejects
those axes up front).

``Engine`` owns the non-IID partition, the packed client tensors on the
device, the selection strategy, the aggregator, the client mode (with
FedDyn's (K, P) per-client state) and the comm ledger, and
drives one canonical round loop:

    poll_losses → select → local_train → aggregate → evaluate

``HostEngine`` (``repro_torch.engine.host``) implements ``select`` /
``local_train`` / ``aggregate``; ``CompiledEngine``
(``repro_torch.engine.compiled``) replaces the whole round step with one
on the device, its selection a mask (``MaskSelectionMixin``), and
``FusedEngine`` (``repro_torch.engine.fused``) runs chunks of such rounds
with no host read between them.  ``rounds()`` yields one frozen
``RoundResult`` per round; ``run()`` drains it into the history dict.
Every random draw goes through ``self.draws``
(``repro_torch.engine.draws``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterator

import numpy as np
import torch

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
    - ``metrics``            — the task's extra held-out metrics on
      evaluated rounds (the LM task's ``ppl`` and ``ppl_per_cluster``);
      ``None`` otherwise.
    - ``params_version``     — server params version after this round.
    """

    round: int
    selected: tuple[int, ...]
    mean_selected_loss: float
    comm_mb: float
    test_loss: float | None = None
    test_acc: float | None = None
    metrics: dict | None = None
    params_version: int = 0

    @property
    def evaluated(self) -> bool:
        return self.test_acc is not None


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
        self.xs = torch.from_numpy(xs).to(self.device)
        self.ys = torch.from_numpy(ys).to(self.device)
        # Row-sampling probabilities per client (validity mask normalized),
        # kept on the host; the draws build their row table from them once.
        mask_t = torch.from_numpy(mask)
        self.sample_probs = mask_t / torch.clamp(mask_t.sum(-1, keepdim=True), min=1e-9)
        if hasattr(self.draws, "bind_rows"):
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

        # --- pluggable components, via the registries ---
        self.strategy = STRATEGY_REGISTRY.build(cfg.strategy, m=cfg.m, **cfg.strategy_kwargs)
        self.strategy.setup(self.hists, self.sizes, seed=cfg.seed, device=self.device)
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

        self._apply_fn, self._loss_fn, self._metric_fn = self.task.build_fns(train, n_classes)
        self._eval_extra = self.task.build_eval_extra(test, n_classes)
        self._round = 0
        self.history: dict[str, list] = {
            "round": [], "test_acc": [], "test_loss": [], "comm_mb": [],
            "mean_selected_loss": [], "selected": [],
        }

    # -- hooks (backend contract) --------------------------------------
    def poll_losses(self, rnd: int) -> np.ndarray:
        """(K,) subsampled local empirical loss of the *global* model on
        every client (Algorithm 1 lines 2–4); zeros when the strategy
        never polls."""
        if not self.strategy.needs_losses:
            return np.zeros(self.cfg.n_clients, np.float32)
        idx = self.draws.poll_indices(rnd, self.sample_probs, self.cfg.eval_samples)
        return self._poll(self.params, idx).cpu().numpy()

    def _poll(self, params: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """(K,) losses of ``params`` on each client's (K, n) sampled rows
        ``idx``, on the device."""
        rows = torch.arange(self.cfg.n_clients, device=self.device)[:, None]
        with torch.no_grad():
            out = self._apply_fn(params, self.xs[rows, idx])
            return self._loss_fn(out, self.ys[rows, idx], None)

    def select(self, rnd: int, losses: np.ndarray) -> np.ndarray:
        """Sorted indices of this round's participants."""
        raise NotImplementedError

    def local_train(self, rnd: int, sel: np.ndarray):
        """Run local training.  Returns ``(payload, sel_losses)``:
        ``payload`` is threaded into ``aggregate``, ``sel_losses`` is a
        (len(sel),) array of local training losses."""
        raise NotImplementedError

    def aggregate(self, rnd: int, sel: np.ndarray, payload) -> None:
        """Fold the payload into ``self.params`` (and any server state)."""
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
        for k, v in (r.metrics or {}).items():
            self.history.setdefault(k, []).append(v)

    # -- the canonical round loop --------------------------------------
    def _round_step(self, rnd: int) -> tuple[np.ndarray, np.ndarray]:
        """One round through the hooks; returns the sorted participants and
        their local training losses."""
        losses = self.poll_losses(rnd)
        sel = np.asarray(self.select(rnd, losses))
        payload, sel_losses = self.local_train(rnd, sel)
        self.aggregate(rnd, sel, payload)
        return sel, sel_losses  # the (m, P) payload is freed here, before evaluation

    def _finish_round(self, rnd: int, sel: np.ndarray, sel_losses) -> RoundResult:
        """Bill round ``rnd``, evaluate it when due and record it."""
        cfg = self.cfg
        self.comm_mb += self.comm.round_mb(len(sel), self.strategy.needs_losses)
        test_loss = test_acc = metrics = None
        # absolute cadence keyed to the configured terminal round, so
        # chunked rounds() calls evaluate on one contiguous schedule
        if rnd % cfg.eval_every == 0 or rnd == cfg.rounds - 1:
            test_loss, test_acc = self.evaluate()
            metrics = self.eval_metrics()
        self._round = rnd + 1
        result = RoundResult(
            round=rnd,
            selected=tuple(int(i) for i in sel),
            mean_selected_loss=_mean_loss(sel_losses),
            comm_mb=float(self.comm_mb),
            test_loss=test_loss,
            test_acc=test_acc,
            metrics=metrics,
            params_version=rnd + 1,
        )
        self._record_history(result)
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
            result = self._finish_round(rnd, *self._round_step(rnd))
            if callback is not None:
                callback(result)
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


class MaskSelectionMixin:
    """Selection of the mask-gated backends: the strategy's ``select_mask``
    on the polled losses, any randomness drawn from ``self.rng``, the same
    numpy stream ``HostEngine`` consumes, so a host run and a compiled run
    of one config select in lockstep.  ``_check_mask_backend`` repeats
    ``FLConfig``'s checks at engine build (for hand-built or mutated
    configs)."""

    def _check_mask_backend(self) -> None:
        if not getattr(self.strategy, "supports_compiled_selection", False):
            raise ValueError(mask_backend_strategy_error(self.cfg.strategy, self.backend))
        if self.cfg.client_mode != "plain":
            raise ValueError(mask_backend_client_mode_error(self.cfg.client_mode, self.backend))

    def select_mask(self, rnd: int, losses: torch.Tensor) -> torch.Tensor:
        """(K,) bool participation mask on the device."""
        return self.strategy.select_mask(losses, self.rng)


def rounds_to_accuracy(history: dict[str, list], target: float) -> int | None:
    """First evaluated round reaching ``target`` test accuracy (the paper's
    rounds-to-accuracy comparison); None if never reached."""
    for rnd, acc in zip(history["round"], history["test_acc"]):
        if acc >= target:
            return rnd
    return None
