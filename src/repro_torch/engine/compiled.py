"""CompiledEngine — the mask-gated round on the device, ported from
``repro.engine.compiled``.

Selection enters the round as a weight vector: the strategy's
``select_mask`` gives a (K,) participation mask on the device, and
``selection_weights`` turns it into FedAvg weights that are zero outside
it.  Since m is static, ``cohort_indices`` gives the cohort's (m,) client
indices with no host read; the round gathers their data and minibatch
rows (``draws.client_batch_indices``, drawn for every client, so a
client's rows do not depend on the cohort it is in), trains just those m
clients and aggregates the cohort with the cohort slice of the weights:
one launch of the FedAvg reduce kernel (K1) for ``fedavg``, ``fednova``
and ``feddyn``, the sorts for ``trimmed_mean`` and ``coordinate_median``.
``cohort_gather=False`` keeps the legacy path: every client trains and
K1 reduces the (K, P) stack with zero weights outside the mask.

The whole round — poll, selection, training, aggregation — is queued on
the device with no host read; the mask and the cohort's losses are read
once, at its end.  ``FusedEngine`` (``repro_torch.engine.fused``) runs
the same round body chunk after chunk.

``compress_bits > 0`` replaces fedavg with ``compressed_fedavg``
(``repro_torch.federated.compression``): the cohort's deltas are
quantized with stochastic rounding in the cohort's own buffer and
reduced with one K1 launch; ``last_quant_error`` reports the last
round's mean quantization error.

As in the reference, the strategy must have a mask selection
(``supports_compiled_selection``) and ``client_mode`` must be
``"plain"``; ``FLConfig`` rejects anything else up front and the engine
checks again.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.convert import leaf_segments
from repro_torch.core.selection import cohort_indices, selection_weights
from repro_torch.engine.base import Engine, MaskSelectionMixin
from repro_torch.federated.client import local_train
from repro_torch.federated.compression import compressed_fedavg

__all__ = ["CompiledEngine"]


class CompiledEngine(MaskSelectionMixin, Engine):
    backend = "compiled"

    def __init__(self, cfg, train, test, n_classes: int, *, device="cuda", draws=None,
                 partition_labels=None, cohort_gather: bool = True):
        super().__init__(cfg, train, test, n_classes, device=device, draws=draws,
                         partition_labels=partition_labels)
        self._check_mask_backend()
        self.cohort_gather = bool(cohort_gather)
        self._sizes_t = torch.as_tensor(self.sizes, dtype=torch.float32, device=self.device)
        self._taus_t = torch.as_tensor(self.taus, device=self.device)
        self._leaves = (leaf_segments(self.task.layout(train, n_classes))
                        if cfg.compress_bits else None)
        self._quant_error: torch.Tensor | None = None

    @property
    def last_quant_error(self) -> float | None:
        """Mean |dequantized − exact delta| of the last compressed round
        (None before one, and without ``compress_bits``)."""
        return None if self._quant_error is None else float(self._quant_error)

    # -- the round on the device ---------------------------------------
    def _draw_round(self, rnd: int, noise: bool = False) -> dict:
        """Round ``rnd``'s draws, in order: the poll's rows (when the
        strategy polls), every client's minibatch rows and, for a fused
        round, the strategy's selection noise."""
        cfg = self.cfg
        out = {"poll": None, "noise": ()}
        if self.strategy.needs_losses:
            out["poll"] = self.draws.poll_indices(rnd, self.sample_probs, cfg.eval_samples)
        out["batch"] = self.draws.client_batch_indices(rnd, self.sample_probs, self.max_steps,
                                                       cfg.batch_size)
        if noise:
            out["noise"] = self.draws.selection_noise(
                rnd, self.strategy.traced_noise, cfg.n_clients,
                getattr(self.strategy, "n_clusters", 0))
        return out

    def _device_round(self, rnd: int, params: torch.Tensor, poll: torch.Tensor | None,
                      batch: torch.Tensor,
                      select: Callable[[torch.Tensor], torch.Tensor]):
        """One round with no host read (unless ``select`` makes one):
        returns (new params, (K,) mask, (m,) cohort training losses)."""
        cfg = self.cfg
        if poll is not None:
            losses = self._poll(params, poll)
        else:
            losses = torch.zeros(cfg.n_clients, dtype=torch.float32, device=self.device)
        mask = select(losses)
        idx = cohort_indices(mask, cfg.m)
        if self.cohort_gather:
            xs, ys, rows, taus = self.xs[idx], self.ys[idx], batch[:, idx], self._taus_t[idx]
        else:
            xs, ys, rows, taus = self.xs, self.ys, batch, self._taus_t
        stacked, train_losses = local_train(
            self._apply_fn, self._loss_fn, params, xs, ys, rows, taus,
            lr=cfg.lr, max_steps=self.max_steps,
        )
        new = self._aggregate(rnd, params, stacked, selection_weights(mask, self._sizes_t), idx)
        return new, mask, (train_losses if self.cohort_gather else train_losses[idx])

    def _aggregate(self, rnd: int, params: torch.Tensor, stacked: torch.Tensor,
                   w_full: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.compress_bits:
            # quantization models the cohort's upload: reduce the m rows
            cohort = stacked if self.cohort_gather else stacked[idx]
            new, self._quant_error = compressed_fedavg(
                cohort, params, w_full[idx],
                lambda start, stop: self.draws.quant_uniforms(rnd, cohort.shape[0], start, stop),
                self._leaves, bits=cfg.compress_bits,
            )
            return new
        if self.cohort_gather:
            w, taus = w_full[idx], self._taus_t[idx]
        else:
            w, taus = w_full, self._taus_t
        taus = taus.to(torch.float32)
        new = self.aggregator.aggregate(stacked, params, w, taus, self.agg_state,
                                        n_selected=cfg.m)
        self.agg_state = self.aggregator.update_state(self.agg_state, stacked, params, w,
                                                      n_selected=cfg.m)
        return new

    def _round_step(self, rnd: int) -> tuple[np.ndarray, np.ndarray]:
        d = self._draw_round(rnd)
        self.params, mask, sel_losses = self._device_round(
            rnd, self.params, d["poll"], d["batch"], lambda losses: self.select_mask(rnd, losses))
        sel = np.flatnonzero(mask.cpu().numpy())
        return sel, sel_losses.cpu().numpy()[: len(sel)]  # the cohort's selected rows come first
