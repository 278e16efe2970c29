"""HostEngine — the paper-faithful simulation backend, ported from
``repro.engine.host``.

Selection is host-side numpy (K scalars per round); local training runs
the selected cohort as one (m, P) tensor on the engine's device (with a
population, its rows gathered from the host store)
(``repro_torch.federated.client.local_train``); aggregation reduces that
tensor with the registered aggregator (FedAvg, FedNova, FedDyn: one
launch of the FedAvg reduce kernel on the card), over the survivors'
rows when the systems or fault axis dropped someone.  Under FedDyn's client
mode the cohort's rows of the (K, P) ``h_clients`` go to local training
and come back updated against the *new* global params, as in the
reference's ``HostEngine.aggregate``.  The backend carries nothing from
round to round beyond the base's checkpointed state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.engine.base import Engine
from repro_torch.federated.client import local_train

__all__ = ["HostEngine"]


class HostEngine(Engine):
    backend = "host"

    def select(self, rnd: int, losses: np.ndarray) -> np.ndarray:
        return self.strategy.select(rnd, losses, self.rng)

    def local_train(self, d: int, sel: np.ndarray):
        sel_t = torch.as_tensor(sel, device=self.device)
        bidx = self.draws.batch_indices(
            d, sel, self.sample_probs[torch.as_tensor(sel)], self.max_steps,
            self.cfg.batch_size,
        )
        h_sel = self.h_clients[sel_t] if self.client_mode.needs_h else None
        if self._store is not None:
            # a population's cohort rows come from the host store
            xs, ys, _ = self._store.gather(sel)
        else:
            xs, ys = self.xs[sel_t], self.ys[sel_t]
        stacked, local_losses = local_train(
            self._apply_fn, self._loss_fn, self.params, xs, ys, bidx,
            torch.as_tensor(self.taus[sel], device=self.device),
            lr=self.cfg.lr, max_steps=self.max_steps,
            mode=self.cfg.client_mode, mu=self.cfg.mu, h_state=h_sel,
        )
        return (stacked, h_sel), local_losses.cpu().numpy()

    def aggregate(self, rnd: int, sel: np.ndarray, payload,
                  survivors: np.ndarray | None = None) -> None:
        stacked, h_sel = payload
        if survivors is not None and len(survivors) != len(sel):
            # only the surviving uploads reach the server: reduce their rows,
            # reweighted over them (the dropped clients trained, but nothing
            # arrived); nobody uploaded — the global model stands still
            if len(survivors) == 0:
                return
            keep = np.flatnonzero(np.isin(sel, survivors))
            rows = torch.as_tensor(keep, device=self.device)
            stacked = stacked[rows]
            h_sel = None if h_sel is None else h_sel[rows]
            sel = np.asarray(sel)[keep]
        w = self.sizes[sel] / self.sizes[sel].sum()
        w_t = torch.as_tensor(w, dtype=torch.float32, device=self.device)
        taus_t = torch.as_tensor(self.taus[sel], dtype=torch.float32, device=self.device)
        new_params = self.aggregator.aggregate(
            stacked, self.params, w_t, taus_t, self.agg_state, n_selected=len(sel)
        )
        self.agg_state = self.aggregator.update_state(
            self.agg_state, stacked, self.params, w_t, n_selected=len(sel)
        )
        self.params = new_params
        if self.client_mode.needs_h:
            h_new = self.client_mode.update_client_state(h_sel, stacked, self.params, self.cfg.mu)
            self.h_clients[torch.as_tensor(sel, device=self.device)] = h_new
