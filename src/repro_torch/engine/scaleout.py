"""ScaleoutEngine — the pod round behind the engine protocol, ported from
``repro.engine.scaleout``.

The K clients are blocked over the pods of a ``repro_torch.launch.mesh.
Mesh`` (K / pods clients a pod), and each process trains the clients of
its block of pods, every client every round from its own draws, as the
compiled backend's ``cohort_gather=False`` path does.  On a grid (a
``data`` or ``model`` axis larger than 1) a process holds one pod, and
every data and model rank of the pod trains that pod's block alike, as
the reference leaves ``data`` and ``model`` to GSPMD inside its manual
``pod`` map.  Selection is the mask-gated backends'
(``MaskSelectionMixin``): the strategy's mask, its randomness from the
same numpy stream as the host backend's; every process draws the same
selection.  Aggregation is the FedAvg weights of the mask
(``selection_weights``; under a systems deadline, of the survivors only)
gating the sum: the FedAvg reduce kernel (K1) over the process's (block,
P) stack, then an ``all_reduce`` of the partial sums over ``pod`` (none
where the process holds every pod).  A round whose cohort was all dropped
keeps the old model.  The clients' training losses are gathered over
``pod``.

Since every client trains from draws keyed by client and zero-weight
clients add exact zeros, a round selects exactly as the ``host`` and
``compiled`` rounds do and lands within fp32 summation order of them.

The default mesh is the reference's: the largest pod count that divides
K and fits the devices, here the processes of the default process group
(one without one: this process holds every client).
``make_scaleout_round`` is the transformer round of
``repro_torch.federated.scaleout`` behind the engine API.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.selection import selection_weights
from repro_torch.engine.base import Engine, MaskSelectionMixin
from repro_torch.federated.client import local_train
from repro_torch.kernels.aggregate import masked_weighted_sum
from repro_torch.launch.mesh import make_host_mesh

__all__ = ["ScaleoutEngine", "make_scaleout_round"]


class ScaleoutEngine(MaskSelectionMixin, Engine):
    backend = "scaleout"
    requires_fedavg_aggregator = True  # aggregation is the weighted sum over pods

    def __init__(self, cfg, train, test, n_classes: int, *, mesh=None, device="cuda",
                 draws=None, partition_labels=None):
        super().__init__(cfg, train, test, n_classes, device=device, draws=draws,
                         partition_labels=partition_labels)
        self._check_mask_backend()
        self.mesh = mesh if mesh is not None else self._default_mesh(cfg.n_clients)
        if "pod" not in self.mesh.shape:
            raise ValueError(
                f"scaleout mesh must carry a 'pod' (client) axis; got axes "
                f"{tuple(self.mesh.shape)} — build it with make_host_mesh(pod=...) (with "
                f"data= or model=, a grid of one pod a process) or "
                f"make_production_mesh(multi_pod=True)"
            )
        self.n_pods = int(self.mesh.shape["pod"])
        if cfg.n_clients % self.n_pods:
            raise ValueError(
                f"n_clients={cfg.n_clients} must be divisible by the pod axis "
                f"({self.n_pods}) so clients block evenly over pods"
            )
        per_pod = cfg.n_clients // self.n_pods
        self._block = slice(self.mesh.pods.start * per_pod, self.mesh.pods.stop * per_pod)
        self._sizes_t = torch.as_tensor(self.sizes, dtype=torch.float32, device=self.device)
        self._taus_t = torch.as_tensor(self.taus, device=self.device)

    @staticmethod
    def _default_mesh(n_clients: int):
        """The largest pod axis that divides n_clients and fits the
        world's processes (1 in a single process)."""
        world = make_host_mesh().world
        return make_host_mesh(pod=max(p for p in range(1, world + 1) if n_clients % p == 0))

    # -- hooks (select comes from MaskSelectionMixin) --------------------
    def local_train(self, d: int, sel: np.ndarray):
        """Every client of this process's block trains from its rows of
        draw index ``d``.  Returns ``((block stack,), losses of sel)``, the
        losses gathered over ``pod``."""
        cfg, blk = self.cfg, self._block
        batch = self.draws.client_batch_indices(d, self.sample_probs, self.max_steps,
                                                cfg.batch_size)
        stacked, losses = local_train(
            self._apply_fn, self._loss_fn, self.params, self.xs[blk], self.ys[blk],
            batch[:, blk], self._taus_t[blk], lr=cfg.lr, max_steps=self.max_steps,
        )
        losses = self.mesh.all_gather(losses, "pod")
        return (stacked,), losses.cpu().numpy()[np.asarray(sel, np.int64)]

    def aggregate(self, rnd: int, sel: np.ndarray, payload,
                  survivors: np.ndarray | None = None) -> None:
        """The weighted sum over the pods: K1 over the block with the
        selection weights of ``sel`` (or of the ``survivors``), then the
        sum over ``pod``; nobody surviving keeps the old model."""
        if survivors is not None and len(survivors) == 0:
            return
        stacked = payload[0]
        weight_idx = sel if survivors is None else survivors
        mask = torch.zeros(self.cfg.n_clients, dtype=torch.bool, device=self.device)
        mask[torch.as_tensor(np.asarray(weight_idx, np.int64), device=self.device)] = True
        w = selection_weights(mask, self._sizes_t)[self._block].contiguous()
        self.params = self.mesh.all_reduce_sum(masked_weighted_sum(stacked, w), "pod").to(
            self.params.dtype)


def make_scaleout_round(model_cfg, mesh, lr: float, local_steps: int = 4,
                        compress_bits: int = 0):
    """The transformer round over the pods of ``mesh``: a thin wrapper
    over ``repro_torch.federated.scaleout.make_federated_round``."""
    from repro_torch.federated.scaleout import make_federated_round

    return make_federated_round(model_cfg, mesh, lr=lr, local_steps=local_steps,
                                compress_bits=compress_bits)
