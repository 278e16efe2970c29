"""The port's analog of ``repro.launch.mesh``: the federated ``pod`` axis
over ``torch.distributed`` processes.

The reference lays a TPU pod's chips out as (data, model) or (pod, data,
model) and uses the ``pod`` axis as the client axis of the scale-out
round.  The port has no tensor or data parallelism inside a client, so a
``Mesh`` here is only that client axis: ``pod`` pods blocked over the
processes of the default process group, each process holding ``pod /
world`` consecutive pods.  Without an initialised process
group the world is this one process, which holds every pod.  A
``data`` or ``model`` axis larger than 1 raises.

The collectives run on the process group as it was initialised: its
backend must be the one the tensors' device calls for (``backend_for``:
NCCL for CUDA tensors, gloo for CPU tensors), else they raise; the port
never swaps one for the other.  ``init_process_group`` is left to the
caller, with an explicit address, world size and rank (nothing on a
one-host machine announces a cluster).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

__all__ = ["Mesh", "backend_for", "make_host_mesh", "make_production_mesh"]

# the reference's production layouts: a 16 x 16 pod, and two of them
_PRODUCTION = {False: {"data": 16, "model": 16}, True: {"pod": 2, "data": 16, "model": 16}}


def backend_for(device: torch.device | str) -> str:
    """The process-group backend that tensors on ``device`` need."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


class Mesh:
    """``pod`` federated pods over the processes of the default process
    group (``group``; None without one, a world of this process alone).

    ``shape`` reads like the reference mesh's ({"pod": n} and the unit
    ``data`` and ``model`` axes; no ``pod`` key for a mesh without one);
    ``world`` and ``rank`` are the group's; ``pods`` is the range of pods
    this process holds."""

    def __init__(self, pod: int = 0):
        initialised = dist.is_available() and dist.is_initialized()
        self.group = dist.group.WORLD if initialised else None
        self.world = dist.get_world_size() if initialised else 1
        self.rank = dist.get_rank() if initialised else 0
        self.shape = ({"pod": pod} if pod else {}) | {"data": 1, "model": 1}
        if pod and pod % self.world:
            raise ValueError(f"a mesh of {pod} pods cannot be blocked evenly over a world of "
                             f"{self.world} processes")
        per = pod // self.world
        self.pods = range(self.rank * per, (self.rank + 1) * per)

    def _check(self, t: torch.Tensor) -> None:
        backend = dist.get_backend(self.group)
        if backend != backend_for(t.device):
            raise RuntimeError(
                f"the process group's backend is {backend!r} but {t.device.type} tensors need "
                f"{backend_for(t.device)!r}; initialise the group for the tensors' device")

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the processes, in place (``t`` itself in a
        world of one)."""
        if self.world > 1:
            self._check(t)
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Each process's ``t`` (n, ...) concatenated in rank order on
        axis 0 (``t`` itself in a world of one)."""
        if self.world == 1:
            return t
        self._check(t)
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts)


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0) -> Mesh:
    """A mesh of ``pod`` pods (none for ``pod=0``) over the processes of
    the default process group (or this process alone)."""
    if data != 1 or model != 1:
        raise ValueError(f"repro_torch's mesh has no data or model axis larger than 1 (got "
                         f"data={data}, model={model}): the port has no tensor or data "
                         f"parallelism inside a client; use pod= for the client axis")
    return Mesh(pod)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production layout (data 16 x model 16, and pod 2
    with ``multi_pod``), which needs that many devices and a model axis:
    raises where the world has fewer devices, and else for the model axis
    the port lacks."""
    shape = _PRODUCTION[multi_pod]
    need = math.prod(shape.values())
    have = Mesh().world
    if have < need:
        raise RuntimeError(f"the production mesh {shape} names {need} devices; this world has "
                           f"{have} process(es), one device each")
    return make_host_mesh(**shape)
