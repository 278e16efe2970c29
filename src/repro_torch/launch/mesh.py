"""The port's analog of ``repro.launch.mesh``: the ``pod``, ``data`` and
``model`` axes over ``torch.distributed`` processes.

The reference lays a TPU pod's chips out as (data, model) or (pod, data,
model); the ``pod`` axis is the client axis of the scale-out round, and
the MoE's expert parallelism (``models.transformer._run_moe``) reduces
over all axes, over ``model``, or over the data axes (every axis but
``model``).  A ``Mesh`` here is one of two layouts:

- **a grid** (``data`` or ``model`` larger than 1): the world has exactly
  pod x data x model processes (pod counted as 1 without a ``pod`` axis),
  one device each, and rank r sits at the coordinates of r in row-major
  order over ("pod", "data", "model"), as ``jax.make_mesh`` lays out host
  devices.  One process subgroup is made for each combination of axes
  that the MoE, the sharded layers and the scale-out round reduce over
  (all axes, ``model``, the data axes, ``pod``, and with a ``pod`` axis
  ``data``, the data axis inside one pod); every rank makes
  every group, in the same order, as ``dist.new_group`` requires.  The
  scale-out round runs on a grid one pod a process row: the data and
  model ranks of a pod train that pod's replica (``in_pod``: the mesh as
  the round's body sees it, manual over ``pod``), and the round sums over
  ``pod`` at a fixed (data, model) coordinate.
- **pods blocked over the world** (``data = model = 1``): ``pod`` pods over
  the processes of the default process group, each process holding
  ``pod / world`` consecutive pods (the world may be smaller than
  ``pod``).  Only the ``pod`` axis spans processes; a reduction over axes
  without it is the identity.

Without an initialised process group the world is this one process: a
grid of one device (``data = model = 1``, the card's), or every pod.

The collectives run on the process group as it was initialised: its
backend must be one the tensors' device can use (``backend_for``: NCCL
for CUDA tensors, gloo for CPU tensors; gloo also takes CUDA tensors,
where the caller initialised gloo, e.g. for several processes on one
card, which NCCL refuses), else they raise; the port never swaps one
for the other.  ``init_process_group`` is left to the
caller, with an explicit address, world size and rank (nothing on a
one-host machine announces a cluster).

A **dry** mesh (``make_dry_mesh``, ``make_production_mesh(dry=True)``) is
rank 0 of a world of pod x data x model processes (``pod`` of them for a
mesh of pods) that is not there: no process group, the axes, coordinates
and subgroups that rank 0 would have.  Its collectives take ``meta``
tensors only (the dry run, ``repro_torch.launch.dryrun``): each returns
the shape it would return.  A dry and a real group alike add each
collective's result bytes to the active work tallies
(``kernels.build.work_tally``) under the reference's kind names, as the
reference's dry run counts them (the result's size: for an all-reduce
the reduced tensor, for an all-gather the gathered one, for an all-to-all
the rows this rank receives), forward and,
for ``grad_sum``, backward: a card's run is counted as its prediction.

The reductions carry gradients so that each rank's backward ends with
the gradient of what it holds: ``all_reduce_sum`` (the ``psum`` of
partial outputs: the cotangent, replicated, passes to each rank's part
unchanged), ``all_reduce_mean`` (the ``pmean``), ``all_gather`` (each
rank's piece takes its slice of the cotangent) and ``grad_sum`` (the
identity forward, whose backward sums the partial gradients of a
replicated value that each rank used for its own part) and
``all_to_all`` (each rank's rows sent to the ranks that asked for them;
backward, each row's gradient sent back to the rank it came from).
``all_reduce_max`` takes no gradient (the cross-entropy's row maximum, a
shift that cancels).
"""

from __future__ import annotations

import copy
import math

import torch
import torch.distributed as dist

from repro_torch.kernels.build import tally_collective

__all__ = ["Mesh", "backend_for", "make_host_mesh", "make_dry_mesh", "make_production_mesh"]

# the reference's production layouts: a 16 x 16 pod, and two of them
_PRODUCTION = {False: {"data": 16, "model": 16}, True: {"pod": 2, "data": 16, "model": 16}}


class _DryGroup:
    """The process group over some axes of a dry mesh: its size and this
    rank's index in it."""

    def __init__(self, size: int, rank: int):
        self.size, self.rank = size, rank


def _group_size(group) -> int:
    return group.size if isinstance(group, _DryGroup) else dist.get_world_size(group)


def _group_rank(group) -> int:
    return group.rank if isinstance(group, _DryGroup) else dist.get_rank(group)


def _all_reduce(t: torch.Tensor, group, op=None) -> None:
    """Sum ``t`` (or its ``op``) over ``group`` in place, its bytes tallied
    (a dry group: only tallied)."""
    tally_collective("all-reduce", t.numel() * t.element_size())
    if not isinstance(group, _DryGroup):
        dist.all_reduce(t, op=op or dist.ReduceOp.SUM, group=group)


def backend_for(device: torch.device | str) -> str:
    """The process-group backend that tensors on ``device`` need."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


class Mesh:
    """The (pod, data, model) axes over the processes of the default
    process group (``group``; None without one, a world of this process
    alone).

    ``shape`` reads like the reference mesh's ({"pod": n} when there is a
    pod axis, then "data" and "model"), ``axis_names`` are its keys;
    ``world`` and ``rank`` are the group's; ``pods`` is the range of pods
    this process holds; ``coords`` the rank's index on each axis (None for
    pods blocked several to a process)."""

    def __init__(self, pod: int = 0, data: int = 1, model: int = 1, dry: bool = False):
        initialised = not dry and dist.is_available() and dist.is_initialized()
        self.dry = dry
        self.shape = ({"pod": pod} if pod else {}) | {"data": data, "model": model}
        self.axis_names = tuple(self.shape)
        self.group = dist.group.WORLD if initialised else None
        self.world = self.size() if dry else dist.get_world_size() if initialised else 1
        self.rank = dist.get_rank() if initialised else 0
        if dry and self.world > 1:
            self.group = _DryGroup(self.world, 0)
        self.grid = data * model > 1
        self._groups: dict[frozenset, object] = {}
        if self.grid:
            if self.world != self.size():
                raise ValueError(f"a mesh of {self.shape} names {self.size()} processes, one "
                                 f"device each; this world has {self.world}")
            self.coords = self._coords_of(self.rank)
            at = self.coords.get("pod", 0)
            self.pods = range(at, at + 1) if pod else range(0)
            self._make_groups()
            return
        if pod and pod % self.world:
            raise ValueError(f"a mesh of {pod} pods cannot be blocked evenly over a world of "
                             f"{self.world} processes")
        per = pod // self.world
        self.pods = range(self.rank * per, (self.rank + 1) * per)
        # one pod a process, or none (each process its own one-device mesh)
        self.coords = None if per > 1 else self._coords_of(self.rank * per)

    # -- axes and groups ----------------------------------------------------

    def _axes(self, axes) -> tuple[str, ...]:
        if axes is None:
            return self.axis_names
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"axes {unknown} are not on the mesh {self.shape}")
        return axes

    def _coords_of(self, rank: int) -> dict[str, int]:
        """``rank``'s index on each axis, row-major over ``axis_names``."""
        coords = {}
        for name in reversed(self.axis_names):
            rank, coords[name] = divmod(rank, self.shape[name])
        return {name: coords[name] for name in self.axis_names}

    def _make_groups(self) -> None:
        """One subgroup for each set of axes that the MoE and the sharded
        layers reduce over (all axes, ``model``, the data axes), for
        ``pod`` (the scale-out round's sum) and, with a ``pod`` axis, for
        ``data`` (the data axis inside one pod), made on every rank in the
        same order; a set whose group would be one process gets none (a dry
        mesh makes rank 0's groups alone, without processes)."""
        names = self.axis_names
        backend = None if self.dry else dist.get_backend()
        pod = ("pod",) if "pod" in names else ()
        in_pod = ("data",) if pod else ()
        for axes in (names, ("model",), tuple(a for a in names if a != "model"), pod, in_pod):
            if self.size(axes) == 1:
                continue
            if self.dry:
                self._groups[frozenset(axes)] = _DryGroup(self.size(axes), 0)
                continue
            members: dict[tuple, list[int]] = {}
            for r in range(self.world):
                c = self._coords_of(r)
                members.setdefault(tuple(c[a] for a in names if a not in axes), []).append(r)
            for ranks in members.values():   # the same order on every rank
                g = dist.new_group(ranks, backend=backend)
                if self.rank in ranks:
                    self._groups[frozenset(axes)] = g

    def in_pod(self) -> "Mesh":
        """This grid as the scale-out round's body sees it, manual over
        ``pod``: the data and model axes of this rank's pod (the same
        process groups), whose data axes leave ``pod`` out (the sharded
        loss reduces over ``model`` and ``data``)."""
        if not self.grid or "pod" not in self.shape:
            raise ValueError(f"in_pod takes a grid with a 'pod' axis; this mesh is {self.shape}")
        inner = copy.copy(self)
        inner.shape = {a: n for a, n in self.shape.items() if a != "pod"}
        inner.axis_names = tuple(inner.shape)
        inner.coords = {a: i for a, i in self.coords.items() if a != "pod"}
        return inner

    def size(self, axes=None) -> int:
        """The number of devices on ``axes`` (all axes for None)."""
        return math.prod(self.shape[a] for a in self._axes(axes))

    def axis_index(self, name: str) -> int:
        """This process's index on axis ``name`` (``jax.lax.axis_index``)."""
        if self.coords is None:
            raise ValueError(f"a process holds {len(self.pods)} pods of {self.shape}; it has "
                             f"no single index on {name!r}")
        return self.coords[self._axes(name)[0]]

    def index(self, axes) -> int:
        """The row-major index of this process over ``axes``."""
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + self.axis_index(a)
        return idx

    def _group(self, axes):
        """The process group over ``axes``, or None where it is this process
        alone (the reduction is then the identity)."""
        axes = self._axes(axes)
        if self.grid:
            if self.size(axes) == 1:
                return None
            if frozenset(axes) not in self._groups:
                raise ValueError(f"the mesh has no process group over {axes}: it makes one "
                                 f"for all axes, 'model', the data axes and 'pod'")
            return self._groups[frozenset(axes)]
        return self.group if "pod" in axes and self.world > 1 else None

    def _check(self, t: torch.Tensor) -> None:
        if self.dry:
            if t.device.type != "meta":
                raise RuntimeError(f"a dry mesh has no processes: its collectives take meta "
                                   f"tensors; got a {t.device.type} tensor")
            return
        backend = dist.get_backend(self.group)
        if backend != backend_for(t.device) and not (backend == "gloo" and t.is_cuda):
            raise RuntimeError(
                f"the process group's backend is {backend!r} but {t.device.type} tensors need "
                f"{backend_for(t.device)!r}; initialise the group for the tensors' device")

    # -- collectives ----------------------------------------------------------

    def all_reduce_sum(self, t: torch.Tensor, axes=None) -> torch.Tensor:
        """``t`` summed over the processes of ``axes`` (all axes for None;
        for pods blocked over the world, over the world): in place, ``t``
        itself, where ``t`` takes no gradient, else a new tensor whose
        backward passes the cotangent through.  The identity where the
        axes hold one process."""
        group = self._group(axes)
        if group is None:
            return t
        self._check(t)
        if t.requires_grad:
            return _SumForward.apply(t, group)
        _all_reduce(t, group)
        return t

    def all_reduce_mean(self, t: torch.Tensor, axes=None) -> torch.Tensor:
        """``all_reduce_sum`` divided by the number of devices on ``axes``
        (the ``pmean``)."""
        if self._group(axes) is None:
            return t
        return self.all_reduce_sum(t.clone(), axes) / self.size(axes)

    def all_reduce_max(self, t: torch.Tensor, axes=None) -> torch.Tensor:
        """``t``'s elementwise maximum over the processes of ``axes``, in
        place (``t`` itself), with no gradient; the identity where the axes
        hold one process."""
        group = self._group(axes)
        if group is None:
            return t
        self._check(t)
        _all_reduce(t, group, dist.ReduceOp.MAX)
        return t

    def grad_sum(self, t: torch.Tensor, axes=None) -> torch.Tensor:
        """``t`` itself forward; backward, its gradient summed over the
        processes of ``axes``: for a replicated value that each process
        uses for its own part of a sum."""
        group = self._group(axes)
        if group is None or not t.requires_grad:
            return t
        self._check(t)
        return _SumBackward.apply(t, group)

    def all_gather(self, t: torch.Tensor, axes=None, dim: int = 0) -> torch.Tensor:
        """Each process's ``t`` concatenated on ``dim`` in the row-major
        order of ``axes`` (all axes for None; for pods blocked over the
        world, the ranks' order); ``t`` itself where the axes hold one
        process.  Backward, each process's piece takes its slice."""
        group = self._group(axes)
        if group is None:
            return t
        self._check(t)
        return _Gather.apply(t.contiguous(), group, dim)

    def all_to_all(self, t: torch.Tensor, send: list[int], recv: list[int],
                   axes=None) -> torch.Tensor:
        """Rows of ``t`` exchanged between the processes of ``axes`` (all
        axes for None): ``send[k]`` consecutive rows go to the k-th process
        of the group (row-major over ``axes``) and ``recv[k]`` rows come
        from it, concatenated in that order (``dist.all_to_all_single``).
        Backward, each row's gradient goes back to the process it came
        from.  ``t`` itself where the axes hold one process."""
        group = self._group(axes)
        if group is None:
            return t
        self._check(t)
        return _AllToAll.apply(t.contiguous(), group, list(send), list(recv))


class _SumForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        out = t.clone()
        _all_reduce(out, group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _all_reduce(g, ctx.group)
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        n, ctx.dim = _group_size(group), dim
        ctx.rank, ctx.size = _group_rank(group), t.shape[dim]
        parts = [torch.empty_like(t) for _ in range(n)]
        tally_collective("all-gather", n * t.numel() * t.element_size())
        if not isinstance(group, _DryGroup):
            dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None


def _exchange(t: torch.Tensor, group, send: list[int], recv: list[int]) -> torch.Tensor:
    out = t.new_empty((sum(recv), *t.shape[1:]))
    tally_collective("all-to-all", out.numel() * out.element_size())
    if not isinstance(group, _DryGroup):
        dist.all_to_all_single(out, t, recv, send, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, send, recv):
        ctx.group, ctx.send, ctx.recv = group, send, recv
        return _exchange(t, group, send, recv)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g.contiguous(), ctx.group, ctx.recv, ctx.send), None, None, None


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0) -> Mesh:
    """A mesh over the processes of the default process group (or this
    process alone): with a ``data`` or ``model`` axis larger than 1, a grid
    that raises unless the world has pod x data x model processes; else
    ``pod`` pods (none for ``pod=0``) blocked over the world."""
    return Mesh(pod, data, model)


def make_dry_mesh(data: int = 1, model: int = 1, pod: int = 0) -> Mesh:
    """Rank 0 of a mesh of pod x data x model processes (``pod`` of them,
    one pod each, where data = model = 1) with no process group: the dry
    run's mesh, whose collectives take ``meta`` tensors and tally their
    bytes."""
    return Mesh(pod, data, model, dry=True)


def make_production_mesh(*, multi_pod: bool = False, dry: bool = False) -> Mesh:
    """The reference's production layout (data 16 x model 16, and pod 2
    with ``multi_pod``): raises where the world has fewer processes than
    its 256 or 512 devices; with ``dry``, rank 0 of that world without it
    (``make_dry_mesh``)."""
    shape = _PRODUCTION[multi_pod]
    if dry:
        return make_dry_mesh(**shape)
    need = math.prod(shape.values())
    have = Mesh().world
    if have < need:
        raise RuntimeError(f"the production mesh {shape} names {need} devices; this world has "
                           f"{have} process(es), one device each")
    return make_host_mesh(**shape)
