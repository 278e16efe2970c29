"""Logical-axis -> mesh-axis sharding policy, ported from ``repro.sharding``.

Models name every parameter's axes logically (``transformer_specs``);
a policy turns those names into the mesh axes each dimension is split
over, for a concrete mesh (the port's ``launch.mesh.Mesh``, or anything
with ``shape`` and ``axis_names``), with the reference's guards: a
dimension that the mesh axes' size does not divide is replicated (e.g.
hymba's vocab 32001 on a 16-way model axis), and no mesh axis is used
twice in one spec.

A spec is the tuple of a ``PartitionSpec``'s entries, trailing ``None``s
dropped, one mesh axis named by itself as ``PartitionSpec`` normalises
it: ``()`` is fully replicated, ``("model",)`` splits the first dimension
over ``model``, ``(("pod", "data"),)`` over both.  The baseline
policy:

  experts    -> model     (expert parallelism)
  heads      -> model     (Megatron tensor parallelism)
  ffn        -> model
  vocab      -> model     (sharded logits / embedding)
  expert_ff  -> data      (FSDP of the expert weights)
  batch      -> all data-parallel axes ("pod", "data")
  seq        -> the data axes only when the batch cannot fill them

everything else replicated; the ``fsdp`` variant splits the batch and the
weights over every axis.

``shard_shape`` and ``shard_bytes`` give one device's block of a leaf
under a spec, as the reference's ``NamedSharding.shard_shape`` does (a
spec from ``spec_for`` splits only the dimensions its axes divide): summed
over a step's arguments, the per-device bytes of the reference's layout,
which the dry run reports as ``argument_size``.  ``shard_tree`` cuts a
whole tree into one rank's blocks under a tree of specs (each dimension
split over every axis its entry names, the axes row-major, as the
reference's ``NamedSharding`` lays out devices), and ``gather_tree``
puts the ranks' blocks back together over the mesh's processes.

Which families a rank holds as blocks: on a grid (``data`` or ``model``
larger than 1) every family (``models.transformer.shards_storage``: the
dense GQA models, hymba-1.5b, xlstm-125m, internvl2-1b, musicgen-large,
and dbrx-132b and deepseek-v3-671b, their experts over ``model`` and the
experts' FFN columns over ``data``) holds every leaf as its block under
the baseline policy and trains, prefills and decodes on its ``data``
share of the batch (the decode cache's block too), tensor-parallel over
``model``; under the ``fsdp`` variant (the dry run's only) every leaf is
whole.  ``spec_leaves`` lists a layout tree's specs in ``tree_flatten``'s
order of the leaves they describe.
"""

from __future__ import annotations

import math
from typing import Any

__all__ = ["ShardingPolicy", "make_policy", "named_sharding_tree", "shard_shape",
           "shard_bytes", "shard_tree", "gather_tree", "spec_leaves"]


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, tuple, type(None))) for e in x)


class ShardingPolicy:
    def __init__(self, mesh, rules: dict[str, Any], dp_axes: tuple[str, ...]):
        self.mesh = mesh
        self.rules = rules
        self.dp_axes = dp_axes

    def _axis_size(self, mesh_axes) -> int:
        if mesh_axes is None:
            return 1
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        return math.prod(self.mesh.shape[a] for a in mesh_axes)

    def spec_for(self, logical_axes: tuple, shape: tuple[int, ...]) -> tuple:
        """The spec of a leaf with these logical axes and ``shape``: each
        dimension's mesh axes by the rules, replicated where they do not
        divide it or reuse an axis already taken; trailing Nones dropped."""
        entries = []
        used: set[str] = set()
        for dim, name in zip(shape, logical_axes):
            mesh_axes = self.rules.get(name) if name is not None else None
            if mesh_axes is None:
                entries.append(None)
                continue
            tup = (mesh_axes,) if isinstance(mesh_axes, str) else tuple(mesh_axes)
            if any(a in used for a in tup) or dim % self._axis_size(tup) != 0:
                entries.append(None)
                continue
            used.update(tup)
            entries.append(tup[0] if len(tup) == 1 else tup)
        while entries and entries[-1] is None:
            entries.pop()
        return tuple(entries)

    def shardings(self, specs_tree, shapes_tree):
        """``specs_tree``: logical-axes tuples; ``shapes_tree``: the same
        structure with a tensor at each leaf (a ``meta`` tensor will do).
        Returns ``shapes_tree``'s structure with each leaf's spec (a list
        where it holds a list or a tuple, so that a walk stops at the
        specs' own tuples).  Where
        ``shapes_tree`` holds a list of layers and ``specs_tree`` the
        reference's stacked layer dict (``transformer_specs``), each layer
        takes the stacked specs without their leading "layers" axis."""
        return _map(lambda sp, sh: self.spec_for(sp, tuple(sh.shape)), specs_tree, shapes_tree,
                    "")


def shard_shape(mesh, spec: tuple, shape: tuple[int, ...]) -> tuple[int, ...]:
    """One device's block of a leaf of ``shape`` under ``spec``: each
    dimension divided by the size of the mesh axes its entry names
    (which must divide it, as ``spec_for`` makes sure)."""
    out = list(shape)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        n = math.prod(mesh.shape[a] for a in axes)
        if out[i] % n:
            raise ValueError(f"dimension {i} of {tuple(shape)} does not divide over {axes} "
                             f"({n} devices)")
        out[i] //= n
    return tuple(out)


def shard_bytes(mesh, spec: tuple, leaf) -> int:
    """The bytes of one device's block of ``leaf`` (a tensor; ``meta``
    will do) under ``spec``."""
    return math.prod(shard_shape(mesh, spec, tuple(leaf.shape))) * leaf.element_size()


def _entry_axes(entry) -> tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_tree(tree, specs, mesh):
    """This rank's blocks of ``tree`` (tensors; ``meta`` will do) under
    ``specs`` (``ShardingPolicy.shardings``'s tree for it, or any tree of
    spec tuples of the same structure): each dimension a spec entry names
    is cut to the rank's block over that entry's axes (its row-major index
    over them, ``mesh.index``), as a new contiguous tensor, so that the
    rank holds the block's bytes and not the whole leaf's."""
    def one(spec, leaf):
        out = leaf
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            axes = _entry_axes(entry)
            n = math.prod(mesh.shape[a] for a in axes)
            if leaf.shape[dim] % n:
                raise ValueError(f"dimension {dim} of {tuple(leaf.shape)} does not divide "
                                 f"over {axes} ({n} devices)")
            size = leaf.shape[dim] // n
            out = out.narrow(dim, mesh.index(axes) * size, size)
        return out.clone() if out is not leaf else leaf

    return _map(one, specs, tree, "")


def gather_tree(blocks, specs, mesh):
    """The inverse of ``shard_tree`` over the mesh's processes: each
    leaf's blocks gathered whole over the axes of each entry of its spec
    (``mesh.all_gather``; a dry mesh gathers ``meta`` shapes)."""
    def one(spec, leaf):
        out = leaf
        for dim, entry in enumerate(spec):
            if entry is not None:
                out = mesh.all_gather(out.contiguous(), _entry_axes(entry), dim=dim)
        return out

    return _map(one, specs, blocks, "")


def spec_leaves(specs) -> list[tuple]:
    """The spec tuples of a layout tree (``ShardingPolicy.shardings``'s), in
    ``tree_flatten``'s order of the leaves they describe (a scalar's spec
    stands for one leaf)."""
    out = []

    def walk(node):
        if _is_axes(node):
            out.append(node)
        else:
            for v in node.values() if isinstance(node, dict) else node:
                walk(v)

    walk(specs)
    return out


def _unstack(specs):
    if _is_axes(specs):
        return specs[1:]
    return {k: _unstack(v) for k, v in specs.items()}


def _map(fn, specs, shapes, path: str):
    """``fn(spec, leaf)`` over the leaves of ``shapes``, matched to
    ``specs`` by structure; a mismatch raises."""
    if _is_axes(specs):
        if not hasattr(shapes, "shape"):
            raise ValueError(f"specs/shapes mismatch at {path or '/'}: a spec, and no tensor")
        return fn(specs, shapes)
    if isinstance(shapes, dict) and isinstance(specs, dict):
        if set(shapes) != set(specs):
            raise ValueError(f"specs/shapes mismatch at {path or '/'}: keys {sorted(specs)} "
                             f"vs {sorted(shapes)}")
        return {k: _map(fn, specs[k], v, f"{path}/{k}") for k, v in shapes.items()}
    if isinstance(shapes, (list, tuple)) and isinstance(specs, dict):
        return [_map(fn, _unstack(specs), v, f"{path}/{i}") for i, v in enumerate(shapes)]
    if isinstance(shapes, (list, tuple)) and isinstance(specs, list) \
            and len(specs) == len(shapes):
        return [_map(fn, sp, v, f"{path}/{i}") for i, (sp, v) in enumerate(zip(specs, shapes))]
    raise ValueError(f"specs/shapes mismatch at {path or '/'}")


def make_policy(mesh, batch_size: int, shard_seq: bool = False,
                overrides: dict[str, Any] | None = None,
                variant: str = "baseline") -> ShardingPolicy:
    """The policy for ``mesh``.  ``shard_seq=True`` moves the data axes
    from the batch to the sequence (long-context decode with batch 1).

    ``baseline``: Megatron tensor parallelism on ``model`` plus data
    parallelism (activations by batch over the data axes, weights by
    heads / ffn / vocab over model).  ``fsdp``: the batch over every axis,
    the weights stored split over the same axes (ZeRO-3 style)."""
    dp = tuple(a for a in mesh.axis_names if a != "model")
    dp_total = math.prod(mesh.shape[a] for a in dp)
    all_axes = tuple(mesh.axis_names)
    all_total = math.prod(mesh.shape[a] for a in all_axes)
    if variant == "fsdp":
        batch_axes = all_axes if (not shard_seq and batch_size % all_total == 0) else None
        rules: dict[str, Any] = {
            "experts": all_axes, "heads": all_axes, "ffn": all_axes, "vocab": all_axes,
            "expert_ff": None, "kv_heads": None, "q_lora": None, "kv_lora": None,
            "embed": None, "embed2": None, "layers": None, "state": None,
            "batch": batch_axes, "seq": dp if shard_seq else None,
        }
    else:
        batch_axes = dp if (not shard_seq and batch_size % dp_total == 0) else None
        rules = {
            "experts": "model", "heads": "model", "ffn": "model", "vocab": "model",
            "expert_ff": "data", "kv_heads": "model", "q_lora": None, "kv_lora": None,
            "embed": None, "embed2": None, "layers": None, "state": None,
            "batch": batch_axes, "seq": dp if shard_seq else None,
        }
    if overrides:
        rules.update(overrides)
    return ShardingPolicy(mesh, rules, dp)


def named_sharding_tree(policy: ShardingPolicy, specs_tree, shapes_tree):
    return policy.shardings(specs_tree, shapes_tree)
