"""The scale-out federated round, ported from ``repro.federated.scaleout``:
clients are pods of a ``repro_torch.launch.mesh.Mesh``, and aggregation is
a selection-weighted sum over them.

Each pod trains its own replica of the parameter tree (``local_steps`` of
plain SGD on ``loss_fn``, ``p - lr * g`` in each leaf's type); the FedAvg
weights vector (zero for a client that was not selected) then gates the
sum, so "only m of K clients upload" is "the sum carries zero weight for
the others".  A process holds a block of pods (``mesh.pods``): the
weighted sum over its block is the FedAvg reduce kernel (K1), leaf by
leaf, and the partial sums meet in one ``all_reduce`` over ``pod`` (none
where the process holds every pod).  With ``compress_bits`` each pod's
delta from its start is quantized to ``compress_bits``-bit integers with
one scale a block (``max |delta| / qmax``, round to nearest, clipped);
the integer blocks and the pods' ``scale * w`` are gathered over ``pod``,
and K1 sums the blocks as fp32 with those weights, onto the start.  Every
pod's mean training loss is gathered over ``pod`` too.

On a mesh of pods (``data = model = 1``) a block is a whole leaf.  On a
grid (``data`` or ``model`` larger than 1) a process holds one pod, as
the reference's round is manual over ``pod`` and leaves ``data`` and
``model`` to GSPMD inside each pod, and the exact sum runs over the
``pod`` subgroup at the rank's (data, model) coordinate.  For the families
of ``models.transformer.shards_storage`` (the dense GQA models, hymba-1.5b
with its Mamba heads on the rank's channels, xlstm-125m with its cores on
the rank's heads, internvl2-1b's patches and musicgen-large's frames)
each rank holds its block of every leaf under the baseline policy
(``sharding.shard_tree``, the reference's ``P("pod", *spec)``) and trains
on its ``data`` share of the pod's batch (the reference's ``P("pod",
"data")``), tensor-parallel over ``model`` and data-parallel over
``data`` (``loss_fn`` on ``mesh.in_pod()``): K1 sums the rank's blocks,
and the int8 round quantizes the rank's block, one scale a (leaf,
block), and keeps it, as the reference's second map (manual over ``pod``
and ``model``) leaves its output split (an expert leaf's block is also
its ``data`` block of columns).  The reference's local steps call
``loss_fn`` without a mesh, so an MoE layer computes ``moe_dense``'s
function there whatever its ``impl``: the port's round runs it so, on the
rank's experts (``transformer._moe_blocks``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro_torch.kernels.aggregate import masked_weighted_sum
from repro_torch.models.transformer import check_supported, loss_fn, shards_storage

__all__ = ["make_federated_round", "stack_for_clients"]


def stack_for_clients(params, n_clients: int):
    """The parameter tree (or a rank's blocks of it) with a leading client
    axis of ``n_clients``: views of each leaf, which local training never
    writes to."""
    return tree_map(lambda p: p.unsqueeze(0).expand(n_clients, *p.shape), params)


def make_federated_round(cfg, mesh, lr: float, local_steps: int = 4, compress_bits: int = 0):
    """``round_fn(stacked_params, batch, weights) -> (new_stacked_params,
    losses)``.

    ``stacked_params``: the parameter tree (``init_params``'s) with a
    leading axis of this process's pods (``len(mesh.pods)``, 1 on a grid;
    ``stack_for_clients``), each leaf whole or, on a grid for the families
    that shard (``shards_storage``), the rank's block of it
    (``sharding.shard_tree``).  ``batch``: ``loss_fn``'s dict, each
    tensor with the same leading axis, then the pod's rows (the rank's
    ``data`` share of them where the leaves are blocks).  ``weights``:
    (n_pods,) fp32 FedAvg weights of every pod (zero: not selected), or
    (``len(mesh.pods)``,), this process's pods' own (the reference's
    ``P("pod")`` share), on the parameters' device.
    Returns the aggregated tree (the rank's blocks where it took blocks),
    the same for every pod (views of one leaf a leaf), and the (n_pods,)
    fp32 mean training losses, each over its pod's whole batch.
    ``compress_bits``: 0 = the exact fp32 weighted sum; 2 to 8 = the
    quantized deltas, one scale a leaf (a grid: a leaf and block)."""
    check_supported(cfg, tree=True)
    if "pod" not in mesh.shape:
        raise ValueError(f"the federated round needs a mesh with a 'pod' (client) axis; got "
                         f"{mesh.shape}")
    if compress_bits and not 2 <= compress_bits <= 8:
        raise ValueError(f"compress_bits must be 0 (off) or in [2, 8], got {compress_bits}")
    n_pods, n_local = mesh.shape["pod"], len(mesh.pods)
    qmax = 2 ** (compress_bits - 1) - 1 if compress_bits else 0
    sharded = shards_storage(cfg, mesh)
    inner = mesh.in_pod() if sharded else None
    if cfg.moe:    # the reference's local steps pass no mesh: moe_dense's function
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl="dense"))

    def local_sgd(leaves, spec, batch):
        losses = []
        for _ in range(local_steps):
            leaves = [p.detach().requires_grad_(True) for p in leaves]
            loss, _ = loss_fn(tree_unflatten(leaves, spec), cfg, batch, inner, sharded=sharded)
            # a leaf the loss does not reach gets a zero gradient
            grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
            with torch.no_grad():
                leaves = [(w - lr * g).to(w.dtype) for w, g in zip(leaves, grads)]
            losses.append(loss.detach().float())
        return leaves, torch.stack(losses).mean()

    def reduce_exact(rows, w):
        stack = torch.stack([r.reshape(-1) for r in rows])
        return mesh.all_reduce_sum(masked_weighted_sum(stack, w), "pod")

    def reduce_quantized(rows, starts, w):
        deltas = [r.float() - s.float() for r, s in zip(rows, starts)]
        scales = torch.stack([torch.clamp(d.abs().max(), min=1e-12) / qmax for d in deltas])
        q = torch.stack([torch.clamp(torch.round(d / sc), -qmax - 1, qmax).to(torch.int8)
                         .reshape(-1) for d, sc in zip(deltas, scales)])
        del deltas
        q_all, sw_all = mesh.all_gather(q, "pod"), mesh.all_gather(scales * w, "pod")
        return masked_weighted_sum(q_all.to(torch.float32), sw_all.contiguous())

    def round_fn(stacked_params, batch, weights):
        leaves, spec = tree_flatten(stacked_params)
        if any(x.shape[0] != n_local for x in leaves):
            raise ValueError(f"this process holds {n_local} pods; the stacked parameters' "
                             f"leading axes are {sorted({x.shape[0] for x in leaves})}")
        if weights.shape == (n_pods,):
            weights = weights[mesh.pods.start:mesh.pods.stop]
        elif weights.shape != (n_local,):
            raise ValueError(f"weights must be ({n_pods},), one a pod, or ({n_local},), this "
                             f"process's pods'; got {tuple(weights.shape)}")
        w = weights.to(torch.float32).contiguous()
        ends, losses = [], []
        for i in range(n_local):
            end, loss = local_sgd([x[i] for x in leaves], spec,
                                  {k: v[i] for k, v in batch.items()})
            ends.append(end)
            losses.append(loss)
        out = []
        for j, leaf in enumerate(leaves):
            rows = [end[j] for end in ends]
            for end in ends:
                end[j] = None   # each pod's trained leaf is freed once it is reduced
            if compress_bits:
                starts = [leaf[i] for i in range(n_local)]
                delta = reduce_quantized(rows, starts, w)
                new = torch.stack([(s.float() + delta.view(s.shape)).to(leaf.dtype)
                                   for s in starts])
            else:
                agg = reduce_exact(rows, w).to(leaf.dtype).view(leaf.shape[1:])
                new = agg.unsqueeze(0).expand(n_local, *agg.shape)
            out.append(new)
        return tree_unflatten(out, spec), mesh.all_gather(torch.stack(losses), "pod")

    return round_fn
