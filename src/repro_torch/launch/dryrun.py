"""The dry run, ported from ``repro.launch.dryrun``: trace every (arch x
input shape) step on the production mesh without allocating a parameter.

For each pair the dry run

1. builds the full config (``long_500k`` takes the reference's
   sliding-window variant, ``long_context_variant``),
2. makes the parameters (``abstract_params``), the batch (``input_specs``
   / ``decode_specs``) and, for decode, the cache (``init_cache`` on
   ``meta``) as empty ``meta`` tensors,
3. takes the reference's layouts from the baseline (or ``fsdp``) policy
   (``repro_torch.sharding``) on a dry production mesh: rank 0 of a world
   of 256 (``single``) or 512 (``multi``) processes that is not there
   (``launch.mesh.make_production_mesh(dry=True)``),
4. runs the step on those ``meta`` tensors along the card's path: the
   kernel wrappers take their ``meta`` branches, which return the CUDA
   path's outputs and saved tensors and tally each kernel's work from its
   work formula (``path="cpu"`` runs the kernels' plain versions on the
   ``meta`` tensors instead, as the CPU runs them),
5. records work, memory and collectives to a JSONL with the reference's
   keys (``t_trace_s`` in place of ``t_lower_s`` / ``t_compile_s``, plus
   ``memory.argument_size_held`` and ``kernel_work``).

Nothing runs on a device and nothing is allocated beyond ``meta``
tensors; an operation that meets a CPU tensor beside the ``meta`` ones
(other than a 0-d scalar) raises.  The step functions are real ones:
given tensors on the card (and a real mesh) they run.

Counting rules:

- ``flops`` are the flops of the matrix products, as the reference's graph
  has them: ``torch.utils.flop_counter.FlopCounterMode`` over the aten
  operations, plus each kernel's product flops from its work formula.
  K3 counts the whole Sq x Sk square with or without a window, since the
  reference's ``jnp`` attention computes every chunk pair: two S x S
  products forward and four backward, and no recomputation (the dry run
  runs no remat).  K4 counts the products of the reference's scan
  formulation: its C contraction, 2 B S D N forward and twice that
  backward.  K1 counts none (the reference's weighted sum is
  elementwise).  The kernels' own work (visible pairs only, K3's
  backward recomputing Q K^T) is under ``kernel_work``.  This is not
  XLA's ``cost_analysis`` total, which also counts elementwise work.
- ``bytes_accessed`` is the eager path's traffic: every aten operation's
  tensor inputs read once and outputs written once (views, ``empty`` and
  ``detach`` move none), plus each kernel's bytes from its work formula.
  It is not comparable with XLA's count after fusion.
- ``memory.temp_size`` is ``MemTracker``'s peak over the trace, less the
  arguments, along the chosen path (outputs included).
  ``memory.argument_size`` is one device's share of the arguments under
  the reference's layout (``sharding.shard_bytes`` of each argument);
  ``memory.argument_size_held`` what the port's rank holds.  ``storage``
  says which (``step_storage``), under the baseline policy on a grid, for
  every family (``models.transformer.shards_storage``: the dense GQA
  models, hymba-1.5b, xlstm-125m, internvl2-1b, musicgen-large, dbrx-132b
  and deepseek-v3-671b): ``"sharded"`` where the rank holds its share, its
  blocks and its rows (the ``train`` step, the federated round, prefill
  and decode: ``prefill_32k``, ``decode_32k``, ``long_500k``; a batch
  that the data axes do not divide is every row on every data rank, its
  share): the arguments are those blocks and, for decode, the rank's
  cache block beside the whole token batch, the held bytes equal
  ``argument_size`` (decode's position counted as the reference's
  int32), and ``temp_size`` is the tensor-parallel step's, hymba's with
  ``w_in`` and, where its 25 heads split mid-head, the attention's
  projections gathered whole over ``model``, xlstm's with ``w_up``
  gathered and, at model 16, its 4 heads computed replicated, an MoE
  layer's by its rule (``transformer._moe_blocks``: rule 1's all-to-all
  of expert blocks, the expert-FFN columns gathered over ``data``, the
  tokens over the data axes), MLA's on the rank's heads.  A decode
  of batch 1 (``long_500k``) holds its block of the k / v cache's
  sequence over the data axes, as the policy's ``shard_seq`` lays it
  out, and combines the blocks' partial softmaxes over them.  A decode
  of a batch larger than 1 that the data axes do not divide holds that
  sequence block too, as the reference's step constrains its cache,
  while the reference's policy keeps the step's cache argument whole
  over the data axes: its held bytes are below ``argument_size``.
  ``"whole"`` where the rank holds every argument whole and computes the
  replicated values of the whole batch (the ``fsdp`` variant, run
  without the mesh), so that ``temp_size`` and ``argument_size_held``
  show what that path needs and the gap to ``argument_size`` is what
  sharding its storage would save.
- ``collective_bytes`` are the dry mesh's collectives by the reference's
  kind names, each counted at its result's size (for an all-gather the
  gathered tensor), as the reference's ``collective_bytes`` counts them.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --federated --arch qwen3-14b
  PYTHONPATH=src python -m repro_torch.launch.dryrun --federated --all
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from contextlib import ExitStack
from dataclasses import replace

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import INPUT_SHAPES, InputShape, get_config, list_configs
from repro_torch.configs.inputs import decode_specs, input_specs, long_context_variant
from repro_torch.kernels.build import plain_on_meta, work_tally
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.transformer import (
    abstract_params,
    cache_specs,
    decode_step,
    init_cache,
    loss_fn,
    param_blocks,
    prefill,
    shards_storage,
    transformer_specs,
)
from repro_torch.sharding import make_policy, shard_bytes, shard_shape, shard_tree, spec_leaves

__all__ = ["build_step", "trace", "count_flops", "probe_costs", "trace_step", "run_one",
           "build_federated", "run_federated", "main"]

PATHS = ("cuda", "cpu")


def _batch_logical_axes(cfg, kind):
    ax = {}
    if cfg.input_mode == "tokens":
        ax["tokens"] = ("batch", "seq_in")
    elif cfg.input_mode == "frames":
        ax["frames"] = ("batch", "seq_in", None)
    else:
        ax["patches"] = ("batch", None, None)
        ax["tokens"] = ("batch", "seq_in")
    if kind == "train":
        ax["labels"] = ("batch", "seq_in")
    return ax


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _held_bytes(tree) -> int:
    """The bytes of ``tree``'s tensors, each storage once."""
    storages = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                for t in _tensors(tree)}
    return sum(storages.values())


def step_storage(cfg, mesh, kind: str, policy_variant: str = "baseline") -> str:
    """What a rank of ``mesh`` holds of a ``kind`` step's arguments under the
    baseline policy on a grid (``shards_storage``): ``"sharded"``,
    its blocks (``train``, the federated round, ``prefill`` and ``decode``),
    the rows the data axes give it (every row where they do not divide
    the batch) and, for a decode whose batch they do not divide, its block
    of the k / v cache's sequence where they divide its length
    (``transformer.seq_block``); else ``"whole"``."""
    if policy_variant != "baseline" or not shards_storage(cfg, mesh):
        return "whole"
    if kind not in ("train", "federated_round", "prefill", "decode"):
        return "whole"
    return "sharded"


def _local(tree):
    """The specs of a rank's blocks: each is what the rank holds, ``()``
    (a list where the tree holds a list or a tuple, as ``shardings``
    gives them)."""
    if isinstance(tree, dict):
        return {k: _local(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_local(v) for v in tree]
    return ()


def _reference_args(cfg, mesh, shape, policy_variant: str):
    """(cfg, the policy, the whole arguments as ``meta`` tensors, their
    specs under the policy, the prefill's cache specs) of ``shape``'s step:
    the reference's layout.  The ``fsdp`` variant sets
    ``act_shard="dp_all"`` where the config has none, and a batch-1 decode
    moves the data axes to the sequence, as in the reference."""
    if policy_variant == "fsdp" and not cfg.act_shard:
        cfg = replace(cfg, act_shard="dp_all")
    policy = make_policy(mesh, shape.global_batch,
                         shard_seq=(shape.kind == "decode" and shape.global_batch == 1),
                         variant=policy_variant)
    params = abstract_params(cfg)
    pshard = policy.shardings(transformer_specs(cfg), params)
    if shape.kind == "decode":
        batch = decode_specs(cfg, shape)
        bshard = {k: () for k in batch}
    else:
        batch = input_specs(cfg, shape)
        bspec = _batch_logical_axes(cfg, shape.kind)
        bshard = {k: policy.spec_for(bspec[k], tuple(batch[k].shape)) for k in batch}
    if shape.kind == "train":
        return cfg, (params, batch), (pshard, bshard), None
    cache = init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
    cshard = policy.shardings(cache_specs(cfg), cache)
    if shape.kind == "prefill":
        return cfg, (params, batch), (pshard, bshard), cshard
    return cfg, (params, batch, cache, shape.seq_len - 1), (pshard, bshard, cshard, ()), cshard


def argument_size(cfg, mesh, shape, policy_variant: str = "baseline") -> int:
    """One device's bytes of ``shape``'s step arguments under the
    reference's layout (``_argument_size`` of ``_reference_args``), what
    the rank holds aside."""
    _, args, specs, _ = _reference_args(cfg, mesh, shape, policy_variant)
    return _argument_size(mesh, specs, args)


def build_step(cfg, mesh, shape, lr: float = 1e-3, policy_variant: str = "baseline"):
    """(fn, args, (in_specs, out_specs), donate) for ``shape``'s kind, as the
    reference's ``build_step``: ``args`` are ``meta`` tensors, the specs
    the policy's layout of each argument and output (a spec tuple a leaf),
    ``donate`` the arguments that the step updates in place.

    - train: ``fn(params, batch) -> (params, loss)``, the gradient of
      ``loss_fn`` and ``p - lr * g`` in each leaf's type, written into the
      parameters in place (the reference donates them);
    - prefill: ``fn(params, batch) -> (logits, cache)``;
    - decode: ``fn(params, batch, cache, pos) -> (logits, cache)``, the
      cache advanced in place; ``pos`` (a Python int) is the cache's last
      position.

    The layout is ``_reference_args``'.  Where ``step_storage`` says
    ``"sharded"``, ``args`` are what the rank holds on that path: its
    blocks of the parameters (``param_blocks``), its share of the batch
    (decode's tokens whole, as the reference replicates them) and its
    block of the cache (``init_cache(..., mesh=)``: a batch of one, or one
    the data axes do not divide, holds its block of the sequence), and
    each spec is ``()``.  That is the rank's share of the reference's
    layout (``argument_size``), but for the decode of a batch larger than
    1 that the data axes do not divide: the reference's policy keeps that
    step's cache argument whole over the data axes, which its step's
    cache constraint then splits over the sequence, the layout the rank
    holds, so that the rank holds less than ``argument_size``."""
    cfg, args, in_specs, cshard = _reference_args(cfg, mesh, shape, policy_variant)
    params, batch = args[:2]
    pshard, bshard = in_specs[:2]
    blocks = step_storage(cfg, mesh, shape.kind, policy_variant) == "sharded"
    if blocks:
        params, pshard = param_blocks(params, cfg, mesh), _local(params)
        if shape.kind != "decode":
            batch = shard_tree(batch, bshard, mesh)
            bshard = _local(batch)
    if shape.kind == "train":

        def train_step(params, batch):
            leaves, spec = tree_flatten(params)
            leaves = [p.detach().requires_grad_(True) for p in leaves]
            loss, _ = loss_fn(tree_unflatten(leaves, spec), cfg, batch, mesh, sharded=blocks)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
            with torch.no_grad():
                for p, g in zip(leaves, grads):
                    p.sub_(lr * g)
            del grads
            return tree_unflatten([p.detach() for p in leaves], spec), loss.detach()

        return train_step, (params, batch), ((pshard, bshard), (pshard, ())), (0,)

    # prefill and decode take blocks on a grid; the fsdp variant, whole,
    # runs them without the mesh
    serve_mesh = mesh if blocks or not shards_storage(cfg, mesh) else None
    if blocks:
        cshard = _local(init_cache(cfg, shape.global_batch, shape.seq_len, device="meta",
                                   mesh=mesh))
    if shape.kind == "prefill":

        def prefill_step(params, batch):
            return prefill(params, cfg, batch, max_len=shape.seq_len, mesh=serve_mesh,
                           batch_size=shape.global_batch)

        return prefill_step, (params, batch), ((pshard, bshard), ((), cshard)), ()

    cache = args[2]
    if blocks:
        cache = init_cache(cfg, shape.global_batch, shape.seq_len, device="meta", mesh=mesh)

    def serve_step(params, batch, cache, pos):
        return decode_step(params, cfg, batch, cache, pos, mesh=serve_mesh,
                           max_len=shape.seq_len)

    return (serve_step, (params, batch, cache, shape.seq_len - 1),
            ((pshard, bshard, cshard, ()), ((), cshard)), (2,))


def _argument_size(mesh, specs, args) -> int:
    """One device's bytes of ``args`` under the layout ``specs`` (a Python
    int argument, decode's position, as the reference's int32 scalar)."""
    total = 0
    for spec, arg in zip(specs, args):
        if isinstance(arg, int):
            total += 4
            continue
        for sp, leaf in zip(spec_leaves(spec), _tensors(arg), strict=True):
            total += shard_bytes(mesh, sp, leaf)
    return total


# ---------------------------------------------------------------------------
# Tracing
# ---------------------------------------------------------------------------

# operations that move no bytes: they make a view or an uninitialised tensor
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
               "detach", "alias", "lift_fresh", "lift_fresh_copy", "_unsafe_view"}


class _Traffic(TorchDispatchMode):
    """Counts each aten operation's tensor inputs read once and outputs
    written once (``bytes``) and the operations by name (``ops``); with
    ``meta_only`` it raises on an operation given a tensor that is not on
    ``meta``, other than a 0-d scalar."""

    def __init__(self, meta_only: bool):
        super().__init__()
        self.meta_only = meta_only
        self.bytes = 0
        self.ops: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        if self.meta_only:
            for t in ins:
                if t.device.type != "meta" and t.ndim > 0:
                    raise RuntimeError(
                        f"the dry run met a {t.device.type} tensor {tuple(t.shape)} beside "
                        f"meta ones in {func}: every argument and every tensor a step makes "
                        f"must be on meta")
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        self.ops[name] = self.ops.get(name, 0) + 1
        if not (func.is_view or name in _NO_TRAFFIC):
            self.bytes += sum(t.numel() * t.element_size() for t in ins + _tensors(out))
        return out


def count_flops(fn, *args):
    """(fn(*args), product flops, the work tally): the flops of the aten
    products that ``FlopCounterMode`` sees plus each kernel's product flops
    (``build.work_tally``).  On the card the same count as the dry run's
    on ``meta`` tensors."""
    counter = FlopCounterMode(display=False)
    with work_tally() as tally, counter:
        out = fn(*args)
    return out, counter.get_total_flops() + tally.product_flops, tally


def trace(fn, args, path: str = "cuda", memory: bool = True) -> dict:
    """Run ``fn(*args)`` on ``meta`` arguments under the counters:
    {"flops", "bytes", "coll", "kernel_work", "peak", "args", "scalars", "output",
    "ops", "t_trace_s"} (``peak`` and the rest of the memory numbers are
    None without ``memory``).  ``path="cpu"`` runs the kernels' plain
    versions."""
    if path not in PATHS:
        raise ValueError(f"path must be one of {PATHS}; got {path!r}")
    leaves = _tensors(args)
    bad = [t for t in leaves if t.device.type != "meta"]
    if bad:
        raise ValueError(f"the dry run takes meta arguments; got {len(bad)} on "
                         f"{sorted({t.device.type for t in bad})}")
    t0 = time.perf_counter()
    counter, traffic = FlopCounterMode(display=False), _Traffic(meta_only=True)
    tracker = base = None
    with ExitStack() as stack:
        if path == "cpu":
            stack.enter_context(plain_on_meta())
        tally = stack.enter_context(work_tally())
        stack.enter_context(counter)
        if memory:
            from torch.distributed._tools.mem_tracker import MemTracker

            tracker = MemTracker()
            tracker.track_external(*leaves)
            base = _total(tracker.get_tracker_snapshot("current"))
            stack.enter_context(tracker)
        stack.enter_context(traffic)
        out = fn(*args)
    rec = {
        "flops": float(counter.get_total_flops() + tally.product_flops),
        "bytes": float(traffic.bytes + tally.bytes),
        "coll": dict(tally.collectives),
        "kernel_work": {k: dict(v) for k, v in tally.kernels.items()},
        "args": _held_bytes(args),
        "scalars": 4 * sum(isinstance(a, int) for a in args),  # decode's int32 position
        "output": _held_bytes(out),
        "peak": None, "temp": None,
        "ops": traffic.ops,
        "t_trace_s": time.perf_counter() - t0,
    }
    if memory:
        rec["peak"] = _total(tracker.get_tracker_snapshot("peak"))
        rec["temp"] = rec["peak"] - base
    return rec


def _total(snapshot) -> int:
    return int(sum(dev["Total"] for dev in snapshot.values()))


# ---------------------------------------------------------------------------
# Probes
# ---------------------------------------------------------------------------


def _probe_cfg(cfg, shape, n_layers: int):
    """The reference's cost-probe variant: ``n_layers`` in {1, 2},
    attention and loss chunks the whole sequence, no remat, the SSM chunk
    the sequence (xLSTM capped at 8192).  The port's trace counts every
    loop's body each time it runs, so the probes only split the total into
    a per-layer part and the rest: total = outside + L x per_layer."""
    s = shape.seq_len
    kw = dict(n_layers=n_layers, scan_unroll=n_layers, attn_chunk=s, loss_chunk=s, remat=False)
    if cfg.ssm is not None:
        chunk = 8192 if cfg.ssm.family == "xlstm" and s > 8192 else s
        kw["ssm"] = replace(cfg.ssm, chunk=chunk)
    return replace(cfg, **kw)


def _cost(cfg, mesh, shape, policy_variant, path):
    fn, args, _, _ = build_step(cfg, mesh, shape, policy_variant=policy_variant)
    rec = trace(fn, args, path, memory=False)
    return {"flops": rec["flops"], "bytes": rec["bytes"], "coll": rec["coll"]}


def _combine(outside, body, n_layers):
    kinds = set(outside["coll"]) | set(body["coll"])
    return {
        "flops": outside["flops"] + n_layers * body["flops"],
        "bytes": outside["bytes"] + n_layers * body["bytes"],
        "coll": {k: outside["coll"].get(k, 0.0) + n_layers * body["coll"].get(k, 0.0)
                 for k in kinds},
    }


def _diff(a, b):
    kinds = set(a["coll"]) | set(b["coll"])
    return {
        "flops": max(a["flops"] - b["flops"], 0.0),
        "bytes": max(a["bytes"] - b["bytes"], 0.0),
        "coll": {k: max(a["coll"].get(k, 0.0) - b["coll"].get(k, 0.0), 0.0) for k in kinds},
    }


def probe_costs(cfg, mesh, shape, policy_variant: str = "baseline", path: str = "cuda") -> dict:
    """The 1- and 2-layer probes as the reference computes them: per_layer
    = cost(P2) - cost(P1), outside = cost(P1) - per_layer, total = outside
    + L x per_layer."""
    p1 = _cost(_probe_cfg(cfg, shape, 1), mesh, shape, policy_variant, path)
    p2 = _cost(_probe_cfg(cfg, shape, 2), mesh, shape, policy_variant, path)
    body = _diff(p2, p1)
    outside = _diff(p1, body)
    return {"per_layer": body, "outside": outside,
            "total": _combine(outside, body, cfg.n_layers)}


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------


def _record(traced, argument_size):
    return {
        "flops": traced["flops"],
        "bytes_accessed": traced["bytes"],
        "collective_bytes": traced["coll"],
        "memory": {
            "argument_size": int(argument_size),
            "argument_size_held": int(traced["args"] + traced["scalars"]),
            "output_size": int(traced["output"]),
            "temp_size": int(traced["temp"]),
            "generated_code_size": 0,
        },
        "kernel_work": traced["kernel_work"],
        "t_trace_s": round(traced["t_trace_s"], 2),
    }


def trace_step(cfg, mesh, shape, policy_variant: str = "baseline", path: str = "cuda",
               probes: bool = True) -> dict:
    """The record's numbers for ``cfg`` at ``shape`` (an ``InputShape``) on
    ``mesh`` (a dry one, or a mesh of one), with the probes unless
    ``probes`` is False, and the traced aten operations under ``ops``."""
    fn, args, _, _ = build_step(cfg, mesh, shape, policy_variant=policy_variant)
    traced = trace(fn, args, path)
    rec = {"n_devices": mesh.size(), "kind": shape.kind, "path": path,
           "storage": step_storage(cfg, mesh, shape.kind, policy_variant),
           **_record(traced, argument_size(cfg, mesh, shape, policy_variant)),
           "ops": traced["ops"]}
    rec["probes"] = None
    if probes:
        try:
            rec["probes"] = probe_costs(cfg, mesh, shape, policy_variant, path)
        except Exception as e:  # probes are best-effort; record why
            rec["probes"] = {"error": f"{type(e).__name__}: {e}"}
    return rec


def run_one(arch: str, shape_name: str, multi_pod: bool, record_hlo: bool = False,
            policy_variant: str = "baseline", path: str = "cuda") -> dict:
    """One (arch, shape, mesh) record; the probes on the single-pod mesh
    only, as in the reference.  ``record_hlo`` (the reference's
    compiled-HLO excerpt) keeps the traced aten operations and their
    counts under ``ops`` instead: the port compiles nothing."""
    shape = INPUT_SHAPES[shape_name]
    cfg = get_config(arch)
    if shape_name == "long_500k":
        cfg = long_context_variant(cfg)
    mesh = make_production_mesh(multi_pod=multi_pod, dry=True)
    body = trace_step(cfg, mesh, shape, policy_variant, path, probes=not multi_pod)
    ops = body.pop("ops")
    rec = {"arch": arch, "config_name": cfg.name, "shape": shape_name, "policy": policy_variant,
           "mesh": "multi" if multi_pod else "single", **body}
    if record_hlo:
        rec["ops"] = ops
    return rec


def build_federated(cfg, mesh, local_steps: int = 4, batch_per_client: int = 128,
                    seq: int = 4096, compress_bits: int = 0, lr: float = 1e-3):
    """(round_fn, args) of the scale-out FedLECC round
    (``federated.scaleout``'s ``make_federated_round``) for this rank of
    ``mesh`` (a dry one): ``args`` are ``meta`` tensors, the parameters
    stacked over the rank's pods and their training batches of
    ``batch_per_client`` x ``seq`` positions each (``input_specs``: tokens,
    frames, or patches and tokens), and the (n_pods,) weights.  Where
    ``step_storage`` says ``"sharded"`` the parameters are the rank's
    blocks (``param_blocks``), each pod's batch its ``data`` share and the
    weights its pods' own: the rank's share of the reference's layout."""
    from repro_torch.federated.scaleout import make_federated_round, stack_for_clients

    n_local = len(mesh.pods)
    whole = abstract_params(cfg)
    one = input_specs(cfg, InputShape("fedround", seq, batch_per_client, "train"))
    batch = {k: torch.empty((n_local, *t.shape), dtype=t.dtype, device="meta")
             for k, t in one.items()}
    if step_storage(cfg, mesh, "federated_round") == "sharded":
        whole = param_blocks(whole, cfg, mesh)
        batch = shard_tree(batch, {k: (None, "data") for k in batch}, mesh)
    params = stack_for_clients(whole, n_local)
    n_weights = n_local if step_storage(cfg, mesh, "federated_round") == "sharded" else \
        mesh.shape["pod"]
    weights = torch.empty((n_weights,), dtype=torch.float32, device="meta")
    round_fn = make_federated_round(cfg, mesh, lr=lr, local_steps=local_steps,
                                    compress_bits=compress_bits)
    return round_fn, (params, batch, weights)


def run_federated(arch: str, local_steps: int = 4, batch_per_client: int = 128,
                  seq: int = 4096, compress_bits: int = 0, path: str = "cuda") -> dict:
    """Trace the scale-out FedLECC round (``build_federated``) for rank 0 of
    the reference's production mesh of 2 pods x 16 data x 16 model
    (``make_production_mesh(multi_pod=True, dry=True)``): one pod a
    process, ``local_steps`` of SGD on its pod's batch of
    ``batch_per_client`` x ``seq`` tokens, K1 over its row, then the sum
    over ``pod`` (an all-reduce); with ``compress_bits`` the rank's block
    of each leaf quantized, its int8 rows and ``scale * w`` gathered over
    ``pod``.  The collectives are tallied under the
    reference's kind names.  ``argument_size`` is one device's share under
    the reference's layout (each leaf ``("pod", *storage spec)``, the batch
    over ``pod`` and ``data``, the weights over ``pod``);
    ``argument_size_held`` the port rank's: that share where ``storage``
    is ``"sharded"``, else every leaf and its pod's batch whole."""
    cfg = get_config(arch)
    mesh = make_production_mesh(multi_pod=True, dry=True)
    n_pods = mesh.shape["pod"]
    round_fn, args = build_federated(cfg, mesh, local_steps, batch_per_client, seq,
                                     compress_bits)
    traced = trace(round_fn, args, path)
    whole = abstract_params(cfg)
    policy = make_policy(mesh, batch_per_client * n_pods)
    inner = spec_leaves(policy.shardings(transformer_specs(cfg), whole))

    # the reference's arguments are every pod's: one device's share of the
    # (n_pods, ...) leaves, batch and weights
    def share(spec, leaf):
        return math.prod(shard_shape(mesh, spec, (n_pods, *leaf.shape))) * leaf.element_size()

    one = input_specs(cfg, InputShape("fedround", seq, batch_per_client, "train"))
    arg_size = sum(share(("pod", *sp), leaf) for sp, leaf in zip(inner, _tensors(whole)))
    arg_size += sum(share(("pod", "data"), t) for t in one.values())
    arg_size += share(("pod",), args[2][0])
    return {
        "arch": arch, "config_name": cfg.name,
        "shape": f"fedround_b{batch_per_client}x{seq}_E{local_steps}_q{compress_bits}",
        "mesh": "multi", "n_devices": mesh.size(), "kind": "federated_round", "path": path,
        "storage": step_storage(cfg, mesh, "federated_round"),
        **_record(traced, arg_size),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="a config name, or several joined by commas")
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true", help="all (arch x shape) pairs")
    ap.add_argument("--out", default="results/dryrun_torch.jsonl")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--policy", default="baseline", choices=["baseline", "fsdp"])
    ap.add_argument("--path", default="cuda", choices=list(PATHS),
                    help="cuda: the kernels' meta branches (the card's path); cpu: their "
                         "plain versions")
    ap.add_argument("--federated", action="store_true",
                    help="trace the scale-out FedLECC round instead of plain steps (for "
                         "--arch, qwen3-14b without one, or every arch with --all)")
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    if args.federated:
        rc = 0
        for arch in list_configs() if args.all else (args.arch or "qwen3-14b").split(","):
            for bits in (0, 8):
                try:
                    rec = run_federated(arch, compress_bits=bits, path=args.path)
                    status = "OK"
                except Exception as e:
                    rec = {"arch": arch, "shape": f"fedround_q{bits}", "mesh": "multi",
                           "error": f"{type(e).__name__}: {e}"}
                    status = "FAIL"
                    rc = 1
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                detail = rec.get("error") or (
                    f"trace={rec['t_trace_s']}s flops={rec['flops']:.3e} coll="
                    f"{ {k: round(v / 1e9, 2) for k, v in rec['collective_bytes'].items()} }GB")
                print(f"[{status}] federated_round {arch} q{bits}: {detail}", flush=True)
        sys.exit(rc)

    archs = list_configs() if (args.all or args.arch is None) else args.arch.split(",")
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    done = set()
    if args.skip_done and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if "error" not in r:
                    done.add((r["arch"], r["shape"], r["mesh"]))
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                if (arch, shape, mesh_kind) in done:
                    continue
                try:
                    rec = run_one(arch, shape, multi_pod=(mesh_kind == "multi"),
                                  policy_variant=args.policy, path=args.path)
                    status = "OK"
                except Exception as e:  # record failures: they are bugs
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "error": f"{type(e).__name__}: {e}"}
                    status = "FAIL"
                    n_fail += 1
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                msg = rec.get("error") or (
                    f"trace={rec['t_trace_s']}s flops={rec['flops']:.3e} "
                    f"temp={rec['memory']['temp_size'] / 2**30:.2f}GiB")
                print(f"[{status}] {arch} x {shape} x {mesh_kind}: {msg}", flush=True)
    sys.exit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
