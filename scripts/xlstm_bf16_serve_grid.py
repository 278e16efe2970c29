#!/usr/bin/env python
"""How far xlstm-125m's served logits move between two correct ways of
summing its products, on the (pod 2, data 2, model 2) grid of
``chip_smoke.py``'s ``serve grid:`` and in one process: the readings behind
that phase's bf16 bound for xlstm-125m (``SERVE_GRID_BF16_TOL``) and behind
its update bound for the 1-step grid round (``GRID_UPDATE_TOL``).

xlstm-125m is cut to 4 layers at full width, with ``init_params``' weights
from seed 0.  The serve runs are ``chip_smoke.py``'s: ``BatchScheduler``
with 8 requests of 128 tokens (seed 7), 16 new tokens each, every step's
logits recorded.  It serves them in one process (the world of one) in fp32
and bf16, and once more in bf16 with each block's down projection summed
in fp32 and rounded once (the same function, its sums in another order);
then in eight gloo processes on the grid, each on its blocks: as the port
runs (bf16 and fp32), with the row blocks' partial outputs kept in fp32
until their sum over ``model`` and rounded once, and with ``core_norm``'s
sum of squares over ``model`` dropped (a control: a wrong grid).  It
prints each pair's largest logit difference relative to max(1, |logits|)
over the steps where the rows' tokens agree, as ``chip_smoke.py``
compares them.

``--rounds``: the scale-out round of one local step instead (lr 0.05, 8
sequences of 128 tokens a pod, FedAvg weights 0.25 / 0.75, fp32), in the
world of one and on the grid, each rank's blocks against the world of
one's cut to them, relative to max(1, |leaf|) and to the leaf's update;
``--control`` drops ``core_norm``'s backward sum over ``model``.

On a card each process takes the one card (about 3 minutes in all on an
H100); without one, the CPU (about 2 minutes; ``--rounds`` longer).

    PYTHONPATH=src python scripts/xlstm_bf16_serve_grid.py [--rounds [--control]]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.nn.functional as F

ROWS, PROMPT, NEW, LAYERS = 8, 128, 16, 4
GRID = {"data": 2, "model": 2, "pod": 2}
WORLD = 8
_PORT: dict = {}


def _device():
    if torch.cuda.is_available():
        torch.cuda.set_device(0)
        return torch.device("cuda", 0)
    torch.set_num_threads(1 if dist.is_initialized() else 8)
    return torch.device("cpu")


def _cfg(dtype):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("xlstm-125m"), n_layers=LAYERS, dtype=dtype)


def _variant(mode):
    """Patch ``ssm._xlstm_out`` for ``mode``: "fp32-sum" (the world of one's
    down projection, or the grid's row blocks, summed in fp32 and rounded
    once), "no-norm-sum" (the grid's ``core_norm`` without its sum over
    ``model``), "no-norm-grad-sum" (without its backward sum); "port"
    leaves the port as it is."""
    from repro_torch.models import ssm
    from repro_torch.models.common import linear, per_client, rms_norm, row_out

    _PORT.setdefault("out", ssm._xlstm_out)
    if mode == "port":
        ssm._xlstm_out = _PORT["out"]
        return

    def norm(y, scale, eps, tp):
        if tp is None or mode == "fp32-sum":
            return rms_norm(y, scale, eps, mesh=tp)
        yf = y.to(torch.float32)
        ss = (yf * yf).sum(-1, keepdim=True)
        if mode == "no-norm-grad-sum":
            ss = tp.all_reduce_sum(ss, "model")
        var = ss / (y.shape[-1] * tp.shape["model"])
        return (yf * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))).to(y.dtype)

    def out(p, cfg, x, y, out_gate, tp=None):
        y = y.reshape(*x.shape[:-1], -1).to(x.dtype)
        y = norm(y, per_client(p["core_norm"], y), cfg.norm_eps, tp)
        h = y * F.silu(out_gate)
        if mode == "fp32-sum":
            o = linear(h.float(), p["w_down"].float())
            return (o if tp is None else row_out(o, tp)).to(x.dtype)
        o = linear(h, p["w_down"])
        return o if tp is None else row_out(o, tp)

    ssm._xlstm_out = out


def _serve(cfg, params, mesh):
    from repro_torch.configs.inputs import dummy_batch
    from repro_torch.serving import BatchScheduler

    class Recording(BatchScheduler):
        def _greedy(self, logits):
            self.seen.append(logits.float().cpu())
            return super()._greedy(logits)

    prompts = list(dummy_batch(cfg, ROWS, PROMPT, seed=7)["tokens"].numpy())
    sched = Recording(cfg, params, max_batch=ROWS, max_new=NEW, mesh=mesh)
    sched.seen = []
    ids = [sched.submit(p) for p in prompts]
    sched.run()
    return {"tokens": [sched.result(i).tolist() for i in ids], "logits": torch.stack(sched.seen)}


def _against(run, want):
    same = [[g[:i] == w[:i] for i in range(NEW)] for g, w in zip(run["tokens"], want["tokens"])]
    mask = torch.tensor(same).T[:, :, None]
    diff = ((run["logits"] - want["logits"]).abs() * mask).max().item()
    return {"relative": diff / max(1.0, want["logits"].abs().max().item()),
            "row_steps_compared": int(mask.sum()), "of": mask.numel()}


def _init(rank, store):
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=WORLD, rank=rank)
    from repro_torch.launch.mesh import make_host_mesh

    return make_host_mesh(**GRID)


def _serve_rank(rank, out, mode, dtype):
    from repro_torch.device import pin_fp32_matmul
    from repro_torch.models.transformer import init_params, param_blocks

    pin_fp32_matmul()
    _variant(mode)
    mesh = _init(rank, f"{out}/store_serve_{mode}_{dtype}")
    dev = _device()
    cfg = _cfg(dtype)
    blocks = param_blocks(init_params(torch.Generator(dev).manual_seed(0), cfg), cfg, mesh)
    run = _serve(cfg, blocks, mesh)
    if rank == 0:
        torch.save(run, f"{out}/grid_{mode}_{dtype}.pt")
    dist.destroy_process_group()


def _round(cfg, params, mesh, batch, dev):
    from repro_torch.federated.scaleout import make_federated_round, stack_for_clients

    fn = make_federated_round(cfg, mesh, lr=0.05, local_steps=1)
    pods = 1 if getattr(mesh, "grid", False) else GRID["pod"]
    return fn(stack_for_clients(params, pods), batch, torch.tensor((0.25, 0.75), device=dev))


def _round_rank(rank, out, mode):
    from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten

    from repro_torch.configs.inputs import dummy_batch
    from repro_torch.device import pin_fp32_matmul
    from repro_torch.models.transformer import init_params, param_blocks

    pin_fp32_matmul()
    _variant(mode)
    mesh = _init(rank, f"{out}/store_round_{mode}")
    dev = _device()
    cfg = _cfg("float32")
    whole = init_params(torch.Generator(dev).manual_seed(0), cfg)
    spec = tree_flatten(whole)[1]
    blocks = param_blocks(whole, cfg, mesh)
    start = [x.clone() for x in tree_leaves(blocks)]
    pod, d = mesh.coords["pod"], mesh.coords["data"]
    share = ROWS // GRID["data"]
    batch = {k: v[None, d * share:(d + 1) * share].to(dev)
             for k, v in dummy_batch(cfg, ROWS, PROMPT, seed=pod).items()}
    new, losses = _round(cfg, blocks, mesh, batch, dev)
    ref = torch.load(f"{out}/round_world_of_one.pt")
    want = tree_leaves(param_blocks(tree_unflatten([r.to(dev) for r in ref], spec), cfg, mesh))
    got = [x[0] for x in tree_leaves(new)]
    rel_leaf = rel_update = 0.0
    worst = None
    for i, (g, w, s) in enumerate(zip(got, want, start, strict=True)):
        e = (g - w).abs().max().item()
        rel_leaf = max(rel_leaf, e / max(1.0, w.abs().max().item()))
        u = (w - s).abs().max().item()
        r = e / u if u > 0 else (0.0 if e == 0 else float("inf"))
        if r > rel_update:
            rel_update, worst = r, {"leaf": i, "shape": list(w.shape), "largest_update": u}
    print(json.dumps({"rank": rank, "losses": losses.tolist(), "relative_to_leaf": rel_leaf,
                      "relative_to_update": rel_update, "worst": worst}), flush=True)
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", action="store_true")
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args()
    from repro_torch.device import pin_fp32_matmul
    from repro_torch.models.transformer import init_params

    pin_fp32_matmul()
    dev = _device()
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as out:
        if args.rounds:
            from torch.utils._pytree import tree_leaves

            from repro_torch.configs.inputs import dummy_batch
            from repro_torch.launch.mesh import make_host_mesh

            cfg = _cfg("float32")
            pods = [dummy_batch(cfg, ROWS, PROMPT, seed=p) for p in range(GRID["pod"])]
            batch = {k: torch.stack([b[k] for b in pods]).to(dev) for k in pods[0]}
            new, losses = _round(cfg, init_params(torch.Generator(dev).manual_seed(0), cfg),
                                 make_host_mesh(pod=GRID["pod"]), batch, dev)
            print(f"world of one: losses {losses.tolist()}", flush=True)
            torch.save([x[0].cpu() for x in tree_leaves(new)], f"{out}/round_world_of_one.pt")
            mode = "no-norm-grad-sum" if args.control else "port"
            mp.spawn(_round_rank, args=(out, mode), nprocs=WORLD)
            return
        runs = {}
        for mode, dtype in (("port", "float32"), ("port", "bfloat16"), ("fp32-sum", "bfloat16")):
            _variant(mode)
            cfg = _cfg(dtype)
            runs[f"world of one, {mode}, {dtype}"] = _serve(
                cfg, init_params(torch.Generator(dev).manual_seed(0), cfg), None)
            _variant("port")
        for mode, dtype in (("port", "bfloat16"), ("fp32-sum", "bfloat16"),
                            ("no-norm-sum", "bfloat16"), ("port", "float32")):
            t = time.time()
            mp.spawn(_serve_rank, args=(out, mode, dtype), nprocs=WORLD)
            runs[f"grid, {mode}, {dtype}"] = torch.load(f"{out}/grid_{mode}_{dtype}.pt")
            print(f"grid {mode} {dtype}: {time.time() - t:.1f} s", flush=True)
        one = "world of one, port, "
        for a, b in ((one + "bfloat16", one + "float32"),
                     ("world of one, fp32-sum, bfloat16", one + "bfloat16"),
                     ("grid, port, bfloat16", one + "bfloat16"),
                     ("grid, fp32-sum, bfloat16", one + "bfloat16"),
                     ("grid, fp32-sum, bfloat16", "world of one, fp32-sum, bfloat16"),
                     ("grid, no-norm-sum, bfloat16", one + "bfloat16"),
                     ("grid, port, float32", one + "float32")):
            print(f"{a} against {b}: {json.dumps(_against(runs[a], runs[b]))}", flush=True)


if __name__ == "__main__":
    main()
