"""Storage sharding: ``loss_fn`` and its gradient on a rank's blocks
against the reference's unsharded ``loss_fn`` and ``jax.grad`` on the CPU.

Two gloo worlds run side by side, each one launch of its processes (a
file store in the test's directory, one intra-op thread each): a world of
2 (``make_host_mesh(1, 2)``: model 2) and a world of 4
(``make_host_mesh(2, 2)``: data 2 x model 2).  The weights are drawn once
(``init_params`` in fp32) and handed to both sides as the reference's
stacked numpy tree.  Every rank cuts them into its blocks under the
baseline policy
(``convert.blocks_from_jax``), takes its ``data`` share of the batch and
computes ``loss_fn(blocks, cfg, share, mesh)`` and the gradient of every
block.  Meanwhile this process computes the reference's loss and
``jax.grad`` on the whole tree and batch.

Cases (fp32, B = 4, S = 32, the loss over chunks of 16 positions):
reduced stablelm-3b (LayerNorm, GeLU, partial RoPE), glm4-9b, gemma3-27b
(the tied vocab-parallel head, a window of 16 that bites) and qwen3-14b
(qk-norm), which all split on whole heads at model 2; a micro config whose
q split falls mid-head, as qwen3-14b's does on 16 (3 heads: every
projection gathered, the layer replicated over ``model``), and one whose
kv split falls mid-head, as glm4-9b's does (4 q heads over 1 kv head: the
kv projections gathered, their gradients summed over ``model``).
Hymba: reduced hymba-1.5b (4 heads on whole heads, a window of 16 that
bites) and a micro hymba whose q split falls mid-head, as full
hymba-1.5b's 25 heads do on 2 and on 16 (3 heads: the attention computed
replicated), both with the Mamba heads on each rank's channel block
(``w_in`` gathered, B and C summed over ``model`` both ways).  The modal
inputs: reduced internvl2-1b (8 patches in front of 24 tokens; the loss
mask's sum over ``data``) and musicgen-large (frames through the
replicated ``frame_norm``, drawn away from zero so that it enters every
number; the untied ``embed`` table read by nothing).  The table paths:
every other case's vocab splits over ``model`` (the vocab-parallel lookup
and cross-entropy); the micro hymba's vocab of 65 does not, as full
hymba-1.5b's 32001 and internvl2-1b's 151655 do not, so its table and
head stay whole and the cross-entropy is computed replicated.

xLSTM: reduced xlstm-125m with one mLSTM and one sLSTM layer (layers
"MS"; reduced "MMMS" holds two mLSTM), its 2 heads on whole heads at model
2 (``w_up`` gathered, ``core_norm``'s sum of squares over ``model`` both
ways), and a micro xLSTM whose 3 heads split mid-head (computed
replicated).

MoE and MLA: reduced dbrx-132b and deepseek-v3-671b (its MTP head on)
with the capacity dispatch at a capacity factor of 0.5, so that experts
overflow: their 4 experts over ``model`` and the experts' FFN columns
over ``data``, deepseek's shared expert tensor-parallel and its MLA on
the rank's 2 of 4 heads, the latent and k_rope cache replicated over
``model``.  Both worlds take rule 1 of the reference's dispatch (the
rank's experts exchanged whole by an all-to-all), so these cases are held
against the reference under its mesh (``_MESH_REFERENCE``: a subprocess
on 4 virtual devices, ``loss_fn``, ``jax.grad``, ``prefill`` and
``decode_step`` with the mesh), whose dispatch drops what the port's
does, and not its unsharded path (``moe_dense``, which drops nothing).

Serving, in the same worlds on the same blocks: every case's prefill of
the batch's first 4 rows (2 a data rank in the world of 4) and
``SERVE_STEPS`` greedy decode steps (the frames model decodes its next
frames), hymba's of 3 rows that the data axes do not divide (every
rank holds every row) and the batches of one of ``ONE_ROW`` (deepseek's
latent sequence split over the data ranks), against the reference's
unsharded ``prefill`` and ``decode_step`` on the whole tree, jitted in
this process (the MoE cases: under its mesh): the logits
within ``SERVE_TOL`` of max(1, |ref|), the greedy tokens exactly, each
rank's cache block (after prefill and at the end) within ``SERVE_TOL``
element by element of the reference's cache cut to it
(``transformer.cache_layout``); and ``BatchScheduler(mesh=)`` on reduced
stablelm-3b, hymba-1.5b and xlstm-125m, groups of 4 and 3 rows, making the
unsharded scheduler's tokens.

Every rank's loss equals the reference's within ``LOSS_ATOL`` (fp32: the
vocab-parallel log-sum-exp and the sums over ranks add in another order),
and each of its gradient blocks equals the reference's gradient, cut to
that rank's block, within ``GRAD_ATOL`` times max(1, the leaf's largest
|gradient|); so do the blocks gathered whole (``sharding.gather_tree``)
on rank 0.  Outside the worlds: ``init_param_blocks`` (the leaf-by-leaf
build) against ``param_blocks(init_params(...))`` bit for bit, and MLA's
decode over a latent cache split into blocks against the whole cache's.
"""

import json
import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._pytree import tree_flatten, tree_leaves  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.inputs import dummy_batch  # noqa: E402
from repro_torch.convert import serving_params_from_jax  # noqa: E402
from repro_torch.convert import cache_from_jax  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    cache_layout,
    init_params,
    param_blocks,
    shards_storage,
)
from repro_torch.serving import BatchScheduler  # noqa: E402
from repro_torch.sharding import shard_tree  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
LOSS_ATOL = 1e-5
GRAD_ATOL = 1e-5
SERVE_TOL = 1e-5
B, S = 4, 32
WORLDS = {2: (1, 2), 4: (2, 2)}   # world size: (data, model)
# the cases, importable by the world's processes (which import no jax)
_CASE = """
import dataclasses

MICRO = dict(d_model=64, n_heads=3, n_kv_heads=1, head_dim=16, d_ff=128, vocab=64)
OVERFLOW = dict(impl="capacity", capacity_factor=0.5)
# name: (the reduced config it starts from, the fields it changes)
CASES = {
    "stablelm-3b": ("stablelm-3b", {}),
    "glm4-9b": ("glm4-9b", {}),
    # one local layer and one global, the window of 16 biting on the first
    "gemma3-27b": ("gemma3-27b", {"sliding_window": 16, "layer_pattern": "LG"}),
    "qwen3-14b": ("qwen3-14b", {}),
    "q_mid_head": ("qwen3-14b", MICRO),
    "kv_mid_head": ("glm4-9b", MICRO | {"n_heads": 4}),
    "hymba-1.5b": ("hymba-1.5b", {"sliding_window": 16}),
    "hymba_q_mid_head": ("hymba-1.5b", MICRO | {"sliding_window": 16, "vocab": 65}),
    "internvl2-1b": ("internvl2-1b", {}),
    "musicgen-large": ("musicgen-large", {}),
    # "MS": one mLSTM and one sLSTM layer (reduced "MMMS" holds two mLSTM)
    "xlstm-125m": ("xlstm-125m", {"layer_pattern": "MS"}),
    "xlstm_mid_head": ("xlstm-125m", {"layer_pattern": "MS", "d_model": 48, "ssm_heads": 3}),
    # the MoE (4 experts over model, their FFN columns over data) and MLA
    # (4 heads over model, the MTP head) models, the capacity dispatch with
    # a factor of 0.5 so that experts overflow
    "dbrx-132b": ("dbrx-132b", {"moe": OVERFLOW}),
    "deepseek-v3-671b": ("deepseek-v3-671b", {"moe": OVERFLOW}),
}
# the cases the reference runs under its mesh (the capacity dispatch), not
# unsharded (moe_dense, which drops nothing)
MESH_CASES = ("dbrx-132b", "deepseek-v3-671b")
# serving: prefill and SERVE_STEPS greedy decode steps of the first rows of
# the case's batch, each run (rows, prompt length, cache length): 4 rows of
# the whole prompt (the data axes divide them); for hymba (a kv cache and a
# recurrent state) also 3 (they do not: every rank holds every row and, on
# the world of 4, its half of the k / v cache's 40 positions, the prompt in
# both halves, the window of 16 leaving the first half with no valid
# position on the local layer from position 35 on); and a batch of one of
# ONE_ROW's prompt and cache lengths, on its halves of the sequence:
# stablelm-3b's prompt of 12 in a cache of 32 (the second half with no
# valid position until the step at 16), gemma3-27b's prompt of 32 in 40
# (its window crossing the halves' boundary at 20 from position 32, the
# first half with no valid position on the local layer from 35 on, the
# global layer reading both), deepseek-v3-671b's 12 in 32 (its latent and
# k_rope cache split as stablelm's k and v)
SERVE_STEPS = 8
UNDIVIDED = ("hymba-1.5b",)
ONE_ROW = {"stablelm-3b": (12, 32), "gemma3-27b": (32, 40), "deepseek-v3-671b": (12, 32)}
# BatchScheduler(mesh=): two prompt lengths, groups of max_batch 4 and 3;
# the groups of 3 and of 1 hold caches of 22 and 18 positions, which the
# world of 4's two data ranks split
SCHEDULED = ("stablelm-3b", "hymba-1.5b", "xlstm-125m")
SCHED_LENS, SCHED_NEW = (16, 16, 16, 16, 12), 6


def make_cfg(get, name):
    arch, kw = CASES[name]
    kw = dict(kw)
    heads, moe = kw.pop("ssm_heads", None), kw.pop("moe", None)
    cfg = dataclasses.replace(get(arch, reduced=True), loss_chunk=16, **kw)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    if heads:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, n_heads=heads))
    return cfg


def serve_runs(name, s):
    '''The case's serving runs, (rows, prompt length, cache length), for
    its batch's sequences of s positions.'''
    runs = [(4, s, s + SERVE_STEPS)]
    if name in UNDIVIDED:
        runs.append((3, s, s + SERVE_STEPS))
    if name in ONE_ROW:
        runs.append((1, *ONE_ROW[name]))
    return runs


def prompts(tokens):
    '''The scheduler's requests: request i the first SCHED_LENS[i] tokens
    of row i of the batch, cyclically.'''
    return [tokens[i % len(tokens), :n] for i, n in enumerate(SCHED_LENS)]
"""
exec(_CASE)


_WORLD = r"""
import os, pickle, sys
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_unflatten

torch.set_num_threads(1)
rank, world, data, model = (int(a) for a in sys.argv[1:5])
work = sys.argv[5]
dist.init_process_group("gloo", init_method="file://" + os.path.join(work, f"store{world}"),
                        world_size=world, rank=rank)
sys.path.insert(0, work)
from shard_case import (CASES, SCHED_NEW, SCHEDULED, SERVE_STEPS, make_cfg, prompts,
                        serve_runs)
from repro_torch.configs import get_config
from repro_torch.convert import blocks_from_jax
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.transformer import (abstract_params, batch_rows, decode_step, loss_fn,
                                            prefill, transformer_specs)
from repro_torch.serving import BatchScheduler
from repro_torch.sharding import gather_tree, make_policy

mesh = make_host_mesh(data, model)
with open(os.path.join(work, "case.pkl"), "rb") as f:
    case = pickle.load(f)
out = {"coords": mesh.coords}
for name in CASES:
    cfg = make_cfg(get_config, name)
    tree, batch = case[name]
    leaves, spec = tree_flatten(blocks_from_jax(tree, cfg, mesh))
    share = len(batch["labels"]) // data
    lo = mesh.axis_index("data") * share
    mine = {k: torch.from_numpy(v[lo:lo + share]) for k, v in batch.items()}
    leaves = [p.requires_grad_(True) for p in leaves]
    loss, _ = loss_fn(tree_unflatten(leaves, spec), cfg, mine, mesh)
    grads = [g.detach() for g in torch.autograd.grad(loss, leaves, allow_unused=True,
                                                      materialize_grads=True)]
    whole = abstract_params(cfg)
    specs = make_policy(mesh, 0).shardings(transformer_specs(cfg), whole)
    gathered = gather_tree(tree_unflatten(grads, spec), specs, mesh)
    out[name] = {"loss": float(loss), "grads": grads,
                 "gathered": tree_flatten(gathered)[0] if rank == 0 else None}
    # serving on the blocks: prefill, then greedy decode steps (frames: the
    # case's next frames), the logits and the cache block after each end;
    # decode_step reads the whole cache's length from the block
    blocks = tree_unflatten([p.detach() for p in leaves], spec)
    for b, s, max_len in serve_runs(name, len(batch["labels"][0])):
        lo, n = batch_rows(mesh, b)
        mine = {k: torch.from_numpy(v[lo:lo + n, :s]) for k, v in batch.items()
                if k != "labels"}
        logits, cache = prefill(blocks, cfg, mine, max_len, mesh=mesh, batch_size=b)
        seen, first = [logits], {k: v.clone() if torch.is_tensor(v) else
                                 tuple(t.clone() for t in v) for k, v in cache.items()}
        for i in range(SERVE_STEPS):
            step = ({"frame": torch.from_numpy(case["frames"][i][:b])}
                    if cfg.input_mode == "frames" else {"token": logits.argmax(-1)[:, None]})
            logits, cache = decode_step(blocks, cfg, step, cache, s + i, mesh=mesh)
            seen.append(logits)
        out[name][f"serve{b}"] = {"logits": torch.stack(seen), "prefill_cache": first,
                                  "cache": cache}
    if name in SCHEDULED:
        toks = prompts(batch["tokens"])
        for mb in (4, 3):
            sched = BatchScheduler(cfg, blocks, max_batch=mb, max_new=SCHED_NEW, mesh=mesh)
            ids = [sched.submit(t) for t in toks]
            sched.run()
            out[name][f"sched{mb}"] = [sched.result(i).tolist() for i in ids]
torch.save(out, os.path.join(work, f"world{world}_rank{rank}.pt"))
dist.destroy_process_group()
"""


# the reference under its mesh for MESH_CASES: a (data, model) mesh of
# Auto axes over the first 2 or 4 of 4 virtual devices (jax 0.9's default
# Explicit axes make the reference's decode cache constraint raise), the
# loss and jax.grad, prefill and the greedy decode steps of each serving run
_MESH_REFERENCE = r"""
import json, os, pickle, sys
from concurrent.futures import ThreadPoolExecutor
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
work = sys.argv[1]
sys.path.insert(0, work)
from shard_case import MESH_CASES, SERVE_STEPS, make_cfg, serve_runs
from repro.configs import get_config
from repro.models import transformer as tf

with open(os.path.join(work, "case.pkl"), "rb") as f:
    case = pickle.load(f)
worlds = {int(n): tuple(dm) for n, dm in json.loads(sys.argv[2]).items()}


def run(name, world):
    cfg = make_cfg(get_config, name)
    tree, batch = case[name]
    mesh = jax.make_mesh(worlds[world], ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2,
                         devices=jax.devices()[:world])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(lambda p, b: tf.loss_fn(p, cfg, b, mesh),
                                                  has_aux=True))(tree, jb)
    step = jax.jit(lambda p, bt, c, pos: tf.decode_step(p, cfg, bt, c, pos, mesh))
    served = {}
    for b, s, max_len in serve_runs(name, batch["tokens"].shape[1]):
        pre = jax.jit(lambda p, bt, n=max_len: tf.prefill(p, cfg, bt, n, mesh))
        logits, cache = pre(tree, {k: jnp.asarray(v[:b, :s]) for k, v in batch.items()
                                   if k != "labels"})
        seen, first = [logits], jax.tree.map(np.asarray, cache)
        for i in range(SERVE_STEPS):
            tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
            logits, cache = step(tree, {"token": tok}, cache, jnp.int32(s + i))
            seen.append(logits)
        served[b] = (np.stack([np.asarray(x) for x in seen]), first,
                     jax.tree.map(np.asarray, cache))
    return (name, world), ((float(loss), jax.tree.map(np.asarray, grads)), served)


with ThreadPoolExecutor(4) as pool:   # XLA compiles outside the GIL
    out = dict(pool.map(lambda nw: run(*nw), [(n, w) for n in MESH_CASES for w in worlds]))
with open(os.path.join(work, "mesh_reference.pkl"), "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Several test workers share the cores: one intra-op thread keeps this
    file's many small torch operations from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_tree(params):
    """``init_params``' tree as the reference's: numpy leaves, each layer
    leaf stacked on a leading axis, the keys in jax's order."""
    tree = {k: v.numpy() for k, v in params.items() if k != "layers"}
    tree["layers"] = jax.tree.map(lambda *xs: np.stack([x.numpy() for x in xs]),
                                  *params["layers"])
    return jax.tree.map(np.asarray, tree)


class _At:
    """A rank's place on a grid, as ``param_blocks`` and ``cache_layout``
    read a mesh."""

    grid = True

    def __init__(self, shape, coords):
        self.shape, self.axis_names, self.coords = shape, tuple(shape), coords

    def size(self, axes):
        return int(np.prod([self.shape[a] for a in axes]))

    def index(self, axes):
        idx = 0
        for a in ((axes,) if isinstance(axes, str) else axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    """The worlds' saved results and the reference's loss and gradient a
    case."""
    work = tmp_path_factory.mktemp("shard")
    (work / "shard_case.py").write_text(_CASE)
    case, cfgs = {}, {}
    for name in CASES:
        ref_cfg, cfg = make_cfg(ref_get_config, name), make_cfg(get_config, name)
        # the weights drawn by the port (faster than the reference's init here),
        # as the reference's stacked numpy tree; a frames model's zero
        # frame_norm drawn away from zero
        params = init_params(torch.Generator().manual_seed(0), cfg)
        if "frame_norm" in params:
            params["frame_norm"] = 0.3 * torch.randn(cfg.d_model,
                                                     generator=torch.Generator().manual_seed(1))
        tree = _numpy_tree(params)
        batch = {k: v.numpy() for k, v in dummy_batch(cfg, B, S, seed=1).items()}
        case[name], cfgs[name] = (tree, batch), (ref_cfg, cfg)
        if cfg.input_mode == "frames":     # the frames model's decode inputs
            rng = np.random.default_rng(2)
            case["frames"] = [rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
                              for _ in range(SERVE_STEPS)]
    with open(work / "case.pkl", "wb") as f:
        pickle.dump(case, f)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = [subprocess.Popen([sys.executable, "-c", _WORLD, str(r), str(n), *map(str, dm),
                               str(work)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for n, dm in WORLDS.items() for r in range(n)]
    ref_env = dict(env)
    ref_env.pop("XLA_FLAGS", None)
    procs.append(subprocess.Popen([sys.executable, "-c", _MESH_REFERENCE, str(work),
                                   json.dumps(WORLDS)], env=ref_env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True))
    def reference(name):
        (tree, batch), ref_cfg = case[name], cfgs[name][0]
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b: ref_tf.loss_fn(p, ref_cfg, b), has_aux=True))(tree, jb)
        return float(loss), jax.tree.map(np.asarray, grads)

    def reference_serve(name):
        """The reference's prefill and greedy decode steps, unsharded, for
        each of the case's serving runs, by rows: (logits, the cache after
        prefill, the cache at the end), numpy."""
        (tree, batch), ref_cfg = case[name], cfgs[name][0]
        step = jax.jit(lambda p, bt, c, pos: ref_tf.decode_step(p, ref_cfg, bt, c, pos))
        got = {}
        for b, s, max_len in serve_runs(name, S):
            pre = jax.jit(lambda p, bt, n=max_len: ref_tf.prefill(p, ref_cfg, bt, n))
            logits, cache = pre(tree, {k: jnp.asarray(v[:b, :s]) for k, v in batch.items()
                                       if k != "labels"})
            seen, first = [logits], jax.tree.map(np.asarray, cache)
            for i in range(SERVE_STEPS):
                inp = ({"frame": jnp.asarray(case["frames"][i][:b])}
                       if ref_cfg.input_mode == "frames" else
                       {"token": jnp.argmax(logits, -1)[:, None].astype(jnp.int32)})
                logits, cache = step(tree, inp, cache, jnp.int32(s + i))
                seen.append(logits)
            got[b] = (np.stack([np.asarray(x) for x in seen]), first,
                      jax.tree.map(np.asarray, cache))
        return got

    try:
        # XLA compiles outside the GIL: the cases' compiles overlap
        unsharded = [name for name in CASES if name not in MESH_CASES]
        with ThreadPoolExecutor(3) as pool:
            served = pool.map(reference_serve, unsharded)
            ref = dict(zip(unsharded, pool.map(reference, unsharded)))
            ref_serve = dict(zip(unsharded, served))
        # the unsharded port's scheduler on the same weights
        sched = {}
        for name in SCHEDULED:
            cfg = cfgs[name][1]
            params = serving_params_from_jax(case[name][0], cfg)
            for mb in (4, 3):
                one = BatchScheduler(cfg, params, max_batch=mb, max_new=SCHED_NEW)
                ids = [one.submit(t) for t in prompts(case[name][1]["tokens"])]
                one.run()
                sched[name, mb] = [one.result(i).tolist() for i in ids]
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    ranks = {n: [torch.load(work / f"world{n}_rank{r}.pt") for r in range(n)] for n in WORLDS}
    with open(work / "mesh_reference.pkl", "rb") as f:
        for (name, world), (loss_grads, served) in pickle.load(f).items():
            ref[name, world], ref_serve[name, world] = loss_grads, served
    return {"ref": ref, "ranks": ranks, "cfgs": cfgs, "serve": ref_serve, "sched": sched}


def _reference(shard, key, name, world):
    """The reference's results of a case for a world: under that world's
    mesh for MESH_CASES, else unsharded (the same for both worlds)."""
    return shard[key][(name, world) if name in MESH_CASES else name]


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_gradient_on_blocks_match_the_reference(shard, name, world):
    ref_cfg, cfg = shard["cfgs"][name]
    want_loss, want_grads = _reference(shard, "ref", name, world)
    data, model = WORLDS[world]
    shape = {"data": data, "model": model}
    whole = serving_params_from_jax(want_grads, cfg)
    for rank, got in enumerate(shard["ranks"][world]):
        assert got["coords"] == {"data": rank // model, "model": rank % model}
        assert abs(got[name]["loss"] - want_loss) <= LOSS_ATOL, (rank, got[name]["loss"],
                                                                 want_loss)
        want = tree_leaves(param_blocks(whole, cfg, _At(shape, got["coords"])))
        pairs = list(zip(got[name]["grads"], want, strict=True))
        if rank == 0:       # its blocks' gradients gathered whole over the world
            pairs += list(zip(got[name]["gathered"], tree_leaves(whole), strict=True))
        for j, (g, w) in enumerate(pairs):
            assert g.shape == w.shape, (rank, j, g.shape, w.shape)
            tol = GRAD_ATOL * max(1.0, float(w.abs().max()))
            err = float((g - w).abs().max())
            assert err <= tol, (rank, j, tuple(w.shape), err, tol)


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("name", list(CASES))
def test_serving_on_blocks_matches_the_reference(shard, name, world):
    """Prefill and ``SERVE_STEPS`` greedy decode steps on every rank's
    blocks against the reference's unsharded ``prefill`` and
    ``decode_step``: the logits within ``SERVE_TOL`` of max(1, |ref|)
    (every rank holds all of them), the greedy tokens exactly, and the
    rank's cache block, after prefill and at the end, within ``SERVE_TOL``
    of max(1, |ref|) element by element: its rows, or on the world of 4
    for 3 rows and 1 its block of the k / v sequence."""
    cfg = shard["cfgs"][name][1]
    data, model = WORLDS[world]
    shape = {"data": data, "model": model}
    cache_len = {b: n for b, _, n in serve_runs(name, S)}
    for b, (want_logits, want_first, want_end) in _reference(shard, "serve", name,
                                                             world).items():
        for rank, got in enumerate(shard["ranks"][world]):
            run = got[name][f"serve{b}"]
            logits = run["logits"]
            assert logits.shape == want_logits.shape, (rank, b)
            tol = SERVE_TOL * max(1.0, float(np.abs(want_logits).max()))
            err = float(np.abs(logits.numpy() - want_logits).max())
            assert err <= tol, (rank, b, err, tol)
            np.testing.assert_array_equal(logits.argmax(-1).numpy(), want_logits.argmax(-1))
            at = _At(shape, got["coords"])
            for mine, want in ((run["prefill_cache"], want_first), (run["cache"], want_end)):
                whole = cache_from_jax(want, cfg)
                layout = cache_layout(cfg, at, b, cache_len[b])
                if "k" in layout:   # the k / v sequence over data where the rows stay
                    split = data > 1 and b % data and cache_len[b] % data == 0
                    assert (*layout["k"], None, None, None)[2] == ("data" if split else None)
                block = shard_tree(whole, layout, at)
                assert set(mine) == set(block), (rank, b)
                for key in block:
                    gs, ws = (v if isinstance(v, (list, tuple)) else (v,)
                              for v in (mine[key], block[key]))
                    for g, w in zip(gs, ws, strict=True):
                        assert g.shape == w.shape, (rank, b, key, g.shape, w.shape)
                        bad = (g - w).abs() > SERVE_TOL * w.abs().clamp(min=1.0)
                        assert not bad.any(), (rank, b, key, float((g - w).abs().max()))


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_batch_scheduler_on_a_mesh_gives_the_unsharded_tokens(shard, world):
    """``BatchScheduler(..., mesh=)`` on every rank's blocks, groups of 4
    (rows split over the data axes) and of 3 and 1 (every row; on the
    world of 4 the k / v sequence split), makes the tokens of the
    unsharded scheduler on the same weights, on every rank."""
    for name in SCHEDULED:
        for mb in (4, 3):
            want = shard["sched"][name, mb]
            for rank, got in enumerate(shard["ranks"][world]):
                assert got[name][f"sched{mb}"] == want, (name, mb, rank)


def test_the_cases_shard_and_split_as_the_docstring_says():
    """The families shard on a grid, xLSTM among them, the MoE and MLA
    models do not; each case's q and kv blocks at model 2 fall on whole
    heads or not (an xLSTM case: its cores' heads), and its vocab splits
    over ``model`` or stays whole, as the module's docstring says; so do
    the full-width configs the card runs."""
    from repro_torch.launch.mesh import make_dry_mesh

    grid = make_dry_mesh(1, 2)
    whole_heads = {"q_mid_head": (False, False), "kv_mid_head": (True, False),
                   "hymba_q_mid_head": (False, False), "xlstm_mid_head": (False, False)}
    for name in CASES:
        cfg = make_cfg(get_config, name)
        assert shards_storage(cfg, grid) and not shards_storage(cfg, None)
        h, kv = cfg.n_heads, cfg.n_kv_heads
        if cfg.block_type == "xlstm":      # the cores' heads, one layer of each core
            h = kv = cfg.ssm.n_heads
            assert cfg.layer_pattern == "MS" and cfg.n_layers == 2, name
            assert cfg.d_model % 2 == 0, name
        assert (h % 2 == 0, kv % 2 == 0) == whole_heads.get(name, (True, True)), name
        assert (cfg.vocab % 2 == 0) == (name != "hymba_q_mid_head"), name
        if cfg.block_type == "hymba":      # the Mamba channels on whole blocks
            assert cfg.d_model % 2 == 0, name
    assert shards_storage(get_config("xlstm-125m", reduced=True), grid)
    # the MoE and MLA models shard too: on the card's (pod 2, data 2, model 2)
    # grid dbrx-132b's 16 experts take rule 1 (2 whole experts a rank, E / 8),
    # deepseek-v3-671b's 128 MLA heads split on whole heads at model 2 and 16
    for name in ("dbrx-132b", "deepseek-v3-671b"):
        assert shards_storage(get_config(name, reduced=True), grid), name
    dbrx, deepseek = get_config("dbrx-132b"), get_config("deepseek-v3-671b")
    assert dbrx.moe.n_experts % 8 == 0 and dbrx.moe.d_expert % 2 == 0
    assert deepseek.n_heads % 16 == 0 and deepseek.moe.n_experts % 16 == 0
    # full width at model 2 and 16: hymba's 25 q heads split mid-head (its
    # attention replicated), its 1600 channels on whole blocks, internvl2's
    # 14 / 2 kv and musicgen's 32 heads on whole heads at 2; hymba's and
    # internvl2's vocab stay whole, musicgen's splits; xlstm-125m's 4 heads
    # split on whole heads at 2 and mid-head at 16 (computed replicated)
    hymba, vlm, frames, xlstm = (get_config(n) for n in ("hymba-1.5b", "internvl2-1b",
                                                          "musicgen-large", "xlstm-125m"))
    for model in (2, 16):
        assert hymba.n_heads % model and hymba.d_model % model == 0
        assert hymba.vocab % model and vlm.vocab % model and frames.vocab % model == 0
        assert xlstm.d_model % model == 0 and xlstm.vocab % model == 0
    assert vlm.n_heads % 2 == vlm.n_kv_heads % 2 == frames.n_heads % 2 == 0
    assert xlstm.ssm.n_heads % 2 == 0 and xlstm.ssm.n_heads % 16


@pytest.mark.parametrize("name", ["stablelm-3b", "hymba-1.5b", "deepseek-v3-671b"])
def test_cache_layout_splits_the_sequence_where_the_reference_constraint_does(name,
                                                                               monkeypatch):
    """``cache_layout``'s k / v leaf (L, B, S, KV, hd) (MLA: its latent (L,
    B, S, kv_lora_rank)) puts the data axes on the rows, on the sequence or
    on neither exactly where the reference's ``_cache_constraint`` puts
    them on a layer's leaf (B, S, KV, hd): rows where the data axes divide
    a batch larger than 1, else the sequence where they divide its length
    (a batch of one, or 3), else neither (a length they do not divide);
    MLA's latent stays whole over ``model``.  The reference's constraint is
    read by standing in for ``with_sharding_constraint``."""
    import jax.sharding

    seen = []
    monkeypatch.setattr(jax.sharding, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda leaf, spec: seen.append(tuple(spec)) or leaf)

    def placed(spec, dims):   # the dimension the data axes split, or None
        for dim, entry in zip(dims, (*spec, None, None)):
            axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
            if "data" in axes:
                return dim
        return None

    cfg = make_cfg(get_config, name)
    key = "latent" if cfg.use_mla else "k"
    tail = (cfg.kv_lora_rank,) if cfg.use_mla else (cfg.n_kv_heads, cfg.resolved_head_dim)
    ways = set()
    for shape in ({"data": 2, "model": 2}, {"pod": 2, "data": 2, "model": 2},
                  {"data": 4, "model": 1}):
        at = _At(shape, dict.fromkeys(shape, 0))
        for b in (1, 3, 4, 8):
            for max_len in (40, 41, 36):
                seen.clear()
                ref_tf._cache_constraint({key: np.zeros((b, max_len, *tail), np.float32)}, at)
                want = placed(seen[0], ("rows", "seq")) if seen else None
                spec = cache_layout(cfg, at, b, max_len)[key]
                got = placed(spec[1:], ("rows", "seq"))
                if cfg.use_mla:      # no head axis: replicated over model
                    assert "model" not in repr(spec), spec
                assert got == want, (shape, b, max_len, got, want)
                ways.add(got)
    assert ways == {"rows", "seq", None}


class _Ranks:
    """n threads standing for the ranks of a mesh's data axis: each
    collective waits for all n and gives each the reduction of their
    tensors, in rank order."""

    def __init__(self, n):
        import threading

        self.shape, self.axis_names = {"data": n, "model": 1}, ("data", "model")
        self.barrier, self.slots, self.local = threading.Barrier(n), [None] * n, threading.local()

    def _reduce(self, t, op):
        self.slots[self.local.rank] = t.clone()
        self.barrier.wait()
        out = op(torch.stack(self.slots))
        self.barrier.wait()
        return t.copy_(out)

    def all_reduce_max(self, t, axes):
        return self._reduce(t, lambda x: x.amax(0))

    def all_reduce_sum(self, t, axes):
        return self._reduce(t, lambda x: x.sum(0))


def test_split_decode_attention_combines_to_the_whole_cache():
    """A cache cut into n blocks, each block's partial softmax
    (``decode_partial``) combined over n threads standing for the data
    ranks (``decode_attention_split``), equals ``decode_attention`` on the
    whole cache within 1e-6 and is finite, for every n, causal limit and
    window, including blocks with no valid position (past ``pos``, or
    before the window), whose partial sums are exactly 0."""
    from repro_torch.models.attention import (decode_attention, decode_attention_split,
                                              decode_partial)

    rng = np.random.default_rng(0)
    b, s, h, kv, d = 2, 48, 6, 2, 16
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((b, 1, h, d), (b, s, kv, d), (b, s, kv, d)))
    empty = 0
    for n in (2, 3, 4):
        m = s // n
        for pos, window, is_global in ((5, 0, 1.0), (47, 0, 1.0), (30, 8, 0.0), (30, 8, 1.0),
                                       (20, 4, 0.0), (40, 12, 0.0)):
            want = decode_attention(q, k, v, pos, window, is_global)
            ranks = _Ranks(n)

            def rank(r, ranks=ranks, pos=pos, window=window, is_global=is_global):
                ranks.local.rank = r
                blk = slice(r * m, (r + 1) * m)
                return decode_attention_split(q, k[:, blk], v[:, blk], pos, r * m, ranks,
                                              window, is_global)

            with ThreadPoolExecutor(n) as pool:
                got = list(pool.map(rank, range(n)))
            for r, out in enumerate(got):
                assert torch.isfinite(out).all(), (n, pos, window, r)
                err = float((out - want).abs().max())
                assert err <= 1e-6, (n, pos, window, is_global, r, err)
            for r in range(n):
                blk = slice(r * m, (r + 1) * m)
                valid = [p for p in range(r * m, (r + 1) * m) if p <= pos and (
                    not window or is_global > 0 or pos - p < window)]
                _, l, o = decode_partial(q, k[:, blk], v[:, blk], pos, r * m, window, is_global)
                if not valid:
                    empty += 1
                    assert not l.any() and not o.any(), (n, pos, window, r)
    assert empty >= 10


def test_split_mla_decode_combines_to_the_whole_cache():
    """MLA's absorbed decode over a latent / k_rope cache cut into n
    blocks, each thread standing for a data rank attending its block and
    combining the partial softmaxes and weighted latent contexts over the
    ranks before ``wkv_b``'s value half (``mla_decode(..., tp=, seq=)``),
    equals ``mla_decode`` on the whole cache within 1e-5 of max(1, |out|)
    and is finite, for every n, causal limit and window, including blocks
    with no valid position; the token is written only into the block that
    holds ``pos``, at its place there."""
    import dataclasses

    from repro_torch.models.attention import init_mla, mla_decode
    from repro_torch.models.transformer import _rope_tables

    cfg = get_config("deepseek-v3-671b", reduced=True)
    p = init_mla(torch.Generator().manual_seed(0), cfg)
    p = {k: v + 0.1 * torch.randn(v.shape, generator=torch.Generator().manual_seed(1))
         if v.ndim == 1 else v for k, v in p.items()}      # norm scales away from zero
    rng = np.random.default_rng(0)
    b, s = 2, 48
    x = torch.from_numpy(rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32))
    latent, k_rope = (torch.from_numpy(rng.standard_normal((b, s, n)).astype(np.float32))
                      for n in (cfg.kv_lora_rank, cfg.qk_rope_head_dim))
    empty = 0
    for n in (2, 3, 4):
        m = s // n
        for pos, window, is_global in ((5, 0, 1.0), (47, 0, 1.0), (30, 8, 0.0), (40, 12, 0.0)):
            c = dataclasses.replace(cfg, sliding_window=window)
            _, (sin, cos) = _rope_tables(c, s, "cpu", positions=pos)
            whole = (latent.clone(), k_rope.clone())
            want, (wl, wk) = mla_decode(p, c, x, sin, cos, whole, pos, is_global)
            ranks = _Ranks(n)

            def rank(r, ranks=ranks, pos=pos, c=c, sin=sin, cos=cos, is_global=is_global):
                ranks.local.rank = r
                blk = (latent[:, r * m:(r + 1) * m].clone(), k_rope[:, r * m:(r + 1) * m].clone())
                out, cache = mla_decode(p, c, x, sin, cos, blk, pos, is_global, tp=ranks,
                                        seq=r * m)
                return out, cache

            with ThreadPoolExecutor(n) as pool:
                got = list(pool.map(rank, range(n)))
            scale = max(1.0, float(want.abs().max()))
            for r, (out, (gl, gk)) in enumerate(got):
                assert torch.isfinite(out).all(), (n, pos, window, r)
                err = float((out - want).abs().max())
                assert err <= 1e-5 * scale, (n, pos, window, is_global, r, err)
                # the block is the whole cache's block after the write
                assert torch.equal(gl, wl[:, r * m:(r + 1) * m]), (n, pos, r)
                assert torch.equal(gk, wk[:, r * m:(r + 1) * m]), (n, pos, r)
                valid = [q for q in range(r * m, (r + 1) * m)
                         if q <= pos and (not window or is_global > 0 or pos - q < window)]
                empty += not valid
    assert empty >= 10


@pytest.mark.parametrize("name", ["dbrx-132b", "deepseek-v3-671b", "hymba-1.5b", "xlstm-125m",
                                  "musicgen-large"])
def test_leaf_by_leaf_build_is_the_blocks_of_the_whole_tree(name):
    """``init_param_blocks`` (each leaf cut to the rank's block as soon as
    it is drawn) equals ``param_blocks(init_params(...))`` bit for bit, leaf
    for leaf in the same order and type, on every rank of both worlds'
    grids and of the card's (pod 2, data 2, model 2) grid."""
    from repro_torch.models.transformer import init_param_blocks

    cfg = get_config(name, reduced=True)
    whole = init_params(torch.Generator().manual_seed(3), cfg)
    for shape in ({"data": 1, "model": 2}, {"data": 2, "model": 2},
                  {"pod": 2, "data": 2, "model": 2}):
        for rank in range(int(np.prod(list(shape.values())))):
            coords, r = {}, rank
            for a in reversed(shape):
                r, coords[a] = divmod(r, shape[a])
            at = _At(shape, coords)
            want, want_spec = tree_flatten(param_blocks(whole, cfg, at))
            got, got_spec = tree_flatten(init_param_blocks(torch.Generator().manual_seed(3),
                                                           cfg, at))
            assert got_spec == want_spec, (shape, rank)
            for j, (g, w) in enumerate(zip(got, want, strict=True)):
                assert g.dtype == w.dtype and torch.equal(g, w), (shape, rank, j)
                assert g.is_contiguous() and g.untyped_storage().nbytes() == w.numel() * \
                    w.element_size(), (shape, rank, j)    # the block alone, not a view
