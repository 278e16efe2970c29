"""The scale-out round and the scaleout backend on a (pod 2, data 2, model
2) grid against the reference's on the CPU.

One module fixture runs, side by side:

- the reference in one subprocess on 8 virtual devices
  (``--xla_force_host_platform_device_count=8``) under
  ``jax.make_mesh((2, 2, 2), ("pod", "data", "model"))`` with Auto axes
  (jax 0.9's default Explicit axes make the reference's round raise at
  ``jax.jit``): ``make_federated_round`` at compress_bits 0 and 8 and
  ``ScaleoutEngine`` on ``fl_cfg(backend="scaleout")``;
- the port in a world of 8 CPU processes under gloo (a file store in the
  test's directory, one intra-op thread each), one pod a process row:
  the same rounds and engine on ``make_host_mesh(2, 2, pod=2)``, each
  rank holding its blocks of every leaf under the baseline policy
  (``param_blocks``) and training on its ``data`` share of its pod's
  batch; each rank's results and its pod's local ends (the oracle's
  input, the whole tree trained in one process) saved.

Reduced qwen3-14b (fp32) from the reference's weights
(``serving_params_from_jax``), B = 4, S = 32, 2 local steps; the engine
replays the reference's draws as ``JaxReplayDraws`` draws them, recorded
here by a one-process run and handed to the world in order.

- (a) every rank holds each leaf as the baseline spec's ``shard_shape``,
  before and after the round, and the exact round's blocks equal the
  reference's grid round, cut to the rank's block, within ``ATOL`` and
  the port's pods-only round in one process likewise;
- (b) the int8 round keeps each rank's blocks (nothing is gathered over
  ``model``): each equals a numpy oracle of one scale a (leaf, block) on
  the rank's own local ends within 1e-6, the blocks put together lie
  within one quantization step of a (reference leaf, model block) of the
  reference's int8 round, and differ from the pods-only int8 round (one
  scale a leaf) by more than 1e-6 on a leaf that ``model`` splits;
- (c) the engine selects exactly as the reference's on the grid, params
  within ``ATOL``;
- (e) reduced hymba-1.5b in the same world: its exact and int8 rounds
  keep each rank's baseline-spec blocks (the Mamba heads on the rank's
  channels), and the exact round's blocks and losses equal the port's
  pods-only round in one process within ``ATOL``;
- (f) reduced xlstm-125m with one mLSTM and one sLSTM layer in the same
  world: its exact round keeps each rank's blocks (the cores on the
  rank's one of two heads) and equals the pods-only round within
  ``ATOL``;
- (g) reduced dbrx-132b in the same world (its 4 experts over model,
  their FFN columns over data): its exact round's blocks and losses equal
  the reference's grid round, cut to the rank's blocks, within ``ATOL``;
  its int8 round keeps each rank's blocks at one scale a (leaf, block),
  an expert leaf's block being its ``data`` block of columns too;
- (d) the dry 2 x 2 x 2 trace's collective bytes by kind equal their
  closed-form counts (the tensor-parallel step's sums over ``model``, the
  gradients' over ``data``, the round's over ``pod``; no gather over
  ``model``), and ``run_federated``'s record is the reference's 2 x 16 x
  16, its arguments the rank's share of the reference's layout.
"""

import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
from torch.utils._pytree import (  # noqa: E402
    MappingKey,
    tree_flatten,
    tree_flatten_with_path,
    tree_leaves,
    tree_unflatten,
)

from conftest import fl_cfg  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.sharding import make_policy as ref_make_policy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.inputs import dummy_batch  # noqa: E402
from repro_torch.convert import params_from_jax, serving_params_from_jax  # noqa: E402
from repro_torch.engine import FLConfig, make_engine  # noqa: E402
from repro_torch.federated.scaleout import make_federated_round, stack_for_clients  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_dry_mesh, make_host_mesh  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    abstract_params,
    init_params,
    param_blocks,
    transformer_specs,
)
from repro_torch.sharding import make_policy, shard_shape, spec_leaves  # noqa: E402
from test_torch_engine import JaxReplayDraws  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ATOL = 1e-5
ORACLE_TOL = 1e-6
B, S, LR, STEPS, SEEDS, W = 4, 32, 0.05, 2, (10, 11), (0.25, 0.75)
MODEL, HYMBA, XLSTM, DBRX, QMAX = "qwen3-14b", "hymba-1.5b", "xlstm-125m", "dbrx-132b", 127
CFG = fl_cfg(backend="scaleout").to_dict()

# the constants and the draws both sides replay, importable by the subprocesses
_CASE = f"""
import torch
B, S, LR, STEPS, SEEDS, W = {B}, {S}, {LR}, {STEPS}, {SEEDS}, {W}
MODEL, HYMBA, XLSTM, DBRX = {MODEL!r}, {HYMBA!r}, {XLSTM!r}, {DBRX!r}
CFG = {CFG!r}


def xlstm_cfg(get):
    '''Reduced xlstm-125m with one mLSTM and one sLSTM layer.'''
    import dataclasses
    return dataclasses.replace(get(XLSTM, reduced=True), layer_pattern="MS")


class Recorded:
    '''The draws a run made, one call after another: recording the calls
    of ``draws`` (``record``), or handing out those of a file in order.'''

    def __init__(self, draws=None, path=None):
        self.draws, self.calls = draws, []
        self._replay = iter(torch.load(path)) if path else None

    def _call(self, name, *a, **k):
        if self._replay is not None:
            got, out = next(self._replay)
            assert got == name, (got, name)
            return out
        out = getattr(self.draws, name)(*a, **k)
        self.calls.append((name, out))
        return out

    def init_params(self, *a, **k):
        return self._call("init_params", *a, **k)

    def poll_indices(self, *a, **k):
        return self._call("poll_indices", *a, **k)

    def client_batch_indices(self, *a, **k):
        return self._call("client_batch_indices", *a, **k)
"""

_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
sys.path.insert(0, sys.argv[1])
from grid_case import B, CFG, DBRX, LR, MODEL, S, SEEDS, STEPS, W
from repro.configs import get_config
from repro.configs.inputs import dummy_batch
from repro.data import make_classification
from repro.engine import FLConfig, make_engine
from repro.federated.scaleout import make_federated_round, stack_for_clients
from repro.jax_compat import set_mesh
from repro.models.transformer import init_transformer

mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"), axis_types=(AxisType.Auto,) * 3)
cfg = get_config(MODEL, reduced=True)
params = init_transformer(jax.random.PRNGKey(0), cfg)
batches = [dummy_batch(cfg, B, S, seed=s) for s in SEEDS]
batch = {k: jnp.stack([b[k] for b in batches]) for k in batches[0]}
out = {f"start/{i}": np.asarray(x) for i, x in enumerate(jax.tree.leaves(params))}
for bits in (0, 8):
    fn = make_federated_round(cfg, mesh, lr=LR, local_steps=STEPS, compress_bits=bits)
    with set_mesh(mesh):
        new, losses = jax.jit(fn)(stack_for_clients(params, 2), batch,
                                  jnp.asarray(W, jnp.float32))
    out |= {f"q{bits}/{i}": np.asarray(x[0]) for i, x in enumerate(jax.tree.leaves(new))}
    out[f"loss{bits}"] = np.asarray(losses)
# reduced dbrx-132b's exact round: its experts over model, their columns over data
dcfg = get_config(DBRX, reduced=True)
dparams = init_transformer(jax.random.PRNGKey(0), dcfg)
dbatches = [dummy_batch(dcfg, B, S, seed=s) for s in SEEDS]
dbatch = {k: jnp.stack([b[k] for b in dbatches]) for k in dbatches[0]}
fn = make_federated_round(dcfg, mesh, lr=LR, local_steps=STEPS, compress_bits=0)
with set_mesh(mesh):
    new, losses = jax.jit(fn)(stack_for_clients(dparams, 2), dbatch, jnp.asarray(W, jnp.float32))
out |= {f"dbrx_q0/{i}": np.asarray(x[0]) for i, x in enumerate(jax.tree.leaves(new))}
out["dbrx_loss0"] = np.asarray(losses)
train = make_classification(800, n_features=64, n_classes=10, seed=0)
test = make_classification(200, n_features=64, n_classes=10, seed=1)
with set_mesh(mesh):
    eng = make_engine(FLConfig.from_dict(CFG), train, test, n_classes=10, mesh=mesh)
    res = list(eng.rounds())
out["selected"] = np.array([list(r.selected) for r in res])
out["engine_losses"] = np.array([r.mean_selected_loss for r in res])
out |= {f"engine/{i}": np.asarray(x) for i, x in enumerate(jax.tree.leaves(eng.params))}
np.savez(os.path.join(sys.argv[1], "reference.npz"), **out)
"""

_WORLD = r"""
import os, sys
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten

torch.set_num_threads(1)
rank, work = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method="file://" + os.path.join(work, "store"),
                        world_size=8, rank=rank)
sys.path.insert(0, work)
from grid_case import (B, CFG, DBRX, HYMBA, LR, MODEL, S, SEEDS, STEPS, W, Recorded,
                       xlstm_cfg)
from repro_torch.configs import get_config
from repro_torch.configs.inputs import dummy_batch
from repro_torch.data import make_classification
from repro_torch.engine import FLConfig, make_engine
from repro_torch.federated.scaleout import make_federated_round, stack_for_clients
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.transformer import loss_fn, param_blocks

mesh = make_host_mesh(2, 2, pod=2)
pod = mesh.coords["pod"]
assert mesh.grid and mesh.pods == range(pod, pod + 1)
cfg = get_config(MODEL, reduced=True)
params = torch.load(os.path.join(work, "params.pt"))
blocks = param_blocks(params, cfg, mesh)
share = B // 2
lo = mesh.coords["data"] * share
batch = {k: v[None] for k, v in dummy_batch(cfg, B, S, seed=SEEDS[pod]).items()}
out = {"coords": [mesh.coords[a] for a in ("pod", "data", "model")],
       "held": [tuple(t.shape) for t in tree_leaves(blocks)]}
for bits in (0, 8):
    fn = make_federated_round(cfg, mesh, lr=LR, local_steps=STEPS, compress_bits=bits)
    new, losses = fn(stack_for_clients(blocks, 1), {k: v[:, lo:lo + share] for k, v in
                                                    batch.items()}, torch.tensor(W))
    out[f"q{bits}"] = [t[0] for t in tree_leaves(new)]
    out[f"loss{bits}"] = losses
# hymba: its blocks, the Mamba heads on the rank's channels
hcfg = get_config(HYMBA, reduced=True)
hblocks = param_blocks(torch.load(os.path.join(work, "hymba.pt")), hcfg, mesh)
hbatch = {k: v[None, lo:lo + share] for k, v in dummy_batch(hcfg, B, S,
                                                            seed=SEEDS[pod]).items()}
for bits in (0, 8):
    fn = make_federated_round(hcfg, mesh, lr=LR, local_steps=STEPS, compress_bits=bits)
    new, losses = fn(stack_for_clients(hblocks, 1), hbatch, torch.tensor(W))
    out[f"hymba_q{bits}"] = [t[0] for t in tree_leaves(new)]
    out[f"hymba_loss{bits}"] = losses
# xlstm: its blocks, the cores on the rank's heads
xcfg = xlstm_cfg(get_config)
xblocks = param_blocks(torch.load(os.path.join(work, "xlstm.pt")), xcfg, mesh)
xbatch = {k: v[None, lo:lo + share] for k, v in dummy_batch(xcfg, B, S,
                                                            seed=SEEDS[pod]).items()}
fn = make_federated_round(xcfg, mesh, lr=LR, local_steps=STEPS)
new, losses = fn(stack_for_clients(xblocks, 1), xbatch, torch.tensor(W))
out["xlstm_q0"], out["xlstm_loss0"] = [t[0] for t in tree_leaves(new)], losses
# dbrx: its blocks, the experts over model and their FFN columns over data;
# the exact and int8 rounds, and the rank's blocks of its pod's local ends
dcfg = get_config(DBRX, reduced=True)
dblocks = param_blocks(torch.load(os.path.join(work, "dbrx.pt")), dcfg, mesh)
out["dbrx_held"] = [tuple(t.shape) for t in tree_leaves(dblocks)]
dbatch = {k: v[None, lo:lo + share] for k, v in dummy_batch(dcfg, B, S,
                                                            seed=SEEDS[pod]).items()}
for bits in (0, 8):
    fn = make_federated_round(dcfg, mesh, lr=LR, local_steps=STEPS, compress_bits=bits)
    new, losses = fn(stack_for_clients(dblocks, 1), dbatch, torch.tensor(W))
    out[f"dbrx_q{bits}"], out[f"dbrx_loss{bits}"] = [t[0] for t in tree_leaves(new)], losses
dleaves, dspec = tree_flatten(dblocks)
for _ in range(STEPS):
    dleaves = [p.detach().requires_grad_(True) for p in dleaves]
    loss, _ = loss_fn(tree_unflatten(dleaves, dspec), dcfg, {k: v[0] for k, v in dbatch.items()},
                      mesh.in_pod())
    grads = torch.autograd.grad(loss, dleaves, allow_unused=True, materialize_grads=True)
    with torch.no_grad():
        dleaves = [(w - LR * g).to(w.dtype) for w, g in zip(dleaves, grads)]
out["dbrx_ends"] = dleaves
# the rank's blocks of its pod's local ends, as the round's local SGD computes them
leaves, spec = tree_flatten(blocks)
one = {k: v[0, lo:lo + share] for k, v in batch.items()}
for _ in range(STEPS):
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    loss, _ = loss_fn(tree_unflatten(leaves, spec), cfg, one, mesh.in_pod())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    with torch.no_grad():
        leaves = [(w - LR * g).to(w.dtype) for w, g in zip(leaves, grads)]
out["ends"] = leaves
train = make_classification(800, n_features=64, n_classes=10, seed=0)
test = make_classification(200, n_features=64, n_classes=10, seed=1)
eng = make_engine(FLConfig.from_dict(CFG), train, test, 10, device="cpu", mesh=mesh,
                  draws=Recorded(path=os.path.join(work, "draws.pt")))
assert eng.n_pods == 2 and eng._block == slice(6 * pod, 6 * pod + 6)
res = list(eng.rounds())
out["selected"] = [list(r.selected) for r in res]
out["engine_losses"] = [r.mean_selected_loss for r in res]
out["engine"] = eng.params
torch.save(out, os.path.join(work, f"rank{rank}.pt"))
dist.destroy_process_group()
"""


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Several test workers share the cores: one intra-op thread keeps this
    file's many small torch operations from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_tree(leaves, template):
    """Saved reference leaves (``jax.tree.leaves`` order) as ``template``'s tree."""
    return jax.tree.unflatten(jax.tree.structure(template), leaves)


@pytest.fixture(scope="module")
def grid(tmp_path_factory, data):
    """The reference's subprocess and the port's world of 8, run side by
    side; their saved results, the start weights (the reference's tree and
    the port's), and the pods-only rounds of one process."""
    work = tmp_path_factory.mktemp("grid")
    (work / "grid_case.py").write_text(_CASE)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, "-c", _REFERENCE, str(work)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref_cfg, cfg = ref_get_config(MODEL, reduced=True), get_config(MODEL, reduced=True)
        ref_start = jax.tree.map(np.asarray, ref_tf.init_transformer(jax.random.PRNGKey(0),
                                                                     ref_cfg))
        params = serving_params_from_jax(ref_start, cfg)
        torch.save(params, work / "params.pt")
        hcfg = get_config(HYMBA, reduced=True)
        hymba = init_params(torch.Generator().manual_seed(0), hcfg)
        torch.save(hymba, work / "hymba.pt")
        # the engine's draws as JaxReplayDraws makes them, for the world to replay
        sys.path.insert(0, str(work))
        try:
            from grid_case import Recorded, xlstm_cfg
        finally:
            sys.path.remove(str(work))
        xcfg = xlstm_cfg(get_config)
        xlstm = init_params(torch.Generator().manual_seed(0), xcfg)
        torch.save(xlstm, work / "xlstm.pt")
        dcfg, ref_dcfg = get_config(DBRX, reduced=True), ref_get_config(DBRX, reduced=True)
        ref_dbrx = jax.tree.map(np.asarray, ref_tf.init_transformer(jax.random.PRNGKey(0),
                                                                    ref_dcfg))
        dbrx = serving_params_from_jax(ref_dbrx, dcfg)
        torch.save(dbrx, work / "dbrx.pt")
        train, test = data
        rec = Recorded(JaxReplayDraws(CFG["seed"], "cpu"))
        one = make_engine(FLConfig.from_dict(CFG), train, test, 10, device="cpu", draws=rec,
                          mesh=make_host_mesh(pod=2))
        one_res = list(one.rounds())
        torch.save(rec.calls, work / "draws.pt")
        procs += [subprocess.Popen([sys.executable, "-c", _WORLD, str(r), str(work)], env=env,
                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                  for r in range(8)]
        batch = {k: torch.stack([dummy_batch(cfg, B, S, seed=s)[k] for s in SEEDS])
                 for k in ("tokens", "labels")}
        pods_only = {}
        for bits in (0, 8):
            fn = make_federated_round(cfg, make_host_mesh(pod=2), lr=LR, local_steps=STEPS,
                                      compress_bits=bits)
            new, losses = fn(stack_for_clients(params, 2), batch, torch.tensor(W))
            pods_only[bits] = ([t[0] for t in tree_leaves(new)], losses)
        hbatch = {k: torch.stack([dummy_batch(hcfg, B, S, seed=s)[k] for s in SEEDS])
                  for k in ("tokens", "labels")}
        fn = make_federated_round(hcfg, make_host_mesh(pod=2), lr=LR, local_steps=STEPS)
        new, losses = fn(stack_for_clients(hymba, 2), hbatch, torch.tensor(W))
        pods_only["hymba"] = ([t[0] for t in tree_leaves(new)], losses)
        xbatch = {k: torch.stack([dummy_batch(xcfg, B, S, seed=s)[k] for s in SEEDS])
                  for k in ("tokens", "labels")}
        fn = make_federated_round(xcfg, make_host_mesh(pod=2), lr=LR, local_steps=STEPS)
        new, losses = fn(stack_for_clients(xlstm, 2), xbatch, torch.tensor(W))
        pods_only["xlstm"] = ([t[0] for t in tree_leaves(new)], losses)
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        torch.set_num_threads(n)
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    ref = dict(np.load(work / "reference.npz"))
    ranks = [torch.load(work / f"rank{r}.pt") for r in range(8)]
    return {"ref": ref, "ranks": ranks, "ref_start": ref_start, "params": params,
            "pods_only": pods_only, "one": (one_res, one.params), "cfg": cfg, "ref_cfg": ref_cfg,
            "hymba": (hcfg, hymba), "xlstm": (xcfg, xlstm),
            "dbrx": (dcfg, ref_dcfg, ref_dbrx, dbrx),
            "mlp": jax.tree.structure(rec.draws._template)}


def _diff(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _ref_leaves(grid, key):
    n = len(jax.tree.leaves(grid["ref_start"]))
    return [grid["ref"][f"{key}/{i}"] for i in range(n)]


def _as_port(grid, key):
    """The reference's saved tree ``key`` as the port's leaves."""
    tree = _ref_tree(_ref_leaves(grid, key), grid["ref_start"])
    return tree_leaves(serving_params_from_jax(tree, grid["cfg"]))


class _At:
    """A rank of the (pod 2, data 2, model 2) grid, as ``param_blocks``
    reads a mesh."""

    shape = {"pod": 2, "data": 2, "model": 2}
    axis_names = tuple(shape)

    def __init__(self, coords):
        self.coords = dict(zip(self.axis_names, coords))

    def index(self, axes):
        idx = 0
        for a in ((axes,) if isinstance(axes, str) else axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx


def _blocks(grid, leaves, coords):
    """The port's whole ``leaves`` cut to the block of the rank at ``coords``."""
    _, spec = tree_flatten(grid["params"])
    tree = tree_unflatten([torch.as_tensor(np.asarray(x)) for x in leaves], spec)
    return tree_leaves(param_blocks(tree, grid["cfg"], _At(coords)))


def test_world_sits_on_the_reference_grid_and_starts_from_its_weights(grid):
    for r, got in enumerate(grid["ranks"]):
        assert got["coords"] == [r // 4, r // 2 % 2, r % 2]   # row-major (pod, data, model)
    for a, b in zip(_ref_leaves(grid, "start"), jax.tree.leaves(grid["ref_start"])):
        np.testing.assert_array_equal(a, b)


def test_every_rank_holds_its_baseline_spec_blocks(grid):
    policy = ref_make_policy(_Grid(), batch_size=0)
    whole = tree_leaves(grid["params"])
    specs = [tuple(policy.spec_for(lg, tuple(w.shape))) for lg, w in
             zip(_port_specs(grid), whole, strict=True)]
    split = 0
    for got in grid["ranks"]:
        want = [shard_shape(_Grid(), sp, tuple(w.shape)) for sp, w in zip(specs, whole)]
        for key in ("q0", "q8"):
            assert [tuple(t.shape) for t in got[key]] == got["held"] == want, key
        split = sum(w != tuple(x.shape) for w, x in zip(want, whole))
    assert split > len(whole) // 2      # the projections, the FFN, embed and head


# ---------------------------------------------------------------- (a) exact
def test_exact_grid_round_matches_the_reference_and_the_pods_only_round(grid):
    pods_only, pods_losses = grid["pods_only"][0]
    for r, got in enumerate(grid["ranks"]):
        want = _blocks(grid, _as_port(grid, "q0"), got["coords"])
        for j, (g, w, p) in enumerate(zip(got["q0"], want, _blocks(grid, pods_only,
                                                                     got["coords"]),
                                          strict=True)):
            assert g.shape == w.shape, (r, j)
            assert _diff(g, w) <= ATOL, (r, j, _diff(g, w))
            assert _diff(g, p) <= ATOL, (r, j, _diff(g, p), "pods-only")
        np.testing.assert_allclose(got["loss0"].numpy(), grid["ref"]["loss0"], atol=ATOL)
        np.testing.assert_allclose(got["loss0"].numpy(), pods_losses.numpy(), atol=ATOL)


# ----------------------------------------------------------------- (b) int8
def _model_dim(policy, logical, shape):
    spec = tuple(policy.spec_for(tuple(logical), shape))
    return next((d for d, e in enumerate(spec) if e == "model"), None)


def _port_specs(grid):
    """Each port leaf's logical axes (``tree_flatten`` order of the serving
    tree), looked up by its path in the reference's stacked specs, a layer
    leaf's without the leading ``layers`` axis."""
    specs = ref_tf.transformer_specs(grid["ref_cfg"])
    out = []
    for path, _ in tree_flatten_with_path(grid["params"])[0]:
        node = specs
        for entry in path:
            if isinstance(entry, MappingKey):
                node = node[entry.key]
        out.append(tuple(node[1:]) if path[0].key == "layers" else tuple(node))
    return out


class _Grid:
    shape = {"pod": 2, "data": 2, "model": 2}
    axis_names = tuple(shape)


def _quantize_oracle(ends, start, w):
    """K1's sum, in numpy fp32 with each product and sum rounded, of the
    pods' int8 blocks at one scale a (pod, block), onto the start's block."""
    s0 = np.asarray(start, np.float32)
    acc = np.zeros(s0.shape, np.float32)
    for e, wp in zip(ends, w):
        d = np.asarray(e, np.float32) - s0
        scale = np.float32(max(np.abs(d).max(), np.float32(1e-12)) / np.float32(QMAX))
        q = np.clip(np.round(d / scale), -QMAX - 1, QMAX).astype(np.float32)
        acc = acc + np.float32(scale * np.float32(wp)) * q
    return s0 + acc


def _assembled(grid, key, pod):
    """The whole leaves of ``key`` put together from the blocks of ``pod``'s
    data-0 ranks, in numpy (the int8 round gathers nothing itself)."""
    policy = ref_make_policy(_Grid(), batch_size=0)
    ranks = {tuple(g["coords"][1:]): g[key] for g in grid["ranks"] if g["coords"][0] == pod}
    out = []
    for j, (lg, w) in enumerate(zip(_port_specs(grid), tree_leaves(grid["params"]))):
        dim = _model_dim(policy, lg, tuple(w.shape))
        parts = [ranks[(0, m)][j].numpy() for m in (0, 1)]
        out.append(parts[0] if dim is None else np.concatenate(parts, axis=dim))
    return out


def test_int8_grid_round_quantizes_a_leaf_and_model_block(grid):
    policy = ref_make_policy(_Grid(), batch_size=0)
    logical = _port_specs(grid)
    start = tree_leaves(grid["params"])
    pods_only = grid["pods_only"][8][0]
    moved = []
    for r, got in enumerate(grid["ranks"]):
        m = got["coords"][2]
        # the same block of each pod's ends: the ranks at this (data, model)
        ends = [next(g["ends"] for g in grid["ranks"]
                     if g["coords"] == [p, *got["coords"][1:]]) for p in (0, 1)]
        for j, (g, s0, lg) in enumerate(zip(got["q8"], _blocks(grid, start, got["coords"]),
                                            logical, strict=True)):
            dim = _model_dim(policy, lg, tuple(start[j].shape))
            oracle = _quantize_oracle([e[j] for e in ends], s0, W)
            assert g.shape == oracle.shape, (r, j)      # kept as the rank's block
            assert _diff(g, oracle) <= ORACLE_TOL, (r, j, _diff(g, oracle))
            if dim is not None:
                theirs = np.split(pods_only[j].numpy(), 2, axis=dim)[m]
                moved.append(_diff(g, theirs))
        np.testing.assert_allclose(got["loss8"].numpy(), grid["ref"]["loss8"], atol=ATOL)
    assert max(moved) > ORACLE_TOL, "the grid's scales never moved a model-split leaf"
    # against the reference: within one quantization step of its blocks, whose
    # stacked layer leaves take one scale over every layer
    ref_tree = _ref_tree(_ref_leaves(grid, "q8"), grid["ref_start"])
    stacked_ends = [_stack(_assembled(grid, "ends", p), grid) for p in (0, 1)]
    stacked_start = _stack(start, grid)
    ref_specs = ref_tf.transformer_specs(grid["ref_cfg"])
    is_spec = lambda x: isinstance(x, tuple)  # noqa: E731
    flat_ref = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    flat_specs = jax.tree.leaves(ref_specs, is_leaf=is_spec)
    for pod in (0, 1):
        mine = _stack(_assembled(grid, "q8", pod), grid)
        for (path, want_leaf), lg in zip(flat_ref, flat_specs, strict=True):
            key = jax.tree_util.keystr(path)
            dim = _model_dim(policy, lg, want_leaf.shape)
            blocks = [slice(None)] if dim is None else np.array_split(
                np.arange(want_leaf.shape[dim]), 2)
            for blk in blocks:
                idx = (slice(None),) * (dim or 0) + (blk,)
                step = sum(w * np.abs(e[key][idx] - stacked_start[key][idx]).max() / QMAX
                           for w, e in zip(W, stacked_ends))
                err = np.abs(mine[key][idx] - np.asarray(want_leaf)[idx]).max()
                assert err <= step + ATOL, (key, float(err), float(step))


def _stack(leaves, grid):
    """Port leaves (``tree_flatten`` order of the serving tree) as numpy
    arrays keyed by the reference tree's paths, layers stacked."""
    _, spec = tree_flatten(grid["params"])
    tree = tree_unflatten([torch.as_tensor(x) for x in leaves], spec)
    ref = {k: v.numpy() for k, v in tree.items() if k != "layers"}
    layers = tree["layers"]
    ref["layers"] = jax.tree.map(lambda *xs: np.stack([x.numpy() for x in xs]), *layers)
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    return {jax.tree_util.keystr(p): v for p, v in flat}


# --------------------------------------------------------------- (c) engine
def test_scaleout_engine_on_the_grid_matches_the_reference(grid):
    ref = grid["ref"]
    one_res, one_params = grid["one"]
    n = sum(k.startswith("engine/") for k in ref)
    ref_params = params_from_jax(jax.tree.unflatten(
        grid["mlp"], [ref[f"engine/{i}"] for i in range(n)])).numpy()
    for r, got in enumerate(grid["ranks"]):
        assert got["selected"] == ref["selected"].tolist() == [list(x.selected)
                                                               for x in one_res], r
        np.testing.assert_allclose(got["engine_losses"], ref["engine_losses"], rtol=ATOL)
        np.testing.assert_allclose(got["engine"].numpy(), ref_params, atol=ATOL)
        np.testing.assert_allclose(got["engine"].numpy(), one_params.numpy(), atol=ATOL)


# ---------------------------------------------------------------- (e) hymba
@pytest.mark.parametrize("bits", [0, 8])
def test_hymba_rounds_keep_each_ranks_blocks(grid, bits):
    hcfg, whole = grid["hymba"]
    pods_losses = grid["pods_only"]["hymba"][1]
    for r, got in enumerate(grid["ranks"]):
        want = param_blocks(abstract_params(hcfg), hcfg, _At(got["coords"]))
        assert [tuple(t.shape) for t in got[f"hymba_q{bits}"]] == [
            tuple(t.shape) for t in tree_leaves(want)], r
        ssm = want["layers"][0]["ssm"]                  # the rank's 128 of 256 channels
        assert ssm["conv_w"].shape[-1] == ssm["a_log"].shape[0] == hcfg.d_model // 2
        assert all(torch.isfinite(t).all() for t in got[f"hymba_q{bits}"]), r
        # each pod's local training, the same at either bits, is the pods-only round's
        np.testing.assert_allclose(got[f"hymba_loss{bits}"].numpy(), pods_losses.numpy(),
                                   atol=ATOL)


def test_hymba_exact_grid_round_matches_the_pods_only_round(grid):
    hcfg, whole = grid["hymba"]
    _, spec = tree_flatten(whole)
    pods_only = tree_unflatten(grid["pods_only"]["hymba"][0], spec)
    for r, got in enumerate(grid["ranks"]):
        want = tree_leaves(param_blocks(pods_only, hcfg, _At(got["coords"])))
        for j, (g, w) in enumerate(zip(got["hymba_q0"], want, strict=True)):
            assert g.shape == w.shape, (r, j)
            assert _diff(g, w) <= ATOL, (r, j, _diff(g, w))


# ---------------------------------------------------------------- (f) xlstm
def test_xlstm_exact_grid_round_keeps_blocks_and_matches_the_pods_only_round(grid):
    xcfg, whole = grid["xlstm"]
    _, spec = tree_flatten(whole)
    pods_only, pods_losses = grid["pods_only"]["xlstm"]
    pods_only = tree_unflatten(pods_only, spec)
    for r, got in enumerate(grid["ranks"]):
        want = param_blocks(pods_only, xcfg, _At(got["coords"]))
        core = want["layers"][0]["xlstm"]            # the rank's one of two heads
        assert core["wq"].shape[-1] == core["w_down"].shape[0] == xcfg.d_model // 2
        for j, (g, w) in enumerate(zip(got["xlstm_q0"], tree_leaves(want), strict=True)):
            assert g.shape == w.shape, (r, j)
            assert _diff(g, w) <= ATOL, (r, j, _diff(g, w))
        np.testing.assert_allclose(got["xlstm_loss0"].numpy(), pods_losses.numpy(), atol=ATOL)


# --------------------------------------------------------------- (d) dry run
@pytest.mark.parametrize("bits", [0, 8])
def test_dry_grid_round_tallies_its_collectives_in_closed_form(bits):
    cfg, ref_cfg = get_config(MODEL, reduced=True), ref_get_config(MODEL, reduced=True)
    mesh = make_dry_mesh(2, 2, pod=2)
    fn, args = dryrun.build_federated(cfg, mesh, STEPS, B, S, bits)
    assert args[1]["tokens"].shape == (1, B // 2, S) and args[2].shape == (1,)
    traced = dryrun.trace(fn, args)
    policy = ref_make_policy(_Grid(), batch_size=0)
    shapes = jax.eval_shape(lambda k: ref_tf.init_transformer(k, ref_cfg), jax.random.PRNGKey(0))
    specs = jax.tree.leaves(ref_tf.transformer_specs(ref_cfg),
                            is_leaf=lambda x: isinstance(x, tuple))
    # the rank's block of each stacked reference leaf: halved where model splits it
    block = [int(np.prod(s.shape)) // (2 if _model_dim(policy, sp, s.shape) is not None else 1)
             for sp, s in zip(specs, jax.tree.leaves(shapes), strict=True)]
    n_leaves = len(tree_leaves(args[0]))
    f32, t, d = 4, B // 2 * S, cfg.d_model          # t: the rank's tokens, a data share
    layers = cfg.n_layers
    # a local step's: forward, the embedding's, each layer's attention and MLP
    # outputs and the head's gold logits and sums of exponentials summed over
    # model, the row maxima's maximum, the mask's and the loss's sums over data;
    # backward, the hidden states' gradient before the head and each layer's two
    # inputs' over model, the qk-norm scales' over model, every block's over data
    step = (f32 * t * d * (1 + 2 * layers) + 3 * f32 * t + 2 * f32
            + f32 * t * d * (1 + 2 * layers) + layers * 2 * cfg.resolved_head_dim * f32
            + f32 * sum(block))
    losses = 2 * 4                                  # the (2,) fp32 losses over pod
    if bits == 0:                                   # the fp32 sum of every block over pod
        want = {"all-reduce": STEPS * step + f32 * sum(block), "all-gather": losses}
    else:                                           # int8 blocks and scale * w over pod,
        want = {"all-reduce": STEPS * step,         # kept: nothing over model
                "all-gather": 2 * sum(block) + 2 * f32 * n_leaves + losses}
    assert traced["coll"] == want
    assert traced["kernel_work"]["masked_weighted_sum"]["launches"] == n_leaves


class _Production:
    shape = {"pod": 2, "data": 16, "model": 16}
    axis_names = tuple(shape)


def test_federated_dry_run_record_is_the_reference_2x16x16(monkeypatch):
    monkeypatch.setattr(dryrun, "get_config", lambda arch: get_config(arch, reduced=True))
    rec = dryrun.run_federated(MODEL, local_steps=1, batch_per_client=16, seq=32,
                               compress_bits=8)
    assert (rec["mesh"], rec["n_devices"], rec["kind"]) == ("multi", 512, "federated_round")
    assert set(rec["collective_bytes"]) == {"all-gather", "all-reduce"}
    assert rec["shape"].endswith("_q8") and rec["storage"] == "sharded"
    # one device's share of the reference's layout: each leaf's block under
    # the baseline policy, one of the 16 rows of its pod's batch, its weight
    policy = ref_make_policy(_Production(), batch_size=0)
    whole = abstract_params(get_config(MODEL, reduced=True))
    logical = _port_specs({"params": whole, "ref_cfg": ref_get_config(MODEL, reduced=True)})
    params = sum(math.prod(shard_shape(_Production(), tuple(policy.spec_for(lg, tuple(t.shape))),
                                       tuple(t.shape))) * t.element_size()
                 for lg, t in zip(logical, tree_leaves(whole)))
    share = params + 2 * 1 * 32 * 4 + 4
    assert rec["memory"]["argument_size_held"] == rec["memory"]["argument_size"] == share


# ----------------------------------------------------------------- (g) dbrx
def _dbrx_specs(grid):
    """Each leaf's baseline spec on the grid, in the port's leaf order."""
    dcfg, _, _, whole = grid["dbrx"]
    return spec_leaves(make_policy(_Grid(), 0).shardings(transformer_specs(dcfg), whole))


def test_dbrx_exact_grid_round_matches_the_reference(grid):
    """Reduced dbrx-132b's exact round on the grid: every rank holds its
    baseline-spec blocks before and after (the 4 experts over model, their
    FFN columns over data, attention and vocab over model), and its blocks
    and losses equal the reference's grid round, cut to the rank's
    blocks, within ``ATOL``."""
    dcfg, _, ref_start, whole = grid["dbrx"]
    n = len(jax.tree.leaves(ref_start))
    ref_new = _ref_tree([grid["ref"][f"dbrx_q0/{i}"] for i in range(n)], ref_start)
    want_tree = serving_params_from_jax(ref_new, dcfg)
    for r, got in enumerate(grid["ranks"]):
        at = _At(got["coords"])
        blocks = param_blocks(whole, dcfg, at)
        moe = blocks["layers"][0]["mlp"]
        e, fe = dcfg.moe.n_experts, dcfg.moe.d_expert
        assert moe["w_up"].shape == (e // 2, dcfg.d_model, fe // 2), r
        assert moe["w_down"].shape == (e // 2, fe // 2, dcfg.d_model), r
        assert got["dbrx_held"] == [tuple(t.shape) for t in tree_leaves(blocks)], r
        want = tree_leaves(param_blocks(want_tree, dcfg, at))
        for j, (g, w) in enumerate(zip(got["dbrx_q0"], want, strict=True)):
            assert g.shape == w.shape, (r, j)
            assert _diff(g, w) <= ATOL, (r, j, _diff(g, w))
        np.testing.assert_allclose(got["dbrx_loss0"].numpy(), grid["ref"]["dbrx_loss0"],
                                   atol=ATOL)


def test_dbrx_int8_grid_round_takes_one_scale_a_leaf_and_block(grid):
    """Reduced dbrx-132b's int8 round keeps each rank's blocks, each equal
    to the numpy oracle of one scale a (leaf, block) on the pods' ends of
    that block within ``ORACLE_TOL``: an expert leaf's block is also its
    ``data`` block of columns, whose scale differs from one taken over the
    whole ``model`` block (both data blocks) by more than ``ORACLE_TOL`` on
    some expert leaf."""
    dcfg, _, _, whole = grid["dbrx"]
    specs = _dbrx_specs(grid)
    expert = [j for j, sp in enumerate(specs) if "data" in sp]
    assert len(expert) == 3 * dcfg.n_layers                   # w_gate, w_up, w_down a layer
    ranks = {tuple(g["coords"]): g for g in grid["ranks"]}
    moved = []
    for r, got in enumerate(grid["ranks"]):
        pod, d, m = got["coords"]
        ends = [ranks[p, d, m]["dbrx_ends"] for p in (0, 1)]
        start = tree_leaves(param_blocks(whole, dcfg, _At(got["coords"])))
        for j, (g, s0) in enumerate(zip(got["dbrx_q8"], start, strict=True)):
            oracle = _quantize_oracle([e[j] for e in ends], s0, W)
            assert g.shape == oracle.shape, (r, j)
            assert _diff(g, oracle) <= ORACLE_TOL, (r, j, _diff(g, oracle))
            if j in expert:      # one scale over the model block, this rank's columns cut
                dim = specs[j].index("data")
                both = [[ranks[p, i, m]["dbrx_ends"][j].numpy() for i in (0, 1)] for p in (0, 1)]
                s_both = [tree_leaves(param_blocks(whole, dcfg, _At([pod, i, m])))[j].numpy()
                          for i in (0, 1)]
                mb = _quantize_oracle([np.concatenate(b, axis=dim) for b in both],
                                      np.concatenate(s_both, axis=dim), W)
                moved.append(_diff(g, np.split(mb, 2, axis=dim)[d]))
        np.testing.assert_allclose(got["dbrx_loss8"].numpy(), got["dbrx_loss0"].numpy(),
                                   atol=ATOL)
    assert max(moved) > ORACLE_TOL, "the data blocks' scales never moved an expert leaf"
