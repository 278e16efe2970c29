"""The mesh's data and model axes and the MoE's expert parallelism
(``models.transformer._run_moe``) against the reference on the CPU.

- ``_run_moe``'s four branches at (data 2, model 2), each case's numpy
  inputs saved to the test's directory: the reference's ``_run_moe`` under
  ``make_host_mesh(2, 2)`` on 4 virtual devices in one subprocess
  (``--xla_force_host_platform_device_count=4``, as ``tests/test_dryrun_mini.py``
  runs one), the port's in a world of 4 CPU processes under gloo (a file
  store in the test's directory, one intra-op thread each): every rank's
  output within 1e-5 relative to max(1, max |reference|), its aux loss
  within 1e-6.  The cases: E = 8 (all-axes expert parallelism), E = 6
  (experts over model, FFN columns over data), E = 5 (replicated), E = 4
  with 4 x 2100 tokens (past 8192: ``moe_capacity_sharded``, the batch
  over data) and 3 x 2800 (the batch replicated);
- the gradients in that world: every rank's gradients of x and of every
  weight equal the one-process computation of the same function within
  1e-5 relative (the one-device mesh for the first three cases, whose
  experts all keep what they keep on four; for the split batch, the
  capacity dispatch of each half and the mean of their aux losses);
- the same cases on each rank's storage blocks in that world
  (``transformer._moe_blocks``: the experts over model, their FFN columns
  over data as the baseline policy stores them, the rank's rows of the
  batch, every row of the batch of 3): its output rows within 1e-5
  relative and its aux within 1e-6 of the same oracle, the gradients of
  its rows and its blocks within 1e-5 relative of the one-process
  computation's cut to them;
- the rank coordinates against the reference mesh's ``devices`` (data 2 x
  model 2, and pod 2 x data 1 x model 2), the subgroups' sums, means and
  gathers (the ``pod`` subgroup's too), and the scale-out round built on a
  grid;
- a world of one against the reference's ``make_host_mesh(1, 1)`` on the
  same cases;
- ``forward``, ``loss_fn``, ``prefill`` and two ``decode_step`` calls of
  the reduced dbrx and deepseek (``impl="capacity"``, capacity factor 0.5
  so that experts overflow at these token counts) under a mesh of one
  against the reference's under a (1, 1) mesh (``make_host_mesh``'s, its
  axes Auto as the reference's jax made them), and one
  ``make_train_step(mesh=)`` step each (clip, then SGD at 0.5: AdamW's
  first step turns gradients within rounding of zero into steps of lr
  either way): hidden states, aux and caches within 1e-5, logits 1e-4,
  losses 1e-5 relative, the parameters after the step 1e-5 relative.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import MoEConfig as RefMoEConfig  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402
from repro.launch.mesh import make_host_mesh as ref_make_host_mesh  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.optim import chain as ref_chain  # noqa: E402
from repro.optim import clip_by_global_norm as ref_clip  # noqa: E402
from repro.optim import sgd as ref_sgd  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.convert import serving_params_from_jax  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.moe import moe_specs  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim import chain, clip_by_global_norm, sgd  # noqa: E402
from test_torch_serving import _check_cache, _close  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
D = 16
# name: (E, top_k, d_expert, n_shared, B, S) and the branch it takes at
# (data 2, model 2)
CASES = {
    "all_axes": (8, 2, 8, 1, 2, 16),
    "model_data": (6, 2, 8, 0, 2, 16),
    "replicated": (5, 2, 8, 1, 2, 16),
    "sharded": (4, 2, 8, 1, 4, 2100),
    "sharded_tokens_replicated": (4, 2, 8, 1, 3, 2800),
}


def _moe_cfg(get, moe_cls, case):
    e, k, fe, shared, _, _ = CASES[case]
    return dataclasses.replace(get("deepseek-v3-671b", reduced=True), d_model=D,
                               moe=moe_cls(n_experts=e, top_k=k, d_expert=fe, n_shared=shared,
                                           impl="capacity"))


def _inputs(case):
    """The case's MoE weights, tokens x (B, S, D), the output cotangent g
    and the aux one, numpy fp32 from the case's seed."""
    e, _, fe, shared, b, s = CASES[case]
    rng = np.random.default_rng(list(CASES).index(case))
    p = {"router": rng.normal(0, 0.25, (D, e)), "w_gate": rng.normal(0, 0.25, (e, D, fe)),
         "w_up": rng.normal(0, 0.25, (e, D, fe)), "w_down": rng.normal(0, 0.35, (e, fe, D))}
    if shared:
        p |= {"shared_gate": rng.normal(0, 0.25, (D, fe)),
              "shared_up": rng.normal(0, 0.25, (D, fe)),
              "shared_down": rng.normal(0, 0.35, (fe, D))}
    x, g = rng.normal(0, 1, (b, s, D)), rng.normal(0, 1, (b, s, D))
    return ({k: v.astype(np.float32) for k, v in p.items()}, x.astype(np.float32),
            g.astype(np.float32), np.float32(0.7))


_CASES_SRC = f"""
import dataclasses
import numpy as np
D = {D}
CASES = {json.dumps(CASES)}
""" + "\n".join(__import__("inspect").getsource(f) for f in (_moe_cfg, _inputs))

_ORACLE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
sys.path.insert(0, sys.argv[1])
from mesh_cases import CASES, _inputs, _moe_cfg
from repro.configs import get_config
from repro.configs.base import MoEConfig
from repro.launch.mesh import make_host_mesh
from repro.models.transformer import _run_moe

out = {}
mesh = make_host_mesh(2, 2)
out["devices_2x2"] = np.vectorize(lambda d: d.id)(mesh.devices)
out["devices_pod"] = np.vectorize(lambda d: d.id)(make_host_mesh(1, 2, pod=2).devices)
for case in CASES:
    cfg = _moe_cfg(get_config, MoEConfig, case)
    p, x, _, _ = _inputs(case)
    o, aux = jax.jit(lambda p, x: _run_moe(p, cfg, x, mesh))(p, x)
    out[case + "/out"], out[case + "/aux"] = np.asarray(o), np.asarray(aux)
np.savez(os.path.join(sys.argv[1], "oracle.npz"), **out)
"""

_WORLD = r"""
import os, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, work = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method="file://" + os.path.join(work, "store"),
                        world_size=4, rank=rank)
sys.path.insert(0, work)
from mesh_cases import CASES, _inputs, _moe_cfg
from repro_torch.configs import get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.federated.scaleout import make_federated_round
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.moe import moe_specs
from repro_torch.models.transformer import _moe_blocks, _run_moe, _sum_replicated, batch_rows
from repro_torch.sharding import make_policy, shard_tree

out = {}
mesh = make_host_mesh(2, 2)
pods = make_host_mesh(1, 2, pod=2)
out["coords_2x2"] = np.array([mesh.coords["data"], mesh.coords["model"]])
out["coords_pod"] = np.array([pods.coords[a] for a in ("pod", "data", "model")])
r = torch.tensor([float(rank)])
out["sum_model"] = mesh.all_reduce_sum(r.clone(), "model").numpy()
out["sum_data"] = mesh.all_reduce_sum(r.clone(), ("data",)).numpy()
out["sum_all"] = mesh.all_reduce_sum(r.clone()).numpy()
out["mean_data"] = mesh.all_reduce_mean(r, "data").numpy()
out["gather_data"] = mesh.all_gather(r, "data").numpy()
out["gather_pod_data"] = pods.all_gather(r, ("pod", "data")).numpy()
try:   # the scale-out round takes the grid, one pod a process
    make_federated_round(get_config("qwen3-14b", reduced=True), pods, lr=0.1)
    out["refusal"] = np.array("")
except ValueError as e:
    out["refusal"] = np.array(str(e))
out["sum_pod"] = pods.all_reduce_sum(r.clone(), "pod").numpy()
for case in CASES:
    cfg = _moe_cfg(get_config, MoEConfig, case)
    p, x, g, ga = _inputs(case)
    p = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    x = torch.from_numpy(x).requires_grad_(True)
    o, aux = _run_moe(p, cfg, x, mesh)
    grads = torch.autograd.grad((o * torch.from_numpy(g)).sum() + float(ga) * aux,
                                [x, *p.values()])
    out[case + "/out"], out[case + "/aux"] = o.detach().numpy(), aux.detach().numpy()
    for name, gr in zip(["x", *p], grads):
        out[f"{case}/d{name}"] = gr.numpy()
    # the same case on the rank's storage blocks (experts over model, their
    # FFN columns over data) and its rows of the batch
    whole = {k: v.detach() for k, v in p.items()}
    specs = make_policy(mesh, 0).shardings(moe_specs(cfg), whole)
    blocks = {k: v.requires_grad_(True) for k, v in shard_tree(whole, specs, mesh).items()}
    lo, n = batch_rows(mesh, x.shape[0])
    xr = x.detach()[lo:lo + n].requires_grad_(True)
    # the replicated leaves' gradients summed over data where the rows split
    # (every data rank computes every row of the batch of 3)
    whole_rows = n == x.shape[0]
    o, aux = _moe_blocks(blocks if whole_rows else _sum_replicated(blocks, specs, mesh), cfg, xr,
                         mesh, True, whole_rows=whole_rows)
    grads = torch.autograd.grad((o * torch.from_numpy(g[lo:lo + n])).sum() + float(ga) * aux,
                                [xr, *blocks.values()])
    out[f"{case}/blocks/out"], out[f"{case}/blocks/aux"] = o.detach().numpy(), aux.detach().numpy()
    for name, gr in zip(["x", *blocks], grads):
        out[f"{case}/blocks/d{name}"] = gr.numpy()
np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
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


@pytest.fixture(scope="module")
def four_devices(tmp_path_factory):
    """The reference's oracle on 4 virtual devices and the port's world of
    4 gloo processes, run side by side; their saved outputs."""
    work = tmp_path_factory.mktemp("mesh")
    (work / "mesh_cases.py").write_text(_CASES_SRC)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, "-c", _ORACLE, str(work)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
    procs += [subprocess.Popen([sys.executable, "-c", _WORLD, str(r), str(work)], env=env,
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
              for r in range(4)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return (dict(np.load(work / "oracle.npz")),
            [dict(np.load(work / f"rank{r}.npz")) for r in range(4)])


def test_rank_coordinates_groups_and_refusal(four_devices):
    oracle, ranks = four_devices
    for r, got in enumerate(ranks):
        assert oracle["devices_2x2"][tuple(got["coords_2x2"])] == r
        assert oracle["devices_pod"][tuple(got["coords_pod"])] == r
        data, model = divmod(r, 2)
        assert got["sum_model"][0] == 2 * data + 2 * data + 1           # ranks {2d, 2d + 1}
        assert got["sum_data"][0] == model + model + 2                  # ranks {m, m + 2}
        assert got["sum_all"][0] == 6
        assert got["mean_data"][0] == (2 * model + 2) / 2
        np.testing.assert_array_equal(got["gather_data"], [model, model + 2])
        np.testing.assert_array_equal(got["gather_pod_data"], [model, model + 2])
        assert str(got["refusal"]) == ""                                # the grid round built
        assert got["sum_pod"][0] == model + model + 2                   # ranks {m, m + 2}


def _one_process(case):
    """The function the four ranks compute, in this process: the one-device
    mesh (its experts keep what they keep on four), or for the batch split
    over data, each half's capacity dispatch and the mean of their aux."""
    cfg = _moe_cfg(get_config, MoEConfig, case)
    p, x, g, ga = _inputs(case)
    p = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    x = torch.from_numpy(x).requires_grad_(True)
    if case == "sharded":
        halves = [moe.moe_capacity(p, cfg, h.reshape(-1, D)) for h in x.chunk(2)]
        out = torch.cat([h for h, _ in halves]).reshape(x.shape)
        aux = (halves[0][1] + halves[1][1]) / 2
    else:
        out, aux = tf._run_moe(p, cfg, x, make_host_mesh())
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum() + float(ga) * aux,
                                [x, *p.values()])
    return out.detach(), aux.detach(), dict(zip(["x", *p], grads))


@pytest.mark.parametrize("case", list(CASES))
def test_run_moe_branches_on_four_processes_match_the_virtual_mesh(four_devices, case):
    oracle, ranks = four_devices
    out, aux, grads = _one_process(case)
    for r, got in enumerate(ranks):
        _close(torch.from_numpy(got[case + "/out"]), oracle[case + "/out"], 1e-5,
               f"rank {r} out")
        assert abs(float(got[case + "/aux"]) - float(oracle[case + "/aux"])) <= 1e-6, r
        _close(out, oracle[case + "/out"], 1e-5, "one process")
        assert abs(float(aux) - float(oracle[case + "/aux"])) <= 1e-6
        for name, want in grads.items():
            _close(torch.from_numpy(got[f"{case}/d{name}"]), want.numpy(), 1e-5,
                   f"rank {r} d{name}")


class _At:
    """A rank of the (data 2, model 2) grid, as ``shard_tree`` reads a mesh."""

    shape = {"data": 2, "model": 2}
    axis_names = tuple(shape)

    def __init__(self, rank):
        self.coords = dict(zip(self.axis_names, divmod(rank, 2)))

    def size(self, axes):
        return int(np.prod([self.shape[a] for a in axes]))

    def index(self, axes):
        idx = 0
        for a in ((axes,) if isinstance(axes, str) else axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx


@pytest.mark.parametrize("case", list(CASES))
def test_run_moe_branches_on_storage_blocks_match_the_virtual_mesh(four_devices, case):
    """Each case on every rank's storage blocks under the baseline policy
    (``_moe_blocks``: the experts over model, their FFN columns over data,
    the router replicated, the shared expert's ``ffn`` over model) and its
    rows of the batch (all 3 of the batch of 3): its output rows within
    1e-5 relative of the reference's 4-device oracle, its aux loss within
    1e-6, and the gradients of its rows and of each of its blocks (the
    replicated leaves' summed over data, as ``_loss_blocks`` sums them)
    within 1e-5 relative of the one-process computation's, cut to the
    rank's rows and blocks."""
    from repro_torch.models.transformer import batch_rows
    from repro_torch.sharding import make_policy, shard_tree

    oracle, ranks = four_devices
    cfg = _moe_cfg(get_config, MoEConfig, case)
    _, _, grads = _one_process(case)
    whole = {k: v for k, v in grads.items() if k != "x"}
    rows = oracle[case + "/out"].shape[0]
    for r, got in enumerate(ranks):
        at = _At(r)
        lo, n = batch_rows(at, rows)
        assert n == (rows // 2 if rows % 2 == 0 else rows)
        _close(torch.from_numpy(got[case + "/blocks/out"]), oracle[case + "/out"][lo:lo + n],
               1e-5, f"rank {r} out")
        assert abs(float(got[case + "/blocks/aux"]) - float(oracle[case + "/aux"])) <= 1e-6, r
        _close(torch.from_numpy(got[case + "/blocks/dx"]), grads["x"][lo:lo + n].numpy(), 1e-5,
               f"rank {r} dx")
        want = shard_tree(whole, make_policy(at, 0).shardings(moe_specs(cfg), whole), at)
        assert want["w_up"].shape[-1] == cfg.moe.d_expert // 2    # the columns over data
        for name, w in want.items():
            _close(torch.from_numpy(got[f"{case}/blocks/d{name}"]), w.numpy(), 1e-5,
                   f"rank {r} d{name}")


@pytest.mark.parametrize("case", list(CASES))
def test_world_of_one_matches_the_one_device_mesh(case):
    ref_cfg, cfg = _moe_cfg(ref_get_config, RefMoEConfig, case), _moe_cfg(get_config,
                                                                          MoEConfig, case)
    p, x, _, _ = _inputs(case)
    mesh = ref_make_host_mesh(1, 1)
    want, want_aux = jax.jit(lambda pp, xx: ref_tf._run_moe(pp, ref_cfg, xx, mesh))(p, x)
    got, got_aux = tf._run_moe({k: torch.from_numpy(v) for k, v in p.items()}, cfg,
                               torch.from_numpy(x), make_host_mesh())
    _close(got, want, 1e-5, "out")
    assert abs(float(got_aux) - float(want_aux)) <= 1e-6


# ------------------------------------------------- the entry points, a mesh of one
FAMILIES = {"dbrx": "dbrx-132b", "deepseek": "deepseek-v3-671b"}
B, S = 2, 12


def _family_cfgs(family):
    def one(get):
        cfg = get(FAMILIES[family], reduced=True)
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, impl="capacity", capacity_factor=0.5))
    return one(ref_get_config), one(get_config)


def test_per_client_weights_take_no_mesh():
    _, cfg = _family_cfgs("dbrx")
    flat = tf.init_transformer(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="per-client weights take no mesh"):
        tf.forward(torch.stack([flat, flat]), cfg, torch.zeros(2, 1, 4, dtype=torch.int64),
                   mesh=make_host_mesh())


def _family_setup(family):
    """The reference's reduced parameters (its init jitted) and the port's
    copy, a (1, 1) reference mesh and the port's mesh of one, and a batch
    of B x S tokens with two more for decoding."""
    ref_cfg, cfg = _family_cfgs(family)
    ref_p = jax.jit(lambda k: ref_tf.init_transformer(k, ref_cfg))(jax.random.PRNGKey(0))
    p = serving_params_from_jax(jax.tree.map(np.asarray, ref_p), cfg)
    # the reference's make_host_mesh(1, 1) with Auto axes, as the jax it was
    # written for made them: this jax makes them Explicit, and the
    # reference's decode cache constraint then raises
    ref_mesh = jax.make_mesh((1, 1), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, cfg.vocab, (B, S + 2)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return ref_cfg, cfg, ref_p, p, ref_mesh, make_host_mesh(), toks, {
        "tokens": toks[:, :S], "labels": labels}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_entry_points_under_a_mesh_of_one_match_reference(family):
    ref_cfg, cfg, ref_p, p, ref_mesh, mesh, toks, batch = _family_setup(family)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    # the capacity path runs and drops at these counts (cap 6 of 24 tokens)
    ids, w, _ = moe._router(p["layers"][0]["mlp"], cfg, torch.randn(B * S, cfg.d_model))
    kept = moe.dispatch(ids, w, moe.capacity(cfg, B * S), 0, cfg.moe.n_experts)[2].sum()
    assert int(kept) < B * S * cfg.moe.top_k

    h, _, aux, _ = jax.jit(lambda pp, b: ref_tf.forward(pp, ref_cfg, b, ref_mesh))(
        ref_p, {"tokens": batch["tokens"]})
    got_h, got_aux = tf.forward(p, cfg, tbatch["tokens"], with_aux=True, mesh=mesh)
    _close(got_h, h, 1e-5, "hidden")
    assert abs(float(got_aux) - float(aux)) <= 1e-6
    h_dense = tf.forward(p, cfg, tbatch["tokens"])
    assert (got_h - h_dense).abs().max() > 1e-3        # the drops change the function

    (loss, m) = jax.jit(lambda pp, b: ref_tf.loss_fn(pp, ref_cfg, b, ref_mesh))(ref_p, batch)
    got_loss, got_m = tf.loss_fn(p, cfg, tbatch, mesh)
    assert abs(float(got_loss) - float(loss)) <= 1e-5 * float(loss)
    for k in m:
        assert abs(float(got_m[k]) - float(m[k])) <= 1e-5 * max(1.0, abs(float(m[k]))), k

    max_len = S + 4
    want, ref_cache = jax.jit(lambda pp, b: ref_tf.prefill(pp, ref_cfg, b, max_len, ref_mesh))(
        ref_p, {"tokens": batch["tokens"]})
    got, cache = tf.prefill(p, cfg, {"tokens": tbatch["tokens"]}, max_len, mesh=mesh)
    _close(got, want, 1e-4, "prefill logits")
    _check_cache(cache, ref_cache, "float32", "prefill")
    step = jax.jit(lambda pp, b, c, pos: ref_tf.decode_step(pp, ref_cfg, b, c, pos, ref_mesh))
    for j, pos in enumerate((S, S + 1)):
        tok = toks[:, S + j:S + j + 1]
        want, ref_cache = step(ref_p, {"token": tok}, ref_cache, jnp.int32(pos))
        got, cache = tf.decode_step(p, cfg, {"token": torch.from_numpy(tok)}, cache, pos,
                                    mesh=mesh)
        _close(got, want, 1e-4, f"decode logits {pos}")
        _check_cache(cache, ref_cache, "float32", f"decode {pos}")


def test_train_step_under_a_mesh_of_one_matches_reference():
    """One launcher step of reduced dbrx under the mesh."""
    ref_cfg, cfg, ref_p, p, ref_mesh, mesh, _, batch = _family_setup("dbrx")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    # one launcher step under the mesh, with plain SGD after the clip:
    # AdamW's first step moves an element by about lr either way wherever
    # its gradient is within rounding of zero (here |g| ~ 1e-9 against
    # sums that differ by 1e-7), SGD by lr x g
    ref_opt = ref_chain(ref_clip(1.0), ref_sgd(0.5))
    opt = chain(clip_by_global_norm(1.0), sgd(0.5))
    new_ref, _, want_loss, _ = ref_train.make_train_step(ref_cfg, ref_opt, mesh=ref_mesh)(
        ref_p, ref_opt.init(ref_p), batch)
    new, state, got_loss, _ = train.make_train_step(cfg, opt, mesh=mesh)(p, opt.init(p), tbatch)
    assert abs(float(got_loss) - float(want_loss)) <= 1e-5 * float(want_loss)
    want_leaves = torch.utils._pytree.tree_leaves(
        serving_params_from_jax(jax.tree.map(np.asarray, new_ref), cfg))
    for i, (a, b) in enumerate(zip(torch.utils._pytree.tree_leaves(new), want_leaves)):
        _close(a, b.numpy(), 1e-5, f"param leaf {i}")
