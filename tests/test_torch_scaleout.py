"""The scaleout backend against the port's host backend and the JAX
package on the CPU.

- ``ScaleoutEngine`` (one process: every pod) under ``JaxReplayDraws``
  against the port's ``host`` run (selections, ``comm_mb`` and losses
  exactly, parameters within 1e-5) and the reference's ``scaleout``
  backend on its one CPU device (selections and ``comm_mb`` exactly,
  losses within 1e-5 relative, parameters within 1e-5), on the
  classification task and the micro LM of ``tests/conftest.py``; under a
  systems deadline with survivors (every axis field of each round, as
  ``check_rounds_against_reference`` holds them), and with none;
- ``FLConfig(backend="scaleout")`` accepts and refuses what the reference
  accepts and refuses, message for message, and the engine checks again;
- ``make_federated_round`` against the oracle of the reference's own test
  (``tests/test_scaleout.py``): each pod trained alone with the
  reference's ``loss_fn`` under ``jax.value_and_grad``, then the weighted
  average, within 1e-5 (compress_bits 0) or within half a quantization
  step a pod, weighted (compress_bits 8); a zero-weight pod has no
  influence;
- the ``Mesh``: the pod axis, the refusals, the grid round accepted, the
  backend check;
- a world of two CPU processes under gloo (a file store in the test's
  directory, a time limit of its own): the engine and the round equal the
  single process holding both pods within 1e-5."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402

from conftest import LM_VOCAB, fl_cfg, lm_fl_cfg  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.inputs import dummy_batch as ref_dummy_batch  # noqa: E402
from repro.engine import FLConfig as RefFLConfig  # noqa: E402
from repro.engine import make_engine as ref_make_engine  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.inputs import dummy_batch  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    params_from_jax,
    serving_params_from_jax,
    transformer_params_from_jax,
)
from repro_torch.engine import FLConfig, ScaleoutEngine, make_engine  # noqa: E402
from repro_torch.federated.scaleout import make_federated_round, stack_for_clients  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    Mesh,
    backend_for,
    make_dry_mesh,
    make_host_mesh,
    make_production_mesh,
)
from test_torch_engine import JaxReplayDraws  # noqa: E402
from test_torch_systems import _ALWAYS, _SYS, check_rounds_against_reference  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ATOL = 1e-5



@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Several test workers share the cores: one intra-op thread keeps this
    file's many small torch calls from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _port(cfg, data, n_classes, **kw):
    train, test = data
    return make_engine(cfg, train, test, n_classes, device="cpu",
                       draws=JaxReplayDraws(cfg.seed, "cpu"), **kw)


def _flat(engine, ref_params):
    tree = jax.tree.map(np.asarray, ref_params)
    if engine.cfg.task == "lm":
        return transformer_params_from_jax(tree, engine.task.model_cfg).numpy()
    return params_from_jax(tree).numpy()


# ---------------------------------------------------------------- the engine
@pytest.mark.parametrize("task", ["classification", "lm"])
def test_scaleout_matches_host_and_the_reference(task, data, lm_data):
    ref_cfg, datasets, n_classes, rounds = (
        (fl_cfg(backend="scaleout"), data, 10, 3) if task == "classification"
        else (lm_fl_cfg(backend="scaleout"), lm_data, LM_VOCAB, 2))
    train, test = datasets
    ref_eng = ref_make_engine(ref_cfg, train, test, n_classes=n_classes)
    ref_res = list(ref_eng.rounds(rounds))
    cfg = FLConfig.from_dict(ref_cfg.to_dict())
    eng = _port(cfg, datasets, n_classes)
    # one process holds every pod here; the reference's default mesh takes as many
    # pods as the worker's jax has devices (up to K), which changes no number
    assert type(eng) is ScaleoutEngine and eng.n_pods == 1 and eng.mesh.world == 1
    res = list(eng.rounds(rounds))
    host = _port(FLConfig.from_dict({**cfg.to_dict(), "backend": "host"}), datasets, n_classes)
    host_res = list(host.rounds(rounds))
    for r, h, w in zip(res, host_res, ref_res):
        assert r.selected == h.selected == w.selected
        assert r.comm_mb == h.comm_mb == w.comm_mb
        assert r.mean_selected_loss == h.mean_selected_loss
        assert r.mean_selected_loss == pytest.approx(w.mean_selected_loss, rel=1e-5)
        assert r.test_loss == h.test_loss
    np.testing.assert_allclose(eng.params.numpy(), host.params.numpy(), atol=ATOL)
    np.testing.assert_allclose(eng.params.numpy(), _flat(eng, ref_eng.params), atol=ATOL)


def test_scaleout_under_a_deadline_keeps_the_survivors(data):
    # the reference's scaleout backend and the port's, every axis field exactly
    results = check_rounds_against_reference(data, fl_cfg(backend="scaleout", systems=_SYS))
    assert any(0 < r.n_dropped for r in results) and all(r.selected for r in results)
    cfg = FLConfig.from_dict(fl_cfg(backend="scaleout", systems=_SYS).to_dict())
    eng, host = _port(cfg, data, 10), _port(dataclasses.replace(cfg, backend="host"), data, 10)
    for a, b in zip(eng.rounds(), host.rounds()):
        assert (a.selected, a.n_dropped, a.sim_time) == (b.selected, b.n_dropped, b.sim_time)
    np.testing.assert_allclose(eng.params.numpy(), host.params.numpy(), atol=ATOL)
    nobody = _port(FLConfig.from_dict(fl_cfg(backend="scaleout", systems={
        **_ALWAYS, "deadline_s": 1e-6}).to_dict()), data, 10)
    before = nobody.params.clone()
    rs = list(nobody.rounds(2))
    assert all(r.selected == () and r.n_dropped == 6 for r in rs)
    assert torch.equal(before, nobody.params)


# ---------------------------------------------------------------- the config
CONFIGS = [
    {},
    {"strategy": "poc"},
    {"strategy": "lossonly"},
    {"strategy": "random"},
    {"task": "lm", "task_kwargs": {"model": "stablelm-3b"}},
    {"systems": {"profile": "mobile_mix", "deadline_s": 30.0, "over_select": 1.3}},
    {"strategy": "fedcls"},
    {"strategy": "fedcor"},
    {"client_mode": "fedprox"},
    {"client_mode": "feddyn", "aggregator": "feddyn"},
    {"aggregator": "fednova"},
    {"aggregator": "trimmed_mean"},
    {"fuse_rounds": 2},
    {"compress_bits": 8},
    {"faults": {"rate": 0.1}},
    {"population": {"n_shards": 2}},
    {"async_mode": {"buffer_k": 2}, "systems": {}},
    {"aggregator": "fednova", "fuse_rounds": 2},
    {"faults": {"rate": 0.1}, "population": {"n_shards": 2}},
]


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: "-".join(map(str, kw)) or "plain")
def test_config_accepts_and_refuses_as_the_reference(kw):
    full = {"backend": "scaleout", **kw}
    try:
        want = RefFLConfig(**full)
    except ValueError as ref_err:
        with pytest.raises(ValueError) as err:
            FLConfig(**full)
        assert str(err.value) == str(ref_err)
        return
    cfg = FLConfig(**full)
    assert cfg.to_dict() == want.to_dict() and FLConfig.from_dict(cfg.to_dict()) == cfg


def test_engine_checks_the_aggregator_and_the_mesh_again(data):
    cfg = FLConfig.from_dict(fl_cfg(backend="scaleout").to_dict())
    cfg.aggregator = "fednova"
    ref = fl_cfg(backend="scaleout")
    ref.aggregator = "fednova"
    train, test = data
    with pytest.raises(ValueError) as ref_err:
        ref_make_engine(ref, train, test, n_classes=10)
    with pytest.raises(ValueError) as err:
        make_engine(cfg, train, test, 10, device="cpu")
    assert str(err.value) == str(ref_err.value)
    good = FLConfig.from_dict(fl_cfg(backend="scaleout").to_dict())
    with pytest.raises(ValueError, match="'pod' \\(client\\) axis; got axes \\('data', 'model'\\)"):
        make_engine(good, train, test, 10, device="cpu", mesh=make_host_mesh())
    with pytest.raises(ValueError, match="divisible by the pod axis"):
        make_engine(good, train, test, 10, device="cpu", mesh=make_host_mesh(pod=5))
    with pytest.raises(ValueError, match="mesh= applies"):
        make_engine(FLConfig.from_dict(fl_cfg().to_dict()), train, test, 10, device="cpu",
                    mesh=make_host_mesh(pod=1))
    with pytest.raises(ValueError, match="cohort_gather=False applies"):
        make_engine(good, train, test, 10, device="cpu", cohort_gather=False)
    four = make_engine(good, train, test, 10, device="cpu", mesh=make_host_mesh(pod=4))
    assert four.n_pods == 4 and four._block == slice(0, 12)


def test_mesh_axes_and_refusals():
    mesh = make_host_mesh(pod=3)
    assert mesh.shape == {"pod": 3, "data": 1, "model": 1} and mesh.world == 1
    assert mesh.pods == range(0, 3) and "pod" not in make_host_mesh().shape
    t = torch.arange(4.0)
    assert mesh.all_reduce_sum(t) is t and mesh.all_gather(t) is t
    # a data or model axis names one process a device: this world has one
    with pytest.raises(ValueError, match="names 2 processes, one device each; this world has 1"):
        make_host_mesh(data=2)
    with pytest.raises(ValueError, match="names 4 processes, one device each; this world has 1"):
        make_host_mesh(model=2, pod=2)
    one = make_host_mesh(1, 1)   # the card's: a grid of one device
    assert one.coords == {"data": 0, "model": 0} and one.index(("data", "model")) == 0
    assert one.all_reduce_mean(t, "model") is t and one.grad_sum(t) is t
    # the scale-out round takes a data or model axis, one pod a process: rank
    # 0 of a dry (pod 2, data 2, model 1) grid, which this world cannot hold
    grid = make_dry_mesh(2, 1, pod=2)
    assert grid.grid and grid.pods == range(0, 1) and not hasattr(Mesh, "require_pods_only")
    assert callable(make_federated_round(get_config("qwen3-14b", reduced=True), grid, lr=0.1))
    for multi_pod in (False, True):
        with pytest.raises(RuntimeError, match="names (256|512) devices; this world has 1"):
            make_production_mesh(multi_pod=multi_pod)
    assert (backend_for("cuda"), backend_for(torch.device("cpu"))) == ("nccl", "gloo")
    assert isinstance(mesh, Mesh)


# ------------------------------------------------------ the federated round
B, S, LR, STEPS = 4, 64, 0.05, 3


@pytest.fixture(scope="module")
def round_setup():
    """qwen3-14b reduced (fp32): the reference's params, two pods' batches
    and each pod trained alone by the reference (the oracle)."""
    ref_cfg, cfg = ref_get_config("qwen3-14b", reduced=True), get_config("qwen3-14b", reduced=True)
    ref_p = ref_tf.init_transformer(jax.random.PRNGKey(0), ref_cfg)
    batches = [ref_dummy_batch(ref_cfg, B, S, seed=s) for s in (10, 11)]

    @jax.jit
    def local(params, b):
        p = params
        for _ in range(STEPS):
            (_, _), g = jax.value_and_grad(ref_tf.loss_fn, has_aux=True)(p, ref_cfg, b)
            p = jax.tree.map(lambda w, gw: w - LR * gw, p, g)
        return p

    locals_ = [jax.tree.map(np.asarray, local(ref_p, b)) for b in batches]
    params = serving_params_from_jax(jax.tree.map(np.asarray, ref_p), cfg)
    batch = {k: torch.stack([dummy_batch(cfg, B, S, seed=s)[k] for s in (10, 11)])
             for k in batches[0]}
    start = jax.tree.map(np.asarray, ref_p)
    return cfg, params, batch, [serving_params_from_jax(lp, cfg) for lp in locals_], \
        serving_params_from_jax(start, cfg)


def _leaves(tree):
    return torch.utils._pytree.tree_leaves(tree)


@pytest.mark.parametrize("weights", [(0.25, 0.75), (0.0, 1.0)])
def test_federated_round_matches_the_independent_training_oracle(round_setup, weights):
    cfg, params, batch, locals_, _ = round_setup
    round_fn = make_federated_round(cfg, make_host_mesh(pod=2), lr=LR, local_steps=STEPS)
    w = torch.tensor(weights)
    new, losses = round_fn(stack_for_clients(params, 2), batch, w)
    assert losses.shape == (2,) and bool(torch.isfinite(losses).all())
    for got, a, b in zip(_leaves(new), _leaves(locals_[0]), _leaves(locals_[1])):
        torch.testing.assert_close(got[0], weights[0] * a + weights[1] * b, atol=ATOL, rtol=0)
        assert torch.equal(got[0], got[1])
    # other data for pod 0: no influence at weight 0 (up to the CPU's
    # run-to-run matmul noise), a material one at weight 0.25
    moved = {**batch, "tokens": torch.stack([batch["tokens"][0].flip(-1), batch["tokens"][1]])}
    again, _ = round_fn(stack_for_clients(params, 2), moved, w)
    diff = max(float((x - y).abs().max()) for x, y in zip(_leaves(again), _leaves(new)))
    assert diff <= 1e-6 if weights[0] == 0 else diff > 1e-4


def test_compressed_round_is_within_the_quantization_step(round_setup):
    cfg, params, batch, locals_, start = round_setup
    weights = (0.25, 0.75)
    round_fn = make_federated_round(cfg, make_host_mesh(pod=2), lr=LR, local_steps=STEPS,
                                    compress_bits=8)
    new, _ = round_fn(stack_for_clients(params, 2), batch, torch.tensor(weights))
    for got, a, b, s in zip(_leaves(new), _leaves(locals_[0]), _leaves(locals_[1]),
                            _leaves(start)):
        exact = weights[0] * a + weights[1] * b
        step = sum(w * (x - s).abs().max() / 127 for w, x in zip(weights, (a, b)))
        err = (got[0] - exact).abs().max()
        assert err <= 0.5 * step + 1e-6, (float(err), float(step))


def test_federated_round_checks_its_inputs(round_setup):
    cfg, params, batch, _, _ = round_setup
    with pytest.raises(ValueError, match="'pod'"):
        make_federated_round(cfg, make_host_mesh(), lr=LR)
    with pytest.raises(ValueError, match="compress_bits"):
        make_federated_round(cfg, make_host_mesh(pod=2), lr=LR, compress_bits=9)
    round_fn = make_federated_round(cfg, make_host_mesh(pod=2), lr=LR, local_steps=1)
    with pytest.raises(ValueError, match="holds 2 pods"):
        round_fn(stack_for_clients(params, 3), batch, torch.tensor([0.5, 0.5]))
    with pytest.raises(ValueError, match="one a pod"):
        round_fn(stack_for_clients(params, 2), batch, torch.tensor([1.0]))


# ------------------------------------------------------ a world of two (gloo)
_WORLD_SCRIPT = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + store, world_size=2, rank=rank)
from world_case import engine_run, round_run
from repro_torch.launch.mesh import make_host_mesh

mesh = make_host_mesh(pod=2)
assert mesh.world == 2 and mesh.pods == range(rank, rank + 1)
results, params = engine_run(None)
new, losses = round_run(mesh)
np.savez(out + f"/rank{rank}.npz", params=params, losses=losses.numpy(),
         selected=np.array([len(r.selected) for r in results]),
         sel=np.concatenate([r.selected for r in results]),
         new=torch.cat([t[0].reshape(-1) for t in torch.utils._pytree.tree_leaves(new)]).numpy())
dist.destroy_process_group()
"""

_CASE = r"""
import torch
from repro_torch.configs import get_config
from repro_torch.configs.inputs import dummy_batch
from repro_torch.data import make_classification
from repro_torch.engine import FLConfig, make_engine
from repro_torch.federated.scaleout import make_federated_round, stack_for_clients
from repro_torch.models.transformer import init_params

def engine_run(mesh):
    train = make_classification(400, n_features=16, n_classes=4, seed=0)
    test = make_classification(100, n_features=16, n_classes=4, seed=1)
    cfg = FLConfig(backend="scaleout", n_clients=8, m=3, rounds=3, hidden=(8,),
                   eval_samples=8, eval_every=1, target_hd=0.5, strategy_kwargs={"J": 2})
    eng = make_engine(cfg, train, test, 4, device="cpu", mesh=mesh)
    assert eng.n_pods == 2
    results = list(eng.rounds())
    return results, eng.params.numpy()

def round_run(mesh):
    cfg = get_config("qwen3-14b", reduced=True)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    pods = list(mesh.pods)
    batch = {k: torch.stack([dummy_batch(cfg, 2, 32, seed=10 + p)[k] for p in pods])
             for k in ("tokens", "labels")}
    fn = make_federated_round(cfg, mesh, lr=0.05, local_steps=2)
    return fn(stack_for_clients(params, len(pods)), batch, torch.tensor([0.25, 0.75]))
"""


def test_world_of_two_under_gloo_matches_one_process(tmp_path):
    (tmp_path / "world_case.py").write_text(_CASE)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(tmp_path)])}
    procs = [subprocess.Popen([sys.executable, "-c", _WORLD_SCRIPT, str(r),
                               str(tmp_path / "store"), str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    sys.path.insert(0, str(tmp_path))
    try:
        import world_case
    finally:
        sys.path.remove(str(tmp_path))
    results, params = world_case.engine_run(make_host_mesh(pod=2))
    new, losses = world_case.round_run(make_host_mesh(pod=2))
    one = torch.cat([t[0].reshape(-1) for t in torch.utils._pytree.tree_leaves(new)]).numpy()
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        assert got["sel"].tolist() == [c for res in results for c in res.selected]
        np.testing.assert_allclose(got["params"], params, atol=ATOL)
        np.testing.assert_allclose(got["losses"], losses.numpy(), atol=ATOL)
        np.testing.assert_allclose(got["new"], one, atol=ATOL)
