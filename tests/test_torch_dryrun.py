"""The dry run (``repro_torch.launch.dryrun``) against the reference's and
against the port's own real runs, on the CPU.

The reference's layouts on a 2 x 4 mesh run in one subprocess with 8
virtual devices (``--xla_force_host_platform_device_count=8``, as
``tests/test_dryrun_mini.py`` runs its compiles), started by the first
test of this file and read by the last, so that the other cases run
meanwhile; its trees and jaxprs are made in this process:

- (a) the abstract tree: for all 10 configs at full size, every leaf of
  ``abstract_params`` has the shape and type of the reference's
  ``jax.eval_shape`` tree (the reference stacks the layers under one
  leading axis; the port keeps a list of layers);
- (b) product flops: for train, prefill and decode of the reduced
  configs at B = 8, S = 64, the dry run's ``flops`` on a mesh of one
  against the sum, over the reference's jaxpr of the same step (a (1, 1)
  mesh with Auto axes, remat off, attention and loss chunks of S, scan
  bodies times their length), of 2 x contracting size x output size of
  every ``dot_general``: equal on stablelm, qwen3, gemma3, internvl2,
  dbrx (``impl="capacity"``) and on hymba's train and prefill; hymba's
  decode within 1 % (the port's one-token Mamba step takes its C
  contraction as an elementwise product and a sum), deepseek
  (``impl="capacity"``) within 1 % (K3 takes MLA's values zero-padded
  from v_head_dim to the q/k width, and counts the padded columns),
  xlstm within 5 % once the port's layers run both cores and keep one,
  as the reference's ``jnp.where`` does (its mLSTM takes the normaliser
  and the state sums as einsums, the port as elementwise products and
  sums; the port's production count, which runs the flagged core only,
  is lower by the other core);
- (c) arguments: on a 2 x 4 mesh, ``argument_size`` equals the sum of
  the reference's ``NamedSharding.shard_shape`` bytes for train, prefill
  and decode of every reduced config, and the compiled
  ``argument_size_in_bytes`` of qwen3 train, hymba prefill and deepseek
  train;
- (d) peak memory: with ``path="cpu"`` the dry run's peak equals
  ``MemTracker``'s peak of the same step on real CPU tensors, exactly;
- (e) the meta branches of K1, K3 and K4: the CUDA path's outputs and
  saved tensors, its refusals, and the shared work formulas' tally;
- (f) collectives: each of ``_run_moe``'s four branches on a dry 2 x 2
  mesh tallies the bytes its collectives give, forward and backward;
- (g) probes: outside + L x per_layer equals the full trace's totals on
  a layer-uniform config;
- (h) the CLI writes one record with the reference's keys;
- (i) ``FederatedSimulation`` warns and gives ``HostEngine``'s history.
"""

import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from torch.utils._pytree import tree_flatten, tree_flatten_with_path  # noqa: E402

from repro_torch.configs import get_config, list_configs  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.configs.inputs import dummy_batch, dummy_decode_batch  # noqa: E402
from repro_torch.kernels.build import plain_on_meta, work_tally  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_dry_mesh  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

S, B = 64, 8
PEAK_S, PEAK_B = 16, 2   # the real CPU steps of (d): the plain scan is a loop over S

# the reference's layouts on 8 virtual devices: its shardings' bytes and
# three compiled argument sizes
_REF_SCRIPT = r"""
import json, math, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
from dataclasses import replace
import jax
from repro.configs import get_config, list_configs
from repro.configs.base import InputShape
from repro.jax_compat import set_mesh
from repro.launch.dryrun import build_step

S, B = %d, %d
out = {"args": {}, "compiled": {}}


def reduced(name):
    cfg = replace(get_config(name, reduced=True), remat=False, attn_chunk=S, loss_chunk=S)
    if cfg.moe:
        cfg = replace(cfg, moe=replace(cfg.moe, impl="capacity"))
    return cfg


mesh = jax.make_mesh((2, 4), ("data", "model"))
for name in list_configs():
    for kind in ("train", "prefill", "decode"):
        fn, specs, (ins, _), _ = build_step(reduced(name), mesh, InputShape("t", S, B, kind))
        out["args"][name + "/" + kind] = sum(
            math.prod(sh.shard_shape(x.shape)) * x.dtype.itemsize
            for x, sh in zip(jax.tree.leaves(specs), jax.tree.leaves(ins)))

for name, kind in %r:
    fn, specs, (ins, outs), donate = build_step(reduced(name), mesh, InputShape("t", S, B, kind))
    with set_mesh(mesh):
        compiled = jax.jit(fn, in_shardings=ins, out_shardings=outs,
                           donate_argnums=donate).lower(*specs).compile()
    out["compiled"][name + "/" + kind] = int(compiled.memory_analysis().argument_size_in_bytes)
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Several test workers share the cores: one intra-op thread keeps this
    file's many small torch operations from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


EXACT = ("stablelm-3b", "qwen3-14b", "gemma3-27b", "internvl2-1b", "dbrx-132b")
# arch -> (the kinds held exactly, the relative tolerance of the rest, why)
WITHIN = {
    "hymba-1.5b": (("train", "prefill"), 0.01,
                   "the one-token Mamba step's C contraction is elementwise in the port"),
    "deepseek-v3-671b": (("decode",), 0.01,
                         "K3 takes MLA's values zero-padded to the q/k width"),
    "xlstm-125m": ((), 0.05, "the mLSTM's normaliser and state sums are einsums in the "
                             "reference, elementwise in the port (both cores run, as the "
                             "reference's jnp.where runs them)"),
}
COMPILED = (("qwen3-14b", "train"), ("hymba-1.5b", "prefill"), ("deepseek-v3-671b", "train"))
_REF: dict = {}


@pytest.fixture(scope="module", autouse=True)
def _reference_subprocess(tmp_path_factory):
    """Start the reference's computations before this file's first test."""
    out = tmp_path_factory.mktemp("dryrun_ref") / "ref.json"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1] / "src")
    env["JAX_PLATFORMS"] = "cpu"
    script = _REF_SCRIPT % (S, B, COMPILED)
    _REF["proc"] = subprocess.Popen([sys.executable, "-c", script, str(out)], env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _REF["out"] = out
    yield
    if _REF["proc"].poll() is None:
        _REF["proc"].kill()
        _REF["proc"].wait()


def _reference() -> dict:
    if "data" not in _REF:
        log, _ = _REF["proc"].communicate(timeout=300)
        assert _REF["proc"].returncode == 0, log[-4000:]
        _REF["data"] = json.loads(_REF["out"].read_text())
    return _REF["data"]


@functools.cache
def _ref():
    """The reference's modules in this process: jax is initialised first,
    so that ``repro.launch.dryrun``'s XLA_FLAGS (set when it is imported)
    changes nothing here; it is taken back out of the environment."""
    import jax

    jax.devices()
    flags = os.environ.get("XLA_FLAGS")
    try:
        from repro.configs import get_config as ref_config
        from repro.jax_compat import set_mesh
        from repro.launch import dryrun as ref_dryrun
        from repro.models.transformer import init_transformer
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    return jax, ref_config, set_mesh, ref_dryrun, init_transformer


def _dot_flops(jaxpr) -> int:
    """2 x contracting size x output size of every ``dot_general`` in
    ``jaxpr`` and its sub-jaxprs, a scan's body times its length."""
    tot = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (lc, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval.shape
            tot += 2 * math.prod(lhs[i] for i in lc) * math.prod(eqn.outvars[0].aval.shape)
        if eqn.primitive.name == "while":
            raise ValueError("a while loop: its trip count is unknown")
        mult = eqn.params.get("length", 1) if eqn.primitive.name == "scan" else 1
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    tot += mult * _dot_flops(inner)
    return tot


def _ref_flops(name, kind) -> int:
    """The reference's step (its ``build_step``) on a (1, 1) mesh with Auto
    axes, remat off, attention and loss chunks of S: its products' flops."""
    jax, ref_config, set_mesh, ref_dryrun, _ = _ref()
    cfg = dataclasses.replace(ref_config(name, reduced=True), remat=False, attn_chunk=S,
                              loss_chunk=S)
    if cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl="capacity"))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    fn, specs, _, _ = ref_dryrun.build_step(cfg, mesh, InputShape("t", S, B, kind))
    with set_mesh(mesh):
        return _dot_flops(jax.make_jaxpr(fn)(*specs).jaxpr)


def _reduced(name, **kw):
    cfg = get_config(name, reduced=True)
    if cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl="capacity"))
    return dataclasses.replace(cfg, **kw)


# ---------------------------------------------------------------------------
# (d) peak memory along the CPU path
# ---------------------------------------------------------------------------


def _real_args(cfg, kind, args):
    """The step's arguments as real CPU tensors: ``init_params``' weights,
    ``dummy_batch``'s tokens, a zero cache."""
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    if kind == "decode":
        batch = dummy_decode_batch(cfg, PEAK_B, seed=1)
        return params, batch, tf.init_cache(cfg, PEAK_B, PEAK_S, device="cpu"), args[3]
    batch = dummy_batch(cfg, PEAK_B, PEAK_S, seed=1)
    if kind == "prefill":
        batch.pop("labels")
    return params, batch


def _real_peak(fn, args) -> int:
    from torch.distributed._tools.mem_tracker import MemTracker

    tracker = MemTracker()
    tracker.track_external(*[t for t in tree_flatten(args)[0] if isinstance(t, torch.Tensor)])
    with tracker:
        fn(*args)
    return int(sum(d["Total"] for d in tracker.get_tracker_snapshot("peak").values()))


@pytest.mark.parametrize("name", ["stablelm-3b", "hymba-1.5b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_cpu_path_peak_equals_memtracker_on_real_tensors(name, kind):
    cfg = _reduced(name)
    mesh = make_dry_mesh()
    fn, args, _, _ = dryrun.build_step(cfg, mesh, InputShape("t", PEAK_S, PEAK_B, kind))
    traced = dryrun.trace(fn, args, path="cpu")
    real = _real_args(cfg, kind, args)
    assert [tuple(t.shape) for t in tree_flatten(real)[0] if isinstance(t, torch.Tensor)] \
        == [tuple(t.shape) for t in tree_flatten(args)[0] if isinstance(t, torch.Tensor)]
    assert traced["peak"] == _real_peak(fn, real)
    assert traced["temp"] == traced["peak"] - traced["args"] > 0


def test_the_cuda_path_keeps_no_square_and_refuses_cpu_tensors():
    cfg = _reduced("stablelm-3b")
    fn, args, _, _ = dryrun.build_step(cfg, make_dry_mesh(), InputShape("t", 256, 2, "prefill"))
    card, plain = dryrun.trace(fn, args), dryrun.trace(fn, args, path="cpu")
    # the plain version's fp32 S x S scores and probabilities, which K3 never makes
    assert plain["peak"] - card["peak"] >= 2 * cfg.n_heads * 256 * 256 * 4
    assert set(card["kernel_work"]) == {"flash_attention_forward"} and not plain["kernel_work"]
    assert card["flops"] == plain["flops"]
    mixed = (args[0], {"tokens": torch.zeros(2, 256, dtype=torch.int32)})
    with pytest.raises(ValueError, match="meta arguments"):
        dryrun.trace(fn, mixed)

    def sneaks(params, batch):
        return params["embed"] @ torch.ones(cfg.d_model, 3)

    with pytest.raises(RuntimeError, match="cpu tensor"):
        dryrun.trace(sneaks, args)


# ---------------------------------------------------------------------------
# (e) the kernels' meta branches
# ---------------------------------------------------------------------------


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_meta_branch(dtype):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ops import (
        attention_call_work,
        flash_attention_backward,
        flash_attention_forward,
    )

    b, s, h, kv, d, window = 2, 96, 6, 2, 40, 32
    q, k, v = (_meta(b, s, n, d, dtype=dtype, grad=True) for n in (h, kv, kv))
    launches = (flash_attention_forward.launches, flash_attention_backward.launches)
    with work_tally() as tally:
        o = flash_attention(q, k, v, window, 0.0)
        saved = o.grad_fn.saved_tensors
        o.sum().backward()
    assert (o.shape, o.dtype, o.device.type) == ((b, s, h, d), dtype, "meta")
    assert [(tuple(t.shape), t.dtype) for t in saved] == [
        ((b, s, h, d), dtype), ((b, s, kv, d), dtype), ((b, s, kv, d), dtype),
        ((b, s, h, d), dtype), ((b, h, s), torch.float32)]
    assert q.grad.shape == q.shape and k.grad.shape == k.shape and v.grad.dtype == dtype
    assert (flash_attention_forward.launches, flash_attention_backward.launches) == launches
    for direction, backward in (("forward", False), ("backward", True)):
        want = attention_call_work((b, s, h, kv, d), window, 0.0, q.element_size(), backward)
        got = tally.kernels[f"flash_attention_{direction}"]
        assert got == {"launches": 1, "product_flops": want.product_flops, "flops": want.flops,
                       "bytes": want.bytes}
    # the whole square in the products, the visible pairs in the kernel
    fwd = attention_call_work((b, s, h, kv, d), window, 0.0, 2, False)
    assert fwd.product_flops == 4 * b * h * s * s * d
    assert fwd.flops == 4 * d * b * h * sum(min(i + 1, window) for i in range(s))
    # refusals: the CUDA path's limits
    with pytest.raises(ValueError, match="D <= 256"):
        flash_attention(*(_meta(1, 8, 2, 264) for _ in range(3)))
    with pytest.raises(ValueError, match="unit stride"):
        flash_attention(_meta(1, 8, 2, 16)[..., ::2],
                        _meta(1, 8, 2, 8), _meta(1, 8, 2, 8))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(*(_meta(1, 8, 2, 16, dtype=torch.float16) for _ in range(3)))
    with pytest.raises(ValueError, match="B and H <= 65535"):
        flash_attention(*(_meta(65536, 1, 1, 8) for _ in range(3)))
    with pytest.raises(ValueError, match="CPU, CUDA or meta"):
        flash_attention(_meta(1, 8, 2, 16), torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2, 16))
    # inside plain_on_meta the plain version runs, and nothing is tallied
    with work_tally() as tally, plain_on_meta():
        flash_attention(q, k, v)
    assert tally.kernels == {}


@pytest.mark.parametrize("final_state", [False, True])
def test_mamba_scan_meta_branch(final_state):
    from repro_torch.kernels.mamba_scan import mamba_scan
    from repro_torch.kernels.mamba_scan.ops import (
        mamba_scan_backward,
        mamba_scan_forward,
        scan_call_work,
    )

    b, s, d, n, g = 4, 50, 130, 16, 2
    x, dt = _meta(b, s, d, grad=True), _meta(b, s, d)
    bm, cm = _meta(b, s, n, grad=True), _meta(b, s, n)
    a_log, d_skip = _meta(g, d, n, grad=True), _meta(g, d)
    launches = (mamba_scan_forward.launches, mamba_scan_backward.launches)
    with work_tally() as tally:
        out = mamba_scan(x, dt, bm, cm, a_log, d_skip, final_state=final_state)
        y = out[0] if final_state else out
        saved = y.grad_fn.saved_tensors
        y.sum().backward()
    assert y.shape == (b, s, d) and y.device.type == "meta"
    if final_state:
        assert out[1].shape == (b, d, n) and out[1].dtype == torch.float32
    assert tuple(saved[-1].shape) == (b, -(-s // 8), d, n) and saved[-1].dtype == torch.float32
    assert x.grad.shape == x.shape and a_log.grad.shape == a_log.shape
    assert (mamba_scan_forward.launches, mamba_scan_backward.launches) == launches
    for direction, backward in (("forward", False), ("backward", True)):
        want = scan_call_work((b, s, d, n), g, 4, final_state and not backward, backward)
        assert tally.kernels[f"mamba_scan_{direction}"] == {
            "launches": 1, "product_flops": want.product_flops, "flops": want.flops,
            "bytes": want.bytes}
    # without a gradient: one forward, no checkpoints
    with torch.no_grad(), work_tally() as tally:
        mamba_scan(x, dt, bm, cm, a_log, d_skip)
    assert set(tally.kernels) == {"mamba_scan_forward"}
    with pytest.raises(ValueError, match="N <= 16"):
        mamba_scan(_meta(1, 4, 8), _meta(1, 4, 8), _meta(1, 4, 17), _meta(1, 4, 17),
                   _meta(8, 17), _meta(8))
    with pytest.raises(ValueError, match="contiguous"):
        mamba_scan(_meta(2, 8, 4).transpose(0, 1), _meta(8, 2, 4), _meta(8, 2, 2),
                   _meta(8, 2, 2), _meta(4, 2), _meta(4))
    with pytest.raises(TypeError, match="a_log and d_skip must be float32"):
        mamba_scan(_meta(1, 4, 8), _meta(1, 4, 8), _meta(1, 4, 2), _meta(1, 4, 2),
                   _meta(8, 2, dtype=torch.bfloat16), _meta(8))


def test_masked_weighted_sum_meta_branch():
    from repro_torch.kernels.aggregate import masked_weighted_sum
    from repro_torch.kernels.aggregate.ops import reduce_work

    before = masked_weighted_sum.launches
    with work_tally() as tally:
        out = masked_weighted_sum(_meta(3, 1000, dtype=torch.bfloat16), _meta(3))
    assert (out.shape, out.dtype, out.device.type) == ((1000,), torch.float32, "meta")
    want = reduce_work(3, 1000, 2)
    assert tally.kernels["masked_weighted_sum"] == {
        "launches": 1, "product_flops": 0.0, "flops": want.flops, "bytes": want.bytes}
    assert masked_weighted_sum.launches == before
    with pytest.raises(TypeError, match="weights must be float32"):
        masked_weighted_sum(_meta(3, 10), _meta(3, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        masked_weighted_sum(_meta(10, 3).T, _meta(3))


# ---------------------------------------------------------------------------
# (f) the MoE's collectives on a dry 2 x 2 mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["experts_all_axes", "experts_model_columns_data",
                                  "replicated", "sharded_batch"])
def test_run_moe_branch_collectives(case):
    n_experts, (b, s) = {"experts_all_axes": (8, (2, 64)),
                         "experts_model_columns_data": (6, (2, 64)),
                         "replicated": (5, (2, 64)),
                         "sharded_batch": (4, (4, 2100))}[case]
    cfg = _reduced("dbrx-132b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=n_experts))
    d, fe, k, e = cfg.d_model, cfg.moe.d_expert, cfg.moe.top_k, n_experts
    mesh = make_dry_mesh(2, 2)
    p = {name: t.requires_grad_(True) for name, t in
         tf.abstract_params(cfg)["layers"][0]["mlp"].items()}
    x = _meta(b, s, d, grad=True)
    with work_tally() as tally:
        out, aux = tf._run_moe(p, cfg, x, mesh)
        (out.sum() + aux).backward()
    assert out.shape == x.shape and x.grad.shape == x.shape
    t, f32 = b * s, 4
    weights = 3 * e * d * fe * f32            # w_gate, w_up, w_down: whole gradients summed
    if case == "replicated":
        want = {}
    elif case != "sharded_batch":
        # forward: the partial outputs over every axis; backward: the
        # weights', the tokens' and the kept router weights' gradients
        want = {"all-reduce": t * d * f32 + weights + t * d * f32 + t * k * f32}
    else:
        t_loc = t // 2                         # the batch split over data
        want = {
            # forward: the partial outputs over model, the aux mean over data;
            # backward: the weights (over model and data), the router's and
            # x's gradients over data, the local tokens and kept weights over model
            "all-reduce": t_loc * d * f32 + f32 + weights + d * e * f32 + t * d * f32
            + t_loc * d * f32 + t_loc * k * f32,
            "all-gather": t * d * f32,         # the outputs gathered over data
        }
    assert tally.collectives == want
    assert tally.kernels == {}


SHARDED = ("gemma3-27b", "glm4-9b", "qwen3-14b", "stablelm-3b", "hymba-1.5b", "internvl2-1b",
           "musicgen-large", "xlstm-125m", "dbrx-132b", "deepseek-v3-671b")


@pytest.mark.parametrize("name", list_configs())
def test_records_say_whether_the_rank_holds_its_blocks(name, monkeypatch):
    """The single-mesh ``train``, ``prefill`` and ``decode`` records (a
    batch of 16, which the 16 data ranks divide) and the federated round's
    of every family, the MoE and MLA models among them (their experts over
    ``model``, the experts' FFN columns over ``data``, MLA's heads over
    ``model``), hold the rank's blocks (``storage`` "sharded",
    ``argument_size_held == argument_size``), less than the whole
    arguments on a mesh of one."""
    from repro_torch.launch.mesh import make_production_mesh

    assert name in SHARDED
    monkeypatch.setattr(dryrun, "get_config", _reduced)
    mesh = make_production_mesh(dry=True)
    cfg = _reduced(name)
    recs = [dryrun.trace_step(cfg, mesh, InputShape("t", 32, 16, kind), probes=False)
            for kind in ("train", "prefill", "decode")]
    recs.append(dryrun.run_federated(name, local_steps=1, batch_per_client=16, seq=32))
    for rec in recs:
        mem = rec["memory"]
        assert rec["storage"] == "sharded", rec["kind"]
        assert mem["argument_size_held"] == mem["argument_size"], rec["kind"]
        if rec["kind"] == "train":
            whole = dryrun.argument_size(cfg, make_dry_mesh(), InputShape("t", 32, 16, "train"))
            assert mem["argument_size_held"] < whole, rec["kind"]


@pytest.mark.parametrize(("name", "shape"), [("dbrx-132b", "decode_32k"),
                                             ("deepseek-v3-671b", "long_500k")])
def test_full_size_moe_and_mla_records_hold_their_blocks(name, shape):
    """At full size on the 16 x 16 dry mesh: dbrx-132b's ``decode_32k``
    holds 41.5 GiB a rank (885.1 while its leaves stayed whole), its
    ``argument_size``; deepseek-v3-671b's ``long_500k`` (batch 1: the
    latent and k_rope cache's sequence over the 16 data ranks, the
    partial softmaxes combined over them) its 11.1 GiB share, its decode
    taking rule 1 (one whole expert a rank, exchanged from the blocks by
    an all-to-all)."""
    rec = dryrun.run_one(name, shape, multi_pod=False)
    mem = rec["memory"]
    assert rec["storage"] == "sharded"
    assert mem["argument_size_held"] == mem["argument_size"]
    held = mem["argument_size_held"] / 2**30
    assert abs(held - {"dbrx-132b": 41.49, "deepseek-v3-671b": 11.13}[name]) < 0.01, held
    if name == "deepseek-v3-671b":
        assert rec["collective_bytes"]["all-to-all"] > 0


@pytest.mark.parametrize("name", SHARDED)
def test_serving_records_shard_where_the_data_axes_divide_the_batch(name):
    """On a dry 2 x 2 mesh the prefill and decode records of the families
    that shard hold the rank's blocks, its rows and its cache block where
    the 2 data ranks divide the batch (4), with ``argument_size_held ==
    argument_size`` and the logits replicated; a batch of 3 and a prefill
    of 1 hold the ``model`` blocks and every row, which is their share
    too; a decode of batch 1 holds its block of the cache's sequence over
    the data axes, as the policy's ``shard_seq`` lays it out: its share
    ("sharded"); a decode of 3 holds that sequence block too, as the
    reference's step constrains its cache, less than the policy's share,
    which keeps the step's cache argument whole over the data axes
    (xlstm's cache has no sequence: its share).  Each holds less than the
    whole arguments."""
    cfg = _reduced(name)
    mesh = make_dry_mesh(2, 2)
    for kind in ("prefill", "decode"):
        for batch in (4, 3, 1):
            shape = InputShape("t", 32, batch, kind)
            fn, args, _, _ = dryrun.build_step(cfg, mesh, shape)
            traced = dryrun.trace(fn, args, memory=False)
            held = traced["args"] + traced["scalars"]
            want = dryrun.argument_size(cfg, mesh, shape)
            whole = dryrun.argument_size(cfg, make_dry_mesh(), shape)
            below = kind == "decode" and batch == 3 and cfg.block_type != "xlstm"
            assert dryrun.step_storage(cfg, mesh, kind) == "sharded"
            assert (held < want) if below else (held == want), (kind, batch, held, want)
            assert held < whole, (kind, batch, want, held, whole)
            logits = fn(*args)[0]
            assert logits.shape == (batch, cfg.vocab), (kind, batch)


def test_dry_mesh_layouts_and_refusals():
    from repro_torch.launch.mesh import make_production_mesh

    single, multi = (make_production_mesh(multi_pod=m, dry=True) for m in (False, True))
    assert single.shape == {"data": 16, "model": 16} and single.world == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16} and multi.world == 512
    assert multi.coords == {"pod": 0, "data": 0, "model": 0} and multi.rank == 0
    with pytest.raises(RuntimeError, match="names 256 devices"):
        make_production_mesh()
    with work_tally() as tally:
        g = multi.all_gather(_meta(3, 5), ("pod", "data"))
        r = multi.all_reduce_sum(_meta(7), "model")
    assert g.shape == (96, 5) and r.shape == (7,)
    assert tally.collectives == {"all-gather": 96 * 5 * 4, "all-reduce": 7 * 4}
    with pytest.raises(RuntimeError, match="meta"):
        single.all_reduce_sum(torch.zeros(3))


# ---------------------------------------------------------------------------
# (g) probes, (h) the CLI, (i) the simulation shim
# ---------------------------------------------------------------------------


def test_probes_add_up_to_the_full_trace():
    cfg = _reduced("stablelm-3b", n_layers=4)
    shape = InputShape("t", S, 4, "train")
    mesh = make_dry_mesh()
    probes = dryrun.probe_costs(cfg, mesh, shape)
    fn, args, _, _ = dryrun.build_step(cfg, mesh, shape)
    full = dryrun.trace(fn, args, memory=False)
    assert probes["total"]["flops"] == full["flops"] > 0
    assert probes["total"]["bytes"] == full["bytes"]
    assert probes["outside"]["flops"] + 4 * probes["per_layer"]["flops"] == full["flops"]


def test_cli_writes_one_record_with_the_reference_keys(tmp_path):
    out = tmp_path / "dry.jsonl"
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "xlstm-125m", "--shape", "long_500k", "--mesh", "single",
                     "--out", str(out)])
    assert done.value.code == 0
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert {"arch", "config_name", "shape", "policy", "mesh", "n_devices", "kind", "flops",
            "bytes_accessed", "collective_bytes", "probes", "memory", "t_trace_s",
            "kernel_work"} <= set(rec)
    assert set(rec["memory"]) == {"argument_size", "argument_size_held", "output_size",
                                  "temp_size", "generated_code_size"}
    assert rec["n_devices"] == 256 and rec["kind"] == "decode" and rec["flops"] > 0
    assert set(rec["probes"]) == {"per_layer", "outside", "total"}
    # xlstm's decode cache has no sequence axis: a batch of one on blocks
    # holds exactly its share of the reference's layout
    assert rec["storage"] == "sharded"
    assert rec["memory"]["argument_size"] == rec["memory"]["argument_size_held"]


def test_federated_simulation_shim_warns_and_runs_the_host_engine(data):
    from conftest import fl_cfg
    from repro_torch.engine import FLConfig, make_engine
    from repro_torch.federated import FederatedSimulation

    train, test = data
    cfg = FLConfig.from_dict(fl_cfg().to_dict())
    with pytest.warns(DeprecationWarning, match="FederatedSimulation is deprecated"):
        sim = FederatedSimulation(cfg, train, test, 10, device="cpu")
    want = make_engine(cfg, train, test, 10, device="cpu").run()
    assert sim.backend == "host" and sim.run() == want


# ---------------------------------------------------------------------------
# (a), (b), (c): against the reference's subprocess
# ---------------------------------------------------------------------------


def _port_path(path) -> tuple[str, int | None]:
    """A port leaf path -> (the reference's stacked path, the layer index)."""
    keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
    if keys[0] == "layers":
        return "/".join(["layers", *map(str, keys[2:])]), keys[1]
    return "/".join(map(str, keys)), None


@pytest.mark.parametrize("name", list_configs())
def test_abstract_tree_matches_the_reference_eval_shape(name):
    jax, ref_config, _, _, init_transformer = _ref()
    cfg = get_config(name)
    shapes = jax.eval_shape(lambda k: init_transformer(k, ref_config(name)),
                            jax.random.PRNGKey(0))
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            [list(x.shape), str(x.dtype)]
            for path, x in jax.tree_util.tree_leaves_with_path(shapes)}
    got: dict[str, list] = {}
    for path, leaf in tree_flatten_with_path(tf.abstract_params(cfg))[0]:
        key, layer = _port_path(path)
        assert leaf.device.type == "meta"
        dtype = str(leaf.dtype).replace("torch.", "")
        if layer is None:
            got[key] = [list(leaf.shape), dtype]
        else:
            stacked = got.setdefault(key, [[0, *leaf.shape], dtype])
            assert stacked == [[stacked[0][0], *leaf.shape], dtype], key
            stacked[0][0] += 1
    assert got == want


def _both_cores(monkeypatch):
    """The reference's xLSTM layer: both cores on every layer, the flagged
    one kept (``jnp.where``), so that the other's products run both ways."""
    seq, dec = tf._apply_layer_seq, tf._apply_layer_decode

    def both_seq(pl, cfg, x, flags, *a, **kw):
        other = "slstm" if flags["is_mlstm"] > 0 else "mlstm"
        o, _ = getattr(ssm, f"{other}_seq")(pl["xlstm"], cfg, tf._norm(pl, cfg, x, "norm1"))
        x2, aux, cache = seq(pl, cfg, x, flags, *a, **kw)
        return x2 + 0.0 * o, aux, cache

    def both_decode(pl, cfg, x, flags, tabs_l, tabs_g, cache, i, pos, mesh=None, **kw):
        other = "slstm" if flags["is_mlstm"] > 0 else "mlstm"
        getattr(ssm, f"{other}_decode")(pl["xlstm"], cfg, tf._norm(pl, cfg, x, "norm1"),
                                        tuple(t[i] for t in cache[other]))
        return dec(pl, cfg, x, flags, tabs_l, tabs_g, cache, i, pos, mesh, **kw)

    monkeypatch.setattr(tf, "_apply_layer_seq", both_seq)
    monkeypatch.setattr(tf, "_apply_layer_decode", both_decode)


@pytest.mark.parametrize("name", EXACT + tuple(WITHIN))
def test_product_flops_match_the_reference_jaxpr(name, monkeypatch):
    cfg = _reduced(name)
    for kind in ("train", "prefill", "decode"):
        fn, args, _, _ = dryrun.build_step(cfg, make_dry_mesh(), InputShape("t", S, B, kind))
        got = dryrun.trace(fn, args, memory=False)["flops"]
        want = _ref_flops(name, kind)
        if name == "xlstm-125m":
            # the production count runs the flagged core only
            assert got < want
            with monkeypatch.context() as m:
                _both_cores(m)
                fn, args, _, _ = dryrun.build_step(cfg, make_dry_mesh(),
                                                   InputShape("t", S, B, kind))
                got = dryrun.trace(fn, args, memory=False)["flops"]
        exact, tol, why = WITHIN.get(name, (("train", "prefill", "decode"), 0.0, ""))
        if kind in exact:
            assert got == want, (name, kind)
        else:
            assert got != want and abs(got - want) <= tol * want, (name, kind, got, want, why)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_argument_size_matches_the_reference_shardings(kind):
    ref = _reference()
    mesh = make_dry_mesh(2, 4)
    for name in list_configs():
        cfg = _reduced(name)
        fn, args, (in_specs, _), _ = dryrun.build_step(cfg, mesh, InputShape("t", S, B, kind))
        got = dryrun._argument_size(mesh, in_specs, args)
        assert got == ref["args"][f"{name}/{kind}"], name
        if (name, kind) in COMPILED:
            assert got == ref["compiled"][f"{name}/{kind}"], name
