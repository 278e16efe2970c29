#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each printed on its own lines:

1. device  — requires ``torch.cuda.is_available()``; prints the card's
   name and power limit as ``nvidia-smi`` reports them.
2. build   — compiles every CUDA kernel of the port from ``src/repro_torch/csrc``
   with nvcc (one process per source, in parallel) into ``build/kernels/``.
3. kernels — holds each kernel against its plain PyTorch version on the
   card and times the kernel, the plain version and one PyTorch library
   call computing the same function where one exists (median over 30
   calls, CUDA events; 5 for the plain scan over 2048 steps).
4. main paths, each driven through ``make_engine(...).rounds()`` with
   every kernel's launch count set to 0 just before and read just after:
   - the paper's experiment at full width (K = 100 clients, m = 10, MLP
     784-200-200-10, shards partition at target HD 0.9, FedLECC with
     J = 3, batch 64, lr 0.005) for 5 rounds;
   - federated LM training on stablelm-3b at full width, cut from 32 to
     2 layers (P = 380,789,760), K = 100, m = 10, batch 8 of 64 tokens,
     3 rounds, with the flash-attention kernel forward (poll, local SGD,
     evaluation) and backward (local SGD);
   - federated LM training on hymba-1.5b at full width, cut from 32 to 6
     layers (P = 344,430,400), the same data recipe and settings, with the
     flash-attention kernel at hymba's shape and the selective-scan kernel,
     each forward (poll, local SGD, evaluation) and backward (local SGD).
5. agreement — a small configuration of each task and model run on the
   CPU (plain versions) and on the card (kernels) from the same draws must
   select the same clients and reach the same parameters.

Then one JSON line lists the kernels, and the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
before that line; so does a machine with no CUDA device, and a directory
that holds this script without the repository's ``src/``.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FP32_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
PEAK_BF16_PER_S = 989e12     # H100 SXM dense bf16 on the tensor cores
# fp32-accurate products on the tensor cores as 3xTF32: three TF32 products
# (495 TFLOP/s dense) for each fp32 one
PEAK_3XTF32_PER_S = 495e12 / 3
# exp and the other special functions: 16 a clock per SM (NVIDIA's Hopper
# SM description) x 132 SMs x the 1.98 GHz boost clock of the SXM part
PEAK_SFU_PER_S = 16 * 132 * 1.98e9
TIMED_CALLS = 30


def _median_ms(fn, calls: int = TIMED_CALLS, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound(n_bytes: float, n_ops: float, peak_ops: float = PEAK_FP32_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _check_hellinger(shape, device):
    """K2 at (B, K, C): kernel vs plain version, and times."""
    import torch

    from repro_torch.kernels.hellinger import hellinger_strip, hellinger_strip_ref

    b, k, c = shape
    g = torch.Generator().manual_seed(b + k + c)

    def panel(n):
        h = torch.rand(n, c, generator=g) * (torch.rand(n, c, generator=g) > 0.3)
        h = h / torch.clamp(h.sum(1, keepdim=True), min=1e-12)
        return torch.sqrt(h).to(device)

    rb, r = panel(b), panel(k)
    got = hellinger_strip(rb, r)
    want = hellinger_strip_ref(rb, r)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = 1e-6
    if not (got.shape == (b, k) and torch.isfinite(got).all() and err <= tol):
        raise AssertionError(f"hellinger_strip {shape}: max |HD - plain| = {err} > {tol}")
    bound_ms, bound_by = _bound(4 * (b * c + k * c + b * k), 2 * b * k * c + 4 * b * k)
    rec = {
        "shape": [b, k, c], "max_abs_err": err, "tolerance": tol,
        "ms": _median_ms(lambda: hellinger_strip(rb, r)),
        "plain_ms": _median_ms(lambda: hellinger_strip_ref(rb, r)),
        "library_ms": _median_ms(lambda: torch.sqrt(torch.clamp(1 - rb @ r.T, 0, 1))),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    print(f"kernel hellinger_strip {json.dumps(rec)}", flush=True)
    return rec


def _check_aggregate(shape, dtype, device):
    """K1 at (M, N) in ``dtype``: kernel vs plain version, and times."""
    import torch

    from repro_torch.kernels.aggregate import masked_weighted_sum, masked_weighted_sum_ref

    m, n = shape
    g = torch.Generator(device=device).manual_seed(m + n)  # drawn on the card: (10, P) is 15 GB
    x = torch.randn(m, n, generator=g, device=device).to(dtype)
    w = torch.rand(m, generator=g, device=device)
    w = w / w.sum()
    got = masked_weighted_sum(x, w)
    want = masked_weighted_sum_ref(x, w)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = 1e-6
    if not (got.shape == (n,) and torch.isfinite(got).all() and err <= tol):
        raise AssertionError(f"masked_weighted_sum {shape} {dtype}: max |err| = {err} > {tol}")
    w_lib = w.to(dtype)
    bound_ms, bound_by = _bound(m * n * x.element_size() + 4 * m + 4 * n, 2 * m * n)
    rec = {
        "shape": [m, n], "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
        "tolerance": tol,
        "ms": _median_ms(lambda: masked_weighted_sum(x, w)),
        "plain_ms": _median_ms(lambda: masked_weighted_sum_ref(x, w)),
        "library_ms": _median_ms(lambda: w_lib @ x),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    print(f"kernel masked_weighted_sum {json.dumps(rec)}", flush=True)
    return rec


def _attention_work(shape, window, is_global, elem):
    """(visible (q, k) pairs, bytes forward, bytes backward) of K3 at
    (B, S, H, KV, D): each input read once, each output written once."""
    b, s, h, kv, d = shape
    if window > 0 and not is_global > 0:
        pairs = sum(min(i + 1, window) for i in range(s))
    else:
        pairs = s * (s + 1) // 2
    q_bytes, kv_bytes, stat = b * s * h * d * elem, b * s * kv * d * elem, 4 * b * h * s
    fwd = q_bytes + 2 * kv_bytes + q_bytes + stat                     # q, k, v -> O, L
    bwd = 3 * q_bytes + 2 * kv_bytes + stat + q_bytes + 2 * kv_bytes  # q, k, v, O, dO, L -> dq, dk, dv
    return b * h * pairs, fwd, bwd


def _check_flash(shape, dtype, window, is_global, device):
    """K3 at (B, S, H, KV, D): forward (O, L) and backward (dq, dk, dv)
    against the plain version and its autograd on the card, and times."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        attention_ref,
        flash_attention_backward,
        flash_attention_forward,
    )

    b, s, h, kv, d = shape
    g = torch.Generator().manual_seed(b * s + h * d + kv)
    q, k, v = (torch.randn(b, s, n, d, generator=g).to(dtype).to(device) for n in (h, kv, kv))
    do = torch.randn(b, s, h, d, generator=g).to(dtype).to(device)
    o, lse = flash_attention_forward(q, k, v, window, is_global)
    dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do, window, is_global)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    o_ref, lse_ref = attention_ref(*leaves, window, is_global)
    grads_ref = torch.autograd.grad(o_ref, leaves, do, retain_graph=True)
    torch.cuda.synchronize()

    # fp32: sums over D and S in another order than the plain version's
    # matrix products; bf16: one rounding of the output to bf16 (8 bits of
    # mantissa) on either side.  Both relative to max(1, max |plain|).
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    errs, limits = {}, {}
    for name, got, want in [("o", o, o_ref), ("lse", lse, lse_ref), ("dq", dq, grads_ref[0]),
                            ("dk", dk, grads_ref[1]), ("dv", dv, grads_ref[2])]:
        if got.shape != want.shape or got.dtype != want.dtype or not torch.isfinite(got).all():
            raise AssertionError(f"flash_attention {shape} {dtype} {name}: bad output "
                                 f"{tuple(got.shape)} {got.dtype}")
        errs[name] = (got.float() - want.float()).abs().max().item()
        limits[name] = tol * max(1.0, want.float().abs().max().item())
    tag = f"{list(shape)} {str(dtype).replace('torch.', '')} window={window} is_global={is_global}"
    if any(errs[n] > limits[n] for n in errs):
        raise AssertionError(f"flash_attention {tag}: max |err| {errs} above {limits}")
    rec = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""), "window": window,
           "is_global": is_global, "errors": errs, "tolerance": tol,
           "forward": {"max_abs_err": max(errs["o"], errs["lse"])},
           "backward": {"max_abs_err": max(errs["dq"], errs["dk"], errs["dv"])}}
    pairs, fwd_bytes, bwd_bytes = _attention_work(shape, window, is_global, q.element_size())
    # K3 multiplies fp32 inputs on the tensor cores as 3xTF32, so the least
    # time the card takes for fp32-accurate attention is set by that rate,
    # not by the 67 TFLOP/s of the CUDA cores
    peak = PEAK_3XTF32_PER_S if dtype == torch.float32 else PEAK_BF16_PER_S
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window > 0 and not is_global > 0:
        pos = torch.arange(s, device=device)
        mask = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < window)
        lib_kw = {"attn_mask": mask}
    else:
        lib_kw = {"is_causal": True}
    if kv != h:
        lib_kw["enable_gqa"] = True
    lib_leaves = [t.detach().requires_grad_(True) for t in (qt, kt, vt)]
    lib_out = F.scaled_dot_product_attention(*lib_leaves, **lib_kw)
    do_t = do.transpose(1, 2)
    fwd_bound = _bound(fwd_bytes, 4 * d * pairs, peak)
    bwd_bound = _bound(bwd_bytes, 10 * d * pairs, peak)
    rec["forward"] |= {
        "ms": _median_ms(lambda: flash_attention_forward(q, k, v, window, is_global)),
        "plain_ms": _median_ms(lambda: attention_ref(q, k, v, window, is_global)),
        "library_ms": _median_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, **lib_kw)),
        "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
    }
    rec["backward"] |= {
        "ms": _median_ms(lambda: flash_attention_backward(q, k, v, o, lse, do, window,
                                                          is_global)),
        "plain_ms": _median_ms(lambda: torch.autograd.grad(o_ref, leaves, do,
                                                           retain_graph=True)),
        "library_ms": _median_ms(lambda: torch.autograd.grad(lib_out, lib_leaves, do_t,
                                                             retain_graph=True)),
        "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
    }
    print(f"kernel flash_attention {json.dumps(rec)}", flush=True)
    return rec


def _mamba_work(shape, groups, elem):
    """(forward bytes, backward bytes, (b, t, d, n) elements) of K4 at
    (B, S, D, N): each input read once, each output written once.  The
    state checkpoints that the forward keeps for the backward are this
    design's choice, not the function's, and are not counted."""
    b, s, d, n = shape
    seq, state = b * s * d * elem, b * s * n * elem
    weights = 4 * groups * d * (n + 1)
    fwd = 2 * seq + 2 * state + weights + seq                              # x, dt, Bm, Cm, w -> y
    bwd = 3 * seq + 2 * state + weights + 2 * seq + 2 * state + weights    # ..., dy -> six grads
    return fwd, bwd, b * s * d * n


def _scan_bound(n_bytes, elements, flops_per_element, exps_per_element):
    """K4's bound: bytes over HBM, against the larger of its fp32 operations
    over the CUDA cores and its exps over the special-function units."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = max(elements * flops_per_element / PEAK_FP32_PER_S,
                elements * exps_per_element / PEAK_SFU_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _check_mamba(shape, groups, dtype, checkpoints, device):
    """K4 at (B, S, D, N) with ``groups`` weight sets (0: shared (D, N)
    weights): forward y, with and without checkpoints, and backward (all
    six gradients) against the plain version and its autograd on the card,
    and times."""
    import torch

    from repro_torch.kernels.mamba_scan import (
        mamba_scan_backward,
        mamba_scan_forward,
        mamba_scan_ref,
    )

    b, s, d, n = shape
    g = torch.Generator().manual_seed(b * s + d + n + groups)
    x = (torch.randn(b, s, d, generator=g) * 0.5).to(dtype).to(device)
    dt = (torch.randn(b, s, d, generator=g) * 0.02 + 0.05).abs().to(dtype).to(device)
    bm, cm = (torch.randn(b, s, n, generator=g).to(dtype).to(device) for _ in range(2))
    wshape = (d, n) if groups == 0 else (groups, d, n)
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32)).expand(*wshape)
    a_log = (a_log + 0.1 * torch.randn(*wshape, generator=g)).to(device)
    d_skip = (1 + 0.1 * torch.randn(*wshape[:-1], generator=g)).to(device)
    dy = torch.randn(b, s, d, generator=g).to(dtype).to(device)
    inputs = (x, dt, bm, cm, a_log, d_skip)
    y, ckpt = mamba_scan_forward(*inputs, checkpoints=True)
    y_no_ckpt = mamba_scan_forward(*inputs)   # as the poll and the evaluations call it
    grads = mamba_scan_backward(*inputs, ckpt, dy)
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    y_ref = mamba_scan_ref(*leaves)
    grads_ref = torch.autograd.grad(y_ref, leaves, dy, retain_graph=True)
    torch.cuda.synchronize()

    # fp32: the kernel sums over N, over channels (dbmat, dcmat) and over rows
    # and steps (da_log, dd_skip) in another order than the plain version, and
    # contracts multiply-adds; bf16: one rounding of y and of the four
    # sequence gradients to 8 bits of mantissa.  Relative to max(1, max |plain|).
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    errs, limits = {}, {}
    names = ("y", "y_no_ckpt", "dx", "ddt", "dbmat", "dcmat", "da_log", "dd_skip")
    for name, got, want in zip(names, (y, y_no_ckpt, *grads), (y_ref, y_ref, *grads_ref)):
        if got.shape != want.shape or got.dtype != want.dtype or not torch.isfinite(got).all():
            raise AssertionError(f"mamba_scan {shape} {dtype} {name}: bad output "
                                 f"{tuple(got.shape)} {got.dtype}")
        errs[name] = (got.float() - want.float()).abs().max().item()
        limits[name] = tol * max(1.0, want.float().abs().max().item())
    tag = f"{list(shape)} groups={groups} {str(dtype).replace('torch.', '')}"
    if any(errs[k] > limits[k] for k in errs):
        raise AssertionError(f"mamba_scan {tag}: max |err| {errs} above {limits}")
    fwd_bytes, bwd_bytes, elements = _mamba_work(shape, max(groups, 1), x.element_size())
    # per (b, t, d, n): forward 1 exp and 5 flops (dt A, the state update and
    # the C contraction); backward at least 1 exp and 16 flops (the state
    # recurrence again, then the reverse one and its six gradient terms)
    fwd_bound = _scan_bound(fwd_bytes, elements, 5, 1)
    bwd_bound = _scan_bound(bwd_bytes, elements, 16, 1)
    plain_calls, plain_warmup = (5, 1) if s > 1024 else (TIMED_CALLS, 3)
    rec = {"shape": list(shape), "groups": groups, "dtype": str(dtype).replace("torch.", ""),
           "checkpoints": checkpoints, "errors": errs, "tolerance": tol,
           "forward": {
               "max_abs_err": max(errs["y"], errs["y_no_ckpt"]),
               "ms": _median_ms(lambda: mamba_scan_forward(*inputs, checkpoints=checkpoints)),
               "plain_ms": _median_ms(lambda: mamba_scan_ref(*inputs), plain_calls, plain_warmup),
               "library_ms": None, "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1]},
           "backward": {
               "max_abs_err": max(errs[k] for k in names[2:]),
               "ms": _median_ms(lambda: mamba_scan_backward(*inputs, ckpt, dy)),
               "plain_ms": _median_ms(lambda: torch.autograd.grad(y_ref, leaves, dy,
                                                                  retain_graph=True),
                                      plain_calls, plain_warmup),
               "library_ms": None, "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1]}}
    print(f"kernel mamba_scan {json.dumps(rec)}", flush=True)
    return rec


def _main_path(device):
    """The paper's experiment at full width, 5 rounds; returns the kernels'
    launch counts from this run alone."""
    import numpy as np
    import torch

    from repro_torch.data import make_classification
    from repro_torch.engine import FLConfig, make_engine
    from repro_torch.kernels.aggregate import masked_weighted_sum
    from repro_torch.kernels.hellinger import hellinger_strip

    t = time.perf_counter()
    train = make_classification(20_000, seed=0)
    test = make_classification(2_000, seed=1)
    print(f"main: data {time.perf_counter() - t:.3f} s  train {train.x.shape} test {test.x.shape}",
          flush=True)
    cfg = FLConfig(n_clients=100, m=10, rounds=5, strategy="fedlecc", strategy_kwargs={"J": 3},
                   partition="shards", target_hd=0.9, batch_size=64, lr=0.005, eval_every=1,
                   hidden=(200, 200), seed=0)

    hellinger_strip.launches = 0
    masked_weighted_sum.launches = 0
    t = time.perf_counter()
    engine = make_engine(cfg, train, test, n_classes=10, device=device)
    torch.cuda.synchronize()
    n_clusters = engine.strategy.n_clusters
    print(f"main: engine setup {time.perf_counter() - t:.3f} s  shards/client={engine.alpha:g}  "
          f"OPTICS clusters={n_clusters}  P={engine.n_params}  max_steps={engine.max_steps}",
          flush=True)
    results = []
    it = engine.rounds()
    while True:
        t = time.perf_counter()
        r = next(it, None)
        if r is None:
            break
        wall = time.perf_counter() - t
        results.append(r)
        print(f"main: round {r.round} selected={list(r.selected)} test_acc={r.test_acc:.4f} "
              f"test_loss={r.test_loss:.4f} train_loss={r.mean_selected_loss:.4f} "
              f"comm={r.comm_mb:.3f} MB wall={wall * 1e3:.2f} ms", flush=True)
    launches = {"hellinger_strip": hellinger_strip.launches,
                "masked_weighted_sum": masked_weighted_sum.launches}
    print(f"main: launches {json.dumps(launches)}", flush=True)

    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if len(results) != cfg.rounds:
        raise AssertionError(f"ran {len(results)} rounds, expected {cfg.rounds}")
    if engine.alpha != 1.0 or n_clusters != 10 or np.bincount(engine.strategy.labels).tolist() != [10] * 10:
        raise AssertionError("paper-scale shards partition should give 10 OPTICS clusters of 10 "
                             f"(got shards={engine.alpha}, clusters={n_clusters})")
    for r in results:
        sel = list(r.selected)
        if len(sel) != cfg.m or sorted(set(sel)) != sel or not 0 <= sel[0] <= sel[-1] < cfg.n_clients:
            raise AssertionError(f"round {r.round}: bad selection {sel}")
        if not (math.isfinite(r.test_loss) and 0.0 <= r.test_acc <= 1.0
                and math.isfinite(r.mean_selected_loss)):
            raise AssertionError(f"round {r.round}: bad metrics {r}")
    if not (engine.params.is_cuda and engine.params.shape == (199_210,)
            and torch.isfinite(engine.params).all()):
        raise AssertionError("final parameters are not a finite (199210,) CUDA tensor")
    return launches


def _agreement(device):
    """Small configuration: CPU (plain versions) vs card (kernels), same draws."""
    import numpy as np

    from repro_torch.data import make_classification
    from repro_torch.engine import FLConfig, make_engine

    train = make_classification(800, n_features=64, n_classes=10, seed=0)
    test = make_classification(200, n_features=64, n_classes=10, seed=1)
    cfg = FLConfig(n_clients=12, m=4, rounds=3, strategy_kwargs={"J": 3}, hidden=(16,),
                   eval_samples=16, eval_every=1, target_hd=0.8, seed=0)
    on_card = make_engine(cfg, train, test, 10, device=device)
    on_cpu = make_engine(cfg, train, test, 10, device="cpu")
    sel_card = [r.selected for r in on_card.rounds()]
    sel_cpu = [r.selected for r in on_cpu.rounds()]
    diff = float(np.abs(on_card.params.cpu().numpy() - on_cpu.params.numpy()).max())
    print(f"agreement: selected card={sel_card} cpu={sel_cpu} max |params diff|={diff:.3g} "
          f"(tolerance 1e-4)", flush=True)
    if sel_card != sel_cpu or not np.array_equal(on_card.strategy.labels, on_cpu.strategy.labels):
        raise AssertionError("card and CPU runs selected different clients")
    if not diff <= 1e-4:
        raise AssertionError(f"card and CPU parameters differ by {diff} > 1e-4")


LM_MICRO = {"model": "stablelm-3b", "hist_bins": 16,
            "overrides": {"d_model": 32, "n_heads": 2, "n_kv_heads": 2, "head_dim": 16,
                          "d_ff": 64, "vocab": 32, "loss_chunk": 16, "attn_chunk": 16,
                          "remat": False}}
# hymba at micro width; its pattern "GL" makes layer 1 windowed at S = 16
HYMBA_MICRO = {"model": "hymba-1.5b", "hist_bins": 16,
               "overrides": {"d_model": 32, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
                             "d_ff": 64, "vocab": 32, "loss_chunk": 16, "attn_chunk": 16,
                             "remat": False, "sliding_window": 8}}

def _profiled(on: bool):
    """``torch.profiler`` over CPU and CUDA activity when ``on``."""
    import contextlib

    import torch

    if not on:
        return contextlib.nullcontext()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def _print_profile(prof, wall_s: float, tag: str, families) -> None:
    """Device time of one profiled round by kernel: the busy and idle shares
    of the round's wall time, each kernel family's share, the top kernels.
    Fails if a family's kernels launched but the profile holds none of them."""
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total_us = sum(e.self_device_time_total for e in events)
    if total_us <= 0:
        print(f"{tag} profile: the profiler recorded no device time", flush=True)
        return
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    summary = {"wall_ms": wall_s * 1e3, "device_busy_ms": total_us / 1e3,
               "device_idle_share": max(0.0, 1 - total_us / 1e3 / (wall_s * 1e3))}
    for fwd, _, names in families:
        fam_us = sum(e.self_device_time_total for e in events if names.search(e.key))
        if fam_us <= 0:
            raise AssertionError(f"{tag} profile: no kernel matches {names.pattern}")
        fam = fwd.__name__.removesuffix("_forward")
        summary[f"{fam}_kernels_ms"] = fam_us / 1e3
        summary[f"{fam}_share_of_busy"] = fam_us / total_us
    summary["top"] = [{"kernel": e.key[:90], "ms": e.self_device_time_total / 1e3,
                       "calls": e.count} for e in top]
    print(f"{tag} profile: {json.dumps(summary)}", flush=True)


def _lm_main_path(device, tag, model, n_layers, n_params, families):
    """Federated LM training on ``model`` at full width, cut to ``n_layers``,
    3 rounds (the last under the profiler); returns the kernels' launch
    counts from this run.  ``families`` holds one (forward wrapper, backward
    wrapper, profile-name regex) for each kernel that the model runs in
    every layer: each launches forward layers x rounds x (poll + steps + 2
    evaluations) times and backward layers x rounds x steps times."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import make_token_stream
    from repro_torch.engine import FLConfig, make_engine
    from repro_torch.kernels.aggregate import masked_weighted_sum
    from repro_torch.kernels.hellinger import hellinger_strip

    counters = [hellinger_strip, masked_weighted_sum] + [w for fam in families for w in fam[:2]]
    full = get_config(model)
    vocab, seq = full.vocab, 64
    t = time.perf_counter()
    train = make_token_stream(2400, seq, vocab, seed=0)
    test = make_token_stream(64, seq, vocab, seed=1)
    print(f"{tag}: data {time.perf_counter() - t:.3f} s  train {train.x.shape} "
          f"test {test.x.shape} vocab {vocab}", flush=True)
    cfg = FLConfig(task="lm", task_kwargs={"model": model, "reduced": False,
                                           "overrides": {"n_layers": n_layers}, "hist_bins": 64},
                   n_clients=100, m=10, strategy="fedlecc", strategy_kwargs={"J": 3},
                   batch_size=8, eval_samples=4, eval_every=1, target_hd=0.9, rounds=3, seed=0)
    mamba = (f", Mamba heads with N {full.ssm.d_state} and conv {full.ssm.conv_kernel}"
             if full.block_type == "hymba" else "")
    window = (f"; at S = {seq} the {full.sliding_window}-token window never bites (the kernel "
              "phase runs it at S = 2048)" if full.sliding_window >= seq else "")
    print(f"{tag}: {model} at full width (d_model {full.d_model}, {full.n_heads} query heads of "
          f"{full.resolved_head_dim} on {full.n_kv_heads} kv heads, {full.mlp_activation} d_ff "
          f"{full.d_ff}{mamba}, vocab {vocab}); cut: n_layers {full.n_layers} -> {n_layers}, "
          f"which one card's memory forces for the (10, P) cohort and its gradient{window}",
          flush=True)

    for c in counters:
        c.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    engine = make_engine(cfg, train, test, n_classes=vocab, device=device)
    torch.cuda.synchronize()
    mc = engine.task.model_cfg
    print(f"{tag}: engine setup {time.perf_counter() - t:.3f} s  shards/client={engine.alpha:g}  "
          f"OPTICS clusters={engine.strategy.n_clusters}  P={engine.n_params}  "
          f"max_steps={engine.max_steps}  peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    results = []
    it = engine.rounds()
    for rnd in range(cfg.rounds):
        torch.cuda.reset_peak_memory_stats()
        last = rnd == cfg.rounds - 1
        with _profiled(last) as prof:
            t = time.perf_counter()
            r = next(it)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        results.append(r)
        print(f"{tag}: round {r.round} selected={list(r.selected)} test_loss={r.test_loss:.4f} "
              f"next_token_acc={r.test_acc:.4f} ppl={r.metrics['ppl']:.2f} "
              f"train_loss={r.mean_selected_loss:.4f} comm={r.comm_mb:.1f} MB "
              f"wall={wall:.3f} s{' (under the profiler)' if last else ''} "
              f"peak={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
        if last:
            _print_profile(prof, wall, tag, families)
    launches = {c.__name__: c.launches for c in counters}
    print(f"{tag}: launches {json.dumps(launches)}", flush=True)

    want = (mc.n_layers * cfg.rounds * (1 + engine.max_steps + 2),  # poll, steps, eval x 2
            mc.n_layers * cfg.rounds * engine.max_steps)
    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the {tag} path never launched: {launches}")
    for fwd, bwd, _ in families:
        got = (fwd.launches, bwd.launches)
        if got != want:
            raise AssertionError(f"{fwd.__name__}/{bwd.__name__} launches {got}; expected "
                                 f"forward {want[0]} (layers x rounds x (poll + steps + 2 "
                                 f"evaluations)) and backward {want[1]} (layers x rounds x steps)")
    if len(results) != cfg.rounds or engine.n_params != n_params or mc.n_layers != n_layers:
        raise AssertionError(f"ran {len(results)} rounds with P={engine.n_params}, "
                             f"{mc.n_layers} layers")
    for r in results:
        sel = list(r.selected)
        if len(sel) != cfg.m or sorted(set(sel)) != sel or not 0 <= sel[0] <= sel[-1] < cfg.n_clients:
            raise AssertionError(f"round {r.round}: bad selection {sel}")
        ppl = r.metrics["ppl"]
        if not (math.isfinite(r.test_loss) and 0.0 <= r.test_acc <= 1.0 and math.isfinite(ppl)
                and ppl > 1.0 and math.isfinite(r.mean_selected_loss)):
            raise AssertionError(f"round {r.round}: bad metrics {r}")
        if not abs(math.log(ppl) - np.float32(r.test_loss)) < 1e-3:  # ppl = exp(mean NLL)
            raise AssertionError(f"round {r.round}: ppl {ppl} is not exp(test_loss {r.test_loss})")
    if not (engine.params.is_cuda and torch.isfinite(engine.params).all()):
        raise AssertionError(f"final {tag} parameters are not a finite CUDA tensor")
    del engine, it
    torch.cuda.empty_cache()
    return launches


def _lm_agreement(device, tag, task_kwargs):
    """An LM micro configuration on the CPU (plain versions) and on the card
    (kernels) from the same draws."""
    import numpy as np

    from repro_torch.data import make_token_stream
    from repro_torch.engine import FLConfig, make_engine

    train = make_token_stream(48, 16, 32, seed=0)
    test = make_token_stream(16, 16, 32, seed=1)
    cfg = FLConfig(task="lm", task_kwargs=task_kwargs, n_clients=8, m=3, rounds=2,
                   strategy_kwargs={"J": 2}, batch_size=4, eval_samples=4, eval_every=1,
                   target_hd=0.8, max_steps_cap=3, seed=0)
    on_card = make_engine(cfg, train, test, 32, device=device)
    on_cpu = make_engine(cfg, train, test, 32, device="cpu")
    res_card, res_cpu = list(on_card.rounds()), list(on_cpu.rounds())
    sel_card, sel_cpu = [r.selected for r in res_card], [r.selected for r in res_cpu]
    diff = float(np.abs(on_card.params.cpu().numpy() - on_cpu.params.numpy()).max())
    ppl_diff = max(abs(a.metrics["ppl"] - b.metrics["ppl"]) for a, b in zip(res_card, res_cpu))
    print(f"{tag} agreement: selected card={sel_card} cpu={sel_cpu} max |params diff|={diff:.3g} "
          f"max |ppl diff|={ppl_diff:.3g} (tolerance 1e-4)", flush=True)
    if sel_card != sel_cpu:
        raise AssertionError(f"{tag}: card and CPU runs selected different clients")
    if not (diff <= 1e-4 and ppl_diff <= 1e-4):
        raise AssertionError(f"{tag}: card and CPU differ by {diff} (params), {ppl_diff} (ppl) "
                             "> 1e-4")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import pin_fp32_matmul
    from repro_torch.kernels import build

    # 1. device
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    pin_fp32_matmul()
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}  torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"count {torch.cuda.device_count()}", flush=True)

    # 2. build
    t = time.perf_counter()
    libs = build.build()
    print(f"build: {time.perf_counter() - t:.2f} s for {len(libs)} sources "
          f"({', '.join(sorted(libs))}) into {build.BUILD_DIR.relative_to(ROOT)}", flush=True)

    # 3. kernels against their plain versions
    k2 = [_check_hellinger(s, device) for s in [(100, 100, 10), (100, 100, 64), (4096, 16384, 10)]]
    k1 = [_check_aggregate(s, dt, device)
          for s, dt in [((10, 199_210), torch.float32), ((10, 380_789_760), torch.float32),
                        ((64, 199_210), torch.bfloat16)]]
    k3 = [_check_flash(s, dt, w, ig, device) for s, dt, w, ig in [
        ((80, 64, 32, 32, 80), torch.float32, 0, 1.0),     # local SGD: m x batch sequences
        ((80, 64, 32, 32, 80), torch.bfloat16, 0, 1.0),
        ((400, 64, 32, 32, 80), torch.float32, 0, 1.0),    # the poll: K x eval_samples
        ((4, 2048, 32, 32, 80), torch.float32, 0, 1.0),
        ((4, 2048, 32, 32, 80), torch.bfloat16, 0, 1.0),
        ((2, 1024, 8, 2, 128), torch.float32, 256, 0.0),   # GQA, sliding window
        ((80, 64, 25, 5, 64), torch.float32, 1024, 0.0),   # hymba's local SGD (GQA group 5)
        ((4, 2048, 25, 5, 64), torch.float32, 1024, 0.0),  # hymba's window where it bites
    ]]
    k4 = [_check_mamba(s, g, dt, ck, device) for s, g, dt, ck in [
        ((80, 64, 1600, 16), 10, torch.float32, True),     # hymba's local SGD: 10 clients
        ((400, 64, 1600, 16), 0, torch.float32, False),    # the poll: shared weights
        ((4, 2048, 1600, 16), 0, torch.float32, True),
        ((4, 2048, 1600, 16), 0, torch.bfloat16, True),
        ((3, 100, 130, 16), 0, torch.float32, True),       # ragged D and S
    ]]
    print("kernels: hellinger_strip, masked_weighted_sum, flash_attention and mamba_scan "
          "(forward and backward) passed at every shape above", flush=True)
    torch.cuda.empty_cache()

    # 4. main paths: the paper's classification experiment, then LM training
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward,
        flash_attention_forward,
    )
    from repro_torch.kernels.mamba_scan import mamba_scan_backward, mamba_scan_forward

    # K3's forward, dQ and dK/dV kernels; K4's scan kernels and the second
    # pass of its backward (a word boundary keeps scan_fwd_kernel out of K3)
    attention = (flash_attention_forward, flash_attention_backward,
                 re.compile(r"\b(?:fwd|dq|dkdv)_kernel\b"))
    scan = (mamba_scan_forward, mamba_scan_backward,
            re.compile(r"\b(?:scan_fwd|scan_bwd|reduce_bc|reduce_params)_kernel\b"))
    launches = _main_path(device)
    lm_launches = _lm_main_path(device, "lm", "stablelm-3b", 2, 380_789_760, (attention,))
    hymba_launches = _lm_main_path(device, "hymba", "hymba-1.5b", 6, 344_430_400,
                                   (attention, scan))

    # 5. small-input agreement with the CPU path
    _agreement(device)
    _lm_agreement(device, "lm", LM_MICRO)
    _lm_agreement(device, "hymba", HYMBA_MICRO)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        {"name": "hellinger_strip", "route": "cuda",
         "source": "src/repro_torch/csrc/hellinger_strip.cu",
         "replaces": "src/repro/kernels/hellinger/kernel.py:38",
         "launches": launches["hellinger_strip"], "shape": k2[0]["shape"],
         **{k: k2[0][k] for k in keys}},
        {"name": "masked_weighted_sum", "route": "cuda",
         "source": "src/repro_torch/csrc/fedavg_reduce.cu",
         "replaces": "src/repro/kernels/aggregate/kernel.py:29",
         "launches": launches["masked_weighted_sum"], "shape": k1[0]["shape"],
         **{k: k1[0][k] for k in keys}},
    ] + [
        {"name": f"flash_attention_{direction}", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:68",
         "launches": lm_launches[f"flash_attention_{direction}"], "shape": k3[0]["shape"],
         **{k: k3[0][direction][k] for k in keys}}
        for direction in ("forward", "backward")
    ] + [
        {"name": f"mamba_scan_{direction}", "route": "cuda",
         "source": "src/repro_torch/csrc/mamba_scan.cu",
         "replaces": "src/repro/kernels/mamba_scan/kernel.py:69",
         "launches": hymba_launches[f"mamba_scan_{direction}"], "shape": k4[0]["shape"],
         **{k: k4[0][direction][k] for k in keys}}
        for direction in ("forward", "backward")
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
