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
   call computing the same function (median over 30 calls, CUDA events).
4. main path — the paper's experiment at full width (K = 100 clients,
   m = 10, MLP 784-200-200-10, shards partition at target HD 0.9, FedLECC
   with J = 3, batch 64, lr 0.005) for 5 rounds through
   ``make_engine(...).rounds()``, with every kernel's launch count read
   from this run alone.
5. agreement — a small configuration run on the CPU (plain versions) and
   on the card (kernels) from the same draws must select the same clients
   and reach the same parameters.

Then one JSON line lists the kernels, and the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
before that line; so does a machine with no CUDA device, and a directory
that holds this script without the repository's ``src/``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FP32_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
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


def _bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_FP32_PER_S
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
    g = torch.Generator().manual_seed(m + n)
    x = torch.randn(m, n, generator=g).to(dtype).to(device)
    w = torch.rand(m, generator=g)
    w = (w / w.sum()).to(device)
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
    k2 = [_check_hellinger(s, device) for s in [(100, 100, 10), (4096, 16384, 10)]]
    k1 = [_check_aggregate(s, dt, device)
          for s, dt in [((10, 199_210), torch.float32), ((64, 199_210), torch.bfloat16)]]
    print("kernels: hellinger_strip passed at (100,100,10) and (4096,16384,10); "
          "masked_weighted_sum passed at (10,199210) fp32 and (64,199210) bf16", flush=True)

    # 4. main path
    launches = _main_path(device)

    # 5. small-input agreement with the CPU path
    _agreement(device)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    kernels = [
        {"name": "hellinger_strip", "route": "cuda",
         "source": "src/repro_torch/csrc/hellinger_strip.cu",
         "replaces": "src/repro/kernels/hellinger/kernel.py:38",
         "launches": launches["hellinger_strip"], **{k: k2[0][k] for k in keys}},
        {"name": "masked_weighted_sum", "route": "cuda",
         "source": "src/repro_torch/csrc/fedavg_reduce.cu",
         "replaces": "src/repro/kernels/aggregate/kernel.py:29",
         "launches": launches["masked_weighted_sum"], **{k: k1[0][k] for k in keys}},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
