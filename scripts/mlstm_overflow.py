#!/usr/bin/env python
"""Where the xlstm-125m async run's NaN came from, read from both packages.

``chip_smoke.py``'s ``xlstm async:`` leg (xlstm-125m at full width and
depth, 100 clients, m = 10, mobile_mix + markov, buffer 5, seed 0) reaches
a local step whose layer-0 mLSTM running max m lies below -log(FLT_MAX)
for one client: exp(-m) overflows to inf, and the gradient of the
normaliser max(|n|, exp(-m)) is 0 x inf = NaN in the reference.

``--dump OUT.npz`` (on a CUDA card; the port only) runs that leg and, at
the first training forward where an mLSTM layer's exp(-m) overflows,
saves the offending client's core input (batch, S, d) and that layer's
parameters, with the dispatch, the client and the smallest m, then stops.
``--check OUT.npz`` (on the CPU; imports both packages) runs the saved
layer through the reference's ``mlstm_seq`` and the port's, and prints
one JSON line: the positions that overflow, the input-gate logits' range,
the largest output difference, the NaN entries of each gradient leaf for
the reference, the port, and the port with the guard taken out
(``_exp_floor`` replaced by ``exp(-m)``, the reference's expression), and
the backward function where the latter first gives NaN
(``torch.autograd.detect_anomaly``).

    PYTHONPATH=src python3 scripts/mlstm_overflow.py --dump build/mlstm_overflow.npz
    PYTHONPATH=src python scripts/mlstm_overflow.py --check build/mlstm_overflow.npz
"""

from __future__ import annotations

import argparse
import json
import warnings

import numpy as np

MODEL = "xlstm-125m"


class _Found(Exception):
    """The first overflowing training forward was saved."""


def _leg_config():
    from repro_torch.engine import FLConfig

    systems = dict(profile="mobile_mix", availability="markov",
                   availability_kwargs={"p_drop": 0.1, "p_join": 0.5}, jitter_sigma=0.2,
                   deadline_s=None, over_select=1.0)
    async_mode = dict(staleness="polynomial", staleness_kwargs={"a": 0.5}, concurrency=20,
                      buffer_k=5)
    return FLConfig(task="lm", task_kwargs={"model": MODEL, "reduced": False,
                                            "overrides": {"n_layers": 12}, "hist_bins": 64},
                    n_clients=100, m=10, strategy="fedlecc", strategy_kwargs={"J": 3},
                    batch_size=8, eval_samples=4, eval_every=1, target_hd=0.9, rounds=4, seed=0,
                    systems=systems, async_mode=async_mode)


def dump(out: str) -> None:
    import torch

    import repro_torch.engine.host as host
    from repro_torch.configs import get_config
    from repro_torch.data import make_token_stream
    from repro_torch.device import pin_fp32_matmul
    from repro_torch.engine import make_engine
    from repro_torch.kernels import build
    from repro_torch.models import ssm

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    pin_fp32_matmul()
    build.build(("hellinger_strip", "fedavg_reduce"))
    vocab = get_config(MODEL).vocab
    train = make_token_stream(2400, 64, vocab, seed=0)
    test = make_token_stream(64, 64, vocab, seed=1)
    where = {}
    train_cohort, mlstm = host.HostEngine.local_train, ssm.mlstm_seq

    def local_train(self, d, sel):
        where.update(dispatch=int(d), cohort=[int(c) for c in sel])
        return train_cohort(self, d, sel)

    def watched(p, cfg, x):
        if x.requires_grad and x.ndim == 4:  # a cohort's training forward
            with torch.no_grad():
                _, _, _, i_log, f_log, _ = ssm._xlstm_proj(p, cfg, x)
                if x.shape[-2] > cfg.ssm.chunk:
                    raise ValueError("the running max below assumes one chunk")
                big_f = torch.cumsum(f_log, dim=-2)
                m = (big_f + torch.cummax(i_log - big_f, dim=-2).values).flatten(1)
                over = torch.isinf(torch.exp(-m)).any(1)
            if over.any():
                row = int(torch.nonzero(over)[0])
                arrays = {"x": x[row].detach()} | {f"p_{k}": v[row].detach() for k, v in p.items()}
                np.savez(out, **{k: v.cpu().numpy() for k, v in arrays.items()},
                         meta=json.dumps({**where, "row": row, "client": where["cohort"][row],
                                          "min_m": float(m[row].min()),
                                          "overflowing": int(torch.isinf(torch.exp(-m[row]))
                                                             .sum())}))
                raise _Found
        return mlstm(p, cfg, x)

    host.HostEngine.local_train, ssm.mlstm_seq = local_train, watched
    engine = make_engine(_leg_config(), train, test, n_classes=vocab, device=device)
    try:
        for r in engine.rounds():
            print(f"step {r.round} version {r.params_version} test_loss {r.test_loss:.4f}",
                  flush=True)
        print("no mLSTM exp(-m) overflowed in a training forward")
    except _Found:
        print(json.dumps(json.loads(str(np.load(out)["meta"]))), flush=True)


def check(path: str) -> None:
    import jax
    import jax.numpy as jnp
    import torch

    from repro.configs import get_config as ref_get_config
    from repro.models import ssm as ref_ssm
    from repro_torch.configs import get_config
    from repro_torch.models import ssm

    data = np.load(path)
    meta = json.loads(str(data["meta"]))
    x = data["x"]
    params = {k[2:]: data[k] for k in data.files if k.startswith("p_")}
    dy = np.random.default_rng(0).normal(0, 1, x.shape).astype(np.float32)
    ref_cfg, cfg = ref_get_config(MODEL), get_config(MODEL)

    _, _, _, i_log, f_log, _ = ref_ssm._xlstm_proj(params, ref_cfg, jnp.asarray(x))
    big_f = jnp.cumsum(f_log, axis=1)
    m = np.asarray(big_f + jax.lax.cummax(i_log - big_f, axis=1))
    out, vjp = jax.vjp(lambda p, xx: ref_ssm.mlstm_seq(p, ref_cfg, xx)[0], params,
                       jnp.asarray(x))
    ref_dp, ref_dx = vjp(jnp.asarray(dy))
    ref_grads = {"x": np.asarray(ref_dx)} | {k: np.asarray(v) for k, v in ref_dp.items()}

    def port(floor=None):
        saved = ssm._exp_floor
        if floor is not None:
            ssm._exp_floor = floor
        try:
            p = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
            xt = torch.from_numpy(x).requires_grad_(True)
            y = ssm.mlstm_seq(p, cfg, xt)[0]
            names = list(p)
            grads = torch.autograd.grad(y, [xt] + [p[k] for k in names], torch.from_numpy(dy))
        finally:
            ssm._exp_floor = saved
        return y.detach().numpy(), dict(zip(["x"] + names, (g.numpy() for g in grads)))

    got, grads = port()
    unguarded_floor = lambda mm: torch.exp(-mm)  # noqa: E731
    _, unguarded = port(unguarded_floor)
    try:  # the backward function that first returns NaN without the guard
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # detect_anomaly's notice that it is on
            with torch.autograd.detect_anomaly(check_nan=True):
                port(unguarded_floor)
        first_nan = None
    except RuntimeError as e:
        first_nan = str(e).split("'")[1] if "'" in str(e) else str(e)
    nans = lambda g: {k: int(np.isnan(v).sum()) for k, v in g.items()}  # noqa: E731
    finite = [k for k in grads if np.isfinite(ref_grads[k]).all()]
    with np.errstate(over="ignore"):
        overflowing = int(np.isinf(np.exp(-m)).sum())
    print(json.dumps({
        **meta, "positions": int(m.size), "overflowing": overflowing, "min_m": float(m.min()),
        "input_gate_logits": [float(np.min(i_log)), float(np.max(i_log))],
        "unguarded_first_nan_in": first_nan,
        "output_max_abs_diff": float(np.abs(got - np.asarray(out)).max()),
        "output_max_abs": float(np.abs(np.asarray(out)).max()),
        "reference_nan": nans(ref_grads), "port_nan": nans(grads),
        "port_unguarded_nan": nans(unguarded),
        "max_abs_diff_where_reference_finite": {
            k: float(np.abs(grads[k] - ref_grads[k]).max()) for k in finite},
        "reference_max_abs": {k: float(np.abs(ref_grads[k]).max()) for k in finite}}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--dump", metavar="OUT.npz")
    mode.add_argument("--check", metavar="IN.npz")
    args = ap.parse_args()
    dump(args.dump) if args.dump else check(args.check)


if __name__ == "__main__":
    main()
