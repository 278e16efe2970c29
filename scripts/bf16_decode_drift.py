#!/usr/bin/env python
"""How far a bf16 decode step drifts from the full forward at the same
position, in the reference and in the port: the reason ``chip_smoke.py``
holds decode(prefill(x[:-1]), x[-1]) ≡ forward(x) to the reference's 2e-2
x (max |logit| + 1) in fp32 at full size and reports the bf16 drift
beside it.

For a registered model at full width, cut to each of ``--layers`` and to
``--vocab`` tokens, both packages build the same weights (the
reference's ``init_transformer``, carried over by
``serving_params_from_jax``) in fp32 and in bf16 and run, on 4 random
prompts of ``--seq`` tokens, the forward over all of them and the
prefill of all but the last followed by one decode step.  Each line
prints, relative to max |logit| + 1 of the reference's forward: the
port's decode against its forward, the reference's decode against its
forward, and the port's forward against the reference's.  On the CPU;
xlstm-125m at 4, 8 and 12 layers takes about two minutes.

    PYTHONPATH=src python scripts/bf16_decode_drift.py --model xlstm-125m --layers 4 8 12
"""

from __future__ import annotations

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.models import transformer as ref_tf
from repro_torch.configs import get_config
from repro_torch.convert import serving_params_from_jax
from repro_torch.models import transformer as tf


def _drift(model: str, layers: int, vocab: int, seq: int, dtype: str) -> dict[str, float]:
    kw = {"n_layers": layers, "vocab": vocab, "dtype": dtype}
    ref_cfg = dataclasses.replace(ref_get_config(model), **kw)
    cfg = dataclasses.replace(get_config(model), **kw)
    ref_p = ref_tf.init_transformer(jax.random.PRNGKey(0), ref_cfg)
    p = serving_params_from_jax(jax.tree.map(np.asarray, ref_p), cfg)
    x = np.random.default_rng(0).integers(0, vocab, (4, seq)).astype(np.int32)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        full = tf._logits(p, cfg, tf.forward(p, cfg, xt)[:, -1]).float().numpy()
        _, cache = tf.prefill(p, cfg, {"tokens": xt[:, :-1]}, seq + 4)
        dec = tf.decode_step(p, cfg, {"token": xt[:, -1:]}, cache, seq - 1)[0].float().numpy()
    h, *_ = ref_tf.forward(ref_p, ref_cfg, {"tokens": jnp.asarray(x)})
    ref_full = np.asarray(ref_tf._logits(ref_p, ref_cfg, h[:, -1]), np.float32)
    _, ref_cache = ref_tf.prefill(ref_p, ref_cfg, {"tokens": jnp.asarray(x[:, :-1])},
                                  max_len=seq + 4)
    ref_dec, _ = ref_tf.decode_step(ref_p, ref_cfg, {"token": jnp.asarray(x[:, -1:])},
                                    ref_cache, jnp.int32(seq - 1))
    ref_dec = np.asarray(ref_dec, np.float32)
    scale = float(np.abs(ref_full).max()) + 1.0
    return {"port decode vs forward": float(np.abs(dec - full).max()) / scale,
            "reference decode vs forward": float(np.abs(ref_dec - ref_full).max()) / scale,
            "port forward vs reference": float(np.abs(full - ref_full).max()) / scale}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="xlstm-125m")
    ap.add_argument("--layers", type=int, nargs="+", default=[4, 8, 12])
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--seq", type=int, default=128)
    args = ap.parse_args()
    for layers in args.layers:
        for dtype in ("float32", "bfloat16"):
            d = _drift(args.model, layers, args.vocab, args.seq, dtype)
            print(f"{args.model} {layers} layers vocab {args.vocab} S {args.seq} {dtype}: "
                  + ", ".join(f"{k} {v:.3g}" for k, v in d.items())
                  + " (of max |logit| + 1; the contract's tolerance 2e-2)", flush=True)


if __name__ == "__main__":
    main()
