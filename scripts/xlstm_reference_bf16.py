#!/usr/bin/env python
"""How far xlstm-125m's own bf16 logits depart from its fp32 ones, in the
JAX package (the reference) and in the port, on the same weights: the
scale of bf16 rounding in this model, against which ``chip_smoke.py``'s
serve grid holds xlstm-125m's bf16 logits (``SERVE_GRID_BF16_TOL``).

xlstm-125m is cut to 4 layers at full width; the reference's
``init_transformer`` weights (fp32, and the same values cast to bf16 where
the model keeps a leaf in bf16) go to the port through
``convert.serving_params_from_jax``.  Each side's ``prefill`` runs 8
prompts of 128 tokens (numpy seed 7) in fp32 and in bf16; the script
prints the largest difference of the last position's logits, relative to
max(1, |logits|), for the reference's bf16 against its fp32, the port's
against its own, the port's bf16 against the reference's bf16, and fp32
against fp32.  It also rounds one place of the port's fp32 blocks to bf16
at a time (q, k and v; the gate logits; the out gate; the core's output;
the block's output) and prints how far each moves the logits.  About a
minute on a CPU; it imports JAX.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/xlstm_reference_bf16.py
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.models import transformer as ref_tf
from repro_torch.configs import get_config
from repro_torch.convert import serving_params_from_jax
from repro_torch.models import ssm
from repro_torch.models import transformer as tf

B, S, LAYERS = 8, 128, 4


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


def main() -> None:
    torch.set_num_threads(8)
    toks = np.random.default_rng(7).integers(0, 1000, (B, S)).astype(np.int32)
    logits, port32 = {}, None
    for dtype in ("float32", "bfloat16"):
        ref_cfg = dataclasses.replace(ref_get_config("xlstm-125m"), n_layers=LAYERS, dtype=dtype)
        cfg = dataclasses.replace(get_config("xlstm-125m"), n_layers=LAYERS, dtype=dtype)
        ref_p = ref_tf.init_transformer(jax.random.PRNGKey(0), ref_cfg)
        if dtype == "float32":
            ref32 = ref_p
        else:   # the fp32 run's values in each leaf's type
            ref_p = jax.tree.map(lambda a, b: b.astype(a.dtype), ref_p, ref32)
        want, _ = ref_tf.prefill(ref_p, ref_cfg, {"tokens": jnp.asarray(toks)}, max_len=S + 4)
        p = serving_params_from_jax(jax.tree.map(np.asarray, ref_p), cfg)
        got, _ = tf.prefill(p, cfg, {"tokens": torch.from_numpy(toks)}, S + 4)
        logits["reference", dtype] = np.asarray(want, np.float32)
        logits["port", dtype] = got.float().numpy()
        if dtype == "float32":
            port32 = (p, cfg)
    for a, b in ((("reference", "bfloat16"), ("reference", "float32")),
                 (("port", "bfloat16"), ("port", "float32")),
                 (("port", "bfloat16"), ("reference", "bfloat16")),
                 (("port", "float32"), ("reference", "float32"))):
        print(f"{' '.join(a)} against {' '.join(b)}: {_rel(logits[a], logits[b]):.4g}",
              flush=True)

    p, cfg = port32
    base = logits["port", "float32"]
    proj, out = ssm._xlstm_proj, ssm._xlstm_out

    def rb(t):
        return t.to(torch.bfloat16).to(t.dtype)

    def rounded(which):
        def new_proj(*a, **k):
            q, kk, v, i, f, g = proj(*a, **k)
            if which == "q, k, v":
                q, kk, v = rb(q), rb(kk), rb(v)
            if which == "gate logits":
                i, f = rb(i), rb(f)
            if which == "out gate":
                g = rb(g)
            return q, kk, v, i, f, g

        def new_out(p_, cfg_, x, y, g, tp=None):
            if which == "core output":
                y = rb(y)
            o = out(p_, cfg_, x, y, g, tp)
            return rb(o) if which == "block output" else o

        return new_proj, new_out

    for which in ("q, k, v", "gate logits", "out gate", "core output", "block output"):
        ssm._xlstm_proj, ssm._xlstm_out = rounded(which)
        try:
            got, _ = tf.prefill(p, cfg, {"tokens": torch.from_numpy(toks)}, S + 4)
        finally:
            ssm._xlstm_proj, ssm._xlstm_out = proj, out
        print(f"the port in fp32 with only its {which} rounded to bf16, against fp32: "
              f"{_rel(got.numpy(), base):.4g}", flush=True)


if __name__ == "__main__":
    main()
