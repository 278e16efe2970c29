"""Serving entry point, ported from ``repro.launch.serve``: batched prefill
and greedy decode for any registered arch, on the card unless ``--device
cpu`` is given (there is no fallback: without a card the default raises).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b --reduced \\
      --batch 4 --prompt-len 64 --gen 32 [--device cpu]

The prompt is ``dummy_batch``'s: tokens, frames (musicgen-large, whose
decode feeds back the embedding of the sampled code as the next frame)
or image patches followed by tokens (internvl2-1b, where ``--prompt-len``
counts the patches, as in the reference, and must exceed them).  The
model runs in its config's dtype: bf16 at full size, fp32 for a
``--reduced`` config, as in the reference.  ``--ckpt`` restores the
parameter tree from a file in the port's own checkpoint format
(``repro_torch.checkpoint.save_checkpoint`` of an ``init_params`` tree);
the port does not read the reference's checkpoints.  Times are host-clock
seconds around work that ends in a device synchronisation.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import get_config
from repro_torch.configs.inputs import dummy_batch
from repro_torch.device import pin_fp32_matmul, resolve_device
from repro_torch.models.transformer import decode_step, init_params, prefill

__all__ = ["main", "run"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(argv: list[str] | None = None) -> tuple[torch.Tensor, dict]:
    """``main``'s work: returns the generated tokens (B, gen) on the CPU
    and the run's figures ({"prefill_s", "decode_s", "decode_steps",
    "prompt_len", "batch", "n_params", "param_bytes"})."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    pin_fp32_matmul()
    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.input_mode == "vlm" and args.prompt_len <= cfg.n_patches:
        raise ValueError(f"{cfg.name}'s prompt holds its {cfg.n_patches} image patches and at "
                         f"least one token; --prompt-len {args.prompt_len} is too short")
    params = init_params(torch.Generator(device).manual_seed(args.seed), cfg)
    if args.ckpt:
        params, meta = load_checkpoint(args.ckpt, params)
        print(f"restored checkpoint ({meta})")

    max_len = args.prompt_len + args.gen
    batch = dummy_batch(cfg, args.batch, args.prompt_len, seed=args.seed)
    batch = {k: v.to(device) for k, v in batch.items() if k != "labels"}

    t0 = time.time()
    logits, cache = prefill(params, cfg, batch, max_len=max_len)
    _sync(device)
    t_prefill = time.time() - t0
    print(f"prefill {args.batch}×{args.prompt_len}: {t_prefill:.2f}s")

    tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    out_tokens = [tok]
    t0 = time.time()
    for i in range(args.gen - 1):
        if cfg.input_mode == "frames":
            # audio decode feeds the embedding of the sampled code
            step = {"frame": params["embed"][tok[:, 0].long()][:, None, :]}
        else:
            step = {"token": tok}
        logits, cache = decode_step(params, cfg, step, cache, args.prompt_len + i)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        out_tokens.append(tok)
    gen = torch.cat(out_tokens, dim=1).cpu()
    dt = time.time() - t0
    print(f"decoded {args.gen} tokens × {args.batch} seqs in {dt:.2f}s "
          f"({args.gen*args.batch/max(dt,1e-9):.1f} tok/s)")
    print("sample:", gen[0][:16].tolist())
    leaves = _leaves(params)
    return gen, {"prefill_s": t_prefill, "decode_s": dt, "decode_steps": args.gen - 1,
                 "prompt_len": args.prompt_len, "batch": args.batch,
                 "n_params": sum(t.numel() for t in leaves),
                 "param_bytes": sum(t.numel() * t.element_size() for t in leaves)}


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def main(argv: list[str] | None = None) -> torch.Tensor:
    """Parse ``argv`` (the command line when None), serve, print the
    reference's ``prefill ...`` and ``decoded ... tok/s`` lines, and return
    the generated tokens (B, gen) on the CPU."""
    return run(argv)[0]


if __name__ == "__main__":
    main()
