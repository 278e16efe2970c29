"""Training entry point, ported from ``repro.launch.train``: trains any registered
token-input architecture on the parameter tree in its config's dtype (bf16
at full size, fp32 for a ``--reduced`` config, as in the reference), on the
card unless ``--device cpu`` is given (there is no fallback: without a
card the default raises).

  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m --reduced \\
      --steps 50 --batch 8 --seq 128 --ckpt /tmp/x.ckpt [--device cpu]

Each step is ``loss_fn`` (the chunked cross-entropy, the MoE aux term and
the MTP head), its gradient by autograd through the flash-attention and
selective-scan kernels on the card, then ``chain(clip_by_global_norm(1.0),
adamw(warmup_cosine(lr, 10, steps), weight_decay=0.01))``.  ``--ckpt``
writes (params, optimizer state) and ``{"arch", "step"}`` in the port's own
checkpoint format; ``--resume`` restores them into freshly built
structures and continues from the stored step.  Times are host-clock
seconds since the loop began, read where the loss comes back to the host.
"""

from __future__ import annotations

import argparse
import time

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.checkpoint.serializer import load_meta
from repro_torch.configs import get_config
from repro_torch.data.synthetic import make_token_stream
from repro_torch.device import pin_fp32_matmul, resolve_device
from repro_torch.models.transformer import check_supported, init_params, loss_fn
from repro_torch.optim import adamw, chain, clip_by_global_norm, warmup_cosine
from repro_torch.optim.optimizers import apply_updates

__all__ = ["make_train_step", "make_optimizer", "main"]


def make_train_step(cfg, optimizer, mesh=None):
    """``step(params, opt_state, batch) -> (params, opt_state, loss,
    metrics)``: ``loss_fn`` (under ``mesh``, the MoE's device mesh, if
    given) and its gradient with respect to every leaf of the parameter
    tree (each gradient in its leaf's type), the optimizer's update and
    ``apply_updates``.  The optimizer state advances in place and the
    parameters come back as a new tree, as the reference's step donates
    both; pass each step the previous step's outputs.  Under a mesh of
    several processes each holds every leaf whole (the global-norm clip
    and AdamW do not run on blocks yet), passes the same batch and ends
    with the same gradient, so their trees stay equal."""
    check_supported(cfg, tree=True)

    def step(params, opt_state, batch):
        leaves, spec = tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        params = tree_unflatten(leaves, spec)
        loss, metrics = loss_fn(params, cfg, batch, mesh, sharded=False)
        # a leaf the step does not reach (an xLSTM layer runs one of its two
        # cores) gets a zero gradient, as the reference's where-selection
        # gives it
        grads = tree_unflatten(list(torch.autograd.grad(loss, leaves, allow_unused=True,
                                                        materialize_grads=True)), spec)
        params = tree_unflatten([p.detach() for p in leaves], spec)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        del grads
        params = apply_updates(params, updates)
        return params, opt_state, loss.detach(), {k: v.detach() for k, v in metrics.items()}

    return step


def make_optimizer(lr: float, steps: int):
    """The launcher's optimizer: clip to global norm 1, then AdamW with a
    10-step linear warmup to ``lr`` and a cosine decay over ``steps``,
    weight decay 0.01."""
    return chain(clip_by_global_norm(1.0),
                 adamw(warmup_cosine(lr, 10, steps), weight_decay=0.01))


def main(argv: list[str] | None = None):
    """Parse ``argv`` (the command line when None), train, print the
    reference's ``step ... loss ... ce ...`` lines, write ``--ckpt`` if
    given, and return (params, opt_state)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume", default=None,
                    help="checkpoint written by a previous --ckpt run; restores params + "
                         "optimizer state and continues from the stored step")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    pin_fp32_matmul()
    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.input_mode != "tokens":
        raise SystemExit(
            f"{args.arch} is {cfg.input_mode}-input; use examples/serve_audio_vlm.py"
        )
    params = init_params(torch.Generator(device).manual_seed(args.seed), cfg)
    opt = make_optimizer(args.lr, args.steps)
    opt_state = opt.init(params)
    start = 0
    if args.resume:
        meta = load_meta(args.resume)
        if meta.get("arch") != cfg.name:
            raise SystemExit(
                f"--resume checkpoint is for arch {meta.get('arch')!r}, "
                f"not {cfg.name!r}"
            )
        # restore into the freshly built structures: the serializer checks
        # structure, dtype and shape leaf by leaf
        (params, opt_state), meta = load_checkpoint(args.resume, (params, opt_state))
        start = int(meta.get("step", 0))
        print(f"resumed {cfg.name} from {args.resume} at step {start}")
    step = make_train_step(cfg, opt)

    data = make_token_stream(args.steps * args.batch, args.seq, cfg.vocab, seed=args.seed)
    tokens = torch.from_numpy(data.x).to(device)
    labels = torch.from_numpy(data.y).to(device)
    t0 = time.time()
    for i in range(start, args.steps):
        lo = i * args.batch
        batch = {"tokens": tokens[lo:lo + args.batch], "labels": labels[lo:lo + args.batch]}
        params, opt_state, loss, metrics = step(params, opt_state, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {float(loss):.4f} ce {float(metrics['ce']):.4f} "
                  f"({time.time()-t0:.1f}s)", flush=True)
    if args.ckpt:
        save_checkpoint(args.ckpt, (params, opt_state),
                        meta={"arch": cfg.name, "step": args.steps})
        print(f"checkpoint written to {args.ckpt}")
    return params, opt_state


if __name__ == "__main__":
    main()
