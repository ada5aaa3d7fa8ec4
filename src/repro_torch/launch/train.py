"""Training launcher of the port (the port of `repro/launch/train.py`),
on one device:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --kernel-backend hopper --batch 8 --seq 512 --microbatches 2 \\
        --steps 200 --ckpt-dir runs/ckpt --resume auto

Random weights from `--seed`, synthetic batches (or `--data-path`, a
flat int32 token file) from the same seed, AdamW on a linear-warmup
cosine schedule, the model's matmuls through `--kernel-backend` (plain
`@` by default), checkpoints every `--ckpt-every` steps and at the end (the reference
writes the last step twice when it is a multiple of `--ckpt-every`; here
the periodic save of that step is waited for instead: the same file).
It runs on the card; `--device cpu --smoke` trains the reduced
configuration on the CPU (there "hopper" takes the kernels' plain
versions).  The reference's mesh, sharding rules and reshard-on-restore
belong to the multi-device launcher, not this one.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..checkpoint.checkpoint import Checkpointer, resume_or_init
from ..configs import ARCH_NAMES, get_config
from ..data.pipeline import DataConfig, make_source
from ..optim.adamw import AdamWConfig
from ..optim.schedule import linear_warmup_cosine
from ..train_lib import train as train_lib


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", choices=("auto", "none"), default="none")
    ap.add_argument("--data-path", default=None,
                    help="memmap token corpus; default synthetic")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--kernel-backend", default=None,
                    choices=("hopper", "torch-ref", "hopper-sparse",
                             "torch-ref-sparse"),
                    help="engine backend for model matmuls (default: "
                         "plain @)")
    ap.add_argument("--sparsity", default=None, metavar="N:M",
                    help="sparse posture (e.g. '2:4'): upgrade the kernel "
                         "backend to its sparse sibling; the weights stay "
                         "dense, as in the reference")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device!r} but no CUDA device is "
                           f"available; pass --device cpu to train on the "
                           f"CPU")
    cfg = get_config(args.arch, smoke=args.smoke)
    tcfg = train_lib.TrainConfig(
        microbatches=args.microbatches,
        compute_dtype=torch.float32 if args.smoke else torch.bfloat16,
        optimizer=AdamWConfig(
            lr=linear_warmup_cosine(args.lr, args.warmup, args.steps)),
        kernel_backend=args.kernel_backend,
        sparsity=args.sparsity,
    )
    source = make_source(cfg, DataConfig(args.batch, args.seq, args.seed),
                         args.data_path)

    def init_fn():
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        return train_lib.init_state(cfg, tcfg, generator=gen, device=dev)

    step_fn = train_lib.make_train_step(cfg, tcfg)
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt and args.resume == "auto":
        start, state = resume_or_init(ckpt, init_fn)
    else:
        start, state = 0, init_fn()
    if start:
        print(f"resumed from step {start}")
    out = {"start": start, "engine": step_fn.engine, "cfg": cfg,
           "train_config": tcfg}
    if start >= args.steps:
        print(f"checkpoint already at step {start} >= --steps "
              f"{args.steps}; nothing to train")
        return {"final_ce": None, "first_ce": None, "steps": start, **out}

    losses, gnorms, seconds = [], [], []
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        _sync(dev)
        ts = time.perf_counter()
        batch = train_lib.device_batch(source.batch(step), dev)
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["ce"]))      # waits for the step
        gnorms.append(float(metrics["grad_norm"]))
        seconds.append(time.perf_counter() - ts)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d}  ce {losses[-1]:.4f}  "
                  f"gnorm {gnorms[-1]:.3f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"{(time.perf_counter() - t0):.1f}s", flush=True)
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, state)
    if ckpt and args.steps % args.ckpt_every == 0:
        ckpt.wait()          # the last periodic save holds this state
    elif ckpt:
        ckpt.save(args.steps, state, blocking=True)
    return {"final_ce": losses[-1], "first_ce": losses[0],
            "steps": args.steps, "ce": losses, "grad_norm": gnorms,
            "step_seconds": seconds, "state": state, "train_step": step_fn,
            **out}


if __name__ == "__main__":
    res = main()
    print({k: res[k] for k in ("final_ce", "first_ce", "steps")})
