"""Serving launcher of the port (static one-batch mode of
`repro/launch/serve.py`): random weights from `--seed`, one batch of
equal-length random prompts, one greedy `generate` call.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --kernel-backend hopper --batch 4 --prompt-len 512 --gen 16

runs on the card; `--device cpu --smoke` runs the reduced configuration
on the CPU (there the "hopper" backend takes the kernels' plain
versions).
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs import ARCH_NAMES, get_config
from ..engine import BACKENDS
from ..models import transformer as T
from ..serve_lib import serve as serve_lib


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernel-backend", default=None, choices=BACKENDS,
                    help="engine backend for model matmuls (default: plain @)")
    ap.add_argument("--plan", default=None,
                    help="ExecutionPlan JSON to warm-start the decision cache")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    dtype = torch.float32 if args.smoke else torch.bfloat16
    scfg = serve_lib.ServeConfig(
        max_seq=args.prompt_len + args.gen + 1, batch=args.batch,
        compute_dtype=dtype, cache_dtype=dtype,
        kernel_backend=args.kernel_backend, plan_path=args.plan,
        device=args.device)
    dev = serve_lib.resolve_device(scfg)
    params = T.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(args.seed),
        device=dev, dtype=dtype)
    prompt = torch.randint(
        0, cfg.vocab, (args.batch, args.prompt_len), device=dev,
        generator=torch.Generator(device=dev).manual_seed(args.seed + 1),
        dtype=torch.int32)
    engine = serve_lib.warm_start_engine(scfg)
    _sync(dev)
    t0 = time.perf_counter()
    tokens = serve_lib.generate(params, cfg, scfg, prompt, args.gen,
                                engine=engine)
    _sync(dev)
    dt = time.perf_counter() - t0
    print(f"generated {tuple(tokens.shape)} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s) on {dev}")
    print(tokens[0][:16].tolist())
    out = {"tokens_per_s": args.batch * args.gen / dt, "seconds": dt,
           "shape": tuple(tokens.shape), "tokens": tokens.cpu(),
           "engine": engine, "cfg": cfg, "serve_config": scfg,
           "params": params, "prompt": prompt}
    if engine is not None:
        print(f"engine plan: {engine.plan.stats}")
        out["engine_plan"] = engine.plan.stats
    return out


if __name__ == "__main__":
    main()
