"""Serving launcher of the port (the port of `repro/launch/serve.py`):
random weights from `--seed`.

Static one-batch mode (every prompt the same length, one `generate`
call):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --kernel-backend hopper --batch 4 --prompt-len 512 --gen 16

Request-trace mode (`--trace`): a mixed-length request list served by the
continuous-batching `serve_lib.scheduler.Scheduler` over a pool of
`--batch` slots, contiguous or paged.  Each item is PROMPTxGEN with an
optional *COUNT repeat:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --kernel-backend hopper --batch 8 --cache-layout paged \\
        --trace "768x32*4,512x64*4,256x16*8,64x48*8"

`--quantize` serves the full int8 posture in either mode: the dense
weights quantized (`quant.quantize_params`), the KV cache int8
(`cache_dtype=torch.int8`, rows and per-row scales), and the backend
upgraded to its int8 sibling ("hopper-int8").  `--sparsity N:M` serves
the float N:M-sparse posture: the dense weights magnitude-pruned
(`sparse.prune_params`) and the backend upgraded to its sparse sibling
("hopper-sparse").  The two together serve sparse x int8: the kept
values stored int8 with per-column scales (`prune_params(...,
quantize=True)`, and no `quantize_params`), the KV cache int8, and
"hopper-sparse" running the sparse GEMM's int8-value variant:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --sparsity 2:4 --quantize --batch 4 --prompt-len 512 --gen 16

Trace mode also serves speculative decoding (`--speculate K`, with
`--draft self` or `self-int8`; max_seq grows by K for the verify's rows),
chunked prefill (`--prefill-chunk C`) and the async ingestion plane
(`--async-ingest`); `--temperature T` samples in either mode:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --kernel-backend hopper --batch 8 --cache-layout paged \
        --speculate 4 --trace "768x32*4,512x24*4,256x8*4"

Every decoder of `configs.ARCH_NAMES` serves in either mode: the
recurrent mamba2-780m ("ssm") and recurrentgemma-2b ("rglru" and
"local"), whose paged ServeConfig runs the contiguous path, and, in
static mode, internvl2-1b with `prefix_tokens` patch embeddings drawn
from the seed before its text prompt.  An encoder (hubert-xlarge) has no
decode step and is refused; run it through `transformer.forward` with
frame embeddings.

Both run on the card; `--device cpu --smoke` runs the reduced
configuration on the CPU (there the "hopper" backend takes the kernels'
plain versions).  As in the reference, both serve inside
`make_test_mesh()`: a one-rank mesh, on which `generate` places params
and cache by the rule tables, every placement `Replicate()`.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCH_NAMES, get_config
from ..dist import sharding as shd
from ..engine import BACKENDS
from ..models import transformer as T
from ..quant import quantize_params
from ..serve_lib import serve as serve_lib
from ..serve_lib.scheduler import Request, Scheduler
from ..sparse import parse_sparsity, prune_params
from .mesh import make_test_mesh


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def parse_trace(spec: str) -> list[tuple[int, int]]:
    """"24x32,8x8*6" -> [(24, 32), (8, 8) x 6] (prompt_len, gen_len)."""
    out: list[tuple[int, int]] = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        count = 1
        if "*" in item:
            item, n = item.split("*")
            count = int(n)
        p, g = item.split("x")
        out.extend([(int(p), int(g))] * count)
    if not out:
        raise ValueError(f"empty trace spec {spec!r}")
    return out


def trace_requests(cfg, trace, seed: int,
                   temperature: float = 0.0) -> list[Request]:
    """The trace's requests, prompts drawn from `seed` as the JAX
    package's launcher draws them.  With `temperature > 0` request `uid`
    samples with its own host generator, seeded `seed + 3 + uid`."""
    rng = np.random.default_rng(seed + 2)
    return [Request(uid=uid,
                    prompt=rng.integers(0, cfg.vocab, plen).astype(np.int32),
                    max_new_tokens=gen, temperature=temperature,
                    key=(torch.Generator().manual_seed(seed + 3 + uid)
                         if temperature > 0 else None))
            for uid, (plen, gen) in enumerate(trace)]


#: seconds a trace served through `--async-ingest` may take a request
ASYNC_TIMEOUT_S = 3600.0


def _run_trace(params, cfg, scfg, args, trace) -> dict:
    dev = serve_lib.resolve_device(scfg)
    reqs = trace_requests(cfg, trace, args.seed, args.temperature)
    sched = Scheduler(params, cfg, scfg, prefill_bucket=args.prefill_bucket)
    _sync(dev)
    t0 = time.perf_counter()
    if args.async_ingest:
        with sched.serve_async(max_queue=max(len(reqs), 1)) as srv:
            futs = [srv.submit(r) for r in reqs]
            for f in futs:
                f.result(timeout=ASYNC_TIMEOUT_S)
        comps = sched.completions
    else:
        comps = sched.run(reqs)
    _sync(dev)
    dt = time.perf_counter() - t0
    n_tok = sum(len(c.tokens) for c in comps.values())
    print(f"served {len(comps)} requests / {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s) over {scfg.batch} slots on {dev}")
    print(f"scheduler: {sched.stats}")
    for uid in sorted(comps)[:8]:
        c = comps[uid]
        print(f"  req {uid}: prompt {c.prompt_len} -> {len(c.tokens)} tokens "
              f"({c.finish_reason}, steps {c.admit_step}..{c.finish_step})")
    out = {"tokens_per_s": n_tok / dt, "seconds": dt, "tokens": n_tok,
           "requests": len(comps), "decode_steps": sched.stats["decode_steps"],
           "scheduler": sched, "engine": sched.engine, "cfg": cfg,
           "serve_config": scfg, "params": params, "trace": trace}
    if sched.engine is not None:
        print(f"engine plan: {sched.engine.plan.stats}")
        out["engine_plan"] = sched.engine.plan.stats
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="batch (static mode) / slot-pool size (--trace)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None,
                    help="request trace 'PROMPTxGEN[*COUNT],...' served by "
                         "the continuous-batching scheduler")
    ap.add_argument("--prefill-bucket", type=int, default=8,
                    help="round admit widths up to this multiple (trace "
                         "mode; 1 = exact)")
    ap.add_argument("--cache-layout", default="contiguous",
                    choices=("contiguous", "paged"),
                    help="KV-cache layout; 'paged' (trace mode only) pools "
                         "fixed pages behind per-slot block tables and "
                         "shares prefilled prompt pages across requests")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per page for --cache-layout paged")
    ap.add_argument("--kernel-backend", default=None, choices=BACKENDS,
                    help="engine backend for model matmuls (default: plain @)")
    ap.add_argument("--quantize", action="store_true",
                    help="full int8 serving posture: quantize the dense "
                         "weights (quant.quantize_params), store the KV "
                         "cache int8 (cache_dtype=int8), and upgrade the "
                         "kernel backend to its int8 sibling")
    ap.add_argument("--sparsity", default=None, metavar="N:M",
                    help="structured-sparse serving posture (e.g. '2:4'): "
                         "magnitude-prune the dense weights "
                         "(sparse.prune_params) and upgrade the kernel "
                         "backend to its sparse sibling; with --quantize "
                         "the kept values are stored int8 (sparse x int8)")
    ap.add_argument("--plan", default=None,
                    help="ExecutionPlan JSON to warm-start the decision "
                         "cache from (see repro_torch.engine.plan_arch)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sample at this temperature (0: greedy); static "
                         "mode draws from a generator seeded --seed + 3, "
                         "trace mode gives request uid its own, seeded "
                         "--seed + 3 + uid")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill (trace mode only): stream "
                         "prompts longer than this into their slot CHUNK "
                         "tokens per tick, interleaved with decode; a "
                         "multiple of --prefill-bucket (and of --page-size "
                         "when paged)")
    ap.add_argument("--async-ingest", action="store_true",
                    help="drive the trace through Scheduler.serve_async "
                         "(a worker thread behind a bounded request queue) "
                         "instead of the synchronous run loop")
    ap.add_argument("--speculate", type=int, default=0, metavar="K",
                    help="speculative decoding (trace mode only): draft K "
                         "tokens per tick and verify them in one K+1-wide "
                         "pass; greedy only, the tokens of --speculate 0")
    ap.add_argument("--draft", default="self", choices=("self", "self-int8"),
                    help="draft model for --speculate: 'self' shares the "
                         "target params, 'self-int8' drafts with their "
                         "int8-quantized copy")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.kind == "encoder":
        raise SystemExit("encoder-only arch: no decode step (see DESIGN.md)")
    dtype = torch.float32 if args.smoke else torch.bfloat16
    trace = parse_trace(args.trace) if args.trace else None
    if args.cache_layout == "paged" and trace is None:
        raise SystemExit("--cache-layout paged needs --trace (the block-table "
                         "plane lives in the continuous-batching scheduler)")
    if (args.prefill_chunk or args.async_ingest) and trace is None:
        raise SystemExit("--prefill-chunk / --async-ingest need --trace "
                         "(chunked ingestion lives in the continuous-"
                         "batching scheduler)")
    max_seq = (max(p + g for p, g in trace) + 1 if trace
               else cfg.prefix_tokens + args.prompt_len + args.gen + 1)
    if args.speculate:
        if trace is None:
            raise SystemExit("--speculate needs --trace (the draft/verify "
                             "tick lives in the continuous-batching "
                             "scheduler)")
        if args.temperature > 0:
            raise SystemExit("--speculate is greedy-only (temperature 0)")
        max_seq += args.speculate  # verify writes k rows past the last token
    scfg = serve_lib.ServeConfig(
        max_seq=max_seq, batch=args.batch,
        compute_dtype=dtype,
        cache_dtype=torch.int8 if args.quantize else dtype,
        kernel_backend=args.kernel_backend, plan_path=args.plan,
        quantize=args.quantize, sparsity=args.sparsity, device=args.device,
        cache_layout=args.cache_layout, page_size=args.page_size,
        speculate_k=args.speculate,
        draft=args.draft if args.speculate else None,
        prefill_chunk=args.prefill_chunk)
    dev = serve_lib.resolve_device(scfg)
    # as the reference serves: inside make_test_mesh() (a one-rank mesh,
    # so every placement `generate` makes is Replicate())
    with shd.use_mesh(make_test_mesh(device=args.device)):
        return _serve(args, cfg, scfg, dev, dtype, trace)


def _serve(args, cfg, scfg, dev, dtype, trace) -> dict:
    params = T.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(args.seed),
        device=dev, dtype=dtype)
    if args.sparsity:
        # with --quantize the kept values store int8 inside the
        # SparseTensor (sparse x int8): quantize_params must not run
        params = prune_params(params, *parse_sparsity(args.sparsity),
                              quantize=args.quantize)
    elif args.quantize:
        params = quantize_params(params)
    if trace is not None:
        return _run_trace(params, cfg, scfg, args, trace)
    draw = torch.Generator(device=dev).manual_seed(args.seed + 1)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           device=dev, generator=draw, dtype=torch.int32)
    embeds = None
    if cfg.prefix_tokens:
        # the stub vision frontend's patch embeddings, from the same seed
        embeds = 0.02 * torch.randn(args.batch, cfg.prefix_tokens,
                                    cfg.d_model, device=dev, generator=draw,
                                    dtype=dtype)
    engine = serve_lib.warm_start_engine(scfg)
    key = (torch.Generator(device=dev).manual_seed(args.seed + 3)
           if args.temperature > 0 else None)
    _sync(dev)
    t0 = time.perf_counter()
    tokens = serve_lib.generate(params, cfg, scfg, prompt, args.gen,
                                temperature=args.temperature, key=key,
                                embeds=embeds, engine=engine)
    _sync(dev)
    dt = time.perf_counter() - t0
    print(f"generated {tuple(tokens.shape)} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s) on {dev}")
    print(tokens[0][:16].tolist())
    out = {"tokens_per_s": args.batch * args.gen / dt, "seconds": dt,
           "shape": tuple(tokens.shape), "tokens": tokens.cpu(),
           "engine": engine, "cfg": cfg, "serve_config": scfg,
           "params": params, "prompt": prompt, "embeds": embeds}
    if engine is not None:
        print(f"engine plan: {engine.plan.stats}")
        out["engine_plan"] = engine.plan.stats
    return out


if __name__ == "__main__":
    main()
