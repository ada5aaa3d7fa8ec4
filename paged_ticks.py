"""Time the paged serve's decode ticks on the card, to compare two trees of
the port in one machine.

    python3 paged_ticks.py [--src DIR] [--granite-sorted | --quantize]
    python3 paged_ticks.py --summary FILE...

Serves `chip_smoke.py`'s paged trace (qwen2-1.5b at full width, bf16,
random weights from seed 0, 8 slots, pages of 16) through the launcher
ROUNDS times with the package under DIR (default: this checkout's src),
and after each serve runs three windows of 10 untraced decode ticks
with all 8 slots decoding; the serve's kernels are built first.  With
--granite-sorted it serves granite-moe-1b-a400m at full width with the
sorted dispatch (`impl="sort"`, set in the configuration: the grouped
kernel) through the Scheduler instead, on the same trace and windows,
as chip_smoke.py's granite sorted serve does.  With --quantize it
serves qwen2-1.5b through the launcher's --quantize (int8 weights on the
int8 GEMM, int8 KV pools on the paged kernel) on the same trace and
windows.
Prints, per round, the serve's mean ms per tick and each window's ms per
tick, wall and the process's CPU time (which does not count the time the
process waits for a core another process holds), then one JSON line.
Needs a CUDA device.  Run it for each tree in turns (A, B, B, A) within
one machine: host times move between machines and over a call.
--summary reads the JSON lines of such runs' outputs and prints, per
tree and mode, the median and quartiles of the windows' wall and CPU ms
a tick and of the serves' ms a tick (no device needed).
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SLOTS, PAGE, BUCKET, SEED, ROUNDS = 8, 16, 16, 0, 3
TRACE = "768x32*4,512x64*4,256x16*8,64x48*8"
ARGS = ["--arch", "qwen2-1.5b", "--kernel-backend", "hopper", "--batch",
        str(SLOTS), "--cache-layout", "paged", "--page-size", str(PAGE),
        "--prefill-bucket", str(BUCKET), "--seed", str(SEED), "--trace",
        TRACE]


def granite_sorted_serve() -> dict:
    """granite-moe-1b-a400m (sorted dispatch) served through the Scheduler
    on the paged layout with TRACE; the launcher's keys for what follows."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.engine import Engine
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import transformer as T
    from repro_torch.serve_lib import serve as serve_lib
    from repro_torch.serve_lib.scheduler import Scheduler

    cfg = get_config("granite-moe-1b-a400m")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           impl="sort"))
    trace = launch_serve.parse_trace(TRACE)
    scfg = serve_lib.ServeConfig(
        max_seq=max(p + g for p, g in trace) + 1, batch=SLOTS,
        kernel_backend="hopper", cache_layout="paged", page_size=PAGE)
    params = T.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(SEED), device="cuda", dtype=torch.bfloat16)
    sched = Scheduler(params, cfg, scfg, engine=Engine(backend="hopper"),
                      prefill_bucket=BUCKET)
    sched.run(launch_serve.trace_requests(cfg, trace, SEED))
    return {"scheduler": sched, "params": params, "cfg": cfg,
            "serve_config": scfg, "engine": sched.engine, "trace": trace}


def summary(files: list[str]) -> int:
    """Median and quartiles, per (tree, mode), over every round of the
    runs whose outputs are `files`."""
    runs = collections.defaultdict(lambda: collections.defaultdict(list))
    for name in files:
        out = json.loads(Path(name).read_text().strip().splitlines()[-1])
        mode = ("granite-sorted" if out["granite_sorted"] else
                "quantize" if out.get("quantize") else "qwen2")
        key = (out["src"], mode)
        runs[key]["runs"].append(name)
        for r in out["rounds"]:
            runs[key]["wall"] += r["window_ms_per_tick"]
            runs[key]["cpu"] += r.get("window_cpu_ms_per_tick", [])
            runs[key]["serve"].append(r["serve_ms_per_tick"])
    for (src, mode), got in sorted(runs.items()):
        line = f"{mode} {src} ({len(got['runs'])} runs):"
        for what in ("wall", "cpu", "serve"):
            if len(got[what]) > 1:
                q1, q2, q3 = statistics.quantiles(got[what], n=4)
                line += (f" {what} median {statistics.median(got[what]):.2f} "
                         f"(IQR {q1:.2f}-{q3:.2f}, n {len(got[what])});")
        print(line)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--summary", nargs="+", metavar="FILE")
    ap.add_argument("--src", default=str(ROOT / "src"))
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--granite-sorted", action="store_true",
                      help="serve granite-moe-1b-a400m, sorted dispatch")
    mode.add_argument("--quantize", action="store_true",
                      help="serve qwen2-1.5b under --quantize")
    args = ap.parse_args(argv)
    if args.summary:
        return summary(args.summary)
    sys.path.insert(0, args.src)
    import torch

    if not torch.cuda.is_available():
        print("paged_ticks: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve_lib.scheduler import Scheduler

    kernels = ["redas_gemm", "paged_attention"]
    if args.granite_sorted:
        kernels.append("grouped_gemm")
    if args.quantize:
        kernels = ["quant_gemm", "paged_attention"]
    for name in kernels:   # not inside a serve
        _build.build(name)
    rounds = []
    for _ in range(ROUNDS):
        out = (granite_sorted_serve() if args.granite_sorted
               else launch_serve.main(ARGS + (["--quantize"] if args.quantize
                                              else [])))
        sched = out["scheduler"]
        serve_ms = sched.timings["decode_s"] * 1e3 / sched.stats["decode_steps"]
        probe = Scheduler(out["params"], out["cfg"], out["serve_config"],
                          engine=out["engine"], prefill_bucket=BUCKET)
        for req in launch_serve.trace_requests(out["cfg"], out["trace"],
                                               SEED):
            probe.submit(req)
        probe.step()                       # admit 8, the first tick
        windows, cpu = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), time.process_time()
            for _ in range(10):
                probe.step()
            torch.cuda.synchronize()
            windows.append((time.perf_counter() - t0) * 1e2)
            cpu.append((time.process_time() - c0) * 1e2)
        print(f"{args.src}: serve {serve_ms:.3f} ms a tick; untraced "
              f"windows {', '.join(f'{w:.3f}' for w in windows)} ms a tick "
              f"(CPU {', '.join(f'{c:.3f}' for c in cpu)})", flush=True)
        rounds.append({"serve_ms_per_tick": serve_ms,
                       "window_ms_per_tick": windows,
                       "window_cpu_ms_per_tick": cpu})
        del out, sched, probe
        torch.cuda.empty_cache()
    print(json.dumps({"src": args.src, "granite_sorted": args.granite_sorted,
                      "quantize": args.quantize, "rounds": rounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
