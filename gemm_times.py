"""Time the ReDas GEMM's OS calls and the grouped GEMM on the card, to
compare two trees of the port in one machine.

    python3 gemm_times.py [--src DIR] [--build-only] [--int8]

With the package under DIR (default: this checkout's src), in bf16:
the ReDas GEMM's OS dataflow at qwen2-1.5b's (K, N) and the main paths'
M (4, 8, 512, 2048, 6144), each at the engine's best OS decision
(`decide_gemm(..., dataflows=("os",))`); the grouped GEMM at
granite-moe-1b-a400m's expert shapes at 8 slots (decode wi/wg and wo,
the 768-token prefill's wi/wg and wo, the 64-token bucket's C = 160)
through `Engine.grouped_matmul` on the `hopper` backend (the decision
and the route that tree takes); and the host's cost of one grouped call
at the decode shapes, as the wall time of enqueueing 200 calls back to
back without waiting for the card (median of 5).  Operands are random
(seed 0), cycled past the L2; device times are those of CUDA graphs of
calls, by CUDA events.  Prints one line a shape, then one JSON line.
With --int8 it times the int8 GEMM instead: qwen2-1.5b's (K, N) at M =
4, 8 (decode) and 2048 (prefill), each through `Engine.quant_matmul` on
the `hopper-int8` backend (bf16 activations against `quantize_params`
storage, w_q (K, N) int8 and its per-column scale: the activations'
quantization, the kernel at the decision that tree's engine takes, the
rescale) and the kernel alone at that decision, with the host's us of
one `quant_matmul` call at the decode shapes.
Needs a CUDA device.  Run it for each tree in turns (A, B, B, A) within
one machine; `--build-only` builds the tree's GEMM kernels and exits,
so that several trees build at once beforehand.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LAYER_GEMMS = ((1536, 1536), (1536, 256), (1536, 8960), (8960, 1536))
GEMM_M = (4, 8, 512, 2048, 6144)
INT8_M = (4, 8, 2048)
GROUPED_SHAPES = ((32, 32, 1024, 512), (32, 32, 512, 1024),
                  (32, 1920, 1024, 512), (32, 1920, 512, 1024),
                  (32, 160, 1024, 512))
L2_BYTES = 50 * 2**20


def device_ms(torch, fn, sets) -> float:
    """Device ms of one call of `fn`: CUDA events around replays of a
    graph of calls cycling through `sets`."""
    reps = max(8, len(sets))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in sets[:2]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        keep = [fn(*sets[i % len(sets)]) for i in range(reps)]
    graph.replay()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    n = max(3, min(200, math.ceil(100.0 / max(e0.elapsed_time(e1), 1e-3))))
    e0.record()
    for _ in range(n):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    del keep, graph
    return e0.elapsed_time(e1) / (n * reps)


def enqueue_us(torch, fn, calls: int = 200, repeats: int = 5) -> float:
    """The host's us per call of `fn`: the wall time of `calls` calls
    enqueued back to back, the card drained before and after but not
    waited for in between (fewer launches than the launch queue holds),
    the median of `repeats`."""
    fn()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1e6 / calls)
        torch.cuda.synchronize()
    return statistics.median(times)


def int8_rows(torch, src: str) -> list[dict]:
    """qwen's int8 GEMMs through `Engine.quant_matmul` on `hopper-int8`
    and through the kernel alone at the tree's decision."""
    from repro_torch.engine import Engine, KernelRequest, backends
    from repro_torch.kernels import quant_gemm

    def kernel_args(dec) -> dict:
        # a tree with the int8 kernel's paths names them; an older one
        # names a tile only
        if hasattr(backends, "int8_args"):
            return backends.int8_args(dec)
        return {"tile": backends._int8_tile(dec)}

    gen = torch.Generator(device="cuda").manual_seed(0)
    eng = Engine(backend="hopper-int8")
    rows = []
    for m in INT8_M:
        for k, n in LAYER_GEMMS:
            count = max(2, min(32, math.ceil(2 * L2_BYTES / (2 * m * k
                                                             + k * n))))
            sets = [(torch.randn(m, k, generator=gen, device="cuda")
                     .to(torch.bfloat16),
                     torch.randint(-127, 128, (k, n), generator=gen,
                                   device="cuda", dtype=torch.int32)
                     .to(torch.int8),
                     torch.rand(1, n, generator=gen, device="cuda") * 1e-2)
                    for _ in range(count)]
            dec = eng.decide(KernelRequest("gemm_w8", m, k, n, in_bytes=1,
                                           out_bytes=2))
            conf = kernel_args(dec)
            q_sets = [(torch.randint(-127, 128, (m, k), generator=gen,
                                     device="cuda", dtype=torch.int32)
                       .to(torch.int8), w) for _, w, _ in sets]
            row = {"kernel": "quant_gemm", "m": m, "k": k, "n": n,
                   "decision": {key: list(v) if isinstance(v, tuple) else v
                                for key, v in conf.items()},
                   "op_ms": device_ms(torch, eng.quant_matmul, sets),
                   "kernel_ms": device_ms(torch, lambda a, b: quant_gemm
                                          .gemm_int8(a, b, **conf), q_sets)}
            if m < 16:
                row["host_us"] = enqueue_us(
                    torch, lambda: eng.quant_matmul(*sets[0]))
            rows.append(row)
            host = (f", host {row['host_us']:.1f} us a call"
                    if "host_us" in row else "")
            print(f"{src}: quant_matmul {m} x {k} x {n} {row['decision']}: "
                  f"op {row['op_ms']:.4f} ms, kernel {row['kernel_ms']:.4f} "
                  f"ms{host}", flush=True)
            del sets, q_sets
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--build-only", action="store_true")
    ap.add_argument("--int8", action="store_true",
                    help="time the int8 GEMM (Engine.quant_matmul)")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import torch

    if not torch.cuda.is_available():
        print("gemm_times: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.engine import Engine, KernelRequest
    from repro_torch.engine.backends import gemm_args
    from repro_torch.engine.cost import decide_gemm
    from repro_torch.kernels import _build, redas_gemm

    for name in (("quant_gemm",) if args.int8
                 else ("redas_gemm", "grouped_gemm")):
        _build.build(name)
    if args.build_only:
        return 0
    if args.int8:
        rows = int8_rows(torch, args.src)
        print(json.dumps({"src": args.src, "int8": True, "rows": rows}))
        return 0
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    rows = []
    for m in GEMM_M:
        for k, n in LAYER_GEMMS:
            dec = decide_gemm(KernelRequest("gemm", m, k, n), "times",
                              dataflows=("os",))
            count = max(2, min(32, math.ceil(
                2 * L2_BYTES / ((m * k + k * n) * 2))))
            sets = [(torch.randn(m, k, generator=gen, device="cuda").to(bf16),
                     (torch.randn(k, n, generator=gen, device="cuda")
                      / math.sqrt(k)).to(bf16)) for _ in range(count)]
            conf = gemm_args(dec, *sets[0])
            row = {"kernel": "redas_gemm_os", "m": m, "k": k, "n": n,
                   "tile": [conf["bm"], conf["bk"], conf["bn"]],
                   "ms": device_ms(torch, lambda a, b: redas_gemm.gemm(
                       a, b, **conf), sets)}
            rows.append(row)
            print(f"{args.src}: redas_gemm os {m} x {k} x {n} tile "
                  f"{tuple(row['tile'])}: {row['ms']:.4f} ms", flush=True)
            del sets
    eng = Engine(backend="hopper")
    for e, c, d, f in GROUPED_SHAPES:
        count = max(2, min(32, math.ceil(2 * L2_BYTES
                                         / (e * (c * d + d * f) * 2))))
        sets = [(torch.randn(e, c, d, generator=gen, device="cuda").to(bf16),
                 (torch.randn(e, d, f, generator=gen, device="cuda")
                  / math.sqrt(d)).to(bf16)) for _ in range(count)]
        row = {"kernel": "grouped_gemm", "shape": [e, c, d, f],
               "ms": device_ms(torch, eng.grouped_matmul, sets)}
        if c == GROUPED_SHAPES[0][1]:
            row["host_us"] = enqueue_us(
                torch, lambda: eng.grouped_matmul(*sets[0]))
        rows.append(row)
        host = (f", host {row['host_us']:.1f} us a call"
                if "host_us" in row else "")
        print(f"{args.src}: grouped_gemm {(e, c, d, f)}: {row['ms']:.4f} ms"
              f"{host}", flush=True)
        del sets
    print(json.dumps({"src": args.src, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
