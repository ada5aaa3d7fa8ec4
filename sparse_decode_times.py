"""Time the sparse GEMM's decode calls and their split-K reduction on the
card, to compare two trees of the port in one machine.

    python3 sparse_decode_times.py [--src DIR] [--build-only]

With the package under DIR (default: this checkout's src), at qwen2-1.5b's
dense GEMM shapes at 2:4 and M = 4 (the static serve's decode) and 8 (the
paged serve's), each at the engine's decision for bf16 activations: the
whole decode call (first kernel and reduction) with bf16 values, the
reduction alone at the decision's split with an unscaled bf16 output,
and, where the tree serves int8 values, both again with int8 values and
their per-column scale.  Operands are random (seed 0), cycled past the
L2; times are device times of CUDA graphs of calls, by CUDA events.
Prints one line a shape, then one JSON line with the rows and the
--sparsity 2:4 static serve's totals (each M = 4 time weighted by the
calls that serve makes: 7 x 28 x 15 decode calls).
Needs a CUDA device.  Run it for each tree in turns (A, B, B, A) within
one machine; `--build-only` builds the tree's sparse kernels and exits,
so that several trees build at once beforehand.
"""

from __future__ import annotations

import argparse
import inspect
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LAYER_GEMMS = {(1536, 1536): 2, (1536, 256): 2, (1536, 8960): 2,
               (8960, 1536): 1}
LAYERS, DECODE_STEPS, STATIC_M = 28, 15, 4
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--build-only", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import torch

    if not torch.cuda.is_available():
        print("sparse_decode_times: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.engine import KernelRequest
    from repro_torch.engine.backends import sparse_args
    from repro_torch.engine.cost import HopperModel
    from repro_torch.kernels import _build, sparse_gemm

    _build.build("sparse_gemm")
    if args.build_only:
        return 0
    int8 = "scale" in inspect.signature(sparse_gemm.split_reduce).parameters
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    rows = []
    for m in (STATIC_M, 8):
        for (k, n), per_layer in LAYER_GEMMS.items():
            k_c = k // 2
            dec = sparse_args(HopperModel().decide(KernelRequest(
                "gemm_sparse", m, k, n, in_bytes=2, out_bytes=2,
                density=0.5)))
            split = dec["split_k"]
            count = max(2, min(32, math.ceil(2 * L2_BYTES / (k_c * n * 3))))
            sets = []
            for _ in range(count):
                a = torch.randn(m, k, generator=gen, device="cuda").to(bf16)
                v = torch.randn(k_c, n, generator=gen, device="cuda").to(bf16)
                i = torch.randint(0, 4, (k_c, n), generator=gen,
                                  device="cuda", dtype=torch.int8)
                sets.append((a, v, i))
            call = (lambda a, v, i, *s: sparse_gemm.sparse_gemm(
                a, v, i, *s, n_keep=2, m_group=4, **dec))
            row = {"m": m, "k": k, "n": n, "decision": dec,
                   "calls_per_layer": per_layer,
                   "call_ms": device_ms(torch, call, sets)}
            wsets = [(torch.randn(split, m, n, generator=gen,
                                  device="cuda"),)
                     for _ in range(max(2, min(32, math.ceil(
                         2 * L2_BYTES / (split * m * n * 4)))))]
            if split > 1:
                row["reduce_ms"] = device_ms(
                    torch, lambda w: sparse_gemm.split_reduce(w, bf16), wsets)
            if int8:
                qsets = [(a, torch.randint(-127, 128, v.shape, generator=gen,
                                           device="cuda", dtype=torch.int8),
                          i, torch.rand(1, n, generator=gen, device="cuda"))
                         for a, v, i in sets]
                row["int8_call_ms"] = device_ms(torch, call, qsets)
                if split > 1:
                    row["int8_reduce_ms"] = device_ms(
                        torch, lambda w, s: sparse_gemm.split_reduce(
                            w, bf16, s),
                        [(w, qsets[0][3]) for (w,) in wsets])
            rows.append(row)
            print(f"{args.src}: {m}x{k}x{n} split {split}: "
                  + ", ".join(f"{key} {val:.5f}" for key, val in row.items()
                              if key.endswith("_ms")), flush=True)
            del sets, wsets
    totals = {}
    for key in ("call_ms", "reduce_ms", "int8_call_ms", "int8_reduce_ms"):
        if any(key in r for r in rows):
            totals[key] = sum(r.get(key, 0.0) * r["calls_per_layer"] * LAYERS
                              * DECODE_STEPS for r in rows
                              if r["m"] == STATIC_M)
    print(json.dumps({"src": args.src, "static_decode_totals_ms": totals,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
