"""Time the paged-attention decode kernel on the card, to compare two trees
of the port in one machine.

    python3 paged_times.py [--src DIR] [--build-only]

With the package under DIR (default: this checkout's src), the paged
kernel through `paged_attention.paged_attention` at the paged serve's
decode tick: 8 slots, pages of 16, a 51-page table per slot with holes
(live pages drawn from a 510-page pool), kv_len (800, 0, 1, 16, 17, 400,
783, 255); qwen2-1.5b's heads (q (8, 1, 12, 128), pools (510, 16, 2,
128)) and granite-moe-1b-a400m's (q (8, 1, 16, 64), pools (510, 16, 8,
64)); float pools and int8 pools with their f32 scale pools, each with
bf16 and f32 q (the shapes and draws of chip_smoke.py's phases 3 and
14).  Device times are those of CUDA graphs of calls cycling through
input sets past the 50 MB L2, by CUDA events; the host's us a call is
the wall time of 200 calls enqueued back to back without waiting for the
card (median of 5), at bf16.  Prints one line a case, then one JSON
line.  Needs a CUDA device.  Run it for each tree in turns (A, B, B, A)
within one machine; `--build-only` builds the tree's paged kernel and
exits, so that several trees build at once beforehand.
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
SLOTS, PAGE, SLOT_PAGES, POOL_PAGES = 8, 16, 51, 510
PAGED_LENS = (800, 0, 1, 16, 17, 400, 783, 255)
SHAPES = {"qwen2-1.5b": (12, 2, 128), "granite-moe-1b-a400m": (16, 8, 64)}
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
    waited for in between, the median of `repeats`."""
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


def paged_sets(torch, dtype, count, seed, int8, shape) -> list[tuple]:
    """`count` input sets at the decode tick for `shape` = (H, KV, D), as
    chip_smoke.py's `_paged_sets` draws them."""
    h, kv, d = shape
    gen = torch.Generator().manual_seed(seed)
    lens = torch.tensor(PAGED_LENS, dtype=torch.int32)
    sets = []
    for _ in range(count):
        q = torch.randn(SLOTS, 1, h, d, generator=gen)
        if int8:
            pools = tuple(torch.randint(-127, 128, (POOL_PAGES, PAGE, kv, d),
                                        generator=gen, dtype=torch.int8)
                          .cuda() for _ in range(2))
            scales = tuple((torch.rand(POOL_PAGES, PAGE, kv, generator=gen)
                            * 1.9e-2 + 1e-3).cuda() for _ in range(2))
        else:
            pools = tuple(torch.randn(POOL_PAGES, PAGE, kv, d, generator=gen)
                          .to("cuda", dtype) for _ in range(2))
            scales = ()
        perm = torch.randperm(POOL_PAGES, generator=gen).to(torch.int32)
        bt = torch.full((SLOTS, SLOT_PAGES), -1, dtype=torch.int32)
        ptr = 0
        for i, n in enumerate(PAGED_LENS):
            need = -(-n // PAGE)
            bt[i, :need] = perm[ptr:ptr + need]
            ptr += need
        sets.append((q.to("cuda", dtype), *pools, bt.cuda(), lens.cuda(),
                     *scales))
    return sets


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--build-only", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import torch

    if not torch.cuda.is_available():
        print("paged_times: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, paged_attention

    _build.build("paged_attention")
    if args.build_only:
        return 0
    rows = []
    for arch, shape in SHAPES.items():
        h, kv, d = shape
        for int8 in (False, True):
            for dtype in (torch.bfloat16, torch.float32):
                itemsize = 1 if int8 else dtype.itemsize
                row_bytes = kv * ((d + 4) if int8 else d * itemsize)
                count = max(2, min(64, math.ceil(
                    L2_BYTES / (sum(PAGED_LENS) * row_bytes))))
                sets = paged_sets(torch, dtype, count, 7 if int8 else 2,
                                  int8, shape)
                row = {"arch": arch, "pools": "int8" if int8 else "float",
                       "q": str(dtype)[6:],
                       "ms": device_ms(torch, paged_attention.paged_attention,
                                       sets)}
                if dtype == torch.bfloat16:
                    row["host_us"] = enqueue_us(
                        torch, lambda: paged_attention.paged_attention(
                            *sets[0]))
                rows.append(row)
                host = (f", host {row['host_us']:.1f} us a call"
                        if "host_us" in row else "")
                print(f"{args.src}: paged_attention {arch} {row['pools']} "
                      f"pools, {row['q']} q: {row['ms']:.4f} ms{host}",
                      flush=True)
                del sets
    print(json.dumps({"src": args.src, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
