#!/usr/bin/env python3
"""Drive the PyTorch/Hopper port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failed check exits non-zero; nothing falls back):
  1. card and set-up: the card's name and power limit, the torch and CUDA
     versions, the build of every kernel from the sources in this checkout
     (seconds, registers and spills from `-Xptxas -v`);
  2. kernel against plain: the ReDas GEMM in each dataflow at every GEMM
     shape of the main path (bf16) and at two shapes in f32, held to its
     plain version, with the kernel's, the plain version's and
     torch.matmul's times beside the card's bound;
  3. the main path: `repro_torch.launch.serve` serving full-width
     qwen2-1.5b (4 requests x 512 prompt + 16 new tokens, bf16, weights
     from a seed) on the `hopper` backend; the GEMM kernel must launch
     7 x 28 x 16 = 3136 times.  The same entry point serving 1 token
     gives the prefill time, and device traces of the served run's
     `generate` the idle share;
  4. parity on the card: full-width prefill logits of `hopper` against
     `torch-ref` on the served run's weights and prompt, and the smoke
     configuration in f32 giving the same tokens on the card as the
     plain versions on the CPU;
  5. the kernels line, then the result line.

Every detail also goes to runs/chip_smoke.json.  Exits non-zero
without a CUDA device, and outside a checkout of the repository.
"""

from __future__ import annotations

import collections
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.engine import Engine, KernelRequest, use_engine  # noqa: E402
from repro_torch.engine.cost import (HBM_BW, PEAK_FLOPS_BF16,  # noqa: E402
                                     PEAK_FLOPS_F32, HopperModel, choose_tile)
from repro_torch.kernels import _build, redas_gemm  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve_lib import serve as serve_lib  # noqa: E402

ARCH = "qwen2-1.5b"
BATCH, PROMPT, GEN, SEED = 4, 512, 16, 0
#: engine GEMMs of one qwen2-1.5b layer: (K, N) -> calls per layer
LAYER_GEMMS = {(1536, 1536): 2, (1536, 256): 2, (1536, 8960): 2, (8960, 1536): 1}
L2_BYTES = 50 * 2**20
BF16_ROW_TOL, F32_ROW_TOL = 1e-2, 1e-4
LOGIT_LIMITS = {"rel_l2": 0.035, "rel_max": 0.035}
REPORT = {}


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------


def device_ms(fn, sets, side: torch.cuda.Stream) -> float:
    """Device time of one call of `fn`, by CUDA events around replays of a
    CUDA graph of calls that cycle through `sets` (inputs past the L2, and
    no host gaps between launches).  `side` is the stream for the warm-up
    before capture; one stream serves every call, so cuBLAS keeps one
    workspace for it."""
    reps = max(8, len(sets))
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
    per_replay = e0.elapsed_time(e1)
    n = max(3, min(200, math.ceil(100.0 / max(per_replay, 1e-3))))
    e0.record()
    for _ in range(n):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    del keep, graph
    return e0.elapsed_time(e1) / (n * reps)


def bound(m: int, k: int, n: int, itemsize: int) -> tuple[float, str]:
    """Least time (ms) the card could take, and what sets it: each input
    read once and the output written once at the HBM rate, against the
    FLOPs at the data-sheet peak for the operand type."""
    peak = PEAK_FLOPS_BF16 if itemsize == 2 else PEAK_FLOPS_F32
    ops_ms = 2.0 * m * k * n / peak * 1e3
    bytes_ms = (m * k + k * n + m * n) * itemsize / HBM_BW * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def row_rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.float(), ref.float()
    return ((got - ref).norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)).max().item()


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_setup() -> None:
    print(card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib = _build.build("redas_gemm")
    seconds = time.perf_counter() - t0
    log = _build.log_path("redas_gemm").read_text()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    stores = sum(int(s) for s in re.findall(r"(\d+) bytes spill stores", log))
    loads = sum(int(s) for s in re.findall(r"(\d+) bytes spill loads", log))
    check(len(regs) > 0, "no kernel in the ptxas report")
    print(f"build: {seconds:.1f} s ({lib.name}); ptxas: "
          f"{len(regs)} kernels, registers {min(regs)}..{max(regs)}, spill "
          f"stores {stores} bytes and loads {loads} bytes in all")
    REPORT["setup"] = {"card": card_line(), "torch": torch.__version__,
                       "cuda": torch.version.cuda, "build_s": seconds,
                       "kernels": len(regs), "registers": [min(regs), max(regs)],
                       "spill_store_bytes": stores, "spill_load_bytes": loads}


def _operand_sets(m, k, n, dtype, gen):
    per = (m * k + k * n) * torch.tensor([], dtype=dtype).element_size()
    count = max(2, min(64, math.ceil(2 * L2_BYTES / per)))
    return [(torch.randn(m, k, generator=gen, device="cuda").to(dtype),
             (torch.randn(k, n, generator=gen, device="cuda")
              / math.sqrt(k)).to(dtype)) for _ in range(count)]


def phase_kernels() -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(1)
    side = torch.cuda.Stream()
    model = HopperModel()
    shapes = [(m, k, n, torch.bfloat16) for m in (BATCH, BATCH * PROMPT)
              for k, n in LAYER_GEMMS]
    shapes += [(BATCH, 1536, 8960, torch.float32),
               (BATCH * PROMPT, 1536, 1536, torch.float32)]
    rows, failures = [], []
    for m, k, n, dtype in shapes:
        sets = _operand_sets(m, k, n, dtype, gen)
        a, b = sets[0]
        size = a.element_size()
        ref = redas_gemm.gemm_reference(a, b)
        plain_ms = device_ms(redas_gemm.gemm_reference, sets, side)
        library_ms = device_ms(torch.matmul, sets, side)
        bound_ms, bound_by = bound(m, k, n, size)
        main = model.decide(KernelRequest("gemm", m, k, n, in_bytes=size,
                                          out_bytes=size))
        tol = BF16_ROW_TOL if dtype == torch.bfloat16 else F32_ROW_TOL
        for df in redas_gemm.DATAFLOWS:
            cfg = choose_tile(m, k, n, size, size, dataflows=(df,))
            tile = {"bm": cfg.bm, "bk": cfg.bk, "bn": cfg.bn}
            out = redas_gemm.gemm(a, b, dataflow=df, **tile)
            torch.cuda.synchronize()
            rel = row_rel_l2(out, ref)
            err = (out.float() - ref.float()).abs().max().item()
            ms = device_ms(lambda x, y, df=df, tile=tile:
                           redas_gemm.gemm(x, y, dataflow=df, **tile), sets,
                           side)
            on_path = (df, cfg.bm, cfg.bk, cfg.bn) == (
                main.dataflow, main.bm, main.bk, main.bn)
            row = {"m": m, "k": k, "n": n, "dtype": str(dtype)[6:],
                   "dataflow": df, "tile": [cfg.bm, cfg.bk, cfg.bn],
                   "main_path": on_path and dtype == torch.bfloat16,
                   "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "max_abs_err": err, "row_rel_l2": rel, "tol": tol}
            rows.append(row)
            ok = math.isfinite(rel) and rel <= tol
            print(f"gemm {row['dtype']} {m}x{k}x{n} {df} tile {tuple(row['tile'])}"
                  f"{' (main path)' if row['main_path'] else ''}: row rel-L2 "
                  f"{rel:.2e} (tol {tol:g}), max|diff| {err:.3e}; kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.matmul "
                  f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})"
                  f"{'' if ok else '  FAILED'}")
            if not ok:
                failures.append(f"{df} {m}x{k}x{n} {row['dtype']}: {rel:.2e}")
        del sets
    REPORT["gemm"] = rows
    check(not failures, f"kernel disagrees with its plain version: {failures}")
    return rows


def _serve(gen: int) -> dict:
    """One run of the main path's entry point: weights and prompt drawn
    from SEED, `gen` greedy tokens for each of the BATCH requests."""
    return launch_serve.main(
        ["--arch", ARCH, "--kernel-backend", "hopper", "--batch", str(BATCH),
         "--prompt-len", str(PROMPT), "--seed", str(SEED), "--gen", str(gen)])


def phase_main_path(cfg) -> dict:
    _serve(2)  # warm-up (allocator, first launches)
    # prefill and the first token alone: the prefill time of a served run
    first = _serve(1)
    first_tokens, prefill_ms = first["tokens"], first["seconds"] * 1e3
    del first
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # what the script holds already
    redas_gemm.reset_launches()
    out = _serve(GEN)
    launches = dict(redas_gemm.launches)
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    expected = sum(LAYER_GEMMS.values()) * cfg.n_layers * GEN
    tokens = out["tokens"]
    decode_ms = (out["seconds"] * 1e3 - prefill_ms) / (GEN - 1)
    mix = collections.Counter(dec.dataflow for _, dec in out["engine"].plan)
    print(f"main path: served {BATCH} requests x ({PROMPT} prompt + {GEN} new) "
          f"in {out['seconds']:.3f} s, {out['tokens_per_s']:.1f} tok/s; prefill "
          f"and first token {prefill_ms:.2f} ms (a served run of 1 token), "
          f"decode {decode_ms:.3f} ms/step (the difference, over {GEN - 1} "
          f"steps); max memory allocated by the run {peak:.2f} GiB (weights "
          f"included); plan {out['engine_plan']}; dataflow mix of decisions "
          f"{dict(mix)}; kernel launches {launches}")
    check(sum(launches.values()) == expected,
          f"GEMM kernel launched {sum(launches.values())} times, not {expected}")
    check(tuple(tokens.shape) == (BATCH, GEN), f"tokens {tuple(tokens.shape)}")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab)).all()), "token out of range")
    check(torch.equal(first_tokens, tokens[:, :1]),
          "the 1-token run's token differs from the served run's first token")
    check(out["engine_plan"]["misses"] == out["engine_plan"]["decisions"] == 8,
          f"plan {out['engine_plan']}: expected 8 decisions, each missed once")
    REPORT["main_path"] = {
        "seconds": out["seconds"], "tokens_per_s": out["tokens_per_s"],
        "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
        "max_memory_gib": peak, "plan": out["engine_plan"],
        "decision_mix": dict(mix), "launches": launches,
        "tokens": tokens.tolist(),
        **_traces(out, prefill_ms, decode_ms * (GEN - 1))}
    return out


def _logit_gap(got: torch.Tensor, ref: torch.Tensor) -> dict:
    got, ref = got.float(), ref.float()
    diff = got - ref
    top = got.argmax(-1)
    # the kernel's top token, scored by the plain logits, within the
    # max-deviation bound of the plain top logit
    near = (ref.max(-1).values - ref.gather(-1, top[..., None])[..., 0]
            <= LOGIT_LIMITS["rel_max"] * ref.abs().max())
    return {"rel_l2": (diff.norm() / ref.norm()).item(),
            "rel_max": (diff.abs().max() / ref.abs().max()).item(),
            "argmax_agreement": (top == ref.argmax(-1)).float().mean().item(),
            "top_within_bound": bool(near.all())}


def _profile(fn) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [(ev.self_device_time_total / 1e3, ev.count, ev.key)
               for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA]
    kernels.sort(reverse=True)
    busy = sum(ms for ms, _, _ in kernels)
    return {"result": result, "wall_ms": wall, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall),
            "top": [{"ms": ms, "count": c, "name": name[:100]}
                    for ms, c, name in kernels[:6]]}


def _traces(out: dict, prefill_ms: float, decode_ms: float) -> dict:
    """Device traces of the served run's `generate`, on its own weights,
    prompt, configuration and engine: one with the first token only
    (prefill) and one with all GEN tokens; decode is their difference.
    The profiler slows the host, so each idle share is given twice:
    against the traced wall time and against the untraced served time
    (`prefill_ms`, `decode_ms` for all decode steps)."""
    def run(n):
        return lambda: serve_lib.generate(out["params"], out["cfg"],
                                          out["serve_config"], out["prompt"],
                                          n, engine=out["engine"])

    prefill = _profile(run(1))
    whole = _profile(run(GEN))
    check(torch.equal(whole.pop("result").cpu(), out["tokens"]),
          "the traced run's tokens differ from the served run's")
    prefill.pop("result")
    wall = whole["wall_ms"] - prefill["wall_ms"]
    busy = whole["device_busy_ms"] - prefill["device_busy_ms"]
    decode = {"wall_ms": wall, "device_busy_ms": busy,
              "idle_share": max(0.0, 1.0 - busy / wall)}
    for prof, served in ((prefill, prefill_ms), (whole, prefill_ms + decode_ms),
                         (decode, decode_ms)):
        prof["served_ms"] = served
        prof["idle_share_served"] = max(0.0, 1.0 - prof["device_busy_ms"] / served)
    for name, prof in (("prefill", prefill), (f"whole serve ({GEN} tokens)", whole),
                       (f"decode ({GEN - 1} steps, the difference)", decode)):
        print(f"trace {name}: wall {prof['wall_ms']:.2f} ms, device busy "
              f"{prof['device_busy_ms']:.2f} ms, idle share {prof['idle_share']:.2f}; "
              f"against the untraced {prof['served_ms']:.2f} ms served, idle "
              f"share {prof['idle_share_served']:.2f}")
        for k in prof.get("top", []):
            print(f"    {k['ms']:9.3f} ms {k['count']:5d} x {k['name']}")
    return {"trace_prefill": prefill, "trace_serve": whole, "trace_decode": decode}


def phase_parity(cfg, served: dict) -> None:
    """Prefill logits on the served run's own weights and prompt, and the
    smoke configuration's tokens on the card against the CPU."""
    params, prompt = served["params"], served["prompt"]
    dev = prompt.device
    spec = T.CacheSpec(PROMPT + GEN + 1, BATCH)

    def run_prefill(backend):
        cache = T.init_cache(cfg, spec, dtype=torch.bfloat16, device=dev)
        with torch.inference_mode():
            if backend is None:  # plain bf16 `@`, no engine
                return T.prefill(params, cfg, prompt, cache)[0]
            with use_engine(Engine(backend=backend)):
                return T.prefill(params, cfg, prompt, cache)[0]

    ref_logits, hop_logits = run_prefill("torch-ref"), run_prefill("hopper")
    lib_logits = run_prefill(None)
    gap = _logit_gap(hop_logits, ref_logits)
    lib_gap = _logit_gap(lib_logits, ref_logits)
    hop_lib_equal = torch.equal(hop_logits, lib_logits)
    print(f"full-width prefill logits, hopper vs torch-ref on the card: "
          f"rel-L2 {gap['rel_l2']:.4e}, max|diff|/max|ref| {gap['rel_max']:.4e}, "
          f"argmax agreement {gap['argmax_agreement']:.2f} (limits {LOGIT_LIMITS}); "
          f"for scale, plain bf16 @ vs torch-ref: rel-L2 {lib_gap['rel_l2']:.4e}, "
          f"max {lib_gap['rel_max']:.4e}; hopper and plain bf16 @ logits "
          f"{'bitwise equal' if hop_lib_equal else 'differ'}")
    check(all(math.isfinite(v) for v in (gap["rel_l2"], gap["rel_max"])),
          "non-finite logits")
    check(gap["rel_l2"] <= LOGIT_LIMITS["rel_l2"]
          and gap["rel_max"] <= LOGIT_LIMITS["rel_max"], f"logit gap {gap}")
    check(gap["top_within_bound"], f"top token outside the bound: {gap}")

    # smoke configuration in f32: tokens on the card == plain versions on CPU
    smoke = get_config(ARCH, smoke=True)
    cpu_params = T.init_params(smoke, generator=torch.Generator().manual_seed(SEED),
                               dtype=torch.float32)
    card_params = _to(cpu_params, dev)
    sprompt = torch.randint(0, smoke.vocab, (2, 24),
                            generator=torch.Generator().manual_seed(SEED + 1),
                            dtype=torch.int32)
    kw = {"max_seq": 33, "batch": 2, "compute_dtype": "float32",
          "cache_dtype": "float32"}
    want = serve_lib.generate(cpu_params, smoke, serve_lib.ServeConfig(
        kernel_backend="torch-ref", device="cpu", **kw), sprompt, 8)
    got = serve_lib.generate(card_params, smoke, serve_lib.ServeConfig(
        kernel_backend="hopper", device="cuda", **kw), sprompt, 8)
    same = torch.equal(got.cpu(), want)
    print(f"smoke config f32, 2 x (24 + 8): tokens on the card "
          f"{'identical to' if same else 'DIFFER from'} the plain versions on the CPU")
    check(same, "smoke tokens differ")
    REPORT["parity"] = {"prefill_logits": gap, "plain_bf16_matmul_logits": lib_gap,
                        "hopper_equals_plain_bf16_matmul": hop_lib_equal,
                        "limits": LOGIT_LIMITS, "smoke_tokens_identical": same}


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def kernels_line(rows: list[dict], main: dict) -> dict:
    """The main path's GEMM work in one serve run: each shape's time at
    its main-path decision, weighted by the launches the run makes."""
    cfg = get_config(ARCH)
    totals = dict.fromkeys(("ms", "plain_ms", "library_ms"), 0.0)
    ops_ms = bytes_ms = bound_ms = 0.0
    err = 0.0
    for (k, n), per_layer in LAYER_GEMMS.items():
        for m, steps in ((BATCH * PROMPT, 1), (BATCH, GEN - 1)):
            row = next(r for r in rows if r["main_path"]
                       and (r["m"], r["k"], r["n"]) == (m, k, n))
            calls = per_layer * cfg.n_layers * steps
            for key in totals:
                totals[key] += calls * row[key]
            bound_ms += calls * row["bound_ms"]
            ops_ms += calls * 2.0 * m * k * n / PEAK_FLOPS_BF16 * 1e3
            bytes_ms += calls * (m * k + k * n + m * n) * 2 / HBM_BW * 1e3
            err = max(err, row["max_abs_err"])
    return {"name": "redas_gemm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/redas_gemm.cu",
            "replaces": "src/repro/kernels/redas_gemm.py:169",
            "launches": sum(main["launches"].values()),
            "launches_by_dataflow": main["launches"],
            "max_abs_err": err, "ms": totals["ms"],
            "plain_ms": totals["plain_ms"], "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": totals["library_ms"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_setup()
    rows = phase_kernels()
    cfg = get_config(ARCH)
    served = phase_main_path(cfg)
    phase_parity(cfg, served)
    line = kernels_line(rows, REPORT["main_path"])
    REPORT["kernels"] = [line]
    REPORT["seconds"] = time.perf_counter() - t0
    out_dir = ROOT / "runs"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(REPORT, indent=1))
    print(f"chip_smoke: all phases passed in {REPORT['seconds']:.1f} s")
    print(json.dumps({"kernels": [line]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
