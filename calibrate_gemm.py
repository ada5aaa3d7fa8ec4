"""Hold the ReDas GEMM's cost model (`engine.cost.gemm_cost`), or with
--int8 the int8 GEMM's (`engine.cost.decide_int8`), against a
calibration sweep of the card, and refit its constants.

    python3 calibrate_gemm.py [SWEEP] [--src DIR] [--fit] [--int8]

SWEEP is a JSON-lines file of `chip_smoke.py --sweep` (one line per
(shape, dataflow, tile): m, k, n, dtype, dataflow, OS's route, tile and
the measured device `us`); by default the committed
tests/data/gemm_sweep_h100.jsonl.
Runs on the CPU.  It prints, for each shape, the model's decision among
the measured configurations (each dataflow at the model's best tile for
it, then the least of those three), its time against the fastest of the
three and against the fastest configuration measured, and the model's
seconds against the measured; then the worst bf16 ratios and the log-RMS
error of the model's times.  `--src DIR` plans with the package under
DIR (another checkout's src: its model on the same sweep).

`--fit` refits OS_BLOCK_BW, STREAM_STEP_S, SM_MMA_RATE (bf16 and f32) and
REDUCE_S by least squares on log time (Nelder-Mead from the committed
values and from random restarts, scipy), over the configurations within
4x of their shape's fastest, leaving out the shapes whose M is in HOLD
(the paged prefill's, which `chip_smoke.py` phase 2 then times), and
prints the constants and the picks they make.

`--int8` reads a `chip_smoke.py --sweep-int8` file instead (one line per
(shape, configuration): m, k, n, path, split_k, tile and `us`; by
default the committed tests/data/int8_sweep_h100.jsonl) and prints, for
each shape, `decide_int8`'s pick among the measured configurations of
its path (each decode split at M <= 16, each tiled tile above) against
the fastest; with `--fit` it first refits INT8_FITTED the same way, over
every shape (none held out).
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SWEEP = ROOT / "tests" / "data" / "gemm_sweep_h100.jsonl"
#: the constants `--fit` fits: (module attribute, key), key None for a
#: scalar, else the operand bytes of SM_MMA_RATE
FITTED = (("OS_BLOCK_BW", None), ("STREAM_STEP_S", None),
          ("SM_MMA_RATE", 2), ("SM_MMA_RATE", 4), ("REDUCE_S", None))
SIZES = {"bfloat16": 2, "float32": 4}
#: the M held out of the fit: the paged prefill's (8 slots x widths 64
#: and 768)
HOLD = (512, 6144)
INT8_SWEEP = ROOT / "tests" / "data" / "int8_sweep_h100.jsonl"
#: the int8 model's constants `--int8 --fit` fits
INT8_FITTED = tuple((name, None) for name in (
    "INT8_DECODE_FIXED_S", "INT8_COMBINE_S", "INT8_WAVE_S", "INT8_SM_BW",
    "INT8_DECODE_BW", "INT8_TILE_FIXED_S", "INT8_LOAD_BW", "INT8_SM_OPS"))


def load(path: Path, redas_gemm) -> dict:
    """The sweep's rows by (m, k, n, dtype), keeping the configurations on
    the package's menus (an OS row on its route's: "sync" where a row
    names none)."""
    shapes = collections.defaultdict(list)
    for line in path.read_text().splitlines():
        row = json.loads(line)
        menu = redas_gemm.tiles_for(row["dataflow"],
                                    row.get("route") or "sync")
        if tuple(row["tile"]) in menu:
            shapes[row["m"], row["k"], row["n"], row["dtype"]].append(row)
    return dict(shapes)


def _cost(cost, m, k, n, row, size):
    return cost.gemm_cost(m, k, n, row["dataflow"], tuple(row["tile"]), size,
                          size, row.get("route"))


def picks(shapes: dict, cost) -> list[dict]:
    """The model's decision at each shape among the measured
    configurations, beside the fastest dataflow and the fastest
    configuration."""
    out = []
    for (m, k, n, dtype), rows in shapes.items():
        size = SIZES[dtype]
        model = {id(r): _cost(cost, m, k, n, r, size) for r in rows}
        rows = [r for r in rows if model[id(r)] is not None]
        best = {}
        for r in rows:
            df = r["dataflow"]
            if (df not in best or model[id(r)]["seconds"]
                    < model[id(best[df])]["seconds"]):
                best[df] = r
        pick = min(best.values(), key=lambda r: model[id(r)]["seconds"])
        out.append({
            "m": m, "k": k, "n": n, "dtype": dtype,
            "decision": [pick["dataflow"], *pick["tile"]], "us": pick["us"],
            "model_us": model[id(pick)]["seconds"] * 1e6,
            "vs_fastest_dataflow": pick["us"] / min(r["us"]
                                                   for r in best.values()),
            "vs_fastest": pick["us"] / min(r["us"] for r in rows),
            "by_dataflow": {df: [*r["tile"], r["us"]]
                            for df, r in best.items()}})
    return out


def log_errors(shapes: dict, cost, hold=()) -> list[float]:
    """log(model / measured) of every configuration within 4x of its
    shape's fastest, the shapes whose M is in `hold` left out."""
    errs = []
    for (m, k, n, dtype), rows in shapes.items():
        if m in hold:
            continue
        size, fastest = SIZES[dtype], min(r["us"] for r in rows)
        for r in rows:
            if r["us"] > 4 * fastest:
                continue
            c = _cost(cost, m, k, n, r, size)
            if c is not None:
                errs.append(math.log(c["seconds"] / (r["us"] * 1e-6)))
    return errs


def _get(cost, fitted=FITTED) -> list[float]:
    return [getattr(cost, a) if key is None else getattr(cost, a)[key]
            for a, key in fitted]


def _set(cost, values, fitted=FITTED) -> None:
    for (attr, key), v in zip(fitted, values, strict=True):
        if key is None:
            setattr(cost, attr, v)
        else:
            getattr(cost, attr)[key] = v


def fit(errors, cost, fitted=FITTED, restarts: int = 4) -> list[float]:
    """The constants `fitted` that minimise the mean squared log error
    `errors()` returns, from the committed values and `restarts` random
    starts around them."""
    import numpy as np
    from scipy.optimize import minimize

    start = np.log(_get(cost, fitted))

    def loss(x):
        _set(cost, np.exp(x), fitted)
        errs = errors()
        return sum(e * e for e in errs) / len(errs)

    rng = np.random.default_rng(0)
    best = None
    for trial in range(restarts + 1):
        x0 = start + (0 if trial == 0 else rng.normal(0, 1, len(start)))
        res = minimize(loss, x0, method="Nelder-Mead",
                       options={"maxiter": 3000, "xatol": 1e-4,
                                "fatol": 1e-8})
        if best is None or res.fun < best.fun:
            best = res
    values = [float(v) for v in np.exp(best.x)]
    _set(cost, values, fitted)
    return values


def int8_load(path: Path) -> dict:
    """The int8 sweep's rows by (m, k, n)."""
    shapes = collections.defaultdict(list)
    for line in path.read_text().splitlines():
        row = json.loads(line)
        shapes[row["m"], row["k"], row["n"]].append(row)
    return dict(shapes)


def int8_seconds(cost, row) -> float:
    """`decide_int8`'s model of one measured configuration."""
    m, k, n = row["m"], row["k"], row["n"]
    if row["path"] == "decode":
        return cost.int8_decode_cost(m, k, n, row["split_k"])["seconds"]
    return cost.int8_tiled_cost(m, k, n, tuple(row["tile"]))["seconds"]


def int8_picks(shapes: dict, cost) -> list[dict]:
    """The model's pick at each shape among the measured configurations,
    against the fastest of them."""
    out = []
    for (m, k, n), rows in shapes.items():
        pick = min(rows, key=lambda r: int8_seconds(cost, r))
        out.append({"m": m, "k": k, "n": n, "path": pick["path"],
                    "decision": pick["split_k"] if pick["path"] == "decode"
                    else pick["tile"], "us": pick["us"],
                    "model_us": int8_seconds(cost, pick) * 1e6,
                    "vs_fastest": pick["us"] / min(r["us"] for r in rows)})
    return out


def int8_log_errors(shapes: dict, cost) -> list[float]:
    """log(model / measured) of every configuration within 4x of its
    shape's fastest."""
    errs = []
    for rows in shapes.values():
        fastest = min(r["us"] for r in rows)
        errs += [math.log(int8_seconds(cost, r) / (r["us"] * 1e-6))
                 for r in rows if r["us"] <= 4 * fastest]
    return errs


def int8_report(shapes: dict, cost) -> None:
    rows = int8_picks(shapes, cost)
    for p in rows:
        print(f"{p['m']:5d} x {p['k']:5d} x {p['n']:5d} {p['path']} "
              f"{p['decision']}: {p['us']:.2f} us (model "
              f"{p['model_us']:.2f}), {p['vs_fastest']:.3f}x the fastest")
    errs = int8_log_errors(shapes, cost)
    print(f"worst: {max(p['vs_fastest'] for p in rows):.3f}x the fastest "
          f"over {len(rows)} shapes; log-RMS error of the model's times "
          f"{math.sqrt(sum(e * e for e in errs) / len(errs)):.3f} over "
          f"{len(errs)} configurations within 4x of their shape's fastest")
    print(json.dumps({"picks": rows}))


def report(shapes: dict, cost, hold) -> None:
    rows = picks(shapes, cost)
    for p in rows:
        print(f"{p['m']:5d} x {p['k']:5d} x {p['n']:5d} {p['dtype']:8s} "
              f"{'held out ' if p['m'] in hold else ''}decision "
              f"{p['decision']} {p['us']:.2f} us (model {p['model_us']:.2f}):"
              f" {p['vs_fastest_dataflow']:.3f}x the fastest dataflow, "
              f"{p['vs_fastest']:.3f}x the fastest configuration; "
              f"{p['by_dataflow']}")
    bf16 = [p for p in rows if p["dtype"] == "bfloat16"]
    errs = log_errors(shapes, cost)
    print(f"bf16 worst: {max(p['vs_fastest_dataflow'] for p in bf16):.3f}x "
          f"the fastest dataflow, {max(p['vs_fastest'] for p in bf16):.3f}x "
          f"the fastest configuration, over {len(bf16)} shapes; log-RMS "
          f"error of the model's times {math.sqrt(sum(e * e for e in errs) / len(errs)):.3f} "
          f"over {len(errs)} configurations within 4x of their shape's "
          f"fastest")
    print(json.dumps({"picks": rows}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sweep", nargs="?")
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--fit", action="store_true")
    ap.add_argument("--int8", action="store_true",
                    help="the int8 GEMM's model and sweep")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    from repro_torch.engine import cost
    from repro_torch.kernels import redas_gemm

    if args.int8:
        shapes = int8_load(Path(args.sweep or INT8_SWEEP))
        if args.fit:
            values = fit(lambda: int8_log_errors(shapes, cost), cost,
                         INT8_FITTED)
            print("fitted:", {a: f"{v:.3g}" for (a, _), v in
                              zip(INT8_FITTED, values, strict=True)})
        int8_report(shapes, cost)
        return 0
    shapes = load(Path(args.sweep or SWEEP), redas_gemm)
    if args.fit:
        values = fit(lambda: log_errors(shapes, cost, HOLD), cost)
        print("fitted, M in", HOLD, "held out:",
              {f"{a}[{k}]" if k else a: f"{v:.3g}"
               for (a, k), v in zip(FITTED, values, strict=True)})
    report(shapes, cost, HOLD)
    return 0


if __name__ == "__main__":
    sys.exit(main())
