"""HopperModel: the ReDas decision surface on one H100 (the port of
`repro/engine/cost.py::TPUModel._decide_gemm` and the primitives of
`repro/core/tpu_model.py`).

A `gemm` request at in_bytes 2 or 4 (the float ReDas GEMM) is planned by
`decide_gemm` over OS's tile menu (that of the OS route the request's
width and shape take, `redas_gemm.shape_route`: the wgmma kernel's for
bf16 that TMA can describe, else the sync kernel's) and WS/IS's streaming
menu with `gemm_cost`, a wave term: each (dataflow, tile) launches a grid
of blocks (OS gm x gn; WS gn x slabs x groups; IS gm x slabs x groups)
that runs in waves of the blocks the card holds, each block walking its
steps one after another.  Its five constants are fitted to a committed
chip sweep (`calibrate_gemm.py`).  WS and IS count their own bytes
(`stream_traffic`), with the K slabs' f32 workspace and the reduction
where K spans more than one slab; the decision's `meta` carries `slabs`
and `groups`.  There is no MXU ramp term: nothing on this card fills and
drains like a systolic array's pipeline.  A bf16 `grouped_gemm` request
whose (D, F) TMA can describe runs on the same ring, so `decide_grouped`
plans it with `gemm_cost` too, the grid and bytes times the experts.

Every other request keeps the roofline of the reference's search,

    t = max(padded FLOPs / peak, dataflow bytes / HBM bandwidth)

with the dataflow traffic formula of `core/tpu_model.hbm_traffic`
(`choose_tile`, `estimate`), pinned to OS on its kernel's menu.  A
`gemm` or `gemm_w8` request keyed at in_bytes == 1 (every request of an
int8 backend) is planned by `decide_int8` on the int8 kernel's two paths,
each output element summed on chip as the JAX package's OS int8 kernel
sums it: at M <= 16 the decode path, its K split by a wave term over the
card's SMs (`int8_decode_cost`), above it the tiled path, its tile by a
wave term (`int8_tiled_cost`).  A
`gemm_sparse` request at M above the sparse kernel's decode rows is
planned as the JAX package's `_decide_gemm_sparse` plans it: at K_eff =
density x K, plus one index byte per kept value, on the kernel's tiled
menu; at decode M it takes the kernel's split-K decode path, split by a
wave term over the card's SMs.  A `gemm_sparse` request keyed at
in_bytes 1 is sparse x int8 storage under float activations (the JAX
package's key): its values move at 1 byte, while A streams, sits in
shared memory and is multiplied at the compute width, its `out_bytes`.

`AnalyticalCostModel` is the other plane: the paper's mapper
(`core.mapper.ReDasMapper` over the Eq. 3-5 `core.analytical_model`)
as a cost model, whose decisions carry the ASIC mapping in their `meta`
and execute on the `simulator` backend (`Engine` resolves to it).  Both
satisfy the `CostModel` protocol.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Protocol, runtime_checkable

from ..core.accelerators import REDAS
from ..core.analytical_model import GEMM, MappingConfig
from ..core.dataflow import Dataflow, LogicalShape
from ..core.mapper import ReDasMapper
from ..kernels import (flash_attention, grouped_gemm, quant_gemm, redas_gemm,
                       sparse_gemm)
from ..kernels.redas_gemm import DATAFLOWS, SMEM_LIMIT, smem_bytes
from .plan import KernelDecision, KernelRequest

# H100 SXM data-sheet peaks (NVIDIA; dense, at the 700 W power limit).
PEAK_OPS_INT8 = 1979e12      # tensor cores, int8 (dense)
PEAK_FLOPS_BF16 = 989e12     # tensor cores, bf16
PEAK_FLOPS_F32 = 67e12       # FP32 outside the tensor cores (no TF32)
HBM_BW = 3.35e12             # bytes / s


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class TileConfig:
    dataflow: str  # "os" | "ws" | "is"
    bm: int
    bk: int
    bn: int


def hbm_traffic(m: int, k: int, n: int, cfg: TileConfig,
                in_bytes: int = 2, out_bytes: int = 2,
                b_bytes: int | None = None) -> float:
    """Device-memory bytes the dataflow moves on padded dims (the formula
    of `core/tpu_model.hbm_traffic`); B at `b_bytes`, A's `in_bytes` by
    default."""
    mp, kp, np_ = _round_up(m, cfg.bm), _round_up(k, cfg.bk), _round_up(n, cfg.bn)
    gm, gk, gn = mp // cfg.bm, kp // cfg.bk, np_ // cfg.bn
    a, o = mp * kp * in_bytes, mp * np_ * out_bytes
    b = kp * np_ * (b_bytes or in_bytes)
    if cfg.dataflow == "os":
        return a * gn + b * gm + o
    acc = mp * np_ * 4  # f32 partial-sum stream
    if cfg.dataflow == "ws":
        return a * gn + b + acc * (2 * gk - 1) + o
    if cfg.dataflow == "is":
        return a + b * gm + acc * (2 * gk - 1) + o
    raise ValueError(cfg.dataflow)


def peak_flops(in_bytes: int) -> float:
    if in_bytes == 1:
        return PEAK_OPS_INT8
    return PEAK_FLOPS_BF16 if in_bytes <= 2 else PEAK_FLOPS_F32


def estimate(m: int, k: int, n: int, cfg: TileConfig, in_bytes: int = 2,
             out_bytes: int = 2,
             b_bytes: int | None = None) -> tuple[float, float, float]:
    """(seconds, hbm bytes, padding efficiency) of one call, at the peak
    of A's width `in_bytes` (B at `b_bytes`, A's width by default)."""
    mp, kp, np_ = _round_up(m, cfg.bm), _round_up(k, cfg.bk), _round_up(n, cfg.bn)
    padded = 2.0 * mp * kp * np_
    bytes_ = hbm_traffic(m, k, n, cfg, in_bytes, out_bytes, b_bytes)
    seconds = max(padded / peak_flops(in_bytes), bytes_ / HBM_BW)
    return seconds, bytes_, 2.0 * m * k * n / padded


def _tile_smem(bm: int, bk: int, bn: int, in_bytes: int) -> int:
    """Shared memory of one block of the kernel a request at `in_bytes`
    runs on: the int8 kernel at 1 byte, the ReDas GEMM's OS tile layout
    otherwise (the grouped kernel shares it)."""
    if in_bytes == 1:
        return quant_gemm.smem_bytes(bm, bk, bn)
    return smem_bytes(bm, bk, bn, in_bytes)


def choose_tile(m: int, k: int, n: int, in_bytes: int = 2,
                out_bytes: int = 2, dataflows=("os",), *, tiles,
                smem=_tile_smem, b_bytes: int | None = None) -> TileConfig:
    """The least-`estimate` legal (dataflow, tile) for one GEMM shape
    among `tiles` (the grouped, int8 or sparse kernel's menu), a tile
    being legal when `smem(bm, bk, bn, in_bytes)` fits a block's shared
    memory.  The float ReDas GEMM is planned by `decide_gemm` instead."""
    best, best_t = None, math.inf
    for bm, bk, bn in tiles:
        if smem(bm, bk, bn, in_bytes) > SMEM_LIMIT:
            continue
        for df in dataflows:
            cfg = TileConfig(df, bm, bk, bn)
            t = estimate(m, k, n, cfg, in_bytes, out_bytes, b_bytes)[0]
            if t < best_t:
                best, best_t = cfg, t
    if best is None:
        raise ValueError(f"no tile of {tiles} fits {SMEM_LIMIT} bytes of "
                         f"shared memory at {in_bytes}-byte operands")
    return best


#: the paged decision's blocks (query rows and keys a step); the paged
#: kernel plans its own cluster, so they are planned but shape nothing
ATTENTION_BLOCK = 64


def decide_attention(request: KernelRequest, name: str) -> KernelDecision:
    """The flash roofline of `repro/engine/cost.py::_decide_attention`
    with the H100's peaks: q/k/v/o traffic only (the online-softmax state
    stays on chip).  m = Sq, n = Sk (or the page span), k = head dim,
    groups = batch x heads.  For the `attention` op the blocks are the
    tile of the flash route the request's width and head dim take
    (`flash_attention.shape_route`: the planner sees no pointers): bm the
    query rows a CTA, bn the keys a step; `meta` names the route.  For
    `paged_attention` they are ATTENTION_BLOCK cut to the sequence."""
    sq, sk, d, bh = request.m, request.n, request.k, request.groups
    flops = 4.0 * bh * sq * sk * d            # QK^T + PV
    hbm = request.in_bytes * bh * d * (2 * sq + 2 * sk)
    seconds = max(flops / peak_flops(request.in_bytes), hbm / HBM_BW)
    meta = {"hbm_bytes": float(hbm), "groups": bh}
    if request.op == "attention":
        route = flash_attention.shape_route(request.in_bytes, d)
        bm, bn = flash_attention.route_tile(route, d)
        meta["route"] = route
    else:
        bm, bn = min(ATTENTION_BLOCK, sq), min(ATTENTION_BLOCK, sk)
    return KernelDecision(
        op=request.op, dataflow="os", bm=bm, bk=d, bn=bn, cost_model=name,
        seconds=seconds, meta=tuple(sorted(meta.items())))


def decide_grouped(request: KernelRequest, name: str) -> KernelDecision:
    """The port of `TPUModel._decide_grouped`: the grouped kernel is OS
    (the accumulator stays on chip over the D sweep), so the search is
    pinned to OS, on one expert's (C, D, F) problem, over the menu of the
    route the request's width and (D, F) take (`redas_gemm.shape_route`:
    the planner sees no pointers).  On the wgmma route the call is
    `gemm_cost`'s wave term over `grouped_gemm.WGMMA_TILES` with the grid
    and the bytes multiplied by the expert count (`groups`); on the sync
    route, and at in_bytes == 1 (the int8 kernel's menu, where the
    experts loop through it), the roofline `choose_tile`, gated by shared
    memory, costing that expert's time x the expert count.  `meta`
    carries `groups` (the experts), and on the wgmma route the route and
    the wave term's blocks, fill and bytes."""
    e, c, d, f = request.groups, request.m, request.k, request.n
    route = redas_gemm.shape_route(request.in_bytes, d, f)
    if route == "wgmma":
        best, tile = None, None
        for t in grouped_gemm.WGMMA_TILES:
            cost = gemm_cost(c, d, f, "os", t, request.in_bytes,
                             request.out_bytes, route, batch=e)
            if cost is not None and (best is None
                                     or cost["seconds"] < best["seconds"]):
                best, tile = cost, t
        meta = {key: best[key] for key in ("hbm_bytes", "blocks", "fill",
                                           "smem_bytes")}
        return KernelDecision(
            op=request.op, dataflow="os", bm=tile[0], bk=tile[1], bn=tile[2],
            cost_model=name, seconds=best["seconds"],
            meta=tuple(sorted({**meta, "groups": e,
                               "route": route}.items())))
    tiles = quant_gemm.TILES if request.in_bytes == 1 else grouped_gemm.TILES
    cfg = choose_tile(c, d, f, request.in_bytes, request.out_bytes,
                      dataflows=("os",), tiles=tiles)
    seconds = estimate(c, d, f, cfg, request.in_bytes, request.out_bytes)[0]
    return KernelDecision(
        op=request.op, dataflow="os", bm=cfg.bm, bk=cfg.bk, bn=cfg.bn,
        cost_model=name, seconds=seconds * e,
        meta=tuple(sorted({
            "groups": e,
            "smem_bytes": _tile_smem(cfg.bm, cfg.bk, cfg.bn,
                                     request.in_bytes)}.items())))


#: the decode path's wave term: the card's SMs, the decode blocks one SM
#: holds at once (128 threads at 90-235 registers), and the compressed
#: rows each split keeps at least (8 for each of a block's 4 warps: one
#: pair of its register stages)
SMS = redas_gemm.SMS
DECODE_BLOCKS_PER_SM = 2
DECODE_MIN_ROWS = 32


def sparse_widths(request: KernelRequest) -> tuple[int, int]:
    """(A's bytes, the values' bytes) of a `gemm_sparse` request: both
    `in_bytes` for float storage; at in_bytes 1 (sparse x int8 storage,
    the JAX package's key) int8 values under activations of the compute
    width `out_bytes`."""
    if request.in_bytes == 1:
        return request.out_bytes, 1
    return request.in_bytes, request.in_bytes


def decode_cost(request: KernelRequest, split_k: int) -> dict:
    """The sparse kernel's decode path at `split_k`: the compressed
    weight (values and one index byte per kept value) and the activations
    stream at the HBM rate times the share of the card the grid fills
    (the wave term), the f32 workspace is written and read back at the
    full rate, and the multiply-adds of the padded rows run on FFMA."""
    m, k, n = request.m, request.k, request.n
    a_bytes, v_bytes = sparse_widths(request)
    k_eff = max(1, round(k * request.density))
    rows = sparse_gemm.decode_rows(m)
    tiles = -(-n // sparse_gemm.decode_columns(v_bytes))
    fill = min(1.0, tiles * split_k / (SMS * DECODE_BLOCKS_PER_SM))
    streamed = k_eff * n * (v_bytes + 1) + m * k * a_bytes
    workspace = 2 * split_k * m * n * 4 if split_k > 1 else 0
    written = m * n * request.out_bytes
    seconds = max(2.0 * rows * k_eff * n / PEAK_FLOPS_F32,
                  streamed / (HBM_BW * fill) + (workspace + written) / HBM_BW)
    return {"seconds": seconds, "hbm_bytes": float(streamed + workspace
                                                   + written),
            "workspace_bytes": workspace, "blocks": tiles * split_k,
            "rows": rows, "k_effective": k_eff}


def decide_sparse(request: KernelRequest, name: str) -> KernelDecision:
    """The port of `TPUModel._decide_gemm_sparse`, with the path: the
    sparse kernel's decode path up to its largest row bucket, the tiled
    path above it.

    Decode: `split_k` is the least-cost split (`decode_cost`, the first
    of equals) from 1 to K_eff / `DECODE_MIN_ROWS`; the decision's (bm,
    bk, bn) are informational (the row bucket, the dense K of a split,
    the block's columns).  Tiled: the effective-FLOPs roofline of N:M
    weight sparsity, searched at K_eff = density x K plus one int8 index
    byte per kept value, pinned to OS over the tiled menu, gated by that
    kernel's one-stage shared memory at a full chunk (every spec fits);
    `stages` says whether the density's chunk keeps a second stage.  Both
    paths count A and the values at `sparse_widths`.  `meta` carries the
    path and `split_k`, so they survive the plan's JSON."""
    m, k, n = request.m, request.k, request.n
    a_bytes, v_bytes = sparse_widths(request)
    k_eff = max(1, round(k * request.density))
    if m <= sparse_gemm.DECODE_ROWS[-1]:
        top = min(max(1, k_eff // DECODE_MIN_ROWS), sparse_gemm.SPLIT_LIMIT)
        costs = [decode_cost(request, s) for s in range(1, top + 1)]
        split_k = min(range(len(costs)),
                      key=lambda i: costs[i]["seconds"]) + 1
        best = costs[split_k - 1]
        return KernelDecision(
            op=request.op, dataflow="os", bm=best["rows"],
            bk=-(-k // split_k),
            bn=sparse_gemm.decode_columns(v_bytes),
            cost_model=name, seconds=best["seconds"],
            meta=tuple(sorted({
                "path": "decode", "split_k": split_k,
                "density": request.density,
                **{key: best[key] for key in ("hbm_bytes", "workspace_bytes",
                                              "blocks", "k_effective")},
            }.items())))
    smem = functools.partial(sparse_gemm.smem_bytes, value_bytes=v_bytes)
    cfg = choose_tile(m, k_eff, n, a_bytes, request.out_bytes,
                      dataflows=("os",), tiles=sparse_gemm.TILES, smem=smem,
                      b_bytes=v_bytes)
    seconds, bytes_, pad_eff = estimate(m, k_eff, n, cfg, a_bytes,
                                        request.out_bytes, v_bytes)
    idx_bytes = float(k_eff * n)
    # a chunk's compressed rows: (bk // M) * N <= bk x density
    rows = math.floor(cfg.bk * request.density + 1e-9)
    stages = (2 if smem(cfg.bm, cfg.bk, cfg.bn, a_bytes, rows, 2)
              <= SMEM_LIMIT else 1)
    return KernelDecision(
        op=request.op, dataflow="os", bm=cfg.bm, bk=cfg.bk, bn=cfg.bn,
        cost_model=name, seconds=seconds + idx_bytes / HBM_BW,
        meta=tuple(sorted({
            "path": "tiled", "split_k": 1, "stages": stages,
            "hbm_bytes": bytes_ + idx_bytes, "padding_efficiency": pad_eff,
            "density": request.density, "k_effective": k_eff,
            "smem_bytes": smem(cfg.bm, cfg.bk, cfg.bn, a_bytes, rows,
                               stages)}.items())))


#: `gemm_cost`'s constants, fitted by `calibrate_gemm.py --fit` to the
#: calibration sweep in tests/data/gemm_sweep_h100.jsonl (`chip_smoke.py
#: --sweep`: every (dataflow, tile) at 38 shapes, NVIDIA H100 80GB HBM3,
#: 700 W), the paged prefill's M = 512 and 6144 held out of the fit:
#: the rate one SM's OS blocks land their operand tiles in shared memory
#: at (the wgmma kernel's TMA ring; the sync kernel's synchronous loads),
#: one pipeline step of a streaming block (a SUB_K-deep sub-chunk: wait
#: for its loads, barrier, issue the next, the math), the operations one
#: SM's resident blocks reach together on the WMMA/FFMA kernels (bf16 on
#: WMMA from shared memory, f32 on FFMA; the wgmma kernel's are the data
#: sheet's peak), and a reduction's cost beside the workspace's bytes
#: (its launch)
OS_BLOCK_BW = 7.02e10
STREAM_STEP_S = 1.08e-6
SM_MMA_RATE = {2: 7.48e11, 4: 1.47e11}
REDUCE_S = 4.92e-6
#: an SM's registers, and the WMMA/FFMA kernels' threads a block
SM_REGISTERS = 65536
BLOCK_THREADS = 128


def resident_blocks(dataflow: str, tile: tuple[int, int, int],
                    in_bytes: int, route: str = "sync") -> int:
    """Blocks of the tile one SM holds at once: its shared memory
    (`redas_gemm.blocks_per_sm`), its threads and its registers, a
    thread's taken as 32 plus its share of the f32 accumulator tile (bm x
    bn over 128 threads for the sync OS kernel, over 64 for WS/IS, whose
    fragments double it; the wgmma kernel's consumer threads hold bn / 2
    each and its producer warp as many), at most 255."""
    bm, bk, bn = tile
    if dataflow == "os" and route == "wgmma":
        threads = redas_gemm.wgmma_threads(bm)
        regs = min(255, 32 + bn // 2)
    else:
        threads = BLOCK_THREADS
        regs = min(255, 32 + bm * bn // (128 if dataflow == "os" else 64))
    smem = redas_gemm.tile_smem(dataflow, bm, bk, bn, in_bytes, route)
    return max(1, min(redas_gemm.blocks_per_sm(smem),
                      redas_gemm.MAX_BLOCKS_PER_SM * BLOCK_THREADS // threads,
                      SM_REGISTERS // (threads * regs)))


def stream_traffic(m: int, k: int, n: int, dataflow: str,
                   tile: tuple[int, int, int], groups: int, in_bytes: int,
                   out_bytes: int) -> dict:
    """Device-memory bytes of the WS/IS kernel (the port's own count; the
    reference's formula is `hbm_traffic`): `streamed` are the operand
    reads — WS reads A once per n-tile and each weight slab once per
    group, IS the mirror — at the real (masked) dims; `workspace` the
    f32 partials written and read back when K spans more than one slab;
    `written` the output (by the kernel, or by the reduction)."""
    fixed, slabs, n_groups = redas_gemm.grid(dataflow, m, k, n, tile, groups)
    a, b = m * k * in_bytes, k * n * in_bytes
    streamed = a * fixed + b * n_groups if dataflow == "ws" else (
        a * n_groups + b * fixed)
    return {"streamed": streamed,
            "workspace": 2 * slabs * m * n * 4 if slabs > 1 else 0,
            "written": m * n * out_bytes}


def gemm_cost(m: int, k: int, n: int, dataflow: str,
              tile: tuple[int, int, int], in_bytes: int = 2,
              out_bytes: int = 2, route: str | None = None,
              batch: int = 1) -> dict | None:
    """The float ReDas GEMM's time at one (dataflow, tile), or None when a
    block does not fit shared memory or the tile is not on the menu of the
    kernel the call runs on (OS: `route`, by default the request's
    `redas_gemm.shape_route`).  OS also takes `batch` independent (m, k,
    n) problems in one launch (the grouped GEMM's experts, whose wgmma
    route runs this ring): the grid's blocks and the bytes are `batch`
    times one problem's.

    The wave term: the grid's blocks run in waves of the blocks the card
    holds (132 SMs x `resident_blocks`), and the busiest SM's blocks
    (`shared`, at most what it holds) split its load and operation rates.
    A block walks its steps one after another:
      OS: ceil(K / bk) steps, each loading (bm + bn) x bk operand elements
          at OS_BLOCK_BW and multiplying them, at the data sheet's peak
          on the wgmma kernel, at SM_MMA_RATE on the sync kernel.  The
          wgmma kernel's ring overlaps the two, so a step is the longer,
          and at least one load's latency (STREAM_STEP_S) over the ring's
          WGMMA_STAGES loads in flight, plus the ring's fill (one load's
          latency) before the first; t = max(waves x the block's time,
          each operand read once and the output written once / HBM: the
          L2 serves the tiles' re-reads).  The sync kernel's chunk is a
          ring of one stage, its load then its math; t = max(waves x the
          block's time, the reference's `hbm_traffic` / HBM);
      WS/IS: the group's swept tiles x the slab's SUB_K-deep sub-chunks,
          each at least STREAM_STEP_S; t = max(waves x steps x step,
          `stream_traffic`'s operand reads / HBM), plus the output and
          (slabs > 1) the workspace at the HBM rate and REDUCE_S."""
    bm, bk, bn = tile
    if batch != 1 and dataflow != "os":
        raise ValueError(f"only OS runs a batch of problems, not {dataflow}")
    if dataflow == "os" and route is None:
        route = redas_gemm.shape_route(in_bytes, k, n)
    if tile not in redas_gemm.tiles_for(dataflow, route or "sync"):
        return None
    smem = redas_gemm.tile_smem(dataflow, bm, bk, bn, in_bytes,
                                route or "sync")
    if smem > SMEM_LIMIT:
        return None
    groups = redas_gemm.groups_for(dataflow, m, k, n, tile, in_bytes, SMS)
    fixed, slabs, n_groups = redas_gemm.grid(dataflow, m, k, n, tile, groups)
    blocks = fixed * slabs * n_groups * batch
    if dataflow == "os":
        slabs = 1
    per_sm = resident_blocks(dataflow, tile, in_bytes, route or "sync")
    waves = -(-blocks // (SMS * per_sm))
    shared = min(per_sm, -(-blocks // SMS))
    rate = SM_MMA_RATE[in_bytes]
    mp, kp, np_ = _round_up(m, bm), _round_up(k, bk), _round_up(n, bn)
    padded = 2.0 * mp * kp * np_
    workspace = 0
    if dataflow == "os":
        load = shared * (bm + bn) * bk * in_bytes / OS_BLOCK_BW
        ops = shared * 2.0 * bm * bn * bk
        if route == "wgmma":
            block = STREAM_STEP_S + -(-k // bk) * max(
                load, ops / (PEAK_FLOPS_BF16 / SMS),
                STREAM_STEP_S / redas_gemm.WGMMA_STAGES)
            # each operand read once: the L2 serves the tiles' re-reads
            bytes_ = batch * ((m * k + k * n) * in_bytes + m * n * out_bytes)
        else:
            block = -(-k // bk) * (load + ops / rate)
            bytes_ = batch * hbm_traffic(m, k, n,
                                         TileConfig("os", bm, bk, bn),
                                         in_bytes, out_bytes)
        seconds = max(waves * block, bytes_ / HBM_BW)
    else:
        traffic = stream_traffic(m, k, n, dataflow, tile, groups, in_bytes,
                                 out_bytes)
        workspace = traffic["workspace"]
        bytes_ = traffic["streamed"] + workspace + traffic["written"]
        swept = -(-m // bm) if dataflow == "ws" else -(-n // bn)
        steps = -(-swept // n_groups) * -(-min(k, bk) // redas_gemm.SUB_K)
        step = max(STREAM_STEP_S,
                   shared * 2.0 * bm * bn * redas_gemm.SUB_K / rate)
        seconds = (max(waves * steps * step, traffic["streamed"] / HBM_BW)
                   + (workspace + traffic["written"]) / HBM_BW
                   + (REDUCE_S if slabs > 1 else 0.0))
    cost = {"seconds": seconds, "hbm_bytes": float(bytes_),
            "padding_efficiency": 2.0 * m * k * n / padded,
            "smem_bytes": smem, "slabs": slabs, "groups": groups,
            "blocks": blocks, "fill": min(1.0, blocks / (SMS * per_sm)),
            "workspace_bytes": workspace}
    if route:
        cost["route"] = route
    return cost


def decide_gemm(request: KernelRequest, name: str, dataflows=DATAFLOWS,
                route: str | None = None) -> KernelDecision:
    """The least-`gemm_cost` (dataflow, tile) of a float `gemm` request
    over each dataflow's menu (OS the menu of `route`, by default the
    request's `redas_gemm.shape_route`; WS/IS `STREAM_TILES`), the first
    of equals in menu order; `meta` carries the cost's terms, so a plan's
    JSON keeps `slabs` and `groups` (and OS its route)."""
    route = route or redas_gemm.shape_route(request.in_bytes, request.k,
                                            request.n)
    best, best_cfg = None, None
    for df in dataflows:
        for tile in redas_gemm.tiles_for(df, route):
            cost = gemm_cost(request.m, request.k, request.n, df, tile,
                             request.in_bytes, request.out_bytes,
                             route if df == "os" else None)
            if cost is not None and (best is None
                                     or cost["seconds"] < best["seconds"]):
                best, best_cfg = cost, (df, tile)
    if best is None:
        raise ValueError(f"no tile of {dataflows} fits {SMEM_LIMIT} bytes "
                         f"of shared memory at {request.in_bytes}-byte "
                         f"operands")
    df, (bm, bk, bn) = best_cfg
    return KernelDecision(
        op=request.op, dataflow=df, bm=bm, bk=bk, bn=bn, cost_model=name,
        seconds=best["seconds"],
        meta=tuple(sorted((key, val) for key, val in best.items()
                          if key != "seconds")))


#: the int8 kernel's wave terms (csrc/quant_gemm.cu), fitted by
#: `calibrate_gemm.py --int8 --fit` (log-error least squares) to its
#: times at every decode split (M = 1, 4, 8, 16) and tiled tile (M = 17,
#: 33, 512, 2048, 6144) at qwen2-1.5b's (K, N) in the committed sweep
#: tests/data/int8_sweep_h100.jsonl (`chip_smoke.py --sweep-int8`, NVIDIA
#: H100 80GB HBM3, 700 W).  Decode: a
#: launch's fixed time (the activation rows, the first slice's latency,
#: the cluster barriers), the combine's time for each rank past one, each
#: wave of blocks past the first, the rate one SM's decode blocks read
#: the weight at, and the rate the card reaches on this path with every SM
#: busy.  Tiled: a block's fixed time (its ring's fill, the epilogue), the
#: rate one SM's blocks land operand chunks in shared memory, and the
#: int8 operations one SM's blocks reach on mma.sync.
INT8_DECODE_FIXED_S = 2.92e-6
INT8_COMBINE_S = 1.14e-7
INT8_WAVE_S = 3.89e-6
INT8_SM_BW = 2.58e10
INT8_DECODE_BW = 2.3e12
INT8_TILE_FIXED_S = 7.59e-6
INT8_LOAD_BW = 4.97e10
INT8_SM_OPS = 2.89e12


def int8_decode_cost(m: int, k: int, n: int, split_k: int) -> dict | None:
    """The int8 kernel's decode path at `split_k`, or None when a block
    does not fit shared memory.  The grid's tiles x split_k blocks run in
    waves of the blocks the card holds; the busiest SM reads its blocks'
    weight slices at INT8_SM_BW, and the whole call (weight, activations,
    int32 output) streams at INT8_DECODE_BW times the share of the SMs
    the grid keeps busy; the longer of the two, plus the launch's fixed
    time, each wave past the first and each rank past one."""
    smem = quant_gemm.decode_smem_bytes(m, k, split_k)
    if smem > SMEM_LIMIT:
        return None
    tiles = -(-n // quant_gemm.DECODE_BN)
    blocks = tiles * split_k
    per_sm = redas_gemm.blocks_per_sm(smem)
    waves = -(-blocks // (SMS * per_sm))
    busiest = -(-min(blocks, SMS * per_sm) // SMS)
    base, extra = quant_gemm.split_slices(k, split_k)
    block_bytes = ((base + (extra > 0)) * quant_gemm.DECODE_SLICE
                   * quant_gemm.DECODE_BN)
    bytes_ = k * n + m * k + 4 * m * n
    fill = min(1.0, blocks / SMS)
    seconds = (INT8_DECODE_FIXED_S + INT8_COMBINE_S * (split_k - 1)
               + INT8_WAVE_S * (waves - 1)
               + max(busiest * block_bytes / INT8_SM_BW,
                     bytes_ / (INT8_DECODE_BW * fill)))
    return {"seconds": seconds, "hbm_bytes": float(bytes_), "blocks": blocks,
            "fill": fill, "smem_bytes": smem}


def int8_resident(tile: tuple[int, int, int]) -> int:
    """Tiled blocks one SM holds: its shared memory, and its registers at
    a thread's 80 plus its share of the int32 accumulator tile (bm x bn
    over 128 threads)."""
    bm, bk, bn = tile
    regs = min(255, 80 + bm * bn // BLOCK_THREADS)
    return max(1, min(redas_gemm.blocks_per_sm(quant_gemm.smem_bytes(*tile)),
                      SM_REGISTERS // (BLOCK_THREADS * regs)))


def int8_tiled_cost(m: int, k: int, n: int,
                    tile: tuple[int, int, int]) -> dict:
    """The int8 kernel's tiled path at `tile`: the grid's blocks run in
    waves of the blocks the card holds (`int8_resident`), the busiest
    SM's blocks sharing its load and operation rates; a block walks
    ceil(K / bk) ring chunks, each the longer of its loads and its
    operations (the ring overlaps the two), after INT8_TILE_FIXED_S; at
    least each operand read once and the output written once at the HBM
    rate."""
    bm, bk, bn = tile
    blocks = -(-m // bm) * -(-n // bn)
    per_sm = int8_resident(tile)
    waves = -(-blocks // (SMS * per_sm))
    shared = min(per_sm, -(-blocks // SMS))
    step = max(shared * (bm + bn) * bk / INT8_LOAD_BW,
               shared * 2.0 * bm * bn * bk / INT8_SM_OPS)
    block = INT8_TILE_FIXED_S + -(-k // bk) * step
    bytes_ = m * k + k * n + 4 * m * n
    padded = 2.0 * _round_up(m, bm) * _round_up(k, bk) * _round_up(n, bn)
    return {"seconds": max(waves * block, bytes_ / HBM_BW),
            "hbm_bytes": float(bytes_), "blocks": blocks,
            "fill": min(1.0, blocks / (SMS * per_sm)),
            "smem_bytes": quant_gemm.smem_bytes(*tile),
            "padding_efficiency": 2.0 * m * k * n / padded}


def decide_int8(request: KernelRequest, name: str) -> KernelDecision:
    """A `gemm` or `gemm_w8` request at in_bytes 1 on the int8 kernel:
    the decode path up to its largest row bucket, `split_k` the
    least-`int8_decode_cost` split from 1 to DECODE_MAX_SPLIT (the first
    of equals; the decision's (bm, bk, bn) are informational: the row
    bucket, the K rows of the largest split, the block's columns); the
    tiled path above it, the least-`int8_tiled_cost` tile of the menu.
    `meta` carries the path and `split_k`, so they survive the plan's
    JSON."""
    m, k, n = request.m, request.k, request.n
    if m <= quant_gemm.DECODE_ROWS[-1]:
        best, split_k = None, None
        for s in range(1, quant_gemm.DECODE_MAX_SPLIT + 1):
            cost = int8_decode_cost(m, k, n, s)
            if cost is not None and (best is None
                                     or cost["seconds"] < best["seconds"]):
                best, split_k = cost, s
        if best is None:
            raise ValueError(f"no decode split of K = {k} fits {SMEM_LIMIT} "
                             f"bytes of shared memory")
        base, extra = quant_gemm.split_slices(k, split_k)
        return KernelDecision(
            op=request.op, dataflow="os", bm=quant_gemm.decode_rows(m),
            bk=(base + (extra > 0)) * quant_gemm.DECODE_SLICE,
            bn=quant_gemm.DECODE_BN, cost_model=name,
            seconds=best["seconds"],
            meta=tuple(sorted({
                "path": "decode", "split_k": split_k,
                **{key: best[key] for key in ("hbm_bytes", "blocks", "fill",
                                              "smem_bytes")}}.items())))
    best, tile = None, None
    for t in quant_gemm.TILES:
        cost = int8_tiled_cost(m, k, n, t)
        if best is None or cost["seconds"] < best["seconds"]:
            best, tile = cost, t
    return KernelDecision(
        op=request.op, dataflow="os", bm=tile[0], bk=tile[1], bn=tile[2],
        cost_model=name, seconds=best["seconds"],
        meta=tuple(sorted({"path": "tiled", "split_k": 1,
                           **{key: val for key, val in best.items()
                              if key != "seconds"}}.items())))


@runtime_checkable
class CostModel(Protocol):
    """What the Engine needs from a decision plane (structural typing:
    `HopperModel` and `AnalyticalCostModel` satisfy it without inheriting
    anything)."""

    name: str
    #: backend the model's decisions execute on when the Engine has no
    #: override (None -> the Engine's "hopper").
    default_backend: str | None

    def decide(self, request: KernelRequest) -> KernelDecision:
        """Search the model's schedule space for `request` and return the
        chosen schedule (backend field may be left "" for the Engine to
        fill in)."""
        ...  # pragma: no cover - protocol


@dataclasses.dataclass
class HopperModel:
    """The decision surface as a cost model: `decide(request)` returns
    the chosen dataflow and CTA tile for a `gemm` or `gemm_w8` request
    (the int8 kernel's path, with its split or tile, at in_bytes == 1),
    the sparse kernel's
    path with its split or OS tile for a `gemm_sparse` one, the
    per-expert OS tile for a `grouped_gemm` one, and the flash blocks for
    an `attention` or `paged_attention` one."""

    name: str = "hopper-h100"
    default_backend: str | None = None  # the Engine resolves "hopper"

    def decide(self, request: KernelRequest) -> KernelDecision:
        if request.op in ("attention", "paged_attention"):
            # paged decode is the same roofline with n = the page span
            return decide_attention(request, self.name)
        if request.op == "grouped_gemm":
            return decide_grouped(request, self.name)
        if request.op == "gemm_sparse":
            return decide_sparse(request, self.name)
        if request.op not in ("gemm", "gemm_w8"):
            raise ValueError(f"HopperModel plans gemm, gemm_w8, gemm_sparse, "
                             f"grouped_gemm and attention, not "
                             f"{request.op!r}")
        if request.op == "gemm" and request.in_bytes in (2, 4):
            return decide_gemm(request, self.name)
        if request.in_bytes != 1:
            raise ValueError(f"HopperModel plans {request.op} at 1-byte "
                             f"(int8) operands, and gemm also at 2 or 4 "
                             f"bytes, not {request.in_bytes}")
        return decide_int8(request, self.name)


# ---------------------------------------------------------------------------
# Plane 1: the ReDas ASIC (Sec. 4 mapper + Eq. 3-5 analytical model)
# ---------------------------------------------------------------------------


class AnalyticalCostModel:
    """The paper's mapper as a cost model (the port of the reference's
    `engine/cost.py::AnalyticalCostModel`).

    One instance owns one `ReDasMapper` (bound to an `AcceleratorSpec`,
    default the ReDas array itself); `decide` lowers the request to a
    `core.analytical_model.GEMM`, runs the interval-sampling search, and
    re-expresses the winning `MappingConfig` as a `KernelDecision` whose
    meta carries the full ASIC mapping (logical shape, loop order,
    buffer allocation, modeled cycles) — enough for the `simulator`
    backend to execute it functionally.  Its cycles and seconds are the
    analytical model's, for the paper's 700 MHz array, not the card's.
    """

    default_backend: str | None = "simulator"

    def __init__(self, spec=None, *, array_size: int | None = None, **mapper_kw):
        self.spec = spec if spec is not None else REDAS
        self._array_size = array_size
        self._mapper_kw = mapper_kw
        self.mapper = ReDasMapper(self.spec, array_size=array_size, **mapper_kw)
        # word_bytes -> mapper: requests carry their operand width and
        # the multi-mode buffer holds capacity/word_bytes words, so a
        # wider dtype halves the tile space the search may allocate.
        self._mappers = {self.spec.word_bytes: self.mapper}
        self.name = f"redas-asic/{self.spec.name}"

    def _mapper_for(self, in_bytes: int) -> ReDasMapper:
        """The mapper sized for `in_bytes`-wide operands (the spec's
        native width — int8, Table 4 — reuses the primary mapper)."""
        mapper = self._mappers.get(in_bytes)
        if mapper is None:
            spec = dataclasses.replace(self.spec, word_bytes=in_bytes)
            mapper = ReDasMapper(spec, array_size=self._array_size,
                                 **self._mapper_kw)
            self._mappers[in_bytes] = mapper
        return mapper

    def decide(self, request: KernelRequest) -> KernelDecision:
        if request.op in ("attention", "paged_attention"):
            raise ValueError(
                "the ASIC plane plans GEMMs; lower attention to its "
                "score/context GEMMs first (core.workloads.arch_gemms)")
        count = request.groups if request.op == "grouped_gemm" else 1
        k = request.k
        if request.op == "gemm_sparse":
            # effective-FLOPs lowering: the mapper sizes the logical
            # array for the contraction a sparsity-aware PE grid
            # actually performs (density x K), so a sparse candidate
            # ranks above its dense sibling at equal shape.
            k = max(1, round(k * request.density))
        gemm = GEMM(request.m, k, request.n, count=count,
                    name=request.name or "engine")
        d = self._mapper_for(request.in_bytes).map_gemm(gemm)
        cfg, rep = d.config, d.report
        return KernelDecision(
            op=request.op, dataflow=cfg.dataflow.value,
            bm=cfg.tile_m, bk=cfg.tile_k, bn=cfg.tile_n,
            cost_model=self.name,
            seconds=rep.cycles / self.spec.freq_hz,
            meta=tuple(sorted(dict(
                shape_rows=cfg.shape.rows, shape_cols=cfg.shape.cols,
                loop_order=cfg.loop_order, alloc_input=cfg.alloc[0],
                alloc_weight=cfg.alloc[1], alloc_output=cfg.alloc[2],
                cycles=rep.cycles,
                pe_utilization=rep.pe_utilization).items())))

    @staticmethod
    def mapping_config(decision: KernelDecision) -> MappingConfig:
        """Rebuild the ASIC `MappingConfig` a decision encodes (the
        simulator backend's input)."""
        meta = decision.meta_dict
        return MappingConfig(
            dataflow=Dataflow(decision.dataflow),
            shape=LogicalShape(int(meta["shape_rows"]), int(meta["shape_cols"])),
            tile_m=decision.bm, tile_k=decision.bk, tile_n=decision.bn,
            loop_order=str(meta["loop_order"]),
            alloc=(float(meta["alloc_input"]), float(meta["alloc_weight"]),
                   float(meta["alloc_output"])),
        )
