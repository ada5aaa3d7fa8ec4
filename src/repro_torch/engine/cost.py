"""HopperModel: the ReDas decision surface on one H100 (the port of
`repro/engine/cost.py::TPUModel._decide_gemm` and the primitives of
`repro/core/tpu_model.py`).

The search runs over the kernel's tile menu x {os, ws, is}.  A tile is
legal when one block's shared memory fits the card's 227 KB; among the
legal ones the model takes the least

    t = max(padded FLOPs / peak, dataflow bytes / HBM bandwidth)

with the dataflow traffic formula of `core/tpu_model.hbm_traffic` (OS
refetches the streaming operands but writes each output once; WS keeps
the weight tile resident per K chunk but streams f32 partial sums; IS is
the transpose).  There is no MXU ramp term: nothing on this card fills
and drains like a systolic array's pipeline.

A request keyed at in_bytes == 1 (every request of an int8 backend) is
planned on the int8 kernel's own menu, pinned to OS as the JAX package
pins its int8 kernel (the streaming dataflows would push int32 partial
sums through HBM), at the data sheet's int8 peak.  A `gemm_sparse`
request at M above the sparse kernel's decode rows is planned as the JAX
package's `_decide_gemm_sparse` plans it: at K_eff = density x K, plus
one index byte per kept value, on the kernel's tiled menu, pinned to OS;
at decode M it takes the kernel's split-K decode path, split by a wave
term over the card's SMs.
"""

from __future__ import annotations

import dataclasses
import math

from ..kernels import grouped_gemm, quant_gemm, sparse_gemm
from ..kernels.redas_gemm import DATAFLOWS, SMEM_LIMIT, TILES, smem_bytes
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
                in_bytes: int = 2, out_bytes: int = 2) -> float:
    """Device-memory bytes the dataflow moves on padded dims (the formula
    of `core/tpu_model.hbm_traffic`)."""
    mp, kp, np_ = _round_up(m, cfg.bm), _round_up(k, cfg.bk), _round_up(n, cfg.bn)
    gm, gk, gn = mp // cfg.bm, kp // cfg.bk, np_ // cfg.bn
    a, b, o = mp * kp * in_bytes, kp * np_ * in_bytes, mp * np_ * out_bytes
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
             out_bytes: int = 2) -> tuple[float, float, float]:
    """(seconds, hbm bytes, padding efficiency) of one call."""
    mp, kp, np_ = _round_up(m, cfg.bm), _round_up(k, cfg.bk), _round_up(n, cfg.bn)
    padded = 2.0 * mp * kp * np_
    bytes_ = hbm_traffic(m, k, n, cfg, in_bytes, out_bytes)
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
                out_bytes: int = 2, dataflows=DATAFLOWS,
                tiles=TILES, smem=_tile_smem) -> TileConfig:
    """The least-time legal (dataflow, tile) for one GEMM shape among
    `tiles` (the ReDas GEMM's menu unless given), a tile being legal when
    `smem(bm, bk, bn, in_bytes)` fits a block's shared memory."""
    best, best_t = None, math.inf
    for bm, bk, bn in tiles:
        if smem(bm, bk, bn, in_bytes) > SMEM_LIMIT:
            continue
        for df in dataflows:
            cfg = TileConfig(df, bm, bk, bn)
            t = estimate(m, k, n, cfg, in_bytes, out_bytes)[0]
            if t < best_t:
                best, best_t = cfg, t
    if best is None:
        raise ValueError(f"no tile of {tiles} fits {SMEM_LIMIT} bytes of "
                         f"shared memory at {in_bytes}-byte operands")
    return best


#: the flash kernel's tile: query rows and keys per step (`kQT`, `kKT`
#: in csrc/flash_attention.cu)
ATTENTION_BLOCK = 64


def decide_attention(request: KernelRequest, name: str) -> KernelDecision:
    """The flash roofline of `repro/engine/cost.py::_decide_attention`
    with the H100's peaks: q/k/v/o traffic only (the online-softmax state
    stays on chip).  m = Sq, n = Sk (or the page span), k = head dim,
    groups = batch x heads.  The blocks are the kernel's own tile, cut
    to the sequence; the wrapper bends them to divisors."""
    sq, sk, d, bh = request.m, request.n, request.k, request.groups
    flops = 4.0 * bh * sq * sk * d            # QK^T + PV
    hbm = request.in_bytes * bh * d * (2 * sq + 2 * sk)
    seconds = max(flops / peak_flops(request.in_bytes), hbm / HBM_BW)
    return KernelDecision(
        op=request.op, dataflow="os", bm=min(ATTENTION_BLOCK, sq), bk=d,
        bn=min(ATTENTION_BLOCK, sk), cost_model=name, seconds=seconds,
        meta=tuple(sorted({"hbm_bytes": float(hbm), "groups": bh}.items())))


def decide_grouped(request: KernelRequest, name: str) -> KernelDecision:
    """The port of `TPUModel._decide_grouped`: the grouped kernel is OS
    (the accumulator stays on chip over the D sweep), so the search is
    pinned to OS over the grouped kernel's tile menu (the int8 kernel's
    at in_bytes == 1, where the experts loop through it), gated by
    shared memory, on one expert's (C, D, F) problem; the call costs
    that expert's time x the expert count (`groups`)."""
    tiles = quant_gemm.TILES if request.in_bytes == 1 else grouped_gemm.TILES
    cfg = choose_tile(request.m, request.k, request.n, request.in_bytes,
                      request.out_bytes, dataflows=("os",), tiles=tiles)
    seconds = estimate(request.m, request.k, request.n, cfg,
                       request.in_bytes, request.out_bytes)[0]
    return KernelDecision(
        op=request.op, dataflow="os", bm=cfg.bm, bk=cfg.bk, bn=cfg.bn,
        cost_model=name, seconds=seconds * request.groups,
        meta=tuple(sorted({
            "groups": request.groups,
            "smem_bytes": _tile_smem(cfg.bm, cfg.bk, cfg.bn,
                                     request.in_bytes)}.items())))


#: the decode path's wave term: the card's SMs, the decode blocks one SM
#: holds at once (128 threads at 90-235 registers), and the compressed
#: rows each split keeps at least (8 for each of a block's 4 warps: one
#: pair of its register stages)
SMS = 132
DECODE_BLOCKS_PER_SM = 2
DECODE_MIN_ROWS = 32


def decode_cost(request: KernelRequest, split_k: int) -> dict:
    """The sparse kernel's decode path at `split_k`: the compressed
    weight (values and one index byte per kept value) and the activations
    stream at the HBM rate times the share of the card the grid fills
    (the wave term), the f32 workspace is written and read back at the
    full rate, and the multiply-adds of the padded rows run on FFMA."""
    m, k, n = request.m, request.k, request.n
    k_eff = max(1, round(k * request.density))
    rows = sparse_gemm.decode_rows(m)
    tiles = -(-n // sparse_gemm.decode_columns(request.in_bytes))
    fill = min(1.0, tiles * split_k / (SMS * DECODE_BLOCKS_PER_SM))
    streamed = k_eff * n * (request.in_bytes + 1) + m * k * request.in_bytes
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
    `stages` says whether the density's chunk keeps a second stage.
    `meta` carries the path and `split_k`, so they survive the plan's
    JSON."""
    m, k, n = request.m, request.k, request.n
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
            bn=sparse_gemm.decode_columns(request.in_bytes),
            cost_model=name, seconds=best["seconds"],
            meta=tuple(sorted({
                "path": "decode", "split_k": split_k,
                "density": request.density,
                **{key: best[key] for key in ("hbm_bytes", "workspace_bytes",
                                              "blocks", "k_effective")},
            }.items())))
    cfg = choose_tile(m, k_eff, n, request.in_bytes, request.out_bytes,
                      dataflows=("os",), tiles=sparse_gemm.TILES,
                      smem=sparse_gemm.smem_bytes)
    seconds, bytes_, pad_eff = estimate(m, k_eff, n, cfg, request.in_bytes,
                                        request.out_bytes)
    idx_bytes = float(k_eff * n)
    # a chunk's compressed rows: (bk // M) * N <= bk x density
    rows = math.floor(cfg.bk * request.density + 1e-9)
    stages = (2 if sparse_gemm.smem_bytes(cfg.bm, cfg.bk, cfg.bn,
                                          request.in_bytes, rows, 2)
              <= SMEM_LIMIT else 1)
    return KernelDecision(
        op=request.op, dataflow="os", bm=cfg.bm, bk=cfg.bk, bn=cfg.bn,
        cost_model=name, seconds=seconds + idx_bytes / HBM_BW,
        meta=tuple(sorted({
            "path": "tiled", "split_k": 1, "stages": stages,
            "hbm_bytes": bytes_ + idx_bytes, "padding_efficiency": pad_eff,
            "density": request.density, "k_effective": k_eff,
            "smem_bytes": sparse_gemm.smem_bytes(
                cfg.bm, cfg.bk, cfg.bn, request.in_bytes, rows,
                stages)}.items())))


@dataclasses.dataclass
class HopperModel:
    """The decision surface as a cost model: `decide(request)` returns
    the chosen dataflow and CTA tile for a `gemm` or `gemm_w8` request
    (an OS tile of the int8 kernel at in_bytes == 1), the sparse kernel's
    path with its split or OS tile for a `gemm_sparse` one, the
    per-expert OS tile for a `grouped_gemm` one, and the flash blocks for
    an `attention` or `paged_attention` one."""

    name: str = "hopper-h100"

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
        int8 = request.in_bytes == 1
        cfg = choose_tile(request.m, request.k, request.n, request.in_bytes,
                          request.out_bytes,
                          dataflows=("os",) if int8 else DATAFLOWS,
                          tiles=quant_gemm.TILES if int8 else TILES)
        seconds, bytes_, pad_eff = estimate(request.m, request.k, request.n,
                                            cfg, request.in_bytes,
                                            request.out_bytes)
        return KernelDecision(
            op=request.op, dataflow=cfg.dataflow,
            bm=cfg.bm, bk=cfg.bk, bn=cfg.bn,
            cost_model=self.name, seconds=seconds,
            meta=tuple(sorted({
                "hbm_bytes": bytes_, "padding_efficiency": pad_eff,
                "smem_bytes": _tile_smem(cfg.bm, cfg.bk, cfg.bn,
                                         request.in_bytes)}.items())))
