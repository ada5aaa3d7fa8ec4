"""The ReDas GEMM on Hopper: wrapper, launch counters and plain versions.

`gemm` computes what `repro.kernels.redas_gemm.gemm` computes — (M, K) @
(K, N) with f32 accumulation, in the OS, WS or IS dataflow, written in
`out_dtype` (bf16 or f32; the operands' dtype unless given) — through
the CUDA kernels in `csrc/redas_gemm.cu`.  The decision's (bm, bk, bn) is
the CTA tile, and it must be on the menu of the kernel the call runs on.

OS has two routes, decided before the launch by `os_route` from the
operands' dtype, shape and base addresses alone: "wgmma" (bf16 whose K
and N are multiples of 8 and whose bases are 16-byte aligned, TMA's rules:
the TMA/wgmma kernel, menu `WGMMA_TILES`) and "sync" (everything else:
the synchronous-load kernel, menu `TILES`).  A launch that fails raises;
no other route is tried.  WS and IS (menu `STREAM_TILES`, bk the depth of
the stationary slab) run one block per (stationary tile, K slab, group of
swept tiles); with more than one slab (K > bk) each slab writes f32
partials to its own slice of a (slabs, M, N) workspace and a second
kernel sums them in slab order (launched by the same call;
`stream_reduce` runs it alone).  Ragged M, K and N are masked inside the
kernels (by TMA's zero fill on the wgmma route): nothing is padded or
sliced here.

On a CUDA tensor the wrapper launches the kernels (or raises: there is no
fallback); on a CPU tensor it returns the plain version `gemm_reference`,
which is what the tests compare against the JAX reference.
`stream_reference` is the plain version of the streaming kernels' own
arithmetic: one f32 product per slab, then their sum in slab order.
`launches` counts GEMMs launched, one per call, by dataflow (OS on both
routes); `os_wgmma_launches` counts the OS calls that ran on the wgmma
kernel, and `reduce_launches` the streaming dataflows' reductions.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import matmul_ref

DATAFLOWS = ("os", "ws", "is")

#: the sync route's OS CTA tiles (bm, bk, bn), in both dtypes;
#: `REDAS_TILES` in csrc/redas_gemm.cu is the same list.  The grouped
#: GEMM shares the layout (`smem_bytes`).
TILES = ((16, 64, 64), (32, 64, 64), (64, 32, 64), (64, 64, 128),
         (128, 32, 128), (64, 256, 64))
#: the wgmma route's OS CTA tiles (bm, bk, bn): bm one or two consumer
#: warpgroups of 64 rows, bk the ring stage's depth, bn one wgmma's
#: width, each the fastest OS tile at some shape of the calibration
#: sweep; `REDAS_WGMMA_TILES` in csrc/redas_gemm.cu is the same list
WGMMA_TILES = ((64, 64, 64), (64, 64, 128), (128, 64, 64), (128, 64, 128),
               (128, 64, 256))
#: the wgmma kernel's ring stages (`kWgStages`)
WGMMA_STAGES = 4
#: the WS/IS tiles (bm, bk, bn), bk the stationary slab's depth, in both
#: dtypes; `REDAS_STREAM_TILES` in csrc/redas_gemm.cu is the same list.
#: A (dataflow, dtype, tile) is legal when its slab and two ring stages
#: fit SMEM_LIMIT (`stream_stages`).
STREAM_TILES = ((16, 64, 64), (16, 256, 64), (16, 1536, 64), (64, 256, 64),
                (64, 512, 64), (128, 128, 128), (128, 256, 128))

#: shared memory a block may use on an H100 (227 KB, NVIDIA data sheet),
#: and what one SM holds for all its blocks (228 KB, each block reserving
#: 1 KB more)
SMEM_LIMIT = 232_448
SM_SMEM = 233_472
BLOCK_RESERVED = 1024
#: resident blocks an SM holds at 128 threads a block (2048 threads)
MAX_BLOCKS_PER_SM = 16
#: K depth of one streaming pipeline step (`kSub`), and the ring's most
#: stages (`kMaxStages`)
SUB_K = 64
MAX_STAGES = 4
#: the H100's SMs, for the group rule when the caller names no card
SMS = 132
#: gridDim.y and gridDim.z
GRID_LIMIT = 65535

_PAD = 8          # shared-memory row padding, elements
_WARPS = 4        # 128 threads a block
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}

#: GEMMs launched by dataflow, the OS ones of them that ran on the wgmma
#: kernel, and the streaming reductions launched, since the last reset
#: (the CPU path and the plain versions never count)
launches = dict.fromkeys(DATAFLOWS, 0)
os_wgmma_launches = 0
reduce_launches = 0

#: the plain version of the kernels: cast to f32, multiply, cast back.
gemm_reference = matmul_ref


def reset_launches() -> None:
    global os_wgmma_launches, reduce_launches
    for df in DATAFLOWS:
        launches[df] = 0
    os_wgmma_launches = reduce_launches = 0


def shape_route(in_bytes: int, k: int, n: int) -> str:
    """The OS route a call of this operand width and (K, N) takes when its
    bases are 16-byte aligned (what a planner, which sees no pointers,
    plans for): "wgmma" for bf16 with K and N multiples of 8 (TMA's row
    strides are multiples of 16 bytes), else "sync"."""
    return "wgmma" if in_bytes == 2 and k % 8 == 0 and n % 8 == 0 else "sync"


def os_route(a: torch.Tensor, b: torch.Tensor) -> str:
    """The OS route of a call on these operands: `shape_route`, and "sync"
    as well when either base is not 16-byte aligned (TMA's address
    rule).  A pure function of dtype, shape and pointers."""
    route = shape_route(a.element_size(), a.shape[1], b.shape[1])
    if route == "wgmma" and (a.data_ptr() % 16 or b.data_ptr() % 16):
        return "sync"
    return route


def smem_bytes(bm: int, bk: int, bn: int, in_bytes: int) -> int:
    """Shared memory one block of the sync route's OS (bm, bk, bn) kernel
    uses: the padded input and weight tiles plus the per-warp f32 epilogue
    tile (the `Smem` struct of csrc/gemm_tile.cuh, which the grouped GEMM
    shares)."""
    return (bm * (bk + _PAD) + bk * (bn + _PAD)) * in_bytes + _WARPS * 256 * 4


def wgmma_smem_bytes(bm: int, bk: int, bn: int) -> int:
    """Shared memory one block of the wgmma (bm, bk, bn) kernel uses: 1 KB
    to align the ring, WGMMA_STAGES stages of the (bm, bk) box of A and
    the (bk, bn) boxes of B in bf16, and a full and an empty 8-byte
    mbarrier a stage (the `WgSmem` struct of csrc/redas_gemm.cu)."""
    return 1024 + WGMMA_STAGES * (bm + bn) * bk * 2 + 2 * WGMMA_STAGES * 8


def wgmma_threads(bm: int) -> int:
    """A wgmma block's threads: one consumer warpgroup per 64 rows, then
    the producer warp."""
    return 2 * bm + 32


def stream_smem_bytes(dataflow: str, bm: int, bk: int, bn: int,
                      in_bytes: int, stages: int) -> int:
    """Shared memory one WS or IS block uses with a ring of `stages`: the
    stationary slab, the moving operand's stages and the per-warp f32
    epilogue tiles (the `StreamSmem` struct of csrc/redas_gemm.cu)."""
    if dataflow == "ws":
        slab, stage = bk * (bn + _PAD), bm * (SUB_K + _PAD)
    elif dataflow == "is":
        slab, stage = bm * (bk + _PAD), SUB_K * (bn + _PAD)
    else:
        raise ValueError(f"{dataflow!r} is not a streaming dataflow")
    return (slab + stages * stage) * in_bytes + _WARPS * 256 * 4


@functools.cache
def stream_stages(dataflow: str, bm: int, bk: int, bn: int,
                  in_bytes: int) -> int:
    """The ring's depth a streaming block runs at: the most stages (up to
    MAX_STAGES) whose shared memory fits SMEM_LIMIT; 0 when two do not."""
    for stages in range(MAX_STAGES, 1, -1):
        if stream_smem_bytes(dataflow, bm, bk, bn, in_bytes,
                             stages) <= SMEM_LIMIT:
            return stages
    return 0


def tiles_for(dataflow: str, route: str = "sync") -> tuple:
    """The tile menu of a dataflow (of OS on `route`)."""
    if dataflow != "os":
        return STREAM_TILES
    return WGMMA_TILES if route == "wgmma" else TILES


def tile_smem(dataflow: str, bm: int, bk: int, bn: int, in_bytes: int,
              route: str = "sync") -> int:
    """Shared memory one block of the dataflow's kernel (OS: on `route`)
    uses at this tile (a streaming tile that fits no ring: its two-stage
    bytes, above SMEM_LIMIT)."""
    if dataflow == "os":
        return (wgmma_smem_bytes(bm, bk, bn) if route == "wgmma"
                else smem_bytes(bm, bk, bn, in_bytes))
    stages = stream_stages(dataflow, bm, bk, bn, in_bytes)
    return stream_smem_bytes(dataflow, bm, bk, bn, in_bytes, max(stages, 2))


def blocks_per_sm(smem: int) -> int:
    """Blocks of `smem` bytes one SM holds at once (shared memory and
    threads; registers not counted)."""
    return max(0, min(MAX_BLOCKS_PER_SM, SM_SMEM // (smem + BLOCK_RESERVED)))


def slab_count(k: int, bk: int) -> int:
    """The K slabs of a streaming call: one per bk rows of K."""
    return -(-k // bk)


def groups_for(dataflow: str, m: int, k: int, n: int,
               tile: tuple[int, int, int], in_bytes: int,
               sms: int = SMS) -> int:
    """How many blocks share one stationary tile's sweep (WS: its m-tiles,
    IS: its n-tiles): enough for the grid to fill every SM with as many
    blocks as it holds at the tile's shared memory, never more than the
    tiles swept.  OS has one."""
    if dataflow == "os":
        return 1
    bm, bk, bn = tile
    gm, gn = -(-m // bm), -(-n // bn)
    fixed, swept = (gn, gm) if dataflow == "ws" else (gm, gn)
    per_sm = max(1, blocks_per_sm(tile_smem(dataflow, *tile, in_bytes)))
    want = max(1, min(swept, -(-sms * per_sm // (fixed * slab_count(k, bk)))))
    return -(-swept // -(-swept // want))    # as the kernel forms them


def grid(dataflow: str, m: int, k: int, n: int, tile: tuple[int, int, int],
         groups: int = 1) -> tuple[int, int, int]:
    """The kernel's grid: OS (n-tiles, m-tiles, 1); WS (n-tiles, slabs,
    groups of m-tiles); IS (m-tiles, slabs, groups of n-tiles), the
    groups as the kernel forms them (`per` = ceil(swept / groups) tiles
    each)."""
    bm, bk, bn = tile
    gm, gn = -(-m // bm), -(-n // bn)
    if dataflow == "os":
        return gn, gm, 1
    fixed, swept = (gn, gm) if dataflow == "ws" else (gm, gn)
    per = -(-swept // groups)
    return fixed, slab_count(k, bk), -(-swept // per)


def stream_reference(a: torch.Tensor, b: torch.Tensor, bk: int,
                     out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The plain version of the WS/IS kernels' arithmetic: each bk-deep K
    slab's f32 product (the partials the kernel writes), summed in slab
    order from zero (`stream_reduce_reference`)."""
    a32, b32 = a.float(), b.float()
    parts = torch.stack([a32[:, k0:k0 + bk] @ b32[k0:k0 + bk]
                         for k0 in range(0, a.shape[1], bk)])
    return stream_reduce_reference(parts, out_dtype or a.dtype)


def stream_reduce_reference(ws: torch.Tensor,
                            out_dtype: torch.dtype) -> torch.Tensor:
    """The reduction's plain version: the (slabs, M, N) f32 partials
    summed in slab order from zero, as the kernel sums them, cast to
    `out_dtype`."""
    total = torch.zeros_like(ws[0])
    for part in ws:
        total = total + part
    return total.to(out_dtype)


def _check(a: torch.Tensor, b: torch.Tensor, dataflow: str,
           tile: tuple[int, int, int], out_dtype) -> str | None:
    """Raise on what the kernels do not take; the OS route, else None."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"gemm takes 2-D operands, got {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm dim mismatch {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if min(a.shape[0], a.shape[1], b.shape[1]) < 1:
        raise ValueError(f"gemm of an empty operand {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODE:
        raise TypeError(f"gemm takes two bf16 or two f32 operands, got "
                        f"{a.dtype} and {b.dtype}")
    if out_dtype not in (None, *_DTYPE_CODE):
        raise TypeError(f"the kernels write bf16 or f32, not {out_dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("gemm takes contiguous row-major operands")
    if dataflow not in DATAFLOWS:
        raise ValueError(f"unknown dataflow {dataflow!r} (known: {DATAFLOWS})")
    route = os_route(a, b) if dataflow == "os" else None
    menu = tiles_for(dataflow, route or "sync")
    if tile not in menu:
        where = f"os {route} route" if route else dataflow
        raise ValueError(f"tile (bm, bk, bn) = {tile} is not on the {where} "
                         f"kernel's menu {menu}")
    return route


def _check_stream(dataflow: str, m: int, k: int, n: int,
                  tile: tuple[int, int, int], in_bytes: int, slabs, groups
                  ) -> None:
    bm, bk, bn = tile
    if stream_stages(dataflow, *tile, in_bytes) < 2:
        need = tile_smem(dataflow, *tile, in_bytes)
        raise ValueError(
            f"{dataflow} tile {tile} needs {need} bytes of shared memory at "
            f"{in_bytes}-byte operands, more than the {SMEM_LIMIT} a block "
            f"may use")
    if slabs is not None and slabs != slab_count(k, bk):
        raise ValueError(f"slabs = {slabs}, but K = {k} at bk = {bk} makes "
                         f"{slab_count(k, bk)}")
    if slab_count(k, bk) > GRID_LIMIT:
        raise ValueError(f"K = {k} at bk = {bk} exceeds the grid limit "
                         f"{GRID_LIMIT}")
    swept = -(-m // bm) if dataflow == "ws" else -(-n // bn)
    if groups is not None and (type(groups) is not int
                               or not 1 <= groups <= swept):
        raise ValueError(f"groups must be an int in 1..{swept}, got "
                         f"{groups!r}")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("redas_gemm")
    lib.redas_gemm_launch.argtypes = (
        [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        + [ctypes.c_void_p])
    lib.redas_wgmma_launch.argtypes = (
        [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        + [ctypes.c_void_p])
    lib.redas_stream_launch.argtypes = (
        [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
        + [ctypes.c_void_p])
    lib.redas_reduce_launch.argtypes = (
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    for fn in (lib.redas_gemm_launch, lib.redas_wgmma_launch,
               lib.redas_stream_launch, lib.redas_reduce_launch):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def stream_reduce(ws: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """(slabs, M, N) f32 partials -> (M, N) in `out_dtype` (bf16 or f32):
    their sum in slab order from zero, through the reduction kernel on a
    CUDA tensor, `stream_reduce_reference` on a CPU one."""
    global reduce_launches
    if ws.dim() != 3 or ws.dtype != torch.float32 or not ws.is_contiguous():
        raise ValueError(f"stream_reduce takes contiguous (slabs, M, N) f32 "
                         f"partials, got {ws.dtype} {tuple(ws.shape)}")
    if ws.shape[0] < 2 or ws.shape[1] * ws.shape[2] < 1:
        raise ValueError(f"stream_reduce needs 2 or more non-empty partials, "
                         f"got {tuple(ws.shape)}")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"stream_reduce writes bf16 or f32, not {out_dtype}")
    if ws.device.type == "cpu":
        return stream_reduce_reference(ws, out_dtype)
    slabs, m, n = ws.shape
    out = torch.empty((m, n), dtype=out_dtype, device=ws.device)
    with torch.cuda.device(ws.device):
        _raise_on(_library().redas_reduce_launch(
            _DTYPE_CODE[out_dtype], ws.data_ptr(), out.data_ptr(), m * n,
            slabs, torch.cuda.current_stream().cuda_stream),
            f"redas_gemm reduction of {slabs} slabs")
    reduce_launches += 1
    return out


def gemm(a: torch.Tensor, b: torch.Tensor, *, dataflow: str = "os",
         bm: int, bk: int, bn: int, slabs: int | None = None,
         groups: int | None = None,
         out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """(M, K) @ (K, N) through the ReDas kernel with CTA tile (bm, bk, bn),
    written in `out_dtype` (bf16 or f32; the operands' dtype if None).

    OS runs on the kernel of `os_route(a, b)`, whose menu the tile must be
    on.  WS and IS take `slabs` (None, or ceil(K / bk), which it must be)
    and `groups` (the blocks that share a stationary tile's sweep; None:
    the rule of `groups_for` on this card).  CUDA operands launch the
    kernels on the current stream; CPU operands get `gemm_reference`.
    Raises on anything the kernels do not take, and when a launch
    fails."""
    global os_wgmma_launches, reduce_launches
    tile = (bm, bk, bn)
    route = _check(a, b, dataflow, tile, out_dtype)
    m, k = a.shape
    n = b.shape[1]
    if dataflow == "os":
        if (slabs, groups) not in ((None, None), (1, 1)):
            raise ValueError(f"OS takes no slabs or groups, got {slabs}, "
                             f"{groups}")
    else:
        _check_stream(dataflow, m, k, n, tile, a.element_size(), slabs,
                      groups)
    if a.device.type == "cpu":
        return gemm_reference(a, b, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"gemm runs on CUDA or CPU tensors, not {a.device}")
    lib, code = _library(), _DTYPE_CODE[a.dtype]
    out_dtype = out_dtype or a.dtype
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    out_code = _DTYPE_CODE[out_dtype]
    ws = None
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "wgmma":
            err = lib.redas_wgmma_launch(out_code, bm, bk, bn, a.data_ptr(),
                                         b.data_ptr(), out.data_ptr(), m, n,
                                         k, stream)
            if err != 0:
                _raise_on(err, f"redas_gemm os wgmma {tile}")
            os_wgmma_launches += 1
        elif route == "sync":
            err = lib.redas_gemm_launch(code, out_code, bm, bk, bn,
                                        a.data_ptr(), b.data_ptr(),
                                        out.data_ptr(), m, n, k, stream)
            if err != 0:
                _raise_on(err, f"redas_gemm os sync {tile}")
        else:
            slabs = slab_count(k, bk)
            if groups is None:
                groups = groups_for(dataflow, m, k, n, tile,
                                    a.element_size(),
                                    _sm_count(a.device.index or 0))
            # more than one slab: f32 partials, reduced in the same call
            ws = (torch.empty((slabs, m, n), dtype=torch.float32,
                              device=a.device) if slabs > 1 else None)
            err = lib.redas_stream_launch(
                DATAFLOWS.index(dataflow), code, out_code, bm, bk, bn,
                a.data_ptr(), b.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(), m, n, k, slabs,
                groups, stream_stages(dataflow, bm, bk, bn, a.element_size()),
                stream)
            if err != 0:
                _raise_on(err, f"redas_gemm {dataflow} {tile} slabs {slabs} "
                               f"groups {groups}")
    launches[dataflow] += 1
    if ws is not None:
        reduce_launches += 1
    return out
