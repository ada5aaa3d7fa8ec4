"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA card and skips without one; on the card run

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_card.py

The file imports no JAX (the card's machine has none).  Tolerances are
per output row, rel-L2 <= 1e-4 in f32 and <= 1e-2 in bf16 (PERF.md §2);
the int8 GEMM's int32 result is held to its plain version bit for bit
on both of its paths (the decode path at split 1, the planner's and the
largest; every tile of the tiled menu), at ragged shapes, a misaligned
base and the sums' extremes, its repeat launches bit for bit.
The sparse GEMM is held at those row tolerances at every N:M spec, on
both of its paths (every tile of the tiled menu; the decode path at
several splits) and with any int8 index array, and its repeat launches
bit for bit; its int8-value variant (sparse x int8 storage, with the
per-column scale) likewise, and its scaled reduction bit for bit.  The ReDas GEMM is held at those row tolerances in each
dataflow at a decode, a prefill and a ragged shape (WS/IS at one slab,
the planner's slabs and the most slabs), its repeat launches and its
reduction bit for bit; its wgmma OS kernel at every tile of its menu, at
qwen's prefill shapes and ragged ones, in both output dtypes; every GEMM
kernel's f32 output from bf16 operands.  The grouped GEMM's wgmma kernel
is held at every tile of its menu at granite's expert shapes and ragged
ones, its capacity rows exactly zero, its repeats and each expert's
output (whatever the other experts hold, Inf included) bit for bit.
The flash kernel is held on both routes at D = 16, 20, 64, 80, 128, 240
and 256 (the wgmma route for bf16 with D % 8 == 0, the sync route for the
rest and for a misaligned base), one launch a call on the expected route
and its repeats bit for bit.  Rows 1 and 2 are also held at the rows of
the speculative verify (M = 8 x 5) and of a 256-token chunk (M = 8 x
256) at qwen2-1.5b's layer shapes, the engine's decision among them.
The paged kernel is held over float and int8 pools at cluster sizes 1,
the wrapper's and 8, at small tables, qwen2-1.5b's decode tick and
granite's (G = 2, D = 64), its kv_len 0 rows exactly zero and its
repeats bit for bit.  The SMOKE configurations of qwen3-14b,
mistral-large-123b, gemma3-12b and recurrentgemma-2b (both also under
--quantize), mamba2-780m and mixtral-8x7b (both MoE dispatches) give the
CPU plain run's tokens on the card; internvl2-1b's after its prefix
embeddings too, and hubert-xlarge's forward logits are within 1e-4
rel-L2 of the CPU's.  The accelerator plane's cycle-level simulator on
CUDA tensors equals its CPU run within 1e-6 with equal cycles (also
behind `Engine(AnalyticalCostModel())`), and a SMOKE Scheduler serve
warm-started from `plan_arch` adds no plan miss on the card.  Each VJP
Function (the ReDas GEMM's, the grouped GEMM's, the int8 and w8 GEMMs',
both sparse GEMMs', pruned positions of dV exactly zero) gives autograd
of its plain version's cotangents at the row tolerances, its backward
GEMMs launched on the kernels; the flash scan's Function matches
autograd of its plain loop within 1e-5; a SMOKE train step on the card
(two microbatches, "hopper") equals the CPU's within rtol/atol 2e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import (flash_attention, grouped_gemm,
                                  paged_attention, quant_gemm, redas_gemm,
                                  sparse_gemm)
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as T
from repro_torch.quant import kv_quantize, quantize, quantize_params
from repro_torch.serve_lib import serve
from repro_torch.serve_lib.scheduler import Request, Scheduler
from repro_torch.sparse import densify_params, sparsify

DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels build and run only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _row_rel_l2(got, ref):
    got, ref = got.float(), ref.float()
    d = got.shape[-1]
    num = (got - ref).reshape(-1, d).norm(dim=-1)
    return (num / ref.reshape(-1, d).norm(dim=-1).clamp_min(1e-30)).max().item()


def _gemm_configs(m, k, n, itemsize):
    """The ReDas kernel arguments a card test holds at (m, k, n): OS at
    the model's best OS tile; WS and IS at one slab (the shallowest
    streaming tile that holds K and fits), at the model's best
    configuration for the dataflow, and at the most slabs (bk = 64)."""
    from repro_torch.engine import KernelRequest
    from repro_torch.engine.cost import decide_gemm

    req = KernelRequest("gemm", m, k, n, in_bytes=itemsize,
                        out_bytes=itemsize)
    configs = []
    for df in redas_gemm.DATAFLOWS:
        dec = decide_gemm(req, "test", dataflows=(df,))
        planned = {"dataflow": df, "bm": dec.bm, "bk": dec.bk, "bn": dec.bn}
        if df == "os":
            configs.append(planned)
            continue
        planned.update(slabs=dec.meta_dict["slabs"],
                       groups=dec.meta_dict["groups"])
        fits = [t for t in redas_gemm.STREAM_TILES
                if redas_gemm.stream_stages(df, *t, itemsize)]
        one = min((t for t in fits if t[1] >= k), key=lambda t: (t[1], t),
                  default=None)
        for tile in ([one] if one else []) + [(16, 64, 64)]:
            conf = {"dataflow": df, "bm": tile[0], "bk": tile[1],
                    "bn": tile[2]}
            if conf not in configs:
                configs.append(conf)
        if planned not in configs:
            configs.append(planned)
    return configs


@pytest.mark.card
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("m,k,n", [(4, 1536, 1536), (8, 1024, 2048),
                                   (300, 512, 384), (5, 1003, 200)])
def test_redas_gemm_matches_plain_version(cuda, dtype, tol, m, k, n):
    """Every dataflow against `gemm_reference` at a decode, a prefill and
    a ragged shape; WS/IS at one slab, the planner's and the most slabs;
    each configuration launched twice, the outputs bit for bit equal."""
    gen = torch.Generator(device=cuda).manual_seed(m + k)
    a = torch.randn(m, k, generator=gen, device=cuda).to(dtype)
    b = (torch.randn(k, n, generator=gen, device=cuda) / k ** 0.5).to(dtype)
    ref = redas_gemm.gemm_reference(a, b)
    configs = _gemm_configs(m, k, n, a.element_size())
    assert {c["dataflow"] for c in configs} == set(redas_gemm.DATAFLOWS)
    assert any(c.get("bk", 0) >= k for c in configs if c["dataflow"] != "os")
    for conf in configs:
        got = redas_gemm.gemm(a, b, **conf)
        again = redas_gemm.gemm(a, b, **conf)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (m, n)
        assert _row_rel_l2(got, ref) <= tol, conf
        assert torch.equal(got, again), conf


#: qwen2-1.5b's layer GEMMs (K, N): q and o, k and v, wi and wg, wo
QWEN_LAYER_KN = [(1536, 1536), (1536, 256), (1536, 8960), (8960, 1536)]
#: the speculative verify's GEMM rows at 8 slots and k = 4 (B (k + 1))
#: and a 256-token chunk's at 8 slots (B x chunk)
SPEC_CHUNK_M = [8 * 5, 8 * 256]


@pytest.mark.card
@pytest.mark.parametrize("m", SPEC_CHUNK_M)
@pytest.mark.parametrize("k,n", QWEN_LAYER_KN)
def test_redas_gemm_at_the_verify_and_chunk_rows(cuda, m, k, n):
    """Rows 1 and 2 (OS, WS and IS) in bf16 at the rows a speculative
    verify (M = 40) and a chunked prefill (M = 2048) give qwen2-1.5b's
    layer GEMMs: each against `gemm_reference` within the bf16 row
    tolerance, repeats bit for bit, and the engine's decision among
    them."""
    from repro_torch.engine import KernelRequest
    from repro_torch.engine.backends import gemm_args
    from repro_torch.engine.cost import HopperModel

    gen = torch.Generator(device=cuda).manual_seed(m + n)
    a = torch.randn(m, k, generator=gen, device=cuda).to(torch.bfloat16)
    b = (torch.randn(k, n, generator=gen, device=cuda) / k ** 0.5).to(
        torch.bfloat16)
    ref = redas_gemm.gemm_reference(a, b)
    configs = _gemm_configs(m, k, n, 2)
    decision = gemm_args(HopperModel().decide(
        KernelRequest("gemm", m, k, n, in_bytes=2, out_bytes=2)))
    for conf in configs + [decision]:
        got = redas_gemm.gemm(a, b, **conf)
        again = redas_gemm.gemm(a, b, **conf)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and got.shape == (m, n)
        assert _row_rel_l2(got, ref) <= 1e-2, conf
        assert torch.equal(got, again), conf


@pytest.mark.card
def test_redas_counters_count_gemms_and_reductions(cuda):
    """`launches` counts one per GEMM by dataflow, `reduce_launches` the
    streaming reductions (one per call with more than one slab); the
    reduction equals its plain version bit for bit; the plain versions
    count nothing."""
    a = torch.randn(8, 1024, device=cuda, dtype=torch.bfloat16)
    b = torch.randn(1024, 512, device=cuda, dtype=torch.bfloat16)
    redas_gemm.reset_launches()
    redas_gemm.gemm(a, b, dataflow="os", bm=64, bk=64, bn=128)   # wgmma
    redas_gemm.gemm(a.float(), b.float(), dataflow="os", bm=16, bk=64,
                    bn=64)                                       # sync
    redas_gemm.gemm(a, b, dataflow="ws", bm=16, bk=1536, bn=64)  # one slab
    redas_gemm.gemm(a, b, dataflow="ws", bm=16, bk=256, bn=64)   # four
    redas_gemm.gemm(a, b, dataflow="is", bm=16, bk=64, bn=64)    # sixteen
    redas_gemm.gemm_reference(a, b)
    redas_gemm.stream_reference(a, b, 256)
    assert redas_gemm.launches == {"os": 2, "ws": 2, "is": 1}
    assert redas_gemm.os_wgmma_launches == 1
    assert redas_gemm.reduce_launches == 2
    ws = torch.randn(5, 7, 33, device=cuda)
    for dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(redas_gemm.stream_reduce(ws, dtype),
                           redas_gemm.stream_reduce_reference(ws, dtype))
    assert redas_gemm.reduce_launches == 4
    redas_gemm.reset_launches()
    assert redas_gemm.launches == {"os": 0, "ws": 0, "is": 0}
    assert redas_gemm.os_wgmma_launches == redas_gemm.reduce_launches == 0


def _misaligned(t):
    """A copy of `t` whose base is 2 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    skip = next(i for i in range(1, 8)
                if (flat.data_ptr() + i * t.element_size()) % 16)
    out = flat[skip:skip + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.card
@pytest.mark.parametrize("m,k,n", [(2048, 1536, 1536), (2048, 1536, 256),
                                   (2048, 1536, 8960), (2048, 8960, 1536),
                                   (1, 1536, 1536), (17, 1536, 256),
                                   (2047, 1536, 8960), (40, 1000, 200)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_wgmma_kernel_matches_plain_version(cuda, m, k, n, out_dtype):
    """The wgmma OS kernel at every tile of its menu against
    `gemm_reference` in both output dtypes: qwen's four (K, N) at the
    prefill's M = 2048, ragged M (1, 17, 2047) and a K that is a multiple
    of 8 but not of the ring's 64 (1000 x 200: TMA zero-fills the edge);
    a repeat launch bit for bit equal; every call counted on the wgmma
    route.  The same operands at a misaligned base run the sync kernel."""
    gen = torch.Generator(device=cuda).manual_seed(m + n)
    a = torch.randn(m, k, generator=gen, device=cuda).bfloat16()
    b = (torch.randn(k, n, generator=gen, device=cuda) / k ** 0.5).bfloat16()
    ref = redas_gemm.gemm_reference(a, b, out_dtype)
    assert redas_gemm.os_route(a, b) == "wgmma"
    redas_gemm.reset_launches()
    for bm, bk, bn in redas_gemm.WGMMA_TILES:
        got = redas_gemm.gemm(a, b, bm=bm, bk=bk, bn=bn, out_dtype=out_dtype)
        again = redas_gemm.gemm(a, b, bm=bm, bk=bk, bn=bn,
                                out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert got.dtype == out_dtype and got.shape == (m, n)
        assert _row_rel_l2(got, ref) <= 1e-2, (bm, bk, bn)
        assert torch.equal(got, again), (bm, bk, bn)
    calls = 2 * len(redas_gemm.WGMMA_TILES)
    assert redas_gemm.os_wgmma_launches == redas_gemm.launches["os"] == calls
    off = _misaligned(a)
    assert redas_gemm.os_route(off, b) == "sync"
    got = redas_gemm.gemm(off, b, bm=64, bk=64, bn=128, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert _row_rel_l2(got, ref) <= 1e-2
    assert redas_gemm.os_wgmma_launches == calls
    assert redas_gemm.launches["os"] == calls + 1


@pytest.mark.card
def test_gemm_kernels_write_f32_from_bf16_operands(cuda):
    """Every float GEMM kernel writes f32 (and bf16 from f32 operands)
    from its f32 accumulator: the sync OS kernel, WS/IS at one slab
    (the kernel's own store) and at many (the reduction's), the grouped
    kernel, and `Engine.matmul(..., out_dtype=torch.float32)` on
    `hopper`."""
    from repro_torch.engine import Engine

    gen = torch.Generator(device=cuda).manual_seed(7)
    a = torch.randn(300, 512, generator=gen, device=cuda).bfloat16()
    b = (torch.randn(512, 384, generator=gen, device=cuda)
         / 512 ** 0.5).bfloat16()
    for x, y, out_dtype, tol in ((a, b, torch.float32, 1e-2),
                                 (a.float(), b.float(), torch.bfloat16,
                                  1e-2)):
        ref = redas_gemm.gemm_reference(x, y, out_dtype)
        for conf in ({"dataflow": "os", "bm": 64, "bk": 64, "bn": 128},
                     {"dataflow": "ws", "bm": 64, "bk": 512, "bn": 64},
                     {"dataflow": "is", "bm": 64, "bk": 256, "bn": 64}):
            got = redas_gemm.gemm(x, y, out_dtype=out_dtype, **conf)
            torch.cuda.synchronize()
            assert got.dtype == out_dtype, conf
            assert _row_rel_l2(got, ref) <= tol, conf
        got = redas_gemm.gemm(_misaligned(x), y, bm=64, bk=64, bn=128,
                              out_dtype=out_dtype)
        assert _row_rel_l2(got, ref) <= tol
    x = torch.randn(4, 40, 256, generator=gen, device=cuda).bfloat16()
    w = (torch.randn(4, 256, 72, generator=gen, device=cuda) / 16).bfloat16()
    for xs, tile in ((x, (64, 64, 128)), (_misaligned(x), (32, 64, 64))):
        got = grouped_gemm.grouped_matmul(xs, w, tile=tile,
                                          out_dtype=torch.float32)
        assert got.dtype == torch.float32
        assert _row_rel_l2(got, grouped_gemm.grouped_matmul_reference(
            x, w, torch.float32)) <= 1e-4
    redas_gemm.reset_launches()
    got = Engine(backend="hopper").matmul(a, b, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert _row_rel_l2(got, redas_gemm.gemm_reference(
        a, b, torch.float32)) <= 1e-4
    assert sum(redas_gemm.launches.values()) == 1


@pytest.mark.card
@pytest.mark.parametrize("what", ["stages", "slabs"])
def test_redas_gemm_failed_launch_raises(cuda, monkeypatch, what):
    """A launch the CUDA entry refuses (a ring depth or a slab count it
    was not built for) raises and counts nothing: no fallback."""
    a = torch.randn(4, 512, device=cuda)
    b = torch.randn(512, 64, device=cuda)
    if what == "stages":
        monkeypatch.setattr(redas_gemm, "stream_stages", lambda *args: 5)
    else:
        monkeypatch.setattr(redas_gemm, "slab_count", lambda k, bk: 3)
    redas_gemm.reset_launches()
    with pytest.raises(RuntimeError, match="launch failed"):
        redas_gemm.gemm(a, b, dataflow="is", bm=16, bk=256, bn=64)
    assert sum(redas_gemm.launches.values()) == 0
    assert redas_gemm.reduce_launches == 0


@pytest.mark.card
def test_redas_gemm_raises_for_a_tile_off_the_menu(cuda):
    a = torch.randn(4, 256, device=cuda)
    b = torch.randn(256, 64, device=cuda)
    with pytest.raises(ValueError, match="menu"):
        redas_gemm.gemm(a, b, dataflow="ws", bm=16, bk=128, bn=64)
    with pytest.raises(ValueError, match="menu"):
        redas_gemm.gemm(a, b, dataflow="os", bm=16, bk=512, bn=64)
    with pytest.raises(ValueError, match="shared memory"):
        redas_gemm.gemm(a, b, dataflow="ws", bm=16, bk=1536, bn=64)  # f32


@pytest.mark.card
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("d", [16, 20, 64, 80, 128, 240, 256])
@pytest.mark.parametrize("sq,sk,bq,bk,causal,window", [
    (100, 100, 50, 50, True, 0),
    (100, 100, 64, 64, False, 0),      # blocks that divide nothing
    (256, 256, 64, 128, True, 32),
    (128, 64, 64, 64, True, 8),        # rows with no live key average v
    (200, 330, 64, 64, True, 0),       # Sq != Sk
    (300, 200, 64, 64, False, 40),
])
def test_flash_kernel_matches_plain_version(cuda, dtype, tol, d, sq, sk, bq,
                                            bk, causal, window):
    """Both routes at every head dim the reference takes: bf16 with D % 8
    == 0 on the wgmma route at its own tile, the rest on the sync route at
    the given blocks; one launch a call, on the expected route, and a
    repeat bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, 3, s, d, generator=gen, device=cuda).to(dtype)
               for s in (sq, sk, sk))
    wgmma = flash_attention.flash_route(q, k, v) == "wgmma"
    assert wgmma == (dtype == torch.bfloat16 and d % 8 == 0)
    blocks = {} if wgmma else {"bq": bq, "bk": bk}
    flash_attention.reset_launches()
    got = flash_attention.flash_attention(q, k, v, causal=causal,
                                          window=window, **blocks)
    torch.cuda.synchronize()
    assert flash_attention.launches == 1
    assert flash_attention.wgmma_launches == int(wgmma)
    ref = flash_attention.flash_attention_reference(q, k, v, causal=causal,
                                                    window=window, bk=bk)
    assert _row_rel_l2(got, ref) <= tol
    assert torch.equal(got, flash_attention.flash_attention(
        q, k, v, causal=causal, window=window, **blocks))


@pytest.mark.card
def test_flash_kernel_misaligned_base_takes_sync_route(cuda):
    """bf16 operands at a base TMA cannot take run on the sync kernel,
    counted as a launch but not as a wgmma launch, and agree with the
    plain version."""
    n = 2 * 4 * 200 * 128
    flat = torch.randn(3 * n + 1, device=cuda).bfloat16()
    q, k, v = (flat[1 + i * n:1 + (i + 1) * n].view(2, 4, 200, 128)
               for i in range(3))
    assert flash_attention.flash_route(q, k, v) == "sync"
    flash_attention.reset_launches()
    got = flash_attention.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.wgmma_launches) == (1, 0)
    ref = flash_attention.flash_attention_reference(q, k, v, causal=True)
    assert _row_rel_l2(got, ref) <= 1e-2


@pytest.mark.card
def test_flash_wgmma_route_refuses_other_blocks(cuda):
    """The wgmma route runs its own tile: other blocks raise before any
    launch, and nothing falls back to the sync route."""
    q = torch.randn(1, 2, 256, 128, device=cuda).bfloat16()
    flash_attention.reset_launches()
    with pytest.raises(ValueError, match="own tile"):
        flash_attention.flash_attention(q, q, q, bq=64, bk=64)
    assert flash_attention.launches == flash_attention.wgmma_launches == 0


#: the paged kernel's cases (page, H, KV, D, kv_len, n_bt): small tables
#: with holes, kv_len 0, 1, a page edge and ragged; qwen2-1.5b's decode tick
#: (the serve's 51-page table); granite's (G = 2, D = 64)
PAGED_LENS = (800, 0, 1, 16, 17, 400, 783, 255)
PAGED_CASES = {
    "p1": (1, 12, 2, 128, None, 5), "p16": (16, 12, 2, 128, None, 5),
    "p5d16": (5, 12, 2, 16, None, 5),
    "qwen": (16, 12, 2, 128, PAGED_LENS, 51),
    "granite": (16, 16, 8, 64, PAGED_LENS, 51),
}


def _paged_inputs(cuda, dtype, name, int8=False):
    """q, pools (int8 ones with distinct per-row scales from U(1e-3,
    2e-2), as tests/test_paged.py draws them), a permuted table with holes
    and kv_len for PAGED_CASES[name] (or the int8 test's (4, 24) case)."""
    page, h, kv, d, lens, n_bt = (
        PAGED_CASES[name] if name in PAGED_CASES else (4, 12, 2, 24, None, 5))
    lens = list(lens or [3 * page, 1, 0, 3 * page + 1, 2])
    rng = np.random.default_rng(page + d)
    b = len(lens)
    need = [-(-n // page) for n in lens]
    n_pool = sum(need) + 3
    perm = rng.permutation(n_pool)
    bt = np.full((b, n_bt), -1, np.int32)
    ptr = 0
    for i, n in enumerate(need):
        bt[i, :n] = perm[ptr:ptr + n]
        ptr += n
    gen = torch.Generator(device=cuda).manual_seed(page)
    q = torch.randn(b, 1, h, d, generator=gen, device=cuda).to(dtype)
    if int8:
        pools = tuple(torch.randint(-127, 128, (n_pool, page, kv, d),
                                    generator=gen, device=cuda,
                                    dtype=torch.int32).to(torch.int8)
                      for _ in range(2))
        scales = tuple(torch.rand(n_pool, page, kv, generator=gen,
                                  device=cuda) * 1.9e-2 + 1e-3
                       for _ in range(2))
    else:
        pools = tuple(torch.randn(n_pool, page, kv, d, generator=gen,
                                  device=cuda).to(dtype) for _ in range(2))
        scales = ()
    ln = torch.tensor(lens, dtype=torch.int32, device=cuda)
    return (q, *pools, torch.from_numpy(bt).to(cuda), ln, *scales), lens


def _check_paged_kernel(args, lens, tol, splits):
    """One launch at `splits` (None: the wrapper's) against the plain
    version per live row, the kv_len 0 rows exact zeros, a second launch
    bit for bit equal."""
    paged_attention.reset_launches()
    got = paged_attention.paged_attention(*args, splits=splits)
    again = paged_attention.paged_attention(*args, splits=splits)
    torch.cuda.synchronize()
    assert paged_attention.launches == 2
    ref = paged_attention.paged_attention_reference(*args)
    dead = [i for i, n in enumerate(lens) if n == 0]
    live = torch.tensor([i for i, n in enumerate(lens) if n > 0],
                        device=got.device)
    assert bool((got[dead] == 0).all())
    assert _row_rel_l2(got[live], ref[live]) <= tol
    assert torch.equal(got, again)


@pytest.mark.card
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("name", list(PAGED_CASES))
@pytest.mark.parametrize("splits", [1, None, 8])
def test_paged_kernel_matches_plain_version(cuda, dtype, tol, name, splits):
    """Float pools at C = 1, the wrapper's split and 8: slots with fewer
    live pages than C (kv_len 1, 2, 16) leave ranks dead."""
    args, lens = _paged_inputs(cuda, dtype, name)
    _check_paged_kernel(args, lens, tol, splits)


@pytest.mark.card
@pytest.mark.parametrize("dtype,tol,shape,tile", [
    (torch.bfloat16, 1e-2, (32, 32, 1024, 512), (64, 64, 64)),
    (torch.float32, 1e-4, (5, 20, 130, 70), (16, 64, 64)),   # ragged
])
def test_grouped_kernel_matches_plain_version(cuda, dtype, tol, shape, tile):
    e, c, d, f = shape
    gen = torch.Generator(device=cuda).manual_seed(c)
    x = torch.randn(e, c, d, generator=gen, device=cuda)
    x[:, c // 2:] = 0.0                      # capacity-padded rows
    x = x.to(dtype)
    w = (torch.randn(e, d, f, generator=gen, device=cuda) / d ** 0.5).to(dtype)
    grouped_gemm.reset_launches()
    got = grouped_gemm.grouped_matmul(x, w, tile=tile)
    torch.cuda.synchronize()
    assert grouped_gemm.launches == 1
    ref = grouped_gemm.grouped_matmul_reference(x, w)
    assert grouped_gemm.launches == 1        # the plain version never counts
    assert bool((got[:, c // 2:] == 0).all())
    assert _row_rel_l2(got[:, :c // 2], ref[:, :c // 2]) <= tol


#: granite's expert GEMMs (E, C, D, F) at 8 slots (chip_smoke.py's
#: GROUPED_SHAPES), then ragged ones: C = 20, 161 and 1921, E = 1 and 33,
#: D = 1000 (a multiple of 8, not of the ring's 64) and F = 200
GROUPED_WGMMA_SHAPES = [(32, 32, 1024, 512), (32, 32, 512, 1024),
                        (32, 1920, 1024, 512), (32, 1920, 512, 1024),
                        (32, 160, 1024, 512), (33, 20, 1000, 200),
                        (1, 161, 1024, 512), (4, 1921, 512, 200),
                        (3, 161, 1000, 200)]


def _grouped_operands(cuda, e, c, d, f, dtype=torch.bfloat16, pad=0):
    """x (E, C, D) with its last `pad` rows of every expert zero (capacity
    padding), w (E, D, F) scaled by 1 / sqrt(D)."""
    gen = torch.Generator(device=cuda).manual_seed(e * 7 + c + d + f)
    x = torch.randn(e, c, d, generator=gen, device=cuda)
    if pad:
        x[:, c - pad:] = 0.0
    w = torch.randn(e, d, f, generator=gen, device=cuda) / d ** 0.5
    return x.to(dtype), w.to(dtype)


@pytest.mark.card
@pytest.mark.parametrize("shape", GROUPED_WGMMA_SHAPES)
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_grouped_wgmma_kernel_matches_plain_version(cuda, shape, out_dtype):
    """The grouped wgmma kernel at every tile of its menu against
    `grouped_matmul_reference` at bf16 row tolerance, in both output
    dtypes: a repeat launch bit for bit equal, the capacity padding's
    zero rows exactly zero, every call counted on the wgmma route.  The
    same operands at a misaligned base run the sync kernel, which
    `wgmma_launches` does not count."""
    e, c, d, f = shape
    pad = min(8, c // 4)
    x, w = _grouped_operands(cuda, e, c, d, f, pad=pad)
    ref = grouped_gemm.grouped_matmul_reference(x, w, out_dtype)
    assert grouped_gemm.grouped_route(x, w) == "wgmma"
    grouped_gemm.reset_launches()
    for tile in grouped_gemm.WGMMA_TILES:
        got = grouped_gemm.grouped_matmul(x, w, tile=tile, out_dtype=out_dtype)
        again = grouped_gemm.grouped_matmul(x, w, tile=tile,
                                            out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert got.dtype == out_dtype and got.shape == (e, c, f)
        assert bool((got[:, c - pad:] == 0).all()), tile
        assert _row_rel_l2(got[:, :c - pad], ref[:, :c - pad]) <= 1e-2, tile
        assert torch.equal(got, again), tile
    calls = 2 * len(grouped_gemm.WGMMA_TILES)
    assert grouped_gemm.wgmma_launches == grouped_gemm.launches == calls
    off = _misaligned(x)
    assert grouped_gemm.grouped_route(off, w) == "sync"
    got = grouped_gemm.grouped_matmul(off, w, tile=(64, 64, 128),
                                      out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert _row_rel_l2(got[:, :c - pad], ref[:, :c - pad]) <= 1e-2
    assert grouped_gemm.wgmma_launches == calls
    assert grouped_gemm.launches == calls + 1


@pytest.mark.card
@pytest.mark.parametrize("shape", [(4, 20, 1000, 200), (3, 161, 1024, 512),
                                   (2, 32, 1024, 512)])
def test_grouped_wgmma_kernel_keeps_experts_apart(cuda, shape):
    """Expert isolation: changing x[1] and w[1], to other values and to
    Inf, leaves every other expert's y bit for bit the same at every
    wgmma tile (TMA's per-dimension zero fill never reads expert 1's rows
    from a box of expert 0 past its ragged C or D)."""
    e, c, d, f = shape
    x, w = _grouped_operands(cuda, e, c, d, f)
    others = [i for i in range(e) if i != 1]
    for tile in grouped_gemm.WGMMA_TILES:
        base = grouped_gemm.grouped_matmul(x, w, tile=tile)
        for fill in (None, float("inf")):
            x2, w2 = x.clone(), w.clone()
            if fill is None:
                x2[1] = -3 * x2[1]
                w2[1] = torch.flip(w2[1], dims=(0,))
            else:
                x2[1] = fill
                w2[1] = fill
            got = grouped_gemm.grouped_matmul(x2, w2, tile=tile)
            torch.cuda.synchronize()
            assert torch.equal(got[others], base[others]), (tile, fill)


@pytest.mark.card
def test_paged_scheduler_tokens_on_the_card_equal_the_cpu(cuda):
    cfg = get_config("qwen2-1.5b", smoke=True)
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab, 20)
    spec = []  # odd uids share a 20-token prefix
    for uid in range(6):
        own = rng.integers(0, cfg.vocab, 3 + uid if uid % 2 else 5 + 2 * uid)
        prompt = np.concatenate([prefix, own]) if uid % 2 else own
        spec.append((uid, prompt.astype(np.int32), 4 + uid))

    def run(device, backend, layout):
        scfg = serve.ServeConfig(max_seq=48, batch=2, compute_dtype="float32",
                                 cache_dtype="float32", kernel_backend=backend,
                                 device=device, cache_layout=layout,
                                 page_size=8)
        done = Scheduler(_to(params, device), cfg, scfg).run(
            [Request(uid=u, prompt=x, max_new_tokens=g) for u, x, g in spec])
        return {u: c.tokens.tolist() for u, c in done.items()}

    paged_attention.reset_launches()
    card = run("cuda", "hopper", "paged")
    assert paged_attention.launches > 0
    assert card == run("cpu", "torch-ref", "paged")
    assert card == run("cuda", "hopper", "contiguous")


def _int8_configs(m: int, k: int, n: int) -> list[dict]:
    """The int8 kernel's arguments a test holds at (m, k, n): on the
    decode path (m <= 16) split 1, the planner's split and the largest;
    every tile of the tiled menu."""
    configs = [{"tile": tile} for tile in quant_gemm.TILES]
    if m <= quant_gemm.DECODE_ROWS[-1]:
        from repro_torch.engine import HopperModel, KernelRequest

        planned = HopperModel().decide(KernelRequest(
            "gemm_w8", m, k, n, in_bytes=1, out_bytes=2)).meta_dict["split_k"]
        configs += [{"path": "decode", "split_k": s} for s in sorted(
            {1, planned, quant_gemm.DECODE_MAX_SPLIT})]
    return configs


def _int8_operands(cuda, m, k, n, seed):
    """Random int8 operands with row 0 of A and column 0 of B at -128 (the
    largest sum, K x 128^2) and row 1 / column 1 at +-127."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    a = torch.randint(-128, 128, (m, k), generator=gen, device=cuda,
                      dtype=torch.int32).to(torch.int8)
    b = torch.randint(-128, 128, (k, n), generator=gen, device=cuda,
                      dtype=torch.int32).to(torch.int8)
    a[0], b[:, 0] = -128, -128
    if m > 1:
        a[1] = 127
    b[:, 1] = -127
    return a, b


@pytest.mark.card
@pytest.mark.parametrize("m", [1, 5, 8, 16, 17, 33, 2048])
@pytest.mark.parametrize("k,n", [(1000, 200), (1000, 256), (1536, 1536),
                                 (1536, 256)])
def test_int8_kernel_matches_plain_version_bitwise(cuda, m, k, n):
    """Both paths (decode at M <= 16: split 1, the planner's and the
    largest; tiled: every menu tile), ragged M and N, K no multiple of a
    slice or chunk (1000: the byte-load path for A) and a whole one; the
    values at -128 and +-127, so the sums reach K x 128^2; each launched
    twice, bit for bit."""
    a, b = _int8_operands(cuda, m, k, n, m + k + n)
    ref = quant_gemm.gemm_int8_reference(a, b)
    assert ref[0, 0].item() == k * 128 * 128
    for kw in _int8_configs(m, k, n):
        first = quant_gemm.gemm_int8(a, b, **kw)
        again = quant_gemm.gemm_int8(a, b, **kw)
        torch.cuda.synchronize()
        assert first.dtype == torch.int32
        assert torch.equal(first, ref), kw
        assert torch.equal(again, first), kw


@pytest.mark.card
@pytest.mark.parametrize("m,k,n", [(8, 1536, 1536), (5, 1000, 200),
                                   (2048, 1536, 256), (33, 1000, 200)])
def test_int8_kernel_at_a_misaligned_base(cuda, m, k, n):
    """Operands whose bases are not 16-byte aligned (views one and three
    bytes into their buffers) take the byte-load branch on both paths and
    give the plain version's bits."""
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    a_buf, b_buf = (torch.randint(-128, 128, (size,), generator=gen,
                                  device=cuda, dtype=torch.int32)
                    .to(torch.int8) for size in (m * k + 1, k * n + 3))
    a, b = a_buf[1:].view(m, k), b_buf[3:].view(k, n)
    assert a.data_ptr() % 16 and b.data_ptr() % 16
    ref = quant_gemm.gemm_int8_reference(a, b)
    for kw in _int8_configs(m, k, n):
        got = quant_gemm.gemm_int8(a, b, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), kw


@pytest.mark.card
def test_int8_kernel_counts_one_launch_a_call_by_path(cuda):
    """Each call adds one to `launches` and one to its path's count, and
    nothing else; the CPU path adds nothing."""
    a, b = _int8_operands(cuda, 8, 1536, 256, 3)
    quant_gemm.reset_launches()
    quant_gemm.gemm_int8(a, b, path="decode", split_k=4)
    assert quant_gemm.launches == 1
    assert quant_gemm.path_launches == {"decode": 1, "tiled": 0}
    quant_gemm.gemm_int8(a, b, tile=quant_gemm.TILES[0])
    quant_gemm.gemm_int8(a.cpu(), b.cpu(), path="decode", split_k=4)
    torch.cuda.synchronize()
    assert quant_gemm.launches == 2
    assert quant_gemm.path_launches == {"decode": 1, "tiled": 1}


@pytest.mark.card
@pytest.mark.parametrize("jitted", [False, True])
def test_int8_codec_gives_the_cpus_bits_on_the_card(cuda, jitted):
    """Both scale forms are spelled out so the card gives the CPU's bits
    (torch itself divides a CUDA tensor by a Python number through the
    reciprocal)."""
    x = torch.randn(4096, 64, generator=torch.Generator().manual_seed(0))
    q, scale = kv_quantize(x.to(cuda), jitted=jitted)
    want_q, want_scale = kv_quantize(x, jitted=jitted)
    assert torch.equal(q.cpu(), want_q) and torch.equal(scale.cpu(), want_scale)
    got, want = quantize(x.to(cuda), jitted=jitted), quantize(x, jitted=jitted)
    assert torch.equal(got.q.cpu(), want.q)
    assert torch.equal(got.scale.cpu(), want.scale)


@pytest.mark.card
def test_int8_kernel_raises_for_a_tile_off_the_menu(cuda):
    a = torch.zeros(8, 64, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="menu"):
        quant_gemm.gemm_int8(a, a.T.contiguous(), tile=(16, 64, 64))


@pytest.mark.card
def test_int8_kernel_raises_for_a_split_off_the_menu(cuda):
    a = torch.zeros(8, 64, dtype=torch.int8, device=cuda)
    quant_gemm.reset_launches()
    for split in (0, quant_gemm.DECODE_MAX_SPLIT + 1):
        with pytest.raises(ValueError, match="split_k"):
            quant_gemm.gemm_int8(a, a.T.contiguous(), path="decode",
                                 split_k=split)
    assert quant_gemm.launches == 0


@pytest.mark.card
def test_quantized_scheduler_tokens_on_the_card_equal_the_cpu(cuda):
    """SMOKE f32 under quantize=True: the int8 kernel and the paged kernel
    on the card give the CPU plain run's tokens, paged and contiguous."""
    cfg = get_config("qwen2-1.5b", smoke=True)
    params = quantize_params(T.init_params(
        cfg, generator=torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(1)
    spec = [(uid, rng.integers(0, cfg.vocab, 4 + 3 * uid).astype(np.int32),
             3 + uid % 4) for uid in range(6)]

    def run(device, layout):
        scfg = serve.ServeConfig(max_seq=40, batch=2, compute_dtype="float32",
                                 cache_dtype="float32", quantize=True,
                                 device=device, cache_layout=layout,
                                 page_size=8)
        done = Scheduler(_to(params, device), cfg, scfg).run(
            [Request(uid=u, prompt=x, max_new_tokens=g) for u, x, g in spec])
        return {u: c.tokens.tolist() for u, c in done.items()}

    want = run("cpu", "paged")
    quant_gemm.reset_launches()
    assert run("cuda", "paged") == want
    assert quant_gemm.launches > 0
    assert run("cuda", "contiguous") == want


@pytest.mark.card
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("name", [*PAGED_CASES, "p4d24"])
@pytest.mark.parametrize("splits", [1, None, 8])
def test_paged_int8_kernel_matches_plain_version(cuda, dtype, tol, name,
                                                 splits):
    """int8 pools with distinct per-row scales (U(1e-3, 2e-2), as
    tests/test_paged.py draws them) at C = 1, the wrapper's split and 8;
    d 24 takes the plain-load path."""
    args, lens = _paged_inputs(cuda, dtype, name, int8=True)
    _check_paged_kernel(args, lens, tol, splits)


@pytest.mark.card
@pytest.mark.parametrize("trace", [None, "24x8,8x4*3"])
def test_quantize_launcher_on_the_card_serves_the_cpus_tokens(cuda, trace):
    """`--quantize` (int8 weights, int8 KV, hopper-int8) through the
    launcher on the card, SMOKE f32: its weights and prompts served on the
    CPU by the plain versions give the same tokens."""
    args = ["--arch", "qwen2-1.5b", "--smoke", "--quantize", "--batch", "2"]
    args += (["--prompt-len", "8", "--gen", "5"] if trace is None else
             ["--cache-layout", "paged", "--page-size", "8", "--trace", trace])
    paged_attention.reset_launches()
    quant_gemm.reset_launches()
    out = launch_serve.main(args)
    assert quant_gemm.launches > 0
    cpu = dataclasses.replace(out["serve_config"], device="cpu")
    params = _to(out["params"], "cpu")
    if trace is None:
        want = serve.generate(params, out["cfg"], cpu, out["prompt"].cpu(), 5)
        assert torch.equal(out["tokens"], want)
        return
    assert paged_attention.launches > 0
    sched = Scheduler(params, out["cfg"], cpu)
    done = sched.run(launch_serve.trace_requests(
        out["cfg"], launch_serve.parse_trace(trace), 0))
    card = out["scheduler"].completions
    assert {u: c.tokens.tolist() for u, c in done.items()} == {
        u: c.tokens.tolist() for u, c in card.items()}


@pytest.mark.card
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("n_keep,m_group,m,k,n", [
    (2, 4, 8, 1536, 1536), (2, 4, 4, 8960, 256), (2, 4, 33, 1003, 200),
    (1, 2, 8, 256, 128), (1, 4, 5, 300, 64), (4, 8, 16, 512, 192),
    (3, 7, 8, 1000, 130), (63, 64, 3, 200, 72), (1, 128, 2, 300, 64),
    (127, 128, 4, 256, 64)])
def test_sparse_kernel_matches_plain_version(cuda, dtype, tol, n_keep,
                                             m_group, m, k, n):
    """Every tile of the tiled path's menu and, at M <= 16, the decode
    path at every split of `_splits`; the f32-output path included."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(m, k, generator=gen, device=cuda).to(dtype)
    st = sparsify(torch.randn(k, n, generator=gen, device=cuda).to(dtype),
                  n_keep, m_group)
    kw = {"n_keep": n_keep, "m_group": m_group}
    sparse_gemm.reset_launches()
    configs = _sparse_configs(m, k, n_keep, m_group, a.element_size())
    for conf in configs:
        for out in (dtype, torch.float32):
            got = sparse_gemm.sparse_gemm(a, st.values, st.indices,
                                          out_dtype=out, **conf, **kw)
            ref = sparse_gemm.sparse_gemm_reference(
                a, st.values, st.indices, out_dtype=out, **kw)
            assert got.dtype == out and got.shape == (m, n)
            assert _row_rel_l2(got, ref) <= (tol if out == dtype else 1e-4)
    assert sparse_gemm.launches == 2 * len(configs)


@pytest.mark.card
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_sparse_kernel_takes_any_index_array(cuda, dtype, tol):
    """Offsets out of range (negative, M, up to 127) add nothing and
    repeated offsets add: the one-hot sum of the plain version, on both
    paths."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    for n_keep, m_group in ((2, 4), (3, 7)):
        k_c = -(-300 // m_group) * n_keep
        a = torch.randn(9, 300, generator=gen, device=cuda).to(dtype)
        v = torch.randn(k_c, 70, generator=gen, device=cuda).to(dtype)
        i = torch.randint(-128, 128, (k_c, 70), generator=gen, device=cuda,
                          dtype=torch.int32).to(torch.int8)
        i[::3] = torch.randint(0, m_group, (len(i[::3]), 70), generator=gen,
                               device=cuda, dtype=torch.int32).to(torch.int8)
        i[1::3] = i[::3][:len(i[1::3])]          # repeats within a group
        kw = {"n_keep": n_keep, "m_group": m_group}
        ref = sparse_gemm.sparse_gemm_reference(a, v, i, **kw)
        for conf in _sparse_configs(9, 300, n_keep, m_group,
                                    a.element_size()):
            got = sparse_gemm.sparse_gemm(a, v, i, **conf, **kw)
            assert _row_rel_l2(got, ref) <= tol


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_kernel_repeat_launches_are_bit_identical(cuda, dtype):
    """No atomics: two launches on the same inputs give the same bits on
    both paths and at every split (the reduction sums in split order)."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    for m, k, n, n_keep, m_group in ((8, 1536, 1536, 2, 4),
                                     (5, 1003, 200, 3, 7)):
        a = torch.randn(m, k, generator=gen, device=cuda).to(dtype)
        st = sparsify(torch.randn(k, n, generator=gen, device=cuda).to(dtype),
                      n_keep, m_group)
        for conf in _sparse_configs(m, k, n_keep, m_group, a.element_size()):
            kw = {"n_keep": n_keep, "m_group": m_group,
                  "out_dtype": torch.float32, **conf}
            first = sparse_gemm.sparse_gemm(a, st.values, st.indices, **kw)
            again = sparse_gemm.sparse_gemm(a, st.values, st.indices, **kw)
            assert torch.equal(first, again), conf


@pytest.mark.card
def test_sparse_counters_count_gemms_and_reductions(cuda):
    """`launches` counts one per sparse GEMM whatever the path,
    `path_launches` splits it by path, and `reduce_launches` counts the
    split-K reduction, which runs only at split_k > 1."""
    st = sparsify(torch.randn(512, 256, device=cuda), 2, 4)
    a = torch.randn(8, 512, device=cuda)
    kw = {"n_keep": 2, "m_group": 4}
    sparse_gemm.reset_launches()
    sparse_gemm.sparse_gemm(a, st.values, st.indices, path="decode",
                            split_k=1, **kw)
    sparse_gemm.sparse_gemm(a, st.values, st.indices, path="decode",
                            split_k=5, **kw)
    sparse_gemm.sparse_gemm(a, st.values, st.indices, **kw)
    sparse_gemm.sparse_gemm_reference(a, st.values, st.indices, **kw)
    assert sparse_gemm.launches == 3
    assert sparse_gemm.path_launches == {"decode": 2, "tiled": 1}
    assert sparse_gemm.reduce_launches == 1
    ws = torch.randn(3, 8, 256, device=cuda)
    got = sparse_gemm.split_reduce(ws, torch.float32)
    assert torch.equal(got, sparse_gemm.split_reduce_reference(
        ws, torch.float32))
    assert sparse_gemm.reduce_launches == 2 and sparse_gemm.launches == 3
    sparse_gemm.reset_launches()
    assert (sparse_gemm.launches, sparse_gemm.reduce_launches) == (0, 0)
    assert sparse_gemm.path_launches == {"decode": 0, "tiled": 0}


@pytest.mark.card
@pytest.mark.parametrize("path", ["decode", "tiled"])
def test_sparse_kernel_failed_launch_raises(cuda, monkeypatch, path):
    """A launch the CUDA entry refuses (a row bucket or a stage count it
    was not built for) raises, and counts nothing: no fallback."""
    st = sparsify(torch.randn(256, 64, device=cuda), 2, 4)
    a = torch.randn(4, 256, device=cuda)
    if path == "decode":
        monkeypatch.setattr(sparse_gemm, "decode_rows", lambda m: 5)
        kw = {"path": "decode", "split_k": 2}
    else:
        monkeypatch.setattr(sparse_gemm, "tiled_stages", lambda *args: 3)
        kw = {}
    sparse_gemm.reset_launches()
    with pytest.raises(RuntimeError, match="launch failed"):
        sparse_gemm.sparse_gemm(a, st.values, st.indices, n_keep=2,
                                m_group=4, **kw)
    assert sparse_gemm.launches == sparse_gemm.reduce_launches == 0


@pytest.mark.card
def test_sparse_kernel_raises_for_a_tile_off_the_menu(cuda):
    st = sparsify(torch.randn(64, 32, device=cuda), 2, 4)
    with pytest.raises(ValueError, match="menu"):
        sparse_gemm.sparse_gemm(torch.randn(4, 64, device=cuda), st.values,
                                st.indices, n_keep=2, m_group=4,
                                tile=(16, 64, 64))


@pytest.mark.card
@pytest.mark.parametrize("trace", [None, "24x8,8x4*3"])
def test_sparsity_launcher_on_the_card_serves_the_cpus_tokens(cuda, trace):
    """`--sparsity 2:4` (float N:M weights, hopper-sparse) through the
    launcher on the card, SMOKE f32: its pruned weights and prompts served
    on the CPU by the plain versions give the same tokens, and so does the
    densified tree served plain on the CPU."""
    args = ["--arch", "qwen2-1.5b", "--smoke", "--sparsity", "2:4",
            "--batch", "2"]
    args += (["--prompt-len", "8", "--gen", "5"] if trace is None else
             ["--cache-layout", "paged", "--page-size", "8", "--trace", trace])
    sparse_gemm.reset_launches()
    out = launch_serve.main(args)
    assert out["serve_config"].kernel_backend == "hopper-sparse"
    assert sparse_gemm.launches > 0
    cpu = dataclasses.replace(out["serve_config"], device="cpu")
    params = _to(out["params"], "cpu")
    if trace is None:
        want = serve.generate(params, out["cfg"], cpu, out["prompt"].cpu(), 5)
        assert torch.equal(out["tokens"], want)
        dense = dataclasses.replace(cpu, sparsity=None, kernel_backend=None)
        assert torch.equal(out["tokens"], serve.generate(
            densify_params(params), out["cfg"], dense, out["prompt"].cpu(), 5))
        return
    sched = Scheduler(params, out["cfg"], cpu)
    done = sched.run(launch_serve.trace_requests(
        out["cfg"], launch_serve.parse_trace(trace), 0))
    card = out["scheduler"].completions
    assert {u: c.tokens.tolist() for u, c in done.items()} == {
        u: c.tokens.tolist() for u, c in card.items()}


@pytest.mark.card
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("n_keep,m_group,m,k,n", [
    (2, 4, 8, 1536, 1536), (2, 4, 4, 8960, 256), (2, 4, 33, 1003, 200),
    (1, 2, 8, 256, 128), (1, 4, 5, 300, 64), (4, 8, 16, 512, 192),
    (3, 7, 8, 1000, 130), (63, 64, 3, 200, 72), (1, 128, 2, 300, 64),
    (127, 128, 4, 256, 64)])
def test_sparse_int8_kernel_matches_plain_version(cuda, dtype, tol, n_keep,
                                                  m_group, m, k, n):
    """The int8-value variant (int8 values, per-column f32 scale) at every
    tile of the tiled menu and, at M <= 16, the decode path at every split
    of `_sparse_configs`, in A's dtype and in f32; two launches of each
    configuration bit for bit; counted apart from the float variant."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randn(m, k, generator=gen, device=cuda).to(dtype)
    st = sparsify(torch.randn(k, n, generator=gen, device=cuda), n_keep,
                  m_group, quantize=True)
    assert st.values.dtype == torch.int8
    kw = {"n_keep": n_keep, "m_group": m_group}
    sparse_gemm.reset_launches()
    configs = _sparse_configs(m, k, n_keep, m_group, a.element_size(),
                              int8=True)
    for conf in configs:
        for out in (dtype, torch.float32):
            got = sparse_gemm.sparse_gemm(a, st.values, st.indices, st.scale,
                                          out_dtype=out, **conf, **kw)
            again = sparse_gemm.sparse_gemm(a, st.values, st.indices,
                                            st.scale, out_dtype=out, **conf,
                                            **kw)
            ref = sparse_gemm.sparse_gemm_reference(
                a, st.values, st.indices, st.scale, out_dtype=out, **kw)
            assert got.dtype == out and got.shape == (m, n)
            assert torch.equal(got, again), conf
            assert _row_rel_l2(got, ref) <= (tol if out == dtype else 1e-4)
    assert sparse_gemm.int8_launches == 4 * len(configs)
    assert sparse_gemm.launches == 0
    want = {"tiled": 4 * len(sparse_gemm.TILES)}
    want["decode"] = 4 * len(configs) - want["tiled"]
    assert sparse_gemm.int8_path_launches == want


@pytest.mark.card
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_sparse_int8_kernel_at_the_extremes(cuda, dtype, tol):
    """Values of -127 and 127, a column whose kept values are all zero
    (scale 1.0) and a scale given as (N,): the plain version's product on
    both paths."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    w = torch.randn(1536, 200, generator=gen, device=cuda)
    w[:, 7] = 0.0
    w[::3, 11] = 50.0
    w[1::3, 11] = -50.0
    st = sparsify(w, 2, 4, quantize=True)
    assert st.scale[0, 7].item() == 1.0 and not st.values[:, 7].any()
    assert {-127, 127} <= set(st.values[:, 11].tolist())
    scale = st.scale.reshape(-1)
    for m in (8, 40):
        a = torch.randn(m, 1536, generator=gen, device=cuda).to(dtype)
        ref = sparse_gemm.sparse_gemm_reference(a, st.values, st.indices,
                                                scale, n_keep=2, m_group=4)
        assert not ref[:, 7].any()
        for conf in _sparse_configs(m, 1536, 2, 4, a.element_size(),
                                    int8=True):
            got = sparse_gemm.sparse_gemm(a, st.values, st.indices, scale,
                                          n_keep=2, m_group=4, **conf)
            assert not got[:, 7].any()
            assert _row_rel_l2(got, ref) <= tol


@pytest.mark.card
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(44, 8, 1536), (3, 5, 1003)])
@pytest.mark.parametrize("scaled", [True, False])
def test_sparse_scaled_reduction_equals_plain_bitwise(cuda, out, shape,
                                                      scaled):
    """The split-K reduction with a scale (and without): the partials
    summed in split order, then times the column's scale, bit for bit its
    plain version, with 16-byte loads (M x N a multiple of 4) and without
    (a ragged 5 x 1003)."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    ws = torch.randn(*shape, generator=gen, device=cuda)
    scale = (torch.rand(1, shape[-1], generator=gen, device=cuda) * 0.02
             + 1e-3) if scaled else None
    sparse_gemm.reset_launches()
    got = sparse_gemm.split_reduce(ws, out, scale)
    assert torch.equal(got, sparse_gemm.split_reduce_reference(ws, out,
                                                               scale))
    assert sparse_gemm.reduce_launches == 1


def _sparse_configs(m, k, n_keep, m_group, itemsize, int8=False):
    """The kernel arguments a card test holds at (m, k): every tile of the
    tiled menu and, at M <= 16, the decode path at split 1, the planner's
    split (keyed at in_bytes 1 for `int8` values), one group a split, and
    past the groups (empty splits)."""
    from repro_torch.engine import HopperModel, KernelRequest

    configs = [{"path": "tiled", "tile": t} for t in sparse_gemm.TILES]
    if m <= sparse_gemm.DECODE_ROWS[-1]:
        dec = HopperModel().decide(KernelRequest(
            "gemm_sparse", m, k, 256, in_bytes=1 if int8 else itemsize,
            out_bytes=itemsize, density=n_keep / m_group))
        top = sparse_gemm.max_split(k, m_group)
        for split in sorted({1, dec.meta_dict["split_k"], top, top + 3}):
            configs.append({"path": "decode", "split_k": split})
    return configs


@pytest.mark.card
@pytest.mark.parametrize("trace", [None, "24x8,8x4*3"])
def test_sparse_int8_launcher_on_the_card_serves_the_cpus_tokens(cuda, trace):
    """`--sparsity 2:4 --quantize` (sparse x int8 weights, an int8 KV
    cache, hopper-sparse) through the launcher on the card, SMOKE f32:
    its weights and prompts served on the CPU by the plain versions give
    the same tokens; every pruned matmul ran on the int8-value variant."""
    args = ["--arch", "qwen2-1.5b", "--smoke", "--sparsity", "2:4",
            "--quantize", "--batch", "2"]
    args += (["--prompt-len", "8", "--gen", "5"] if trace is None else
             ["--cache-layout", "paged", "--page-size", "8", "--trace", trace])
    sparse_gemm.reset_launches()
    out = launch_serve.main(args)
    assert out["serve_config"].kernel_backend == "hopper-sparse"
    assert out["serve_config"].cache_dtype == torch.int8
    assert sparse_gemm.int8_launches > 0 and sparse_gemm.launches == 0
    card_cfg = out["serve_config"]
    cpu = serve.ServeConfig(
        max_seq=card_cfg.max_seq, batch=2, compute_dtype=torch.float32,
        cache_dtype=torch.int8, quantize=True, sparsity="2:4", device="cpu",
        cache_layout=card_cfg.cache_layout, page_size=8)
    params = _to(out["params"], "cpu")
    if trace is None:
        want = serve.generate(params, out["cfg"], cpu, out["prompt"].cpu(), 5)
        assert torch.equal(out["tokens"], want)
        return
    sched = Scheduler(params, out["cfg"], cpu)
    done = sched.run(launch_serve.trace_requests(
        out["cfg"], launch_serve.parse_trace(trace), 0))
    card = out["scheduler"].completions
    assert {u: c.tokens.tolist() for u, c in done.items()} == {
        u: c.tokens.tolist() for u, c in card.items()}


#: the SMOKE configurations of qwen3-14b, mistral-large-123b, gemma3-12b
#: and recurrentgemma-2b (both also under --quantize), mamba2-780m and
#: mixtral-8x7b (both MoE dispatches)
NEW_SMOKE = [("qwen3-14b", None), ("mistral-large-123b", None),
             ("gemma3-12b", None), ("gemma3-12b", "quantize"),
             ("mixtral-8x7b", "einsum"), ("mixtral-8x7b", "sort"),
             ("mamba2-780m", None), ("recurrentgemma-2b", None),
             ("recurrentgemma-2b", "quantize")]


@pytest.mark.card
@pytest.mark.parametrize("arch,posture", NEW_SMOKE,
                         ids=[f"{a}-{p}" if p else a for a, p in NEW_SMOKE])
def test_new_smoke_archs_tokens_on_the_card_equal_the_cpu(cuda, arch,
                                                          posture):
    """SMOKE f32: the card's greedy tokens (the hand-written kernels) equal
    the CPU plain run's, static (2 x (40 + 6), past the 16-row windows)
    and through the Scheduler, paged and contiguous; a paged ServeConfig
    builds the paged plane only where the arch has "attn" layers."""
    cfg = get_config(arch, smoke=True)
    if posture in ("einsum", "sort"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, impl=posture))
    quant = posture == "quantize"
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0))
    if quant:
        params = quantize_params(params)
    kw = dict(compute_dtype="float32", quantize=quant,
              cache_dtype="int8" if quant else "float32")
    rng = np.random.default_rng(3)
    spec = [(uid, rng.integers(0, cfg.vocab, 5 + 7 * uid).astype(np.int32),
             3 + uid % 4) for uid in range(6)]
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40)).astype(
        np.int32))

    def run(device, backend, layout):
        p = _to(params, device)
        if layout is None:
            return serve.generate(p, cfg, serve.ServeConfig(
                max_seq=47, batch=2, kernel_backend=backend, device=device,
                **kw), prompt.to(device), 6).cpu().tolist()
        sched = Scheduler(p, cfg, serve.ServeConfig(
            max_seq=48, batch=2, kernel_backend=backend, device=device,
            cache_layout=layout, page_size=8, **kw))
        assert (layout == "paged" and "attn" in cfg.layer_pattern) == (
            sched.paged is not None)
        done = sched.run([Request(uid=u, prompt=x, max_new_tokens=g)
                          for u, x, g in spec])
        return {u: c.tokens.tolist() for u, c in done.items()}

    for layout in (None, "paged", "contiguous"):
        assert run("cuda", "hopper", layout) == run("cpu", "torch-ref",
                                                    layout), layout


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.card
@pytest.mark.parametrize("arch", ["internvl2-1b", "hubert-xlarge"])
def test_embedding_input_archs_on_the_card_equal_the_cpu(cuda, arch):
    """SMOKE f32: internvl2-1b's greedy tokens after an 8-row prefix of
    patch embeddings, and hubert-xlarge's forward logits over 40 frames
    (within 1e-4 rel-L2), on the card (`hopper`) against the CPU's plain
    run (`torch-ref`)."""
    from repro_torch.engine import Engine, use_engine

    cfg = get_config(arch, smoke=True)
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (2, 40), generator=gen,
                           dtype=torch.int32)
    rows = 40 if cfg.embed_inputs else cfg.prefix_tokens
    embeds = torch.randn(2, rows, cfg.d_model, generator=gen)

    def run(device, backend):
        p = _to(params, device)
        if cfg.embed_inputs:
            with torch.inference_mode(), use_engine(Engine(backend=backend)):
                return T.forward(p, cfg, None, embeds=embeds.to(device),
                                 compute_dtype=torch.float32)[0].cpu()
        return serve.generate(p, cfg, serve.ServeConfig(
            max_seq=rows + 48 + 1, batch=2, compute_dtype="float32",
            cache_dtype="float32", kernel_backend=backend, device=device),
            prompt.to(device), 8, embeds=0.02 * embeds.to(device)).cpu()

    redas_gemm.reset_launches()
    got = run("cuda", "hopper")
    assert sum(redas_gemm.launches.values()) > 0
    want = run("cpu", "torch-ref")
    if cfg.embed_inputs:
        assert ((got - want).norm() / want.norm()).item() <= 1e-4
    else:
        assert torch.equal(got, want)


# --------------------------------------------------------------------------
# The accelerator plane and warm-started serving on the card
# --------------------------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("df", ["os", "ws", "is"])
@pytest.mark.parametrize("m,k,n,shape", [(13, 20, 9, None),
                                         (30, 17, 24, (40, 32))])
def test_simulator_on_the_card_equals_the_cpu(cuda, df, m, k, n, shape):
    """The cycle-level simulator on CUDA tensors: the CPU's output (the
    same f32 fused multiply-adds in the same order) within 1e-6, equal
    cycles, and a float64 product within 1e-5; batched too."""
    from repro_torch.core import simulator as sim
    from repro_torch.core.dataflow import Dataflow, LogicalShape

    shape = None if shape is None else LogicalShape(*shape)
    gen = torch.Generator().manual_seed(m * k + n)
    a, b = torch.randn(3, m, k, generator=gen), torch.randn(3, k, n,
                                                            generator=gen)
    for fn, x, y in (("simulate_gemm", a[0], b[0]),
                     ("simulate_gemm_batch", a, b)):
        got, cyc = getattr(sim, fn)(x.to(cuda), y.to(cuda), Dataflow(df),
                                    shape)
        want, want_cyc = getattr(sim, fn)(x, y, Dataflow(df), shape)
        assert got.device.type == "cuda" and cyc == want_cyc
        torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got.cpu().double(), x.double() @ y.double(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.card
def test_simulator_engine_on_the_card(cuda):
    """`Engine(AnalyticalCostModel()).matmul` on CUDA tensors: the mapper's
    decision executed on the simulator, equal to the CPU's call."""
    from repro_torch.engine import AnalyticalCostModel, Engine

    gen = torch.Generator().manual_seed(5)
    a, b = torch.randn(70, 33, generator=gen), torch.randn(33, 50,
                                                           generator=gen)
    eng = Engine(AnalyticalCostModel())
    got = eng.matmul(a.to(cuda), b.to(cuda))
    want = eng.matmul(a, b)
    assert eng.plan.misses == 1 and eng.plan.hits == 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got.cpu().double(), a.double() @ b.double(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.card
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_warm_started_smoke_serve_on_the_card_plans_nothing(cuda, layout,
                                                           tmp_path):
    """qwen2 SMOKE f32 through the Scheduler on the card, warm-started
    from `plan_arch` for its posture: no new miss over the serve, the
    kernels launched, the tokens of the cold serve on the card."""
    from repro_torch.engine import Engine, plan_arch

    cfg = get_config("qwen2-1.5b", smoke=True)
    params = T.init_params(cfg, generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda)
    rng = np.random.default_rng(0)
    reqs = [(u, rng.integers(0, cfg.vocab, p).astype(np.int32), g)
            for u, (p, g) in enumerate([(40, 6), (5, 9), (17, 3), (33, 8)])]
    kw = dict(max_seq=64, batch=4, compute_dtype="float32",
              cache_dtype="float32", kernel_backend="hopper", device="cuda",
              cache_layout=layout, page_size=16)
    plan = plan_arch(cfg, dtype_bytes=4, decode_batch=4,
                     admit_widths=(16, 32, 48, 64),
                     paged_pages=4 if layout == "paged" else 0,
                     page_size=16 if layout == "paged" else 0)
    plan.save(tmp_path / "plan.json")

    def run(scfg, engine=None):
        sched = Scheduler(params, cfg, scfg, engine=engine, prefill_bucket=16)
        return sched, sched.run([Request(uid=u, prompt=p.copy(),
                                         max_new_tokens=g)
                                 for u, p, g in reqs])

    scfg = serve.ServeConfig(**kw)
    _, cold = run(scfg, Engine(backend="hopper"))
    wscfg = serve.ServeConfig(**kw, plan_path=str(tmp_path / "plan.json"))
    eng = serve.warm_start_engine(wscfg)
    misses = eng.plan.misses
    redas_gemm.reset_launches()
    sched, warm = run(wscfg)
    assert sched.engine is eng and eng.plan.misses == misses
    assert sum(redas_gemm.launches.values()) > 0
    for uid in cold:
        np.testing.assert_array_equal(warm[uid].tokens, cold[uid].tokens)


# --------------------------------------------------------------------------
# The kernels' VJPs and the train step on the card
# --------------------------------------------------------------------------


def _vjp_pair(run, plain, inputs, g):
    """Cotangents through the port's Function (`run`) and through autograd
    of the plain version (`plain`) on the same CUDA operands."""
    out = []
    for fn in (run, plain):
        ts = [t.detach().clone().requires_grad_() for t in inputs]
        out.append(torch.autograd.grad(fn(*ts), ts, grad_outputs=g))
    return out


@pytest.mark.card
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("shape", [(512, 1536, 256), (96, 1536, 8960),
                                   (33, 100, 72)])
def test_gemm_vjp_on_the_card(cuda, dtype, tol, shape):
    from repro_torch.engine import Engine
    from repro_torch.engine.backends import DiffGemm

    m, k, n = shape
    gen = torch.Generator(device=cuda).manual_seed(m)
    a, b, g = (torch.randn(*s, device=cuda, generator=gen, dtype=dtype)
               for s in ((m, k), (k, n), (m, n)))
    eng = Engine(backend="hopper")
    out = eng.matmul(a.requires_grad_(), b)
    assert type(out.grad_fn) is DiffGemm._backward_cls
    before = redas_gemm.launches["os"]
    got, want = _vjp_pair(eng.matmul, lambda x, y: (x.float() @ y.float())
                          .to(dtype), (a, b), g)
    assert redas_gemm.launches["os"] - before >= 2   # dA and dB on row 1
    for x, y in zip(got, want):
        assert _row_rel_l2(x, y) <= tol


@pytest.mark.card
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_grouped_vjp_on_the_card(cuda, dtype, tol):
    from repro_torch.engine import Engine

    gen = torch.Generator(device=cuda).manual_seed(5)
    x, w, g = (torch.randn(*s, device=cuda, generator=gen, dtype=dtype)
               for s in ((32, 64, 1024), (32, 1024, 512), (32, 64, 512)))
    before = grouped_gemm.launches
    got, want = _vjp_pair(Engine(backend="hopper").grouped_matmul,
                          lambda x, w: (x.float() @ w.float()).to(dtype),
                          (x, w), g)
    assert grouped_gemm.launches - before == 3       # forward, dx, dw
    for p, q in zip(got, want):
        assert _row_rel_l2(p, q) <= tol


@pytest.mark.card
def test_int8_and_sparse_vjps_on_the_card(cuda):
    """The int8 GEMM's, the w8 GEMM's and both sparse GEMMs' cotangents on
    "hopper-*" against the plain backends on the same CUDA operands (the
    backward is float, row 1); pruned positions of dV exactly 0."""
    from repro_torch.engine import Engine

    gen = torch.Generator(device=cuda).manual_seed(6)
    a, b, g = (torch.randn(*s, device=cuda, generator=gen,
                           dtype=torch.bfloat16)
               for s in ((256, 1536), (1536, 256), (256, 256)))
    kern, plain = Engine(backend="hopper-int8"), Engine(backend="torch-ref-int8")
    got, want = _vjp_pair(kern.matmul, plain.matmul, (a, b), g)
    for p, q in zip(got, want):
        assert _row_rel_l2(p, q) <= 1e-2
    qt = quantize(b)
    got, want = _vjp_pair(lambda x: kern.quant_matmul(x, qt.q, qt.scale),
                          lambda x: plain.quant_matmul(x, qt.q, qt.scale),
                          (a,), g)
    assert _row_rel_l2(got[0], want[0]) <= 1e-2
    skern, splain = Engine(backend="hopper-sparse"), Engine(
        backend="torch-ref-sparse")
    st = sparsify(b, 2, 4)

    def sparse(eng):
        return lambda x, v: eng.sparse_matmul(x, sparse_gemm_tensor(st, v))

    got, want = _vjp_pair(sparse(skern), sparse(splain), (a, st.values), g)
    for p, q in zip(got, want):
        assert _row_rel_l2(p, q) <= 1e-2
    dense = sparse_gemm.scatter_dense(got[1].float(), st.indices, 2, 4)
    kept = sparse_gemm.scatter_dense(torch.ones_like(st.values, dtype=torch.float32),
                                     st.indices, 2, 4)
    assert (dense[kept == 0] == 0).all()
    sq = sparsify(b, 2, 4, quantize=True)
    got, want = _vjp_pair(lambda x: skern.sparse_matmul(x, sq),
                          lambda x: splain.sparse_matmul(x, sq), (a,), g)
    assert _row_rel_l2(got[0], want[0]) <= 1e-2


def sparse_gemm_tensor(st, values):
    from repro_torch.sparse.nm import SparseTensor

    return SparseTensor(values, st.indices, st.scale, n=st.n, m=st.m,
                        k_dense=st.k_dense)


@pytest.mark.card
def test_flash_scan_vjp_on_the_card(cuda):
    from repro_torch.models import layers

    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn(*s, device=cuda, generator=gen)
               for s in ((2, 96, 12, 64), (2, 130, 2, 64), (2, 130, 2, 64)))
    g = torch.randn(2, 96, 12, 64, device=cuda, generator=gen)
    pos = (torch.arange(34, 130, device=cuda, dtype=torch.int32)
           .expand(2, 96).contiguous())
    kv_len = torch.tensor([130, 100], device=cuda, dtype=torch.int32)
    got, want = _vjp_pair(
        lambda *t: layers.flash_attention(*t, pos, kv_len, True, 40, 48),
        lambda *t: layers._flash_scan(*t, pos, kv_len, True, 40, 48),
        (q, k, v), g)
    for p, r in zip(got, want):
        torch.testing.assert_close(p, r, rtol=1e-5, atol=1e-5)


@pytest.mark.card
def test_smoke_train_step_on_the_card_equals_the_cpu(cuda):
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.train_lib import train as train_lib
    from repro_torch.tree import flatten_with_path, tree_map

    cfg = get_config("qwen2-1.5b", smoke=True)
    batch = make_source(cfg, DataConfig(batch=4, seq_len=32)).batch(0)
    out = {}
    for dev in ("cpu", "cuda"):
        tcfg = train_lib.TrainConfig(microbatches=2,
                                     compute_dtype=torch.float32,
                                     kernel_backend="hopper")
        state = train_lib.init_state(
            cfg, tcfg, generator=torch.Generator().manual_seed(0))
        state = tree_map(lambda t: t.to(dev), state)
        step = train_lib.make_train_step(cfg, tcfg)
        new, _ = step(state, train_lib.device_batch(batch, dev))
        out[dev] = dict(flatten_with_path(new))
    for key, leaf in out["cpu"].items():
        torch.testing.assert_close(out["cuda"][key].cpu(), leaf, rtol=2e-4,
                                   atol=2e-4, msg=key)

