"""The port's grouped (per-expert) GEMM on the CPU: the plain version of
`kernels/grouped_gemm.py` against the JAX Pallas kernel (interpret mode)
and the JAX plain version, the CPU path of its wrapper and its checks,
its two routes (`grouped_route`) and the tile menu of each that the CUDA
source is compiled for, `HopperModel`'s grouped decision (the wgmma
route through `gemm_cost`'s wave term with the experts as a batch, the
sync route and int8 on the roofline) and its JSON round trip, the
backend's tile snap, and the engine entry point `Engine.grouped_matmul`
(memo key, dim check and plan counts as in the JAX engine).

The CUDA kernels run only on the card: `chip_smoke.py` and
tests/test_torch_card.py hold them against this plain version there.
Tolerance rtol 2e-5, atol 2e-4, as tests/test_kernels.py holds the f32
TPU kernels to their oracle (f32 both sides; only the order of sums
differs); a bf16 output within one bf16 ulp (rtol 2^-7), the f32 sums
then rounding either way.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jax_engine
from repro.kernels import grouped_gemm as jgg
from repro.kernels.ref import grouped_matmul_ref
from repro_torch.engine import (Engine, ExecutionPlan, HopperModel,
                                KernelRequest, cost)
from repro_torch.engine.backends import grouped_tile, hopper_grouped_gemm
from repro_torch.engine.plan import KernelDecision
from repro_torch.kernels import grouped_gemm, quant_gemm, redas_gemm

TOL = {"rtol": 2e-5, "atol": 2e-4}


def _operands(e, c, d, f, seed=0, zero_rows=0):
    """x (E, C, D) with its last `zero_rows` rows of every expert zero
    (capacity padding), w (E, D, F)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(e, c, d)).astype(np.float32)
    if zero_rows:
        x[:, c - zero_rows:] = 0.0
    w = (rng.normal(size=(e, d, f)) / np.sqrt(d)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("e,c,d,f,zero_rows", [
    (4, 16, 64, 32, 0),
    (3, 20, 40, 24, 8),        # ragged C, D and F; capacity-padded rows
    (8, 4, 64, 32, 3),         # decode capacity: 4 rows, mostly zeros
    (2, 37, 130, 70, 0),       # nothing a multiple of anything
])
def test_plain_version_matches_pallas_kernel_and_jax_ref(e, c, d, f,
                                                         zero_rows):
    x, w = _operands(e, c, d, f, seed=c, zero_rows=zero_rows)
    got = grouped_gemm.grouped_matmul_reference(torch.from_numpy(x),
                                                torch.from_numpy(w)).numpy()
    pallas = jgg.grouped_matmul(jnp.asarray(x), jnp.asarray(w),
                                interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    ref = grouped_matmul_ref(jnp.asarray(x.reshape(e * c, d)), jnp.asarray(w),
                             [c] * e)
    np.testing.assert_allclose(got, np.asarray(ref).reshape(e, c, f), **TOL)
    if zero_rows:
        assert not got[:, c - zero_rows:].any()   # zero rows stay exact zeros


def test_wrapper_on_cpu_takes_plain_version_without_counting():
    x, w = (torch.from_numpy(a) for a in _operands(3, 20, 40, 24, seed=1))
    grouped_gemm.reset_launches()
    for tile in grouped_gemm.TILES:
        got = grouped_gemm.grouped_matmul(x, w, tile=tile)
        torch.testing.assert_close(
            got, grouped_gemm.grouped_matmul_reference(x, w), rtol=0, atol=0)
    assert grouped_gemm.launches == 0
    half = grouped_gemm.grouped_matmul_reference(x.bfloat16(), w.bfloat16())
    assert half.dtype == torch.bfloat16


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, w = (torch.from_numpy(a) for a in _operands(2, 8, 16, 24))
    tile = grouped_gemm.TILES[0]
    with pytest.raises(ValueError, match="menu"):
        grouped_gemm.grouped_matmul(x, w, tile=(8, 128, 128))
    with pytest.raises(ValueError, match="mismatch"):
        grouped_gemm.grouped_matmul(x, w[:, :-1], tile=tile)
    with pytest.raises(ValueError, match="mismatch"):
        grouped_gemm.grouped_matmul(x, w[:1], tile=tile)
    with pytest.raises(ValueError, match=r"\(E, C, D\)"):
        grouped_gemm.grouped_matmul(x[0], w, tile=tile)
    with pytest.raises(ValueError, match="contiguous"):
        grouped_gemm.grouped_matmul(x.transpose(1, 2).contiguous()
                                    .transpose(1, 2), w, tile=tile)
    with pytest.raises(TypeError):
        grouped_gemm.grouped_matmul(x.double(), w.double(), tile=tile)
    with pytest.raises(TypeError, match="bf16 or f32"):
        grouped_gemm.grouped_matmul(x, w, tile=tile, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="empty"):
        grouped_gemm.grouped_matmul(x[:, :0], w, tile=tile)


@pytest.mark.parametrize("route,macro", [("sync", "GROUPED_TILES"),
                                         ("wgmma", "GROUPED_WGMMA_TILES")])
def test_tile_menu_matches_the_cuda_source(route, macro):
    """Each route's menu is the list its macro compiles, and every tile of
    it fits a block's 227 KB of shared memory (the sync route at both
    operand widths)."""
    src = (Path(grouped_gemm.__file__).with_name("csrc")
           / "grouped_gemm.cu").read_text()
    block = src[src.index(f"#define {macro}("):]
    block = block[:block.index("\n\n")]
    tiles = tuple(tuple(int(v) for v in t)
                  for t in re.findall(r"X\((\d+), (\d+), (\d+)\)", block))
    assert tiles == grouped_gemm.tiles_for(route)
    for in_bytes in ((2, 4) if route == "sync" else (2,)):
        assert all(grouped_gemm.tile_smem(t, in_bytes, route)
                   <= grouped_gemm.SMEM_LIMIT for t in tiles)
    if route == "wgmma":
        assert tiles == redas_gemm.WGMMA_TILES        # the ring's own menu
        assert all(grouped_gemm.tile_smem(t, 2, route)
                   == redas_gemm.wgmma_smem_bytes(*t) for t in tiles)


#: granite's expert GEMMs at 8 slots: decode (C = 8 x 4) and the prefill
#: of a 768-token bucket (C = 8 x 240), for wi/wg (D=1024, F=512) and wo
GRANITE = [(32, c, d, f) for c in (32, 1920) for d, f in ((1024, 512),
                                                           (512, 1024))]


@pytest.mark.parametrize("in_bytes", [2, 4])
@pytest.mark.parametrize("e,c,d,f", GRANITE + [(8, 20, 40, 24)])
def test_hopper_grouped_decision_is_os_on_the_menu(e, c, d, f, in_bytes):
    """OS on the menu of the shape's route: in bf16 (every shape here has
    D and F multiples of 8) the wgmma menu at the least `gemm_cost` with
    the experts as its batch; in f32 the sync menu at the roofline's best
    per-expert tile, costed once per expert."""
    req = KernelRequest("grouped_gemm", c, d, f, groups=e, in_bytes=in_bytes,
                        out_bytes=in_bytes)
    dec = HopperModel().decide(req)
    assert dec.dataflow == "os"
    tile = (dec.bm, dec.bk, dec.bn)
    meta = dec.meta_dict
    assert meta["groups"] == e
    if in_bytes == 2:
        assert redas_gemm.shape_route(in_bytes, d, f) == "wgmma"
        assert tile in grouped_gemm.WGMMA_TILES
        assert meta["route"] == "wgmma"
        assert meta["smem_bytes"] == redas_gemm.wgmma_smem_bytes(*tile)
        costs = {t: cost.gemm_cost(c, d, f, "os", t, 2, 2, "wgmma",
                                   batch=e)["seconds"]
                 for t in grouped_gemm.WGMMA_TILES}
        assert dec.seconds == costs[tile] == min(costs.values())
        return
    assert tile in grouped_gemm.TILES
    assert meta["smem_bytes"] == grouped_gemm.smem_bytes(dec.bm, dec.bk,
                                                         dec.bn, in_bytes)
    # the per-expert problem's best OS tile, costed once per expert
    best = cost.choose_tile(c, d, f, in_bytes, in_bytes, dataflows=("os",),
                            tiles=grouped_gemm.TILES)
    assert (best.bm, best.bk, best.bn) == tile
    per_expert = cost.estimate(c, d, f, best, in_bytes, in_bytes)[0]
    assert dec.seconds == pytest.approx(per_expert * e)


#: granite's five expert-GEMM shapes (E, C, D, F) at 8 slots, as
#: chip_smoke.py's GROUPED_SHAPES: decode wi/wg and wo, the 768-token
#: prefill's wi/wg and wo, the 64-token bucket's ragged C = 160
GRANITE_SHAPES = [(32, 32, 1024, 512), (32, 32, 512, 1024),
                  (32, 1920, 1024, 512), (32, 1920, 512, 1024),
                  (32, 160, 1024, 512)]


def _misaligned(shape, dtype=torch.bfloat16):
    """A contiguous tensor of `shape` whose base is 2 bytes past a 16-byte
    boundary."""
    flat = torch.empty(math.prod(shape) + 8, dtype=dtype)
    return flat[1:1 + math.prod(shape)].view(shape)


@pytest.mark.parametrize("e,c,d,f", GRANITE_SHAPES)
def test_grouped_route_on_granite_shapes_and_off_them(e, c, d, f):
    """bf16 at granite's shapes takes the wgmma route; f32, a D or F that
    is no multiple of 8 and a base off 16 bytes take the sync one."""
    x = torch.empty((e, c, d), dtype=torch.bfloat16)
    w = torch.empty((e, d, f), dtype=torch.bfloat16)
    assert grouped_gemm.grouped_route(x, w) == "wgmma"
    assert redas_gemm.shape_route(2, d, f) == "wgmma"
    assert grouped_gemm.grouped_route(x.float(), w.float()) == "sync"
    assert redas_gemm.shape_route(4, d, f) == "sync"
    assert grouped_gemm.grouped_route(x[..., :d - 4].contiguous(),
                                      w[:, :d - 4].contiguous()) == "sync"
    assert grouped_gemm.grouped_route(x, w[..., :f - 1].contiguous()) == "sync"
    assert redas_gemm.shape_route(2, d - 4, f) == "sync"
    assert redas_gemm.shape_route(2, d, f - 1) == "sync"
    off_x, off_w = _misaligned((e, c, d)), _misaligned((e, d, f))
    assert off_x.data_ptr() % 16 and off_x.is_contiguous()
    assert grouped_gemm.grouped_route(off_x, w) == "sync"
    assert grouped_gemm.grouped_route(x, off_w) == "sync"


def test_wgmma_route_on_the_cpu_takes_plain_version_without_counting():
    """bf16 operands on the wgmma route at every tile of its menu, and a
    misaligned copy at every sync tile: the plain version, bit for bit,
    and no count; a sync tile on the wgmma route (and the reverse) is
    refused."""
    x, w = (torch.from_numpy(a).bfloat16()
            for a in _operands(3, 20, 40, 24, seed=6, zero_rows=4))
    want = grouped_gemm.grouped_matmul_reference(x, w)
    grouped_gemm.reset_launches()
    assert grouped_gemm.grouped_route(x, w) == "wgmma"
    for tile in grouped_gemm.WGMMA_TILES:
        got = grouped_gemm.grouped_matmul(x, w, tile=tile)
        assert torch.equal(got, want)
    off = _misaligned(tuple(x.shape))
    off.copy_(x)
    assert grouped_gemm.grouped_route(off, w) == "sync"
    for tile in grouped_gemm.TILES:
        assert torch.equal(grouped_gemm.grouped_matmul(off, w, tile=tile),
                           want)
    assert grouped_gemm.launches == grouped_gemm.wgmma_launches == 0
    with pytest.raises(ValueError, match="wgmma route's menu"):
        grouped_gemm.grouped_matmul(x, w, tile=(16, 64, 64))
    with pytest.raises(ValueError, match="sync route's menu"):
        grouped_gemm.grouped_matmul(off, w, tile=(128, 64, 256))


def test_gemm_cost_batch_multiplies_grid_and_bytes():
    """`gemm_cost`'s batch is the grouped GEMM's expert count: the blocks
    and bytes of the wgmma OS call are batch times one problem's, the
    time no less than one problem's; only OS takes a batch."""
    one = cost.gemm_cost(32, 1024, 512, "os", (64, 64, 64), route="wgmma")
    many = cost.gemm_cost(32, 1024, 512, "os", (64, 64, 64), route="wgmma",
                          batch=32)
    assert many["blocks"] == 32 * one["blocks"]
    assert many["hbm_bytes"] == 32 * one["hbm_bytes"]
    assert many["seconds"] >= one["seconds"]
    assert many["seconds"] >= many["hbm_bytes"] / cost.HBM_BW
    with pytest.raises(ValueError, match="only OS"):
        cost.gemm_cost(32, 1024, 512, "ws", redas_gemm.STREAM_TILES[0],
                       batch=2)


def test_grouped_decisions_survive_the_plans_json(tmp_path):
    """The decisions at granite's five bf16 shapes: OS on the wgmma menu,
    `groups` the expert count, equal after the plan's JSON round trip."""
    plan, model = ExecutionPlan(), HopperModel()
    reqs = [KernelRequest("grouped_gemm", c, d, f, groups=e)
            for e, c, d, f in GRANITE_SHAPES]
    for req in reqs:
        plan.add(req, model.decide(req))
    plan.save(tmp_path / "plan.json")
    loaded = ExecutionPlan.load(tmp_path / "plan.json")
    for req in reqs:
        dec = loaded.lookup(req)
        assert dec == plan.decisions[req.key()]
        assert (dec.bm, dec.bk, dec.bn) in grouped_gemm.WGMMA_TILES
        assert dec.meta_dict["groups"] == req.groups == 32
        assert dec.meta_dict["route"] == "wgmma"
    assert ExecutionPlan.from_json(loaded.to_json()).to_json() == \
        loaded.to_json()


@pytest.mark.parametrize("e,c,d,f", GRANITE_SHAPES)
def test_int8_grouped_decision_is_the_roofline_on_the_int8_menu(e, c, d, f):
    """At in_bytes 1 the experts loop through the int8 kernel: its menu's
    roofline tile, costed once per expert, as before the wgmma route."""
    dec = HopperModel().decide(KernelRequest("grouped_gemm", c, d, f,
                                             groups=e, in_bytes=1,
                                             out_bytes=2))
    best = cost.choose_tile(c, d, f, 1, 2, dataflows=("os",),
                            tiles=quant_gemm.TILES)
    assert (dec.bm, dec.bk, dec.bn) == (best.bm, best.bk, best.bn)
    assert dec.seconds == pytest.approx(cost.estimate(c, d, f, best, 1,
                                                      2)[0] * e)
    assert dec.meta_dict == {"groups": e, "smem_bytes": quant_gemm.smem_bytes(
        best.bm, best.bk, best.bn)}


@pytest.mark.parametrize("tile,aligned,want", [
    ((32, 64, 64), True, "wgmma"),        # an older plan's sync tile
    ((128, 64, 256), True, "wgmma"),      # on the menu: kept
    ((128, 64, 256), False, "sync"),      # a misaligned base
    ((64, 64, 128), False, "sync"),       # on both menus: kept
])
def test_backend_snaps_the_tile_to_the_operands_route(tile, aligned, want):
    """`hopper_grouped_gemm` snaps a tile that is not on the menu of the
    operands' route to that menu's nearest tile (`quant_gemm.snap_tile`)
    and keeps one that is; on the CPU the call is the plain version."""
    x, w = (torch.from_numpy(a).bfloat16()
            for a in _operands(4, 12, 32, 16, seed=7))
    if not aligned:
        off = _misaligned(tuple(x.shape))
        off.copy_(x)
        x = off
    dec = KernelDecision(op="grouped_gemm", dataflow="os", bm=tile[0],
                         bk=tile[1], bn=tile[2])
    assert grouped_gemm.grouped_route(x, w) == want
    menu = grouped_gemm.tiles_for(want)
    got = grouped_tile(dec, x, w)
    assert got in menu
    assert got == (tile if tile in menu
                   else quant_gemm.snap_tile(*tile, tiles=menu))
    assert torch.equal(hopper_grouped_gemm(dec, x, w),
                       grouped_gemm.grouped_matmul_reference(x, w))


def test_engine_grouped_matmul_memo_and_plan_as_in_jax_engine():
    a = _operands(4, 12, 32, 16, seed=2)
    b = _operands(4, 8, 32, 16, seed=3)
    jeng = jax_engine.Engine(backend="pallas-interpret")
    teng = Engine(backend="hopper")
    for x, w in (a, a, b, a, b):
        want = jeng.grouped_matmul(jnp.asarray(x), jnp.asarray(w))
        got = teng.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert teng.plan.stats == jeng.plan.stats
    assert (teng.plan.stats["decisions"], teng.plan.hits) == (2, 3)
    req, dec = next(iter(teng.plan))
    assert (req.op, req.groups, req.in_bytes) == ("grouped_gemm", 4, 4)
    assert dec.backend == "hopper"
    ref = Engine(backend="torch-ref").grouped_matmul(
        *(torch.from_numpy(v) for v in a))
    torch.testing.assert_close(
        ref, teng.grouped_matmul(*(torch.from_numpy(v) for v in a)),
        rtol=0, atol=0)


def test_engine_grouped_matmul_dim_mismatch_raises_as_in_jax_engine():
    x, w = _operands(4, 8, 32, 16)
    for xs, ws in ((x, w[:, :-1]), (x, w[:3])):
        with pytest.raises(ValueError, match="grouped dim mismatch"):
            jax_engine.Engine(backend="pallas-interpret").grouped_matmul(
                jnp.asarray(xs), jnp.asarray(ws))
        eng = Engine(backend="hopper")
        with pytest.raises(ValueError, match="grouped dim mismatch"):
            eng.grouped_matmul(torch.from_numpy(xs),
                               torch.from_numpy(np.ascontiguousarray(ws)))
        assert len(eng.plan) == 0


@pytest.mark.parametrize("in_dt,out_dt", [("bfloat16", "float32"),
                                          ("float32", "bfloat16"),
                                          ("bfloat16", "bfloat16")])
def test_out_dtype_matches_the_reference_grouped_backend(in_dt, out_dt):
    """The wrapper and `Engine.grouped_matmul` on `hopper` (and
    `torch-ref`) write any `out_dtype` from the f32 accumulator; the
    reference's grouped backend (`pallas-interpret`) casts its kernel's
    result, which the kernel stores in x's dtype, so with bf16 operands
    its f32 output carries one bf16 rounding that the port's does not:
    held within one bf16 ulp wherever bf16 is on either side.  The CPU
    path counts nothing."""
    t_in, t_out = getattr(torch, in_dt), getattr(torch, out_dt)
    j_in, j_out = getattr(jnp, in_dt), getattr(jnp, out_dt)
    x, w = _operands(3, 20, 40, 24, seed=4, zero_rows=5)
    want = jax_engine.Engine(backend="pallas-interpret").grouped_matmul(
        jnp.asarray(x, dtype=j_in), jnp.asarray(w, dtype=j_in),
        out_dtype=j_out)
    assert want.dtype == j_out
    tx, tw = torch.from_numpy(x).to(t_in), torch.from_numpy(w).to(t_in)
    tol = ({"rtol": 2 ** -7, "atol": 2e-4} if "bfloat16" in (in_dt, out_dt)
           else TOL)
    grouped_gemm.reset_launches()
    tile = grouped_gemm.tiles_for(grouped_gemm.grouped_route(tx, tw))[0]
    for got in (grouped_gemm.grouped_matmul(tx, tw, tile=tile,
                                            out_dtype=t_out),
                Engine(backend="hopper").grouped_matmul(tx, tw,
                                                        out_dtype=t_out),
                Engine(backend="torch-ref").grouped_matmul(tx, tw,
                                                           out_dtype=t_out)):
        assert got.dtype == t_out
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   **tol)
    assert grouped_gemm.launches == 0
