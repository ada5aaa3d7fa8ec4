"""The ReDas GEMM wrapper of the port on the CPU: its plain version
against the JAX Pallas kernel (interpret mode), the CPU path of the
`hopper` wrapper, and the wrapper's input checks.

The CUDA kernels themselves run only on the card: `chip_smoke.py` and
tests/test_torch_card.py hold them against the plain version there.  The
OS route rule (`os_route`: the wgmma kernel for bf16 that TMA can
describe, the sync kernel otherwise), both OS menus against the CUDA
source and their shared memory, and the `out_dtype` output against the
JAX kernel's are held here.  bf16 outputs are held within one bf16 ulp
(rtol 2^-7): the f32 sums differ only in order, and the cast to bf16
may then round either way.  The
streaming dataflows' own arithmetic (one f32 product per K slab, summed in
slab order: `stream_reference`, `stream_reduce_reference`) is held here
against the JAX package's WS/IS Pallas kernel in interpret mode.
Tolerance rtol 2e-5, atol 2e-4, as tests/test_kernels.py uses for the f32
kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jax_engine
from repro.engine.backends import pallas_gemm
from repro.kernels import redas_gemm as jax_redas_gemm
from repro_torch.engine import Engine
from repro_torch.kernels import redas_gemm

SHAPES = [(40, 96, 200), (1, 160, 136), (257, 64, 8)]
TILE = dict(zip(("bm", "bk", "bn"), redas_gemm.TILES[0]))


def _operands(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, k)).astype(np.float32),
            rng.normal(size=(k, n)).astype(np.float32))


@pytest.mark.parametrize("dataflow", redas_gemm.DATAFLOWS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_pallas_kernel(dataflow, shape):
    a, b = _operands(*shape)
    want = pallas_gemm(jnp.asarray(a), jnp.asarray(b), dataflow=dataflow,
                       interpret=True)
    got = redas_gemm.gemm_reference(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("dataflow", redas_gemm.DATAFLOWS)
def test_cpu_tensors_take_plain_version_without_counting(dataflow):
    a, b = (torch.from_numpy(x) for x in _operands(40, 96, 200, seed=1))
    redas_gemm.reset_launches()
    got = redas_gemm.gemm(a, b, dataflow=dataflow, **TILE)
    torch.testing.assert_close(got, redas_gemm.gemm_reference(a, b),
                               rtol=0, atol=0)
    assert redas_gemm.launches == dict.fromkeys(redas_gemm.DATAFLOWS, 0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a, b = (torch.from_numpy(x) for x in _operands(32, 64, 48))
    with pytest.raises(ValueError, match="menu"):
        redas_gemm.gemm(a, b, bm=8, bk=128, bn=128)
    with pytest.raises(ValueError, match="contiguous"):
        redas_gemm.gemm(a, b.t().contiguous().t(), **TILE)
    with pytest.raises(ValueError, match="2-D"):
        redas_gemm.gemm(a[None], b, **TILE)
    with pytest.raises(ValueError, match="dataflow"):
        redas_gemm.gemm(a, b, dataflow="xs", **TILE)
    with pytest.raises(TypeError):
        redas_gemm.gemm(a.double(), b.double(), **TILE)
    with pytest.raises(TypeError, match="bf16 or f32"):
        redas_gemm.gemm(a, b, out_dtype=torch.float16, **TILE)
    with pytest.raises(ValueError, match="mismatch"):
        redas_gemm.gemm(a, b[:-1], **TILE)


@pytest.mark.parametrize("macro,menu", [
    ("REDAS_TILES", redas_gemm.TILES),
    ("REDAS_WGMMA_TILES", redas_gemm.WGMMA_TILES),
    ("REDAS_STREAM_TILES", redas_gemm.STREAM_TILES)])
def test_tile_menu_matches_the_cuda_source(macro, menu):
    import re
    from pathlib import Path

    src = (Path(redas_gemm.__file__).with_name("csrc")
           / "redas_gemm.cu").read_text()
    block = src[src.index(f"#define {macro}("):]
    block = block[:block.index("\n\n")]
    tiles = tuple(tuple(int(v) for v in t)
                  for t in re.findall(r"X\((\d+), (\d+), (\d+)\)", block))
    assert tiles == menu
    # slabs are whole pipeline steps deep, and the constants match
    if macro == "REDAS_STREAM_TILES":
        assert all(bk % redas_gemm.SUB_K == 0 for _, bk, _ in tiles)
        assert f"kSub = {redas_gemm.SUB_K};" in src
        assert f"kMaxStages = {redas_gemm.MAX_STAGES};" in src
        assert f"kSmemLimit = {redas_gemm.SMEM_LIMIT};" in src
    if macro == "REDAS_WGMMA_TILES":
        # one or two consumer warpgroups, a 64-deep stage (one swizzled
        # 128-byte row of bf16), one wgmma's width
        assert {bm for bm, _, _ in tiles} == {64, 128}
        assert {bk for _, bk, _ in tiles} == {64}
        assert all(bn % 64 == 0 and bn <= 256 for _, _, bn in tiles)
        # the ring, shared with the grouped GEMM, lives in hopper.cuh
        ring = (Path(redas_gemm.__file__).with_name("csrc")
                / "hopper.cuh").read_text()
        assert f"kWgStages = {redas_gemm.WGMMA_STAGES};" in ring
        assert "wgmma_os_tile<BM, BN, 2>" in src


@pytest.mark.parametrize("dataflow", ["ws", "is"])
@pytest.mark.parametrize("shape,bk", [((40, 96, 200), 64), ((1, 160, 136), 64),
                                      ((257, 300, 8), 128),
                                      ((5, 1003, 200), 256)])
def test_slab_by_slab_sum_matches_pallas_streaming_kernel(dataflow, shape,
                                                          bk):
    """The streaming kernels' arithmetic — each bk-deep K slab's f32
    product, then the slabs summed in order from zero — against the JAX
    package's WS/IS Pallas kernel (its K chunks carried through the
    aliased f32 accumulator), in interpret mode."""
    a, b = _operands(*shape, seed=3)
    want = pallas_gemm(jnp.asarray(a), jnp.asarray(b), dataflow=dataflow,
                       interpret=True)
    got = redas_gemm.stream_reference(torch.from_numpy(a),
                                      torch.from_numpy(b), bk)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("slabs,m,n", [(2, 3, 5), (7, 4, 1536), (35, 2, 9)])
def test_reduction_plain_version_sums_in_slab_order(slabs, m, n):
    """The reduction's plain version is the f32 sum of the partials in
    slab order from zero (numpy, in the same order), bit for bit, cast
    last; the CPU path of `stream_reduce` returns it and counts nothing."""
    rng = np.random.default_rng(slabs)
    ws = (rng.normal(size=(slabs, m, n))
          * 10.0 ** rng.integers(-3, 4, size=(slabs, m, n))).astype(np.float32)
    want = np.zeros((m, n), np.float32)
    for part in ws:
        want = want + part
    redas_gemm.reset_launches()
    for dtype in (torch.float32, torch.bfloat16):
        got = redas_gemm.stream_reduce(torch.from_numpy(ws), dtype)
        assert got.dtype == dtype
        assert torch.equal(got, torch.from_numpy(want).to(dtype))
    assert redas_gemm.reduce_launches == 0


def test_streaming_layout_and_groups():
    """The streaming kernel's shared memory, ring depth, grid and group
    rule as the CUDA source lays them out: WS holds a (bk, bn) slab and
    rings (bm, 64) input pieces, IS the mirror; a tile fits when the slab
    and two stages do; the groups fill the card and never exceed the
    tiles swept; OS keeps the layout the grouped GEMM shares."""
    rg = redas_gemm
    assert rg.stream_smem_bytes("ws", 16, 512, 64, 2, 4) == (
        (512 * 72 + 4 * 16 * 72) * 2 + 4096)
    assert rg.stream_smem_bytes("is", 16, 512, 64, 2, 4) == (
        (16 * 520 + 4 * 64 * 72) * 2 + 4096)
    assert rg.tile_smem("os", 64, 256, 64, 2) == rg.smem_bytes(64, 256, 64, 2)
    assert rg.smem_bytes(16, 64, 64, 2) == 15616       # the grouped gate
    assert rg.stream_stages("ws", 16, 1536, 64, 2) == 3
    assert rg.stream_stages("is", 64, 1536, 64, 2) == 3
    assert rg.stream_stages("ws", 64, 1536, 64, 2) == 0
    assert rg.stream_stages("is", 16, 64, 64, 4) == 4
    for df in ("ws", "is"):
        for tile in rg.STREAM_TILES:
            for size in (2, 4):
                st = rg.stream_stages(df, *tile, size)
                fits = rg.stream_smem_bytes(df, *tile, size, 2) <= 232_448
                assert (st >= 2) == fits
                if st:
                    assert rg.tile_smem(df, *tile, size) <= 232_448
    assert rg.slab_count(8960, 256) == 35 and rg.slab_count(1536, 1536) == 1
    assert rg.grid("ws", 4, 8960, 1536, (16, 256, 64)) == (24, 35, 1)
    assert rg.grid("is", 4, 8960, 1536, (16, 256, 64), 24) == (1, 35, 24)
    assert rg.grid("is", 2048, 1536, 256, (64, 256, 64), 3) == (32, 6, 2)
    assert rg.grid("os", 2048, 1536, 256, (128, 32, 128)) == (2, 16, 1)
    assert rg.groups_for("os", 2048, 1536, 256, (128, 32, 128), 2) == 1
    assert rg.groups_for("ws", 4, 8960, 1536, (16, 256, 64), 2) == 1
    for m, k, n in ((4, 1536, 1536), (2048, 1536, 256), (8, 8960, 1536)):
        for df in ("ws", "is"):
            for tile in rg.STREAM_TILES:
                if not rg.stream_stages(df, *tile, 2):
                    continue
                g = rg.groups_for(df, m, k, n, tile, 2)
                swept = -(-m // tile[0]) if df == "ws" else -(-n // tile[2])
                assert 1 <= g <= swept
                assert rg.grid(df, m, k, n, tile, g)[2] == g  # as formed


def test_streaming_wrapper_checks_slabs_groups_and_fit():
    a, b = (torch.from_numpy(x) for x in _operands(8, 1536, 128, seed=4))
    kw = {"dataflow": "ws", "bm": 16, "bk": 256, "bn": 64}
    got = redas_gemm.gemm(a, b, slabs=6, groups=1, **kw)
    assert torch.equal(got, redas_gemm.gemm_reference(a, b))
    with pytest.raises(ValueError, match="slabs"):
        redas_gemm.gemm(a, b, slabs=5, **kw)
    with pytest.raises(ValueError, match="groups"):
        redas_gemm.gemm(a, b, groups=2, **kw)        # one m-tile to sweep
    with pytest.raises(ValueError, match="menu"):
        redas_gemm.gemm(a, b, dataflow="ws", bm=16, bk=128, bn=64)
    with pytest.raises(ValueError, match="menu"):
        redas_gemm.gemm(a, b, dataflow="os", bm=16, bk=256, bn=64)
    with pytest.raises(ValueError, match="shared memory"):
        redas_gemm.gemm(a, b, dataflow="ws", bm=16, bk=1536, bn=64)  # f32
    with pytest.raises(ValueError, match="OS takes no slabs"):
        redas_gemm.gemm(a, b, slabs=2, **TILE)


#: one bf16 ulp relative (a sum rounded to bf16 either way), as stated in
#: the module's docstring; f32 outputs at the f32 kernels' tolerance
BF16_OUT_TOL = {"rtol": 2 ** -7, "atol": 2e-4}
F32_OUT_TOL = {"rtol": 2e-5, "atol": 2e-4}
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float32": (torch.float32, jnp.float32)}


@pytest.mark.parametrize("dataflow", redas_gemm.DATAFLOWS)
@pytest.mark.parametrize("in_dt,out_dt", [("bfloat16", "float32"),
                                          ("bfloat16", "bfloat16"),
                                          ("float32", "bfloat16"),
                                          ("float32", "float32")])
def test_out_dtype_matches_pallas_kernel(dataflow, in_dt, out_dt):
    """The port writes any `out_dtype` from its f32 accumulator, as the
    reference's `redas_gemm.gemm(..., out_dtype=...)` does (interpret
    mode, at a shape its blocks divide); the CPU path of `gemm` returns
    the plain version in that dtype."""
    a, b = _operands(128, 256, 128, seed=5)
    (t_in, j_in), (t_out, j_out) = DTYPES[in_dt], DTYPES[out_dt]
    want = jax_redas_gemm.gemm(
        jnp.asarray(a, dtype=j_in), jnp.asarray(b, dtype=j_in),
        dataflow=dataflow, bm=128, bk=128, bn=128, interpret=True,
        out_dtype=j_out)
    ta, tb = torch.from_numpy(a).to(t_in), torch.from_numpy(b).to(t_in)
    # (64, 64, 128) is on both OS routes' menus (bf16 here takes wgmma)
    bm, bk, bn = (64, 64, 128) if dataflow == "os" else (64, 256, 64)
    got = redas_gemm.gemm(ta, tb, dataflow=dataflow, bm=bm, bk=bk, bn=bn,
                          out_dtype=t_out)
    assert got.dtype == t_out
    tol = BF16_OUT_TOL if out_dt == "bfloat16" else F32_OUT_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("backend", ["hopper", "torch-ref"])
def test_engine_matmul_writes_f32_from_bf16_operands(backend):
    """`Engine.matmul(a_bf16, b_bf16, out_dtype=torch.float32)` returns
    f32 on both backends, what the reference's engine (`pallas_gemm`,
    interpret mode) returns for the same request."""
    a, b = _operands(40, 96, 200, seed=6)
    want = jax_engine.Engine(backend="pallas-interpret").matmul(
        jnp.asarray(a, dtype=jnp.bfloat16), jnp.asarray(b, dtype=jnp.bfloat16),
        out_dtype=jnp.float32)
    got = Engine(backend=backend).matmul(
        torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16(),
        out_dtype=torch.float32)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_OUT_TOL)


def _misaligned(rows, cols, dtype=torch.bfloat16):
    """A contiguous (rows, cols) tensor whose base is 2 bytes past a
    16-byte boundary."""
    flat = torch.zeros(rows * cols + 8, dtype=dtype)
    skip = next(i for i in range(1, 8) if
                (flat.data_ptr() + i * flat.element_size()) % 16)
    return flat[skip:skip + rows * cols].view(rows, cols)


@pytest.mark.parametrize("m,k,n,dtype,route", [
    *[(m, k, n, torch.bfloat16, "wgmma") for m in (4, 8, 512, 2048, 6144)
      for k, n in ((1536, 1536), (1536, 256), (1536, 8960), (8960, 1536))],
    (2048, 1024, 512, torch.bfloat16, "wgmma"),      # granite's k/v
    (5, 1003, 200, torch.bfloat16, "sync"),          # K % 8 != 0
    (5, 1000, 204, torch.bfloat16, "sync"),          # N % 8 != 0
    (2048, 1536, 1536, torch.float32, "sync"),
    (4, 1536, 8960, torch.float32, "sync"),
])
def test_os_route_rule(m, k, n, dtype, route):
    """The OS route is a pure function of dtype, shape and base addresses:
    every main-path bf16 shape goes to the wgmma kernel, f32 and shapes
    TMA cannot describe (a row stride that is no multiple of 16 bytes) to
    the sync kernel; so does a base that is not 16-byte aligned.  The
    planner sees the shape only (`shape_route`)."""
    a, b = torch.zeros(m, k, dtype=dtype), torch.zeros(k, n, dtype=dtype)
    assert redas_gemm.os_route(a, b) == route
    assert redas_gemm.shape_route(a.element_size(), k, n) == route
    if route == "wgmma" and m * k <= 2048 * 1536:
        assert redas_gemm.os_route(_misaligned(m, k), b) == "sync"
        assert redas_gemm.os_route(a, _misaligned(k, n)) == "sync"


def test_wgmma_tiles_fit_shared_memory():
    """Each wgmma tile's ring (WGMMA_STAGES stages of the (bm, 64) A box
    and the (64, bn) B boxes, bf16), its barriers and the 1 KB that
    aligns it fit the 227 KB a block may use; the route's menu is what
    `tiles_for` and `tile_smem` give."""
    assert redas_gemm.tiles_for("os", "wgmma") == redas_gemm.WGMMA_TILES
    assert redas_gemm.tiles_for("os") == redas_gemm.TILES
    assert redas_gemm.wgmma_smem_bytes(128, 64, 256) == (
        1024 + 4 * (128 * 64 + 64 * 256) * 2 + 64)
    for bm, bk, bn in redas_gemm.WGMMA_TILES:
        smem = redas_gemm.tile_smem("os", bm, bk, bn, 2, "wgmma")
        assert smem == redas_gemm.wgmma_smem_bytes(bm, bk, bn)
        assert smem <= redas_gemm.SMEM_LIMIT == 232_448
        assert redas_gemm.wgmma_threads(bm) == 128 * (bm // 64) + 32


def test_wgmma_route_checks_its_menu_on_cpu_tensors():
    """A bf16 call TMA can describe takes wgmma tiles and refuses the sync
    menu's; a misaligned one takes the sync menu; both return the plain
    version on the CPU and count nothing."""
    a, b = (torch.from_numpy(x).bfloat16() for x in _operands(40, 96, 200,
                                                                seed=7))
    redas_gemm.reset_launches()
    got = redas_gemm.gemm(a, b, bm=64, bk=64, bn=128)
    assert torch.equal(got, redas_gemm.gemm_reference(a, b))
    with pytest.raises(ValueError, match="wgmma route"):
        redas_gemm.gemm(a, b, **TILE)
    off = _misaligned(40, 96)
    off.copy_(a)
    assert torch.equal(redas_gemm.gemm(off, b, **TILE),
                       redas_gemm.gemm_reference(a, b))
    with pytest.raises(ValueError, match="sync route"):
        redas_gemm.gemm(off, b, bm=128, bk=64, bn=256)
    assert redas_gemm.launches == dict.fromkeys(redas_gemm.DATAFLOWS, 0)
    assert redas_gemm.os_wgmma_launches == 0


def test_engine_snaps_a_planned_tile_to_the_route_of_misaligned_operands():
    """The planner sees shapes, not pointers: a bf16 shape it plans on the
    wgmma menu, called with a misaligned base, runs on the sync kernel at
    the sync menu's nearest tile (`gemm_args`) and returns the plain
    version; aligned operands keep the planned tile."""
    from repro_torch.engine.backends import gemm_args

    a, b = (torch.from_numpy(x).bfloat16() for x in _operands(256, 1536, 1536,
                                                                seed=8))
    eng = Engine(backend="hopper")
    want = redas_gemm.gemm_reference(a, b)
    assert torch.equal(eng.matmul(a, b), want)
    (_, dec), = eng.plan
    assert dec.dataflow == "os" and dec.meta_dict["route"] == "wgmma"
    planned = (dec.bm, dec.bk, dec.bn)
    assert planned in redas_gemm.WGMMA_TILES
    assert planned not in redas_gemm.TILES
    off = _misaligned(256, 1536)
    off.copy_(a)
    args = gemm_args(dec, off, b)
    assert (args["bm"], args["bk"], args["bn"]) in redas_gemm.TILES
    assert gemm_args(dec, a, b) == gemm_args(dec)
    assert torch.equal(eng.matmul(off, b), want)
