"""The ReDas GEMM wrapper of the port on the CPU: its plain version
against the JAX Pallas kernel (interpret mode), the CPU path of the
`hopper` wrapper, and the wrapper's input checks.

The CUDA kernels themselves run only on the card: `chip_smoke.py` and
tests/test_torch_card.py hold them against the plain version there.  The
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

from repro.engine.backends import pallas_gemm
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
    with pytest.raises(TypeError):
        redas_gemm.gemm(a, b, out_dtype=torch.bfloat16, **TILE)
    with pytest.raises(ValueError, match="mismatch"):
        redas_gemm.gemm(a, b[:-1], **TILE)


@pytest.mark.parametrize("macro,menu", [
    ("REDAS_TILES", redas_gemm.TILES),
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
