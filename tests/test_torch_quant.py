"""The port's int8 weight plane (quant codec, int8 GEMM, int8 engine
backends, `ServeConfig(quantize=True)`) against the JAX package, on the
CPU.

Inputs are drawn with numpy and handed to both packages; the SMOKE
weights are the JAX `init_params` tree carried across by the bridge.
Every check here is bitwise (tolerance 0) unless it says otherwise: the
codec, the int32 product and the rescale are the same f32 operations in
the same order, and the int8 backends' plain versions are exact.  The
JAX package's int8 GEMM runs jitted, where XLA computes a scale as
`amax * f32(1/127)`; its `quantize`/`kv_quantize` called eagerly divide.
The port's `jitted=` argument names which of the two it reproduces.
"""

import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jax_engine
from repro.configs import get_config as jax_get_config
from repro.kernels import quant_gemm as jax_qg
from repro.models import layers as jax_layers
from repro.models import transformer as JT
from repro.quant import kv_quantize as jax_kv_quantize
from repro.quant import quantize as jax_quantize
from repro.quant import quantize_params as jax_quantize_params
from repro.serve_lib import serve as jax_serve
from repro.serve_lib.scheduler import Request as JaxRequest
from repro.serve_lib.scheduler import Scheduler as JaxScheduler
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.engine import (BACKENDS, INT8_BACKENDS, Engine,
                                ExecutionPlan, HopperModel, KernelRequest,
                                backend_in_bytes, int8_sibling, use_engine)
from repro_torch.engine import cost
from repro_torch.kernels import quant_gemm
from repro_torch.models import layers
from repro_torch.quant import (QMAX, SKIP_KEYS, QuantizedTensor, dequantize,
                               kv_dequantize, kv_quantize, quantize,
                               quantize_params, tree_bytes)
from repro_torch.serve_lib import serve
from repro_torch.serve_lib.scheduler import Request, Scheduler

ARCH = "qwen2-1.5b"
CSRC = Path(quant_gemm.__file__).with_name("csrc") / "quant_gemm.cu"


def _np(x):
    return np.asarray(x)


def _normal(shape, seed, zero_col=False):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if zero_col:
        x[..., 3] = 0.0          # an all-zero channel / row gets scale 1.0
    return x


# --------------------------------------------------------------------------
# The codec
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape,axis", [
    ((64, 96), -2), ((2, 64, 96), -2), ((64, 96), 0), ((33, 17), -1)])
@pytest.mark.parametrize("jitted", [False, True])
def test_quantize_bitwise_equals_reference(shape, axis, jitted):
    x = _normal(shape, 0, zero_col=True)
    fn = jax.jit(jax_quantize, static_argnums=1) if jitted else jax_quantize
    want = fn(jnp.asarray(x), axis)
    got = quantize(torch.from_numpy(x), axis, jitted=jitted)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), _np(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), _np(want.scale))
    np.testing.assert_array_equal(dequantize(got).numpy(),
                                  _np(want.dequantize()))
    assert got.shape == tuple(want.shape) and got.ndim == want.ndim


@pytest.mark.parametrize("shape", [(5, 64), (3, 7, 16), (300, 64)])
@pytest.mark.parametrize("jitted", [False, True])
def test_kv_quantize_bitwise_equals_reference(shape, jitted):
    x = _normal(shape, 1, zero_col=False)
    x[0] = 0.0
    fn = jax.jit(jax_kv_quantize) if jitted else jax_kv_quantize
    wq, ws = fn(jnp.asarray(x))
    q, s = kv_quantize(torch.from_numpy(x), jitted=jitted)
    np.testing.assert_array_equal(q.numpy(), _np(wq))
    np.testing.assert_array_equal(s.numpy(), _np(ws))
    assert bool((s[0] == 1.0).all())
    err = (kv_dequantize(q, s) - torch.from_numpy(x)).abs()
    assert bool((err <= s[..., None] / 2 + 1e-7).all())   # the codec's bound


def test_the_two_scale_forms_differ_as_xla_makes_them():
    """`amax / 127` and XLA's `amax * f32(1/127)` differ in the last bit
    for some rows; the port reproduces each where the reference runs it."""
    x = torch.from_numpy(_normal((300, 64), 0))
    _, eager = kv_quantize(x)
    _, jitted = kv_quantize(x, jitted=True)
    amax = x.abs().amax(-1)
    assert torch.equal(eager, amax / QMAX)
    assert int((eager != jitted).sum()) == 13          # of 300 rows


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_get_config(ARCH, smoke=True)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    jq = jax_quantize_params(jparams)
    return jcfg, jparams, jq, get_config(ARCH, smoke=True), params


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def test_quantize_params_bitwise_on_the_smoke_tree(smoke):
    _, _, jq, _, params = smoke
    mine = dict(_leaves(quantize_params(params)))
    want = dict(_leaves(jq))
    assert mine.keys() == want.keys()
    n_quant = 0
    for path, leaf in want.items():
        got = mine[path]
        if hasattr(leaf, "q"):
            n_quant += 1
            assert isinstance(got, QuantizedTensor), path
            np.testing.assert_array_equal(got.q.numpy(), _np(leaf.q))
            np.testing.assert_array_equal(got.scale.numpy(), _np(leaf.scale))
        else:
            assert isinstance(got, torch.Tensor), path
            np.testing.assert_array_equal(got.numpy(), _np(leaf))
    assert n_quant == 7          # wq, wk, wv, wo, wi, wg and the MLP's wo
    assert tree_bytes(quantize_params(params)) == sum(
        leaf.size * leaf.dtype.itemsize
        for leaf in jax.tree.leaves(jq) if hasattr(leaf, "dtype"))


def test_quantize_params_skip_list_as_in_reference():
    rng = np.random.default_rng(3)
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    tree = {"router": {"w": mk(8, 4)}, "ssm": {"in_proj": {"w": mk(8, 16)},
                                              "out_proj": {"w": mk(16, 8)}},
            "mlp": [{"w": mk(8, 8), "b": mk(8)}, {"w": mk(3, 8, 8)}],
            "norm": {"w": mk(8)}, "emb": mk(10, 8)}
    want = jax_quantize_params(jax.tree.map(jnp.asarray, tree))
    got = quantize_params(params_from_numpy(tree, device="cpu"))
    assert SKIP_KEYS == ("router", "in_proj", "out_proj")
    for path, leaf in _leaves(want):
        node = got
        for p in path:
            node = node[p]
        assert isinstance(node, QuantizedTensor) == hasattr(leaf, "q"), path
    assert isinstance(got["mlp"], list)
    assert isinstance(got["mlp"][1]["w"], QuantizedTensor)
    assert not isinstance(got["router"]["w"], QuantizedTensor)


def test_bridge_carries_a_quantized_tree(smoke):
    _, _, jq, _, params = smoke
    tree = jax.tree.map(np.asarray, jq)
    for dtype in (None, torch.bfloat16):
        carried = params_from_numpy(tree, device="cpu", dtype=dtype)
        w = carried["stack"]["b0"]["attn"]["wq"]["w"]
        assert isinstance(w, QuantizedTensor)
        assert w.q.dtype == torch.int8 and w.scale.dtype == torch.float32
    carried = params_from_numpy(tree, device="cpu")
    mine = dict(_leaves(quantize_params(params)))
    for path, leaf in _leaves(carried):
        if isinstance(leaf, QuantizedTensor):
            assert torch.equal(leaf.q, mine[path].q)
            assert torch.equal(leaf.scale, mine[path].scale)


# --------------------------------------------------------------------------
# The int8 GEMM
# --------------------------------------------------------------------------


def test_gemm_int8_plain_version_is_exact():
    rng = np.random.default_rng(4)
    a = rng.integers(-127, 128, (9, 8960)).astype(np.int8)
    b = rng.integers(-127, 128, (8960, 40)).astype(np.int8)
    b[:, 0] = 127
    a[0] = 127                                    # the largest sum, 8960 x 127^2
    quant_gemm.reset_launches()
    got = quant_gemm.gemm_int8(torch.from_numpy(a), torch.from_numpy(b),
                               tile=quant_gemm.TILES[0])
    assert got.dtype == torch.int32 and quant_gemm.launches == 0
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))


@pytest.mark.parametrize("bad", ["tile", "dtype", "shape", "split",
                                 "split_type", "decode_tile", "decode_rows",
                                 "tiled_split", "path"])
def test_gemm_int8_refuses_what_the_kernel_does_not_take(bad):
    a = torch.zeros(4, 32, dtype=torch.int8)
    b = torch.zeros(32, 16, dtype=torch.int8)
    tile = quant_gemm.TILES[0]
    decode = {"path": "decode", "split_k": 2}
    with pytest.raises((ValueError, TypeError)):
        if bad == "tile":
            quant_gemm.gemm_int8(a, b, tile=(8, 8, 8))
        elif bad == "dtype":
            quant_gemm.gemm_int8(a.float(), b, tile=tile)
        elif bad == "shape":
            quant_gemm.gemm_int8(a, b[:16], tile=tile)
        elif bad == "split":
            quant_gemm.gemm_int8(a, b, path="decode",
                                 split_k=quant_gemm.DECODE_MAX_SPLIT + 1)
        elif bad == "split_type":
            quant_gemm.gemm_int8(a, b, path="decode", split_k=2.0)
        elif bad == "decode_tile":
            quant_gemm.gemm_int8(a, b, tile=tile, **decode)
        elif bad == "decode_rows":
            quant_gemm.gemm_int8(torch.zeros(17, 32, dtype=torch.int8), b,
                                 **decode)
        elif bad == "tiled_split":
            quant_gemm.gemm_int8(a, b, tile=tile, split_k=2)
        else:
            quant_gemm.gemm_int8(a, b, path="wide")


@pytest.mark.parametrize("m,k,n", [(5, 64, 96), (8, 1000, 200), (37, 256, 64)])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_quant_gemm_bitwise_equals_reference(m, k, n, use_pallas, out):
    """Both entry points against the reference's `xla-int8` path and its
    Pallas kernel in interpret mode (blocks (32, 128, 128))."""
    a, w = _normal((m, k), 5), _normal((k, n), 6)
    jdt, tdt = getattr(jnp, out), getattr(torch, out)
    kw = dict(bm=32, bk=128, bn=128, interpret=True, use_pallas=use_pallas,
              out_dtype=jdt)
    wq = jax_quantize(jnp.asarray(w))
    want_w8 = jax_qg.quant_gemm_w8(jnp.asarray(a), wq.q, wq.scale, **kw)
    want_dyn = jax_qg.quant_gemm(jnp.asarray(a), jnp.asarray(w), **kw)
    tw = quantize(torch.from_numpy(w))
    for use_kernel in (True, False):      # on the CPU both are exact
        got_w8 = quant_gemm.quant_gemm_w8(torch.from_numpy(a), tw.q, tw.scale,
                                          use_kernel=use_kernel, out_dtype=tdt)
        got_dyn = quant_gemm.quant_gemm(torch.from_numpy(a),
                                        torch.from_numpy(w),
                                        use_kernel=use_kernel, out_dtype=tdt)
        assert got_w8.dtype == tdt
        np.testing.assert_array_equal(got_w8.float().numpy(),
                                      _np(want_w8.astype(jnp.float32)))
        np.testing.assert_array_equal(got_dyn.float().numpy(),
                                      _np(want_dyn.astype(jnp.float32)))


def test_int32_core_equals_reference_kernel_in_interpret_mode():
    rng = np.random.default_rng(7)
    a = rng.integers(-127, 128, (64, 256)).astype(np.int8)
    b = rng.integers(-127, 128, (256, 128)).astype(np.int8)
    want = jax_qg.gemm_int8(jnp.asarray(a), jnp.asarray(b), bm=32, bk=128,
                            bn=128, interpret=True)
    for kw in ({"tile": quant_gemm.TILES[-1]}, {"tile": (32, 64, 64)}):
        got = quant_gemm.gemm_int8(torch.from_numpy(a), torch.from_numpy(b),
                                   **kw)
        np.testing.assert_array_equal(got.numpy(), _np(want))


def test_gemm_int8_paths_on_the_cpu_are_the_reference_bits():
    """On CPU tensors every path, tile and split returns the plain int32
    product (the reference's bits) and launches nothing: the sums at the
    extremes (-128 x -128 over all K) included."""
    rng = np.random.default_rng(11)
    a = rng.integers(-128, 128, (5, 1000)).astype(np.int8)
    b = rng.integers(-128, 128, (1000, 200)).astype(np.int8)
    a[0], b[:, 0] = -128, -128
    want = a.astype(np.int64) @ b.astype(np.int64)
    assert want[0, 0] == 1000 * 128 * 128
    quant_gemm.reset_launches()
    configs = ([{"path": "decode", "split_k": s}
                for s in range(1, quant_gemm.DECODE_MAX_SPLIT + 1)]
               + [{"tile": t} for t in quant_gemm.TILES] + [{}])
    for kw in configs:
        got = quant_gemm.gemm_int8(torch.from_numpy(a), torch.from_numpy(b),
                                   **kw)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert quant_gemm.launches == 0
    assert quant_gemm.path_launches == {"decode": 0, "tiled": 0}


def _macro(src: str, name: str) -> str:
    block = src[src.index(f"#define {name}"):]
    return block[:block.index("\n\n")]


def test_cuda_source_menu_equals_the_wrapper_menu():
    """The tiled menu, the decode row buckets, block columns and most
    splits, and the rings' depths of csrc/quant_gemm.cu are the wrapper's;
    every tile fits the 4-warp (2 x 2) layout and a block's shared
    memory, and qwen2-1.5b's deepest K (8960) fits a decode block at one
    split."""
    src = CSRC.read_text()
    tiles = tuple(tuple(int(v) for v in t) for t in re.findall(
        r"X\((\d+), (\d+), (\d+)\)", _macro(src, "QUANT_TILES")))
    assert tiles == quant_gemm.TILES
    rows = tuple(int(v) for v in re.findall(
        r"X\((\d+)\)", _macro(src, "QUANT_DECODE_ROWS")))
    assert rows == quant_gemm.DECODE_ROWS
    for name, value in (("QUANT_DECODE_BN", quant_gemm.DECODE_BN),
                        ("QUANT_DECODE_MAX_SPLIT",
                         quant_gemm.DECODE_MAX_SPLIT)):
        assert re.search(rf"#define {name} (\d+)", src).group(1) == str(value)
    stages = int(re.search(r"kStages = (\d+);", src).group(1))
    dec_stages = int(re.search(r"kDecStages = (\d+);", src).group(1))
    slice_rows = int(re.search(r"kSlice = (\d+);", src).group(1))
    assert slice_rows == quant_gemm.DECODE_SLICE
    assert quant_gemm.smem_bytes(64, 64, 64) == stages * 64 * 128
    assert quant_gemm.decode_smem_bytes(8, 32, 1) == (
        4 * dec_stages * slice_rows * quant_gemm.DECODE_BN + 8 * (32 + 16))
    for bm, bk, bn in tiles:
        assert bm % 32 == 0 and bk == 64 and bn in (64, 128, 256)
        assert quant_gemm.smem_bytes(bm, bk, bn) <= 232_448
    assert quant_gemm.decode_smem_bytes(16, 8960, 1) <= 232_448
    assert "__float2int" not in src and "roundf" not in src


def test_snap_tile_keeps_menu_tiles_and_snaps_others():
    for t in quant_gemm.TILES:
        assert quant_gemm.snap_tile(*t) == t
    assert quant_gemm.snap_tile(16, 64, 64) == (32, 64, 64)
    assert quant_gemm.snap_tile(16, 128, 64) == (32, 64, 64)
    assert quant_gemm.snap_tile(256, 512, 256) == (128, 64, 128)
    assert quant_gemm.snap_tile(32, 128, 128) in quant_gemm.TILES


@pytest.mark.parametrize("k", [1, 31, 32, 33, 1000, 1536, 8960])
def test_split_ranges_cover_k_once(k):
    """The (base, extra) of `split_slices`, which the wrapper passes the
    decode kernel, gives split s the 32-row slices [s base + min(s,
    extra), + base + (s < extra)) (the kernel's formula): every row of a
    ragged or whole K exactly once, in order, at split 1, the planner's
    split, the largest, and splits past K's slices (empty, as the kernel
    takes them)."""
    planned = HopperModel().decide(KernelRequest(
        "gemm_w8", 8, k, 1536, in_bytes=1, out_bytes=2)).meta_dict["split_k"]
    for split in sorted({1, 2, 3, 7, planned, quant_gemm.DECODE_MAX_SPLIT}):
        base, extra = quant_gemm.split_slices(k, split)
        assert base * split + extra == -(-k // 32) and 0 <= extra < split
        ranges = []
        for s in range(split):
            lo = (s * base + min(s, extra)) * 32
            hi = lo + (base + (s < extra)) * 32
            ranges.append((min(lo, k), min(hi, k)))
        taken = [row for lo, hi in ranges for row in range(lo, hi)]
        assert taken == list(range(k))
        sizes = [-(-(hi - lo) // 32) for lo, hi in ranges]
        assert max(sizes) - min(sizes) <= 1
        if split > -(-k // 32):
            assert sum(lo == hi for lo, hi in ranges) == split - -(-k // 32)
    with pytest.raises(ValueError):
        quant_gemm.split_slices(k, 0)


# --------------------------------------------------------------------------
# Cost model and engine
# --------------------------------------------------------------------------


QWEN_KN = ((1536, 1536), (1536, 256), (1536, 8960), (8960, 1536))


@pytest.mark.parametrize("m", [4, 8, 2048, 5])
@pytest.mark.parametrize("op", ["gemm", "gemm_w8"])
def test_hopper_plans_int8_on_the_kernel_menu(m, op):
    """Decode M plans the decode path at a split on its menu, M = 2048 the
    tiled path at a menu tile; each decision's shared memory is the
    kernel's and fits a block; the int8 grouped GEMM plans a menu tile."""
    for k, n in QWEN_KN:
        dec = HopperModel().decide(KernelRequest(op, m, k, n, in_bytes=1,
                                                 out_bytes=2))
        meta = dec.meta_dict
        assert dec.dataflow == "os"
        if m <= 16:
            assert meta["path"] == "decode"
            assert 1 <= meta["split_k"] <= quant_gemm.DECODE_MAX_SPLIT
            assert meta["smem_bytes"] == quant_gemm.decode_smem_bytes(
                m, k, meta["split_k"]) <= 232_448
        else:
            assert meta["path"] == "tiled" and meta["split_k"] == 1
            assert (dec.bm, dec.bk, dec.bn) in quant_gemm.TILES
            assert meta["smem_bytes"] == quant_gemm.smem_bytes(
                dec.bm, dec.bk, dec.bn) <= 232_448
        assert dec.seconds > 0
    grouped = HopperModel().decide(KernelRequest(
        "grouped_gemm", 32, 1024, 512, groups=32, in_bytes=1, out_bytes=2))
    assert (grouped.bm, grouped.bk, grouped.bn) in quant_gemm.TILES
    assert cost.peak_flops(1) == 1979e12 == cost.PEAK_OPS_INT8
    assert cost.peak_flops(2) == 989e12


@pytest.mark.parametrize("m", [1, 4, 8, 16, 17, 33, 512, 2048, 6144])
def test_decide_int8_paths_splits_and_tiles(m):
    """`decide_int8`: the decode path up to 16 rows, with the least-cost
    split (the first of equals) filling the card as far as a cluster of
    8 lets it (at least 0.9 of the SMs where 8 splits of the tiles reach
    them; at N = 256, whose 4 column tiles give at most 32 blocks, 7 or 8
    splits); the tiled path above 16 rows at the least-cost menu tile,
    whose grid at M = 2048, N = 256 is not the 32 blocks of the old
    (128 x 128) tile."""
    for k, n in QWEN_KN:
        dec = HopperModel().decide(KernelRequest("gemm_w8", m, k, n,
                                                 in_bytes=1, out_bytes=2))
        meta = dec.meta_dict
        if m <= quant_gemm.DECODE_ROWS[-1]:
            split = meta["split_k"]
            costs = [cost.int8_decode_cost(m, k, n, s) for s in
                     range(1, quant_gemm.DECODE_MAX_SPLIT + 1)]
            assert meta["path"] == "decode"
            assert dec.seconds == costs[split - 1]["seconds"] == min(
                c["seconds"] for c in costs if c is not None)
            assert (dec.bm, dec.bn) == (quant_gemm.decode_rows(m),
                                        quant_gemm.DECODE_BN)
            tiles = -(-n // quant_gemm.DECODE_BN)
            assert meta["blocks"] == tiles * split
            if tiles * quant_gemm.DECODE_MAX_SPLIT >= cost.SMS:
                assert meta["blocks"] >= 0.9 * cost.SMS
            else:
                assert split >= quant_gemm.DECODE_MAX_SPLIT - 1
            assert meta["hbm_bytes"] == k * n + m * k + 4 * m * n
            continue
        tile = (dec.bm, dec.bk, dec.bn)
        assert meta["path"] == "tiled" and meta["split_k"] == 1
        assert tile in quant_gemm.TILES
        assert dec.seconds == min(cost.int8_tiled_cost(m, k, n, t)["seconds"]
                                  for t in quant_gemm.TILES)
        assert meta["blocks"] == -(-m // tile[0]) * -(-n // tile[2])
        if (m, n) == (2048, 256):
            assert meta["blocks"] > 32


#: the card's int8 sweep (`chip_smoke.py --sweep-int8`, NVIDIA H100
#: 80GB HBM3, 700 W): every decode split at M <= 16 and every tiled tile
#: above, at qwen2-1.5b's (K, N); the data `decide_int8`'s constants are
#: fitted to (`calibrate_gemm.py --int8 --fit`)
INT8_SWEEP = Path(__file__).parent / "data" / "int8_sweep_h100.jsonl"


def test_decide_int8_picks_hold_on_the_cards_sweep():
    """At every shape of the committed sweep the planner's decision is a
    measured configuration of its path and takes at most 1.25x the
    fastest of them (as `chip_smoke.py` phase 12 holds it on the card)."""
    shapes = {}
    for line in INT8_SWEEP.read_text().splitlines():
        row = json.loads(line)
        shapes.setdefault((row["m"], row["k"], row["n"]), []).append(row)
    assert len(shapes) == 36
    for (m, k, n), rows in shapes.items():
        dec = HopperModel().decide(KernelRequest(
            "gemm_w8", m, k, n, in_bytes=1, out_bytes=2))
        meta = dec.meta_dict
        if meta["path"] == "decode":
            pick = next(r for r in rows if r["path"] == "decode"
                        and r["split_k"] == meta["split_k"])
        else:
            pick = next(r for r in rows if r["path"] == "tiled" and tuple(
                r["tile"]) == (dec.bm, dec.bk, dec.bn))
        assert len(rows) == (quant_gemm.DECODE_MAX_SPLIT if m <= 16
                             else len(quant_gemm.TILES))
        assert pick["us"] <= 1.25 * min(r["us"] for r in rows), (m, k, n)


def test_int8_path_and_split_survive_json(tmp_path):
    """A decode decision (M = 8) and a tiled one (M = 2048) keep their
    path, split and tile through the plan's JSON and name the same kernel
    arguments after it; a decision without a path (an older plan) runs
    the tiled path at its tile snapped to the menu."""
    from repro_torch.engine.backends import int8_args
    from repro_torch.engine.plan import KernelDecision

    decode = KernelRequest("gemm_w8", 8, 8960, 1536, in_bytes=1, out_bytes=2)
    tiled = KernelRequest("gemm_w8", 2048, 1536, 256, in_bytes=1,
                          out_bytes=2)
    plan, model = ExecutionPlan(), HopperModel()
    for req in (decode, tiled):
        plan.add(req, model.decide(req))
    plan.save(tmp_path / "plan.json")
    loaded = ExecutionPlan.load(tmp_path / "plan.json")
    for req in (decode, tiled):
        before, after = plan.decisions[req.key()], loaded.lookup(req)
        assert after == before
        assert int8_args(after) == int8_args(before)
    got = int8_args(loaded.lookup(decode))
    assert got == {"path": "decode",
                   "split_k": model.decide(decode).meta_dict["split_k"]}
    assert int8_args(loaded.lookup(tiled))["path"] == "tiled"
    old = KernelDecision(op="gemm_w8", dataflow="os", bm=16, bk=128, bn=64,
                         cost_model="hopper-h100", seconds=1e-5)
    assert int8_args(old) == {"path": "tiled", "tile": (32, 64, 64)}
    assert ExecutionPlan.from_json(loaded.to_json()).to_json() == \
        loaded.to_json()


def test_int8_backends_and_their_names():
    assert INT8_BACKENDS == ("hopper-int8", "torch-ref-int8")
    assert set(INT8_BACKENDS) <= set(BACKENDS)
    assert [int8_sibling(b) for b in (None, "hopper", "torch-ref",
                                      "hopper-int8", "torch-ref-int8")] == [
        "hopper-int8", "hopper-int8", "torch-ref-int8", "hopper-int8",
        "torch-ref-int8"]
    with pytest.raises(ValueError, match="cannot upgrade"):
        int8_sibling("xla-einsum")
    assert backend_in_bytes("hopper-int8", 2) == 1
    assert backend_in_bytes("hopper", 2) == 2
    assert Engine(backend="hopper-int8").int8
    assert not Engine(backend="hopper").int8


@pytest.mark.parametrize("backend", INT8_BACKENDS)
def test_int8_backend_keys_plan_at_one_byte(backend):
    """As tests/test_quant.py's test of the reference: operands key at 1
    byte, the output at the float compute width; the product equals the
    reference's `xla-int8` one."""
    a, b = _normal((16, 64), 7), _normal((64, 32), 8)
    with jax_engine.use_engine(backend="xla-int8") as jeng:
        want = jeng.matmul(jnp.asarray(a), jnp.asarray(b))
    with use_engine(backend=backend) as eng:
        got = eng.matmul(torch.from_numpy(a), torch.from_numpy(b))
    (req, dec), = list(eng.plan)
    assert req.in_bytes == 1 and req.out_bytes == 4
    assert dec.backend == backend
    np.testing.assert_array_equal(got.numpy(), _np(want))
    r1 = KernelRequest("gemm", 512, 512, 512, in_bytes=1, out_bytes=1)
    r2 = KernelRequest("gemm", 512, 512, 512, in_bytes=2, out_bytes=2)
    plan = ExecutionPlan()
    plan.add(r1, HopperModel().decide(r1))
    assert plan.lookup(r2) is None  # bf16 must not reuse the int8 plan


@pytest.mark.parametrize("backend", INT8_BACKENDS)
def test_dense_dispatches_gemm_w8_on_an_int8_engine(backend):
    """tests/test_quant.py's `dense` test, and the reference's output bit
    for bit."""
    rng = np.random.default_rng(9)
    w = rng.normal(size=(32, 16)).astype(np.float32)
    bias = rng.normal(size=(16,)).astype(np.float32)
    x = rng.normal(size=(2, 4, 32)).astype(np.float32)
    jp = {"w": jax_quantize(jnp.asarray(w)), "b": jnp.asarray(bias)}
    with jax_engine.use_engine(backend="xla-int8") as jeng:
        want = jax_layers.dense(jp, jnp.asarray(x))
    p = {"w": quantize(torch.from_numpy(w)), "b": torch.from_numpy(bias)}
    with use_engine(backend=backend) as eng:
        got = layers.dense(p, torch.from_numpy(x))
    assert {req.op for req, _ in eng.plan} == {"gemm_w8"}
    assert {req.op for req, _ in jeng.plan} == {"gemm_w8"}
    (req, _), = list(eng.plan)
    assert (req.m, req.k, req.n, req.in_bytes, req.out_bytes) == (
        8, 32, 16, 1, 4)
    assert got.shape == (2, 4, 16)
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_dense_dequantizes_outside_an_int8_engine():
    rng = np.random.default_rng(8)
    w = rng.normal(size=(32, 16)).astype(np.float32)
    x = rng.normal(size=(4, 32)).astype(np.float32)
    pq = {"w": quantize(torch.from_numpy(w))}
    ref = layers.dense({"w": torch.from_numpy(w)}, torch.from_numpy(x))
    out = layers.dense(pq, torch.from_numpy(x))          # no engine
    # the quantization error, as the reference's own test bounds it
    assert ((out - ref).abs().max() / ref.abs().max()).item() < 0.02
    want = jax_layers.dense({"w": jax_quantize(jnp.asarray(w))},
                            jnp.asarray(x))
    # f32 sums in another order than XLA's (tests/test_torch_serve.py TOL)
    np.testing.assert_allclose(out.numpy(), _np(want), rtol=1e-5, atol=1e-5)
    for backend in ("hopper", "torch-ref"):              # float engines
        with use_engine(backend=backend) as eng:
            out2 = layers.dense(pq, torch.from_numpy(x))
        assert {req.op for req, _ in eng.plan} == {"gemm"}
        torch.testing.assert_close(out2, out, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", INT8_BACKENDS)
def test_int8_grouped_gemm_equals_reference(backend):
    x, w = _normal((3, 20, 64), 10), _normal((3, 64, 40), 11)
    reg = jax_engine.default_registry()
    jdec = jax_engine.TPUModel().decide(jax_engine.KernelRequest(
        "grouped_gemm", 20, 64, 40, groups=3, in_bytes=1, out_bytes=4))
    want = reg.get("xla-int8", "grouped_gemm")(jdec, jnp.asarray(x),
                                               jnp.asarray(w))
    with use_engine(backend=backend) as eng:
        got = eng.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w))
    (req, dec), = list(eng.plan)
    assert req.in_bytes == 1 and (dec.bm, dec.bk, dec.bn) in quant_gemm.TILES
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("backend", INT8_BACKENDS)
def test_int8_backends_register_plain_attention(backend):
    """The reference's int8 backends register its plain attention
    (`_xla_attention`), not the flash kernel; f32, sums in XLA's order
    against torch's (tests/test_torch_serve.py TOL)."""
    q, k, v = (_normal((2, 4, 24, 16), s) for s in (12, 13, 14))
    reg = jax_engine.default_registry()
    jdec = jax_engine.TPUModel().decide(jax_engine.KernelRequest(
        "attention", 24, 16, 24, groups=8, in_bytes=1, out_bytes=4))
    want = reg.get("xla-int8", "attention")(
        jdec, *(jnp.asarray(t) for t in (q, k, v)), causal=True)
    with use_engine(backend=backend) as eng:
        got = eng.attention(*(torch.from_numpy(t) for t in (q, k, v)))
    assert eng.registry.get(backend, "attention").__name__ == "plain_attention"
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------
# ServeConfig(quantize=True)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("given,want", [
    (None, "hopper-int8"), ("hopper", "hopper-int8"),
    ("torch-ref", "torch-ref-int8"), ("hopper-int8", "hopper-int8")])
def test_serveconfig_quantize_upgrades_the_backend(given, want):
    scfg = serve.ServeConfig(max_seq=8, batch=1, kernel_backend=given,
                             quantize=True, device="cpu")
    assert scfg.kernel_backend == want
    assert serve.warm_start_engine(scfg).int8
    assert serve.ServeConfig(max_seq=8, batch=1, kernel_backend=given,
                             device="cpu").kernel_backend == given


def test_serveconfig_quantize_refuses_what_it_cannot_upgrade():
    with pytest.raises(ValueError, match="cannot upgrade"):
        serve.ServeConfig(max_seq=8, batch=1, kernel_backend="xla-einsum",
                          quantize=True, device="cpu")
    # as the reference (tests/test_quant.py)
    with pytest.raises(ValueError, match="cannot upgrade"):
        jax_serve.ServeConfig(max_seq=8, batch=1, kernel_backend="nope",
                              quantize=True)
    # the full posture, int8 weights over an int8 KV cache, now builds
    full = serve.ServeConfig(max_seq=8, batch=1, cache_dtype="int8",
                             quantize=True, device="cpu")
    assert (full.kernel_backend, full.cache_dtype) == ("hopper-int8",
                                                       torch.int8)
    leaves = serve.init_cache(get_config(ARCH, smoke=True),
                              full)["slots"]["b0"]
    assert (leaves["k"].dtype, leaves["k_scale"].dtype) == (torch.int8,
                                                            torch.float32)


def test_warm_start_keys_an_int8_plan_at_one_byte(tmp_path, recwarn):
    """An int8 plan warms an int8 ServeConfig without a warning; a bf16
    plan on it warns (it would miss on every lookup)."""
    int8_plan, bf16_plan = tmp_path / "int8.json", tmp_path / "bf16.json"
    eng = Engine(backend="hopper-int8")
    eng.quant_matmul(torch.zeros(4, 64), torch.zeros(64, 32, dtype=torch.int8),
                     torch.ones(1, 32), out_dtype=torch.bfloat16)
    eng.plan.save(int8_plan)
    eng = Engine()
    eng.decide(KernelRequest("gemm", 4, 64, 32, in_bytes=2, out_bytes=2))
    eng.plan.save(bf16_plan)
    kw = dict(max_seq=8, batch=1, compute_dtype="bfloat16", quantize=True,
              device="cpu")
    warm = serve.warm_start_engine(serve.ServeConfig(plan_path=str(int8_plan),
                                                     **kw))
    assert not [w for w in recwarn if "warm-start" in str(w.message)]
    assert len(warm.plan) == 1
    with pytest.warns(UserWarning, match="in_bytes=1"):
        serve.warm_start_engine(serve.ServeConfig(plan_path=str(bf16_plan),
                                                  **kw))


TRACE = [(6, 8), (10, 2), (6, 5), (14, 9), (10, 3), (6, 7), (14, 2), (10, 6)]


def _trace_prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, p).astype(np.int32) for p, _ in TRACE]


@pytest.fixture(scope="module")
def reference_runs(smoke):
    """The reference Scheduler on tests/test_quant.py's 8-request trace,
    quantized weights, quantize=True (it resolves to "xla-int8"), f32
    cache, contiguous and paged; and its `generate` on two prompts."""
    jcfg, _, jq, _, _ = smoke
    prompts = _trace_prompts(jcfg.vocab)
    max_seq = max(p + g for p, g in TRACE) + 1
    runs = {}
    for layout in ("contiguous", "paged"):
        scfg = jax_serve.ServeConfig(
            max_seq=max_seq, batch=3, compute_dtype=jnp.float32,
            cache_dtype=jnp.float32, quantize=True, cache_layout=layout,
            page_size=4)
        assert scfg.kernel_backend == "xla-int8"
        done = JaxScheduler(jq, jcfg, scfg).run(
            [JaxRequest(uid=i, prompt=p, max_new_tokens=g)
             for i, (p, (_, g)) in enumerate(zip(prompts, TRACE))])
        runs[layout] = {u: np.asarray(c.tokens) for u, c in done.items()}
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 11))
    scfg = jax_serve.ServeConfig(max_seq=20, batch=2,
                                 compute_dtype=jnp.float32,
                                 cache_dtype=jnp.float32, quantize=True)
    runs["generate"] = (tokens.astype(np.int32), np.asarray(jax_serve.generate(
        jq, jcfg, scfg, jnp.asarray(tokens, jnp.int32), 6)))
    return runs


@pytest.mark.parametrize("backend", ["hopper", "torch-ref"])
def test_generate_quantized_tokens_equal_reference(smoke, reference_runs,
                                                   backend):
    _, _, jq, cfg, _ = smoke
    params = params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu")
    prompt, want = reference_runs["generate"]
    scfg = serve.ServeConfig(max_seq=20, batch=2, compute_dtype="float32",
                             cache_dtype="float32", kernel_backend=backend,
                             quantize=True, device="cpu")
    got = serve.generate(params, cfg, scfg, prompt, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    eng = serve.warm_start_engine(scfg)
    assert {req.op for req, _ in eng.plan} == {"gemm_w8"}


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("backend", ["hopper-int8", "torch-ref-int8"])
def test_scheduler_quantized_tokens_equal_reference(smoke, reference_runs,
                                                    layout, backend):
    """Identical tokens per uid against the reference Scheduler, on the
    same quantized weights carried through the bridge."""
    _, _, jq, cfg, _ = smoke
    params = params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu")
    scfg = serve.ServeConfig(
        max_seq=max(p + g for p, g in TRACE) + 1, batch=3,
        compute_dtype="float32", cache_dtype="float32",
        kernel_backend=backend, quantize=True, device="cpu",
        cache_layout=layout, page_size=4)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=g) for i, (p, (_, g))
            in enumerate(zip(_trace_prompts(cfg.vocab), TRACE))]
    sched = Scheduler(params, cfg, scfg)
    done = sched.run(reqs)
    want = reference_runs[layout]
    assert sorted(done) == sorted(want)
    for uid, toks in want.items():
        np.testing.assert_array_equal(done[uid].tokens, toks,
                                      err_msg=f"uid={uid}")
    ops = {req.op for req, _ in sched.engine.plan}
    assert "gemm_w8" in ops and "gemm" not in ops
    assert all(req.in_bytes == 1 for req, _ in sched.engine.plan)


def test_quantized_tree_from_the_port_serves_like_the_bridged_one(smoke):
    """`quantize_params` on the port's own tree gives the bridged tree
    (bitwise, above), so it serves the same tokens."""
    _, _, jq, cfg, params = smoke
    bridged = params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu")
    scfg = serve.ServeConfig(max_seq=16, batch=2, compute_dtype="float32",
                             cache_dtype="float32", quantize=True,
                             device="cpu")
    prompt = np.random.default_rng(2).integers(0, cfg.vocab, (2, 7))
    a = serve.generate(quantize_params(params), cfg, scfg, prompt, 4)
    b = serve.generate(bridged, cfg, scfg, prompt, 4)
    assert torch.equal(a, b)
    assert tree_bytes(bridged) < tree_bytes(params)
