"""The port's engine (plan, registry, HopperModel, Engine) against the
JAX package's engine, on the CPU."""

import collections
import itertools
import json
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jax_engine
from repro.core import tpu_model
from repro_torch.engine import (BACKENDS, Engine, ExecutionPlan, HopperModel,
                                KernelRequest, default_registry, use_engine)
from repro_torch.engine import cost
from repro_torch.kernels import redas_gemm

#: every engine GEMM of full-width qwen2-1.5b serving 4 requests of 512
#: prompt tokens: M = 4 (decode) or 2048 (prefill) x (K, N) of wq/wo,
#: wk/wv, wi/wg and the MLP's wo.
MAIN_PATH_KN = ((1536, 1536), (1536, 256), (1536, 8960), (8960, 1536))
MAIN_PATH_SHAPES = [(m, k, n) for m in (4, 2048) for k, n in MAIN_PATH_KN]


def test_plan_json_roundtrip_byte_identical(tmp_path):
    eng = Engine()
    for m, k, n in MAIN_PATH_SHAPES:
        eng.decide(KernelRequest("gemm", m, k, n))
    eng.plan.save(tmp_path / "plan.json")
    text = (tmp_path / "plan.json").read_text()
    plan2 = ExecutionPlan.load(tmp_path / "plan.json")
    plan2.save(tmp_path / "plan2.json")
    assert (tmp_path / "plan2.json").read_text() == text
    assert list(plan2) == list(eng.plan)


def test_plan_format_is_the_jax_packages(tmp_path):
    """A JAX plan of gemm decisions loads in the port and saves back byte
    for byte."""
    eng = jax_engine.Engine(backend="pallas-interpret")
    eng.plan_gemms([(128, 256, 512), (1, 1024, 16), (43264, 144, 32)])
    eng.plan.save(tmp_path / "jax.json")
    text = (tmp_path / "jax.json").read_text()
    assert ExecutionPlan.from_json(text).to_json() == text


def test_hits_and_misses_count_as_in_jax_engine():
    rng = np.random.default_rng(0)
    mats = [rng.normal(size=s).astype(np.float32)
            for s in ((16, 64), (64, 32), (32, 48))]
    seq = [(0, 1), (0, 1), (0, 1), (1, 2), (0, 1), (1, 2)]
    jeng = jax_engine.Engine(backend="xla-einsum")
    teng = Engine(backend="torch-ref")
    for i, j in seq:
        jeng.matmul(jnp.asarray(mats[i]), jnp.asarray(mats[j]))
        teng.matmul(torch.from_numpy(mats[i]), torch.from_numpy(mats[j]))
    assert teng.plan.stats == jeng.plan.stats
    assert teng.plan.stats["decisions"] == 2


@pytest.mark.parametrize("in_bytes", [2, 4])
@pytest.mark.parametrize("shape", MAIN_PATH_SHAPES)
def test_hopper_decisions_lie_in_menu_and_fit_shared_memory(shape, in_bytes):
    """Each decision's tile is on its dataflow's menu (OS: the menu of the
    route the shape takes, the wgmma kernel's for these bf16 shapes, the
    sync kernel's for f32), and its block's shared memory in that
    kernel's layout (wgmma: the TMA ring; sync OS: `smem_bytes`, which the
    grouped GEMM shares; WS/IS: the slab and the ring at the depth the
    wrapper launches) fits the card and is what `meta` records."""
    dec = HopperModel().decide(KernelRequest("gemm", *shape, in_bytes=in_bytes,
                                             out_bytes=in_bytes))
    assert dec.dataflow in redas_gemm.DATAFLOWS
    route = "wgmma" if in_bytes == 2 else "sync"
    assert redas_gemm.shape_route(in_bytes, *shape[1:]) == route
    tile = (dec.bm, dec.bk, dec.bn)
    if dec.dataflow == "os":
        assert tile in redas_gemm.tiles_for("os", route)
        assert dec.meta_dict["route"] == route
        smem = (redas_gemm.wgmma_smem_bytes(*tile) if route == "wgmma"
                else redas_gemm.smem_bytes(*tile, in_bytes))
    else:
        assert tile in redas_gemm.tiles_for(dec.dataflow)
        smem = redas_gemm.stream_smem_bytes(
            dec.dataflow, *tile, in_bytes,
            redas_gemm.stream_stages(dec.dataflow, *tile, in_bytes))
    assert smem == redas_gemm.tile_smem(dec.dataflow, *tile, in_bytes, route)
    assert smem == dec.meta_dict["smem_bytes"] <= 232_448
    assert dec.seconds > 0


def test_traffic_formula_equals_jax_packages():
    for (m, k, n), tile, df, (ib, ob) in itertools.product(
            MAIN_PATH_SHAPES + [(40, 96, 200), (257, 64, 8)],
            redas_gemm.TILES, redas_gemm.DATAFLOWS, ((2, 2), (4, 4), (2, 4))):
        bm, bk, bn = tile
        assert cost.hbm_traffic(m, k, n, cost.TileConfig(df, bm, bk, bn),
                                ib, ob) == tpu_model.hbm_traffic(
            m, k, n, tpu_model.TPUKernelConfig(df, bm, bk, bn), ib, ob)


#: decode M = 4 (static) and 8 (paged): WS or IS, K split into slabs
#: where it spans more than one, but OS on the wgmma kernel at N = 8960
#: (13.3-13.4 us against WS/IS's 17.0-17.4, 1.3x, in
#: tests/data/gemm_sweep_h100.jsonl); prefill M = 2048: OS on the wgmma
#: kernel at every (K, N), N = 256 included (10.3 us against 23.6)
DECODE_DATAFLOW = {(1536, 1536): ("ws", "is"), (1536, 256): ("ws", "is"),
                   (1536, 8960): ("os",), (8960, 1536): ("ws", "is")}


@pytest.mark.parametrize("m", [4, 8, 2048])
@pytest.mark.parametrize("k,n", MAIN_PATH_KN)
def test_hopper_gemm_picks_streaming_at_decode_and_os_at_prefill(m, k, n):
    """The wave term moves qwen's bf16 decode GEMMs off OS's serial K loop
    onto WS/IS with K slabs in parallel, except where the wgmma OS
    kernel's one wave of blocks is faster (N = 8960); prefill is OS.  A
    streaming decision's `meta` carries the slabs and groups the kernel
    runs at, an OS one its route."""
    dec = HopperModel().decide(KernelRequest("gemm", m, k, n))
    meta = dec.meta_dict
    tile = (dec.bm, dec.bk, dec.bn)
    want = DECODE_DATAFLOW[k, n] if m <= 16 else ("os",)
    assert dec.dataflow in want
    if dec.dataflow == "os":
        assert meta["route"] == "wgmma" and meta["slabs"] == 1
    else:
        assert meta["slabs"] == redas_gemm.slab_count(k, dec.bk)
        assert meta["groups"] == redas_gemm.groups_for(
            dec.dataflow, m, k, n, tile, 2)
        os_dec = cost.decide_gemm(KernelRequest("gemm", m, k, n), "test",
                                  dataflows=("os",))
        assert os_dec.seconds > dec.seconds
    assert meta["blocks"] == math.prod(redas_gemm.grid(
        dec.dataflow, m, k, n, tile, meta["groups"]))
    assert 0 < meta["fill"] <= 1
    assert meta["workspace_bytes"] == (
        2 * meta["slabs"] * m * n * 4 if meta["slabs"] > 1 else 0)


#: the card's calibration sweep (`chip_smoke.py --sweep`, NVIDIA H100 80GB
#: HBM3, 700 W): every (dataflow, tile) timed at 38 shapes
SWEEP = Path(__file__).parent / "data" / "gemm_sweep_h100.jsonl"
#: the most the decision may take against the fastest dataflow (each at
#: the model's best tile for it), as `chip_smoke.py` phase 2 holds it
PICK_LIMIT = 1.25
#: the paged prefill's GEMM M (8 slots x widths 64 and 768), held out of
#: the fit of `gemm_cost`'s constants
HELD_OUT_M = (512, 6144)


def _sweep() -> dict:
    shapes = collections.defaultdict(list)
    for line in SWEEP.read_text().splitlines():
        row = json.loads(line)
        if tuple(row["tile"]) in redas_gemm.tiles_for(
                row["dataflow"], row.get("route") or "sync"):
            shapes[row["m"], row["k"], row["n"], row["dtype"]].append(row)
    return shapes


@pytest.mark.parametrize("held_out", [False, True])
def test_gemm_cost_picks_hold_on_the_cards_sweep(held_out):
    """At every bf16 shape of the committed sweep (the shapes the
    constants were fitted to, and apart from them the held-out paged
    prefill), the model's decision among the measured configurations
    takes at most PICK_LIMIT x the fastest dataflow's time, each
    dataflow at the model's best tile for it."""
    shapes = {key: rows for key, rows in _sweep().items()
              if key[3] == "bfloat16" and (key[0] in HELD_OUT_M) == held_out}
    assert len(shapes) == (8 if held_out else 28)
    for (m, k, n, _), rows in shapes.items():
        seconds = {id(r): cost.gemm_cost(m, k, n, r["dataflow"],
                                         tuple(r["tile"]), 2, 2,
                                         r.get("route"))["seconds"]
                   for r in rows}
        best = {}
        for r in rows:
            df = r["dataflow"]
            if df not in best or seconds[id(r)] < seconds[id(best[df])]:
                best[df] = r
        assert set(best) == set(redas_gemm.DATAFLOWS)
        pick = min(best.values(), key=lambda r: seconds[id(r)])
        dec = HopperModel().decide(KernelRequest("gemm", m, k, n))
        assert [dec.dataflow, dec.bm, dec.bk, dec.bn] == [
            pick["dataflow"], *pick["tile"]]
        fastest = min(r["us"] for r in best.values())
        assert pick["us"] <= PICK_LIMIT * fastest, (m, k, n, pick)


def test_hopper_plans_float_gemm_only_through_the_wave_term():
    """A float `gemm` goes to `decide_gemm`; an int8 request to
    `decide_int8`; any other operand width is refused."""
    int8 = KernelRequest("gemm_w8", 8, 1536, 1536, in_bytes=1, out_bytes=2)
    assert HopperModel().decide(int8) == cost.decide_int8(int8,
                                                          "hopper-h100")
    req = KernelRequest("gemm", 8, 1536, 1536)
    assert HopperModel().decide(req) == cost.decide_gemm(req, "hopper-h100")
    with pytest.raises(ValueError, match="not 2"):
        HopperModel().decide(KernelRequest("gemm_w8", 8, 1536, 1536))
    with pytest.raises(ValueError, match="not 4"):
        HopperModel().decide(KernelRequest("gemm_w8", 8, 1536, 1536,
                                           in_bytes=4, out_bytes=4))


def test_stream_decisions_keep_slabs_and_groups_through_json(tmp_path):
    """A plan's JSON keeps `slabs` and `groups`, and the backend passes
    them on to the kernel's wrapper."""
    from repro_torch.engine.backends import gemm_args

    eng = Engine()
    for m, k, n in MAIN_PATH_SHAPES:
        eng.decide(KernelRequest("gemm", m, k, n))
    eng.plan.save(tmp_path / "plan.json")
    back = ExecutionPlan.load(tmp_path / "plan.json")
    streamed = 0
    for (req, dec), (req2, dec2) in zip(eng.plan, back, strict=True):
        assert (req, dec) == (req2, dec2)
        meta = dec2.meta_dict
        args = gemm_args(dec2)
        assert (args["dataflow"], args["bm"], args["bk"], args["bn"]) == (
            dec.dataflow, dec.bm, dec.bk, dec.bn)
        if dec2.dataflow == "os":
            assert "slabs" not in args and meta["route"] == "wgmma"
        else:
            streamed += 1
            assert (args["slabs"], args["groups"]) == (meta["slabs"],
                                                       meta["groups"])
            assert type(args["groups"]) is int
    assert streamed >= 3     # decode at N = 1536 and 256 (DECODE_DATAFLOW)


#: the decisions of the other kernels' requests at their main-path shapes,
#: as the parent commit of the wave term made them (it plans only `gemm`
#: at in_bytes 2 and 4, and the bf16 `grouped_gemm` of the wgmma route
#: below), and the grouped requests also in f32, whose sync route keeps
#: the roofline; the int8 `gemm_w8` ones as the int8 kernel's own wave
#: terms (`decide_int8`) make them: request (op, m, k, n, groups,
#: in_bytes, density) -> (dataflow, bm, bk, bn, seconds, meta); out_bytes 2
PINNED_DECISIONS = {
    ('gemm_w8', 4, 1536, 1536, 1, 1, 1.0): (
        'os', 8, 320, 64, 4.519051130434783e-06,
        {'blocks': 120, 'fill': 0.9090909090909091,
         'hbm_bytes': 2390016.0, 'path': 'decode', 'smem_bytes': 51840,
         'split_k': 5}),
    ('gemm_sparse', 4, 1536, 1536, 1, 2, 0.5): (
        'os', 4, 64, 256, 2.299262089552239e-06,
        {'blocks': 144, 'density': 0.5, 'hbm_bytes': 4743168.0,
         'k_effective': 768, 'path': 'decode', 'split_k': 24,
         'workspace_bytes': 1179648}),
    ('gemm_w8', 4, 1536, 256, 1, 1, 1.0): (
        'os', 8, 224, 64, 4.43095950310559e-06,
        {'blocks': 28, 'fill': 0.21212121212121213,
         'hbm_bytes': 403456.0, 'path': 'decode', 'smem_bytes': 51072,
         'split_k': 7}),
    ('gemm_sparse', 4, 1536, 256, 1, 2, 0.5): (
        'os', 4, 64, 256, 2.0363844776119402e-06,
        {'blocks': 24, 'density': 0.5, 'hbm_bytes': 800768.0,
         'k_effective': 768, 'path': 'decode', 'split_k': 24,
         'workspace_bytes': 196608}),
    ('gemm_w8', 4, 1536, 8960, 1, 1, 1.0): (
        'os', 8, 768, 64, 9.08272347826087e-06,
        {'blocks': 280, 'fill': 1.0, 'hbm_bytes': 13912064.0,
         'path': 'decode', 'smem_bytes': 55424, 'split_k': 2}),
    ('gemm_sparse', 4, 1536, 8960, 1, 2, 0.5): (
        'os', 4, 192, 256, 6.872109850746269e-06,
        {'blocks': 280, 'density': 0.5, 'hbm_bytes': 23021568.0,
         'k_effective': 768, 'path': 'decode', 'split_k': 8,
         'workspace_bytes': 2293760}),
    ('gemm_w8', 4, 8960, 1536, 1, 1, 1.0): (
        'os', 8, 1120, 64, 9.72798956521739e-06,
        {'blocks': 192, 'fill': 1.0, 'hbm_bytes': 13822976.0,
         'path': 'decode', 'smem_bytes': 58240, 'split_k': 8}),
    ('gemm_sparse', 4, 8960, 1536, 1, 2, 0.5): (
        'os', 4, 204, 256, 6.832983880597015e-06,
        {'blocks': 264, 'density': 0.5, 'hbm_bytes': 22890496.0,
         'k_effective': 4480, 'path': 'decode', 'split_k': 44,
         'workspace_bytes': 2162688}),
    ('gemm_w8', 8, 1536, 1536, 1, 1, 1.0): (
        'os', 8, 320, 64, 4.533743304347826e-06,
        {'blocks': 120, 'fill': 0.9090909090909091,
         'hbm_bytes': 2420736.0, 'path': 'decode', 'smem_bytes': 51840,
         'split_k': 5}),
    ('gemm_sparse', 8, 1536, 1536, 1, 2, 0.5): (
        'os', 8, 64, 256, 2.6617886567164184e-06,
        {'blocks': 144, 'density': 0.5, 'hbm_bytes': 5947392.0,
         'k_effective': 768, 'path': 'decode', 'split_k': 24,
         'workspace_bytes': 2359296}),
    ('gemm_w8', 8, 1536, 256, 1, 1, 1.0): (
        'os', 8, 224, 64, 4.451948322981367e-06,
        {'blocks': 28, 'fill': 0.21212121212121213,
         'hbm_bytes': 413696.0, 'path': 'decode', 'smem_bytes': 51072,
         'split_k': 7}),
    ('gemm_sparse', 8, 1536, 256, 1, 2, 0.5): (
        'os', 8, 64, 256, 2.1360334328358213e-06,
        {'blocks': 24, 'density': 0.5, 'hbm_bytes': 1011712.0,
         'k_effective': 768, 'path': 'decode', 'split_k': 24,
         'workspace_bytes': 393216}),
    ('gemm_w8', 8, 1536, 8960, 1, 1, 1.0): (
        'os', 8, 768, 64, 9.147725217391305e-06,
        {'blocks': 280, 'fill': 1.0, 'hbm_bytes': 14061568.0,
         'path': 'decode', 'smem_bytes': 55424, 'split_k': 2}),
    ('gemm_sparse', 8, 1536, 8960, 1, 2, 0.5): (
        'os', 8, 192, 256, 7.5818794029850746e-06,
        {'blocks': 280, 'density': 0.5, 'hbm_bytes': 25399296.0,
         'k_effective': 768, 'path': 'decode', 'split_k': 8,
         'workspace_bytes': 4587520}),
    ('gemm_w8', 8, 8960, 1536, 1, 1, 1.0): (
        'os', 8, 1120, 64, 9.754257391304347e-06,
        {'blocks': 192, 'fill': 1.0, 'hbm_bytes': 13883392.0,
         'path': 'decode', 'smem_bytes': 58240, 'split_k': 8}),
    ('gemm_sparse', 8, 8960, 1536, 1, 2, 0.5): (
        'os', 8, 204, 256, 7.503627462686567e-06,
        {'blocks': 264, 'density': 0.5, 'hbm_bytes': 25137152.0,
         'k_effective': 4480, 'path': 'decode', 'split_k': 44,
         'workspace_bytes': 4325376}),
    ('gemm_w8', 2048, 1536, 1536, 1, 1, 1.0): (
        'os', 64, 64, 128, 3.3713692733564014e-05,
        {'blocks': 384, 'fill': 0.9696969696969697,
         'hbm_bytes': 18087936.0, 'padding_efficiency': 1.0,
         'path': 'tiled', 'smem_bytes': 49152, 'split_k': 1}),
    ('gemm_sparse', 2048, 1536, 1536, 1, 2, 0.5): (
        'os', 128, 128, 128, 2.4766739104477612e-05,
        {'density': 0.5, 'hbm_bytes': 82968576.0, 'k_effective': 768,
         'padding_efficiency': 1.0, 'path': 'tiled', 'smem_bytes': 159744,
         'split_k': 1, 'stages': 2}),
    ('gemm_w8', 2048, 1536, 256, 1, 1, 1.0): (
        'os', 64, 64, 64, 1.1943948788927335e-05,
        {'blocks': 128, 'fill': 0.24242424242424243,
         'hbm_bytes': 5636096.0, 'padding_efficiency': 1.0,
         'path': 'tiled', 'smem_bytes': 32768, 'split_k': 1}),
    ('gemm_sparse', 2048, 1536, 256, 1, 2, 0.5): (
        'os', 128, 128, 128, 4.127789850746269e-06,
        {'density': 0.5, 'hbm_bytes': 13828096.0, 'k_effective': 768,
         'padding_efficiency': 1.0, 'path': 'tiled', 'smem_bytes': 159744,
         'split_k': 1, 'stages': 2}),
    ('gemm_w8', 2048, 1536, 8960, 1, 1, 1.0): (
        'os', 64, 64, 128, 0.00020228215640138408,
        {'blocks': 2240, 'fill': 1.0, 'hbm_bytes': 90308608.0,
         'padding_efficiency': 1.0, 'path': 'tiled',
         'smem_bytes': 49152, 'split_k': 1}),
    ('gemm_sparse', 2048, 1536, 8960, 1, 2, 0.5): (
        'os', 128, 128, 128, 0.0001444726447761194,
        {'density': 0.5, 'hbm_bytes': 483983360.0, 'k_effective': 768,
         'padding_efficiency': 1.0, 'path': 'tiled', 'smem_bytes': 159744,
         'split_k': 1, 'stages': 2}),
    ('gemm_w8', 2048, 8960, 1536, 1, 1, 1.0): (
        'os', 64, 64, 128, 0.00015997820761245673,
        {'blocks': 384, 'fill': 0.9696969696969697,
         'hbm_bytes': 44695552.0, 'padding_efficiency': 1.0,
         'path': 'tiled', 'smem_bytes': 49152, 'split_k': 1}),
    ('gemm_sparse', 2048, 8960, 1536, 1, 2, 0.5): (
        'os', 128, 128, 128, 0.00013539541970149254,
        {'density': 0.5, 'hbm_bytes': 453574656.0, 'k_effective': 4480,
         'padding_efficiency': 1.0, 'path': 'tiled', 'smem_bytes': 159744,
         'split_k': 1, 'stages': 2}),
    ('grouped_gemm', 32, 1024, 512, 32, 4, 1.0): (
        'os', 32, 64, 64, 3.0361752835820894e-05,
        {'groups': 32, 'smem_bytes': 31744}),
    ('grouped_gemm', 32, 512, 1024, 32, 4, 1.0): (
        'os', 32, 64, 64, 3.067476059701493e-05,
        {'groups': 32, 'smem_bytes': 31744}),
    ('grouped_gemm', 1920, 1024, 512, 32, 4, 1.0): (
        'os', 64, 64, 128, 0.0009615598423880597,
        {'groups': 32, 'smem_bytes': 57344}),
    ('grouped_gemm', 1920, 512, 1024, 32, 4, 1.0): (
        'os', 64, 64, 128, 0.0009615598423880597,
        {'groups': 32, 'smem_bytes': 57344}),
    ('grouped_gemm', 160, 1024, 512, 32, 4, 1.0): (
        'os', 64, 64, 128, 9.615598423880597e-05,
        {'groups': 32, 'smem_bytes': 57344}),
    ('grouped_gemm', 160, 512, 1024, 32, 4, 1.0): (
        'os', 64, 64, 128, 9.615598423880597e-05,
        {'groups': 32, 'smem_bytes': 57344}),
    # bf16 experts whose (D, F) TMA can describe run on the GEMM's wgmma
    # ring, and the same wave term plans them with the experts as a batch
    ('grouped_gemm', 32, 1024, 512, 32, 2, 1.0): (
        'os', 64, 64, 64, 1.0955271641791044e-05,
        {'blocks': 256, 'fill': 0.6464646464646465, 'groups': 32,
         'hbm_bytes': 36700160.0, 'route': 'wgmma', 'smem_bytes': 66624}),
    ('grouped_gemm', 32, 512, 1024, 32, 2, 1.0): (
        'os', 64, 64, 128, 1.0955271641791044e-05,
        {'blocks': 256, 'fill': 0.9696969696969697, 'groups': 32,
         'hbm_bytes': 36700160.0, 'route': 'wgmma', 'smem_bytes': 99392}),
    ('grouped_gemm', 1920, 1024, 512, 32, 2, 1.0): (
        'os', 128, 64, 256, 9.826188034188034e-05,
        {'blocks': 960, 'fill': 1.0, 'groups': 32,
         'hbm_bytes': 222298112.0, 'route': 'wgmma', 'smem_bytes': 197696}),
    ('grouped_gemm', 1920, 512, 1024, 32, 2, 1.0): (
        'os', 128, 64, 256, 0.00010022051282051282,
        {'blocks': 1920, 'fill': 1.0, 'groups': 32,
         'hbm_bytes': 222298112.0, 'route': 'wgmma', 'smem_bytes': 197696}),
    ('grouped_gemm', 160, 1024, 512, 32, 2, 1.0): (
        'os', 128, 64, 256, 1.4711364776119402e-05,
        {'blocks': 128, 'fill': 0.9696969696969697, 'groups': 32,
         'hbm_bytes': 49283072.0, 'route': 'wgmma', 'smem_bytes': 197696}),
    ('grouped_gemm', 160, 512, 1024, 32, 2, 1.0): (
        'os', 128, 64, 256, 1.4711364776119402e-05,
        {'blocks': 256, 'fill': 1.0, 'groups': 32,
         'hbm_bytes': 49283072.0, 'route': 'wgmma', 'smem_bytes': 197696}),
}


def test_other_kernels_decisions_are_unchanged_by_the_wave_term():
    model = HopperModel()
    for (op, m, k, n, g, ib, dens), want in PINNED_DECISIONS.items():
        dec = model.decide(KernelRequest(op, m, k, n, groups=g, in_bytes=ib,
                                         out_bytes=2, density=dens))
        assert (dec.dataflow, dec.bm, dec.bk, dec.bn, dec.seconds,
                dec.meta_dict) == want, (op, m, k, n)


def test_registry_holds_both_backends():
    """The float backends and their int8 and sparse siblings; `gemm_w8`
    is an int8 op only and `gemm_sparse` a sparse one, as in the JAX
    package; the simulator runs `gemm` alone."""
    reg = default_registry()
    ops = ("gemm", "grouped_gemm", "attention", "paged_attention")
    kernel_backends = [b for b in BACKENDS if b != "simulator"]
    assert reg.ops("simulator") == ("gemm",)
    assert reg.get("simulator", "gemm").__name__ == "simulator_gemm"
    assert {(b, op): reg.get(b, op).__name__
            for b in kernel_backends for op in ops} == {
        ("hopper", "gemm"): "hopper_gemm", ("torch-ref", "gemm"): "ref_gemm",
        ("hopper", "grouped_gemm"): "hopper_grouped_gemm",
        ("torch-ref", "grouped_gemm"): "ref_grouped_gemm",
        ("hopper", "attention"): "hopper_attention",
        ("torch-ref", "attention"): "ref_attention",
        ("hopper", "paged_attention"): "hopper_paged_attention",
        ("torch-ref", "paged_attention"): "ref_paged_attention",
        ("hopper-int8", "gemm"): "hopper_int8_gemm",
        ("torch-ref-int8", "gemm"): "ref_int8_gemm",
        ("hopper-int8", "grouped_gemm"): "hopper_int8_grouped_gemm",
        ("torch-ref-int8", "grouped_gemm"): "ref_int8_grouped_gemm",
        ("hopper-int8", "attention"): "plain_attention",
        ("torch-ref-int8", "attention"): "plain_attention",
        ("hopper-int8", "paged_attention"): "hopper_paged_attention",
        ("torch-ref-int8", "paged_attention"): "ref_paged_attention",
        ("hopper-sparse", "gemm"): "hopper_gemm",
        ("torch-ref-sparse", "gemm"): "ref_gemm",
        ("hopper-sparse", "grouped_gemm"): "ref_grouped_gemm",
        ("torch-ref-sparse", "grouped_gemm"): "ref_grouped_gemm",
        ("hopper-sparse", "attention"): "plain_attention",
        ("torch-ref-sparse", "attention"): "plain_attention",
        ("hopper-sparse", "paged_attention"): "hopper_paged_attention",
        ("torch-ref-sparse", "paged_attention"): "ref_paged_attention"}
    assert reg.has("hopper", "paged_attention")
    assert reg.has("hopper", "grouped_gemm")
    assert reg.get("hopper-int8", "gemm_w8").__name__ == "hopper_int8_gemm_w8"
    assert reg.get("torch-ref-int8", "gemm_w8").__name__ == "ref_int8_gemm_w8"
    with pytest.raises(KeyError, match="no kernel"):
        reg.get("hopper", "gemm_w8")


def test_engine_backends_agree_on_cpu():
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.normal(size=(40, 96)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(96, 200)).astype(np.float32))
    with use_engine(backend="hopper") as hop:
        got = hop.matmul(a, b)
    with use_engine(backend="torch-ref") as ref:
        want = ref.matmul(a, b)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="either"):
        with use_engine(hop, backend="hopper"):
            pass


def test_warm_start_engine_cached_per_config(tmp_path):
    """Repeated generate() calls share the decision memo (as the JAX
    package's `_ENGINES` memo does)."""
    from repro_torch.serve_lib import serve as serve_lib

    p = tmp_path / "plan.json"
    eng = Engine()
    eng.decide(KernelRequest("gemm", 16, 64, 32, in_bytes=4, out_bytes=4))
    eng.plan.save(p)
    scfg = serve_lib.ServeConfig(max_seq=8, batch=1, compute_dtype="float32",
                                 kernel_backend="hopper", plan_path=str(p),
                                 device="cpu")
    e1 = serve_lib.warm_start_engine(scfg)
    e2 = serve_lib.warm_start_engine(scfg)
    assert e1 is e2
    assert len(e1.plan) == 1
    other = serve_lib.warm_start_engine(
        serve_lib.ServeConfig(max_seq=16, batch=1, compute_dtype="float32",
                              kernel_backend="hopper", plan_path=str(p),
                              device="cpu"))
    assert other is not e1
    assert serve_lib.warm_start_engine(
        serve_lib.ServeConfig(max_seq=8, batch=1, device="cpu")) is None


def test_serveconfig_normalizes_dtypes():
    """"bfloat16" and torch.bfloat16 spell the SAME config, so the engine
    memo holds one engine (one decision cache), not one per spelling."""
    from repro_torch.serve_lib import serve as serve_lib

    a = serve_lib.ServeConfig(max_seq=8, batch=1, compute_dtype="bfloat16",
                              cache_dtype="bfloat16", kernel_backend="hopper",
                              device="cpu")
    b = serve_lib.ServeConfig(max_seq=8, batch=1,
                              compute_dtype=torch.bfloat16,
                              cache_dtype=torch.bfloat16,
                              kernel_backend="hopper", device="cpu")
    assert a == b and hash(a) == hash(b)
    assert a.compute_dtype == torch.bfloat16
    eng_a = serve_lib.warm_start_engine(a)
    eng_b = serve_lib.warm_start_engine(b)
    assert eng_a is eng_b, "dtype spelling built a duplicate engine"
