"""The port's two attention kernels on the CPU: the plain versions of
`kernels/flash_attention.py` and `kernels/paged_attention.py` against the
JAX Pallas kernels (interpret mode) and the JAX plain versions, the CPU
path of their wrappers, and the engine entry points `Engine.attention`
and `Engine.paged_attention` (memo keys and plan counts as in the JAX
engine).

The CUDA kernels run only on the card: `chip_smoke.py` holds them
against these plain versions there, as tests/test_torch_card.py does.
Tolerances: flash rtol 1e-4 / atol 2e-5 (as tests/test_flash_kernel.py
holds the TPU kernel to its oracle), paged rtol = atol = 2e-5 (as
tests/test_paged.py holds it).
"""

import functools
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jax_engine
from repro.kernels import flash_attention as jfa
from repro.kernels.paged_attention import (paged_attention_reference as
                                           jax_paged_reference,
                                           paged_attention_tpu)
from repro_torch.engine import Engine, HopperModel, KernelRequest
from repro_torch.engine import backends
from repro_torch.kernels import flash_attention, paged_attention

FLASH_TOL = {"rtol": 1e-4, "atol": 2e-5}
PAGED_TOL = {"rtol": 2e-5, "atol": 2e-5}


def _qkv(b, h, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, sq, d)).astype(np.float32),
            rng.normal(size=(b, h, sk, d)).astype(np.float32),
            rng.normal(size=(b, h, sk, d)).astype(np.float32))


# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------


@pytest.mark.parametrize("sq,sk,want,causal,window", [
    (128, 128, 32, True, 0),      # causal
    (128, 128, 64, False, 0),     # non-causal
    (256, 256, 64, True, 64),     # causal sliding window
    (128, 128, 32, False, 48),    # non-causal window
    (100, 100, 64, True, 0),      # _legal_block bends 64 to 50
    (64, 32, 32, True, 8),        # rows past Sk + window - 1 see no key
])
def test_flash_plain_version_matches_pallas_kernel(sq, sk, want, causal,
                                                   window):
    q, k, v = _qkv(2, 3, sq, sk, 32)
    bq = flash_attention._legal_block(sq, want)
    bk = flash_attention._legal_block(sk, want)
    ref = jfa.flash_attention_tpu(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  window=window, bq=bq, bk=bk, interpret=True)
    got = flash_attention.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window, bk=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FLASH_TOL)


def test_legal_block_is_the_reference_rule():
    for seq in (1, 7, 8, 50, 100, 128, 509, 512, 2048):
        for want in (16, 64, 512):
            assert (flash_attention._legal_block(seq, want)
                    == jfa._legal_block(seq, want)), (seq, want)
    with pytest.raises(ValueError, match="pad the sequence"):
        flash_attention._legal_block(4099, 64)  # prime, past one block


def test_flash_wrapper_on_cpu_takes_plain_version_without_counting():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 2, 64, 64, 32, seed=1))
    flash_attention.reset_launches()
    got = flash_attention.flash_attention(q, k, v, causal=True, bq=32, bk=16)
    want = flash_attention.flash_attention_reference(q, k, v, causal=True,
                                                     bk=16)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert flash_attention.launches == 0
    with pytest.raises(ValueError, match="GQA"):
        flash_attention.flash_attention(q, k[:, :1].contiguous(),
                                        v[:, :1].contiguous(), bq=32, bk=32)
    with pytest.raises(TypeError):
        flash_attention.flash_attention(q.double(), k.double(), v.double(),
                                        bq=32, bk=32)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention.flash_attention(q.transpose(2, 3).contiguous()
                                        .transpose(2, 3), k, v, bq=32, bk=32)


def test_route_constants_match_the_cuda_source():
    """The Python route and geometry constants are the CUDA source's: the
    wgmma route's (padded D, keys a stage) map, query rows a CTA, ring
    stages and mbarriers; the sync route's pass widths, rows, keys and
    head-dim chunk."""
    src = (flash_attention._build.CSRC / "flash_attention.cu").read_text()

    def macro(name):
        line = next(ln for ln in src.splitlines()
                    if ln.startswith(f"#define {name}(X)"))
        return [tuple(int(v) for v in m.split(","))
                for m in re.findall(r"X\(([\d, ]+)\)", line)]

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert dict(macro("FLASH_WGMMA_TILES")) == flash_attention.WGMMA_TILES
    assert tuple(w for (w,) in macro("FLASH_SYNC_WIDTHS")) == \
        flash_attention.SYNC_WIDTHS
    assert const("kWgRows") == flash_attention.WGMMA_ROWS
    assert const("kKvStages") == flash_attention.KV_STAGES
    assert const("kQT") == flash_attention.SYNC_ROWS
    assert const("kKT") == flash_attention.SYNC_KEYS
    assert const("kKC") == flash_attention.SYNC_CHUNK
    assert "(1 + 4 * kKvStages) * sizeof(uint64_t)" in src


@pytest.mark.parametrize("d", [16, 20, 80, 240, 256])
@pytest.mark.parametrize("sq,sk,causal,window", [
    (48, 64, True, 0),       # causal, Sq != Sk
    (64, 48, True, 16),      # window; rows past Sk + window - 2 see no key
    (40, 56, False, 24),     # non-causal window, Sq != Sk
])
def test_flash_plain_version_matches_pallas_kernel_at_any_head_dim(
        d, sq, sk, causal, window):
    """The SMOKE configs' D = 16, a D no TMA row takes (20), hubert's 80,
    gemma3's 240 and recurrentgemma's 256."""
    q, k, v = _qkv(1, 2, sq, sk, d, seed=d)
    bq = flash_attention._legal_block(sq, 16)
    bk = flash_attention._legal_block(sk, 16)
    ref = jfa.flash_attention_tpu(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  window=window, bq=bq, bk=bk, interpret=True)
    got = flash_attention.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window, bk=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FLASH_TOL)


def test_flash_route_and_shared_memory_at_every_head_dim():
    """bf16 with D % 8 == 0 and D <= 256 takes the wgmma route, padded to
    the least of 64, 128, 256 that holds D, every CTA within a block's
    shared memory; everything else the sync route, whose every pass width
    fits too; a misaligned base turns the wgmma route to sync."""
    fa = flash_attention
    for d in range(1, 301):
        route = fa.shape_route(2, d)
        assert route == ("wgmma" if d % 8 == 0 and d <= 256 else "sync"), d
        assert fa.shape_route(4, d) == "sync"
        if route == "wgmma":
            dp = fa.padded_dim(d)
            assert dp == min(p for p in fa.WGMMA_TILES if p >= d)
            assert fa.route_tile(route, d) == (128, fa.WGMMA_TILES[dp])
    assert fa.padded_dim(264) is None
    assert fa.route_tile("sync", 80) == (64, 64)
    assert {dp: fa.wgmma_smem_bytes(dp) for dp in fa.WGMMA_TILES} == {
        64: 83016, 128: 164936, 256: 197704}
    assert max(fa.wgmma_smem_bytes(dp) for dp in fa.WGMMA_TILES) \
        <= fa.SMEM_LIMIT == 232_448
    assert max(fa.sync_smem_bytes(w) for w in fa.SYNC_WIDTHS) <= fa.SMEM_LIMIT
    q = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    assert fa.flash_route(q, q, q) == "wgmma"
    assert fa.flash_route(q.float(), q.float(), q.float()) == "sync"
    flat = torch.zeros(2 * 8 * 64 + 1, dtype=torch.bfloat16)
    off = flat[1:].view(1, 2, 8, 64)              # base 2 bytes past 16
    assert fa.flash_route(off, q, q) == fa.flash_route(q, q, off) == "sync"
    assert fa.flash_route(q[..., :20].contiguous(), q[..., :20].contiguous(),
                          q[..., :20].contiguous()) == "sync"


def test_flash_wrapper_refusals():
    """Blocks off the wgmma route's own tile, blocks below 1, a device
    that is neither CUDA nor the CPU, and mixed dtypes are refused; the
    sync route takes any blocks, and on CPU tensors the wrapper returns
    the plain version at the route's tile."""
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in _qkv(1, 2, 40, 40, 80, seed=5))
    assert flash_attention.flash_route(q, k, v) == "wgmma"
    with pytest.raises(ValueError, match="own tile"):
        flash_attention.flash_attention(q, k, v, bq=64, bk=64)
    with pytest.raises(ValueError, match="own tile"):
        flash_attention.flash_attention(q, k, v, bk=64)
    got = flash_attention.flash_attention(q, k, v, bq=128, bk=128)
    torch.testing.assert_close(
        got, flash_attention.flash_attention_reference(q, k, v, bk=128),
        rtol=0, atol=0)
    qf, kf, vf = q.float(), k.float(), v.float()
    for bq, bk in ((-1, 16), (0, None), (None, 0)):
        with pytest.raises(ValueError, match=">= 1"):
            flash_attention.flash_attention(qf, kf, vf, bq=bq, bk=bk)
    torch.testing.assert_close(
        flash_attention.flash_attention(qf, kf, vf, bq=7, bk=9),
        flash_attention.flash_attention_reference(qf, kf, vf, bk=9),
        rtol=0, atol=0)
    with pytest.raises(TypeError, match="one dtype"):
        flash_attention.flash_attention(q, kf, vf)
    meta = torch.empty(1, 2, 40, 80, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        flash_attention.flash_attention(meta, meta, meta)


def test_engine_attention_memo_and_plan_as_in_jax_engine():
    q, k, v = _qkv(1, 2, 64, 64, 32, seed=2)
    q2, k2, v2 = _qkv(1, 2, 32, 32, 32, seed=3)
    jeng = jax_engine.Engine(backend="pallas-interpret")
    teng = Engine(backend="hopper")
    calls = [(q, k, v, True), (q, k, v, True), (q2, k2, v2, True),
             (q, k, v, False), (q2, k2, v2, True)]
    for a, b, c, causal in calls:
        want = jeng.attention(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c),
                              causal=causal)
        got = teng.attention(torch.from_numpy(a), torch.from_numpy(b),
                             torch.from_numpy(c), causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLASH_TOL)
    assert teng.plan.stats == jeng.plan.stats
    # causality keys the memo, not the plan
    assert teng.plan.stats["decisions"] == 2
    assert teng.plan.hits == 3
    ref = Engine(backend="torch-ref").attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    torch.testing.assert_close(
        ref, teng.attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v)), rtol=0, atol=0)


@pytest.mark.parametrize("op", ["attention", "paged_attention"])
def test_hopper_model_attention_decision(op):
    """The flash roofline for both ops; the `attention` op's blocks are
    the tile of the flash route its width and head dim take (query rows a
    CTA, keys a step), the paged op's the 64-row block cut to the
    sequence."""
    req = KernelRequest(op, 512, 128, 512, groups=48, in_bytes=2, out_bytes=2)
    dec = HopperModel().decide(req)
    flash = op == "attention"
    assert (dec.bm, dec.bk, dec.bn) == ((128, 128, 128) if flash
                                        else (64, 128, 64))
    flops = 4.0 * 48 * 512 * 512 * 128
    hbm = 2 * 48 * 128 * (2 * 512 + 2 * 512)
    assert dec.seconds == pytest.approx(max(flops / 989e12, hbm / 3.35e12))
    assert dec.meta_dict.get("route") == ("wgmma" if flash else None)
    small = HopperModel().decide(KernelRequest(op, 1, 128, 40, groups=96))
    assert (small.bm, small.bn) == ((128, 128) if flash else (1, 40))
    if flash:
        for d, in_bytes, tile, route in ((256, 2, (128, 64), "wgmma"),
                                         (16, 2, (128, 128), "wgmma"),
                                         (20, 2, (64, 64), "sync"),
                                         (128, 4, (64, 64), "sync")):
            dec = HopperModel().decide(KernelRequest(
                op, 300, d, 200, groups=4, in_bytes=in_bytes,
                out_bytes=in_bytes))
            assert ((dec.bm, dec.bn), dec.bk, dec.meta_dict["route"]) == \
                (tile, d, route)


def test_flash_blocks_follow_the_operands_route():
    """The hopper backend runs the wgmma route at its own tile, and the
    sync route (f32, or a base TMA cannot take) at the decision's blocks
    bent to divisors as the JAX package bends them; the plain version
    walks the same KV blocks."""
    dec = HopperModel().decide(KernelRequest("attention", 100, 64, 100,
                                             groups=2))
    q = torch.zeros(1, 2, 100, 64, dtype=torch.bfloat16)
    assert backends.flash_blocks(dec, q, q, q) == (128, 128)
    qf = q.float()
    assert backends.flash_blocks(dec, qf, qf, qf) == (
        flash_attention._legal_block(100, 128),) * 2 == (100, 100)
    sync = HopperModel().decide(KernelRequest("attention", 100, 64, 100,
                                              groups=2, in_bytes=4))
    assert backends.flash_blocks(sync, qf, qf, qf) == (50, 50)
    flat = torch.zeros(2 * 100 * 64 + 1, dtype=torch.bfloat16)
    off = flat[1:].view(1, 2, 100, 64)
    assert backends.flash_blocks(dec, off, q, q) == (100, 100)


def test_engine_attention_at_smoke_head_dim():
    """Engine.attention on the hopper and torch-ref backends at the SMOKE
    configs' head dim (16), against the JAX engine in interpret
    mode (the port's CPU path is the plain version at the route's KV
    blocks)."""
    q, k, v = _qkv(1, 2, 64, 64, 16, seed=6)
    want = jax_engine.Engine(backend="pallas-interpret").attention(
        *(jnp.asarray(x) for x in (q, k, v)), causal=True)
    for backend in ("hopper", "torch-ref"):
        got = Engine(backend=backend).attention(
            *(torch.from_numpy(x) for x in (q, k, v)), causal=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **FLASH_TOL)


# --------------------------------------------------------------------------
# paged attention
# --------------------------------------------------------------------------


def _paged_case(page, lens, seed=0, h=12, kv=2, d=16, spare=3):
    """q, pools and a permuted, hole-riddled block table for `lens`."""
    rng = np.random.default_rng(seed)
    b = len(lens)
    n_bt = max(-(-max(lens) // page), 1) + 1        # one hole column at least
    n_pool = b * n_bt + spare
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    kp = rng.normal(size=(n_pool, page, kv, d)).astype(np.float32)
    vp = rng.normal(size=(n_pool, page, kv, d)).astype(np.float32)
    perm = rng.permutation(n_pool)
    bt = np.full((b, n_bt), -1, np.int32)
    ptr = 0
    for i, n in enumerate(lens):
        need = -(-n // page)
        bt[i, :need] = perm[ptr:ptr + need]
        ptr += need
    return q, kp, vp, bt, np.asarray(lens, np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("page", [1, 6, 16])
def test_paged_plain_version_matches_pallas_kernel(page):
    """G = 6 (12 heads over 2 KV heads), a page-edge length, a one-row
    slot, holes past every live span, and a slot with kv_len == 0 that
    both kernels write as exact zeros."""
    lens = [2 * page, 1, 2 * page + 1, 0]
    q, kp, vp, bt, ln = _paged_case(page, lens)
    got = paged_attention.paged_attention_reference(*_t(q, kp, vp, bt, ln))
    ker = paged_attention_tpu(*(jnp.asarray(x) for x in (q, kp, vp, bt, ln)),
                              interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ker), **PAGED_TOL)
    np.testing.assert_array_equal(got.numpy()[3], 0.0)
    np.testing.assert_array_equal(np.asarray(ker)[3], 0.0)
    # live slots: the JAX plain version too (it averages at kv_len == 0)
    ref = jax_paged_reference(*(jnp.asarray(x) for x in (q, kp, vp, bt, ln)))
    np.testing.assert_allclose(got.numpy()[:3], np.asarray(ref)[:3],
                               **PAGED_TOL)


def test_pages_past_kv_len_add_exactly_zero():
    """The CUDA kernel stops after ceil(kv_len / page) pages.  That is
    exact: in the TPU kernel, filling the table past each live span with
    real pages instead of holes leaves every output bit unchanged, and so
    does cutting the table to the longest live span."""
    page = 4
    q, kp, vp, bt, ln = _paged_case(page, [5, 8, 1], seed=3, d=32)
    rng = np.random.default_rng(4)
    full = bt.copy()
    full[full < 0] = rng.integers(0, kp.shape[0], (full < 0).sum())
    args = [jnp.asarray(x) for x in (q, kp, vp)]
    holes = paged_attention_tpu(*args, jnp.asarray(bt), jnp.asarray(ln),
                                interpret=True)
    filled = paged_attention_tpu(*args, jnp.asarray(full), jnp.asarray(ln),
                                 interpret=True)
    np.testing.assert_array_equal(np.asarray(holes), np.asarray(filled))
    cut = bt[:, :2]                      # ceil(max kv_len / page) = 2 pages
    short = paged_attention_tpu(*args, jnp.asarray(cut), jnp.asarray(ln),
                                interpret=True)
    np.testing.assert_array_equal(np.asarray(holes), np.asarray(short))
    got = paged_attention.paged_attention_reference(*_t(q, kp, vp, full, ln))
    np.testing.assert_allclose(got.numpy(), np.asarray(holes), **PAGED_TOL)


def test_paged_wrapper_on_cpu_and_its_checks():
    q, kp, vp, bt, ln = _t(*_paged_case(4, [5, 3]))
    paged_attention.reset_launches()
    got = paged_attention.paged_attention(q, kp, vp, bt, ln)
    torch.testing.assert_close(
        got, paged_attention.paged_attention_reference(q, kp, vp, bt, ln),
        rtol=0, atol=0)
    assert paged_attention.launches == 0
    # int8 pools with their scale pools: the wrapper takes them
    k8, v8 = (torch.from_numpy(np.random.default_rng(i).integers(
        -127, 128, kp.shape).astype(np.int8)) for i in (1, 2))
    ks, vs = (torch.full(kp.shape[:3], x) for x in (0.01, 0.02))
    torch.testing.assert_close(
        paged_attention.paged_attention(q, k8, v8, bt, ln, ks, vs),
        paged_attention.paged_attention_reference(q, k8, v8, bt, ln, ks, vs),
        rtol=0, atol=0)
    assert paged_attention.launches == 0
    with pytest.raises(TypeError, match="int8 pools"):
        paged_attention.paged_attention(q, kp, vp, bt, ln, ks, vs)
    with pytest.raises(TypeError, match="int8 pools"):
        paged_attention.paged_attention(q, k8, v8, bt, ln)
    with pytest.raises(ValueError, match="both"):
        paged_attention.paged_attention(q, k8, v8, bt, ln, k_scale=ks)
    with pytest.raises(ValueError, match="k_scale must be f32"):
        paged_attention.paged_attention(q, k8, v8, bt, ln, ks.double(), vs)
    with pytest.raises(TypeError, match="int32"):
        paged_attention.paged_attention(q, kp, vp, bt.long(), ln)
    with pytest.raises(ValueError, match=r"\(B, 1, H, D\)"):
        paged_attention.paged_attention(q.expand(2, 2, 12, 16).contiguous(),
                                        kp, vp, bt, ln)
    # the kernel's shared memory at the main-path shape fits one block
    assert paged_attention.smem_bytes(6, 128, 16, 2, n_bt=51) <= \
        paged_attention._SMEM_LIMIT


def test_engine_paged_attention_memo_and_plan_as_in_jax_engine():
    q, kp, vp, bt, ln = _paged_case(4, [5, 9], seed=5)
    ln2 = np.asarray([7, 1], np.int32)
    jeng = jax_engine.Engine(backend="xla-einsum")
    teng = Engine(backend="hopper")
    for lens in (ln, ln2, ln):      # kv_len is not in the key
        want = jeng.paged_attention(*(jnp.asarray(x)
                                      for x in (q, kp, vp, bt, lens)))
        got = teng.paged_attention(*_t(q, kp, vp, bt, lens))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **PAGED_TOL)
    assert teng.plan.stats == jeng.plan.stats
    assert (teng.plan.stats["decisions"], teng.plan.hits) == (1, 2)
    (req, dec), = teng.plan
    assert (req.op, req.m, req.k, req.n, req.groups) == (
        "paged_attention", 1, 16, bt.shape[1] * 4, 2 * 12)


# --------------------------------------------------------------------------
# the card's split over pages: the cluster size, the page ranges and the
# combine, on the CPU
# --------------------------------------------------------------------------


@pytest.mark.parametrize("b,kv,n_bt,want", [
    (8, 2, 51, 8),     # qwen2-1.5b's decode tick: 16 pairs -> 128 blocks
    (8, 8, 51, 4),     # granite-moe-1b-a400m's, qwen3-14b's and
                       # gemma3-12b's: 64 pairs -> 256 blocks
    (2, 2, 2, 2),      # SMOKE (2 KV heads) at the launcher's --batch 2,
                       # pages of 8 and 8 + 4 tokens: capped by n_bt
    (4, 2, 13, 8),     # SMOKE at 4 slots, a longer table
    (70, 2, 51, 1),    # more pairs than SMs
])
def test_splits_for_at_the_decode_shapes(b, kv, n_bt, want):
    assert paged_attention.splits_for(b, kv, n_bt) == want


def test_splits_for_bounds():
    for b in (1, 2, 3, 5, 8, 16, 33, 66, 140):
        for kv in (1, 2, 8):
            for n_bt in (0, 1, 2, 3, 7, 51):
                c = paged_attention.splits_for(b, kv, n_bt)
                assert 1 <= c <= paged_attention.MAX_SPLITS
                assert c & (c - 1) == 0                    # a power of two
                assert c <= max(1, n_bt)
                cap = min(paged_attention.MAX_SPLITS, n_bt)
                # the least power of two that fills every SM once, or
                # the largest one under the cap
                assert (c * b * kv >= paged_attention.SMS
                        or 2 * c > cap)
                assert c == 1 or (c // 2) * b * kv < paged_attention.SMS


#: where the kernel states the page-range rule that `_page_range` mirrors
PAGE_RANGE_LINE = 252


def _page_range(n_live, splits, rank):
    """The kernel's page-range rule (csrc/paged_attention.cu:252,
    `page_range`): rank `rank` of `splits` takes the live pages [begin,
    end), at most ceil(n_live / splits) of them."""
    per = -(-n_live // splits)
    begin = min(rank * per, n_live)
    return begin, min(begin + per, n_live)


def test_page_ranges_cover_every_live_page_once_in_order():
    src = (paged_attention._build.CSRC / "paged_attention.cu").read_text()
    assert "void page_range(" in src.splitlines()[PAGE_RANGE_LINE - 1]
    assert f"paged_attention.cu:{PAGE_RANGE_LINE}," in _page_range.__doc__
    for n_live in range(0, 61):
        for splits in range(1, paged_attention.MAX_SPLITS + 1):
            ranges = [_page_range(n_live, splits, r) for r in range(splits)]
            pages = [p for lo, hi in ranges for p in range(lo, hi)]
            assert pages == list(range(n_live))           # once, in order
            assert all(hi - lo <= -(-n_live // splits) for lo, hi in ranges)
            assert all(hi >= lo for lo, hi in ranges)
            # the dead ranks are the last ones
            live = [hi > lo for lo, hi in ranges]
            assert live == sorted(live, reverse=True)


def _split_combine(q, kp, vp, bt, ln, splits, ks=None, vs=None):
    """The kernel's algebra in numpy f32: per (slot, KV head), each rank's
    partial softmax state (m, l, acc) over its page range's rows at
    positions < kv_len (holes clamp into the pool; an int8 pool's k scale
    multiplies the score, its v scale the weight after l), then the
    rank-order combine with the dead guard."""
    b, _, h, d = q.shape
    n_pool, page, kv, _ = kp.shape
    g, n_bt = h // kv, bt.shape[1]
    neg = np.float32(paged_attention.NEG_INF)
    qs = (q / np.float32(math.sqrt(d))).astype(np.float32)
    out = np.zeros_like(q)
    for bi in range(b):
        n_live = min(-(-int(ln[bi]) // page), n_bt) if ln[bi] > 0 else 0
        for kh in range(kv):
            qg = qs[bi, 0, kh * g:(kh + 1) * g]                   # (G, D)
            parts = []
            for rank in range(splits):
                lo, hi = _page_range(n_live, splits, rank)
                rows = [(np.clip(bt[bi, p], 0, n_pool - 1), i)
                        for p in range(lo, hi) for i in range(page)
                        if p * page + i < ln[bi]]
                if not rows:
                    parts.append((np.full(g, neg), np.zeros(g, np.float32),
                                  np.zeros((g, d), np.float32)))
                    continue
                idx = tuple(np.array(x) for x in zip(*rows))
                k = kp[idx + (kh,)].astype(np.float32)            # (n, D)
                v = vp[idx + (kh,)].astype(np.float32)
                s = qg @ k.T                                       # (G, n)
                if ks is not None:
                    s = s * ks[idx + (kh,)][None, :]
                m = s.max(axis=1)
                p = np.exp(s - m[:, None])
                l = p.sum(axis=1)
                if vs is not None:
                    p = p * vs[idx + (kh,)][None, :]
                parts.append((m, l, p @ v))
            big = np.max([m for m, _, _ in parts], axis=0)
            num = np.zeros((g, d), np.float32)
            den = np.zeros(g, np.float32)
            for m, l, acc in parts:                               # rank order
                w = np.where(m == neg, 0.0, np.exp(m - big)).astype(np.float32)
                num += w[:, None] * acc
                den += w * l
            out[bi, 0, kh * g:(kh + 1) * g] = num / np.maximum(den, 1e-30)[:, None]
    return out


def _split_case(kind):
    """Page 4, kv_len 0, 1, a page edge (8) and past it, a slot of 8 live
    pages and one of 5, holes after every live span; int8 pools with
    distinct per-row scales from U(1e-3, 2e-2)."""
    q, kp, vp, bt, ln = _paged_case(4, [0, 1, 8, 9, 30, 17], seed=7)
    if kind == "float":
        return q, kp, vp, bt, ln
    rng = np.random.default_rng(8)
    k8, v8 = (rng.integers(-127, 128, kp.shape).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(1e-3, 2e-2, kp.shape[:3]).astype(np.float32)
              for _ in range(2))
    return q, k8, v8, bt, ln, ks, vs


@functools.cache
def _split_references(kind):
    case = _split_case(kind)
    port = paged_attention.paged_attention_reference(*_t(*case)).numpy()
    jax_kernel = np.asarray(paged_attention_tpu(
        *(jnp.asarray(x) for x in case), interpret=True))
    return port, jax_kernel


@pytest.mark.parametrize("kind", ["float", "int8"])
@pytest.mark.parametrize("splits", range(1, 9))
def test_split_and_combine_matches_the_references(kind, splits):
    case = _split_case(kind)
    got = _split_combine(*case[:5], splits, *case[5:])
    port, jax_kernel = _split_references(kind)
    np.testing.assert_allclose(got, port, **PAGED_TOL)
    np.testing.assert_allclose(got, jax_kernel, **PAGED_TOL)
    np.testing.assert_array_equal(got[0], 0.0)                 # kv_len 0


def test_paged_wrapper_takes_splits_on_cpu():
    q, kp, vp, bt, ln = _t(*_paged_case(4, [5, 3, 0]))
    want = paged_attention.paged_attention_reference(q, kp, vp, bt, ln)
    paged_attention.reset_launches()
    for splits in (1, 2, 8):
        torch.testing.assert_close(
            paged_attention.paged_attention(q, kp, vp, bt, ln, splits=splits),
            want, rtol=0, atol=0)
    assert paged_attention.launches == 0
    for bad in (0, 9, 2.0, True):
        with pytest.raises(ValueError, match="splits"):
            paged_attention.paged_attention(q, kp, vp, bt, ln, splits=bad)


@pytest.mark.parametrize("g,d,itemsize,quantized", [
    (6, 128, 2, False), (6, 128, 4, False), (6, 128, 1, True),   # qwen
    (2, 64, 2, False), (2, 64, 1, True),                          # granite
    (2, 16, 4, False), (2, 16, 1, True),                          # SMOKE
    (12, 256, 4, False), (1, 80, 2, False),                       # others
])
def test_smem_bytes_fits_and_stages_hold_whole_pages(g, d, itemsize,
                                                     quantized):
    for page in (1, 4, 5, 16, 32):
        pages = paged_attention.stage_pages(page, d, itemsize, quantized)
        assert pages >= 1
        row = d * itemsize + (4 if quantized else 0)
        assert pages == 1 or 2 * pages * page * row <= \
            paged_attention.STAGE_BYTES
        for n_bt in (1, 51, 2048 // page):
            assert paged_attention.smem_bytes(
                g, d, page, itemsize, quantized, n_bt=n_bt) <= \
                paged_attention._SMEM_LIMIT


@pytest.mark.parametrize("g,want", [(1, 2), (2, 2), (3, 3), (4, 4), (5, 3),
                                    (6, 3), (8, 4), (12, 4), (16, 4)])
def test_heads_per_group_pads_least(g, want):
    hn = paged_attention.heads_per_group(g)
    assert hn == want
    chunks = -(-g // hn)
    for other in (2, 3, 4):      # no other choice pads less, or as little
        c = -(-g // other)       # in fewer chunks
        assert (c * other - g, c) >= (chunks * hn - g, chunks)



@pytest.mark.parametrize("g,d,page,match", [
    (6, 512, 16, "head dim"),          # a row takes at most a warp of lanes
    (40, 128, 16, "query heads"),      # 10 chunks of 4 heads, 8 warps
    (6, 256, 256, "shared memory"),    # two stages of one f32 page each
])
def test_kernel_geometry_refuses_what_the_kernel_cannot_take(g, d, page,
                                                              match):
    with pytest.raises(ValueError, match=match):
        paged_attention._geometry(g, d, page, 51, 4, False)
    assert paged_attention._geometry(6, 128, 16, 51, 2, False) == 2
