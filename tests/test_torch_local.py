"""The port's sliding-window ("local") block kind against the JAX package,
in f32 on the CPU: `layers.local_attention`, the ring placement
`transformer._ring_place`, the kind-aware cache shapes, the qk-norm
projection, and gemma3-12b SMOKE's ragged prefill and masked decode
through rings that wrap, on both layouts.  The weights come from the JAX
`init_params` through the bridge; inputs are made with numpy from a
seed.

Tolerances: the attention functions at atol 1e-5 (f32 both sides; only
the order of sums differs); ring placement and cache shapes exactly; the
model at rtol 1e-4 / atol 1e-3, as tests/test_torch_serve.py holds the
port's logits to the JAX ones.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import layers
from repro_torch.models import transformer as T

ATTN_TOL = {"rtol": 0, "atol": 1e-5}
TOL = {"rtol": 1e-4, "atol": 1e-3}
GEMMA3 = "gemma3-12b"


def _t(x):
    return torch.from_numpy(np.array(x))


# --------------------------------------------------------------------------
# local_attention
# --------------------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 15, 16, 17, 40])
def test_local_attention_matches_reference(s):
    """Window 16, 4 query heads over 2 KV heads (GQA), S below, at, one
    past and 2.5 windows: the chunk padding, the empty first previous
    chunk and the window edge."""
    rng = np.random.default_rng(s)
    q = rng.standard_normal((2, s, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    want = JL.local_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              16)
    got = layers.local_attention(_t(q), _t(k), _t(v), 16)
    assert got.shape == (2, s, 4, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


def test_attention_block_takes_the_window_as_the_reference():
    """gemma3 SMOKE's attention block over 40 tokens: a causal window
    runs the exact sliding window (not the flash scan), as the JAX
    `attention_block` dispatches it; window 0 runs the flash scan."""
    jcfg, cfg = jax_get_config(GEMMA3, True), get_config(GEMMA3, True)
    jp = JL.attn_init(jax.random.PRNGKey(3), jcfg)
    p = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(0).standard_normal((2, 40, cfg.d_model)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
    for window in (16, 0):
        want = JL.attention_block(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                                  window=window)
        got = layers.attention_block(p, cfg, _t(x), _t(pos).int(),
                                     window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


def test_qk_norm_projection_matches_reference():
    """qwen3-14b SMOKE's `attn_qkv` with qk-norm on (nonzero norm scales,
    so the norm shows): q, k and v equal the JAX function's."""
    jcfg, cfg = (jax_get_config("qwen3-14b", True),
                 get_config("qwen3-14b", True))
    assert cfg.qk_norm
    jp = JL.attn_init(jax.random.PRNGKey(1), jcfg)
    rng = np.random.default_rng(2)
    jp["q_norm"] = jnp.asarray(rng.standard_normal(16).astype(np.float32))
    jp["k_norm"] = jnp.asarray(rng.standard_normal(16).astype(np.float32))
    p = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    pos = (np.arange(7, dtype=np.int32)[None] + np.asarray([[0], [5]])).astype(
        np.int32)
    want = JL.attn_qkv(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got = layers.attn_qkv(p, cfg, _t(x), _t(pos))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **ATTN_TOL)
    plain = layers.attn_qkv(p, dataclasses.replace(cfg, qk_norm=False),
                            _t(x), _t(pos))
    assert not torch.allclose(plain[0], got[0])  # the norm did something


# --------------------------------------------------------------------------
# Ring placement and the kind-aware caches
# --------------------------------------------------------------------------


@pytest.mark.parametrize("trailing", [(2, 16), (2,)], ids=["rows", "scales"])
def test_ring_place_matches_reference(trailing):
    """Slots shorter than, equal to, one past and far past an 8-row ring,
    in a 21-wide batch: the rows (KV, D) and the int8 codec's scales
    (KV,) land where the JAX `_ring_place` puts them, exactly."""
    rng = np.random.default_rng(4)
    k = rng.standard_normal((5, 21, *trailing)).astype(np.float32)
    lengths = np.asarray([3, 8, 9, 21, 1], np.int32)
    want = JT._ring_place(jnp.asarray(k), jnp.asarray(lengths), 8)
    got = T._ring_place(_t(k), _t(lengths), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(path): leaf for path, leaf in flat}


@pytest.mark.parametrize("arch", [GEMMA3, "mixtral-8x7b"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("max_seq", [40, 10], ids=["wide", "short"])
def test_init_cache_shapes_match_reference(arch, layout, dtype, max_seq):
    """Every cache leaf's path, shape and dtype equal the JAX
    `init_cache`'s: only "attn" blocks are paged, a "local" block keeps a
    ring of min(window, max_seq) rows on either layout, and an int8 cache
    quantizes the rows of both kinds with their f32 scales."""
    jcfg, cfg = jax_get_config(arch, True), get_config(arch, True)
    spec = dict(page_size=8, n_pages=12) if layout == "paged" else {}
    want = JT.init_cache(jcfg, JT.CacheSpec(max_seq, 3, **spec),
                         dtype=getattr(jnp, dtype))
    got = T.init_cache(cfg, T.CacheSpec(max_seq, 3, **spec),
                       dtype=getattr(torch, dtype))
    want, got = _leaves(want), _leaves(got)
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        assert tuple(got[path].shape) == leaf.shape, path
        assert str(got[path].dtype).removeprefix("torch.") == str(leaf.dtype)
    rings = [p for p in got if p.endswith("['k']")]
    assert rings and all(got[p].shape[-3] == min(16, max_seq) for p in rings
                         if "b5" not in p)


# --------------------------------------------------------------------------
# gemma3 SMOKE: ragged ring prefill and masked decode
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gemma3():
    jcfg = jax_get_config(GEMMA3, smoke=True)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jcfg, jparams, get_config(GEMMA3, smoke=True), params


def _cache_leaves(cache):
    return [np.asarray(leaf) for _, leaf in sorted(_leaves(cache).items())]


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_ragged_ring_prefill_and_masked_decode_match_reference(gemma3,
                                                               layout):
    """Two admits into a live cache (prompts of 30, 9 and 16 tokens, then
    one of 25 into a masked slot) and 12 decode ticks with an inactive
    slot, so the 16-row rings of the local blocks wrap in prefill and in
    decode: the live rows' logits, every cache leaf (rings, pages,
    clocks) equal the JAX package's.  The paged layout pages block b5
    alone and passes a zero history, as both schedulers do."""
    jcfg, jparams, cfg, params = gemma3
    rng = np.random.default_rng(12)
    b, page = 3, 4
    paged = layout == "paged"
    spec = dict(page_size=page, n_pages=40) if paged else {}
    jcache = JT.init_cache(jcfg, JT.CacheSpec(48, b, **spec),
                           dtype=jnp.float32)
    cache = T.init_cache(cfg, T.CacheSpec(48, b, **spec), dtype=torch.float32)
    bt = np.full((b, 12), -1, np.int32)
    bt[0, :11] = np.arange(11)
    bt[1, :8] = np.arange(11, 19)
    bt[2, :10] = np.arange(19, 29)
    steps = [  # (tokens width, lengths, update_mask)
        (30, [30, 9, 16], [True, True, False]),
        (25, [1, 1, 25], [False, False, True]),
    ]
    for width, lengths, mask in steps:
        toks = rng.integers(0, cfg.vocab, (b, width)).astype(np.int32)
        kw = {"lengths": np.asarray(lengths, np.int32),
              "update_mask": np.asarray(mask)}
        if paged:
            kw.update(block_tables=bt, hist_len=np.zeros(b, np.int32))
        want, jcache = JT.prefill(jparams, jcfg, jnp.asarray(toks), jcache,
                                  compute_dtype=jnp.float32,
                                  **{k: jnp.asarray(v) for k, v in kw.items()})
        got, cache = T.prefill(params, cfg, _t(toks), cache,
                               compute_dtype=torch.float32,
                               **{k: _t(v) for k, v in kw.items()})
        rows = np.flatnonzero(mask)
        np.testing.assert_allclose(got.numpy()[rows], np.asarray(want)[rows],
                                   **TOL)
    active = np.asarray([True, False, True])
    for _ in range(12):
        tok = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
        kw = {"active": active}
        if paged:
            kw["block_tables"] = bt
        want, jcache = JT.decode_step(jparams, jcfg, jcache, jnp.asarray(tok),
                                      compute_dtype=jnp.float32,
                                      **{k: jnp.asarray(v)
                                         for k, v in kw.items()})
        got, cache = T.decode_step(params, cfg, cache, _t(tok),
                                   compute_dtype=torch.float32,
                                   **{k: _t(v) for k, v in kw.items()})
        np.testing.assert_allclose(got.numpy()[active],
                                   np.asarray(want)[active], **TOL)
    assert cache["t"].tolist() == [42, 9, 37]
    for mine, ref in zip(_cache_leaves(cache), _cache_leaves(jcache),
                         strict=True):
        assert mine.shape == ref.shape
        np.testing.assert_allclose(mine, ref, **TOL)


def test_history_on_a_ring_block_is_refused(gemma3):
    """A history on a paged mixed-pattern cache (once refused, now
    ported): the paged "attn" blocks gather their history pages while the
    local blocks' rings continue write-then-attend, in one call.  8 rows
    prefilled into slot 0, then 10 more into slot 0 (its 16-row ring
    wraps) beside a fresh slot 1: logits and every cache leaf equal the
    JAX package's."""
    jcfg, jparams, cfg, params = gemma3
    spec = T.CacheSpec(48, 2, page_size=4, n_pages=30)
    jcache = JT.init_cache(jcfg, JT.CacheSpec(48, 2, page_size=4,
                                              n_pages=30), dtype=jnp.float32)
    cache = T.init_cache(cfg, spec, dtype=torch.float32)
    bt = np.arange(24, dtype=np.int32).reshape(2, 12)
    rng = np.random.default_rng(9)
    for hist, lengths, pages in (([0, 0], [8, 5], 0), ([8, 0], [10, 7], 2)):
        toks = rng.integers(0, cfg.vocab, (2, 10)).astype(np.int32)
        kw = {"lengths": np.asarray(lengths, np.int32), "block_tables": bt,
              "hist_len": np.asarray(hist, np.int32)}
        want, jcache = JT.prefill(jparams, jcfg, jnp.asarray(toks), jcache,
                                  compute_dtype=jnp.float32, hist_pages=pages,
                                  **{k: jnp.asarray(v) for k, v in kw.items()})
        got, cache = T.prefill(params, cfg, _t(toks), cache,
                               compute_dtype=torch.float32, hist_pages=pages,
                               **{k: _t(v) for k, v in kw.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert cache["t"].tolist() == [18, 7]
    for mine, ref in zip(_cache_leaves(cache), _cache_leaves(jcache),
                         strict=True):
        np.testing.assert_allclose(mine, ref, rtol=1e-5, atol=1e-5)
