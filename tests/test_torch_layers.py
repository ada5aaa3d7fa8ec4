"""The port's layers against the JAX reference, f32 on the CPU.

The same numpy inputs (numpy.random.default_rng) go to both sides.
Tolerance rtol 1e-5, atol 1e-5 unless a test says otherwise: both sides
compute in f32 and differ only in the order of their sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as jl
from repro_torch.configs import get_config
from repro_torch.models import layers as tl

TOL = {"rtol": 1e-5, "atol": 1e-5}


def _pair(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


@pytest.mark.parametrize("cast_early", [True, False])
def test_rms_norm(cast_early):
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng, 3, 5, 48)
    js, ts = _pair(rng, 48)
    _close(tl.rms_norm(ts, tx, 1e-6, cast_early=cast_early),
           jl.rms_norm(js, jx, 1e-6, cast_early=cast_early))


def test_rotary_interleaved_pairs():
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng, 2, 9, 3, 16)
    pos = rng.integers(0, 600, size=(2, 9)).astype(np.int32)
    _close(tl.rotary(tx, torch.from_numpy(pos), 1e6),
           jl.rotary(jx, jnp.asarray(pos), 1e6), rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("causal,chunk,kv_len", [
    (True, 512, (19, 19)),     # one chunk
    (True, 8, (19, 19)),       # chunk smaller than S, ragged last chunk
    (True, 8, (19, 11)),       # ragged kv_len
    (False, 6, (19, 7)),       # bidirectional
])
def test_flash_attention_forward(causal, chunk, kv_len):
    rng = np.random.default_rng(2)
    jq, tq = _pair(rng, 2, 19, 4, 16)
    jk, tk = _pair(rng, 2, 19, 2, 16)
    jv, tv = _pair(rng, 2, 19, 2, 16)
    pos = np.broadcast_to(np.arange(19, dtype=np.int32), (2, 19))
    kvl = np.asarray(kv_len, np.int32)
    want = jl.flash_attention(jq, jk, jv, jnp.asarray(pos), jnp.asarray(kvl),
                              causal, 0, chunk)
    got = tl.flash_attention(tq, tk, tv, torch.from_numpy(pos.copy()),
                             torch.from_numpy(kvl), causal, 0, chunk)
    _close(got, want)


def _dense_params(rng, d_in, d_out, bias):
    jw, tw = _pair(rng, d_in, d_out)
    jp, tp = {"w": jw}, {"w": tw}
    if bias:
        jb, tb = _pair(rng, d_out)
        jp["b"], tp["b"] = jb, tb
    return jp, tp


def test_dense_with_bias():
    rng = np.random.default_rng(3)
    jp, tp = _dense_params(rng, 24, 40, True)
    jx, tx = _pair(rng, 2, 5, 24)
    _close(tl.dense(tp, tx), jl.dense(jp, jx), rtol=1e-5, atol=1e-4)


def test_mlp_swiglu():
    rng = np.random.default_rng(4)
    params = [_dense_params(rng, a, b, False)
              for a, b in ((32, 64), (32, 64), (64, 32))]
    jp = {n: p[0] for n, p in zip(("wi", "wg", "wo"), params)}
    tp = {n: p[1] for n, p in zip(("wi", "wg", "wo"), params)}
    jx, tx = _pair(rng, 2, 5, 32)
    _close(tl.mlp(tp, tx), jl.mlp(jp, jx), rtol=1e-5, atol=1e-4)


def _attn_params(rng, cfg):
    hd, nh, nkv, d = cfg.head_dim_, cfg.n_heads, cfg.n_kv, cfg.d_model
    shapes = {"wq": (d, nh * hd), "wk": (d, nkv * hd), "wv": (d, nkv * hd),
              "wo": (nh * hd, d)}
    pairs = {n: _dense_params(rng, *s, n != "wo") for n, s in shapes.items()}
    return ({n: p[0] for n, p in pairs.items()},
            {n: p[1] for n, p in pairs.items()})


def test_attn_qkv_matches():
    cfg, jcfg = get_config("qwen2-1.5b", True), jax_get_config("qwen2-1.5b", True)
    rng = np.random.default_rng(5)
    jp, tp = _attn_params(rng, cfg)
    jx, tx = _pair(rng, 2, 7, cfg.d_model)
    pos = np.broadcast_to(np.arange(3, 10, dtype=np.int32), (2, 7))
    want = jl.attn_qkv(jp, jcfg, jx, jnp.asarray(pos))
    got = tl.attn_qkv(tp, cfg, tx, torch.from_numpy(pos.copy()))
    for g, w in zip(got, want, strict=True):
        _close(g, w, rtol=1e-5, atol=1e-4)


def test_cached_attention_matches():
    cfg, jcfg = get_config("qwen2-1.5b", True), jax_get_config("qwen2-1.5b", True)
    rng = np.random.default_rng(6)
    jp, tp = _attn_params(rng, cfg)
    hd = cfg.head_dim_
    jq, tq = _pair(rng, 2, 1, cfg.n_heads, hd)
    jk, tk = _pair(rng, 2, 13, cfg.n_kv, hd)
    jv, tv = _pair(rng, 2, 13, cfg.n_kv, hd)
    pos = np.asarray([[4], [12]], np.int32)
    kvl = np.asarray([5, 13], np.int32)
    want = jl.cached_attention(jp, jcfg, jq, jk, jv, jnp.asarray(pos),
                               jnp.asarray(kvl))
    got = tl.cached_attention(tp, cfg, tq, tk, tv, torch.from_numpy(pos),
                              torch.from_numpy(kvl))
    _close(got, want, rtol=1e-5, atol=1e-4)


def test_slot_update_writes_each_slots_row():
    rng = np.random.default_rng(7)
    cache = rng.normal(size=(3, 6, 2)).astype(np.float32)
    new = rng.normal(size=(3, 2)).astype(np.float32)
    idx = np.asarray([0, 5, 2], np.int32)
    want = jl.slot_update(jnp.asarray(cache), jnp.asarray(idx), jnp.asarray(new))
    got = tl.slot_update(torch.from_numpy(cache.copy()), torch.from_numpy(idx),
                         torch.from_numpy(new))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
