"""The port's RG-LRU block ("rglru", `models/rglru.py`) and
recurrentgemma-2b SMOKE ((rglru, rglru, local) x 1 + a 2-layer tail,
window 16) against the JAX package, in f32 on the CPU.  The weights come
from the JAX `init_params` / `rglru_init` through the bridge; inputs are
made with numpy from a seed.

Tolerances: a module (the gates, the scan, the block, the decode step)
at rtol 1e-5 / atol 1e-5 (f32 both sides; the log-depth scan sums in
another order than `jax.lax.associative_scan`); the model's logits at
rtol 1e-4 / atol 1e-3, as the other model tests hold them; decode
against forward at the JAX package's own 5e-3 of the logits' scale;
greedy tokens identical, Scheduler stats equal; an inactive slot's
state bit for bit.  Under an int8 cache the rings are int8 and the
recurrent conv and h bf16, as in the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import rglru as JR
from repro.models import transformer as JT
from repro.models.config import ArchConfig as JaxArchConfig
from repro.quant import quantize_params as jax_quantize_params
from repro.serve_lib import serve as jax_serve
from repro.serve_lib.scheduler import Request as JaxRequest
from repro.serve_lib.scheduler import Scheduler as JaxScheduler
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import rglru
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig
from repro_torch.serve_lib import serve
from repro_torch.serve_lib.scheduler import Request, Scheduler

MOD_TOL = {"rtol": 1e-5, "atol": 1e-5}
TOL = {"rtol": 1e-4, "atol": 1e-3}
#: under an int8 cache the recurrent state is stored bf16: an element
#: whose f32 value (summed in another order) rounds the other way moves
#: the next steps' logits by up to 2e-3 and the stored state by an ulp
BF16_STATE_TOL = {"rtol": 1e-2, "atol": 5e-3}
DECODE_REL = 5e-3
RGEMMA = "recurrentgemma-2b"


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=MOD_TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(path): leaf for path, leaf in flat}


def _np(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.float().numpy()
    return np.asarray(jnp.asarray(leaf).astype(jnp.float32))


# --------------------------------------------------------------------------
# The module's functions
# --------------------------------------------------------------------------

RG_KW = dict(name="t", kind="decoder", n_layers=1, d_model=24, n_heads=2,
             n_kv=1, d_ff=48, vocab=100, layer_pattern=("rglru",),
             rglru_width=24, head_dim=12)


@pytest.fixture(scope="module")
def block():
    """A 24-wide RG-LRU block (the JAX `rglru_init`), nonzero conv bias."""
    jcfg, cfg = JaxArchConfig(**RG_KW), ArchConfig(**RG_KW)
    jp = JR.rglru_init(jax.random.PRNGKey(1), jcfg)
    jp["conv_b"] = jnp.asarray(0.3 * np.random.default_rng(0).standard_normal(
        24), jnp.float32)
    return jcfg, jp, cfg, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            device="cpu")


def test_gates_match_reference(block):
    _, jp, _, p = block
    u = np.random.default_rng(2).standard_normal((2, 9, 24)).astype(np.float32)
    for g, w in zip(rglru._gates(p, _t(u)), JR._gates(jp, jnp.asarray(u)),
                    strict=True):
        assert g.dtype == torch.float32
        _close(g, w)


@pytest.mark.parametrize("length", [16, 21, 1])
@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_reference(block, length, with_valid, with_h0):
    """A power-of-two length, another and one step; ragged `valid` rows
    (pad rows the identity) and a starting state: h in u's dtype and
    h_last in f32."""
    _, jp, _, p = block
    rng = np.random.default_rng(length)
    u = rng.standard_normal((3, length, 24)).astype(np.float32)
    valid = (np.arange(length)[None, :]
             < np.asarray([length, max(length - 5, 1), 1])[:, None])
    h0 = rng.standard_normal((3, 24)).astype(np.float32)
    kw_j = {"valid": jnp.asarray(valid) if with_valid else None,
            "h0": jnp.asarray(h0) if with_h0 else None}
    kw = {"valid": _t(valid) if with_valid else None,
          "h0": _t(h0) if with_h0 else None}
    want = JR.rglru_scan(jp, jnp.asarray(u), **kw_j)
    got = rglru.rglru_scan(p, _t(u), **kw)
    assert got[1].dtype == torch.float32
    for g, w in zip(got, want, strict=True):
        _close(g, w)
    ub = torch.from_numpy(u).bfloat16()
    assert rglru.rglru_scan(p, ub)[0].dtype == torch.bfloat16


def test_rglru_scan_is_log_depth(block, monkeypatch):
    """The scan takes ceil(log2 S) doubling steps, not S sequential ones:
    at S = 1000 it concatenates 10 times for h (and 9 for a)."""
    _, _, _, p = block
    calls = []
    cat = torch.cat
    monkeypatch.setattr(torch, "cat", lambda *a, **k: calls.append(1)
                        or cat(*a, **k))
    u = torch.randn(1, 1000, 24, generator=torch.Generator().manual_seed(0))
    rglru.rglru_scan(p, u)
    assert len(calls) == 10 + 9


def test_rglru_block_matches_reference(block):
    jcfg, jp, cfg, p = block
    x = np.random.default_rng(3).standard_normal((2, 13, 24)).astype(
        np.float32)
    _close(rglru.rglru_block(p, cfg, _t(x)),
           JR.rglru_block(jp, jcfg, jnp.asarray(x)))


def test_rglru_decode_step_matches_reference(block):
    """Five steps from a nonzero state: outputs and both states."""
    jcfg, jp, cfg, p = block
    rng = np.random.default_rng(4)
    conv = rng.standard_normal((2, 3, 24)).astype(np.float32)
    h = rng.standard_normal((2, 24)).astype(np.float32)
    jc, jh, c, hh = jnp.asarray(conv), jnp.asarray(h), _t(conv), _t(h)
    for _ in range(5):
        x = rng.standard_normal((2, 1, 24)).astype(np.float32)
        want, jc, jh = JR.rglru_decode_step(jp, jcfg, jnp.asarray(x), jc, jh)
        got, c, hh = rglru.rglru_decode_step(p, cfg, _t(x), c, hh)
        for g, w in ((got, want), (c, jc), (hh, jh)):
            _close(g, w)


# --------------------------------------------------------------------------
# recurrentgemma-2b SMOKE
# --------------------------------------------------------------------------

_WEIGHTS = {}


def _weights(quantize: bool = False):
    if quantize not in _WEIGHTS:
        jcfg = jax_get_config(RGEMMA, smoke=True)
        jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
        if quantize:
            jparams = jax_quantize_params(jparams)
        _WEIGHTS[quantize] = (jcfg, jparams, get_config(RGEMMA, smoke=True),
                              params_from_numpy(jax.tree.map(np.asarray,
                                                             jparams),
                                                device="cpu"))
    return _WEIGHTS[quantize]


#: postures: float weights and cache; an int8 cache alone; --quantize
#: (int8 weights and an int8 cache)
POSTURES = {"f32": (False, "float32"), "int8-cache": (False, "int8"),
            "quantize": (True, "int8")}


def _serve_kw(posture, jax_side: bool):
    quant, cache = POSTURES[posture]
    if jax_side:
        return dict(compute_dtype=jnp.float32, quantize=quant,
                    cache_dtype=getattr(jnp, cache),
                    kernel_backend="xla-einsum")
    return dict(compute_dtype="float32", quantize=quant, cache_dtype=cache,
                kernel_backend="hopper", device="cpu")


def test_forward_matches_reference():
    """40 tokens: past the 16-row window of the local block."""
    jcfg, jparams, cfg, params = _weights()
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 40)).astype(
        np.int32)
    want, _ = JT.forward(jparams, jcfg, jnp.asarray(toks),
                         compute_dtype=jnp.float32)
    got, _ = T.forward(params, cfg, _t(toks), compute_dtype=torch.float32)
    _close(got, want, TOL)


def test_prefill_then_decode_matches_forward():
    _, _, cfg, params = _weights()
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 24)).astype(np.int32))
    full, _ = T.forward(params, cfg, toks, compute_dtype=torch.float32)
    cache = T.init_cache(cfg, T.CacheSpec(24, 2), dtype=torch.float32)
    lg, cache = T.prefill(params, cfg, toks[:, :12], cache,
                          compute_dtype=torch.float32)
    outs = [lg]
    for t in range(12, 24):
        lg, cache = T.decode_step(params, cfg, cache, toks[:, t:t + 1],
                                  compute_dtype=torch.float32)
        outs.append(lg)
    scale = float(full.abs().max())
    err = float((torch.cat(outs, 1) - full[:, 11:]).abs().max()) / scale
    assert err < DECODE_REL, err


def test_init_params_matches_reference_tree():
    """The port's `init_params` has the JAX tree's paths and shapes (`rec`
    beside `mlp` in the rglru blocks, the tail), its fixed leaves (lam,
    conv_b, the norms) the JAX values; the bridge carries every leaf
    across, as is and cast to bf16."""
    _, jparams, cfg, params = _weights()
    want = _leaves(jparams)
    mine = _leaves(T.init_params(cfg, generator=torch.Generator().manual_seed(
        0)))
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        k: v.shape for k, v in want.items()}
    for path in ("['stack']['b0']['rec']['lam']", "['tail'][1]['rec']['lam']",
                 "['stack']['b1']['rec']['conv_b']", "['tail'][0]['norm2']"):
        # log / expm1 of another library: a few f32 ulps apart
        np.testing.assert_allclose(_np(mine[path]), _np(want[path]),
                                   rtol=1e-5)
    got = _leaves(params)
    bf16 = _leaves(params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     device="cpu", dtype=torch.bfloat16))
    for path, leaf in want.items():
        np.testing.assert_array_equal(_np(got[path]), _np(leaf))
        np.testing.assert_array_equal(_np(bf16[path]),
                                      _np(leaf.astype(jnp.bfloat16)))


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_init_cache_layout_matches_reference(layout, dtype):
    """Rings of min(window, max_seq) rows (int8 with f32 scales under
    int8) and the recurrent conv and h in the cache dtype, bf16 under
    int8; nothing paged on either layout."""
    jcfg, cfg = jax_get_config(RGEMMA, True), get_config(RGEMMA, True)
    spec = dict(page_size=8, n_pages=12) if layout == "paged" else {}
    for max_seq in (10, 40):
        want = _leaves(JT.init_cache(jcfg, JT.CacheSpec(max_seq, 3, **spec),
                                     dtype=getattr(jnp, dtype)))
        got = _leaves(T.init_cache(cfg, T.CacheSpec(max_seq, 3, **spec),
                                   dtype=getattr(torch, dtype)))
        assert {k: (v.shape, str(v.dtype)) for k, v in want.items()} == {
            k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in got.items()}
    if dtype == "int8":
        assert got["['tail'][0]['h']"].dtype == torch.bfloat16
        assert got["['slots']['b2']['k']"].dtype == torch.int8


@pytest.mark.parametrize("posture", list(POSTURES))
def test_generate_tokens_identical_to_reference(posture):
    """Two 40-token prompts and 8 new tokens: the ring rolls at prefill
    and wraps in decode, the recurrent state carries 47 steps."""
    jcfg, jparams, cfg, params = _weights(POSTURES[posture][0])
    prompt = np.random.default_rng(4).integers(0, cfg.vocab, (2, 40)).astype(
        np.int32)
    want = jax_serve.generate(jparams, jcfg, jax_serve.ServeConfig(
        max_seq=49, batch=2, **_serve_kw(posture, True)), jnp.asarray(prompt),
        8)
    got = serve.generate(params, cfg, serve.ServeConfig(
        max_seq=49, batch=2, **_serve_kw(posture, False)), _t(prompt), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("posture", list(POSTURES))
def test_scheduler_tokens_and_stats_identical_to_reference(posture, layout):
    """Seven requests of 3-39 tokens over 2 slots, a padding prefill
    bucket of 8: a paged ServeConfig builds no paged plane (no "attn"
    layer) and runs the contiguous path, as in the JAX package."""
    jcfg, jparams, cfg, params = _weights(POSTURES[posture][0])
    rng = np.random.default_rng(0)
    spec = [(uid, rng.integers(0, cfg.vocab, int(rng.integers(3, 40))).astype(
        np.int32), int(rng.integers(2, 8))) for uid in range(7)]
    kw = dict(max_seq=56, batch=2, cache_layout=layout, page_size=8)
    ref = JaxScheduler(jparams, jcfg, jax_serve.ServeConfig(
        **kw, **_serve_kw(posture, True)), prefill_bucket=8)
    ref.run([JaxRequest(uid=u, prompt=p.copy(), max_new_tokens=g)
             for u, p, g in spec], max_steps=300)
    sched = Scheduler(params, cfg, serve.ServeConfig(
        **kw, **_serve_kw(posture, False)), prefill_bucket=8)
    sched.run([Request(uid=u, prompt=p.copy(), max_new_tokens=g)
               for u, p, g in spec], max_steps=300)
    assert sched.paged is None and ref.paged is None
    assert sorted(sched.completions) == sorted(ref.completions)
    for uid, c in ref.completions.items():
        np.testing.assert_array_equal(sched.completions[uid].tokens, c.tokens,
                                      err_msg=f"uid={uid}")
    assert sched.stats == ref.stats


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_ragged_prefill_and_masked_decode_match_reference(dtype):
    """Two admits into a live cache (prompts of 30, 3 and 16 tokens, then
    one of 25 into a masked slot) and 10 decode ticks with slot 1
    inactive, so the 16-row rings wrap: the live rows' logits and every
    cache leaf equal the JAX package's (under int8 at BF16_STATE_TOL), and
    the inactive slot's rings, conv and h stay bit for bit."""
    jcfg, jparams, cfg, params = _weights()
    tol = TOL if dtype == "float32" else BF16_STATE_TOL
    rng = np.random.default_rng(9)
    b = 3
    jcache = JT.init_cache(jcfg, JT.CacheSpec(48, b), dtype=getattr(jnp, dtype))
    cache = T.init_cache(cfg, T.CacheSpec(48, b), dtype=getattr(torch, dtype))
    for width, lengths, mask in ((30, [30, 3, 16], [True, True, False]),
                                 (25, [1, 1, 25], [False, False, True])):
        toks = rng.integers(0, cfg.vocab, (b, width)).astype(np.int32)
        kw = {"lengths": np.asarray(lengths, np.int32),
              "update_mask": np.asarray(mask)}
        want, jcache = JT.prefill(jparams, jcfg, jnp.asarray(toks), jcache,
                                  compute_dtype=jnp.float32,
                                  **{k: jnp.asarray(v) for k, v in kw.items()})
        got, cache = T.prefill(params, cfg, _t(toks), cache,
                               compute_dtype=torch.float32,
                               **{k: _t(v) for k, v in kw.items()})
        rows = np.flatnonzero(mask)
        _close(got[rows], np.asarray(want)[rows], TOL)
    blocks = [*cache["slots"].values(), *cache["tail"]]
    frozen = {(i, name): _slot(c[name], i, 1).clone()
              for i, c in enumerate(blocks) for name in c}
    active = np.asarray([True, False, True])
    for _ in range(10):
        tok = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
        want, jcache = JT.decode_step(jparams, jcfg, jcache, jnp.asarray(tok),
                                      compute_dtype=jnp.float32,
                                      active=jnp.asarray(active))
        got, cache = T.decode_step(params, cfg, cache, _t(tok),
                                   compute_dtype=torch.float32,
                                   active=_t(active))
        _close(got[active], np.asarray(want)[active], tol)
    assert cache["t"].tolist() == [40, 3, 35]
    for (i, name), before in frozen.items():
        assert torch.equal(_slot(blocks[i][name], i, 1), before), (i, name)
    want, got = _leaves(jcache), _leaves(cache)
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        np.testing.assert_allclose(_np(got[path]), _np(leaf), **tol)


def _slot(leaf, block_index, slot):
    """Slot `slot` of a cache leaf: a stacked block's leaves have the
    period axis first (the SMOKE config has one period: blocks 0-2),
    tail blocks (3 on) none."""
    return leaf[:, slot] if block_index < 3 else leaf[slot]


def test_cli_serves_recurrentgemma_on_cpu_smoke():
    """Static and trace mode through the launcher, --quantize and paged."""
    base = ["--arch", RGEMMA, "--smoke", "--device", "cpu",
            "--kernel-backend", "hopper", "--batch", "2"]
    out = launch_serve.main(base + ["--quantize", "--prompt-len", "24",
                                    "--gen", "4"])
    assert out["shape"] == (2, 4) and out["engine_plan"]["hits"] > 0
    out = launch_serve.main(base + ["--cache-layout", "paged", "--page-size",
                                    "8", "--trace", "24x8,8x4*3"])
    assert out["requests"] == 4 and out["tokens"] == 8 + 3 * 4
    assert out["scheduler"].paged is None
