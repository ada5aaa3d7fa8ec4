"""The port's Mamba-2 SSD block ("ssm", `models/ssm.py`) and mamba2-780m
SMOKE against the JAX package, in f32 on the CPU.  The weights come from
the JAX `init_params` / `ssm_init` through the bridge; inputs are made
with numpy from a seed.

Tolerances: a module (the conv, the SSD scan, the block, the decode
step) at rtol 1e-5 / atol 1e-5 (f32 both sides; only the order of sums
differs), the ragged conv state exactly (a gather); the model's logits
at rtol 1e-4 / atol 1e-3, as the other model tests hold them; decode
against forward at the JAX package's own 5e-3 of the logits' scale
(`tests/test_serve.py::test_prefill_then_decode_matches_forward`);
greedy tokens identical, Scheduler stats equal; an inactive slot's
state bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.models.config import ArchConfig as JaxArchConfig
from repro.models.config import SSMConfig as JaxSSMConfig
from repro.serve_lib import serve as jax_serve
from repro.serve_lib.scheduler import Request as JaxRequest
from repro.serve_lib.scheduler import Scheduler as JaxScheduler
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig, SSMConfig
from repro_torch.serve_lib import serve
from repro_torch.serve_lib.scheduler import Request, Scheduler

MOD_TOL = {"rtol": 1e-5, "atol": 1e-5}
TOL = {"rtol": 1e-4, "atol": 1e-3}
DECODE_REL = 5e-3
MAMBA = "mamba2-780m"


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=MOD_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _leaves(tree):
    """{path: leaf} of a JAX or a port tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(path): leaf for path, leaf in flat}


def _np(leaf):
    """A leaf as f32 numpy (bf16 included)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.float().numpy()
    return np.asarray(jnp.asarray(leaf).astype(jnp.float32))


# --------------------------------------------------------------------------
# The module's functions
# --------------------------------------------------------------------------


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("act", [True, False])
def test_causal_conv_matches_reference(with_state, act):
    rng = np.random.default_rng(1)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    x = rng.standard_normal((3, 7, 12)).astype(np.float32)
    st = rng.standard_normal((3, 3, 12)).astype(np.float32)
    want = JS._causal_conv(jnp.asarray(w), jnp.asarray(b), jnp.asarray(x),
                           jnp.asarray(st) if with_state else None, act=act)
    got = ssm._causal_conv(_t(w), _t(b), _t(x),
                           _t(st) if with_state else None, act=act)
    for g, wv in zip(got, want, strict=True):
        _close(g, wv)


def test_ragged_conv_state_matches_reference():
    """Slots shorter than, at and past the conv window, in a 9-wide
    batch: the gathered rows, zero-padded on the left, exactly."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, 9, 6)).astype(np.float32)
    lengths = np.asarray([1, 2, 3, 4, 9], np.int32)
    want = JS.ragged_conv_state(jnp.asarray(x), jnp.asarray(lengths), 4)
    got = ssm.ragged_conv_state(_t(x), _t(lengths), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("length", [8, 21])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("h0", [False, True])
def test_ssd_chunked_matches_reference(length, groups, h0):
    """Chunk 8 over a length that is and one that is not a multiple of it
    (3 chunks, the last padded), 4 heads over 1 and 2 groups, with and
    without a starting state."""
    rng = np.random.default_rng(length + 10 * groups)
    b, h, p, n = 2, 4, 8, 8
    args = [rng.standard_normal((b, length, h, p)),
            rng.uniform(0.01, 0.2, (b, length, h)),
            rng.uniform(-1, 1, h),
            rng.standard_normal((b, length, groups, n)),
            rng.standard_normal((b, length, groups, n)),
            rng.standard_normal(h)]
    args = [a.astype(np.float32) for a in args]
    st = rng.standard_normal((b, h, n, p)).astype(np.float32) if h0 else None
    want = JS.ssd_chunked(*map(jnp.asarray, args), chunk=8,
                          h0=None if st is None else jnp.asarray(st))
    got = ssm.ssd_chunked(*map(_t, args), chunk=8,
                          h0=None if st is None else _t(st))
    for g, wv in zip(got, want, strict=True):
        assert g.dtype == torch.float32
        _close(g, wv)


SSM_KW = dict(name="t", kind="decoder", n_layers=1, d_model=32, n_heads=0,
              n_kv=0, d_ff=0, vocab=100, layer_pattern=("ssm",))


@pytest.fixture(scope="module")
def ssm_block_params():
    """A 32-wide SSD block over 2 groups (the JAX `ssm_init`), with
    nonzero norm and conv bias so that both show."""
    jcfg = JaxArchConfig(**SSM_KW, ssm=JaxSSMConfig(d_state=16, head_dim=8,
                                                    n_groups=2, chunk=8))
    cfg = ArchConfig(**SSM_KW, ssm=SSMConfig(d_state=16, head_dim=8,
                                             n_groups=2, chunk=8))
    jp = JS.ssm_init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(3)
    jp["norm"] = jnp.asarray(0.3 * rng.standard_normal(jp["norm"].shape),
                             jnp.float32)
    jp["conv_b"] = jnp.asarray(0.3 * rng.standard_normal(jp["conv_b"].shape),
                               jnp.float32)
    return jcfg, jp, cfg, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            device="cpu")


def test_ssm_block_matches_reference(ssm_block_params):
    jcfg, jp, cfg, p = ssm_block_params
    x = np.random.default_rng(4).standard_normal((2, 19, 32)).astype(
        np.float32)
    _close(ssm.ssm_block(p, cfg, _t(x)), JS.ssm_block(jp, jcfg, jnp.asarray(x)))


def test_ssm_decode_step_matches_reference(ssm_block_params):
    """Five steps from a nonzero state: outputs and both states."""
    jcfg, jp, cfg, p = ssm_block_params
    rng = np.random.default_rng(5)
    conv = rng.standard_normal((2, 3, 64 + 2 * 2 * 16)).astype(np.float32)
    state = rng.standard_normal((2, 8, 16, 8)).astype(np.float32)
    jc, js, c, s = jnp.asarray(conv), jnp.asarray(state), _t(conv), _t(state)
    for _ in range(5):
        x = rng.standard_normal((2, 1, 32)).astype(np.float32)
        want, jc, js = JS.ssm_decode_step(jp, jcfg, jnp.asarray(x), jc, js)
        got, c, s = ssm.ssm_decode_step(p, cfg, _t(x), c, s)
        for g, wv in ((got, want), (c, jc), (s, js)):
            _close(g, wv)


def test_softplus_matches_reference_at_the_init_values():
    """`F.softplus` switches to the identity above 20; at the values the
    recurrent blocks feed it (dt_bias and Lambda from their inits, plus
    projections) it equals `jax.nn.softplus` in f32."""
    x = np.concatenate([np.linspace(-12, 25, 2001),
                        np.log(np.expm1(np.geomspace(1e-3, 1e-1, 50))),
                        np.log(np.expm1(-np.log(np.linspace(0.9, 0.999,
                                                            50))))])
    x = x.astype(np.float32)
    want = jax.nn.softplus(jnp.asarray(x))
    got = torch.nn.functional.softplus(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


# --------------------------------------------------------------------------
# mamba2-780m SMOKE
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mamba():
    jcfg = jax_get_config(MAMBA, smoke=True)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jcfg, jparams, get_config(MAMBA, smoke=True), params


def test_forward_matches_reference(mamba):
    """40 tokens: three 16-token chunks, the last padded."""
    jcfg, jparams, cfg, params = mamba
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 40)).astype(
        np.int32)
    want, _ = JT.forward(jparams, jcfg, jnp.asarray(toks),
                         compute_dtype=jnp.float32)
    got, _ = T.forward(params, cfg, _t(toks), compute_dtype=torch.float32)
    _close(got, want, TOL)


def test_prefill_then_decode_matches_forward(mamba):
    """The JAX package's own check, on the port: prefill half of 24
    tokens, decode the rest, each logit within 5e-3 of forward's scale."""
    _, _, cfg, params = mamba
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


def test_init_params_matches_reference_tree(mamba):
    """The port's `init_params` has the JAX tree's paths and shapes, its
    fixed leaves (A_log, D, norm, conv_b) the JAX values; the bridge
    carries every leaf across, as is or cast to bf16 as the JAX launcher
    casts its tree (the f32 leaves A_log, D, dt_bias, norm, conv_w and
    conv_b included)."""
    jcfg, jparams, cfg, params = mamba
    want = _leaves(jparams)
    mine = _leaves(T.init_params(cfg, generator=torch.Generator().manual_seed(
        0)))
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        k: v.shape for k, v in want.items()}
    for name in ("A_log", "D", "norm", "conv_b"):
        path = f"['stack']['b0']['ssm']['{name}']"
        # log / expm1 of another library: a few f32 ulps apart
        np.testing.assert_allclose(_np(mine[path]), _np(want[path]),
                                   rtol=1e-5)
    got = _leaves(params)
    bf16 = _leaves(params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     device="cpu", dtype=torch.bfloat16))
    for path, leaf in want.items():
        np.testing.assert_array_equal(_np(got[path]), _np(leaf))
        assert bf16[path].dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(bf16[path]),
                                      _np(leaf.astype(jnp.bfloat16)))


def test_generate_tokens_identical_to_reference(mamba):
    jcfg, jparams, cfg, params = mamba
    prompt = np.random.default_rng(4).integers(0, cfg.vocab, (2, 37)).astype(
        np.int32)
    want = jax_serve.generate(jparams, jcfg, jax_serve.ServeConfig(
        max_seq=46, batch=2, compute_dtype=jnp.float32,
        cache_dtype=jnp.float32, kernel_backend="xla-einsum"),
        jnp.asarray(prompt), 8)
    got = serve.generate(params, cfg, serve.ServeConfig(
        max_seq=46, batch=2, compute_dtype="float32", cache_dtype="float32",
        kernel_backend="hopper", device="cpu"), _t(prompt), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _spec(vocab, seed=0):
    """Seven requests of 3-39 prompt tokens (ragged against the 16-token
    chunk and the conv window) and 2-7 new tokens."""
    rng = np.random.default_rng(seed)
    return [(uid, rng.integers(0, vocab, int(rng.integers(3, 40))).astype(
        np.int32), int(rng.integers(2, 8))) for uid in range(7)]


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_scheduler_tokens_and_stats_identical_to_reference(mamba, layout):
    """2 slots, a padding prefill bucket of 8: admits into a live cache,
    ragged prompts; a paged ServeConfig builds no paged plane (no "attn"
    layer) and runs the contiguous path, as in the JAX package."""
    jcfg, jparams, cfg, params = mamba
    spec = _spec(cfg.vocab)
    kw = dict(max_seq=56, batch=2, cache_layout=layout, page_size=8)
    ref = JaxScheduler(jparams, jcfg, jax_serve.ServeConfig(
        **kw, compute_dtype=jnp.float32, cache_dtype=jnp.float32,
        kernel_backend="xla-einsum"), prefill_bucket=8)
    ref.run([JaxRequest(uid=u, prompt=p.copy(), max_new_tokens=g)
             for u, p, g in spec], max_steps=300)
    sched = Scheduler(params, cfg, serve.ServeConfig(
        **kw, compute_dtype="float32", cache_dtype="float32",
        kernel_backend="hopper", device="cpu"), prefill_bucket=8)
    sched.run([Request(uid=u, prompt=p.copy(), max_new_tokens=g)
               for u, p, g in spec], max_steps=300)
    assert sched.paged is None and ref.paged is None
    assert sorted(sched.completions) == sorted(ref.completions)
    for uid, c in ref.completions.items():
        np.testing.assert_array_equal(sched.completions[uid].tokens, c.tokens,
                                      err_msg=f"uid={uid}")
    assert sched.stats == ref.stats


def test_ragged_prefill_and_masked_decode_match_reference(mamba):
    """Two admits into a live cache (prompts of 21, 2 and 16 tokens, then
    one of 5 into a masked slot) and 6 decode ticks with slot 1 inactive:
    the live rows' logits and every cache leaf equal the JAX package's,
    and the inactive slot's conv and SSD state stay bit for bit."""
    jcfg, jparams, cfg, params = mamba
    rng = np.random.default_rng(7)
    b = 3
    jcache = JT.init_cache(jcfg, JT.CacheSpec(40, b), dtype=jnp.float32)
    cache = T.init_cache(cfg, T.CacheSpec(40, b), dtype=torch.float32)
    for width, lengths, mask in ((21, [21, 2, 16], [True, True, False]),
                                 (5, [1, 1, 5], [False, False, True])):
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
    frozen = [c[name][:, 1].clone() for c in cache["slots"].values()
              for name in ("conv", "state")]
    active = np.asarray([True, False, True])
    for _ in range(6):
        tok = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
        want, jcache = JT.decode_step(jparams, jcfg, jcache, jnp.asarray(tok),
                                      compute_dtype=jnp.float32,
                                      active=jnp.asarray(active))
        got, cache = T.decode_step(params, cfg, cache, _t(tok),
                                   compute_dtype=torch.float32,
                                   active=_t(active))
        _close(got[active], np.asarray(want)[active], TOL)
    assert cache["t"].tolist() == [27, 2, 11]
    after = [c[name][:, 1] for c in cache["slots"].values()
             for name in ("conv", "state")]
    for a, f in zip(after, frozen, strict=True):
        assert torch.equal(a, f) and f.abs().sum() > 0
    want = _leaves(jcache)
    got = _leaves(cache)
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        np.testing.assert_allclose(_np(got[path]), _np(leaf), **TOL)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_init_cache_layout_matches_reference(layout):
    """conv in the cache dtype and the SSD state in f32, on either layout
    (nothing paged), and constant in max_seq."""
    jcfg, cfg = jax_get_config(MAMBA, True), get_config(MAMBA, True)
    spec = dict(page_size=8, n_pages=12) if layout == "paged" else {}
    for max_seq in (16, 400):
        want = _leaves(JT.init_cache(jcfg, JT.CacheSpec(max_seq, 3, **spec),
                                     dtype=jnp.bfloat16))
        got = _leaves(T.init_cache(cfg, T.CacheSpec(max_seq, 3, **spec),
                                   dtype=torch.bfloat16))
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()} == {
            k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in got.items()}


def test_int8_cache_is_refused_with_the_reference_message():
    """mamba2 has no attention rows to quantize: int8 is refused, in the
    JAX package's words, by the validator and by the Scheduler."""
    jcfg, cfg = jax_get_config(MAMBA, True), get_config(MAMBA, True)
    with pytest.raises(ValueError) as want:
        jax_serve.validate_cache_dtype(jnp.int8, jcfg)
    with pytest.raises(ValueError) as got:
        serve.validate_cache_dtype(torch.int8, cfg)
    assert str(got.value) == str(want.value)
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="int8 SSM/RG-LRU state is "
                                         "unsupported"):
        Scheduler(params, cfg, serve.ServeConfig(
            max_seq=16, batch=2, cache_dtype="int8", device="cpu"))


def test_no_kernel_runs_in_an_ssm_block(mamba):
    """The block's projections and the LM head are plain matmuls, as in
    the JAX package: a `hopper` serve makes no engine decision."""
    _, _, cfg, params = mamba
    eng = serve.warm_start_engine(serve.ServeConfig(
        max_seq=20, batch=2, compute_dtype="float32", cache_dtype="float32",
        kernel_backend="hopper", device="cpu"))
    serve.generate(params, cfg, serve.ServeConfig(
        max_seq=20, batch=2, compute_dtype="float32", cache_dtype="float32",
        kernel_backend="hopper", device="cpu"),
        torch.zeros((2, 9), dtype=torch.int32), 4, engine=eng)
    assert len(eng.plan) == 0


def test_cli_serves_mamba2_on_cpu_smoke():
    from repro_torch.launch import serve as launch_serve
    out = launch_serve.main(["--arch", MAMBA, "--smoke", "--device", "cpu",
                             "--kernel-backend", "hopper", "--batch", "2",
                             "--cache-layout", "paged", "--page-size", "8",
                             "--trace", "24x8,8x4*3"])
    assert out["requests"] == 4 and out["tokens"] == 8 + 3 * 4
    assert out["scheduler"].paged is None
