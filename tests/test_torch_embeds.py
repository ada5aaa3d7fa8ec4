"""The port's embedding inputs against the JAX package, in f32 on the
CPU: internvl2-1b SMOKE with a (B, P, D) patch-embedding prefix before
its tokens, and hubert-xlarge SMOKE (an encoder: (B, S, D) frame
embeddings in, non-causal attention, the GELU feed-forward).  The
weights come from the JAX `init_params` through the bridge; tokens and
embeddings are made with numpy from a seed.  Also: the refusals the
port keeps, each in the JAX package's words.

Tolerances: logits at rtol 1e-4 / atol 1e-3, as the other model tests
hold them; decode against forward at the JAX package's own 5e-3 of the
logits' scale; greedy tokens identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import serve as jax_launch
from repro.models import transformer as JT
from repro.serve_lib import serve as jax_serve
from repro.serve_lib.scheduler import Scheduler as JaxScheduler
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as T
from repro_torch.serve_lib import serve
from repro_torch.serve_lib.scheduler import Scheduler

TOL = {"rtol": 1e-4, "atol": 1e-3}
DECODE_REL = 5e-3
VLM, AUDIO = "internvl2-1b", "hubert-xlarge"

_WEIGHTS = {}


def _weights(arch):
    if arch not in _WEIGHTS:
        jcfg = jax_get_config(arch, smoke=True)
        jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
        _WEIGHTS[arch] = (jcfg, jparams, get_config(arch, smoke=True),
                          params_from_numpy(jax.tree.map(np.asarray, jparams),
                                            device="cpu"))
    return _WEIGHTS[arch]


def _t(x):
    return torch.from_numpy(np.array(x))


def _inputs(cfg, s: int, seed: int = 1):
    """(tokens (2, s), embeddings): the VLM's 0.02-scaled prefix of
    `prefix_tokens` rows, or the encoder's s frames."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (2, s)).astype(np.int32)
    rows = s if cfg.embed_inputs else cfg.prefix_tokens
    scale = 1.0 if cfg.embed_inputs else 0.02
    emb = (scale * rng.standard_normal((2, rows, cfg.d_model))).astype(
        np.float32)
    return toks, emb


# --------------------------------------------------------------------------
# internvl2-1b: a patch-embedding prefix
# --------------------------------------------------------------------------


def test_vlm_forward_matches_reference():
    """8 prefix rows and 24 tokens: (2, 32, V) logits."""
    jcfg, jparams, cfg, params = _weights(VLM)
    toks, emb = _inputs(cfg, 24)
    want, _ = JT.forward(jparams, jcfg, jnp.asarray(toks),
                         embeds=jnp.asarray(emb), compute_dtype=jnp.float32)
    got, _ = T.forward(params, cfg, _t(toks), embeds=_t(emb),
                       compute_dtype=torch.float32)
    assert got.shape == (2, cfg.prefix_tokens + 24, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_vlm_prefill_then_decode_matches_forward():
    """The JAX package's own check: prefill the prefix and 12 tokens (the
    clock then P + 12), decode the other 12."""
    _, _, cfg, params = _weights(VLM)
    toks, emb = map(_t, _inputs(cfg, 24, seed=2))
    p = cfg.prefix_tokens
    full, _ = T.forward(params, cfg, toks, embeds=emb,
                        compute_dtype=torch.float32)
    cache = T.init_cache(cfg, T.CacheSpec(p + 24, 2), dtype=torch.float32)
    lg, cache = T.prefill(params, cfg, toks[:, :12], cache, embeds=emb,
                          compute_dtype=torch.float32)
    assert cache["t"].tolist() == [p + 12] * 2
    outs = [lg]
    for t in range(12, 24):
        lg, cache = T.decode_step(params, cfg, cache, toks[:, t:t + 1],
                                  compute_dtype=torch.float32)
        outs.append(lg)
    scale = float(full.abs().max())
    err = float((torch.cat(outs, 1) - full[:, p + 11:]).abs().max()) / scale
    assert err < DECODE_REL, err


def test_vlm_generate_tokens_identical_to_reference():
    jcfg, jparams, cfg, params = _weights(VLM)
    toks, emb = _inputs(cfg, 30, seed=3)
    max_seq = cfg.prefix_tokens + 30 + 8
    want = jax_serve.generate(jparams, jcfg, jax_serve.ServeConfig(
        max_seq=max_seq, batch=2, compute_dtype=jnp.float32,
        cache_dtype=jnp.float32, kernel_backend="xla-einsum"),
        jnp.asarray(toks), 8, embeds=jnp.asarray(emb))
    got = serve.generate(params, cfg, serve.ServeConfig(
        max_seq=max_seq, batch=2, compute_dtype="float32",
        cache_dtype="float32", kernel_backend="hopper", device="cpu"),
        _t(toks), 8, embeds=_t(emb))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_vlm_cli_draws_a_prefix_on_cpu_smoke():
    """Static mode draws `prefix_tokens` embeddings from the seed (0.02
    N(0, 1)) and serves after them; the same seed serves the same
    tokens."""
    argv = ["--arch", VLM, "--smoke", "--device", "cpu", "--kernel-backend",
            "hopper", "--batch", "2", "--prompt-len", "8", "--gen", "4"]
    out = launch_serve.main(argv)
    cfg = out["cfg"]
    assert out["shape"] == (2, 4)
    assert out["embeds"].shape == (2, cfg.prefix_tokens, cfg.d_model)
    assert 0.01 < float(out["embeds"].std()) < 0.03
    assert out["serve_config"].max_seq == cfg.prefix_tokens + 8 + 4 + 1
    assert torch.equal(launch_serve.main(argv)["tokens"], out["tokens"])


# --------------------------------------------------------------------------
# hubert-xlarge: frame embeddings into an encoder
# --------------------------------------------------------------------------


def test_encoder_forward_matches_reference():
    """40 frames: the logits equal the JAX package's, and they are not
    the causal model's (the encoder attends both ways)."""
    jcfg, jparams, cfg, params = _weights(AUDIO)
    assert not cfg.is_causal and not cfg.gated_mlp and "embed" not in params
    _, emb = _inputs(cfg, 40)
    want, _ = JT.forward(jparams, jcfg, None, embeds=jnp.asarray(emb),
                         compute_dtype=jnp.float32)
    got, _ = T.forward(params, cfg, None, embeds=_t(emb),
                       compute_dtype=torch.float32)
    assert got.shape == (2, 40, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    causal, _ = T.forward(params, dataclasses.replace(cfg, kind="decoder"),
                          None, embeds=_t(emb), compute_dtype=torch.float32)
    assert not torch.allclose(causal, got, atol=1e-3)


def test_encoder_generates_its_one_token_as_the_reference():
    """An encoder serves one token, the argmax of its last frame, as the
    JAX `generate` does at n_tokens = 1."""
    jcfg, jparams, cfg, params = _weights(AUDIO)
    toks, emb = _inputs(cfg, 16, seed=4)
    want = jax_serve.generate(jparams, jcfg, jax_serve.ServeConfig(
        max_seq=17, batch=2, compute_dtype=jnp.float32,
        cache_dtype=jnp.float32, kernel_backend="xla-einsum"),
        jnp.asarray(toks), 1, embeds=jnp.asarray(emb))
    got = serve.generate(params, cfg, serve.ServeConfig(
        max_seq=17, batch=2, compute_dtype="float32", cache_dtype="float32",
        kernel_backend="hopper", device="cpu"), _t(toks), 1, embeds=_t(emb))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# The refusals the port keeps
# --------------------------------------------------------------------------


def _message(fn, kind=Exception) -> str:
    with pytest.raises(kind) as err:
        fn()
    return str(err.value)


def _scfgs(**kw):
    return (jax_serve.ServeConfig(max_seq=40, batch=2,
                                  compute_dtype=jnp.float32,
                                  cache_dtype=jnp.float32, **kw),
            serve.ServeConfig(max_seq=40, batch=2, compute_dtype="float32",
                              cache_dtype="float32", device="cpu", **kw))


@pytest.mark.parametrize("arch", [AUDIO, VLM])
def test_scheduler_refuses_as_the_reference(arch):
    """The Scheduler refuses an encoder (no decode step) and an arch that
    takes embeddings, with the JAX package's error and message."""
    jcfg, jparams, cfg, params = _weights(arch)
    jscfg, scfg = _scfgs()
    kind = ValueError if arch == AUDIO else NotImplementedError
    want = _message(lambda: JaxScheduler(jparams, jcfg, jscfg), kind)
    assert _message(lambda: Scheduler(params, cfg, scfg), kind) == want


def test_launcher_refuses_an_encoder_as_the_reference():
    argv = ["--arch", AUDIO, "--smoke", "--batch", "2", "--prompt-len", "8",
            "--gen", "4"]
    want = _message(lambda: jax_launch.main(argv), SystemExit)
    assert _message(lambda: launch_serve.main(argv + ["--device", "cpu"]),
                    SystemExit) == want


def test_generate_refuses_an_encoder_decode():
    """More than one token from an encoder: the JAX `generate` fails at
    its missing embedding table; the port refuses with the message the
    JAX Scheduler and launcher give."""
    jcfg, jparams, cfg, params = _weights(AUDIO)
    toks, emb = _inputs(cfg, 8)
    jscfg, scfg = _scfgs()
    with pytest.raises(KeyError):
        jax_serve.generate(jparams, jcfg, jscfg, jnp.asarray(toks), 2,
                           embeds=jnp.asarray(emb))
    want = _message(lambda: JaxScheduler(jparams, jcfg, jscfg), ValueError)
    assert _message(lambda: serve.generate(params, cfg, scfg, _t(toks), 2,
                                           embeds=_t(emb)),
                    ValueError) == want


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_ragged_prefill_with_embeds_is_refused_as_the_reference(arch):
    jcfg, jparams, cfg, params = _weights(arch)
    toks, emb = _inputs(cfg, 8)
    lengths = np.asarray([8, 5], np.int32)
    jcache = JT.init_cache(jcfg, JT.CacheSpec(40, 2), dtype=jnp.float32)
    cache = T.init_cache(cfg, T.CacheSpec(40, 2), dtype=torch.float32)
    want = _message(lambda: JT.prefill(
        jparams, jcfg, jnp.asarray(toks), jcache, embeds=jnp.asarray(emb),
        lengths=jnp.asarray(lengths)), NotImplementedError)
    assert _message(lambda: T.prefill(
        params, cfg, _t(toks), cache, embeds=_t(emb), lengths=_t(lengths)),
        NotImplementedError) == want


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-2b"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_history_on_a_recurrent_block_is_refused(arch, layout):
    """A resident history (`hist_len` > 0) continues a recurrent block's
    state (chunked prefill; once refused, now ported): 4 tokens
    prefilled into slot 0, then a call continuing slot 0 by 6 tokens and
    starting slot 1 afresh.  Logits and every cache leaf equal the JAX
    package's, on either layout (a paged CacheSpec pages nothing without
    "attn" layers; the block tables then address no pool)."""
    jcfg, jparams, cfg, params = _weights(arch)
    spec = dict(page_size=4, n_pages=30) if layout == "paged" else {}
    jcache = JT.init_cache(jcfg, JT.CacheSpec(48, 2, **spec),
                           dtype=jnp.float32)
    cache = T.init_cache(cfg, T.CacheSpec(48, 2, **spec), dtype=torch.float32)
    rng = np.random.default_rng(7)
    kw = {}
    if layout == "paged":
        kw = {"block_tables": np.arange(24, dtype=np.int32).reshape(2, 12)}
    for hist, lengths, pages in (([0, 0], [4, 3], 0), ([4, 0], [6, 6], 1)):
        toks = rng.integers(0, cfg.vocab, (2, 6)).astype(np.int32)
        call = {**kw, "lengths": np.asarray(lengths, np.int32),
                "hist_len": np.asarray(hist, np.int32)}
        extra = {"hist_pages": pages} if layout == "paged" else {}
        want, jcache = JT.prefill(jparams, jcfg, jnp.asarray(toks), jcache,
                                  compute_dtype=jnp.float32, **extra,
                                  **{k: jnp.asarray(v)
                                     for k, v in call.items()})
        got, cache = T.prefill(params, cfg, _t(toks), cache,
                               compute_dtype=torch.float32, **extra,
                               **{k: _t(v) for k, v in call.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert cache["t"].tolist() == [10, 6]
    mine, ref = jax.tree.leaves(jax.tree.map(
        np.asarray, {"s": cache["slots"], "t": cache["tail"]},
        is_leaf=lambda x: isinstance(x, torch.Tensor))), jax.tree.leaves(
        {"s": jcache["slots"], "t": jcache["tail"]})
    for a, b in zip(mine, ref, strict=True):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32), rtol=1e-5,
                                   atol=1e-5)
