"""The port's model and serving path on qwen2-1.5b SMOKE against the JAX
reference, with the JAX `init_params` weights carried across by the
bridge (the port's own `init_params` draws other values from a
torch.Generator).  f32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.engine import use_engine as jax_use_engine
from repro.models import transformer as JT
from repro.serve_lib import serve as jax_serve
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.engine import use_engine
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as T
from repro_torch.serve_lib import serve

ARCH = "qwen2-1.5b"
#: as tests/test_kernels.py holds the engine-routed JAX forward to XLA's
TOL = {"rtol": 1e-4, "atol": 1e-3}


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_get_config(ARCH, smoke=True)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, tree, params_from_numpy(tree, device="cpu")


def _tokens(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_config_is_a_copy_of_the_reference(arch):
    import dataclasses

    for smoke in (False, True):
        assert (dataclasses.asdict(get_config(arch, smoke))
                == dataclasses.asdict(jax_get_config(arch, smoke)))


def test_bridge_round_trips_every_leaf(weights):
    _, _, tree, params = weights
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    assert isinstance(params["tail"], list)
    for path, leaf in flat:
        node = params
        for p in path:
            node = node[p.key if hasattr(p, "key") else p.idx]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), leaf)
    assert params["stack"]["b0"]["attn"]["wq"]["w"].shape[0] == 2  # periods


def test_init_params_matches_reference_shapes(weights):
    cfg = get_config(ARCH, smoke=True)
    _, _, tree, _ = weights
    mine = T.init_params(cfg, generator=torch.Generator().manual_seed(0))
    got = jax.tree.map(lambda t: tuple(t.shape), mine)
    want = jax.tree.map(lambda a: a.shape, tree)
    assert got == want


def test_forward_matches_reference(weights):
    jcfg, jparams, _, params = weights
    toks = _tokens(2, 11, jcfg.vocab)
    want, _ = JT.forward(jparams, jcfg, jnp.asarray(toks),
                         compute_dtype=jnp.float32)
    got, _ = T.forward(params, get_config(ARCH, True), torch.from_numpy(toks),
                       compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_through_engines_matches_reference(weights):
    jcfg, jparams, _, params = weights
    toks = _tokens(1, 16, jcfg.vocab, seed=2)
    with jax_use_engine(backend="pallas-interpret"):
        want, _ = JT.forward(jparams, jcfg, jnp.asarray(toks),
                             compute_dtype=jnp.float32)
    with use_engine(backend="hopper") as eng:
        got, _ = T.forward(params, get_config(ARCH, True),
                           torch.from_numpy(toks), compute_dtype=torch.float32)
    assert eng.plan.stats["decisions"] > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_then_decode_matches_forward(weights):
    _, _, _, params = weights
    cfg = get_config(ARCH, True)
    toks = torch.from_numpy(_tokens(2, 12, cfg.vocab, seed=3))
    full, _ = T.forward(params, cfg, toks, compute_dtype=torch.float32)
    cache = T.init_cache(cfg, T.CacheSpec(max_seq=12, batch=2),
                         dtype=torch.float32)
    lg, cache = T.prefill(params, cfg, toks[:, :6], cache,
                          compute_dtype=torch.float32)
    outs = [lg]
    for t in range(6, 12):
        lg, cache = T.decode_step(params, cfg, cache, toks[:, t:t + 1],
                                  compute_dtype=torch.float32)
        outs.append(lg)
    assert cache["t"].tolist() == [12, 12]
    torch.testing.assert_close(torch.cat(outs, 1), full[:, 5:], rtol=1e-4,
                               atol=1e-4)


def test_cache_shorter_than_prompt_matches_reference(weights):
    """A cache of max_seq < prompt keeps the prompt's last rows rolled to
    their ring positions, and decode then attends the last max_seq rows,
    as in the JAX package."""
    jcfg, jparams, _, params = weights
    cfg = get_config(ARCH, True)
    toks = _tokens(2, 11, jcfg.vocab, seed=5)
    jcache = JT.init_cache(jcfg, JT.CacheSpec(max_seq=6, batch=2),
                           dtype=jnp.float32)
    cache = T.init_cache(cfg, T.CacheSpec(max_seq=6, batch=2),
                         dtype=torch.float32)
    want, jcache = JT.prefill(jparams, jcfg, jnp.asarray(toks[:, :8]), jcache,
                              compute_dtype=jnp.float32)
    got, cache = T.prefill(params, cfg, torch.from_numpy(toks[:, :8]), cache,
                           compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for t in range(8, 11):
        want, jcache = JT.decode_step(jparams, jcfg, jcache,
                                      jnp.asarray(toks[:, t:t + 1]),
                                      compute_dtype=jnp.float32)
        got, cache = T.decode_step(params, cfg, cache,
                                   torch.from_numpy(toks[:, t:t + 1]),
                                   compute_dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(cache["slots"]["b0"]["k"].numpy(),
                               np.asarray(jcache["slots"]["b0"]["k"]), **TOL)


@pytest.mark.parametrize("backend", [None, "hopper", "torch-ref"])
def test_greedy_tokens_identical_to_reference(weights, backend):
    jcfg, jparams, _, params = weights
    prompt = _tokens(2, 8, jcfg.vocab, seed=4)
    jscfg = jax_serve.ServeConfig(max_seq=15, batch=2,
                                  compute_dtype=jnp.float32,
                                  cache_dtype=jnp.float32)
    want = jax_serve.generate(jparams, jcfg, jscfg, jnp.asarray(prompt), 6)
    scfg = serve.ServeConfig(max_seq=15, batch=2, compute_dtype="float32",
                             cache_dtype="float32", kernel_backend=backend,
                             device="cpu")
    got = serve.generate(params, get_config(ARCH, True), scfg,
                         torch.from_numpy(prompt), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cli_runs_on_cpu_smoke():
    out = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--kernel-backend", "hopper", "--batch", "2",
                             "--prompt-len", "8", "--gen", "4"])
    assert out["shape"] == (2, 4)
    assert out["engine_plan"]["misses"] == out["engine_plan"]["decisions"]
    assert out["engine_plan"]["hits"] > 0
    # it hands back what it served: `generate` on that gives the tokens again
    again = serve.generate(out["params"], out["cfg"], out["serve_config"],
                           out["prompt"], 4, engine=out["engine"])
    assert torch.equal(again, out["tokens"])
