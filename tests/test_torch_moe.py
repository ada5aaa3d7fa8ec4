"""The port's MoE (`models/moe.py`) and granite-moe-1b-a400m through the
port's model and `Scheduler`, against the JAX package, in f32 on the CPU.
The weights come from the JAX `moe_init`/`init_params` through the
bridge; the inputs are made with numpy from a seed (f32 router logits
from random inputs have no exact ties, so `torch.topk` and
`jax.lax.top_k` choose the same experts).

  capacity    `MoEConfig.capacity` equals the JAX formula for seq 1-1024;
  blocks      `moe_block_sorted` and `moe_block_einsum` give the JAX
              blocks' y and aux at high capacity, at cf 1.0 (where
              selections drop, so token-major priority shows) and on
              granite SMOKE; the sorted block inside an engine scope
              (`torch-ref`, `hopper`) against the JAX block under
              `pallas-interpret`; the einsum block makes no grouped
              request in either package;
  model       granite SMOKE `forward` (logits, aux), `prefill` and
              `decode_step`, for both impls; ragged prefill at cf 1.0,
              where the pad tokens take capacity after the real ones;
  scheduler   greedy tokens and stats identical per uid to the JAX
              `Scheduler`, both impls, contiguous and paged, cf 8.0 and
              the default cf, at a prefill bucket of 8 (so pad tokens
              route beside the prompts).

Tolerances: the blocks at rtol = atol = 1e-5 (f32 both sides; only the
order of sums differs); the model at rtol 1e-4 / atol 1e-3, as
tests/test_torch_serve.py holds the port's logits to the JAX ones.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.engine import use_engine as jax_use_engine
from repro.models import moe as jax_moe
from repro.models import transformer as JT
from repro.models.config import ArchConfig as JaxArchConfig
from repro.models.config import MoEConfig as JaxMoEConfig
from repro.serve_lib import serve as jax_serve
from repro.serve_lib.scheduler import Request as JaxRequest
from repro.serve_lib.scheduler import Scheduler as JaxScheduler
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.engine import use_engine
from repro_torch.launch import serve as launch_serve
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig, MoEConfig
from repro_torch.serve_lib import serve
from repro_torch.serve_lib.scheduler import Request, Scheduler

ARCH = "granite-moe-1b-a400m"
BLOCK_TOL = {"rtol": 1e-5, "atol": 1e-5}
MODEL_TOL = {"rtol": 1e-4, "atol": 1e-3}
IMPLS = ("einsum", "sort")


def _with(cfg, **moe_kw):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))


def _pair(jcfg, cfg, **moe_kw):
    return _with(jcfg, **moe_kw), _with(cfg, **moe_kw)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


# --------------------------------------------------------------------------
# capacity and configuration
# --------------------------------------------------------------------------


@pytest.mark.parametrize("e,k,cf", [(32, 8, 1.25), (8, 4, 1.25), (4, 2, 8.0),
                                    (4, 2, 1.0), (8, 2, 1.1)])
def test_capacity_matches_reference(e, k, cf):
    mine, ref = MoEConfig(e, k, cf), JaxMoEConfig(e, k, cf)
    assert [mine.capacity(s) for s in range(1, 1025)] == [
        ref.capacity(s) for s in range(1, 1025)]
    assert moe.capacity(dataclasses.replace(_BLOCK_CFG, moe=mine), 12) \
        == jax_moe.capacity(dataclasses.replace(_JAX_BLOCK_CFG, moe=ref), 12)


def test_granite_capacity_and_config_are_the_references():
    for smoke in (False, True):
        assert (dataclasses.asdict(get_config(ARCH, smoke))
                == dataclasses.asdict(jax_get_config(ARCH, smoke)))
    m = get_config(ARCH).moe
    assert (m.capacity(1), m.capacity(64), m.capacity(768)) == (4, 20, 240)


# --------------------------------------------------------------------------
# MoE blocks
# --------------------------------------------------------------------------

#: tests/test_moe.py's configuration (high capacity, cf 8.0)
_KW = dict(name="t", kind="decoder", n_layers=1, d_model=16, n_heads=2,
           n_kv=1, d_ff=32, vocab=100, head_dim=8)
_BLOCK_CFG = ArchConfig(**_KW, moe=MoEConfig(4, 2, capacity_factor=8.0))
_JAX_BLOCK_CFG = JaxArchConfig(**_KW, moe=JaxMoEConfig(4, 2,
                                                       capacity_factor=8.0))

#: (name, cf or None for the config's own, x shape, seed)
BLOCK_CASES = [("high_capacity", None, (2, 12, 16), 0),
               ("cf_1.0", 1.0, (2, 32, 16), 1),
               ("granite_smoke", None, (2, 12, 64), 2)]


def _block_case(name, cf, shape, seed, impl):
    if name == "granite_smoke":
        jcfg, cfg = jax_get_config(ARCH, True), get_config(ARCH, True)
    else:
        jcfg, cfg = _JAX_BLOCK_CFG, _BLOCK_CFG
    kw = {"impl": impl} if cf is None else {"impl": impl,
                                            "capacity_factor": cf}
    jcfg, cfg = _pair(jcfg, cfg, **kw)
    jp = jax_moe.moe_init(jax.random.PRNGKey(seed), jcfg)
    p = params_from_numpy(_numpy_tree(jp), device="cpu")
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jcfg, cfg, jp, p, x


def _dropped(sel: np.ndarray, e: int, c: int) -> int:
    """Selections past capacity, counted per example in token-major
    order."""
    b = sel.shape[0]
    flat = sel.reshape(b, -1)
    return sum(max(0, int((flat[i] == j).sum()) - c)
               for i in range(b) for j in range(e))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name,cf,shape,seed", BLOCK_CASES,
                         ids=[c[0] for c in BLOCK_CASES])
def test_moe_block_matches_reference(impl, name, cf, shape, seed):
    jcfg, cfg, jp, p, x = _block_case(name, cf, shape, seed, impl)
    want_y, want_aux = jax_moe.moe_block(jp, jcfg, jnp.asarray(x))
    block = moe.moe_block_sorted if impl == "sort" else moe.moe_block_einsum
    got_y, got_aux = block(p, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **BLOCK_TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **BLOCK_TOL)
    _, sel, _ = moe._route(p, cfg, torch.from_numpy(x))
    drops = _dropped(sel.numpy(), cfg.moe.n_experts,
                     moe.capacity(cfg, shape[1]))
    if name != "granite_smoke":   # granite's own cf drops some here too
        assert (drops > 0) == (name == "cf_1.0")


def test_sorted_block_in_an_engine_matches_reference_under_pallas():
    """The sorted block's three expert matmuls go through the engine's
    grouped GEMM, in both packages, and agree."""
    jcfg, cfg, jp, p, x = _block_case("granite_smoke", None, (2, 12, 64), 3,
                                      "sort")
    with jax_use_engine(backend="pallas-interpret") as jeng:
        want, _ = jax_moe.moe_block(jp, jcfg, jnp.asarray(x))
    for backend in ("torch-ref", "hopper"):
        with use_engine(backend=backend) as eng:
            got, _ = moe.moe_block(p, cfg, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
        assert sorted(req.key() for req, _ in eng.plan) == sorted(
            req.key() for req, _ in jeng.plan)
        assert {req.op for req, _ in eng.plan} == {"grouped_gemm"}
        assert eng.plan.stats == jeng.plan.stats  # wi/wg share a decision


def test_einsum_block_makes_no_grouped_request():
    """The default dispatch never reaches the engine, in either package."""
    jcfg, cfg, jp, p, x = _block_case("granite_smoke", None, (2, 12, 64), 4,
                                      "einsum")
    with jax_use_engine(backend="pallas-interpret") as jeng:
        want, _ = jax_moe.moe_block(jp, jcfg, jnp.asarray(x))
    with use_engine(backend="hopper") as eng:
        got, _ = moe.moe_block(p, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    assert len(eng.plan) == len(jeng.plan) == 0
    assert eng.plan.stats == jeng.plan.stats


# --------------------------------------------------------------------------
# Model
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_get_config(ARCH, smoke=True)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(_numpy_tree(jparams), device="cpu")
    return jcfg, jparams, get_config(ARCH, smoke=True), params


def test_bridge_maps_the_moe_tree(weights):
    jcfg, jparams, cfg, params = weights
    flat, _ = jax.tree_util.tree_flatten_with_path(_numpy_tree(jparams))
    for path, leaf in flat:
        node = params
        for key in path:
            node = node[key.key if hasattr(key, "key") else key.idx]
        np.testing.assert_array_equal(node.numpy(), leaf)
    block = params["stack"]["b0"]
    assert "mlp" not in block
    assert tuple(block["moe"]["router"]["w"].shape) == (2, 64, 8)
    assert tuple(block["moe"]["experts"]["wi"].shape) == (2, 8, 64, 32)
    assert tuple(block["moe"]["experts"]["wo"].shape) == (2, 8, 32, 64)
    mine = T.init_params(cfg, generator=torch.Generator().manual_seed(0))
    assert (jax.tree.map(lambda t: tuple(t.shape), mine)
            == jax.tree.map(lambda a: a.shape, _numpy_tree(jparams)))


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_matches_reference(weights, impl):
    jcfg, jparams, cfg, params = weights
    jcfg, cfg = _pair(jcfg, cfg, impl=impl)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 12))
    want, want_aux = JT.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32),
                                compute_dtype=jnp.float32)
    got, aux = T.forward(params, cfg, torch.from_numpy(toks),
                         compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    assert float(aux) > 0


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_and_decode_match_reference(weights, impl):
    jcfg, jparams, cfg, params = weights
    jcfg, cfg = _pair(jcfg, cfg, impl=impl)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab, (2, 10)).astype(np.int32)
    jcache = JT.init_cache(jcfg, JT.CacheSpec(16, 2), dtype=jnp.float32)
    cache = T.init_cache(cfg, T.CacheSpec(16, 2), dtype=torch.float32)
    want, jcache = JT.prefill(jparams, jcfg, jnp.asarray(toks), jcache,
                              compute_dtype=jnp.float32)
    with use_engine(backend="hopper"):
        got, cache = T.prefill(params, cfg, torch.from_numpy(toks), cache,
                               compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        want, jcache = JT.decode_step(jparams, jcfg, jcache, jnp.asarray(tok),
                                      compute_dtype=jnp.float32)
        with use_engine(backend="hopper"):
            got, cache = T.decode_step(params, cfg, cache,
                                       torch.from_numpy(tok),
                                       compute_dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    np.testing.assert_array_equal(cache["t"].numpy(), np.asarray(jcache["t"]))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_ragged_prefill_at_cf_1_matches_reference(weights, impl, layout,
                                                  monkeypatch):
    """Right-padded rows (token 0 past each length) route and take
    capacity after their example's real tokens; at cf 1.0 selections
    drop, and the live rows still equal the JAX package's."""
    jcfg, jparams, cfg, params = weights
    jcfg, cfg = _pair(jcfg, cfg, impl=impl, capacity_factor=1.0)
    b, width, page = 3, 12, 4
    lengths = np.asarray([12, 5, 8], np.int32)
    toks = np.random.default_rng(7).integers(1, cfg.vocab, (b, width))
    toks[np.arange(width)[None, :] >= lengths[:, None]] = 0
    toks = toks.astype(np.int32)
    kw = {"lengths": lengths, "update_mask": np.asarray([True, True, True])}
    spec = {}
    if layout == "paged":
        spec = dict(page_size=page, n_pages=12)
        kw.update(block_tables=np.arange(12, dtype=np.int32).reshape(3, 4),
                  hist_len=np.zeros(b, np.int32))
    jcache = JT.init_cache(jcfg, JT.CacheSpec(16, b, **spec),
                           dtype=jnp.float32)
    cache = T.init_cache(cfg, T.CacheSpec(16, b, **spec), dtype=torch.float32)
    want, jcache = JT.prefill(jparams, jcfg, jnp.asarray(toks), jcache,
                              compute_dtype=jnp.float32,
                              **{k: jnp.asarray(v) for k, v in kw.items()})
    routed = []

    def route(*args):
        out = moe._route.__wrapped__(*args)
        routed.append(out[1].numpy())
        return out

    route.__wrapped__ = moe._route
    monkeypatch.setattr(moe, "_route", route)
    got, cache = T.prefill(params, cfg, torch.from_numpy(toks), cache,
                           compute_dtype=torch.float32,
                           **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    np.testing.assert_array_equal(cache["t"].numpy(), np.asarray(jcache["t"]))
    c = cfg.moe.capacity(width)
    assert len(routed) == cfg.n_layers
    assert any(_dropped(sel, cfg.moe.n_experts, c) for sel in routed)


# --------------------------------------------------------------------------
# Scheduler
# --------------------------------------------------------------------------


def _spec(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [(uid, rng.integers(0, vocab, int(rng.integers(3, 18))
                               ).astype(np.int32), int(rng.integers(2, 7)))
            for uid in range(6)]


@pytest.mark.parametrize("cf", [8.0, None], ids=["cf8", "default_cf"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("impl", IMPLS)
def test_scheduler_tokens_and_stats_identical_to_reference(weights, impl,
                                                           layout, cf):
    jcfg, jparams, cfg, params = weights
    kw = {"impl": impl} if cf is None else {"impl": impl,
                                            "capacity_factor": cf}
    jcfg, cfg = _pair(jcfg, cfg, **kw)
    spec = _spec(cfg.vocab)
    ref = JaxScheduler(jparams, jcfg, jax_serve.ServeConfig(
        max_seq=48, batch=2, compute_dtype=jnp.float32,
        cache_dtype=jnp.float32, kernel_backend="xla-einsum",
        cache_layout=layout, page_size=8), prefill_bucket=8)
    want = ref.run([JaxRequest(uid=u, prompt=p.copy(), max_new_tokens=g)
                    for u, p, g in spec], max_steps=300)
    sched = Scheduler(params, cfg, serve.ServeConfig(
        max_seq=48, batch=2, compute_dtype="float32", cache_dtype="float32",
        kernel_backend="hopper", device="cpu", cache_layout=layout,
        page_size=8), prefill_bucket=8)
    got = sched.run([Request(uid=u, prompt=p.copy(), max_new_tokens=g)
                     for u, p, g in spec], max_steps=300)
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid].tokens, want[uid].tokens,
                                      err_msg=f"uid={uid}")
    assert sched.stats == ref.stats
    ops = {req.op for req, _ in sched.engine.plan}
    assert ("grouped_gemm" in ops) == (impl == "sort")
    if sched.paged is not None:
        sched.paged.check_invariants()


def test_cli_serves_granite_einsum_without_grouped_requests():
    """The launcher serves the default (einsum) dispatch, as the JAX
    launcher does: the engine plans the attention GEMMs and nothing
    grouped."""
    out = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--kernel-backend", "hopper", "--batch", "2",
                             "--prompt-len", "8", "--gen", "4"])
    assert tuple(out["tokens"].shape) == (2, 4)
    assert out["cfg"].moe.impl == "einsum"
    ops = {req.op for req, _ in out["engine"].plan}
    assert ops == {"gemm"}
