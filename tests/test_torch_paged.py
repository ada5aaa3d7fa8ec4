"""The port's paged KV plane and continuous-batching `Scheduler` against
the JAX package, on qwen2-1.5b SMOKE in f32 on the CPU, with the JAX
`init_params` weights carried across by the bridge.

  host plane   the port's `PagedKV`, `PageAllocator` and `PrefixIndex`
               driven by the same operation sequences as the JAX
               package's give the same results, tables, refcounts and
               free lists;
  model        ragged prefill with an update mask, paged prefill and
               masked decode write what the JAX package writes (the port
               writes in place; the JAX package merges old rows back);
  scheduler    greedy tokens identical per uid to
               `repro.serve_lib.scheduler.Scheduler`, contiguous and
               paged, with eviction, readmission and EOS; the stats of
               the shared-prefix and mixed-history traces equal the JAX
               scheduler's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro.serve_lib import paged as jax_paged
from repro.serve_lib import serve as jax_serve
from repro.serve_lib.scheduler import Request as JaxRequest
from repro.serve_lib.scheduler import Scheduler as JaxScheduler
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as T
from repro_torch.serve_lib import paged as port_paged
from repro_torch.serve_lib import serve
from repro_torch.serve_lib.scheduler import Request, Scheduler

ARCH = "qwen2-1.5b"
#: as tests/test_torch_serve.py holds the port's logits to the JAX ones
TOL = {"rtol": 1e-4, "atol": 1e-3}


# --------------------------------------------------------------------------
# Host plane: the same operation sequences through both copies
# --------------------------------------------------------------------------


def _try(fn, *args):
    try:
        out = fn(*args)
    except (AssertionError, RuntimeError, ValueError) as e:
        return ("raised", type(e).__name__)
    return out.tolist() if isinstance(out, np.ndarray) else out


def _alloc_state(a):
    return {"refcount": a.refcount.tolist(), "free": list(a._free)}


def _kv_state(kv):
    kv.check_invariants()
    return {"tables": kv.tables.tolist(), **_alloc_state(kv.alloc),
            "index": sorted(kv.index.pages()) if kv.index else None,
            "shared": kv.shared_tokens}


def _allocator(m):
    a = m.PageAllocator(4)
    log = [a.alloc(3), _try(a.ref, [1]), a.deref([0, 1]), a.deref([1]),
           _try(a.alloc, 4), a.free_count, _try(m.PageAllocator, 0)]
    return log, _alloc_state(a)


def _prefix_index(m):
    a = m.PageAllocator(8)
    idx = m.PrefixIndex(page_size=4)
    toks = list(range(10))
    pages = a.alloc(3)
    log = [idx.lookup(toks), idx.insert(toks, pages, a), idx.lookup(toks),
           idx.lookup(toks[:7]), idx.lookup([99] + toks[1:])]
    other = a.alloc(2)
    log += [idx.insert(toks[:8], other, a), idx.lookup(toks)]
    a.deref(pages)
    log += [len(idx), idx.evict(a.free_count + 1, a), idx.lookup(toks)]
    return log, _alloc_state(a)


def _admit_share_release(m):
    kv = m.PagedKV(batch=2, max_seq=32, page_size=4, n_pages=16)
    p1 = list(range(10))
    log = [kv.admit(0, p1)]
    kv.note_prefilled(0, p1)
    log += [kv.admit(1, p1[:8] + [77, 78, 79]), _kv_state(kv)]
    kv.release(0)
    log.append(_kv_state(kv))
    kv.release(1)
    return log, _kv_state(kv)


def _sharing_cap(m):
    kv = m.PagedKV(batch=2, max_seq=32, page_size=4, n_pages=16)
    p1 = list(range(8))
    kv.admit(0, p1)
    kv.note_prefilled(0, p1)
    return [kv.admit(1, list(p1))], _kv_state(kv)


def _decode_frontier(m):
    kv = m.PagedKV(batch=2, max_seq=32, page_size=4, n_pages=16)
    kv.admit(0, list(range(10)))
    kv.note_prefilled(0, list(range(10)))
    kv.admit(1, list(range(10)) + [5])
    log = [_try(kv.ensure_decode_page, 0, 10),
           _try(kv.ensure_decode_page, 1, 12), _kv_state(kv)]
    kv.tables[1][3] = -1
    log += [_try(kv.ensure_decode_page, 1, kv.page),
            _try(kv.ensure_decode_page, 0, 32)]
    return log, kv.tables.tolist()


def _pool_exhaustion(m):
    kv = m.PagedKV(batch=2, max_seq=64, page_size=4, n_pages=3,
                   prefix_sharing=False)
    return [kv.admit(0, list(range(9))),
            _try(kv.admit, 1, list(range(5)))], _kv_state(kv)


def _pressure_pins_prefix(m):
    kv = m.PagedKV(batch=1, max_seq=8, page_size=1, n_pages=5)
    kv.admit(0, [1, 2, 3])
    kv.note_prefilled(0, [1, 2, 3])
    kv.release(0)
    return [_try(kv.admit, 0, [1, 2, 3, 4, 5, 6])], _kv_state(kv)


def _pressure_evicts_unshared(m):
    kv = m.PagedKV(batch=2, max_seq=8, page_size=1, n_pages=6)
    kv.admit(0, [1, 2, 3])
    kv.note_prefilled(0, [1, 2, 3])
    kv.release(0)
    kv.admit(0, [9, 9])
    kv.note_prefilled(0, [9, 9])
    kv.release(0)
    return [kv.index.lookup([1, 2, 3]), kv.admit(1, [1, 2, 3, 4, 5])], \
        _kv_state(kv)


def _rollback(m):
    kv = m.PagedKV(batch=1, max_seq=32, page_size=4, n_pages=10)
    kv.admit(0, list(range(6)))
    for pos in range(6, 14):
        kv.ensure_decode_page(0, pos)
    log = [_kv_state(kv)]
    kv.rollback(0, 7)
    return log, _kv_state(kv)


HOST_CASES = [_allocator, _prefix_index, _admit_share_release, _sharing_cap,
              _decode_frontier, _pool_exhaustion, _pressure_pins_prefix,
              _pressure_evicts_unshared, _rollback]


@pytest.mark.parametrize("case", HOST_CASES, ids=lambda f: f.__name__[1:])
def test_host_plane_matches_reference(case):
    assert case(port_paged) == case(jax_paged)


def test_host_plane_raises_its_own_pool_exhausted():
    kv = port_paged.PagedKV(batch=1, max_seq=8, page_size=4, n_pages=2)
    with pytest.raises(port_paged.PoolExhausted):
        kv.alloc.alloc(3)
    assert port_paged.PoolExhausted is not jax_paged.PoolExhausted


# --------------------------------------------------------------------------
# Fixtures
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_get_config(ARCH, smoke=True)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jcfg, jparams, get_config(ARCH, smoke=True), params


def _jax_scfg(max_seq=48, batch=2, layout="contiguous", page=8, **kw):
    return jax_serve.ServeConfig(
        max_seq=max_seq, batch=batch, compute_dtype=jnp.float32,
        cache_dtype=jnp.float32, kernel_backend="xla-einsum",
        cache_layout=layout, page_size=page, **kw)


def _scfg(max_seq=48, batch=2, layout="contiguous", page=8, **kw):
    return serve.ServeConfig(
        max_seq=max_seq, batch=batch, compute_dtype="float32",
        cache_dtype="float32", kernel_backend="hopper", device="cpu",
        cache_layout=layout, page_size=page, **kw)


def _jax_reqs(spec):
    return [JaxRequest(uid=u, prompt=p.copy(), max_new_tokens=g, eos_id=e)
            for u, p, g, e in spec]


def _port_reqs(spec):
    return [Request(uid=u, prompt=p.copy(), max_new_tokens=g, eos_id=e)
            for u, p, g, e in spec]


def _random_spec(vocab, n, rng, max_prompt=18, max_gen=6, prefix=None):
    spec = []
    for uid in range(n):
        prompt = rng.integers(0, vocab, int(rng.integers(3, max_prompt)))
        if prefix is not None:
            prompt = np.concatenate([prefix, prompt])
        spec.append((uid, prompt.astype(np.int32),
                     int(rng.integers(2, max_gen + 1)), None))
    return spec


def _same_tokens(got, want):
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid].tokens, want[uid].tokens,
                                      err_msg=f"uid={uid}")
        assert got[uid].finish_reason == want[uid].finish_reason, uid


# --------------------------------------------------------------------------
# Model level: ragged / paged prefill and masked decode write what the JAX
# package writes
# --------------------------------------------------------------------------


def _cache_leaves(cache):
    c = cache["slots"]["b0"]
    return [np.asarray(c[k]) for k in sorted(c)] + [np.asarray(cache["t"])]


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_ragged_prefill_and_masked_decode_match_reference(weights, layout):
    """Two admits into a live cache (the second masked to one slot) and a
    decode with an inactive slot: logits of the live rows, every cache
    row and the clocks equal the JAX package's."""
    jcfg, jparams, cfg, params = weights
    rng = np.random.default_rng(11)
    b, page = 3, 4
    paged = layout == "paged"
    spec = dict(page_size=page, n_pages=20) if paged else {}
    jcache = JT.init_cache(jcfg, JT.CacheSpec(24, b, **spec), dtype=jnp.float32)
    cache = T.init_cache(cfg, T.CacheSpec(24, b, **spec), dtype=torch.float32)
    bt = np.full((b, 6), -1, np.int32)
    bt[0, :3], bt[1, :2], bt[2, :4] = [4, 0, 9], [7, 3], [1, 2, 5, 6]
    steps = [  # (tokens width, lengths, update_mask)
        (10, [9, 6, 1], [True, True, False]),
        (8, [1, 1, 8], [False, False, True]),
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
        got, cache = T.prefill(params, cfg, torch.from_numpy(toks), cache,
                               compute_dtype=torch.float32,
                               **{k: torch.from_numpy(v) for k, v in kw.items()})
        rows = np.flatnonzero(mask)
        np.testing.assert_allclose(got.numpy()[rows], np.asarray(want)[rows],
                                   **TOL)
    active = np.asarray([True, False, True])
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
        kw = {"active": active}
        if paged:
            kw["block_tables"] = bt
        want, jcache = JT.decode_step(jparams, jcfg, jcache, jnp.asarray(tok),
                                      compute_dtype=jnp.float32,
                                      **{k: jnp.asarray(v)
                                         for k, v in kw.items()})
        got, cache = T.decode_step(params, cfg, cache, torch.from_numpy(tok),
                                   compute_dtype=torch.float32,
                                   **{k: torch.from_numpy(v)
                                      for k, v in kw.items()})
        np.testing.assert_allclose(got.numpy()[active],
                                   np.asarray(want)[active], **TOL)
    for mine, ref in zip(_cache_leaves(cache), _cache_leaves(jcache),
                         strict=True):
        assert mine.shape == ref.shape
        np.testing.assert_allclose(mine, ref, **TOL)


def test_paged_prefill_rejections_as_in_reference(weights):
    _, _, cfg, params = weights
    cache = T.init_cache(cfg, T.CacheSpec(32, 2, page_size=8, n_pages=10),
                         dtype=torch.float32)
    toks = torch.zeros((2, 8), dtype=torch.int32)
    bt = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    with pytest.raises(NotImplementedError, match="ragged"):
        T.prefill(params, cfg, toks, cache, block_tables=bt)
    # a history on the contiguous layout is chunked prefill (once
    # refused, now ported): zeros start each slot afresh, as a ragged
    # prefill does
    contiguous = T.init_cache(cfg, T.CacheSpec(32, 2), dtype=torch.float32)
    fresh = T.init_cache(cfg, T.CacheSpec(32, 2), dtype=torch.float32)
    lengths = torch.tensor([8, 5], dtype=torch.int32)
    got, contiguous = T.prefill(params, cfg, toks, contiguous,
                                compute_dtype=torch.float32, lengths=lengths,
                                hist_len=torch.zeros(2, dtype=torch.int32))
    want, fresh = T.prefill(params, cfg, toks, fresh,
                            compute_dtype=torch.float32, lengths=lengths)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    assert contiguous["t"].tolist() == fresh["t"].tolist() == [8, 5]
    with pytest.raises(NotImplementedError, match="ragged"):
        T.prefill(params, cfg, toks, contiguous,
                  hist_len=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="block_tables"):
        T.decode_step(params, cfg, cache, toks[:, :1])


# --------------------------------------------------------------------------
# Scheduler: greedy tokens identical to the JAX scheduler
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mixed(weights):
    """Six mixed-length requests over two slots (eviction and readmission),
    uid 0 stopping at an EOS token; the JAX scheduler's completions and
    stats (contiguous, exact widths)."""
    jcfg, jparams, cfg, params = weights
    spec = _random_spec(cfg.vocab, 6, np.random.default_rng(0))
    spec[0] = (0, spec[0][1], 6, None)
    free = Scheduler(params, cfg, _scfg()).run(_port_reqs(spec))
    spec[0] = (0, spec[0][1], 6, int(free[0].tokens[2]))
    ref = JaxScheduler(jparams, jcfg, _jax_scfg())
    ref.run(_jax_reqs(spec), max_steps=300)
    return spec, ref.completions, ref.stats


@pytest.mark.parametrize("layout,page,bucket", [
    ("contiguous", 8, 1), ("contiguous", 8, 8), ("paged", 4, 1),
    ("paged", 8, 1)])
def test_scheduler_tokens_identical_to_reference(weights, mixed, layout,
                                                 page, bucket):
    _, _, cfg, params = weights
    spec, want, ref_stats = mixed
    sched = Scheduler(params, cfg, _scfg(layout=layout, page=page),
                      prefill_bucket=bucket)
    got = sched.run(_port_reqs(spec), max_steps=300)
    _same_tokens(got, want)
    assert got[0].finish_reason == "eos"
    first_finish = min(c.finish_step for c in got.values())
    assert any(c.admit_step > first_finish for c in got.values())
    if (layout, bucket) == ("contiguous", 1):
        assert sched.stats == ref_stats
    if sched.paged is not None:
        sched.paged.check_invariants()
        assert sched.engine.plan.stats["decisions"] > 0


def test_shared_prefix_tokens_and_stats_equal_reference(weights):
    jcfg, jparams, cfg, params = weights
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab, 40).astype(np.int32)
    spec = _random_spec(cfg.vocab, 6, rng, max_prompt=7, max_gen=4,
                        prefix=prefix)
    ref = JaxScheduler(jparams, jcfg, _jax_scfg(96, layout="paged"))
    want = ref.run(_jax_reqs(spec), max_steps=400)
    sp = Scheduler(params, cfg, _scfg(96, layout="paged"))
    got = sp.run(_port_reqs(spec), max_steps=400)
    sp.paged.check_invariants()
    _same_tokens(got, want)
    keys = ("prefill_calls", "prefill_widths", "prefill_width_sum",
            "prefill_tokens", "shared_prefix_tokens")
    assert {k: sp.stats[k] for k in keys} == {k: ref.stats[k] for k in keys}
    assert sp.stats["shared_prefix_tokens"] > 0
    sc = Scheduler(params, cfg, _scfg(96))
    _same_tokens(sc.run(_port_reqs(spec), max_steps=400), want)
    assert sp.stats["prefill_tokens"] < sc.stats["prefill_tokens"]


def test_mixed_history_admits_match_reference(weights):
    """The trace of tests/test_paged.py's mixed-history case: a prefix
    hit and a cold prompt admitted in one tick prefill in two calls, each
    at its own width; tokens and every stat equal the JAX scheduler's."""
    jcfg, jparams, cfg, params = weights
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, cfg.vocab, 24).astype(np.int32)
    fresh = rng.integers(0, cfg.vocab, 24).astype(np.int32)
    suffix = rng.integers(0, cfg.vocab, 4).astype(np.int32)
    spec = [(0, prefix, 2, None), (1, np.concatenate([prefix, suffix]), 2, None),
            (2, fresh, 2, None)]
    ref = JaxScheduler(jparams, jcfg, _jax_scfg(64, layout="paged"),
                       prefill_bucket=8)
    ref.run(_jax_reqs(spec[:1]), max_steps=50)
    ref.run(_jax_reqs(spec[1:]), max_steps=100)
    sp = Scheduler(params, cfg, _scfg(64, layout="paged"), prefill_bucket=8)
    sp.run(_port_reqs(spec[:1]), max_steps=50)
    calls0, wsum0 = sp.stats["prefill_calls"], sp.stats["prefill_width_sum"]
    sp.run(_port_reqs(spec[1:]), max_steps=100)
    sp.paged.check_invariants()
    _same_tokens(sp.completions, ref.completions)
    assert sp.stats == ref.stats
    assert sp.stats["prefill_calls"] - calls0 == 2
    assert sp.stats["prefill_width_sum"] - wsum0 == 8 + 24


# --------------------------------------------------------------------------
# Errors and backpressure
# --------------------------------------------------------------------------


def test_pool_exhausted_backpressure_serializes(weights):
    """A pool of exactly one slot's pages: the second request waits in
    the queue until the first frees its pages, and both complete with
    the contiguous layout's tokens."""
    _, _, cfg, params = weights
    spec = [(0, np.arange(60, dtype=np.int32) % cfg.vocab, 2, None),
            (1, np.arange(5, dtype=np.int32) % cfg.vocab, 2, None)]
    scfg = _scfg(64, layout="paged", page=4, n_pages=16)
    sched = Scheduler(params, cfg, scfg)
    got = sched.run(_port_reqs(spec), max_steps=200)
    sched.paged.check_invariants()
    assert got[1].admit_step >= got[0].finish_step
    _same_tokens(got, Scheduler(params, cfg, _scfg(64)).run(_port_reqs(spec)))


def test_pool_that_cannot_hold_a_prompt_fails_with_intent(weights):
    _, _, cfg, params = weights
    sched = Scheduler(params, cfg, _scfg(32, layout="paged", page=4))
    sched.paged = port_paged.PagedKV(batch=2, max_seq=32, page_size=4,
                                     n_pages=2)
    sched.submit(Request(uid=0, prompt=np.arange(20, dtype=np.int32),
                         max_new_tokens=2))
    with pytest.raises(RuntimeError, match="cannot hold"):
        sched.step()


def test_unported_features_raise(weights):
    """What once raised as not ported (sampling, `serve_async`,
    speculation, chunked prefill) now serves, with the JAX Scheduler's
    checks: a positive temperature needs a key, as it does there; the
    duplicate-uid and int8-cache checks stay."""
    jcfg, jparams, cfg, params = weights
    sched = Scheduler(params, cfg, _scfg())
    req = dict(uid=0, prompt=np.ones(4, np.int32), max_new_tokens=2,
               temperature=0.7)
    with pytest.raises(ValueError, match="PRNG key"):
        sched.submit(Request(**req))
    with pytest.raises(ValueError, match="PRNG key"):
        JaxScheduler(jparams, jcfg, jax_serve.ServeConfig(
            max_seq=48, batch=2, compute_dtype=jnp.float32)).submit(
                JaxRequest(**req))
    sched.submit(Request(**req, key=torch.Generator().manual_seed(0)))
    with sched.serve_async() as srv:
        fut = srv.submit(Request(uid=5, prompt=np.ones(3, np.int32),
                                 max_new_tokens=2))
        assert len(fut.result(timeout=120).tokens) == 2
    assert len(sched.completions[0].tokens) == 2
    spec = _random_spec(cfg.vocab, 3, np.random.default_rng(0))
    plain = Scheduler(params, cfg, _scfg()).run(_port_reqs(spec))
    for kw in ({"speculate_k": 2}, {"prefill_chunk": 8}):
        _same_tokens(Scheduler(params, cfg, _scfg(**kw)).run(
            _port_reqs(spec)), plain)
    # the int8 KV cache is ported: the config that raised now holds it
    assert serve.ServeConfig(max_seq=8, batch=1,
                             cache_dtype="int8").cache_dtype == torch.int8
    with pytest.raises(ValueError, match="duplicate"):
        sched.submit(Request(uid=1, prompt=np.ones(4, np.int32),
                             max_new_tokens=2))
        sched.submit(Request(uid=1, prompt=np.ones(4, np.int32),
                             max_new_tokens=2))


def test_serveconfig_paged_validation_as_in_reference():
    ok = serve.ServeConfig(max_seq=32, batch=2, cache_layout="paged",
                           page_size=8)
    ref = jax_serve.ServeConfig(max_seq=32, batch=2, cache_layout="paged",
                                page_size=8)
    assert (ok.slot_pages, ok.resolved_n_pages) == (ref.slot_pages,
                                                    ref.resolved_n_pages)
    for kw, match in (({"cache_layout": "ragged"}, "cache_layout"),
                      ({"cache_layout": "paged", "page_size": 0}, "page_size"),
                      ({"cache_layout": "paged", "page_size": 8,
                        "n_pages": 3}, "n_pages")):
        with pytest.raises(ValueError, match=match):
            serve.ServeConfig(max_seq=32, batch=2, **kw)
        with pytest.raises(ValueError, match=match):
            jax_serve.ServeConfig(max_seq=32, batch=2, **kw)


def test_generate_rejects_paged(weights):
    _, _, cfg, params = weights
    with pytest.raises(NotImplementedError, match="Scheduler"):
        serve.generate(params, cfg, _scfg(32, layout="paged"),
                       torch.zeros((2, 4), dtype=torch.int32), 2)


def test_trace_cli_on_cpu():
    """Trace mode of the launcher serves through the Scheduler and hands
    back what it served; its trace grammar is the JAX launcher's."""
    from repro.launch import serve as jax_launch

    spec = "24x8,8x4*3"
    assert launch_serve.parse_trace(spec) == jax_launch.parse_trace(spec)
    out = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--kernel-backend", "hopper", "--batch", "2",
                             "--cache-layout", "paged", "--page-size", "8",
                             "--prefill-bucket", "8", "--trace", spec])
    sched = out["scheduler"]
    assert out["requests"] == 4 and sched.paged is not None
    assert out["tokens"] == 8 + 3 * 4
    assert sched.stats["decode_steps"] == out["decode_steps"] > 0
    assert out["engine_plan"]["hits"] > 0
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--cache-layout", "paged"])
