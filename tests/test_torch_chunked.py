"""The port's chunked prefill (`transformer.prefill(hist_len=...)` on a
contiguous cache, the Scheduler's `prefill_chunk`) and async ingestion
(`Scheduler.serve_async`) against the JAX package, in f32 on the CPU, on
the four cache kinds (qwen2-1.5b, mixtral-8x7b, mamba2-780m,
recurrentgemma-2b), and gemma3-12b paged (paged "attn" blocks beside
rings that continue, in one call).

Tolerances: the chunk's logits at rtol 1e-4 / atol 1e-3 and every cache
tensor at rtol / atol 1e-5; greedy tokens identical per uid, the
Scheduler's stats equal.  Under an int8 cache the port's chunked serve
is held to the JAX package's chunked serve and its unchunked serve to
the JAX unchunked one: the JAX package's own chunked and unchunked int8
serves differ (its `test_chunked_prefill_paged_and_int8[int8]`).  Every
wait on a future has a timeout.
"""

import concurrent.futures
import dataclasses
import queue
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro_torch.models import transformer as T
from repro_torch.serve_lib import serve
from repro_torch.serve_lib.scheduler import Request, Scheduler
from test_torch_spec import (KINDS, TOL, _t, assert_caches_close,
                             assert_same_serve, jitted, run_both, run_port,
                             weights)

CHUNK = 8
WAIT_S = 120


def _prefill_both(arch, layout, toks, cache_pair, **kw):
    """One prefill call in both packages (`kw` numpy arrays, ints
    static); returns (jax logits, port logits) and updates `cache_pair`."""
    jcfg, jparams, cfg, params = weights(arch)
    jcache, cache = cache_pair
    want, jcache = jitted(JT.prefill, jcfg, jnp.asarray(toks), jcache,
                          **{k: (v if isinstance(v, int) else jnp.asarray(v))
                             for k, v in kw.items()})(jparams)
    got, cache = T.prefill(params, cfg, _t(toks), cache,
                           compute_dtype=torch.float32,
                           **{k: (v if isinstance(v, int) else _t(v))
                              for k, v in kw.items()})
    cache_pair[:] = [jcache, cache]
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("arch", KINDS + ["gemma3-12b"])
def test_prefill_hist_len_continues_the_cache_as_reference(arch):
    """Three slots streamed in chunks of 12 into a 48-row cache (gemma3:
    paged, pages of 4): a first chunk at history 0 (lengths 12, 2, 9),
    then a call mixing continuations (12 more rows after 12: a 16-row
    ring wraps inside the chunk; 3 rows after 2: shorter than the conv
    window) with a slot that starts afresh at history 0, then a third:
    the logits and every cache tensor equal the JAX package's."""
    jcfg, _, cfg, _ = weights(arch)
    layout = "paged" if arch == "gemma3-12b" else "contiguous"
    spec = {"page_size": 4, "n_pages": 36} if layout == "paged" else {}
    pair = [JT.init_cache(jcfg, JT.CacheSpec(48, 3, **spec),
                          dtype=jnp.float32),
            T.init_cache(cfg, T.CacheSpec(48, 3, **spec),
                         dtype=torch.float32)]
    rng = np.random.default_rng(3)
    calls = [(np.asarray([0, 0, 0]), np.asarray([12, 2, 9])),
             (np.asarray([12, 2, 0]), np.asarray([12, 3, 5])),
             (np.asarray([24, 5, 5]), np.asarray([7, 12, 1]))]
    for hist, lengths in calls:
        kw = {"lengths": lengths.astype(np.int32),
              "hist_len": hist.astype(np.int32)}
        if layout == "paged":
            kw["block_tables"] = np.arange(36, dtype=np.int32).reshape(3, 12)
            kw["hist_pages"] = -(-int(hist.max()) // 4)
        toks = rng.integers(0, cfg.vocab, (3, 12)).astype(np.int32)
        want, got = _prefill_both(arch, layout, toks, pair, **kw)
        np.testing.assert_allclose(got, want, **TOL)
        assert_caches_close(pair[1], pair[0])
    assert pair[1]["t"].tolist() == [31, 17, 6]


def _mix(vocab: int, seed: int, n_short: int = 3, long_len: int = 24):
    """One prompt longer than the chunk and `n_short` short ones, as the
    JAX package's chunk tests draw them: (uid, prompt, gen)."""
    rng = np.random.default_rng(seed)
    out = [(0, rng.integers(0, vocab, long_len).astype(np.int32), 6)]
    for uid in range(1, n_short + 1):
        plen = int(rng.integers(3, 8))
        out.append((uid, rng.integers(0, vocab, plen).astype(np.int32), 6))
    return out


BASE = {"max_seq": 48, "batch": 2}


@pytest.mark.parametrize("arch", KINDS)
def test_chunked_matches_reference_and_unchunked(arch):
    """A 24-token prompt streamed in chunks of 8 beside short prompts:
    tokens and stats equal the JAX Scheduler's chunked serve, and the
    tokens equal the port's unchunked serve."""
    spec = _mix(weights(arch)[2].vocab, 3)
    ref, sched = run_both(arch, spec, {**BASE, "prefill_chunk": CHUNK})
    assert_same_serve(ref, sched)
    assert CHUNK in sched.stats["prefill_widths"]
    plain = run_port(arch, spec, BASE)
    for uid, c in plain.completions.items():
        np.testing.assert_array_equal(sched.completions[uid].tokens, c.tokens)


@pytest.mark.parametrize("posture", ["paged", "int8", "paged-int8"])
def test_chunked_paged_and_int8_as_reference(posture):
    """Chunks of 8 on the paged layout (pages of 8) and under an int8
    cache: the port's chunked serve equals the JAX package's chunked
    serve, its unchunked serve the JAX unchunked one (tokens and stats);
    on a float cache chunked tokens also equal unchunked ones."""
    over = {}
    if "paged" in posture:
        over.update(cache_layout="paged", page_size=8)
    if "int8" in posture:
        over.update(cache_dtype="int8")
    spec = _mix(weights("qwen2-1.5b")[2].vocab, 4)
    check = None
    if "paged" in posture:
        check = lambda s: s.paged.check_invariants()  # noqa: E731
    ref, chunked = run_both("qwen2-1.5b", spec,
                            {**BASE, **over, "prefill_chunk": CHUNK},
                            each_tick=check)
    assert_same_serve(ref, chunked)
    ref, plain = run_both("qwen2-1.5b", spec, {**BASE, **over})
    assert_same_serve(ref, plain)
    if "int8" not in posture:
        for uid, c in plain.completions.items():
            np.testing.assert_array_equal(chunked.completions[uid].tokens,
                                          c.tokens)


def test_gemma3_paged_chunked_as_reference():
    """gemma3-12b on the paged layout with chunks of 8: its paged "attn"
    blocks continue through the gathered history pages and its rings
    through the chunk continuation, in one call per chunk; tokens and
    stats equal the JAX Scheduler's."""
    spec = _mix(weights("gemma3-12b")[2].vocab, 5, long_len=30)
    ref, sched = run_both("gemma3-12b", spec,
                          {**BASE, "cache_layout": "paged", "page_size": 8,
                           "prefill_chunk": CHUNK},
                          each_tick=lambda s: s.paged.check_invariants())
    assert_same_serve(ref, sched)
    assert sched.paged is not None and CHUNK in sched.stats["prefill_widths"]


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "recurrentgemma-2b"])
def test_chunked_with_speculation_as_reference(arch):
    """Chunks of 8 and speculate_k = 2: a slot drafts only once its prompt
    is resident; tokens and stats equal the JAX Scheduler's, and the
    tokens the port's plain serve."""
    spec = _mix(weights(arch)[2].vocab, 5)
    base = {**BASE, "max_seq": 50}
    ref, sched = run_both(arch, spec, {**base, "prefill_chunk": CHUNK,
                                       "speculate_k": 2, "draft": "self"})
    assert_same_serve(ref, sched)
    plain = run_port(arch, spec, base)
    for uid, c in plain.completions.items():
        np.testing.assert_array_equal(sched.completions[uid].tokens, c.tokens)


def _port_scfg(**kw):
    return serve.ServeConfig(**{**BASE, **kw}, compute_dtype="float32",
                             cache_dtype="float32", device="cpu",
                             kernel_backend="hopper")


def _requests(spec):
    return [Request(uid=u, prompt=p.copy(), max_new_tokens=g)
            for u, p, g in spec]


def test_chunk_width_validation_as_reference():
    """A chunk not a multiple of the prefill bucket (Scheduler) or of the
    page size (paged ServeConfig), or wider than max_seq: refused in the
    JAX package's words."""
    from repro.serve_lib import serve as jax_serve
    from repro.serve_lib.scheduler import Scheduler as JaxScheduler

    jcfg, jparams, cfg, params = weights("qwen2-1.5b")

    def message(fn):
        with pytest.raises(ValueError) as e:
            fn()
        return str(e.value)

    jbase = jax_serve.ServeConfig(**BASE, compute_dtype=jnp.float32)
    assert message(lambda: Scheduler(params, cfg, _port_scfg(prefill_chunk=6),
                                     prefill_bucket=4)) == message(
        lambda: JaxScheduler(jparams, jcfg, dataclasses.replace(
            jbase, prefill_chunk=6), prefill_bucket=4))
    for kw in ({"prefill_chunk": 12, "cache_layout": "paged",
                "page_size": 8}, {"prefill_chunk": 49}, {"prefill_chunk": 0}):
        assert message(lambda kw=kw: _port_scfg(**kw)) == message(
            lambda kw=kw: dataclasses.replace(jbase, **kw))


# --------------------------------------------------------------------------
# The async ingestion plane
# --------------------------------------------------------------------------


def test_serve_async_matches_run():
    """Futures resolve to the Completions the synchronous loop gives,
    through the chunked ingestion path; the worker enters the engine's
    scope and inference mode itself."""
    _, _, cfg, params = weights("qwen2-1.5b")
    spec = _mix(cfg.vocab, 6)
    scfg = _port_scfg(prefill_chunk=CHUNK)
    ref = Scheduler(params, cfg, scfg).run(_requests(spec), max_steps=300)
    sched = Scheduler(params, cfg, scfg)
    with sched.serve_async(max_queue=len(spec)) as srv:
        futs = {r.uid: srv.submit(r) for r in _requests(spec)}
        comps = {uid: f.result(timeout=WAIT_S) for uid, f in futs.items()}
    for uid, c in ref.items():
        np.testing.assert_array_equal(comps[uid].tokens, c.tokens)
        assert comps[uid].finish_reason == c.finish_reason
    assert not sched.n_active and not sched.queue


def test_async_backpressure_and_clean_shutdown():
    """A full bounded queue raises queue.Full under a submit timeout;
    shutdown drains accepted work and then refuses new submissions; a
    rejected request fails on its own future, not in the worker."""
    _, _, cfg, params = weights("qwen2-1.5b")
    spec = _mix(cfg.vocab, 7, n_short=1)
    reqs = _requests(spec)
    sched = Scheduler(params, cfg, _port_scfg(batch=1))
    srv = sched.serve_async(max_queue=1, start=False)
    fut0 = srv.submit(reqs[0])            # fills the queue
    with pytest.raises(queue.Full):
        srv.submit(reqs[1], timeout=0.05)
    srv.start()
    srv.shutdown(wait=True)               # drains the accepted request
    assert fut0.result(timeout=5).finish_reason == "length"
    with pytest.raises(RuntimeError, match="shutdown"):
        srv.submit(reqs[1])
    sched2 = Scheduler(params, cfg, _port_scfg(batch=1))
    with sched2.serve_async() as srv2:
        good = srv2.submit(reqs[0])
        bad = srv2.submit(Request(uid=reqs[0].uid, prompt=reqs[1].prompt,
                                  max_new_tokens=2))   # duplicate uid
        assert good.result(timeout=WAIT_S).finish_reason == "length"
        with pytest.raises(ValueError, match="duplicate"):
            bad.result(timeout=WAIT_S)


def test_a_dead_worker_fails_its_futures():
    """A step that raises fails every pending future with its error and
    stops the worker: a caller waiting on a future gets the error, not a
    hang."""
    _, _, cfg, params = weights("qwen2-1.5b")
    sched = Scheduler(params, cfg, _port_scfg())

    def broken():
        raise RuntimeError("the card fell off")

    sched.step = broken
    srv = sched.serve_async()
    futs = [srv.submit(r) for r in _requests(_mix(cfg.vocab, 8))]
    for f in futs:
        with pytest.raises(RuntimeError, match="fell off"):
            f.result(timeout=WAIT_S)
    srv._thread.join(timeout=WAIT_S)
    assert not srv._thread.is_alive()
    with pytest.raises(RuntimeError, match="died"):
        srv.submit(_requests(_mix(cfg.vocab, 9))[0])


def test_async_worker_runs_in_its_own_thread():
    """The worker thread serves while the caller's thread is outside any
    inference mode and engine scope."""
    _, _, cfg, params = weights("qwen2-1.5b")
    sched = Scheduler(params, cfg, _port_scfg())
    seen = []
    step = sched.step

    def spy():
        seen.append(threading.current_thread().name)
        return step()

    sched.step = spy
    with sched.serve_async() as srv:
        fut = srv.submit(_requests(_mix(cfg.vocab, 10, n_short=0))[0])
        assert isinstance(fut, concurrent.futures.Future)
        assert len(fut.result(timeout=WAIT_S).tokens) == 6
    assert seen and set(seen) == {"serve-async-worker"}
    assert not torch.is_inference_mode_enabled()
