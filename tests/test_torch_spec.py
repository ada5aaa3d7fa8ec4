"""The port's speculative decoding (`transformer.spec_forward`,
`spec_commit`, `verify_step`, `draft_propose`; the Scheduler's
speculative tick) against the JAX package, in f32 on the CPU, on the
four cache kinds through their serving archs:

  qwen2-1.5b         full attention (contiguous and paged)
  mixtral-8x7b       sliding-window rings (+ MoE, capacity factor 8)
  mamba2-780m        SSM (conv + SSD state)
  recurrentgemma-2b  RG-LRU (+ local rings)

and gemma3-12b (paged "attn" beside rings) at the model level.  The
weights come from the JAX `init_params` through the bridge.

Tolerances: the verify's logits at rtol 1e-4 / atol 1e-3, as the other
model tests hold logits; every cache tensor after a commit at rtol /
atol 1e-5; within the port, what keep = 0 and a propose must leave as
it was, bit for bit; greedy tokens identical per uid and the
Scheduler's stats equal to the JAX Scheduler's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro.serve_lib import serve as jax_serve
from repro.serve_lib.scheduler import Request as JaxRequest
from repro.serve_lib.scheduler import Scheduler as JaxScheduler
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.serve_lib import serve
from repro_torch.serve_lib.scheduler import Request, Scheduler

KINDS = ["qwen2-1.5b", "mixtral-8x7b", "mamba2-780m", "recurrentgemma-2b"]
TOL = {"rtol": 1e-4, "atol": 1e-3}
CACHE_TOL = {"rtol": 1e-5, "atol": 1e-5}
#: (arch, layout) of the model-level cases
MODEL_CASES = [(a, "contiguous") for a in KINDS] + [
    ("qwen2-1.5b", "paged"), ("gemma3-12b", "paged")]
B, MAX_SEQ, PAGE, W = 3, 48, 8, 4


def _t(x):
    return torch.from_numpy(np.array(x))


def _moe_cf(cfg):
    """Capacity factor 8: no token dropped, whatever the call's width."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))


_WEIGHTS = {}


def weights(arch: str, seed: int = 0):
    """(jax cfg, jax params, port cfg, port params) from PRNGKey(seed)."""
    if (arch, seed) not in _WEIGHTS:
        jcfg = _moe_cf(jax_get_config(arch, smoke=True))
        jparams = JT.init_params(jax.random.PRNGKey(seed), jcfg)
        _WEIGHTS[arch, seed] = (
            jcfg, jparams, _moe_cf(get_config(arch, smoke=True)),
            params_from_numpy(jax.tree.map(np.asarray, jparams),
                              device="cpu"))
    return _WEIGHTS[arch, seed]


def jitted(fn, jcfg, *args, **kw):
    """`fn(params, jcfg, *args, **kw)` of the JAX package under one
    `jax.jit` (much quicker on the CPU than its op-by-op eager form);
    int arguments (static: counts, page numbers) close over the call."""
    static = {k: v for k, v in kw.items() if isinstance(v, int)}
    traced = {k: v for k, v in kw.items() if not isinstance(v, int)}
    fixed = {i: a for i, a in enumerate(args) if isinstance(a, int)}
    rest = [a for a in args if not isinstance(a, int)]

    def body(p, a, t):
        it = iter(a)
        full = [fixed[i] if i in fixed else next(it) for i in range(len(args))]
        return fn(p, jcfg, *full, compute_dtype=jnp.float32, **t, **static)

    call = jax.jit(body)
    return lambda params: call(params, rest, traced)


def cache_leaves(cache) -> list:
    """Every leaf of a cache (either package's) in one order, as f32
    numpy: the clock, then each block's leaves by name."""
    out = [cache["t"]]
    for name in sorted(cache["slots"]):
        out += [cache["slots"][name][k] for k in sorted(cache["slots"][name])]
    for c in cache["tail"]:
        out += [c[k] for k in sorted(c)]
    return [x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32) for x in out]


def assert_caches_close(mine, ref, tol=CACHE_TOL):
    got, want = cache_leaves(mine), cache_leaves(ref)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        assert a.shape == b.shape, i
        np.testing.assert_allclose(a, b, **tol, err_msg=f"leaf {i}")


def _prefilled(arch: str, layout: str):
    """Both packages' caches after one ragged prefill of 3 slots (20, 7
    and 13 tokens: past the 16-row rings), with the block tables of a
    paged layout: slot i owns pages i * 6 .. i * 6 + 5."""
    jcfg, jparams, cfg, params = weights(arch)
    spec = ({"page_size": PAGE, "n_pages": 3 * MAX_SEQ // PAGE}
            if layout == "paged" else {})
    jcache = JT.init_cache(jcfg, JT.CacheSpec(MAX_SEQ, B, **spec),
                           dtype=jnp.float32)
    cache = T.init_cache(cfg, T.CacheSpec(MAX_SEQ, B, **spec),
                         dtype=torch.float32)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (B, 20)).astype(np.int32)
    kw = {"lengths": np.asarray([20, 7, 13], np.int32)}
    if layout == "paged":
        kw["block_tables"] = np.arange(3 * MAX_SEQ // PAGE,
                                       dtype=np.int32).reshape(B, -1)
        kw["hist_len"] = np.zeros(B, np.int32)
    _, jcache = jitted(JT.prefill, jcfg, jnp.asarray(toks), jcache,
                       **{k: jnp.asarray(v) for k, v in kw.items()})(jparams)
    _, cache = T.prefill(params, cfg, _t(toks), cache,
                         compute_dtype=torch.float32,
                         **{k: _t(v) for k, v in kw.items()})
    bt = kw.get("block_tables")
    verify = rng.integers(0, cfg.vocab, (B, W)).astype(np.int32)
    return jcache, cache, bt, verify


def _spec_kw(bt, active, jax_side: bool):
    arr = jnp.asarray if jax_side else _t
    kw = {"active": arr(active)}
    if bt is not None:
        kw["block_tables"] = arr(bt)
    return kw


_VERIFIED = {}


def verified(arch: str, layout: str) -> dict:
    """One W = 4 verify pass over a live cache in both packages, slot 1
    inactive, then commits keeping 0, 1 and W tokens: the logits, the
    committed caches, and the port's slot 0 (keep 0) before and after."""
    if (arch, layout) not in _VERIFIED:
        jcfg, jparams, cfg, params = weights(arch)
        jcache, cache, bt, verify = _prefilled(arch, layout)
        active = np.asarray([True, False, True])
        keep = np.asarray([0, 1, W], np.int32)

        def jax_side(p, c):
            logits, spec, undo = JT.spec_forward(
                p, jcfg, c, jnp.asarray(verify), compute_dtype=jnp.float32,
                **_spec_kw(bt, active, True))
            return logits, JT.spec_commit(jcfg, spec, undo, jnp.asarray(keep))

        want_logits, want = jax.jit(jax_side)(jparams, jcache)
        before = _live(arch, cache, bt, 0)
        got_logits, spec, undo = T.spec_forward(
            params, cfg, cache, _t(verify), compute_dtype=torch.float32,
            **_spec_kw(bt, active, False))
        clock = spec["t"].clone()
        got = T.spec_commit(cfg, spec, undo, _t(keep))
        _VERIFIED[arch, layout] = {
            "active": active, "keep": keep, "clock": clock,
            "want_logits": np.asarray(want_logits), "want": want,
            "got_logits": got_logits.numpy(), "got": got, "before": before,
            "after": _live(arch, got, bt, 0)}
    return _VERIFIED[arch, layout]


@pytest.mark.parametrize("arch,layout", MODEL_CASES)
def test_spec_forward_logits_match_reference(arch, layout):
    """One W = 4 verify pass over a live cache, slot 1 inactive: the
    active slots' (W, V) logits equal the JAX package's."""
    run = verified(arch, layout)
    active, got = run["active"], run["got_logits"]
    assert got.shape == (B, W, weights(arch)[2].vocab)
    np.testing.assert_allclose(got[active], run["want_logits"][active], **TOL)


def _live(arch, cache, bt, slot: int) -> list:
    """What a commit with keep = 0 must leave as it was in `slot`: its
    attention rows below the clock (on a paged layout, read through its
    block table), its whole rings and its recurrent state."""
    cfg = weights(arch)[2]
    t = int(cache["t"][slot])
    out = []
    for kind, c in T._blocks(cfg, cache["slots"], cache["tail"]):
        if "k_pages" in c:
            pages = torch.from_numpy(bt[slot]).long()
            out += [c[n][pages].reshape(-1, *c[n].shape[2:])[:t].clone()
                    for n in ("k_pages", "v_pages")]
        elif kind == "attn":
            out += [c[n][slot, :t].clone() for n in ("k", "v")]
        else:
            out += [v[slot].clone() for v in c.values()]
    return out


@pytest.mark.parametrize("arch,layout", MODEL_CASES)
def test_spec_commit_matches_reference(arch, layout):
    """The verify pass's commits keeping 0 (slot 0), 1 (slot 1, inactive
    in the pass) and W (slot 2) tokens: every cache tensor (clock, rows,
    rings, states, the rows the pass wrote past the clocks) equals the
    JAX package's, and slot 0 is left as it was, bit for bit, where its
    live state lies."""
    run = verified(arch, layout)
    assert run["got"]["t"].tolist() == (run["clock"]
                                        + _t(run["keep"])).tolist()
    assert_caches_close(run["got"], run["want"])
    for a, b in zip(run["before"], run["after"], strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", KINDS + ["gemma3-12b"])
def test_draft_propose_matches_reference_and_leaves_the_cache(arch):
    """Three greedy drafts from a live contiguous cache with slot 1
    inactive: the JAX package's drafts, and every cache tensor after the
    propose bit for bit what it was before."""
    jcfg, jparams, cfg, params = weights(arch)
    jcache, cache, _, verify = _prefilled(arch, "contiguous")
    active = np.asarray([True, False, True])
    before = [torch.from_numpy(x.copy()) for x in cache_leaves(cache)]
    want = jitted(JT.draft_propose, jcfg, jcache, jnp.asarray(verify[:, 0]),
                  3, active=jnp.asarray(active))(jparams)
    got = T.draft_propose(params, cfg, cache, _t(verify[:, 0]), 3,
                          compute_dtype=torch.float32, active=_t(active))
    np.testing.assert_array_equal(got.numpy()[active],
                                  np.asarray(want)[active])
    for a, b in zip(before, cache_leaves(cache), strict=True):
        assert torch.equal(a, torch.from_numpy(b))


def test_verify_step_accepts_the_greedy_prefix():
    """verify_step's (g, n_acc) and committed clock equal the JAX
    package's, with slot 1 inactive (keep 0)."""
    jcfg, jparams, cfg, params = weights("qwen2-1.5b")
    jcache, cache, _, verify = _prefilled("qwen2-1.5b", "contiguous")
    active = np.asarray([True, False, True])
    # a verify window whose drafts are the target's own greedy tokens on
    # slot 0: all accepted there
    greedy = T.draft_propose(params, cfg, cache, _t(verify[:, 0]), W - 1,
                             compute_dtype=torch.float32).numpy()
    verify[0, 1:] = greedy[0]
    jg, jn, jc = jitted(JT.verify_step, jcfg, jcache, jnp.asarray(verify),
                        active=jnp.asarray(active))(jparams)
    g, n, c = T.verify_step(params, cfg, cache, _t(verify),
                            compute_dtype=torch.float32, active=_t(active))
    np.testing.assert_array_equal(g.numpy()[active], np.asarray(jg)[active])
    assert n.tolist() == np.asarray(jn).tolist() and n.tolist()[0] == W - 1
    assert c["t"].tolist() == np.asarray(jc["t"]).tolist()


# --------------------------------------------------------------------------
# The Scheduler's speculative tick against the JAX Scheduler
# --------------------------------------------------------------------------


def requests(vocab: int, n: int, seed: int, max_prompt: int = 16,
             max_gen: int = 8) -> list[tuple]:
    """(uid, prompt, gen) of n requests, as the JAX package's spec tests
    draw them."""
    rng = np.random.default_rng(seed)
    out = []
    for uid in range(n):
        plen = int(rng.integers(3, max_prompt))
        gen = int(rng.integers(2, max_gen + 1))
        out.append((uid, rng.integers(0, vocab, plen).astype(np.int32), gen))
    return out


def run_both(arch, spec, scfg_kw: dict, *, draft_seed=None,
             each_tick=None, prefill_bucket: int = 8):
    """Serve `spec` through the JAX Scheduler and the port's with the same
    configuration; returns (jax Scheduler, port Scheduler)."""
    jcfg, jparams, _, _ = weights(arch)
    jkw = {}
    if draft_seed is not None:
        djcfg, djparams, _, _ = weights(arch, draft_seed)
        jkw = {"draft_params": djparams, "draft_cfg": djcfg}
    jax_kw = {k: (getattr(jnp, v) if k == "cache_dtype" else v)
              for k, v in scfg_kw.items()}
    ref = JaxScheduler(jparams, jcfg, jax_serve.ServeConfig(
        compute_dtype=jnp.float32, **{"cache_dtype": jnp.float32, **jax_kw}),
        prefill_bucket=prefill_bucket, **jkw)
    ref.run([JaxRequest(uid=u, prompt=p.copy(), max_new_tokens=g)
             for u, p, g in spec], max_steps=300)
    return ref, run_port(arch, spec, scfg_kw, draft_seed=draft_seed,
                         each_tick=each_tick, prefill_bucket=prefill_bucket)


def run_port(arch, spec, scfg_kw: dict, *, draft_seed=None, each_tick=None,
             prefill_bucket: int = 8) -> Scheduler:
    """Serve `spec` through the port's Scheduler on the CPU, calling
    `each_tick(sched)` after every tick."""
    _, _, cfg, params = weights(arch)
    kw = {}
    if draft_seed is not None:
        _, _, dcfg, dparams = weights(arch, draft_seed)
        kw = {"draft_params": dparams, "draft_cfg": dcfg}
    sched = Scheduler(params, cfg, serve.ServeConfig(
        compute_dtype="float32", kernel_backend="hopper", device="cpu",
        **{"cache_dtype": "float32", **scfg_kw}),
        prefill_bucket=prefill_bucket, **kw)
    for u, p, g in spec:
        sched.submit(Request(uid=u, prompt=p.copy(), max_new_tokens=g))
    steps = 0
    while sched.queue or sched.n_active:
        sched.step()
        if each_tick is not None:
            each_tick(sched)
        steps += 1
        assert steps < 300, "the port's Scheduler did not drain"
    return sched


def assert_same_serve(ref, sched):
    assert sorted(sched.completions) == sorted(ref.completions)
    for uid, c in ref.completions.items():
        np.testing.assert_array_equal(sched.completions[uid].tokens, c.tokens,
                                      err_msg=f"uid={uid}")
        assert sched.completions[uid].finish_reason == c.finish_reason
    assert sched.stats == ref.stats


SPEC = {"max_seq": MAX_SEQ, "batch": 2, "speculate_k": 3, "draft": "self"}


@pytest.mark.parametrize("arch", KINDS)
def test_self_draft_matches_reference(arch):
    """The target drafting for itself: tokens per uid and stats equal to
    the JAX Scheduler's, every draft accepted."""
    spec = requests(weights(arch)[2].vocab, 4, 0)
    ref, sched = run_both(arch, spec, SPEC)
    assert_same_serve(ref, sched)
    st = sched.stats
    assert st["spec_ticks"] > 0
    assert st["accepted_draft_tokens"] == st["draft_tokens"] > 0


@pytest.mark.parametrize("arch", KINDS)
def test_disagreeing_draft_matches_reference(arch):
    """A draft with other weights (PRNGKey(7)): most drafts are rejected,
    so nearly every tick rolls back (ring rows, recurrent stash, clock);
    tokens and stats equal the JAX Scheduler's."""
    spec = requests(weights(arch)[2].vocab, 3, 1)
    ref, sched = run_both(arch, spec, SPEC, draft_seed=7)
    assert_same_serve(ref, sched)
    assert (sched.stats["accepted_draft_tokens"]
            < sched.stats["draft_tokens"])


@pytest.mark.parametrize("k", [1, 4])
def test_paged_int8_matches_reference(k):
    """Speculation over the paged int8 cache: the verify writes k rows
    past the frontier, rejection releases the pages it emptied
    (`PagedKV.rollback`), the page accounting holds after every tick."""
    spec = requests(weights("qwen2-1.5b")[2].vocab, 4, 0)
    ref, sched = run_both(
        "qwen2-1.5b", spec,
        {"max_seq": MAX_SEQ, "batch": 2, "cache_dtype": "int8",
         "cache_layout": "paged", "page_size": PAGE, "speculate_k": k,
         "draft": "self"},
        each_tick=lambda s: s.paged.check_invariants())
    assert_same_serve(ref, sched)


def test_self_int8_draft_matches_reference():
    """draft="self-int8": the target's int8 copy drafts (its weights
    dequantized every call under the float engine, as in the JAX
    package); the float target verifies."""
    spec = requests(weights("qwen2-1.5b")[2].vocab, 3, 2)
    ref, sched = run_both("qwen2-1.5b", spec, {**SPEC, "draft": "self-int8"})
    assert_same_serve(ref, sched)


def _message(fn, kind):
    with pytest.raises(kind) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("kw", [{"speculate_k": -1}, {"draft": "self"},
                                {"speculate_k": 2, "draft": "gpt-tiny"}])
def test_config_validation_as_reference(kw):
    want = _message(lambda: jax_serve.ServeConfig(max_seq=32, batch=2, **kw),
                    ValueError)
    assert _message(lambda: serve.ServeConfig(max_seq=32, batch=2, **kw),
                    ValueError) == want


def test_scheduler_validation_as_reference():
    """Sampling and a budget without k rows of headroom are refused at
    submit, a verify wider than the ring and a draft without its config
    or without speculate_k at construction: the JAX package's errors, in
    its words where they name no library."""
    jcfg, jparams, cfg, params = weights("qwen2-1.5b")
    scfg = serve.ServeConfig(max_seq=32, batch=2, compute_dtype="float32",
                             cache_dtype="float32", device="cpu",
                             speculate_k=3, draft="self")
    jscfg = jax_serve.ServeConfig(max_seq=32, batch=2,
                                  compute_dtype=jnp.float32,
                                  cache_dtype=jnp.float32, speculate_k=3,
                                  draft="self")
    sched, ref = Scheduler(params, cfg, scfg), JaxScheduler(jparams, jcfg,
                                                            jscfg)
    with pytest.raises(ValueError, match="greedy"):
        sched.submit(Request(uid=0, prompt=np.zeros(4, np.int32),
                             max_new_tokens=2, temperature=0.5,
                             key=torch.Generator().manual_seed(0)))
    long = dict(uid=1, prompt=np.zeros(20, np.int32), max_new_tokens=10)
    assert _message(lambda: sched.submit(Request(**long)), ValueError) == \
        _message(lambda: ref.submit(JaxRequest(**long)), ValueError)
    base = dataclasses.replace(scfg, speculate_k=0, draft=None)
    jbase = dataclasses.replace(jscfg, speculate_k=0, draft=None)
    for port, want in (
            (lambda: Scheduler(params, cfg, scfg, draft_params=params),
             lambda: JaxScheduler(jparams, jcfg, jscfg,
                                  draft_params=jparams)),
            (lambda: Scheduler(params, cfg, base, draft_params=params,
                               draft_cfg=cfg),
             lambda: JaxScheduler(jparams, jcfg, jbase, draft_params=jparams,
                                  draft_cfg=jcfg))):
        assert _message(port, ValueError) == _message(want, ValueError)
    rj, _, rcfg, rparams = weights("recurrentgemma-2b")
    wide = dataclasses.replace(scfg, max_seq=48, speculate_k=16)
    jwide = dataclasses.replace(jscfg, max_seq=48, speculate_k=16)
    assert _message(lambda: Scheduler(rparams, rcfg, wide), ValueError) == \
        _message(lambda: JaxScheduler(weights("recurrentgemma-2b")[1], rj,
                                      jwide), ValueError)


def test_cached_attention_per_query_lengths_and_exclude_as_reference():
    """`layers.cached_attention` with a (B, Sq) per-query valid length and
    an (B, Sq, Smax) `exclude` mask, on a float and an int8 cache (rows
    with their scales): the JAX package's output at rtol 1e-5 / atol
    1e-5."""
    from repro.models import layers as JL
    from repro.quant import kv_quantize as jax_kv_quantize
    from repro_torch.models import layers

    jcfg, jparams, cfg, params = weights("qwen2-1.5b")
    rng = np.random.default_rng(11)
    b, sq, smax = 3, 4, 12
    q = rng.standard_normal((b, sq, cfg.n_heads, cfg.head_dim_)).astype(
        np.float32)
    k = rng.standard_normal((b, smax, cfg.n_kv, cfg.head_dim_)).astype(
        np.float32)
    v = rng.standard_normal((b, smax, cfg.n_kv, cfg.head_dim_)).astype(
        np.float32)
    kv_len = np.asarray([[5, 6, 7, 8], [1, 2, 3, 4], [9, 10, 11, 12]],
                        np.int32)
    exclude = rng.random((b, sq, smax)) < 0.2
    exclude[:, :, 0] = False                    # every query sees a row
    jp = jax.tree.map(lambda a: a[0], jparams["stack"]["b0"]["attn"])
    p = {n: {"w": params["stack"]["b0"]["attn"][n]["w"][0]}
         for n in ("wo",)}
    pos = kv_len - 1
    for quantized in (False, True):
        jkw, kw = {}, {}
        jk, jv, tk, tv = jnp.asarray(k), jnp.asarray(v), _t(k), _t(v)
        if quantized:
            (jk, ks), (jv, vs) = jax_kv_quantize(jk), jax_kv_quantize(jv)
            jkw = {"k_scale": ks, "v_scale": vs}
            tk, tv = _t(np.asarray(jk)), _t(np.asarray(jv))
            kw = {"k_scale": _t(np.asarray(ks)), "v_scale": _t(np.asarray(vs))}
        want = JL.cached_attention(jp, jcfg, jnp.asarray(q), jk, jv,
                                   jnp.asarray(pos), jnp.asarray(kv_len),
                                   exclude=jnp.asarray(exclude), **jkw)
        got = layers.cached_attention(p, cfg, _t(q), tk, tv, _t(pos),
                                      _t(kv_len), exclude=_t(exclude), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
