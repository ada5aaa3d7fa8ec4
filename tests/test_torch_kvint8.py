"""The port's int8 KV cache (the per-row codec in both cache layouts, the
scale-aware decode attention, the int8-pool paged attention, the
cache-dtype validator and the launcher's `--quantize`) against the JAX
package, on the CPU.

Inputs are drawn with numpy and handed to both packages; the SMOKE
weights are the JAX `init_params` tree carried across by the bridge.
Tolerances: the plain paged version and `cached_attention` rtol = atol =
2e-5 (as tests/test_paged.py holds the Pallas kernel to its reference);
the cache writes bit for bit (the same f32 codec in the same order);
greedy tokens identical per uid at f32 (as the reference's own int8
parity test pins them).  The JAX cache writes run inside `jax.jit`, as
its serving paths run them, where XLA computes a scale as
`amax * f32(1/127)`; the port writes the cache in that form.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jax_engine
from repro.configs import get_config as jax_get_config
from repro.kernels.paged_attention import (paged_attention_reference as
                                           jax_paged_reference,
                                           paged_attention_tpu)
from repro.models import layers as jax_layers
from repro.models import transformer as JT
from repro.quant import quantize_params as jax_quantize_params
from repro.serve_lib import serve as jax_serve
from repro.serve_lib.scheduler import Request as JaxRequest
from repro.serve_lib.scheduler import Scheduler as JaxScheduler
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.engine import Engine
from repro_torch.kernels import paged_attention
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers
from repro_torch.models import transformer as T
from repro_torch.quant import QuantizedTensor, quantize_params
from repro_torch.serve_lib import serve
from repro_torch.serve_lib.scheduler import Request, Scheduler

ARCH = "qwen2-1.5b"
TOL = {"rtol": 2e-5, "atol": 2e-5}


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# --------------------------------------------------------------------------
# (a) the plain paged version with scales
# --------------------------------------------------------------------------


def _int8_paged_case():
    """tests/test_paged.py::test_paged_kernel_matches_reference's int8
    case: b 3, h 4, kv 2, d 16, page 8, 5-entry tables with holes over a
    32-page pool, kv_len [1, 17, 37], scales from U(1e-3, 2e-2)."""
    rng = np.random.default_rng(0)
    b, h, kv, d, page, n_bt, n_pool = 3, 4, 2, 16, 8, 5, 32
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    lens = np.asarray([1, 17, 37], np.int32)
    bt = np.full((b, n_bt), -1, np.int32)
    perm = rng.permutation(n_pool)
    ptr = 0
    for i in range(b):
        need = -(-int(lens[i]) // page)
        bt[i, :need] = perm[ptr:ptr + need]
        ptr += need
    rng.normal(size=(2, n_pool, page, kv, d))      # the float case's pools
    k8 = rng.integers(-127, 128, (n_pool, page, kv, d)).astype(np.int8)
    v8 = rng.integers(-127, 128, (n_pool, page, kv, d)).astype(np.int8)
    ks = rng.uniform(1e-3, 2e-2, (n_pool, page, kv)).astype(np.float32)
    vs = rng.uniform(1e-3, 2e-2, (n_pool, page, kv)).astype(np.float32)
    return q, k8, v8, bt, lens, ks, vs


@pytest.mark.parametrize("against", ["reference", "pallas_interpret"])
def test_paged_plain_version_with_scales_matches_jax(against):
    q, k8, v8, bt, lens, ks, vs = _int8_paged_case()
    j = [jnp.asarray(x) for x in (q, k8, v8, bt, lens, ks, vs)]
    if against == "reference":
        want = jax_paged_reference(*j[:5], k_scale=j[5], v_scale=j[6])
    else:
        want = paged_attention_tpu(*j, interpret=True)
    got = paged_attention.paged_attention_reference(*_t(q, k8, v8, bt, lens,
                                                        ks, vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the wrapper takes the plain version on CPU tensors, and counts nothing
    paged_attention.reset_launches()
    wrapped = paged_attention.paged_attention(*_t(q, k8, v8, bt, lens, ks, vs))
    assert torch.equal(wrapped, got) and paged_attention.launches == 0


def test_paged_scales_fold_as_dequantized_rows_attend():
    """Distinct per-row scales: folding them into the scores and the
    softmax weights gives attention over the dequantized rows (up to f32
    rounding, the scales being constant along D); the softmax denominator
    stays the unscaled one; kv_len 0 writes exact zeros."""
    q, k8, v8, bt, lens, ks, vs = _t(*_int8_paged_case())
    lens = torch.tensor([0, 17, 37], dtype=torch.int32)
    got = paged_attention.paged_attention_reference(q, k8, v8, bt, lens,
                                                    ks, vs)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    deq = lambda x, s: x.float() * s[..., None]
    plain = paged_attention.paged_attention_reference(
        q, deq(k8, ks), deq(v8, vs), bt, lens)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("backend", ["hopper", "torch-ref-int8"])
def test_engine_plans_int8_pools_apart_from_float_pools(backend):
    """Int8 pools take a memo key of their own (the pools' dtype is in the
    key, as the reference's `k_pages.aval` is) and plan at q's width, 1 on
    an int8 backend; a second pass plans nothing new."""
    q, k8, v8, bt, lens, ks, vs = _int8_paged_case()
    kf, vf = k8.astype(np.float32), v8.astype(np.float32)
    jax_backend = {"hopper": "xla-einsum",
                   "torch-ref-int8": "xla-int8"}[backend]
    jeng, teng = jax_engine.Engine(backend=jax_backend), Engine(backend=backend)
    for _ in range(2):
        jeng.paged_attention(*(jnp.asarray(x) for x in (q, kf, vf, bt, lens)))
        jeng.paged_attention(*(jnp.asarray(x) for x in (q, k8, v8, bt, lens)),
                             k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        teng.paged_attention(*_t(q, kf, vf, bt, lens))
        got = teng.paged_attention(*_t(q, k8, v8, bt, lens),
                                   k_scale=torch.from_numpy(ks),
                                   v_scale=torch.from_numpy(vs))
    want = jax_paged_reference(*(jnp.asarray(x) for x in (q, k8, v8, bt,
                                                           lens)),
                               k_scale=jnp.asarray(ks),
                               v_scale=jnp.asarray(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert teng.plan.stats == jeng.plan.stats
    # two memo keys (float and int8 pools) over one request shape: the
    # second key finds the first's decision in the plan
    assert len(teng._memo) == len(jeng._memo) == 2
    assert (teng.plan.stats["decisions"], teng.plan.misses) == (1, 1)
    assert ({req.in_bytes for req, _ in teng.plan}
            == {req.in_bytes for req, _ in jeng.plan})


# --------------------------------------------------------------------------
# (b) cached_attention with scales
# --------------------------------------------------------------------------


def test_cached_attention_with_scales_matches_jax():
    cfg, jcfg = get_config(ARCH, smoke=True), jax_get_config(ARCH, smoke=True)
    rng = np.random.default_rng(3)
    b, s, h, kv, d = 3, 12, cfg.n_heads, cfg.n_kv, cfg.head_dim_
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    k8, v8 = (rng.integers(-127, 128, (b, s, kv, d)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(1e-3, 2e-2, (b, s, kv)).astype(np.float32)
              for _ in range(2))
    wo = (rng.normal(size=(h * d, cfg.d_model)) / np.sqrt(h * d)).astype(
        np.float32)
    lens = np.asarray([1, 7, 12], np.int32)
    pos = (lens - 1)[:, None]
    want = jax_layers.cached_attention(
        {"wo": {"w": jnp.asarray(wo)}}, jcfg, *(jnp.asarray(x) for x in
                                                 (q, k8, v8, pos, lens)),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    tq, tk, tv, tpos, tlen, tks, tvs = _t(q, k8, v8, pos, lens, ks, vs)
    got = layers.cached_attention({"wo": {"w": torch.from_numpy(wo)}}, cfg,
                                  tq, tk, tv, tpos, tlen, k_scale=tks,
                                  v_scale=tvs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --------------------------------------------------------------------------
# (c) the int8 cache leaves
# --------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_init_cache_int8_leaves_match_jax(layout):
    cfg, jcfg = get_config(ARCH, smoke=True), jax_get_config(ARCH, smoke=True)
    kw = {"page_size": 4, "n_pages": 9} if layout == "paged" else {}
    jc = JT.init_cache(jcfg, JT.CacheSpec(20, 3, **kw), dtype=jnp.int8)
    tc = T.init_cache(cfg, T.CacheSpec(20, 3, **kw), dtype=torch.int8)
    for name, leaf in jc["slots"]["b0"].items():
        mine = tc["slots"]["b0"][name]
        assert tuple(mine.shape) == leaf.shape, name
        assert str(mine.dtype).removeprefix("torch.") == leaf.dtype.name, name
    want = {"k", "v", "k_scale", "v_scale"} if layout == "contiguous" else {
        "k_pages", "v_pages", "k_scale_pages", "v_scale_pages"}
    assert set(tc["slots"]["b0"]) == set(jc["slots"]["b0"]) == want


def test_paged_slot_update_takes_the_scale_pools_with_their_sink():
    cfg = get_config(ARCH, smoke=True)
    c = T.init_cache(cfg, T.CacheSpec(20, 2, page_size=4, n_pages=5),
                     dtype=torch.int8)["slots"]["b0"]
    pool = c["k_scale_pages"][0]                        # (5, 4, KV)
    assert pool.is_contiguous()
    assert pool.untyped_storage().nbytes() >= 2 * 6 * pool[0].nbytes
    new = torch.tensor([[1.5, 2.5], [3.5, 4.5]])
    # page 2 is written; page -1 and page 5 (past the pool) go to the sink
    layers.paged_slot_update(pool, torch.tensor([2, -1]),
                             torch.tensor([1, 0]), new)
    layers.paged_slot_update(pool, torch.tensor([5]), torch.tensor([3]),
                             new[:1])
    assert torch.equal(pool[2, 1], new[0])
    assert int((pool != 0).sum()) == 2
    with pytest.raises(ValueError, match="sink"):
        layers.paged_slot_update(torch.zeros(5, 4, 2), torch.tensor([0]),
                                 torch.tensor([0]), new[:1])


# --------------------------------------------------------------------------
# (d) the codec writes, bit for bit, fed the same k/v
# --------------------------------------------------------------------------

MAX_SEQ = 24


def _kv_tables():
    """q, k, v rows by absolute position (MAX_SEQ, heads, D): magnitudes
    from 1e-3 to 1e2 across rows, and an all-zero k row (scale 1.0)."""
    cfg = get_config(ARCH, smoke=True)
    rng = np.random.default_rng(11)
    tabs = []
    for heads in (cfg.n_heads, cfg.n_kv, cfg.n_kv):
        x = rng.normal(size=(MAX_SEQ, heads, cfg.head_dim_))
        x *= np.exp(rng.uniform(-7, 4.6, size=(MAX_SEQ, heads, 1)))
        tabs.append(x.astype(np.float32))
    tabs[1][3] = 0.0
    return tabs


def _fake_qkv(tabs, framework):
    """An `attn_qkv` that returns the tables' rows at `positions`.  It
    adds 0 * x (exact for finite x) so that under `jax.jit` the rows stay
    data-dependent and XLA cannot fold the codec into constants."""
    if framework == "jax":
        jtabs = [jnp.asarray(t) for t in tabs]

        def fake(p, cfg, x, positions):
            zero = (x[..., :1] * 0.0)[..., None]
            return tuple(t[positions] + zero for t in jtabs)
    else:
        ttabs = [torch.from_numpy(t) for t in tabs]

        def fake(p, cfg, x, positions):
            zero = (x[..., :1] * 0.0)[..., None]
            return tuple(t[positions.long()] + zero for t in ttabs)
    return fake


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_get_config(ARCH, smoke=True)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jcfg, jparams, get_config(ARCH, smoke=True), params


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_codec_writes_bitwise_equal_jax(weights, monkeypatch, layout):
    """One ragged prefill and two masked decode steps, the same k/v rows
    fed to both packages: int8 rows and f32 scales bit for bit equal."""
    jcfg, jparams, cfg, params = weights
    tabs = _kv_tables()
    monkeypatch.setattr(jax_layers, "attn_qkv", _fake_qkv(tabs, "jax"))
    monkeypatch.setattr(layers, "attn_qkv", _fake_qkv(tabs, "torch"))
    b, s = 3, 10
    tokens = np.random.default_rng(12).integers(0, cfg.vocab, (b, s)).astype(
        np.int32)
    lens = np.asarray([10, 4, 7], np.int32)
    kw = {}
    if layout == "paged":
        kw = {"page_size": 4, "n_pages": 20}
        bt = np.asarray([[3, 7, 1, 12, -1, -1], [5, 0, 18, -1, -1, -1],
                         [9, 2, 11, 4, -1, -1]], np.int32)
    spec_j, spec_t = JT.CacheSpec(MAX_SEQ, b, **kw), T.CacheSpec(MAX_SEQ, b,
                                                                  **kw)
    jbt = {"block_tables": jnp.asarray(bt)} if kw else {}
    tbt = {"block_tables": torch.from_numpy(bt)} if kw else {}

    jprefill = jax.jit(lambda p, tok, c, ln: JT.prefill(
        p, jcfg, tok, c, compute_dtype=jnp.float32, lengths=ln, **jbt))
    jdecode = jax.jit(lambda p, c, tok, act: JT.decode_step(
        p, jcfg, c, tok, compute_dtype=jnp.float32, active=act, **jbt))
    jc = JT.init_cache(jcfg, spec_j, dtype=jnp.int8)
    _, jc = jprefill(jparams, jnp.asarray(tokens), jc, jnp.asarray(lens))
    tc = T.init_cache(cfg, spec_t, dtype=torch.int8)
    with torch.inference_mode():
        _, tc = T.prefill(params, cfg, torch.from_numpy(tokens), tc,
                          compute_dtype=torch.float32,
                          lengths=torch.from_numpy(lens), **tbt)
        for step, act in enumerate(([True, True, True], [True, False, True])):
            tok = tokens[:, step:step + 1]
            _, jc = jdecode(jparams, jc, jnp.asarray(tok), jnp.asarray(act))
            _, tc = T.decode_step(params, cfg, tc, torch.from_numpy(tok),
                                  compute_dtype=torch.float32,
                                  active=torch.tensor(act), **tbt)
    np.testing.assert_array_equal(tc["t"].numpy(), np.asarray(jc["t"]))
    for name, want in jc["slots"]["b0"].items():
        got = tc["slots"]["b0"][name].numpy()
        assert got.dtype == np.asarray(want).dtype, name
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)
    scale = "k_scale_pages" if kw else "k_scale"
    assert np.any(tc["slots"]["b0"][scale].numpy() == 1.0)   # the zero row
    assert len(np.unique(tc["slots"]["b0"][scale].numpy())) > 20


# --------------------------------------------------------------------------
# (e) greedy tokens under the full posture and under an int8 cache alone
# --------------------------------------------------------------------------

#: 8 requests, four with a two-page shared prefix (pages of 4)
PREFIX = np.random.default_rng(5).integers(0, 128, 8).astype(np.int32)


def _trace(vocab):
    rng = np.random.default_rng(6)
    out = []
    for uid in range(8):
        tail = rng.integers(0, vocab, 3 + uid).astype(np.int32)
        prompt = np.concatenate([PREFIX, tail]) if uid % 2 else tail
        out.append((uid, prompt, 3 + uid % 4))
    return out


def _max_seq(vocab):
    return max(p.size + g for _, p, g in _trace(vocab)) + 1


@pytest.fixture(scope="module")
def reference_runs(weights):
    """The reference on the int8 postures: its Scheduler (contiguous and
    paged) and `generate`, under quantize=True with an int8 cache (the
    launcher's --quantize) and under cache_dtype=int8 alone."""
    jcfg, jparams, _, _ = weights
    jq = jax_quantize_params(jparams)
    runs = {}
    for posture, p, kw in (("full", jq, {"quantize": True}),
                           ("kv", jparams, {})):
        for layout in ("contiguous", "paged"):
            scfg = jax_serve.ServeConfig(
                max_seq=_max_seq(jcfg.vocab), batch=3,
                compute_dtype=jnp.float32, cache_dtype=jnp.int8,
                cache_layout=layout, page_size=4, **kw)
            sched = JaxScheduler(p, jcfg, scfg)
            done = sched.run([JaxRequest(uid=u, prompt=x, max_new_tokens=g)
                              for u, x, g in _trace(jcfg.vocab)])
            runs[(posture, layout)] = (
                {u: np.asarray(c.tokens) for u, c in done.items()},
                {k: v for k, v in sched.stats.items()})
        prompt = np.random.default_rng(7).integers(0, jcfg.vocab, (2, 11))
        scfg = jax_serve.ServeConfig(max_seq=20, batch=2,
                                     compute_dtype=jnp.float32,
                                     cache_dtype=jnp.int8, **kw)
        runs[(posture, "generate")] = (prompt.astype(np.int32), np.asarray(
            jax_serve.generate(p, jcfg, scfg,
                               jnp.asarray(prompt, jnp.int32), 6)))
    return runs


def _port_params(weights, posture):
    params = weights[3]
    return quantize_params(params) if posture == "full" else params


@pytest.mark.parametrize("posture,backend", [
    ("full", "hopper"), ("full", "torch-ref"), ("kv", "hopper"),
    ("kv", None)])
def test_generate_int8_cache_tokens_equal_reference(weights, reference_runs,
                                                    posture, backend):
    cfg = weights[2]
    prompt, want = reference_runs[(posture, "generate")]
    scfg = serve.ServeConfig(max_seq=20, batch=2, compute_dtype="float32",
                             cache_dtype="int8", kernel_backend=backend,
                             quantize=posture == "full", device="cpu")
    got = serve.generate(_port_params(weights, posture), cfg, scfg, prompt, 6)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("posture,backend", [
    ("full", "hopper-int8"), ("full", "torch-ref-int8"), ("kv", "hopper")])
def test_scheduler_int8_cache_tokens_equal_reference(weights, reference_runs,
                                                     posture, backend,
                                                     layout):
    """Identical tokens per uid and the reference's stats, with a shared
    prefix (so paged prefill reads dequantized history pages)."""
    cfg = weights[2]
    scfg = serve.ServeConfig(
        max_seq=_max_seq(cfg.vocab), batch=3, compute_dtype="float32",
        cache_dtype="int8", kernel_backend=backend,
        quantize=posture == "full", device="cpu", cache_layout=layout,
        page_size=4)
    sched = Scheduler(_port_params(weights, posture), cfg, scfg)
    done = sched.run([Request(uid=u, prompt=x, max_new_tokens=g)
                      for u, x, g in _trace(cfg.vocab)])
    want, stats = reference_runs[(posture, layout)]
    assert sorted(done) == sorted(want)
    for uid, toks in want.items():
        np.testing.assert_array_equal(done[uid].tokens, toks,
                                      err_msg=f"uid={uid}")
    assert sched.stats == stats
    if layout == "paged":
        assert sched.stats["shared_prefix_tokens"] > 0
        sched.paged.check_invariants()
        assert sched.cache["slots"]["b0"]["k_scale_pages"].dtype == torch.float32


def test_int8_paged_matches_int8_contiguous(weights):
    """The port's copy of tests/test_paged.py's check: int8 paged and
    int8 contiguous serve the same tokens, and every scale pool is
    page-shaped beside its rows."""
    _, _, cfg, params = weights
    rng = np.random.default_rng(0)
    reqs = []
    for uid in range(4):
        prompt = rng.integers(0, cfg.vocab, int(rng.integers(3, 18)))
        reqs.append((uid, prompt.astype(np.int32), int(rng.integers(2, 7))))
    kw = dict(max_seq=48, batch=2, compute_dtype="float32",
              cache_dtype="int8", device="cpu")
    a = Scheduler(params, cfg, serve.ServeConfig(**kw)).run(
        [Request(uid=u, prompt=p, max_new_tokens=g) for u, p, g in reqs])
    sp = Scheduler(params, cfg, serve.ServeConfig(cache_layout="paged",
                                                  page_size=8, **kw))
    b = sp.run([Request(uid=u, prompt=p, max_new_tokens=g)
                for u, p, g in reqs])
    sp.paged.check_invariants()
    for uid in a:
        np.testing.assert_array_equal(a[uid].tokens, b[uid].tokens,
                                      err_msg=f"uid={uid}")
    slot = sp.cache["slots"]["b0"]
    assert slot["k_pages"].dtype == torch.int8
    assert slot["k_scale_pages"].shape == slot["k_pages"].shape[:-1]
    assert slot["v_scale_pages"].shape == slot["v_pages"].shape[:-1]


# --------------------------------------------------------------------------
# (f) the cache-dtype validator
# --------------------------------------------------------------------------


def _message(fn, *args, **kw):
    with pytest.raises(ValueError) as err:
        fn(*args, **kw)
    return str(err.value)


@pytest.mark.parametrize("bad", ["float64", "int32", "uint8"])
def test_validate_cache_dtype_rejects_what_the_reference_rejects(bad):
    want = _message(jax_serve.validate_cache_dtype, bad)
    assert _message(serve.validate_cache_dtype, bad) == want
    assert _message(serve.ServeConfig, max_seq=8, batch=1,
                    cache_dtype=bad) == want
    assert "not a supported cache dtype" in want


def test_validate_cache_dtype_names_and_archs_as_the_reference():
    want = _message(jax_serve.validate_cache_dtype, "bogus")
    got = _message(serve.validate_cache_dtype, "bogus")
    prefix = "cache_dtype 'bogus' is not a dtype: "
    assert want.startswith(prefix) and got.startswith(prefix)
    for name in ("int8", "bfloat16", "float32", "float16"):
        assert str(serve.validate_cache_dtype(name)) == f"torch.{name}"
        assert jax_serve.validate_cache_dtype(name).name == name
    cfg, jcfg = get_config(ARCH, smoke=True), jax_get_config(ARCH, smoke=True)
    assert serve.validate_cache_dtype("int8", cfg) == torch.int8
    ssm = dataclasses.replace(cfg, layer_pattern=("ssm",))
    jssm = dataclasses.replace(jcfg, layer_pattern=("ssm",))
    want = _message(jax_serve.validate_cache_dtype, "int8", jssm)
    assert _message(serve.validate_cache_dtype, "int8", ssm) == want
    assert "int8 SSM/RG-LRU state is unsupported" in want
    # a float cache on the same arch passes both
    assert serve.validate_cache_dtype("bfloat16", ssm) == torch.bfloat16


# --------------------------------------------------------------------------
# (g) the launcher's --quantize
# --------------------------------------------------------------------------


def test_launcher_quantize_static(capsys):
    out = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--quantize", "--batch", "2", "--prompt-len",
                             "8", "--gen", "4", "--seed", "3"])
    scfg = out["serve_config"]
    assert (scfg.cache_dtype, scfg.kernel_backend, scfg.quantize) == (
        torch.int8, "hopper-int8", True)
    assert isinstance(out["params"]["stack"]["b0"]["attn"]["wq"]["w"],
                      QuantizedTensor)
    assert {req.op for req, _ in out["engine"].plan} == {"gemm_w8"}
    # the API path on the same seeded weights and prompt
    cfg = out["cfg"]
    params = quantize_params(T.init_params(
        cfg, generator=torch.Generator().manual_seed(3), device="cpu",
        dtype=torch.float32))
    want = serve.generate(params, cfg, scfg, out["prompt"], 4)
    assert torch.equal(out["tokens"], want)
    assert "generated (2, 4)" in capsys.readouterr().out


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_launcher_quantize_trace(layout):
    out = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--quantize", "--batch", "2", "--cache-layout",
                             layout, "--page-size", "8", "--trace",
                             "24x8,8x4*3"])
    sched = out["scheduler"]
    assert out["requests"] == 4 and out["tokens"] == 8 + 3 * 4
    assert sched.engine.backend == "hopper-int8"
    leaves = sched.cache["slots"]["b0"]
    rows = "k_pages" if layout == "paged" else "k"
    scale = "k_scale_pages" if layout == "paged" else "k_scale"
    assert leaves[rows].dtype == torch.int8
    assert leaves[scale].dtype == torch.float32
    ops = {req.op for req, _ in sched.engine.plan}
    assert "gemm_w8" in ops and "gemm" not in ops
    if layout == "paged":
        assert "paged_attention" in ops
