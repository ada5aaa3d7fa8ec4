"""The kernels' VJPs of the port against `jax.vjp` of the reference, f32
on the CPU: each engine op of the port runs through its
`torch.autograd.Function` (the reference's dispatch-layer custom VJPs)
on both the kernel backend ("hopper", "hopper-int8", "hopper-sparse": on
CPU tensors the kernels' plain versions) and the plain one, and its
cotangents for one random output cotangent are held to the reference's
on the same numpy inputs:

  float and grouped GEMM   rtol 2e-5 / atol 5e-4 against "pallas-interpret"
                           (`tests/test_engine.py:352-391`)
  int8 GEMM, w8            the float backward against "xla-int8" and
                           "pallas-tpu-int8" (interpret off the TPU), and
                           within 0.06 of the float GEMM's cotangents, the
                           bound of `tests/test_quant.py:200-215`
  sparse, sparse x int8    against "xla-sparse" at rtol/atol 1e-5
                           (`tests/test_sparse.py:180-220`), pruned
                           positions of the values' cotangent exactly 0
  flash scan               dq, dk, dv within rtol/atol 1e-5 of the
                           reference's `_flash_bwd`, with GQA, ragged
                           `kv_len`, a window and a chunk that does not
                           divide Sk; no per-chunk scores saved

Each op's output carries its Function as `grad_fn` (on CUDA tensors the
kernels' outputs carry none, so a CPU test without the Function would
pass while the card dropped every weight's gradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jax_engine
from repro.models.layers import flash_attention as jax_flash
from repro.sparse import SparseTensor as JaxSparse
from repro.sparse import sparsify as jax_sparsify
from repro_torch.engine import Engine
from repro_torch.engine.backends import DiffGemm
from repro_torch.kernels import grouped_gemm, quant_gemm, sparse_gemm
from repro_torch.models import layers
from repro_torch.sparse.nm import SparseTensor

FLOAT_TOL = {"rtol": 2e-5, "atol": 5e-4}
SPARSE_TOL = {"rtol": 1e-5, "atol": 1e-5}


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _port_vjp(fn, inputs, g):
    """(output, cotangents) of `fn` at numpy `inputs` for cotangent `g`."""
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, grad_outputs=torch.tensor(g))
    return out, [gr.numpy() for gr in grads]


def _jax_vjp(fn, inputs, g):
    out, pull = jax.vjp(fn, *[jnp.asarray(x) for x in inputs])
    return out, [np.asarray(c) for c in pull(jnp.asarray(g))]


def _close(got, want, tol):
    for a, b in zip(got, want, strict=True):
        np.testing.assert_allclose(a, b, **tol)


@pytest.mark.parametrize("backend", ["hopper", "torch-ref"])
@pytest.mark.parametrize("shape", [(12, 40, 24), (33, 64, 17)])
def test_gemm_vjp_matches_reference(backend, shape):
    m, k, n = shape
    rng = np.random.default_rng(m)
    a, b, g = _rand(rng, m, k), _rand(rng, k, n), _rand(rng, m, n)
    eng = Engine(backend=backend)
    out, got = _port_vjp(eng.matmul, (a, b), g)
    assert type(out.grad_fn) is DiffGemm._backward_cls
    jeng = jax_engine.Engine(backend="pallas-interpret")
    _, want = _jax_vjp(jeng.matmul, (a, b), g)
    _close(got, want, FLOAT_TOL)


def test_gemm_vjp_bf16_cotangents_keep_operand_dtypes():
    rng = np.random.default_rng(3)
    a = torch.tensor(_rand(rng, 16, 32)).bfloat16().requires_grad_()
    b = torch.tensor(_rand(rng, 32, 8)).requires_grad_()
    out = Engine(backend="hopper").matmul(a, b.bfloat16().detach()
                                          .requires_grad_(),
                                          out_dtype=torch.float32)
    assert out.dtype == torch.float32
    (da,) = torch.autograd.grad(out.sum(), [a])
    assert da.dtype == torch.bfloat16


def test_gemm_engine_plans_no_backward_shape():
    """The backward's GEMMs run outside the engine's memo: a plan sees
    the forward's one request, hit again by a second call."""
    rng = np.random.default_rng(4)
    a = torch.tensor(_rand(rng, 8, 24), requires_grad=True)
    b = torch.tensor(_rand(rng, 24, 40), requires_grad=True)
    eng = Engine(backend="hopper")
    for _ in range(2):
        eng.matmul(a, b).square().sum().backward()
    assert eng.plan.misses == 1 and eng.plan.hits == 1
    assert len(list(eng.plan)) == 1


@pytest.mark.parametrize("backend", ["hopper", "torch-ref"])
def test_grouped_vjp_matches_reference(backend):
    rng = np.random.default_rng(8)
    x, w = _rand(rng, 3, 10, 16), _rand(rng, 3, 16, 8)
    g = _rand(rng, 3, 10, 8)
    out, got = _port_vjp(Engine(backend=backend).grouped_matmul, (x, w), g)
    assert type(out.grad_fn) is grouped_gemm.DiffGrouped._backward_cls
    jeng = jax_engine.Engine(backend="pallas-interpret")
    _, want = _jax_vjp(jeng.grouped_matmul, (x, w), g)
    _close(got, want, FLOAT_TOL)


INT8_CASES = [("hopper-int8", "pallas-tpu-int8"),
              ("torch-ref-int8", "xla-int8")]


@pytest.mark.parametrize("backend,jax_backend", INT8_CASES)
def test_int8_vjp_matches_reference(backend, jax_backend):
    rng = np.random.default_rng(6)
    a, b, g = _rand(rng, 16, 48), _rand(rng, 48, 24), _rand(rng, 16, 24)
    out, got = _port_vjp(Engine(backend=backend).matmul, (a, b), g)
    assert type(out.grad_fn) is DiffGemm._backward_cls
    _, want = _jax_vjp(jax_engine.Engine(backend=jax_backend).matmul,
                       (a, b), g)
    _close(got, want, FLOAT_TOL)
    # the cotangents stay float: the float GEMM's, within the reference's
    # own bound
    _, dense = _port_vjp(lambda x, y: x @ y, (a, b), g)
    for c, r in zip(got, dense, strict=True):
        assert np.abs(c - r).max() / np.abs(r).max() < 0.06


@pytest.mark.parametrize("backend,jax_backend", INT8_CASES)
def test_int8_w8_vjp_is_activation_only(backend, jax_backend):
    from repro.quant import quantize as jax_quantize
    from repro_torch.quant import quantize

    rng = np.random.default_rng(7)
    a, w, g = _rand(rng, 8, 32), _rand(rng, 32, 16), _rand(rng, 8, 16)
    qt = quantize(torch.tensor(w))
    jqt = jax_quantize(jnp.asarray(w))
    np.testing.assert_array_equal(qt.q.numpy(), np.asarray(jqt.q))
    eng = Engine(backend=backend)
    out, (da,) = _port_vjp(lambda x: eng.quant_matmul(x, qt.q, qt.scale),
                           (a,), g)
    assert type(out.grad_fn) is quant_gemm.DiffQuantGemmW8._backward_cls
    jeng = jax_engine.Engine(backend=jax_backend)
    _, (want,) = _jax_vjp(lambda x: jeng.quant_matmul(x, jqt.q, jqt.scale),
                          (a,), g)
    np.testing.assert_allclose(da, want, **FLOAT_TOL)


def test_int8_grouped_takes_its_gradient_per_expert():
    """The int8 grouped op loops `quant_gemm` over the experts; each
    expert's gradient comes through `DiffGemm` (float backward)."""
    rng = np.random.default_rng(9)
    x, w, g = _rand(rng, 3, 10, 16), _rand(rng, 3, 16, 8), _rand(rng, 3, 10, 8)
    _, got = _port_vjp(Engine(backend="hopper-int8").grouped_matmul,
                       (x, w), g)
    jeng = jax_engine.Engine(backend="xla-int8")
    _, want = _jax_vjp(jeng.grouped_matmul, (x, w), g)
    _close(got, want, FLOAT_TOL)


SPARSE_CASES = [("hopper-sparse", "xla-sparse"),
                ("torch-ref-sparse", "xla-sparse")]


@pytest.mark.parametrize("backend,jax_backend", SPARSE_CASES)
@pytest.mark.parametrize("spec,k", [((2, 4), 48), ((3, 7), 40)])
def test_sparse_vjp_masks_the_values(backend, jax_backend, spec, k):
    from repro_torch.sparse import sparsify

    n, m = spec
    rng = np.random.default_rng(k)
    a, w, g = _rand(rng, 16, k), _rand(rng, k, 24), _rand(rng, 16, 24)
    jst = jax_sparsify(jnp.asarray(w), n, m)
    st = sparsify(torch.tensor(w), n, m)
    np.testing.assert_array_equal(st.values.numpy(), np.asarray(jst.values))
    eng = Engine(backend=backend)

    def port(a_, v_):
        return eng.sparse_matmul(a_, SparseTensor(
            v_, st.indices, n=n, m=m, k_dense=st.k_dense))

    out, (da, dv) = _port_vjp(port, (a, st.values.numpy()), g)
    assert type(out.grad_fn) is sparse_gemm.DiffSparseGemm._backward_cls
    jeng = jax_engine.Engine(backend=jax_backend)

    def ref(a_, v_):
        return jeng.sparse_matmul(a_, JaxSparse(v_, jst.indices, n=n, m=m,
                                                k_dense=jst.k_dense))

    _, (ja, jv) = _jax_vjp(ref, (a, np.asarray(jst.values)), g)
    np.testing.assert_allclose(da, ja, **SPARSE_TOL)
    np.testing.assert_allclose(dv, jv, **SPARSE_TOL)
    # scattered to dense, the pruned positions are exactly zero
    dense = sparse_gemm.scatter_dense(torch.tensor(dv), st.indices, n, m)
    kept = sparse_gemm.scatter_dense(torch.ones_like(st.values), st.indices,
                                     n, m)
    assert (dense[kept == 0] == 0.0).all()


@pytest.mark.parametrize("backend,jax_backend", SPARSE_CASES)
def test_sparse_int8_vjp_is_activation_only(backend, jax_backend):
    from repro_torch.sparse import sparsify

    rng = np.random.default_rng(7)
    a, w, g = _rand(rng, 8, 32), _rand(rng, 32, 16), _rand(rng, 8, 16)
    jst = jax_sparsify(jnp.asarray(w), 2, 4, quantize=True)
    st = sparsify(torch.tensor(w), 2, 4, quantize=True)
    eng, jeng = Engine(backend=backend), jax_engine.Engine(backend=jax_backend)
    out, (da,) = _port_vjp(lambda x: eng.sparse_matmul(x, st), (a,), g)
    assert type(out.grad_fn) is sparse_gemm.DiffSparseGemmQ._backward_cls
    _, (want,) = _jax_vjp(lambda x: jeng.sparse_matmul(x, jst), (a,), g)
    np.testing.assert_allclose(da, want, **SPARSE_TOL)


FLASH_CASES = [
    # (B, Sq, Sk, H, KV, D, causal, window, chunk, kv_len)
    (2, 24, 24, 4, 2, 16, True, 0, 8, (24, 17)),
    (2, 20, 29, 6, 2, 8, True, 0, 7, (29, 11)),
    (1, 32, 32, 4, 1, 16, True, 9, 12, (32,)),
    (2, 16, 23, 2, 2, 8, False, 0, 5, (23, 9)),
]


def _flash_inputs(case):
    b, sq, sk, h, kv, d, causal, window, chunk, kv_len = case
    rng = np.random.default_rng(sq * sk)
    q, k, v = _rand(rng, b, sq, h, d), _rand(rng, b, sk, kv, d), _rand(
        rng, b, sk, kv, d)
    # queries at the end of the keys, as a prefill continuing a history
    pos = np.broadcast_to(np.arange(sk - sq, sk, dtype=np.int32), (b, sq))
    return (q, k, v, np.ascontiguousarray(pos),
            np.asarray(kv_len, np.int32)), _rand(rng, b, sq, h, d)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_scan_vjp_matches_reference(case):
    (q, k, v, pos, kv_len), g = _flash_inputs(case)
    causal, window, chunk = case[6:9]
    tpos, tlen = torch.tensor(pos), torch.tensor(kv_len)

    def port(q_, k_, v_):
        return layers.flash_attention(q_, k_, v_, tpos, tlen, causal, window,
                                      chunk)

    out, got = _port_vjp(port, (q, k, v), g)
    assert type(out.grad_fn) is layers.FlashScan._backward_cls
    _, want = _jax_vjp(lambda q_, k_, v_: jax_flash(
        q_, k_, v_, jnp.asarray(pos), jnp.asarray(kv_len), causal, window,
        chunk), (q, k, v), g)
    _close(got, want, {"rtol": 1e-5, "atol": 1e-5})
    # and against autograd through the plain loop (the forward alone)
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    plain = layers._flash_scan(*ts, tpos, tlen, causal, window, chunk)
    auto = torch.autograd.grad(plain, ts, grad_outputs=torch.tensor(g))
    _close(got, [t.numpy() for t in auto], {"rtol": 1e-5, "atol": 1e-5})


def test_flash_scan_saves_no_chunk_scores():
    """What the Function keeps for the backward: q, k, v, the positions,
    o and the (B, KV, G, Sq) log-sum-exp; autograd through the plain
    loop keeps each chunk's (B, KV, G, Sq, C) scores."""
    (q, k, v, pos, kv_len), _ = _flash_inputs(FLASH_CASES[1])
    tpos, tlen = torch.tensor(pos), torch.tensor(kv_len)

    def saved_shapes(fn):
        shapes = []

        def pack(t):
            shapes.append(tuple(t.shape))
            return t

        ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            fn(*ts, tpos, tlen, True, 0, 7)
        return shapes

    b, sq, h = q.shape[:3]
    kv = k.shape[2]
    scores = lambda shapes: [s for s in shapes
                             if s[:4] == (b, kv, h // kv, sq) and len(s) == 5]
    assert scores(saved_shapes(layers._flash_scan))   # the hook sees them
    kept = saved_shapes(layers.flash_attention)
    assert not scores(kept)
    assert len(kept) == 7 and (b, kv, h // kv, sq) in kept


def test_dense_weights_all_get_gradients_through_the_engine():
    """A SMOKE forward on "hopper": every float leaf gets a gradient (the
    dense weights through `DiffGemm`, the rest through autograd)."""
    from repro_torch.configs import get_config
    from repro_torch.engine import use_engine
    from repro_torch.models import transformer as T
    from repro_torch.tree import flatten_with_path

    cfg = get_config("qwen2-1.5b", smoke=True)
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0))
    leaves = [(p, t.requires_grad_()) for p, t in flatten_with_path(params)]
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    with use_engine(backend="hopper") as eng:
        logits, _ = T.forward(params, cfg, tokens,
                              compute_dtype=torch.float32)
        grads = torch.autograd.grad(logits.square().mean(),
                                    [t for _, t in leaves],
                                    allow_unused=True)
    missing = [p for (p, _), g in zip(leaves, grads) if g is None]
    assert not missing, missing
    # forward and recompute: 7 engine GEMMs a layer, twice
    assert eng.plan.hits + eng.plan.misses == 2 * 7 * cfg.n_layers
