"""The port's sparse x int8 plane (N:M-pruned weights whose kept values are
stored int8 with a per-output-column f32 scale) against the JAX package,
on the CPU: the storage (`sparsify`/`prune_params(quantize=True)`), the
sparse GEMM's plain version with int8 values and a scale, the scaled
split-K reduction, the planner and the engine's in_bytes-1 key, the
bridge, `layers.dense`, `ServeConfig`, the launcher's `--sparsity 2:4
--quantize`, and qwen2-1.5b SMOKE tokens against the reference's own
sparse x int8 serve.

Inputs are drawn with numpy and handed to both packages.  The storage is
held bit for bit (the reference's eager arithmetic: f32 values, amax /
127, round half to even); the products at the tolerance each test states;
greedy tokens identical per uid.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import engine as jax_engine
from repro.configs import get_config as jax_get_config
from repro.kernels import sparse_gemm as jax_sg
from repro.models import transformer as JT
from repro.serve_lib import serve as jax_serve
from repro.serve_lib.scheduler import Request as JaxRequest
from repro.serve_lib.scheduler import Scheduler as JaxScheduler
from repro.sparse import prune_params as jax_prune_params
from repro.sparse import sparsify as jax_sparsify
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.engine import (BACKENDS, SPARSE_BACKENDS, Engine,
                                ExecutionPlan, HopperModel, KernelRequest,
                                use_engine)
from repro_torch.engine import cost
from repro_torch.engine.backends import sparse_args
from repro_torch.kernels import sparse_gemm
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers
from repro_torch.quant import tree_bytes
from repro_torch.serve_lib import serve
from repro_torch.serve_lib.scheduler import Request, Scheduler
from repro_torch.sparse import SparseTensor, prune_params, sparsify

ARCH = "qwen2-1.5b"
CSRC = Path(sparse_gemm.__file__).with_name("csrc") / "sparse_gemm.cu"
SPECS = [(1, 2), (2, 4), (1, 4), (4, 8), (3, 7)]
JAX_NAME = {"hopper": "pallas-tpu", "torch-ref": "xla-einsum",
            "hopper-int8": "pallas-tpu-int8", "torch-ref-int8": "xla-int8",
            "hopper-sparse": "pallas-tpu-sparse",
            "torch-ref-sparse": "xla-sparse", "simulator": "simulator"}


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _assert_storage_equal(got: SparseTensor, want) -> None:
    assert got.quantized and want.quantized
    assert got.values.dtype == torch.int8 and got.scale.dtype == torch.float32
    assert (got.n, got.m, got.k_dense) == (want.n, want.m, want.k_dense)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


# --------------------------------------------------------------------------
# Storage: sparsify / prune_params(quantize=True)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n,m", SPECS)
@pytest.mark.parametrize("k", [56, 61])         # a multiple of every M; ragged
def test_sparsify_quantize_bitwise_equal_reference(n, m, k):
    """Values, indices and scale bit for bit, a stacked (3, K, N) weight
    pruned and quantized one slice at a time, scale (3, 1, N)."""
    x = _normal((3, k, 40), 100 + k + 10 * m)
    got = sparsify(torch.from_numpy(x), n, m, quantize=True)
    assert got.scale.shape == (3, 1, 40)
    _assert_storage_equal(got, jax_sparsify(jnp.asarray(x), n, m,
                                            quantize=True))


@settings(deadline=None, max_examples=25, database=None, derandomize=True)
@given(spec=st.sampled_from(SPECS), k=st.integers(1, 90),
       n=st.integers(1, 24), seed=st.integers(0, 2**16),
       spread=st.sampled_from([1e-3, 1.0, 1e3]))
def test_sparsify_quantize_property_bitwise(spec, k, n, seed, spread):
    """Any K (down to 1, below M), any width and any magnitude: the
    reference's bits, and the eager scale (`amax / 127`, a true
    division)."""
    x = _normal((k, n), seed) * np.float32(spread)
    got = sparsify(torch.from_numpy(x), *spec, quantize=True)
    _assert_storage_equal(got, jax_sparsify(jnp.asarray(x), *spec,
                                            quantize=True))


@pytest.mark.parametrize("n,m", SPECS)
def test_tied_magnitudes_and_an_all_zero_column(n, m):
    """Every magnitude tied, a column of exact zeros (scale 1.0, values
    0) and a column of halves: the reference's bits; the tied column's
    values are +-127."""
    k = 3 * m + 1
    x = np.ones((k, 6), np.float32)
    x[1::2] = -1.0
    x[:, 2] = 0.0
    x[:, 4] = np.tile(np.array([0.5, -0.5], np.float32), k)[:k]
    got = sparsify(torch.from_numpy(x), n, m, quantize=True)
    _assert_storage_equal(got, jax_sparsify(jnp.asarray(x), n, m,
                                            quantize=True))
    assert got.scale[0, 2].item() == 1.0
    assert not got.values[:, 2].any()
    assert set(got.values[:, 0].abs().tolist()) <= {0, 127}


def test_sparsify_quantize_takes_the_values_from_f32():
    """A bf16 weight: the scale and the int8 values come from the kept
    values in f32, as the reference's do."""
    x = _normal((40, 16), 7)
    got = sparsify(torch.from_numpy(x).to(torch.bfloat16), 2, 4,
                   quantize=True)
    _assert_storage_equal(got, jax_sparsify(jnp.asarray(x, jnp.bfloat16), 2,
                                            4, quantize=True))


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_get_config(ARCH, smoke=True)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    jsq = jax_prune_params(jparams, 2, 4, quantize=True)
    return jcfg, jsq, get_config(ARCH, smoke=True), params


def _sparse_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _sparse_leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _sparse_leaves(v, path + (i,))
    else:
        yield path, tree


def test_prune_params_quantize_bitwise_on_the_smoke_tree(smoke):
    """The SMOKE tree: the 7 pruned leaves' storage bit for bit, every
    other leaf untouched, the bytes the reference's, and fewer than the
    float 2:4 tree's."""
    _, jsq, _, params = smoke
    mine = dict(_sparse_leaves(prune_params(params, 2, 4, quantize=True)))
    want = dict(_sparse_leaves(jsq))
    assert mine.keys() == want.keys()
    n_sparse = 0
    for path, leaf in want.items():
        if hasattr(leaf, "indices"):
            n_sparse += 1
            _assert_storage_equal(mine[path], leaf)
        else:
            np.testing.assert_array_equal(mine[path].numpy(),
                                          np.asarray(leaf))
    assert n_sparse == 7
    quantized = tree_bytes(prune_params(params, 2, 4, quantize=True))
    assert quantized == sum(leaf.size * leaf.dtype.itemsize
                            for leaf in jax.tree.leaves(jsq))
    assert quantized < tree_bytes(prune_params(params, 2, 4))


def test_bridge_carries_a_quantized_pruned_tree(smoke):
    """The reference's `prune_params(quantize=True)` tree through the
    bridge: int8 values and f32 scales whatever `dtype` says, equal to
    the port's own pruning of the same weights."""
    _, jsq, _, params = smoke
    tree = jax.tree.map(np.asarray, jsq)
    mine = dict(_sparse_leaves(prune_params(params, 2, 4, quantize=True)))
    for dtype in (None, torch.bfloat16):
        carried = params_from_numpy(tree, device="cpu", dtype=dtype)
        w = carried["stack"]["b0"]["mlp"]["wo"]["w"]
        assert w.quantized and w.values.dtype == torch.int8
        assert w.scale.dtype == torch.float32 and w.scale.shape == (2, 1, 64)
        for path, leaf in _sparse_leaves(carried):
            if isinstance(leaf, SparseTensor):
                for part in ("values", "indices", "scale"):
                    assert torch.equal(getattr(leaf, part),
                                       getattr(mine[path], part)), path


def test_densify_and_period_slices_of_quantized_storage(smoke):
    """`densify` scales before the one-hot sum, as the reference's does;
    a period slice keeps its scale."""
    from repro_torch.models.transformer import _index

    _, jsq, _, params = smoke
    st_ = prune_params(params, 2, 4, quantize=True)["stack"]["b0"]["attn"][
        "wq"]["w"]
    want = jsq["stack"]["b0"]["attn"]["wq"]["w"]
    np.testing.assert_array_equal(st_.densify().numpy(),
                                  np.asarray(want.densify()))
    sl = _index({"w": st_}, 1)["w"]
    assert sl.quantized and sl.scale.shape == (1, st_.shape[-1])
    assert torch.equal(sl.densify(), st_.densify()[1])


# --------------------------------------------------------------------------
# The sparse GEMM's plain version with int8 values and a scale
# --------------------------------------------------------------------------


def _operands(m, k, n, nk, mg, seed):
    a = _normal((m, k), seed)
    stq = jax_sparsify(jnp.asarray(_normal((k, n), seed + 1)), nk, mg,
                       quantize=True)
    return a, np.array(stq.values), np.array(stq.indices), np.array(stq.scale)


def _plain(a, v, i, s, nk, mg, out_dtype=None):
    return sparse_gemm.sparse_gemm_reference(
        torch.from_numpy(a), torch.from_numpy(v), torch.from_numpy(i),
        torch.from_numpy(s), n_keep=nk, m_group=mg, out_dtype=out_dtype)


@pytest.mark.parametrize("n_keep,m_group", SPECS)
@pytest.mark.parametrize("m,k,n", [(5, 64, 96), (13, 44, 21), (8, 256, 128)])
def test_plain_int8_values_equal_xla_sparse(n_keep, m_group, m, k, n):
    """Against the reference's `use_pallas=False` branch with int8 values
    and the scale, in f32, at rtol 1e-6, atol 1e-5 (the same f32 tile and
    scale; the product sums in another order)."""
    a, v, i, s = _operands(m, k, n, n_keep, m_group, 31)
    want = jax_sg.sparse_gemm(jnp.asarray(a), jnp.asarray(v), jnp.asarray(i),
                              jnp.asarray(s), n_keep=n_keep, m_group=m_group,
                              use_pallas=False)
    got = _plain(a, v, i, s, n_keep, m_group)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)
    # the scale as (N,) gives the same bits
    flat = sparse_gemm.sparse_gemm_reference(
        torch.from_numpy(a), torch.from_numpy(v), torch.from_numpy(i),
        torch.from_numpy(s).reshape(-1), n_keep=n_keep, m_group=m_group)
    assert torch.equal(flat, got)


@pytest.mark.parametrize("n_keep,m_group,m,k,n", [
    (2, 4, 16, 32, 16), (2, 4, 13, 44, 21), (1, 4, 8, 256, 128),
    (3, 7, 5, 70, 24)])
def test_plain_int8_values_equal_pallas_kernel_in_interpret_mode(
        n_keep, m_group, m, k, n):
    """Against the Pallas kernel in interpret mode with the scale, at rtol
    1e-5, atol 1e-4 (the reference's own Pallas/XLA pair is not bit-exact
    here, ROADMAP.md queue 3 caveats)."""
    a, v, i, s = _operands(m, k, n, n_keep, m_group, 32)
    want = jax_sg.sparse_gemm(jnp.asarray(a), jnp.asarray(v), jnp.asarray(i),
                              jnp.asarray(s), n_keep=n_keep, m_group=m_group,
                              use_pallas=True, interpret=True)
    np.testing.assert_allclose(_plain(a, v, i, s, n_keep, m_group).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", ["tiled", "decode"])
def test_sparse_gemm_int8_on_the_cpu_is_its_plain_version(out, path):
    a, v, i, s = (torch.from_numpy(x) for x in _operands(9, 100, 40, 2, 4, 33))
    out = getattr(torch, out)
    kw = {"path": "decode", "split_k": 3} if path == "decode" else {}
    sparse_gemm.reset_launches()
    got = sparse_gemm.sparse_gemm(a, v, i, s, n_keep=2, m_group=4,
                                  out_dtype=out, **kw)
    assert sparse_gemm.launches == sparse_gemm.int8_launches == 0
    assert got.dtype == out
    assert torch.equal(got, sparse_gemm.sparse_gemm_reference(
        a, v, i, s, n_keep=2, m_group=4, out_dtype=out))


@pytest.mark.parametrize("split", [2, 7])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_scaled_split_reduce_sums_in_order_then_scales(split, out):
    """`split_reduce_reference` with a scale: the partials summed in split
    order from zero, then times the column's scale, then cast (the
    kernel's order); `split_reduce` on a CPU tensor is that; and the
    partials of the decode path's split, reduced with the scale, are the
    scaled product to f32 rounding."""
    out = getattr(torch, out)
    rng = np.random.default_rng(split)
    ws = torch.from_numpy(rng.normal(size=(split, 3, 10)).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(1e-3, 2e-2, (1, 10))
                             .astype(np.float32))
    total = torch.zeros(3, 10)
    for part in ws:
        total = total + part
    want = (total * scale).to(out)
    for s in (scale, scale.reshape(-1)):
        assert torch.equal(sparse_gemm.split_reduce_reference(ws, out, s),
                           want)
        assert torch.equal(sparse_gemm.split_reduce(ws, out, s), want)
    assert torch.equal(sparse_gemm.split_reduce_reference(ws, out),
                       total.to(out))
    a, v, i, sc = (torch.from_numpy(x) for x in _operands(4, 61, 24, 2, 4, 34))
    groups = v.shape[0] // 2
    base, extra = sparse_gemm.split_groups(groups, split)
    parts = []
    for s in range(split):
        g0 = s * base + min(s, extra)
        g1 = g0 + base + (s < extra)
        dense = sparse_gemm.scatter_dense(v[2 * g0:2 * g1].float(),
                                          i[2 * g0:2 * g1], 2, 4)
        a_s = torch.nn.functional.pad(a, (0, 4 * groups - 61))[
            :, 4 * g0:4 * g1]
        parts.append(a_s @ dense)
    got = sparse_gemm.split_reduce_reference(torch.stack(parts),
                                             torch.float32, sc)
    torch.testing.assert_close(got, _plain(*(x.numpy() for x in (a, v, i,
                                                                   sc)),
                                           2, 4), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad", ["int8 activations", "scale shape",
                                 "scale dtype", "scale layout",
                                 "value dtype", "reduce scale"])
def test_sparse_gemm_int8_refuses_what_the_kernel_does_not_take(bad):
    """int8 values with float activations are taken; int8 activations, a
    scale of another shape, dtype or layout, and float values of another
    dtype than A's are not (on the CPU too: the check runs first)."""
    a, v, i, s = (torch.from_numpy(x) for x in _operands(4, 64, 32, 2, 4, 35))
    want, match = TypeError, "scale must be f32"
    if bad == "int8 activations":
        a, match = a.to(torch.int8), "bf16 or f32 activations"
    elif bad == "scale shape":
        s = torch.ones(1, 16)
    elif bad == "scale dtype":
        s = s.to(torch.bfloat16)
    elif bad == "scale layout":
        s, want, match = torch.ones(32, 2)[:, 0], ValueError, "contiguous"
    elif bad == "value dtype":
        v, s, match = v.to(torch.bfloat16), None, "same dtype or int8"
    if bad == "reduce scale":
        with pytest.raises(TypeError, match="scale must be f32"):
            sparse_gemm.split_reduce(torch.zeros(2, 4, 32), torch.float32,
                                     torch.ones(4, 32))
        return
    with pytest.raises(want, match=match):
        sparse_gemm.sparse_gemm(a, v, i, s, n_keep=2, m_group=4)


def test_cuda_source_int8_lanes_and_smem_equal_the_wrapper():
    """The decode lane's columns are the CUDA source's `DecRow` C for each
    value type (8 int8 values a lane, as `DECODE_LANE_BYTES` says), so the
    wrapper's `decode_columns`, the decision's bn and the compiled kernel
    agree; int8 value rows sit unpadded in shared memory, and every tile
    keeps two stages at every spec for bf16 activations."""
    src = CSRC.read_text()
    lanes = {vt: int(c) for vt, c in re.findall(
        r"struct DecRow<(__nv_bfloat16|float|signed char)> \{\s*"
        r"static constexpr int C = (\d+);", src)}
    assert lanes == {"__nv_bfloat16": 8, "float": 4, "signed char": 8}
    for vt, size in (("__nv_bfloat16", 2), ("float", 4), ("signed char", 1)):
        assert sparse_gemm.decode_columns(size) == 32 * lanes[vt]
        assert sparse_gemm.DECODE_LANE_BYTES[size] == lanes[vt] * size
    assert "BN + (sizeof(VT) > 1 ? kPad : 0)" in src
    req = KernelRequest("gemm_sparse", 8, 1536, 8960, in_bytes=1,
                        out_bytes=2, density=0.5)
    assert HopperModel().decide(req).bn == 32 * lanes["signed char"]
    specs = [(n, m) for m in range(2, 129) for n in range(1, m)]
    for tile in sparse_gemm.TILES:
        bm, bk, bn = tile
        for a_bytes in (2, 4):
            assert (sparse_gemm.smem_bytes(*tile, a_bytes, value_bytes=1)
                    == sparse_gemm.smem_bytes(*tile, a_bytes)
                    - bk * ((bn + 8) * a_bytes - bn))
            assert sparse_gemm.smem_bytes(*tile, a_bytes,
                                          value_bytes=1) <= 232_448
        assert all(sparse_gemm.tiled_stages(tile, 2, n, m, 1) == 2
                   for n, m in specs)


# --------------------------------------------------------------------------
# Planner and engine: the in_bytes-1 key
# --------------------------------------------------------------------------


@pytest.mark.parametrize("m", [4, 8, 16, 17, 2048])
@pytest.mark.parametrize("out_bytes", [2, 4])
def test_hopper_plans_int8_values_at_their_widths(m, out_bytes):
    """A request at in_bytes 1 (int8 values) under activations of the
    compute width `out_bytes`: decode blocks of `decode_columns(1)`
    columns, the values streamed at 1 byte plus 1 index byte and A at
    `out_bytes`; the tiled path's shared memory and bytes with value rows
    at 1 byte, at the compute width's peak; never dearer than the float
    storage's decision of the same shape, and cheaper on the decode path,
    which the bytes bound."""
    for k, n in ((1536, 1536), (1536, 256), (1536, 8960), (8960, 1536)):
        req = KernelRequest("gemm_sparse", m, k, n, in_bytes=1,
                            out_bytes=out_bytes, density=0.5)
        flt = KernelRequest("gemm_sparse", m, k, n, in_bytes=out_bytes,
                            out_bytes=out_bytes, density=0.5)
        assert cost.sparse_widths(req) == (out_bytes, 1)
        assert cost.sparse_widths(flt) == (out_bytes, out_bytes)
        dec = HopperModel().decide(req)
        meta = dec.meta_dict
        flt_seconds = HopperModel().decide(flt).seconds
        assert dec.seconds <= flt_seconds
        if m <= sparse_gemm.DECODE_ROWS[-1]:
            assert meta["path"] == "decode" and dec.seconds < flt_seconds
            assert dec.bn == sparse_gemm.decode_columns(1) == 256
            assert meta["blocks"] == -(-n // 256) * meta["split_k"]
            streamed = (meta["hbm_bytes"] - meta["workspace_bytes"]
                        - m * n * out_bytes)
            assert streamed == k // 2 * n * 2 + m * k * out_bytes
            continue
        assert meta["path"] == "tiled"
        tile = (dec.bm, dec.bk, dec.bn)
        assert meta["smem_bytes"] == sparse_gemm.smem_bytes(
            *tile, out_bytes, dec.bk // 2, meta["stages"], value_bytes=1)
        assert meta["stages"] == sparse_gemm.tiled_stages(tile, out_bytes,
                                                          2, 4, 1)
        cfg = cost.TileConfig("os", *tile)
        body, bytes_, _ = cost.estimate(m, k // 2, n, cfg, out_bytes,
                                        out_bytes, 1)
        assert meta["hbm_bytes"] == bytes_ + k // 2 * n
        assert dec.seconds == body + k // 2 * n / cost.HBM_BW


def test_sparse_int8_storage_keys_at_one_byte():
    """The reference's test of the same name on the port: float sparse
    storage keys at its width, sparse x int8 at 1, on both sparse
    backends, as on the reference's `xla-sparse`."""
    rng = np.random.default_rng(8)
    a = rng.normal(size=(8, 32)).astype(np.float32)
    w = rng.normal(size=(32, 16)).astype(np.float32)
    with jax_engine.use_engine(backend="xla-sparse") as jeng:
        jeng.sparse_matmul(jnp.asarray(a), jax_sparsify(jnp.asarray(w), 2, 4))
        jeng.sparse_matmul(jnp.asarray(a), jax_sparsify(jnp.asarray(w), 2, 4,
                                                        quantize=True))
    want = {(req.in_bytes, req.out_bytes) for req, _ in jeng.plan}
    assert want == {(4, 4), (1, 4)}
    for backend in SPARSE_BACKENDS:
        with use_engine(backend=backend) as eng:
            eng.sparse_matmul(torch.from_numpy(a),
                              sparsify(torch.from_numpy(w), 2, 4))
            eng.sparse_matmul(torch.from_numpy(a),
                              sparsify(torch.from_numpy(w), 2, 4,
                                       quantize=True))
        assert {(req.in_bytes, req.out_bytes) for req, _ in eng.plan} == want
        assert eng.plan.stats["misses"] == 2


@pytest.mark.parametrize("m", [8, 40])
def test_sparse_matmul_int8_equals_reference_on_both_backends(m):
    """Quantized storage through `Engine.sparse_matmul`: both sparse
    backends return what `torch-ref-sparse` returns (the decode path at M
    = 8, the tiled one at 40, on CPU tensors their plain version), and
    the reference's `xla-sparse` engine's product at rtol 1e-6, atol
    1e-5; a repeat is a memo hit, apart from float storage's key."""
    a = _normal((m, 64), 36)
    w = _normal((64, 48), 37)
    stq = sparsify(torch.from_numpy(w), 2, 4, quantize=True)
    with jax_engine.use_engine(backend="xla-sparse") as jeng:
        want = np.asarray(jeng.sparse_matmul(
            jnp.asarray(a), jax_sparsify(jnp.asarray(w), 2, 4,
                                         quantize=True)))
    outs = {}
    for backend in SPARSE_BACKENDS:
        eng = Engine(backend=backend)
        outs[backend] = eng.sparse_matmul(torch.from_numpy(a), stq)
        eng.sparse_matmul(torch.from_numpy(a), stq)
        assert eng.plan.stats["misses"] == 1 and eng.plan.hits == 1
        (req, dec), = list(eng.plan)
        assert req.in_bytes == 1 and req.out_bytes == 4
        assert sparse_args(dec)["path"] == ("decode" if m <= 16 else "tiled")
    assert torch.equal(outs["hopper-sparse"], outs["torch-ref-sparse"])
    np.testing.assert_allclose(outs["torch-ref-sparse"].numpy(), want,
                               rtol=1e-6, atol=1e-5)


def test_int8_sparse_decisions_survive_json(tmp_path):
    """Decisions at in_bytes 1 (decode and tiled) survive the plan's JSON,
    keyed apart from float storage of the same shape, and name the same
    kernel arguments after it."""
    plan, model = ExecutionPlan(), HopperModel()
    reqs = [KernelRequest("gemm_sparse", m, 1536, 8960, in_bytes=ib,
                          out_bytes=2, density=0.5)
            for m in (8, 2048) for ib in (1, 2)]
    assert len({r.key() for r in reqs}) == 4
    for req in reqs:
        plan.add(req, model.decide(req))
    plan.save(tmp_path / "plan.json")
    loaded = ExecutionPlan.load(tmp_path / "plan.json")
    for req in reqs:
        before, after = plan.decisions[req.key()], loaded.lookup(req)
        assert after == before
        assert sparse_args(after) == sparse_args(before)
    assert loaded.lookup(reqs[0]).bn == 256


# --------------------------------------------------------------------------
# layers.dense
# --------------------------------------------------------------------------


@pytest.mark.parametrize("backend", SPARSE_BACKENDS)
def test_dense_dispatches_int8_storage_on_a_sparse_engine(backend):
    w = _normal((32, 16), 38)
    x = torch.from_numpy(_normal((2, 4, 32), 39))
    p = {"w": sparsify(torch.from_numpy(w), 2, 4, quantize=True),
         "b": torch.ones(16)}
    with use_engine(backend=backend) as eng:
        out = layers.dense(p, x)
    assert [(req.op, req.in_bytes) for req, _ in eng.plan] == [
        ("gemm_sparse", 1)]
    want = sparse_gemm.sparse_gemm_reference(
        x.reshape(8, 32), p["w"].values, p["w"].indices, p["w"].scale,
        n_keep=2, m_group=4).reshape(2, 4, 16) + 1.0
    assert torch.equal(out, want)


@pytest.mark.parametrize("backend", [None, "hopper", "torch-ref",
                                     "hopper-int8", "torch-ref-int8"])
def test_dense_densifies_int8_storage_off_a_sparse_engine(backend):
    """Off a sparse engine the storage densifies (scaled, in f32) to the
    compute dtype and takes that posture's dense matmul; the densified
    weight is the reference's."""
    w = _normal((32, 16), 40)
    x = torch.from_numpy(_normal((4, 32), 41))
    p = {"w": sparsify(torch.from_numpy(w), 2, 4, quantize=True)}
    wf = p["w"].densify()
    np.testing.assert_array_equal(wf.numpy(), np.asarray(jax_sparsify(
        jnp.asarray(w), 2, 4, quantize=True).densify()))
    if backend is None:
        assert torch.equal(layers.dense(p, x), x @ wf)
        return
    with use_engine(backend=backend) as eng:
        out = layers.dense(p, x)
    assert {req.op for req, _ in eng.plan} == {"gemm"}
    with use_engine(backend=backend):
        assert torch.equal(out, layers.dense({"w": wf}, x))


# --------------------------------------------------------------------------
# ServeConfig and the launcher
# --------------------------------------------------------------------------


@pytest.mark.parametrize("given_backend", [None, *BACKENDS])
def test_serveconfig_sparse_int8_upgrades_as_the_reference(given_backend):
    """`sparsity` with `quantize=True`: the int8 upgrade, then the sparse
    one, name for name as the reference's; a sparse name and the
    simulator have no int8 sibling, and both raise for them."""
    kw = {"max_seq": 8, "batch": 1, "sparsity": "2:4", "quantize": True}
    if given_backend in (*SPARSE_BACKENDS, "simulator"):
        with pytest.raises(ValueError, match="cannot upgrade"):
            serve.ServeConfig(kernel_backend=given_backend, device="cpu",
                              **kw)
        with pytest.raises(ValueError, match="cannot upgrade"):
            jax_serve.ServeConfig(
                kernel_backend=JAX_NAME[given_backend], **kw)
        return
    scfg = serve.ServeConfig(kernel_backend=given_backend, device="cpu",
                             **kw)
    assert serve.warm_start_engine(scfg).sparse
    if given_backend is None:
        assert scfg.kernel_backend == "hopper-sparse"
        return
    want = jax_serve.ServeConfig(kernel_backend=JAX_NAME[given_backend],
                                 **kw).kernel_backend
    assert JAX_NAME[scfg.kernel_backend] == want


@pytest.mark.parametrize("trace", [None, "24x8,8x4*3"])
def test_launcher_serves_sparsity_with_quantize_on_the_cpu(trace):
    """`--sparsity 2:4 --quantize`: the weights pruned with quantize=True
    and never through `quantize_params`, an int8 KV cache, "hopper-sparse"
    keyed at in_bytes 1; the static serve's tokens are the API's."""
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--sparsity", "2:4",
            "--quantize", "--batch", "2"]
    args += (["--prompt-len", "8", "--gen", "4"] if trace is None else
             ["--cache-layout", "paged", "--page-size", "8", "--trace", trace])
    out = launch_serve.main(args)
    scfg = out["serve_config"]
    assert scfg.kernel_backend == "hopper-sparse"
    assert scfg.cache_dtype == torch.int8
    w = out["params"]["stack"]["b0"]["mlp"]["wi"]["w"]
    assert isinstance(w, SparseTensor) and w.quantized
    assert {(req.op, req.in_bytes) for req, _ in out["engine"].plan
            if req.op == "gemm_sparse"} == {("gemm_sparse", 1)}
    assert {req.op for req, _ in out["engine"].plan} <= {
        "gemm_sparse", "paged_attention"}
    if trace is None:
        assert tuple(out["tokens"].shape) == (2, 4)
        want = serve.generate(out["params"], out["cfg"], serve.ServeConfig(
            max_seq=13, batch=2, compute_dtype="float32", cache_dtype="int8",
            sparsity="2:4", quantize=True, device="cpu"), out["prompt"], 4)
        assert torch.equal(out["tokens"], want)
    else:
        assert out["requests"] == 4


# --------------------------------------------------------------------------
# qwen2-1.5b SMOKE under sparsity="2:4", quantize=True: tokens against the
# reference's own sparse x int8 serve
# --------------------------------------------------------------------------


TRACE = [(6, 8), (10, 2), (6, 5), (14, 9), (10, 3), (6, 7), (14, 2), (10, 6)]
MAX_SEQ = max(p + g for p, g in TRACE) + 1


def _trace_prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, p).astype(np.int32) for p, _ in TRACE]


@pytest.fixture(scope="module")
def reference_runs(smoke):
    """The reference's own sparse x int8 serve of its pruned, quantized
    seed-0 weights (sparsity="2:4", quantize=True resolve to
    "xla-sparse"), f32: its Scheduler on the 8-request trace, contiguous
    and paged, under a float cache and under an int8 cache, and its
    `generate` on two prompts under a float cache."""
    jcfg, jsq, _, _ = smoke
    prompts = _trace_prompts(jcfg.vocab)
    runs = {}
    for cache in ("float32", "int8"):
        for layout in ("contiguous", "paged"):
            scfg = jax_serve.ServeConfig(
                max_seq=MAX_SEQ, batch=3, compute_dtype=jnp.float32,
                cache_dtype=getattr(jnp, cache), sparsity="2:4",
                quantize=True, cache_layout=layout, page_size=4)
            assert scfg.kernel_backend == "xla-sparse"
            done = JaxScheduler(jsq, jcfg, scfg).run(
                [JaxRequest(uid=i, prompt=p, max_new_tokens=g)
                 for i, (p, (_, g)) in enumerate(zip(prompts, TRACE))])
            runs[cache, layout] = {u: np.asarray(c.tokens)
                                   for u, c in done.items()}
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 11))
    scfg = jax_serve.ServeConfig(max_seq=20, batch=2,
                                 compute_dtype=jnp.float32,
                                 cache_dtype=jnp.float32, sparsity="2:4",
                                 quantize=True)
    runs["generate"] = (tokens.astype(np.int32), np.asarray(jax_serve.generate(
        jsq, jcfg, scfg, jnp.asarray(tokens, jnp.int32), 6)))
    return runs


def _bridged(smoke):
    return params_from_numpy(jax.tree.map(np.asarray, smoke[1]), device="cpu")


@pytest.mark.parametrize("backend", [None, "hopper", "torch-ref"])
def test_generate_sparse_int8_tokens_equal_reference(smoke, reference_runs,
                                                     backend):
    cfg = smoke[2]
    prompt, want = reference_runs["generate"]
    scfg = serve.ServeConfig(max_seq=20, batch=2, compute_dtype="float32",
                             cache_dtype="float32", kernel_backend=backend,
                             sparsity="2:4", quantize=True, device="cpu")
    got = serve.generate(_bridged(smoke), cfg, scfg, prompt, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    eng = serve.warm_start_engine(scfg)
    assert {(req.op, req.in_bytes) for req, _ in eng.plan} == {
        ("gemm_sparse", 1)}


@pytest.mark.parametrize("cache", ["float32", "int8"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("backend", ["hopper", "torch-ref"])
def test_scheduler_sparse_int8_tokens_equal_reference(smoke, reference_runs,
                                                      cache, layout, backend):
    """Identical tokens per uid against the reference's Scheduler (each
    backend upgraded to its sparse sibling), on the same pruned int8
    weights carried through the bridge, both layouts,
    a float and an int8 KV cache; the port's own pruning of the seed-0
    tree serves the same tokens."""
    cfg = smoke[2]
    scfg = serve.ServeConfig(
        max_seq=MAX_SEQ, batch=3, compute_dtype="float32", cache_dtype=cache,
        kernel_backend=backend, sparsity="2:4", quantize=True, device="cpu",
        cache_layout=layout, page_size=4)
    assert scfg.kernel_backend == f"{backend}-sparse"
    want = reference_runs[cache, layout]
    trees = [_bridged(smoke)]
    if backend == "hopper":
        trees.append(prune_params(smoke[3], 2, 4, quantize=True))
    for tree in trees:
        reqs = [Request(uid=i, prompt=p, max_new_tokens=g)
                for i, (p, (_, g)) in enumerate(zip(_trace_prompts(cfg.vocab),
                                                    TRACE))]
        sched = Scheduler(tree, cfg, scfg)
        done = sched.run(reqs)
        assert sorted(done) == sorted(want)
        for uid, toks in want.items():
            np.testing.assert_array_equal(done[uid].tokens, toks,
                                          err_msg=f"uid={uid}")
        ops = {(req.op, req.in_bytes) for req, _ in sched.engine.plan
               if req.op != "paged_attention"}
        assert ops == {("gemm_sparse", 1)}
