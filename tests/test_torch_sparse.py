"""The port's N:M sparsity plane (float values) against the JAX package,
on the CPU: `sparse/` (parse, prune, densify), the sparse GEMM's plain
version, the sparse engine backends, `layers.dense`, and qwen2-1.5b SMOKE
served under `sparsity="2:4"`.

Inputs are drawn with numpy and handed to both packages; the SMOKE
weights are the JAX `init_params` tree, pruned by the JAX package and
carried across by the bridge.  The pruning and the densify are held bit
for bit (f32 magnitudes, the same stable sort, the same one-hot sum); the
products at the tolerance each test states (an f32 product in another
summation order); greedy tokens identical per uid.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jax_engine
from repro.configs import get_config as jax_get_config
from repro.kernels import sparse_gemm as jax_sg
from repro.models import transformer as JT
from repro.serve_lib import serve as jax_serve
from repro.serve_lib.scheduler import Request as JaxRequest
from repro.serve_lib.scheduler import Scheduler as JaxScheduler
from repro.sparse import densify_params as jax_densify_params
from repro.sparse import parse_sparsity as jax_parse_sparsity
from repro.sparse import prune_params as jax_prune_params
from repro.sparse import sparsify as jax_sparsify
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.engine import (BACKENDS, SPARSE_BACKENDS, Engine,
                                ExecutionPlan, HopperModel, KernelRequest,
                                sparse_sibling, use_engine)
from repro_torch.engine import cost
from repro_torch.kernels import sparse_gemm
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers
from repro_torch.quant import tree_bytes
from repro_torch.serve_lib import serve
from repro_torch.serve_lib.scheduler import Request, Scheduler
from repro_torch.sparse import (SparseTensor, densify, densify_params,
                                parse_sparsity, prune_params, sparsify)

ARCH = "qwen2-1.5b"
CSRC = Path(sparse_gemm.__file__).with_name("csrc") / "sparse_gemm.cu"
SPECS = [(1, 2), (2, 4), (1, 4), (4, 8), (3, 7)]
#: the port's backend names beside the JAX package's, name for name
JAX_NAME = {"hopper": "pallas-tpu", "torch-ref": "xla-einsum",
            "hopper-int8": "pallas-tpu-int8", "torch-ref-int8": "xla-int8",
            "hopper-sparse": "pallas-tpu-sparse",
            "torch-ref-sparse": "xla-sparse", "simulator": "simulator"}


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _message(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("ValueError", str(e))


# --------------------------------------------------------------------------
# sparse/: parse, prune, densify
# --------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["2:4", "1:2", "3:7", "127:128", "4:2",
                                  "0:4", "2:2", "2-4", "2:", "a:b", "1:129",
                                  " 2:4"])
def test_parse_sparsity_equals_reference(spec):
    assert _message(parse_sparsity, spec) == _message(jax_parse_sparsity,
                                                      spec)


@pytest.mark.parametrize("n,m", SPECS)
@pytest.mark.parametrize("k", [56, 61])         # a multiple of every M; ragged
def test_sparsify_and_densify_bitwise_equal_reference(n, m, k):
    x = _normal((2, k, 24), n * 100 + m)
    want = jax_sparsify(jnp.asarray(x), n, m)
    got = sparsify(torch.from_numpy(x), n, m)
    assert got.indices.dtype == torch.int8 and got.values.dtype == torch.float32
    assert (got.n, got.m, got.k_dense) == (n, m, k)
    assert got.shape == tuple(want.shape) == (2, k, 24)
    assert got.ndim == want.ndim and got.density == want.density
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(densify(got).numpy(),
                                  np.asarray(want.densify()))


@pytest.mark.parametrize("n,m", SPECS)
def test_tied_magnitudes_keep_the_earlier_offset(n, m):
    """Every magnitude tied (signs alternate), and one column of exact
    zeros: the stable sort keeps the first n offsets of each group."""
    k = 3 * m + 1
    x = np.ones((k, 6), np.float32)
    x[1::2] = -1.0
    x[:, 2] = 0.0
    x[:, 4] = np.tile(np.array([0.5, -0.5], np.float32), k)[:k]
    want = jax_sparsify(jnp.asarray(x), n, m)
    got = sparsify(torch.from_numpy(x), n, m)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    assert (got.indices.numpy()[:n] == np.arange(n)[:, None]).all()


def test_sparsify_keeps_bf16_values_exact():
    x = _normal((40, 16), 7)
    got = sparsify(torch.from_numpy(x).to(torch.bfloat16), 2, 4)
    want = jax_sparsify(jnp.asarray(x, jnp.bfloat16), 2, 4)
    assert got.values.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.values.float().numpy(),
                                  np.asarray(want.values, np.float32))
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))


def test_sparse_x_int8_is_refused_by_name():
    """Sparse x int8 storage is served now (tests/test_torch_sparse_int8.py
    holds it bit for bit): `quantize=True` gives int8 values and a (1, N)
    f32 scale, in `sparsify` and in `prune_params`, as the reference's;
    what it still refuses, it refuses by name, with or without
    `quantize`."""
    x = _normal((16, 8), 8)
    got = sparsify(torch.from_numpy(x), 2, 4, quantize=True)
    want = jax_sparsify(jnp.asarray(x), 2, 4, quantize=True)
    assert got.quantized and got.values.dtype == torch.int8
    assert got.scale.dtype == torch.float32 and got.scale.shape == (1, 8)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    tree = prune_params({"w": torch.from_numpy(x)}, 2, 4, quantize=True)
    assert torch.equal(tree["w"].values, got.values)
    for quantize in (False, True):
        with pytest.raises(ValueError, match="need 1 <= N < M"):
            sparsify(torch.from_numpy(x), 4, 4, quantize=quantize)


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_get_config(ARCH, smoke=True)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    jsp = jax_prune_params(jparams, 2, 4)
    return jcfg, jparams, jsp, get_config(ARCH, smoke=True), params


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def test_prune_params_bitwise_on_the_smoke_tree(smoke):
    _, _, jsp, _, params = smoke
    mine = dict(_leaves(prune_params(params, 2, 4)))
    want = dict(_leaves(jsp))
    assert mine.keys() == want.keys()
    n_sparse = 0
    for path, leaf in want.items():
        got = mine[path]
        if hasattr(leaf, "indices"):
            n_sparse += 1
            assert isinstance(got, SparseTensor), path
            assert (got.n, got.m, got.k_dense) == (leaf.n, leaf.m,
                                                   leaf.k_dense)
            np.testing.assert_array_equal(got.values.numpy(),
                                          np.asarray(leaf.values))
            np.testing.assert_array_equal(got.indices.numpy(),
                                          np.asarray(leaf.indices))
        else:
            assert isinstance(got, torch.Tensor), path
            np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))
    assert n_sparse == 7         # wq, wk, wv, wo, wi, wg and the MLP's wo
    assert tree_bytes(prune_params(params, 2, 4)) == sum(
        leaf.size * leaf.dtype.itemsize for leaf in jax.tree.leaves(jsp))


def test_prune_params_skip_list_as_in_reference():
    rng = np.random.default_rng(3)
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    tree = {"router": {"w": mk(8, 4)}, "ssm": {"in_proj": {"w": mk(8, 16)},
                                              "out_proj": {"w": mk(16, 8)}},
            "mlp": [{"w": mk(8, 8), "b": mk(8)}, {"w": mk(3, 8, 8)}],
            "norm": {"w": mk(8)}, "emb": mk(10, 8),
            "experts": {"wi": mk(2, 8, 4)}}
    want = jax_prune_params(jax.tree.map(jnp.asarray, tree), 1, 4)
    got = prune_params(params_from_numpy(tree, device="cpu"), 1, 4)
    for path, leaf in _leaves(want):
        node = got
        for p in path:
            node = node[p]
        assert isinstance(node, SparseTensor) == hasattr(leaf, "indices"), path
    assert isinstance(got["mlp"], list)
    assert isinstance(got["mlp"][1]["w"], SparseTensor)
    assert got["mlp"][1]["w"].values.shape == (3, 2, 8)
    assert not isinstance(got["router"]["w"], SparseTensor)
    assert not isinstance(got["experts"]["wi"], SparseTensor)


def test_densify_params_equals_reference(smoke):
    _, _, jsp, _, params = smoke
    mine = dict(_leaves(densify_params(prune_params(params, 2, 4))))
    for path, leaf in _leaves(jax_densify_params(jsp)):
        np.testing.assert_array_equal(mine[path].numpy(), np.asarray(leaf))


def test_bridge_carries_a_pruned_tree(smoke):
    _, _, jsp, _, params = smoke
    tree = jax.tree.map(np.asarray, jsp)
    for dtype in (None, torch.bfloat16):
        w = params_from_numpy(tree, device="cpu",
                              dtype=dtype)["stack"]["b0"]["mlp"]["wo"]["w"]
        assert isinstance(w, SparseTensor) and w.scale is None
        assert w.indices.dtype == torch.int8
        assert w.values.dtype == (dtype or torch.float32)
        assert (w.n, w.m, w.k_dense) == (2, 4, 128)
    carried = dict(_leaves(params_from_numpy(tree, device="cpu")))
    mine = dict(_leaves(prune_params(params, 2, 4)))
    for path, leaf in carried.items():
        if isinstance(leaf, SparseTensor):
            assert torch.equal(leaf.values, mine[path].values)
            assert torch.equal(leaf.indices, mine[path].indices)


def test_transformer_slices_a_stacked_sparse_tensor_per_period():
    from repro_torch.models.transformer import _index

    st = sparsify(torch.from_numpy(_normal((3, 18, 8), 9)), 3, 7)
    sl = _index({"w": st}, 1)["w"]
    assert isinstance(sl, SparseTensor)
    assert (sl.n, sl.m, sl.k_dense, sl.shape) == (3, 7, 18, (18, 8))
    assert torch.equal(sl.densify(), st.densify()[1])


# --------------------------------------------------------------------------
# The sparse GEMM's plain version against the JAX package's
# --------------------------------------------------------------------------


def _operands(m, k, n, nk, mg, seed):
    a = _normal((m, k), seed)
    st = jax_sparsify(jnp.asarray(_normal((k, n), seed + 1)), nk, mg)
    return a, np.array(st.values), np.array(st.indices)


def _plain(a, v, i, nk, mg, out_dtype=None):
    return sparse_gemm.sparse_gemm_reference(
        torch.from_numpy(a), torch.from_numpy(v), torch.from_numpy(i),
        n_keep=nk, m_group=mg, out_dtype=out_dtype)


@pytest.mark.parametrize("n_keep,m_group", SPECS)
@pytest.mark.parametrize("m,k,n", [(5, 64, 96), (13, 44, 21), (8, 256, 128)])
def test_plain_version_equals_xla_sparse(n_keep, m_group, m, k, n):
    """Against the JAX package's `use_pallas=False` branch in f32, at
    rtol 1e-6, atol 1e-5 (both scatter the same f32 tile; the product sums
    in another order)."""
    a, v, i = _operands(m, k, n, n_keep, m_group, 11)
    want = jax_sg.sparse_gemm(jnp.asarray(a), jnp.asarray(v), jnp.asarray(i),
                              n_keep=n_keep, m_group=m_group,
                              use_pallas=False)
    got = _plain(a, v, i, n_keep, m_group)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("n_keep,m_group,m,k,n", [
    (2, 4, 16, 32, 16), (2, 4, 13, 44, 21), (1, 4, 8, 256, 128),
    (3, 7, 5, 70, 24)])
def test_plain_version_equals_pallas_kernel_in_interpret_mode(n_keep,
                                                              m_group, m, k,
                                                              n):
    """Against the Pallas kernel in interpret mode, at rtol 1e-5, atol 1e-4:
    not bit for bit, since the reference's own Pallas/XLA pair is not on
    this tree (ROADMAP.md queue 3, caveats)."""
    a, v, i = _operands(m, k, n, n_keep, m_group, 12)
    want = jax_sg.sparse_gemm(jnp.asarray(a), jnp.asarray(v), jnp.asarray(i),
                              n_keep=n_keep, m_group=m_group,
                              use_pallas=True, interpret=True)
    got = _plain(a, v, i, n_keep, m_group)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


def test_scatter_is_the_one_hot_sum_for_any_index_array():
    """An offset outside 0..M-1 (M itself, 100, -1, -128) adds nothing,
    and two kept values at one offset add: as the reference's
    `_scatter_dense`, bit for bit, and as written out by hand."""
    rng = np.random.default_rng(13)
    v = rng.normal(size=(6, 5)).astype(np.float32)       # 3 groups of 2:4
    i = np.array([[0, 1, 2, 3, 0], [1, 1, 4, 100, 3],
                  [2, 2, -1, 3, 0], [-128, 3, 2, 2, 0],
                  [3, 0, 1, 127, 2], [3, 0, 1, 1, 2]], np.int8)
    want = np.asarray(jax_sg._scatter_dense(jnp.asarray(v), jnp.asarray(i),
                                            2, 4))
    got = sparse_gemm.scatter_dense(torch.from_numpy(v), torch.from_numpy(i),
                                    2, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    by_hand = np.zeros((12, 5), np.float32)
    for r in range(6):
        for c in range(5):
            if 0 <= i[r, c] < 4:
                by_hand[(r // 2) * 4 + i[r, c], c] += v[r, c]
    np.testing.assert_array_equal(got.numpy(), by_hand)
    a = _normal((3, 12), 14)
    want = jax_sg.sparse_gemm(jnp.asarray(a), jnp.asarray(v), jnp.asarray(i),
                              n_keep=2, m_group=4, use_pallas=False)
    np.testing.assert_allclose(_plain(a, v, i, 2, 4).numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_sparse_gemm_on_the_cpu_is_its_plain_version(out):
    a, v, i = _operands(9, 100, 40, 2, 4, 15)
    args = (torch.from_numpy(a), torch.from_numpy(v), torch.from_numpy(i))
    out = getattr(torch, out)
    sparse_gemm.reset_launches()
    got = sparse_gemm.sparse_gemm(*args, n_keep=2, m_group=4, out_dtype=out)
    assert sparse_gemm.launches == 0
    assert got.dtype == out
    assert torch.equal(got, sparse_gemm.sparse_gemm_reference(
        *args, n_keep=2, m_group=4, out_dtype=out))


@pytest.mark.parametrize("bad", ["tile", "dtype", "int8", "k", "shape",
                                 "spec", "path", "split 0", "split limit",
                                 "split float", "tiled split", "decode tile",
                                 "decode rows"])
def test_sparse_gemm_refuses_what_the_kernel_does_not_take(bad):
    """Every argument the kernels do not take raises, on the CPU too (the
    check runs before the plain version): a tile off the menu, a path the
    kernel lacks, a split_k outside 1..SPLIT_LIMIT or not an int, a split
    on the tiled path, a tile on the decode path, M above its rows."""
    a, v, i = (torch.from_numpy(x) for x in _operands(4, 64, 32, 2, 4, 16))
    kw = {"n_keep": 2, "m_group": 4}
    want, match = ValueError, None
    decode = {"path": "decode", "split_k": 2}
    if bad == "tile":
        kw["tile"], match = (16, 64, 64), "menu"
    elif bad == "path":
        kw["path"], match = "sparse", "not one of the kernel's"
    elif bad.startswith("split"):
        split = {"split 0": 0, "split limit": sparse_gemm.SPLIT_LIMIT + 1,
                 "split float": 2.0}[bad]
        kw.update(decode, split_k=split)
        match = "split_k must be an int"
    elif bad == "tiled split":
        kw["split_k"], match = 2, "tiled path takes split_k 1"
    elif bad == "decode tile":
        kw.update(decode, tile=sparse_gemm.TILES[0])
        match = "takes no tile"
    elif bad == "decode rows":
        a = torch.from_numpy(_normal((17, 64), 16))
        kw.update(decode)
        match = "largest row bucket 16"
    elif bad == "dtype":
        a, want, match = a.double(), TypeError, "bf16 or f32"
    elif bad == "int8":
        # int8 values are taken; int8 activations are not
        a, v = a.to(torch.int8), v.to(torch.int8)
        want, match = TypeError, "bf16 or f32 activations"
    elif bad == "k":
        a, match = a[:, :59].contiguous(), "compressed K 32 does not match"
    elif bad == "shape":
        i, match = i[:, :16], "mismatch"
    else:
        kw["m_group"], match = 2, "1 <= N < M"
    with pytest.raises(want, match=match):
        sparse_gemm.sparse_gemm(a, v, i, **kw)


def test_cuda_source_menu_equals_the_wrapper_menu():
    """The tiled menu and the decode row buckets are the CUDA source's
    macros; every tile fits a block with one stage of a full chunk (every
    spec), and bf16 tiles keep two stages at every spec."""
    src = CSRC.read_text()
    block = src[src.index("#define SPARSE_TILES"):].split("\n\n")[0]
    menu = tuple((int(a), int(b), int(c)) for a, b, c in
                 re.findall(r"X\((\d+), (\d+), (\d+)\)", block))
    assert menu == sparse_gemm.TILES
    block = src[src.index("#define SPARSE_DECODE_ROWS"):].split("\n\n")[0]
    rows = tuple(int(r) for r in re.findall(r"X\((\d+)\)", block))
    assert rows == sparse_gemm.DECODE_ROWS
    assert all(bk >= 128 for _, bk, _ in menu)       # one group of M = 128
    specs = [(n, m) for m in range(2, 129) for n in range(1, m)]
    for tile in menu:
        for in_bytes in (2, 4):
            assert sparse_gemm.smem_bytes(*tile, in_bytes) <= 232_448
        assert all(sparse_gemm.tiled_stages(tile, 2, n, m) == 2
                   for n, m in specs)
        assert sparse_gemm.smem_bytes(*tile, 2, 127, 2) <= 232_448
    # f32 at the wide tiles falls back to one stage where two do not fit
    assert sparse_gemm.tiled_stages((128, 128, 128), 4, 2, 4) == 1
    assert sparse_gemm.tiled_stages((16, 128, 64), 4, 127, 128) == 2


# --------------------------------------------------------------------------
# Engine: the sparse backends, keying and planning
# --------------------------------------------------------------------------


def test_sparse_backends_and_their_names():
    assert SPARSE_BACKENDS == ("hopper-sparse", "torch-ref-sparse")
    assert set(SPARSE_BACKENDS) <= set(BACKENDS)
    assert sparse_sibling(None) == "hopper-sparse"
    with pytest.raises(ValueError, match="cannot upgrade"):
        sparse_sibling("xla-sparse")
    assert Engine(backend="hopper-sparse").sparse
    assert not Engine(backend="hopper").sparse
    assert not Engine(backend="hopper-sparse").int8


@pytest.mark.parametrize("given", [None, *BACKENDS])
def test_serveconfig_sparsity_upgrades_as_the_reference(given):
    """The port's upgrade of each backend name is the reference's, name
    for name (the reference's None is per host; the port's is the card's
    kernel).  The simulator has no sparse sibling in either package."""
    if given == "simulator":
        with pytest.raises(ValueError, match="cannot upgrade"):
            serve.ServeConfig(max_seq=8, batch=1, kernel_backend=given,
                              sparsity="2:4", device="cpu")
        with pytest.raises(ValueError, match="cannot upgrade"):
            jax_serve.ServeConfig(max_seq=8, batch=1,
                                  kernel_backend=JAX_NAME[given],
                                  sparsity="2:4")
        return
    scfg = serve.ServeConfig(max_seq=8, batch=1, kernel_backend=given,
                             sparsity="2:4", device="cpu")
    assert scfg.kernel_backend in SPARSE_BACKENDS
    assert serve.warm_start_engine(scfg).sparse
    if given is None:
        assert scfg.kernel_backend == "hopper-sparse"
        return
    want = jax_serve.ServeConfig(max_seq=8, batch=1,
                                 kernel_backend=JAX_NAME[given],
                                 sparsity="2:4").kernel_backend
    assert JAX_NAME[scfg.kernel_backend] == want


def test_serveconfig_sparsity_refuses_what_it_cannot_serve():
    with pytest.raises(ValueError, match="need 1 <= N < M"):
        serve.ServeConfig(max_seq=8, batch=1, sparsity="4:2", device="cpu")
    with pytest.raises(ValueError, match="cannot upgrade"):
        serve.ServeConfig(max_seq=8, batch=1, sparsity="2:4",
                          kernel_backend="simulator", device="cpu")
    # sparse x int8 is served (the int8 upgrade, then the sparse one), but
    # not from a backend without an int8 sibling
    assert serve.ServeConfig(max_seq=8, batch=1, sparsity="2:4",
                             quantize=True,
                             device="cpu").kernel_backend == "hopper-sparse"
    with pytest.raises(ValueError, match="cannot upgrade"):
        serve.ServeConfig(max_seq=8, batch=1, sparsity="2:4", quantize=True,
                          kernel_backend="simulator", device="cpu")


def test_registry_holds_the_sparse_backends():
    from repro_torch.engine import default_registry

    reg = default_registry()
    names = {(b, op): reg.get(b, op).__name__ for b in SPARSE_BACKENDS
             for op in ("gemm_sparse", "gemm", "grouped_gemm", "attention",
                        "paged_attention")}
    assert names == {
        ("hopper-sparse", "gemm_sparse"): "hopper_sparse_gemm",
        ("torch-ref-sparse", "gemm_sparse"): "ref_sparse_gemm",
        ("hopper-sparse", "gemm"): "hopper_gemm",
        ("torch-ref-sparse", "gemm"): "ref_gemm",
        ("hopper-sparse", "grouped_gemm"): "ref_grouped_gemm",
        ("torch-ref-sparse", "grouped_gemm"): "ref_grouped_gemm",
        ("hopper-sparse", "attention"): "plain_attention",
        ("torch-ref-sparse", "attention"): "plain_attention",
        ("hopper-sparse", "paged_attention"): "hopper_paged_attention",
        ("torch-ref-sparse", "paged_attention"): "ref_paged_attention"}
    for b in ("hopper", "hopper-int8"):
        assert not reg.has(b, "gemm_sparse")


def test_hopper_sparse_backend_snaps_a_foreign_tile_to_its_menu():
    """A decision planned for another kernel (a TPU block from a
    warm-start plan) runs at the sparse menu's nearest tile."""
    from repro_torch.engine import KernelDecision, default_registry
    from repro_torch.kernels import quant_gemm

    assert quant_gemm.snap_tile(8, 512, 128,
                                tiles=sparse_gemm.TILES) in sparse_gemm.TILES
    assert quant_gemm.snap_tile(16, 128, 64,
                                tiles=sparse_gemm.TILES) == (16, 128, 64)
    a, v, i = (torch.from_numpy(x) for x in _operands(6, 40, 24, 2, 4, 25))
    fn = default_registry().get("hopper-sparse", "gemm_sparse")
    got = fn(KernelDecision("gemm_sparse", "os", 8, 512, 128), a, v, i,
             n_keep=2, m_group=4)
    assert torch.equal(got, sparse_gemm.sparse_gemm_reference(
        a, v, i, n_keep=2, m_group=4))
    # a decode decision names its path and split (the decision's tile is
    # informational there), and a bad split in one raises
    from repro_torch.engine.backends import sparse_args
    dec = HopperModel().decide(KernelRequest("gemm_sparse", 6, 40, 24,
                                             in_bytes=4, out_bytes=4,
                                             density=0.5))
    assert sparse_args(dec) == {"path": "decode", "split_k":
                                dec.meta_dict["split_k"]}
    assert torch.equal(fn(dec, a, v, i, n_keep=2, m_group=4), got)
    bad = KernelDecision("gemm_sparse", "os", 8, 20, 256,
                         meta=(("path", "decode"), ("split_k", 0)))
    with pytest.raises(ValueError, match="split_k must be an int"):
        fn(bad, a, v, i, n_keep=2, m_group=4)


@pytest.mark.parametrize("backend", SPARSE_BACKENDS)
def test_sparse_matmul_keys_density_and_equals_reference(backend):
    """Density is part of the key: 2:4 and 1:4 storage of one shape plan
    apart, and apart from a dense GEMM of that shape; the products equal
    the reference's `xla-sparse` engine at rtol 1e-6, atol 1e-5."""
    a = _normal((16, 64), 17)
    w = _normal((64, 32), 18)
    eng = Engine(backend=backend)
    for n, m in ((2, 4), (1, 4)):
        st = sparsify(torch.from_numpy(w), n, m)
        with jax_engine.use_engine(backend="xla-sparse") as jeng:
            want = jeng.sparse_matmul(jnp.asarray(a),
                                      jax_sparsify(jnp.asarray(w), n, m))
        got = eng.sparse_matmul(torch.from_numpy(a), st)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-5)
    eng.matmul(torch.from_numpy(a), torch.from_numpy(w))
    reqs = sorted((req.op, req.density) for req, _ in eng.plan)
    assert reqs == [("gemm", 1.0), ("gemm_sparse", 0.25), ("gemm_sparse", 0.5)]
    assert eng.plan.stats["misses"] == 3
    eng.sparse_matmul(torch.from_numpy(a), sparsify(torch.from_numpy(w), 2, 4))
    assert eng.plan.stats["misses"] == 3 and eng.plan.hits == 1


def test_sparse_request_keys_apart_and_survives_json(tmp_path):
    """Density keys a sparse request apart; a decision with its path and
    split_k (decode at M = 8, tiled at M = 64) survives the plan's JSON
    and names the same kernel arguments after it."""
    from repro_torch.engine.backends import sparse_args

    dense = KernelRequest("gemm", 64, 256, 64)
    half = KernelRequest("gemm_sparse", 64, 256, 64, density=0.5)
    quarter = KernelRequest("gemm_sparse", 64, 256, 64, density=0.25)
    decode = KernelRequest("gemm_sparse", 8, 8960, 1536, density=0.5)
    assert len({dense.key(), half.key(), quarter.key()}) == 3
    plan = ExecutionPlan()
    model = HopperModel()
    plan.add(dense, model.decide(dense))
    assert plan.lookup(half) is None
    plan.add(half, model.decide(half))
    assert plan.lookup(quarter) is None
    plan.add(decode, model.decide(decode))
    plan.save(tmp_path / "plan.json")
    loaded = ExecutionPlan.load(tmp_path / "plan.json")
    assert loaded.lookup(half) is not None
    assert loaded.lookup(quarter) is None
    assert [r.density for r, _ in loaded] == [1.0, 0.5, 0.5]
    for req in (half, decode):
        before, after = plan.decisions[req.key()], loaded.lookup(req)
        assert after == before
        assert sparse_args(after) == sparse_args(before)
    assert sparse_args(loaded.lookup(decode)) == {
        "path": "decode", "split_k": 44}
    assert sparse_args(loaded.lookup(half))["path"] == "tiled"
    assert ExecutionPlan.from_json(loaded.to_json()).to_json() == \
        loaded.to_json()


def test_sparse_matmul_refuses_quantized_storage_and_a_wrong_k():
    """Quantized storage is served now, keyed at in_bytes 1 (apart from
    float storage of the same shape); a wrong K is still refused, and so
    is a scale the kernel does not take."""
    st = sparsify(torch.from_numpy(_normal((64, 32), 19)), 2, 4)
    a = torch.from_numpy(_normal((4, 64), 20))
    q = SparseTensor(st.values.to(torch.int8), st.indices,
                     torch.full((1, 32), 0.5), n=2, m=4, k_dense=64)
    eng = Engine(backend="hopper-sparse")
    got = eng.sparse_matmul(a, q)
    assert torch.equal(got, sparse_gemm.sparse_gemm_reference(
        a, q.values, q.indices, q.scale, n_keep=2, m_group=4))
    eng.sparse_matmul(a, st)
    assert sorted(req.in_bytes for req, _ in eng.plan) == [1, 4]
    with pytest.raises(ValueError, match="dim mismatch"):
        eng.sparse_matmul(a[:, :60].contiguous(), st)
    bad = SparseTensor(q.values, q.indices, q.scale.double(), n=2, m=4,
                       k_dense=64)
    with pytest.raises(TypeError, match="scale must be f32"):
        Engine(backend="hopper-sparse").sparse_matmul(a, bad)


@pytest.mark.parametrize("m", [1, 4, 8, 16, 17, 2048, 5])
@pytest.mark.parametrize("in_bytes", [2, 4])
def test_hopper_plans_sparse_on_the_kernel_menu(m, in_bytes):
    """M up to the decode rows (16) plans the decode path with a split_k
    that covers the card (blocks >= 132) unless each split is already at
    its depth floor, streaming fewer bytes than the dense weight; above
    it, OS on the tiled menu at K_eff = density x K plus one index byte
    per kept value, cheaper than the dense product at the same tile under
    the same roofline (the dense float GEMM itself is planned by the
    wgmma kernel's fitted wave term, another kernel's model)."""
    for k, n in ((1536, 1536), (1536, 256), (1536, 8960), (8960, 1536)):
        req = KernelRequest("gemm_sparse", m, k, n, in_bytes=in_bytes,
                            out_bytes=in_bytes, density=0.5)
        dec = HopperModel().decide(req)
        meta = dec.meta_dict
        assert dec.dataflow == "os"
        assert meta["k_effective"] == k // 2 and meta["density"] == 0.5
        if m <= sparse_gemm.DECODE_ROWS[-1]:
            split = meta["split_k"]
            assert meta["path"] == "decode"
            assert dec.bm == sparse_gemm.decode_rows(m)
            assert dec.bn == sparse_gemm.decode_columns(in_bytes)
            assert meta["blocks"] == -(-n // dec.bn) * split
            assert (meta["blocks"] >= cost.SMS
                    or split == k // 2 // cost.DECODE_MIN_ROWS)
            assert meta["workspace_bytes"] == (2 * split * m * n * 4
                                               if split > 1 else 0)
            top = k // 2 // cost.DECODE_MIN_ROWS
            assert 1 <= split <= top
            assert dec.seconds == min(cost.decode_cost(req, s)["seconds"]
                                      for s in range(1, top + 1))
            # it streams the compressed weight, fewer bytes than the dense
            streamed = (meta["hbm_bytes"] - meta["workspace_bytes"]
                        - m * n * in_bytes - m * k * in_bytes)
            assert streamed == k // 2 * n * (in_bytes + 1) < k * n * in_bytes
            continue
        assert meta["path"] == "tiled" and meta["split_k"] == 1
        assert (dec.bm, dec.bk, dec.bn) in sparse_gemm.TILES
        stages = meta["stages"]
        assert meta["smem_bytes"] == sparse_gemm.smem_bytes(
            dec.bm, dec.bk, dec.bn, in_bytes, dec.bk // 2,
            stages) <= cost.SMEM_LIMIT
        assert stages == sparse_gemm.tiled_stages(
            (dec.bm, dec.bk, dec.bn), in_bytes, 2, 4)
        cfg = cost.TileConfig("os", dec.bm, dec.bk, dec.bn)
        body, bytes_, _ = cost.estimate(m, k // 2, n, cfg, in_bytes,
                                        in_bytes)
        assert meta["hbm_bytes"] == bytes_ + k // 2 * n
        assert dec.seconds == body + k // 2 * n / cost.HBM_BW
        dense = cost.estimate(m, k, n, cfg, in_bytes, in_bytes)[0]
        assert dec.seconds < dense


@pytest.mark.parametrize("n_keep,m_group", SPECS + [(127, 128), (63, 64)])
@pytest.mark.parametrize("k", [56, 61, 1003, 8960])
def test_split_group_ranges_cover_every_group_once(n_keep, m_group, k):
    """The (base, extra) of `split_groups`, which the wrapper passes the
    decode kernel, gives each split the groups [s base + min(s, extra),
    + base + (s < extra)) (the kernel's formula): every group of a ragged
    or whole K exactly once, in order, at split 1, the planner's split,
    one group a split, and splits past the groups (empty, as the kernel
    takes them)."""
    groups = -(-k // m_group)
    req = KernelRequest("gemm_sparse", 8, k, 1536, density=n_keep / m_group)
    planned = HopperModel().decide(req).meta_dict["split_k"]
    top = sparse_gemm.max_split(k, m_group)
    assert top == groups
    for split in {1, 2, 7, planned, top, top + 5}:
        base, extra = sparse_gemm.split_groups(groups, split)
        assert base * split + extra == groups and 0 <= extra < split
        ranges = [(s * base + min(s, extra),
                   s * base + min(s, extra) + base + (s < extra))
                  for s in range(split)]
        taken = [g for lo, hi in ranges for g in range(lo, hi)]
        assert taken == list(range(groups))
        sizes = [hi - lo for lo, hi in ranges]
        assert max(sizes) - min(sizes) <= 1


# --------------------------------------------------------------------------
# layers.dense
# --------------------------------------------------------------------------


@pytest.mark.parametrize("backend", SPARSE_BACKENDS)
def test_dense_dispatches_gemm_sparse_on_a_sparse_engine(backend):
    w = _normal((32, 16), 21)
    x = torch.from_numpy(_normal((2, 4, 32), 22))
    p = {"w": sparsify(torch.from_numpy(w), 2, 4), "b": torch.ones(16)}
    with use_engine(backend=backend) as eng:
        out = layers.dense(p, x)
    assert {req.op for req, _ in eng.plan} == {"gemm_sparse"}
    assert out.shape == (2, 4, 16)
    want = x @ p["w"].densify() + 1.0
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("backend", [None, "hopper", "torch-ref",
                                     "hopper-int8", "torch-ref-int8"])
def test_dense_densifies_off_a_sparse_engine(backend):
    """No engine, a float engine or an int8 engine: the weight densifies
    to the compute dtype and takes that posture's dense matmul."""
    w = _normal((32, 16), 23)
    x = torch.from_numpy(_normal((4, 32), 24))
    p = {"w": sparsify(torch.from_numpy(w), 2, 4)}
    wf = p["w"].densify()
    if backend is None:
        out = layers.dense(p, x)
        want = x @ wf
    else:
        with use_engine(backend=backend) as eng:
            out = layers.dense(p, x)
        assert {req.op for req, _ in eng.plan} == {"gemm"}
        with use_engine(backend=backend):
            want = layers.dense({"w": wf}, x)
    assert torch.equal(out, want)
    ref = np.asarray(jnp.asarray(x.numpy()) @ jax_sparsify(
        jnp.asarray(w), 2, 4).densify())
    np.testing.assert_allclose(layers.dense(p, x).numpy(), ref, rtol=1e-6,
                               atol=1e-6)


# --------------------------------------------------------------------------
# qwen2-1.5b SMOKE under sparsity="2:4": tokens against the reference
# --------------------------------------------------------------------------


TRACE = [(6, 8), (10, 2), (6, 5), (14, 9), (10, 3), (6, 7), (14, 2), (10, 6)]


def _trace_prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, p).astype(np.int32) for p, _ in TRACE]


@pytest.fixture(scope="module")
def reference_runs(smoke):
    """The reference's own sparse serve of its pruned seed-0 weights
    (sparsity="2:4" resolves to "xla-sparse"): its Scheduler on
    tests/test_sparse.py's 8-request trace, f32, contiguous and paged, and
    its `generate` on two prompts."""
    jcfg, _, jsp, _, _ = smoke
    prompts = _trace_prompts(jcfg.vocab)
    max_seq = max(p + g for p, g in TRACE) + 1
    runs = {}
    for layout in ("contiguous", "paged"):
        scfg = jax_serve.ServeConfig(
            max_seq=max_seq, batch=3, compute_dtype=jnp.float32,
            cache_dtype=jnp.float32, sparsity="2:4", cache_layout=layout,
            page_size=4)
        assert scfg.kernel_backend == "xla-sparse"
        done = JaxScheduler(jsp, jcfg, scfg).run(
            [JaxRequest(uid=i, prompt=p, max_new_tokens=g)
             for i, (p, (_, g)) in enumerate(zip(prompts, TRACE))])
        runs[layout] = {u: np.asarray(c.tokens) for u, c in done.items()}
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 11))
    scfg = jax_serve.ServeConfig(max_seq=20, batch=2,
                                 compute_dtype=jnp.float32,
                                 cache_dtype=jnp.float32, sparsity="2:4")
    runs["generate"] = (tokens.astype(np.int32), np.asarray(jax_serve.generate(
        jsp, jcfg, scfg, jnp.asarray(tokens, jnp.int32), 6)))
    return runs


def _bridged(smoke):
    return params_from_numpy(jax.tree.map(np.asarray, smoke[2]), device="cpu")


@pytest.mark.parametrize("backend", [None, "hopper", "torch-ref"])
def test_generate_sparse_tokens_equal_reference(smoke, reference_runs,
                                                backend):
    cfg = smoke[3]
    prompt, want = reference_runs["generate"]
    scfg = serve.ServeConfig(max_seq=20, batch=2, compute_dtype="float32",
                             cache_dtype="float32", kernel_backend=backend,
                             sparsity="2:4", device="cpu")
    got = serve.generate(_bridged(smoke), cfg, scfg, prompt, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    eng = serve.warm_start_engine(scfg)
    assert {req.op for req, _ in eng.plan} == {"gemm_sparse"}
    assert all(req.density == 0.5 for req, _ in eng.plan)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("backend", SPARSE_BACKENDS)
def test_scheduler_sparse_tokens_equal_reference(smoke, reference_runs,
                                                 layout, backend):
    """Identical tokens per uid against the reference's Scheduler, on the
    same pruned weights carried through the bridge."""
    cfg = smoke[3]
    scfg = serve.ServeConfig(
        max_seq=max(p + g for p, g in TRACE) + 1, batch=3,
        compute_dtype="float32", cache_dtype="float32",
        kernel_backend=backend, sparsity="2:4", device="cpu",
        cache_layout=layout, page_size=4)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=g) for i, (p, (_, g))
            in enumerate(zip(_trace_prompts(cfg.vocab), TRACE))]
    sched = Scheduler(_bridged(smoke), cfg, scfg)
    done = sched.run(reqs)
    want = reference_runs[layout]
    assert sorted(done) == sorted(want)
    for uid, toks in want.items():
        np.testing.assert_array_equal(done[uid].tokens, toks,
                                      err_msg=f"uid={uid}")
    ops = {req.op for req, _ in sched.engine.plan}
    assert "gemm_sparse" in ops and "gemm" not in ops


def test_scheduler_sparse_tokens_equal_the_densified_oracle(smoke):
    """The reference's test_scheduler_sparse_greedy_parity_vs_densified_
    oracle on the port: the port's own pruning of the seed-0 tree on the
    sparse engine serves the trace with exactly the tokens of its
    densified weights served plain."""
    cfg, params = smoke[3], smoke[4]
    sp = prune_params(params, 2, 4)
    max_seq = max(p + g for p, g in TRACE) + 1
    runs = {}
    for name, tree, sparsity in (("sparse", sp, "2:4"),
                                 ("oracle", densify_params(sp), None)):
        scfg = serve.ServeConfig(max_seq=max_seq, batch=3,
                                 compute_dtype="float32", sparsity=sparsity,
                                 device="cpu")
        done = Scheduler(tree, cfg, scfg).run(
            [Request(uid=i, prompt=p, max_new_tokens=g) for i, (p, (_, g))
             in enumerate(zip(_trace_prompts(cfg.vocab), TRACE))])
        runs[name] = {u: c.tokens.tolist() for u, c in done.items()}
    assert runs["sparse"] == runs["oracle"]


# --------------------------------------------------------------------------
# The launcher
# --------------------------------------------------------------------------


@pytest.mark.parametrize("trace", [None, "24x8,8x4*3"])
def test_launcher_serves_sparsity_on_the_cpu(trace):
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--sparsity", "2:4",
            "--batch", "2"]
    args += (["--prompt-len", "8", "--gen", "4"] if trace is None else
             ["--cache-layout", "paged", "--page-size", "8", "--trace", trace])
    out = launch_serve.main(args)
    assert out["serve_config"].kernel_backend == "hopper-sparse"
    assert isinstance(out["params"]["stack"]["b0"]["mlp"]["wi"]["w"],
                      SparseTensor)
    assert {req.op for req, _ in out["engine"].plan} >= {"gemm_sparse"}
    if trace is None:
        assert tuple(out["tokens"].shape) == (2, 4)
        want = serve.generate(densify_params(out["params"]), out["cfg"],
                              serve.ServeConfig(
                                  max_seq=13, batch=2,
                                  compute_dtype="float32",
                                  cache_dtype="float32", device="cpu"),
                              out["prompt"], 4)
        assert torch.equal(out["tokens"], want)
    else:
        assert out["requests"] == 4


def test_launcher_refuses_sparsity_with_quantize():
    """`--sparsity` with `--quantize` serves sparse x int8 now
    (tests/test_torch_sparse_int8.py drives it); a bad spec is refused
    with or without `--quantize`."""
    out = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--sparsity", "2:4", "--quantize", "--batch",
                             "1", "--prompt-len", "4", "--gen", "2"])
    assert out["params"]["stack"]["b0"]["mlp"]["wi"]["w"].quantized
    for extra in ([], ["--quantize"]):
        with pytest.raises(ValueError, match="need 1 <= N < M"):
            launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                               "--sparsity", "4:4", *extra])
