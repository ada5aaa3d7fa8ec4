"""The port's grouped (per-expert) GEMM on the CPU: the plain version of
`kernels/grouped_gemm.py` against the JAX Pallas kernel (interpret mode)
and the JAX plain version, the CPU path of its wrapper and its checks,
the tile menu the CUDA source is compiled for, `HopperModel`'s grouped
decision, and the engine entry point `Engine.grouped_matmul` (memo key,
dim check and plan counts as in the JAX engine).

The CUDA kernel runs only on the card: `chip_smoke.py` and
tests/test_torch_card.py hold it against this plain version there.
Tolerance rtol 2e-5, atol 2e-4, as tests/test_kernels.py holds the f32
TPU kernels to their oracle (f32 both sides; only the order of sums
differs); a bf16 output within one bf16 ulp (rtol 2^-7), the f32 sums
then rounding either way.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jax_engine
from repro.kernels import grouped_gemm as jgg
from repro.kernels.ref import grouped_matmul_ref
from repro_torch.engine import Engine, HopperModel, KernelRequest, cost
from repro_torch.kernels import grouped_gemm

TOL = {"rtol": 2e-5, "atol": 2e-4}


def _operands(e, c, d, f, seed=0, zero_rows=0):
    """x (E, C, D) with its last `zero_rows` rows of every expert zero
    (capacity padding), w (E, D, F)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(e, c, d)).astype(np.float32)
    if zero_rows:
        x[:, c - zero_rows:] = 0.0
    w = (rng.normal(size=(e, d, f)) / np.sqrt(d)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("e,c,d,f,zero_rows", [
    (4, 16, 64, 32, 0),
    (3, 20, 40, 24, 8),        # ragged C, D and F; capacity-padded rows
    (8, 4, 64, 32, 3),         # decode capacity: 4 rows, mostly zeros
    (2, 37, 130, 70, 0),       # nothing a multiple of anything
])
def test_plain_version_matches_pallas_kernel_and_jax_ref(e, c, d, f,
                                                         zero_rows):
    x, w = _operands(e, c, d, f, seed=c, zero_rows=zero_rows)
    got = grouped_gemm.grouped_matmul_reference(torch.from_numpy(x),
                                                torch.from_numpy(w)).numpy()
    pallas = jgg.grouped_matmul(jnp.asarray(x), jnp.asarray(w),
                                interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    ref = grouped_matmul_ref(jnp.asarray(x.reshape(e * c, d)), jnp.asarray(w),
                             [c] * e)
    np.testing.assert_allclose(got, np.asarray(ref).reshape(e, c, f), **TOL)
    if zero_rows:
        assert not got[:, c - zero_rows:].any()   # zero rows stay exact zeros


def test_wrapper_on_cpu_takes_plain_version_without_counting():
    x, w = (torch.from_numpy(a) for a in _operands(3, 20, 40, 24, seed=1))
    grouped_gemm.reset_launches()
    for tile in grouped_gemm.TILES:
        got = grouped_gemm.grouped_matmul(x, w, tile=tile)
        torch.testing.assert_close(
            got, grouped_gemm.grouped_matmul_reference(x, w), rtol=0, atol=0)
    assert grouped_gemm.launches == 0
    half = grouped_gemm.grouped_matmul_reference(x.bfloat16(), w.bfloat16())
    assert half.dtype == torch.bfloat16


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, w = (torch.from_numpy(a) for a in _operands(2, 8, 16, 24))
    tile = grouped_gemm.TILES[0]
    with pytest.raises(ValueError, match="menu"):
        grouped_gemm.grouped_matmul(x, w, tile=(8, 128, 128))
    with pytest.raises(ValueError, match="mismatch"):
        grouped_gemm.grouped_matmul(x, w[:, :-1], tile=tile)
    with pytest.raises(ValueError, match="mismatch"):
        grouped_gemm.grouped_matmul(x, w[:1], tile=tile)
    with pytest.raises(ValueError, match=r"\(E, C, D\)"):
        grouped_gemm.grouped_matmul(x[0], w, tile=tile)
    with pytest.raises(ValueError, match="contiguous"):
        grouped_gemm.grouped_matmul(x.transpose(1, 2).contiguous()
                                    .transpose(1, 2), w, tile=tile)
    with pytest.raises(TypeError):
        grouped_gemm.grouped_matmul(x.double(), w.double(), tile=tile)
    with pytest.raises(TypeError, match="bf16 or f32"):
        grouped_gemm.grouped_matmul(x, w, tile=tile, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="empty"):
        grouped_gemm.grouped_matmul(x[:, :0], w, tile=tile)


def test_tile_menu_matches_the_cuda_source():
    src = (Path(grouped_gemm.__file__).with_name("csrc")
           / "grouped_gemm.cu").read_text()
    block = src[src.index("#define GROUPED_TILES"):]
    block = block[:block.index("\n\n")]
    tiles = tuple(tuple(int(v) for v in t)
                  for t in re.findall(r"X\((\d+), (\d+), (\d+)\)", block))
    assert tiles == grouped_gemm.TILES
    for in_bytes in (2, 4):
        assert all(grouped_gemm.smem_bytes(*t, in_bytes)
                   <= grouped_gemm.SMEM_LIMIT for t in tiles)


#: granite's expert GEMMs at 8 slots: decode (C = 8 x 4) and the prefill
#: of a 768-token bucket (C = 8 x 240), for wi/wg (D=1024, F=512) and wo
GRANITE = [(32, c, d, f) for c in (32, 1920) for d, f in ((1024, 512),
                                                           (512, 1024))]


@pytest.mark.parametrize("in_bytes", [2, 4])
@pytest.mark.parametrize("e,c,d,f", GRANITE + [(8, 20, 40, 24)])
def test_hopper_grouped_decision_is_os_on_the_menu(e, c, d, f, in_bytes):
    req = KernelRequest("grouped_gemm", c, d, f, groups=e, in_bytes=in_bytes,
                        out_bytes=in_bytes)
    dec = HopperModel().decide(req)
    assert dec.dataflow == "os"
    assert (dec.bm, dec.bk, dec.bn) in grouped_gemm.TILES
    meta = dec.meta_dict
    assert meta["groups"] == e
    assert meta["smem_bytes"] == grouped_gemm.smem_bytes(dec.bm, dec.bk,
                                                         dec.bn, in_bytes)
    # the per-expert problem's best OS tile, costed once per expert
    best = cost.choose_tile(c, d, f, in_bytes, in_bytes, dataflows=("os",),
                            tiles=grouped_gemm.TILES)
    assert (best.bm, best.bk, best.bn) == (dec.bm, dec.bk, dec.bn)
    per_expert = cost.estimate(c, d, f, best, in_bytes, in_bytes)[0]
    assert dec.seconds == pytest.approx(per_expert * e)


def test_engine_grouped_matmul_memo_and_plan_as_in_jax_engine():
    a = _operands(4, 12, 32, 16, seed=2)
    b = _operands(4, 8, 32, 16, seed=3)
    jeng = jax_engine.Engine(backend="pallas-interpret")
    teng = Engine(backend="hopper")
    for x, w in (a, a, b, a, b):
        want = jeng.grouped_matmul(jnp.asarray(x), jnp.asarray(w))
        got = teng.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert teng.plan.stats == jeng.plan.stats
    assert (teng.plan.stats["decisions"], teng.plan.hits) == (2, 3)
    req, dec = next(iter(teng.plan))
    assert (req.op, req.groups, req.in_bytes) == ("grouped_gemm", 4, 4)
    assert dec.backend == "hopper"
    ref = Engine(backend="torch-ref").grouped_matmul(
        *(torch.from_numpy(v) for v in a))
    torch.testing.assert_close(
        ref, teng.grouped_matmul(*(torch.from_numpy(v) for v in a)),
        rtol=0, atol=0)


def test_engine_grouped_matmul_dim_mismatch_raises_as_in_jax_engine():
    x, w = _operands(4, 8, 32, 16)
    for xs, ws in ((x, w[:, :-1]), (x, w[:3])):
        with pytest.raises(ValueError, match="grouped dim mismatch"):
            jax_engine.Engine(backend="pallas-interpret").grouped_matmul(
                jnp.asarray(xs), jnp.asarray(ws))
        eng = Engine(backend="hopper")
        with pytest.raises(ValueError, match="grouped dim mismatch"):
            eng.grouped_matmul(torch.from_numpy(xs),
                               torch.from_numpy(np.ascontiguousarray(ws)))
        assert len(eng.plan) == 0


@pytest.mark.parametrize("in_dt,out_dt", [("bfloat16", "float32"),
                                          ("float32", "bfloat16"),
                                          ("bfloat16", "bfloat16")])
def test_out_dtype_matches_the_reference_grouped_backend(in_dt, out_dt):
    """The wrapper and `Engine.grouped_matmul` on `hopper` (and
    `torch-ref`) write any `out_dtype` from the f32 accumulator; the
    reference's grouped backend (`pallas-interpret`) casts its kernel's
    result, which the kernel stores in x's dtype, so with bf16 operands
    its f32 output carries one bf16 rounding that the port's does not:
    held within one bf16 ulp wherever bf16 is on either side.  The CPU
    path counts nothing."""
    t_in, t_out = getattr(torch, in_dt), getattr(torch, out_dt)
    j_in, j_out = getattr(jnp, in_dt), getattr(jnp, out_dt)
    x, w = _operands(3, 20, 40, 24, seed=4, zero_rows=5)
    want = jax_engine.Engine(backend="pallas-interpret").grouped_matmul(
        jnp.asarray(x, dtype=j_in), jnp.asarray(w, dtype=j_in),
        out_dtype=j_out)
    assert want.dtype == j_out
    tx, tw = torch.from_numpy(x).to(t_in), torch.from_numpy(w).to(t_in)
    tol = ({"rtol": 2 ** -7, "atol": 2e-4} if "bfloat16" in (in_dt, out_dt)
           else TOL)
    grouped_gemm.reset_launches()
    for got in (grouped_gemm.grouped_matmul(tx, tw, tile=grouped_gemm.TILES[0],
                                            out_dtype=t_out),
                Engine(backend="hopper").grouped_matmul(tx, tw,
                                                        out_dtype=t_out),
                Engine(backend="torch-ref").grouped_matmul(tx, tw,
                                                           out_dtype=t_out)):
        assert got.dtype == t_out
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   **tol)
    assert grouped_gemm.launches == 0
