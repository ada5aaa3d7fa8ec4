"""The port's cycle-level simulator (`repro_torch.core.simulator`,
PyTorch) against the JAX package's (`jax.lax.scan` / `vmap`) on the CPU:
outputs within rtol/atol 1e-6 (the same f32 fused multiply-adds in the
same order), cycle counts equal and equal to Eq. 4's streaming term less
one; the roundabout geometry exactly; the refusals in the reference's
words."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import accelerators as ra
from repro.core import analytical_model as ram
from repro.core import dataflow as rdf
from repro.core import mapper as rmp
from repro.core import simulator as rsim
from repro_torch.core import accelerators as pa
from repro_torch.core import analytical_model as pam
from repro_torch.core import mapper as pmp
from repro_torch.core import simulator as sim
from repro_torch.core.dataflow import Dataflow, LogicalShape

TOL = {"rtol": 1e-6, "atol": 1e-6}
dims = st.integers(min_value=1, max_value=12)


def _ref_shape(shape):
    return None if shape is None else rdf.LogicalShape(shape.rows,
                                                       shape.cols)


def _both(fn, a, b, df, shape=None):
    """(port output, port cycles, reference output, reference cycles)."""
    out, cyc = getattr(sim, fn)(a, b, df, shape, device="cpu")
    ref, rcyc = getattr(rsim, fn)(a, b, rdf.Dataflow(df.value),
                                  _ref_shape(shape))
    return out, cyc, np.asarray(ref), int(rcyc)


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@given(dims, dims, dims, st.sampled_from(list(Dataflow)))
@settings(max_examples=12, deadline=None)
def test_simulator_matches_reference_and_gemm(m, k, n, df):
    rng = np.random.default_rng(42)
    a, b = _normal(rng, m, k), _normal(rng, k, n)
    out, cycles, ref, ref_cycles = _both("simulate_gemm", a, b, df)
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(out.numpy(), a.astype(np.float64) @ b,
                               rtol=1e-5, atol=1e-5)
    shape = {Dataflow.OS: LogicalShape(m, n), Dataflow.WS: LogicalShape(k, n),
             Dataflow.IS: LogicalShape(m, k)}[df]
    assert cycles == ref_cycles == sim.eq4_stream_term(df, shape, m, k, n) - 1


@given(dims, dims, dims, st.sampled_from(list(Dataflow)),
       st.integers(0, 5), st.integers(0, 5))
@settings(max_examples=8, deadline=None)
def test_simulator_on_larger_array(m, k, n, df, extra_r, extra_c):
    """A tile smaller than the logical array still computes the GEMM, as
    the reference's does, in as many cycles."""
    rng = np.random.default_rng(7)
    a, b = _normal(rng, m, k), _normal(rng, k, n)
    rows, cols = {Dataflow.OS: (m, n), Dataflow.WS: (k, n),
                  Dataflow.IS: (m, k)}[df]
    shape = LogicalShape(rows + extra_r, cols + extra_c)
    out, cycles, ref, ref_cycles = _both("simulate_gemm", a, b, df, shape)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(out.numpy(), a.astype(np.float64) @ b,
                               rtol=1e-5, atol=1e-5)
    assert cycles == ref_cycles


@pytest.mark.parametrize("df", list(Dataflow))
@pytest.mark.parametrize("m,k,n,shape", [(4, 6, 3, None), (24, 40, 20, None),
                                         (30, 17, 9, (40, 32))])
def test_batch_matches_per_tile_and_reference(df, m, k, n, shape):
    rng = np.random.default_rng(3)
    a, b = _normal(rng, 5, m, k), _normal(rng, 5, k, n)
    if shape is not None:
        shape = LogicalShape(*shape)
    out, cycles, ref, ref_cycles = _both("simulate_gemm_batch", a, b, df,
                                         shape)
    assert tuple(out.shape) == (5, m, n)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(out.numpy(), a.astype(np.float64) @ b,
                               rtol=1e-5, atol=1e-5)
    assert cycles == ref_cycles
    for i in range(a.shape[0]):
        single, c1 = sim.simulate_gemm(a[i], b[i], df, shape, device="cpu")
        torch.testing.assert_close(out[i], single, rtol=0, atol=0)
        assert cycles == c1


@given(st.integers(1, 24), st.integers(1, 24), st.integers(1, 24))
@settings(max_examples=15, deadline=None)
def test_is_equals_transposed_ws(m, k, n):
    """IS is WS on the transposed problem: outputs transpose-equal and the
    cycle counts match (tests/test_is_ws_identity.py)."""
    rng = np.random.default_rng(m * 31 + k * 7 + n)
    a, b = rng.normal(size=(m, k)), rng.normal(size=(k, n))
    out_is, cyc_is = sim.simulate_gemm(a, b, Dataflow.IS, device="cpu")
    out_ws, cyc_ws = sim.simulate_gemm(b.T, a.T, Dataflow.WS, device="cpu")
    assert cyc_is == cyc_ws
    torch.testing.assert_close(out_is, out_ws.T, rtol=0, atol=0)


@pytest.mark.parametrize("spec", tuple(ra.make_specs(8)))
def test_mapping_of_mapper_decisions_matches_reference(spec):
    """A mapper decision at an 8 x 8 array (reshaped shapes included),
    run tile by tile through the simulator, reproduces a @ b as the
    reference's does, in as many cycles a tile."""
    port = pmp.ReDasMapper(pa.make_specs(8)[spec], array_size=8)
    ref = rmp.ReDasMapper(ra.make_specs(8)[spec], array_size=8)
    rng = np.random.default_rng(11)
    for m, k, n in ((13, 9, 17), (5, 100, 9)):
        dec = port.map_gemm(pam.GEMM(m, k, n))
        rdec = ref.map_gemm(ram.GEMM(m, k, n))
        assert dec.config.dataflow.value == rdec.config.dataflow.value
        a, b = _normal(rng, m, k), _normal(rng, k, n)
        out, cycles = sim.simulate_mapping(a, b, dec.config, device="cpu")
        want, want_cycles = rsim.simulate_mapping(a, b, rdec.config)
        assert tuple(out.shape) == (m, n)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(out.numpy(), a.astype(np.float64) @ b,
                                   rtol=1e-4, atol=1e-4)
        assert cycles == int(want_cycles) > 0


def test_tensors_stay_on_their_device_and_numpy_needs_a_card():
    a = torch.randn(5, 7, dtype=torch.float64)
    b = torch.randn(7, 3, dtype=torch.float64)
    out, _ = sim.simulate_gemm(a, b, Dataflow.WS)   # default device="cuda"
    assert out.device.type == "cpu" and out.dtype == torch.float32
    torch.testing.assert_close(out, (a.float() @ b.float()), rtol=1e-5,
                               atol=1e-5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sim.simulate_gemm(a.numpy(), b.numpy(), Dataflow.WS)


# --------------------------------------------------------------------------
# Refusals
# --------------------------------------------------------------------------


REFUSALS = [
    ("simulate_gemm", (4, 5), (6, 3), Dataflow.OS, None),
    ("simulate_gemm", (4, 5), (5, 3), Dataflow.OS, (3, 3)),
    ("simulate_gemm", (4, 5), (5, 3), Dataflow.WS, (4, 3)),
    ("simulate_gemm", (4, 5), (5, 3), Dataflow.IS, (4, 4)),
    ("simulate_gemm_batch", (2, 4, 5), (3, 5, 3), Dataflow.OS, None),
    ("simulate_gemm_batch", (4, 5), (5, 3), Dataflow.OS, None),
    ("simulate_gemm_batch", (2, 4, 5), (2, 6, 3), Dataflow.WS, None),
    ("simulate_gemm_batch", (2, 4, 5), (2, 5, 3), Dataflow.WS, (4, 2)),
]


@pytest.mark.parametrize("fn,a_shape,b_shape,df,shape", REFUSALS)
def test_refusals_in_the_references_words(fn, a_shape, b_shape, df, shape):
    a, b = np.ones(a_shape, np.float32), np.ones(b_shape, np.float32)
    shape = None if shape is None else LogicalShape(*shape)
    with pytest.raises(ValueError) as got:
        getattr(sim, fn)(a, b, df, shape, device="cpu")
    with pytest.raises(ValueError) as want:
        getattr(rsim, fn)(a, b, rdf.Dataflow(df.value), _ref_shape(shape))
    assert str(got.value) == str(want.value)


def test_pinwheel_refusal_in_the_references_words():
    for r_l, r_p in ((0, 8), (5, 8)):
        with pytest.raises(ValueError) as got:
            sim.pinwheel_decomposition(r_l, r_p)
        with pytest.raises(ValueError) as want:
            rsim.pinwheel_decomposition(r_l, r_p)
        assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------
# Roundabout geometry
# --------------------------------------------------------------------------


@pytest.mark.parametrize("r_p", [6, 8, 16, 32])
def test_roundabout_geometry_is_the_references(r_p):
    """Placement, every lane's ring and its corner hops, and the
    validator's stats, exactly; every hop Manhattan-adjacent and each
    corner R_l hops (Eq. 4's bypass term)."""
    for r_l in range(1, r_p // 2 + 1):
        strips = sim.pinwheel_decomposition(r_l, r_p)
        for got, want in zip(strips, rsim.pinwheel_decomposition(r_l, r_p),
                             strict=True):
            assert got["orientation"] == want["orientation"]
            np.testing.assert_array_equal(got["coords"], want["coords"])
        np.testing.assert_array_equal(sim.logical_to_physical(r_l, r_p),
                                      rsim.logical_to_physical(r_l, r_p))
        for lane in range(r_l):
            path, hops = sim.roundabout_ring(r_l, r_p, lane)
            ref_path, ref_hops = rsim.roundabout_ring(r_l, r_p, lane)
            np.testing.assert_array_equal(path, ref_path)
            assert hops == ref_hops
        stats = sim.validate_roundabout(r_l, r_p)
        assert stats == rsim.validate_roundabout(r_l, r_p)
        assert stats["bypass_hops_per_lane"] == 4 * r_l
        assert stats["used_pes"] == r_p * r_p - (r_p - 2 * r_l) ** 2


def test_pinwheel_shapes():
    assert len(sim.pinwheel_decomposition(2, 6)) == 4
    assert sim.logical_to_physical(2, 6).shape == (2, 16, 2)
