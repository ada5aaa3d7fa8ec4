"""The port's accelerator plane (`repro_torch.core`) against the JAX
package's on the CPU, bit for bit: the same numpy operations in the same
order give the same logical shapes, analytical-model reports, mapper
decisions, energies and GEMM traces.  The paper's direction checks
(`tests/test_system.py`) hold on the port too."""

import dataclasses
import math

import numpy as np
import pytest

from repro.core import accelerators as ra
from repro.core import analytical_model as ram
from repro.core import dataflow as rdf
from repro.core import energy as ren
from repro.core import mapper as rmp
from repro.core import workloads as rwl
from repro.configs import all_configs as ref_all_configs
from repro_torch.configs import ARCH_NAMES, all_configs
from repro_torch.core import (REDAS, SPECS, TPU, WORKLOADS, arch_gemms,
                              make_specs)
from repro_torch.core import accelerators as pa
from repro_torch.core import analytical_model as pam
from repro_torch.core import dataflow as pdf
from repro_torch.core import energy as pen
from repro_torch.core import mapper as pmp
from repro_torch.core import workloads as pwl

ABBRS = tuple(rwl.WORKLOADS)


def _shapes(shapes):
    return [(s.rows, s.cols) for s in shapes]


def _cfg(c):
    """A MappingConfig of either package as plain data."""
    return (c.dataflow.value, c.shape.rows, c.shape.cols, c.tile_m,
            c.tile_k, c.tile_n, c.loop_order, c.alloc)


def _gemm(g):
    return (g.M, g.K, g.N, g.count, g.name)


def _decision(d):
    return (_gemm(d.gemm), _cfg(d.config), dataclasses.asdict(d.report),
            d.candidates_evaluated)


def _to_port_cfg(c):
    return pam.MappingConfig(
        dataflow=pdf.Dataflow(c.dataflow.value),
        shape=pdf.LogicalShape(c.shape.rows, c.shape.cols),
        tile_m=c.tile_m, tile_k=c.tile_k, tile_n=c.tile_n,
        loop_order=c.loop_order, alloc=c.alloc)


# --------------------------------------------------------------------------
# Eq. 1: logical shapes
# --------------------------------------------------------------------------


def test_a_128_array_has_129_logical_shapes():
    assert pdf.n_logical_shapes(128) == 129
    assert len(pdf.enumerate_logical_shapes(128)) == 129
    assert pdf.n_logical_shapes(128, 4) == rdf.n_logical_shapes(128, 4) == 33
    assert len(REDAS.shapes) == len(ra.REDAS.shapes) == 33
    assert _shapes(TPU.shapes) == [(128, 128)]


@pytest.mark.parametrize("r_p,granularity", [(6, 1), (8, 1), (8, 2),
                                             (128, 1), (128, 4)])
def test_shape_enumeration_and_its_helpers_match_reference(r_p, granularity):
    got = pdf.enumerate_logical_shapes(r_p, granularity=granularity)
    want = rdf.enumerate_logical_shapes(r_p, granularity=granularity)
    assert _shapes(got) == _shapes(want)
    assert pdf.n_logical_shapes(r_p, granularity) == len(got)
    for s, w in zip(got, want):
        assert pdf.bypass_cycles(s) == rdf.bypass_cycles(w)
        assert (pdf.subarray_decomposition(s, r_p)
                == rdf.subarray_decomposition(w, r_p))
        assert pdf.pe_usage(s, r_p) == rdf.pe_usage(w, r_p)
        for df in pdf.ALL_DATAFLOWS:
            assert (pdf.tile_dims_for(df, s)
                    == rdf.tile_dims_for(rdf.Dataflow(df.value), w))


def test_shape_refusals_in_the_references_words():
    for fn, args in ((pdf.enumerate_logical_shapes, (6, 8)),
                     (pdf.enumerate_logical_shapes, (7,))):
        with pytest.raises(ValueError) as got:
            fn(*args)
        with pytest.raises(ValueError) as want:
            getattr(rdf, fn.__name__)(*args)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        pdf.subarray_decomposition(pdf.LogicalShape(3, 3), 8)
    with pytest.raises(ValueError) as want:
        rdf.subarray_decomposition(rdf.LogicalShape(3, 3), 8)
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------
# Eq. 3-5: the analytical model
# --------------------------------------------------------------------------


@pytest.mark.parametrize("abbr", ABBRS)
def test_estimate_and_estimate_batch_match_reference(abbr):
    """Every distinct GEMM of the workload under a spread of mappings
    (valid and invalid): every CostReport field; and the whole pruned
    candidate tensor of the ReDas mapper through `estimate_batch`."""
    rng = np.random.default_rng(ABBRS.index(abbr))
    distinct = {(g.M, g.K, g.N): g for g in rwl.WORKLOADS[abbr].gemms}
    ref_model, port_model = ra.REDAS.model(), REDAS.model()
    ref_mapper = rmp.ReDasMapper(ra.REDAS)
    port_mapper = pmp.ReDasMapper(REDAS)
    for g in list(distinct.values())[:6]:
        pg = pam.GEMM(g.M, g.K, g.N, g.count, g.name)
        batch = ref_mapper.candidate_batch(g)
        pbatch = port_mapper.candidate_batch(pg)
        for col in ("df", "rows", "cols", "tile_m", "tile_k", "tile_n",
                    "order_ids", "alloc_ids"):
            np.testing.assert_array_equal(getattr(pbatch, col),
                                          getattr(batch, col))
        picks = rng.choice(len(batch), size=min(12, len(batch)),
                           replace=False)
        for i in picks:
            cfg = batch.config(int(i))
            assert (dataclasses.asdict(port_model.estimate(pg, _to_port_cfg(cfg)))
                    == dataclasses.asdict(ref_model.estimate(g, cfg)))
        stream = np.asarray([rmp._STREAM_DIM[d] for d in batch.dataflows],
                            np.int8)[batch.df]
        alloc = np.asarray(rmp.ALLOC_CANDIDATES, np.float64)[batch.alloc_ids]
        cols = dict(rows=batch.rows, cols=batch.cols, tile_m=batch.tile_m,
                    tile_k=batch.tile_k, tile_n=batch.tile_n,
                    order_ids=batch.order_ids, stream_dims=stream,
                    alloc=alloc)
        got = port_model.estimate_batch(pg, **cols)
        want = ref_model.estimate_batch(g, **cols)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


def test_model_helpers_match_reference():
    sizes = np.array([0, 1, 63, 64, 100, 4096, 5000, 2 ** 23])
    np.testing.assert_array_equal(pam.dram_efficiency(sizes),
                                  ram.dram_efficiency(sizes))
    np.testing.assert_array_equal(pam.dram_access_cycles(sizes, 365.7),
                                  ram.dram_access_cycles(sizes, 365.7))
    for order in pam.LOOP_ORDERS:
        for cap in (0, 1, 3, 50):
            for dims in ("mk", "kn"):
                assert (pam._operand_fetch_count(
                    order, {"m": 3, "k": 5, "n": 7}, frozenset(dims), cap)
                    == ram._operand_fetch_count(
                        order, {"m": 3, "k": 5, "n": 7}, frozenset(dims),
                        cap))
            assert (pam._output_k_reuse(order, {"m": 3, "k": 5, "n": 7}, cap)
                    == ram._output_k_reuse(order, {"m": 3, "k": 5, "n": 7},
                                           cap))
    with pytest.raises(ValueError) as got:
        pam.GEMM(0, 1, 1)
    with pytest.raises(ValueError) as want:
        ram.GEMM(0, 1, 1)
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------
# §4: the mapper over the paper's suite, and the energy model
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mapped():
    """Both packages' `map_model` of every workload on every spec."""
    out = {}
    for name in ra.SPECS:
        for abbr in ABBRS:
            out["ref", name, abbr] = rmp.ReDasMapper(ra.SPECS[name]).map_model(
                rwl.WORKLOADS[abbr].gemms)
            out["port", name, abbr] = pmp.ReDasMapper(SPECS[name]).map_model(
                WORKLOADS[abbr].gemms)
    return out


@pytest.mark.parametrize("spec", tuple(ra.SPECS))
@pytest.mark.parametrize("abbr", ABBRS)
def test_map_model_and_energy_match_reference(mapped, spec, abbr):
    got, want = mapped["port", spec, abbr], mapped["ref", spec, abbr]
    assert [_decision(d) for d in got.decisions] == [
        _decision(d) for d in want.decisions]
    for total in ("total_cycles", "total_macs", "total_dram_bytes",
                  "total_sram_bytes", "total_config_cycles",
                  "total_bypass_cycles"):
        assert getattr(got, total) == getattr(want, total), total
    assert got.pe_utilization(128) == want.pe_utilization(128)
    vec = rwl.WORKLOADS[abbr].vector_elements
    e_got = pen.model_energy(SPECS[spec], got, vec)
    e_want = ren.model_energy(ra.SPECS[spec], want, vec)
    assert dataclasses.asdict(e_got) == dataclasses.asdict(e_want)
    assert e_got.edp == e_want.edp and e_got.power_w == e_want.power_w
    assert (e_got.adp(SPECS[spec].area_mm2)
            == e_want.adp(ra.SPECS[spec].area_mm2))
    assert (e_got.power_efficiency(2.0 * got.total_macs)
            == e_want.power_efficiency(2.0 * want.total_macs))


def test_specs_and_baselines_match_reference():
    for size in (8, 128):
        got, want = make_specs(size), ra.make_specs(size)
        assert list(got) == list(want)
        for name in want:
            g = dataclasses.asdict(got[name])
            w = dataclasses.asdict(want[name])
            g["dataflows"] = [d.value for d in got[name].dataflows]
            w["dataflows"] = [d.value for d in want[name].dataflows]
            g["shapes"] = _shapes(got[name].shapes)
            w["shapes"] = _shapes(want[name].shapes)
            assert g == w, name
            assert (_shapes(got[name].shapes_for(32))
                    == _shapes(want[name].shapes_for(32)))
    for g in rwl.WORKLOADS["TY"].gemms:
        pg = pam.GEMM(g.M, g.K, g.N, g.count, g.name)
        assert (_decision(pmp.fixed_baseline_decision(TPU, pg))
                == _decision(rmp.fixed_baseline_decision(ra.TPU, g)))
        assert (pmp.ReDasMapper(REDAS).space_size(pg)
                == rmp.ReDasMapper(ra.REDAS).space_size(g))


def test_scalar_mapper_picks_what_the_batched_one_picks():
    """The port's oracle path (`vectorized=False`) against its batched
    path and the reference's, at an 8 x 8 array."""
    spec = make_specs(8)["redas"]
    for m, k, n in ((13, 9, 17), (8, 24, 4), (1, 30, 20)):
        g = pam.GEMM(m, k, n)
        scalar = pmp.ReDasMapper(spec, vectorized=False).map_gemm(g)
        batched = pmp.ReDasMapper(spec).map_gemm(g)
        ref = rmp.ReDasMapper(ra.make_specs(8)["redas"]).map_gemm(
            ram.GEMM(m, k, n))
        assert _cfg(scalar.config) == _cfg(batched.config) == _cfg(ref.config)


# --------------------------------------------------------------------------
# The workload traces
# --------------------------------------------------------------------------


def test_paper_suite_matches_reference():
    assert list(WORKLOADS) == list(rwl.WORKLOADS)
    for abbr, w in rwl.WORKLOADS.items():
        p = WORKLOADS[abbr]
        assert (p.name, p.abbr, p.domain, p.vector_elements, p.total_macs,
                p.n_layers) == (w.name, w.abbr, w.domain, w.vector_elements,
                                w.total_macs, w.n_layers)
        assert [_gemm(g) for g in p.gemms] == [_gemm(g) for g in w.gemms]


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_arch_gemms_match_reference(arch, smoke):
    cfg = all_configs(smoke)[arch]
    ref = ref_all_configs(smoke)[arch]
    for kw in ({}, {"seq_len": 100, "batch": 3}):
        assert ([_gemm(g) for g in arch_gemms(cfg, **kw)]
                == [_gemm(g) for g in rwl.arch_gemms(ref, **kw)])


def test_arch_traces_match_reference():
    got, want = pwl.arch_traces(smoke=True), rwl.arch_traces(smoke=True)
    assert list(got) == list(want)
    for name in want:
        assert [_gemm(g) for g in got[name]] == [_gemm(g) for g in want[name]]


# --------------------------------------------------------------------------
# The paper's claims, in direction, on the port (tests/test_system.py)
# --------------------------------------------------------------------------


def test_redas_faster_than_tpu_everywhere(mapped):
    for m in ("TY", "GN", "VI"):
        assert (mapped["port", "redas", m].total_cycles
                < mapped["port", "tpu", m].total_cycles)


def test_rnn_benefits_most(mapped):
    """GNMT (matrix-vector GEMMs) gains more than TinyYOLO (fat convs) —
    the paper's Sec. 5.2 observation."""
    s = {m: (mapped["port", "tpu", m].total_cycles
             / mapped["port", "redas", m].total_cycles) for m in ("TY", "GN")}
    assert s["GN"] > s["TY"]


def test_utilization_improves(mapped):
    for m in ("TY", "GN", "VI"):
        assert (mapped["port", "redas", m].pe_utilization(128)
                > mapped["port", "tpu", m].pe_utilization(128))


def test_edp_improves(mapped):
    """Clear EDP wins on the RNN/attention suites (GN, VI); parity or
    better on the fat-conv TY (Fig. 16's smallest gain)."""
    def edp(acc, m):
        return pen.model_energy(SPECS[acc], mapped["port", acc, m],
                                WORKLOADS[m].vector_elements).edp
    for m in ("GN", "VI"):
        assert edp("redas", m) < edp("tpu", m)
    assert edp("redas", "TY") < edp("tpu", "TY") * 1.1


def test_modeled_suite_geomeans_match_reference(mapped):
    """The suite's modeled speedup and EDP ratio (ReDas over the TPU-like
    array): geometric means over the eight workloads, equal to the
    reference's and above 1."""
    def geo(side, fn):
        return math.exp(sum(math.log(fn(side, m)) for m in ABBRS) / len(ABBRS))

    def speedup(side, m):
        return (mapped[side, "tpu", m].total_cycles
                / mapped[side, "redas", m].total_cycles)

    def edp_ratio(side, m):
        specs = SPECS if side == "port" else ra.SPECS
        e = {acc: pen.model_energy(specs[acc], mapped[side, acc, m],
                                   WORKLOADS[m].vector_elements).edp
             for acc in ("tpu", "redas")}
        return e["tpu"] / e["redas"]

    assert geo("port", speedup) == geo("ref", speedup) > 1.0
    assert geo("port", edp_ratio) == geo("ref", edp_ratio) > 1.0


def test_workload_gemm_inventory():
    """Headline GEMMs the paper quotes exist in the traces."""
    re_shapes = {(g.M, g.K, g.N) for g in WORKLOADS["RE"].gemms}
    assert (49, 2048, 512) in re_shapes or (49, 512, 2048) in re_shapes
    assert (12544, 147, 64) in re_shapes
    ty = [g for g in WORKLOADS["TY"].gemms if g.name == "conv2"][0]
    assert (ty.M, ty.K, ty.N) == (43264, 144, 32)
    vi_shapes = {(g.M, g.K, g.N) for g in WORKLOADS["VI"].gemms}
    assert (50, 768, 3072) in vi_shapes and (50, 3072, 768) in vi_shapes
    be_shapes = {(g.M, g.K, g.N) for g in WORKLOADS["BE"].gemms}
    assert (128, 1024, 4096) in be_shapes


def test_accelerator_constants_are_the_references():
    for const in ("SRAM_BYTES", "FREQ_HZ", "DRAM_BW", "WORD_BYTES", "ARRAY",
                  "RESHAPE_GRANULARITY"):
        assert getattr(pa, const) == getattr(ra, const)
    assert pen.SIMD_PJ_PER_ELEMENT == ren.SIMD_PJ_PER_ELEMENT
    assert pen.SIMD_LANES == ren.SIMD_LANES
    assert pwl.ARCH_TRACE_SEQ == rwl.ARCH_TRACE_SEQ
