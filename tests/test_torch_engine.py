"""The port's engine (plan, registry, HopperModel, Engine) against the
JAX package's engine, on the CPU."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jax_engine
from repro.core import tpu_model
from repro_torch.engine import (BACKENDS, Engine, ExecutionPlan, HopperModel,
                                KernelRequest, default_registry, use_engine)
from repro_torch.engine import cost
from repro_torch.kernels import redas_gemm

#: every engine GEMM of full-width qwen2-1.5b serving 4 requests of 512
#: prompt tokens: M = 4 (decode) or 2048 (prefill) x (K, N) of wq/wo,
#: wk/wv, wi/wg and the MLP's wo.
MAIN_PATH_KN = ((1536, 1536), (1536, 256), (1536, 8960), (8960, 1536))
MAIN_PATH_SHAPES = [(m, k, n) for m in (4, 2048) for k, n in MAIN_PATH_KN]


def test_plan_json_roundtrip_byte_identical(tmp_path):
    eng = Engine()
    for m, k, n in MAIN_PATH_SHAPES:
        eng.decide(KernelRequest("gemm", m, k, n))
    eng.plan.save(tmp_path / "plan.json")
    text = (tmp_path / "plan.json").read_text()
    plan2 = ExecutionPlan.load(tmp_path / "plan.json")
    plan2.save(tmp_path / "plan2.json")
    assert (tmp_path / "plan2.json").read_text() == text
    assert list(plan2) == list(eng.plan)


def test_plan_format_is_the_jax_packages(tmp_path):
    """A JAX plan of gemm decisions loads in the port and saves back byte
    for byte."""
    eng = jax_engine.Engine(backend="pallas-interpret")
    eng.plan_gemms([(128, 256, 512), (1, 1024, 16), (43264, 144, 32)])
    eng.plan.save(tmp_path / "jax.json")
    text = (tmp_path / "jax.json").read_text()
    assert ExecutionPlan.from_json(text).to_json() == text


def test_hits_and_misses_count_as_in_jax_engine():
    rng = np.random.default_rng(0)
    mats = [rng.normal(size=s).astype(np.float32)
            for s in ((16, 64), (64, 32), (32, 48))]
    seq = [(0, 1), (0, 1), (0, 1), (1, 2), (0, 1), (1, 2)]
    jeng = jax_engine.Engine(backend="xla-einsum")
    teng = Engine(backend="torch-ref")
    for i, j in seq:
        jeng.matmul(jnp.asarray(mats[i]), jnp.asarray(mats[j]))
        teng.matmul(torch.from_numpy(mats[i]), torch.from_numpy(mats[j]))
    assert teng.plan.stats == jeng.plan.stats
    assert teng.plan.stats["decisions"] == 2


@pytest.mark.parametrize("in_bytes", [2, 4])
@pytest.mark.parametrize("shape", MAIN_PATH_SHAPES)
def test_hopper_decisions_lie_in_menu_and_fit_shared_memory(shape, in_bytes):
    dec = HopperModel().decide(KernelRequest("gemm", *shape, in_bytes=in_bytes,
                                             out_bytes=in_bytes))
    assert (dec.bm, dec.bk, dec.bn) in redas_gemm.TILES
    assert dec.dataflow in redas_gemm.DATAFLOWS
    smem = redas_gemm.smem_bytes(dec.bm, dec.bk, dec.bn, in_bytes)
    assert smem == dec.meta_dict["smem_bytes"] <= 232_448
    assert dec.seconds > 0


def test_traffic_formula_equals_jax_packages():
    for (m, k, n), tile, df, (ib, ob) in itertools.product(
            MAIN_PATH_SHAPES + [(40, 96, 200), (257, 64, 8)],
            redas_gemm.TILES, redas_gemm.DATAFLOWS, ((2, 2), (4, 4), (2, 4))):
        bm, bk, bn = tile
        assert cost.hbm_traffic(m, k, n, cost.TileConfig(df, bm, bk, bn),
                                ib, ob) == tpu_model.hbm_traffic(
            m, k, n, tpu_model.TPUKernelConfig(df, bm, bk, bn), ib, ob)


def test_registry_holds_both_backends():
    """The float backends and their int8 and sparse siblings; `gemm_w8`
    is an int8 op only and `gemm_sparse` a sparse one, as in the JAX
    package."""
    reg = default_registry()
    ops = ("gemm", "grouped_gemm", "attention", "paged_attention")
    assert {(b, op): reg.get(b, op).__name__ for b in BACKENDS for op in ops} == {
        ("hopper", "gemm"): "hopper_gemm", ("torch-ref", "gemm"): "ref_gemm",
        ("hopper", "grouped_gemm"): "hopper_grouped_gemm",
        ("torch-ref", "grouped_gemm"): "ref_grouped_gemm",
        ("hopper", "attention"): "hopper_attention",
        ("torch-ref", "attention"): "ref_attention",
        ("hopper", "paged_attention"): "hopper_paged_attention",
        ("torch-ref", "paged_attention"): "ref_paged_attention",
        ("hopper-int8", "gemm"): "hopper_int8_gemm",
        ("torch-ref-int8", "gemm"): "ref_int8_gemm",
        ("hopper-int8", "grouped_gemm"): "hopper_int8_grouped_gemm",
        ("torch-ref-int8", "grouped_gemm"): "ref_int8_grouped_gemm",
        ("hopper-int8", "attention"): "plain_attention",
        ("torch-ref-int8", "attention"): "plain_attention",
        ("hopper-int8", "paged_attention"): "hopper_paged_attention",
        ("torch-ref-int8", "paged_attention"): "ref_paged_attention",
        ("hopper-sparse", "gemm"): "hopper_gemm",
        ("torch-ref-sparse", "gemm"): "ref_gemm",
        ("hopper-sparse", "grouped_gemm"): "ref_grouped_gemm",
        ("torch-ref-sparse", "grouped_gemm"): "ref_grouped_gemm",
        ("hopper-sparse", "attention"): "plain_attention",
        ("torch-ref-sparse", "attention"): "plain_attention",
        ("hopper-sparse", "paged_attention"): "hopper_paged_attention",
        ("torch-ref-sparse", "paged_attention"): "ref_paged_attention"}
    assert reg.has("hopper", "paged_attention")
    assert reg.has("hopper", "grouped_gemm")
    assert reg.get("hopper-int8", "gemm_w8").__name__ == "hopper_int8_gemm_w8"
    assert reg.get("torch-ref-int8", "gemm_w8").__name__ == "ref_int8_gemm_w8"
    with pytest.raises(KeyError, match="no kernel"):
        reg.get("hopper", "gemm_w8")


def test_engine_backends_agree_on_cpu():
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.normal(size=(40, 96)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(96, 200)).astype(np.float32))
    with use_engine(backend="hopper") as hop:
        got = hop.matmul(a, b)
    with use_engine(backend="torch-ref") as ref:
        want = ref.matmul(a, b)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="either"):
        with use_engine(hop, backend="hopper"):
            pass


def test_warm_start_engine_cached_per_config(tmp_path):
    """Repeated generate() calls share the decision memo (as the JAX
    package's `_ENGINES` memo does)."""
    from repro_torch.serve_lib import serve as serve_lib

    p = tmp_path / "plan.json"
    eng = Engine()
    eng.decide(KernelRequest("gemm", 16, 64, 32, in_bytes=4, out_bytes=4))
    eng.plan.save(p)
    scfg = serve_lib.ServeConfig(max_seq=8, batch=1, compute_dtype="float32",
                                 kernel_backend="hopper", plan_path=str(p),
                                 device="cpu")
    e1 = serve_lib.warm_start_engine(scfg)
    e2 = serve_lib.warm_start_engine(scfg)
    assert e1 is e2
    assert len(e1.plan) == 1
    other = serve_lib.warm_start_engine(
        serve_lib.ServeConfig(max_seq=16, batch=1, compute_dtype="float32",
                              kernel_backend="hopper", plan_path=str(p),
                              device="cpu"))
    assert other is not e1
    assert serve_lib.warm_start_engine(
        serve_lib.ServeConfig(max_seq=8, batch=1, device="cpu")) is None


def test_serveconfig_normalizes_dtypes():
    """"bfloat16" and torch.bfloat16 spell the SAME config, so the engine
    memo holds one engine (one decision cache), not one per spelling."""
    from repro_torch.serve_lib import serve as serve_lib

    a = serve_lib.ServeConfig(max_seq=8, batch=1, compute_dtype="bfloat16",
                              cache_dtype="bfloat16", kernel_backend="hopper",
                              device="cpu")
    b = serve_lib.ServeConfig(max_seq=8, batch=1,
                              compute_dtype=torch.bfloat16,
                              cache_dtype=torch.bfloat16,
                              kernel_backend="hopper", device="cpu")
    assert a == b and hash(a) == hash(b)
    assert a.compute_dtype == torch.bfloat16
    eng_a = serve_lib.warm_start_engine(a)
    eng_b = serve_lib.warm_start_engine(b)
    assert eng_a is eng_b, "dtype spelling built a duplicate engine"
