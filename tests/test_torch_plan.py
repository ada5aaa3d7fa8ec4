"""The port's planning surface against the JAX package's on the CPU:
`AnalyticalCostModel` decisions field for field, the `simulator`
backend, the ASIC guard, `plan_gemms`, `default_engine` / `matmul`,
`decode_requests` and `plan_arch` key sets over the plan-coverage
posture grid for all ten archs, a reference-saved ASIC plan loaded by
the port, and warm-started SMOKE Scheduler serves that plan nothing
(zero new misses) and give the cold serves' tokens."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jax_engine
from repro.analysis import plan_coverage as pc
from repro.configs import all_configs as ref_all_configs
from repro.core import accelerators as ra
from repro_torch import engine
from repro_torch.configs import ARCH_NAMES, all_configs, get_config
from repro_torch.core import make_specs
from repro_torch.core.analytical_model import GEMM
from repro_torch.engine import (AnalyticalCostModel, CostModel, Engine,
                                ExecutionPlan, HopperModel, KernelRequest,
                                decode_requests, default_engine,
                                default_registry, plan_arch, use_engine)
from repro_torch.engine.context import int8_sibling, sparse_sibling
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as T
from repro_torch.quant import quantize_params
from repro_torch.serve_lib import serve
from repro_torch.serve_lib.scheduler import Request, Scheduler
from repro_torch.sparse import prune_params

#: the port's name for each reference backend the posture grid reaches
PORT_NAME = {"pallas-tpu": "hopper", "pallas-tpu-int8": "hopper-int8",
             "pallas-tpu-sparse": "hopper-sparse"}
SLOT_PAGES = -(-pc.MAX_SEQ // pc.PAGE_SIZE)


def _decision(d):
    return (d.op, d.dataflow, d.bm, d.bk, d.bn, d.backend, d.cost_model,
            d.seconds, d.meta)


def _request(r):
    return (*r.key(), r.name)


# --------------------------------------------------------------------------
# AnalyticalCostModel
# --------------------------------------------------------------------------


REQUESTS = [
    KernelRequest("gemm", 43264, 144, 32, in_bytes=1, out_bytes=1),
    KernelRequest("gemm", 128, 1024, 4096),
    KernelRequest("gemm", 1, 1024, 4096, in_bytes=4, out_bytes=4),
    KernelRequest("gemm", 37, 19, 23, in_bytes=2, out_bytes=4),
    KernelRequest("gemm_w8", 8, 1536, 8960, in_bytes=1, out_bytes=2),
    KernelRequest("grouped_gemm", 32, 1024, 512, groups=32),
    KernelRequest("grouped_gemm", 8, 96, 40, groups=4, in_bytes=4,
                  out_bytes=4),
    KernelRequest("gemm_sparse", 8, 1536, 8960, density=0.5),
    KernelRequest("gemm_sparse", 512, 1536, 256, in_bytes=1, density=0.5),
]


def _ref_request(r):
    return jax_engine.KernelRequest(r.op, r.m, r.k, r.n, groups=r.groups,
                                    in_bytes=r.in_bytes,
                                    out_bytes=r.out_bytes, density=r.density,
                                    name=r.name)


@pytest.mark.parametrize("request_", REQUESTS, ids=lambda r: "-".join(
    map(str, r.key())))
def test_asic_decisions_equal_the_references(request_):
    got = AnalyticalCostModel().decide(request_)
    want = jax_engine.AnalyticalCostModel().decide(_ref_request(request_))
    assert _decision(got) == _decision(want)
    assert got.meta_dict.keys() == {
        "shape_rows", "shape_cols", "loop_order", "alloc_input",
        "alloc_weight", "alloc_output", "cycles", "pe_utilization"}
    cfg = AnalyticalCostModel.mapping_config(got)
    ref_cfg = jax_engine.AnalyticalCostModel.mapping_config(want)
    assert (cfg.dataflow.value, cfg.shape.rows, cfg.shape.cols, cfg.tile_m,
            cfg.tile_k, cfg.tile_n, cfg.loop_order, cfg.alloc) == (
        ref_cfg.dataflow.value, ref_cfg.shape.rows, ref_cfg.shape.cols,
        ref_cfg.tile_m, ref_cfg.tile_k, ref_cfg.tile_n, ref_cfg.loop_order,
        ref_cfg.alloc)


def test_asic_decisions_on_another_spec_and_array():
    spec = make_specs(8)["sara"]
    got = AnalyticalCostModel(spec, array_size=8).decide(REQUESTS[3])
    want = jax_engine.AnalyticalCostModel(
        ra.make_specs(8)["sara"], array_size=8).decide(
            _ref_request(REQUESTS[3]))
    assert _decision(got) == _decision(want)
    assert got.cost_model == "redas-asic/sara"


@pytest.mark.parametrize("op", ["attention", "paged_attention"])
def test_asic_plane_refuses_attention_in_the_references_words(op):
    req = KernelRequest(op, 16, 64, 16, groups=4)
    with pytest.raises(ValueError) as got:
        AnalyticalCostModel().decide(req)
    with pytest.raises(ValueError) as want:
        jax_engine.AnalyticalCostModel().decide(_ref_request(req))
    assert str(got.value) == str(want.value)


def test_both_cost_models_are_cost_models():
    assert isinstance(HopperModel(), CostModel)
    assert isinstance(AnalyticalCostModel(), CostModel)
    assert HopperModel().default_backend is None
    assert Engine(HopperModel()).backend == "hopper"


# --------------------------------------------------------------------------
# The simulator backend and the ASIC guard
# --------------------------------------------------------------------------


def test_simulator_backend_executes_an_asic_decision():
    eng = Engine(AnalyticalCostModel())
    assert eng.backend == "simulator" == eng.plan.backend
    assert default_registry().ops("simulator") == ("gemm",)
    assert "simulator" in default_registry().backends()
    rng = np.random.default_rng(4)
    a = rng.normal(size=(10, 6)).astype(np.float32)
    b = rng.normal(size=(6, 8)).astype(np.float32)
    got = eng.matmul(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), a.astype(np.float64) @ b,
                               rtol=1e-4, atol=1e-4)
    want = jax_engine.Engine(jax_engine.AnalyticalCostModel()).matmul(
        jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # bf16 operands: the simulator computes in f32, the result is cast back
    got16 = eng.matmul(torch.from_numpy(a).bfloat16(),
                       torch.from_numpy(b).bfloat16())
    assert got16.dtype == torch.bfloat16
    dec = next(d for _, d in eng.plan)
    assert dec.backend == "simulator" and dec.meta_dict["shape_rows"] > 0


def test_simulator_backend_refuses_a_decision_without_a_mapping():
    eng = Engine(HopperModel(), backend="simulator")
    a, b = torch.ones(4, 8), torch.ones(8, 4)
    with pytest.raises(ValueError, match="simulator backend needs an ASIC "
                       r"mapping in decision.meta \(plan with "
                       "AnalyticalCostModel"):
        eng.matmul(a, b)


def test_asic_guard_on_a_fresh_decision():
    req = KernelRequest("gemm", 16, 64, 32, in_bytes=4, out_bytes=4)
    with pytest.raises(ValueError, match="ASIC cost model") as got:
        Engine(AnalyticalCostModel(), backend="hopper").decide(req)
    with pytest.raises(ValueError, match="ASIC cost model") as want:
        jax_engine.Engine(jax_engine.AnalyticalCostModel(),
                          backend="xla-einsum").decide(_ref_request(req))
    for text in (str(got.value), str(want.value)):
        assert "re-plan with" in text
        assert text.startswith(f"decision for {req.key()} was produced by "
                               f"an ASIC cost model ('redas-asic/redas')")


def test_asic_guard_on_a_warm_start(tmp_path):
    """An AnalyticalCostModel plan loaded into a hopper engine refuses its
    first lookup; a ServeConfig warm start of it refuses the serve."""
    cfg = get_config("qwen2-1.5b", smoke=True)
    path = tmp_path / "asic.json"
    plan = plan_arch(cfg, seq_len=16, batch=2, dtype_bytes=4,
                     cost_model=AnalyticalCostModel(), decode_batch=2)
    assert plan.backend == "simulator"
    plan.save(path)
    req, _ = next(iter(plan))
    eng = Engine(backend="hopper", plan=ExecutionPlan.load(path))
    with pytest.raises(ValueError, match="ASIC cost model.*re-plan"):
        eng.decide(req)
    # the simulator engine takes it
    sim = Engine(backend="simulator", plan=ExecutionPlan.load(path))
    assert sim.decide(req).backend == "simulator"
    scfg = serve.ServeConfig(max_seq=24, batch=2, compute_dtype="float32",
                             kernel_backend="hopper", plan_path=str(path),
                             device="cpu")
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0))
    prompt = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="ASIC cost model"):
        serve.generate(params, cfg, scfg, prompt, 2)


def test_simulator_runs_a_smoke_forward():
    """qwen2 SMOKE in f32, every engine GEMM on the simulator: logits of
    the `torch-ref` engine's within 1e-4."""
    cfg = get_config("qwen2-1.5b", smoke=True)
    cfg = dataclasses.replace(cfg, n_layers=1)
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (1, 6),
                           generator=torch.Generator().manual_seed(1))
    with use_engine(Engine(AnalyticalCostModel())) as eng:
        got, _ = T.forward(params, cfg, tokens, compute_dtype=torch.float32)
    with use_engine(backend="torch-ref"):
        want, _ = T.forward(params, cfg, tokens, compute_dtype=torch.float32)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert eng.plan.misses == len(eng.plan) > 0


# --------------------------------------------------------------------------
# plan_gemms, default_engine, matmul
# --------------------------------------------------------------------------


def test_plan_gemms_matches_reference():
    gemms = [GEMM(64, 128, 32, name="a"), (64, 128, 32), (9, 40, 17),
             GEMM(1, 96, 200, count=3)]
    eng = Engine(AnalyticalCostModel()).plan_gemms(gemms, in_bytes=4)
    ref = jax_engine.Engine(jax_engine.AnalyticalCostModel()).plan_gemms(
        [g if isinstance(g, tuple) else (g.M, g.K, g.N) for g in gemms],
        in_bytes=4)
    assert len(eng.plan) == 3 and eng.plan.misses == 3
    assert eng.plan.hits == ref.plan.hits == 1
    assert ({k: _decision(d) for k, d in eng.plan.decisions.items()}
            == {k: _decision(d) for k, d in ref.plan.decisions.items()})
    assert all(k[5:7] == (4, 4) for k in eng.plan.decisions)
    hop = Engine().plan_gemms([(8, 64, 32)], in_bytes=1, out_bytes=2)
    assert list(hop.plan.decisions) == [("gemm", 8, 64, 32, 1, 1, 2, 1.0)]


def test_default_engine_and_module_matmul():
    assert default_engine() is default_engine()
    assert default_engine().backend == "hopper"
    a, b = torch.randn(5, 7), torch.randn(7, 3)
    before = len(default_engine().plan)
    torch.testing.assert_close(engine.matmul(a, b), a @ b)
    assert len(default_engine().plan) >= before
    with use_engine(Engine(AnalyticalCostModel())) as eng:
        out = engine.matmul(a, b)
    assert len(eng.plan) == 1
    torch.testing.assert_close(out, a @ b, rtol=1e-5, atol=1e-5)


def test_package_exports_the_planning_surface():
    import repro_torch

    for name in ("AnalyticalCostModel", "CostModel", "HopperModel",
                 "decode_requests", "default_engine", "matmul", "plan_arch",
                 "GEMM", "WORKLOADS", "arch_gemms", "Engine", "use_engine",
                 "ExecutionPlan", "get_config"):
        assert getattr(repro_torch, name) is not None, name
        assert name in repro_torch.__all__
    assert repro_torch.plan_arch is plan_arch
    assert len(repro_torch.WORKLOADS) == 8
    with pytest.raises(AttributeError):
        repro_torch.TPUModel  # noqa: B018


# --------------------------------------------------------------------------
# decode_requests / plan_arch against the reference over the posture grid
# --------------------------------------------------------------------------


def _posture_kw(surface):
    paged = surface.layout == "paged"
    return dict(decode_batch=pc.BATCH, admit_widths=pc.admit_widths(),
                quantized_weights=surface.quantize,
                sparse_weights=surface.sparse, sparse_density=0.5,
                paged_pages=SLOT_PAGES if paged else 0,
                page_size=pc.PAGE_SIZE if paged else 0,
                verify_k=surface.speculate_k, prefill_chunk=pc.PREFILL_CHUNK)


def _port_backend(surface):
    backend = "hopper"
    if surface.quantize:
        backend = int8_sibling(backend)
    if surface.sparse:
        backend = sparse_sibling(backend)
    assert backend == PORT_NAME[pc.backend_for(surface)]
    return backend


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_decode_requests_match_reference(arch):
    for smoke in (True, False):
        cfg, ref = all_configs(smoke)[arch], ref_all_configs(smoke)[arch]
        for surface in pc.surfaces(ref):
            in_bytes = 1 if surface.quantize and not surface.sparse else 2
            for seq in (1, 16, 3):
                kw = dict(batch=pc.BATCH, dtype_bytes=in_bytes, seq=seq,
                          quantized_weights=surface.quantize,
                          sparse_weights=surface.sparse, density=0.5,
                          out_bytes=2,
                          paged_pages=(SLOT_PAGES if surface.layout == "paged"
                                       else 0),
                          page_size=pc.PAGE_SIZE)
                got = decode_requests(cfg, **kw)
                want = jax_engine.decode_requests(ref, **kw)
                assert ([_request(r) for r in got]
                        == [_request(r) for r in want]), (smoke, surface, seq)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_plan_arch_key_sets_match_reference(arch):
    """Every surface of the plan-coverage grid (layout x quantize x
    sparsity x speculate_k, decode batch 4, admit widths 16-64, pages of
    16, chunk 32), SMOKE and full: the port plans the reference's keys,
    on the port's backend of the same name, and covers every request the
    reference's coverage proof derives from the Scheduler's rules."""
    for smoke in (True, False):
        cfg, ref = all_configs(smoke)[arch], ref_all_configs(smoke)[arch]
        for surface in pc.surfaces(ref):
            kw = _posture_kw(surface)
            got = plan_arch(cfg, backend=_port_backend(surface), **kw)
            want = jax_engine.plan_arch(ref, backend=pc.backend_for(surface),
                                        **kw)
            assert set(got.decisions) == set(want.decisions), surface
            assert got.backend == _port_backend(surface)
            if pc.servable(ref):
                for req, label in pc.expected_requests(ref, surface):
                    assert req.key() in got.decisions, (surface, label)


def test_plan_arch_under_the_asic_plane_equals_the_references():
    for arch in ("qwen2-1.5b", "granite-moe-1b-a400m", "recurrentgemma-2b"):
        cfg = get_config(arch, smoke=True)
        ref = ref_all_configs(True)[arch]
        kw = dict(seq_len=32, dtype_bytes=4, decode_batch=2,
                  admit_widths=(8, 16), verify_k=2)
        got = plan_arch(cfg, cost_model=AnalyticalCostModel(), **kw)
        want = jax_engine.plan_arch(
            ref, cost_model=jax_engine.AnalyticalCostModel(), **kw)
        assert got.backend == want.backend == "simulator"
        assert got.cost_model == want.cost_model
        assert ({k: _decision(d) for k, d in got.decisions.items()}
                == {k: _decision(d) for k, d in want.decisions.items()})


def test_plan_arch_keys_int8_at_one_byte_and_records_its_backend():
    cfg = get_config("qwen2-1.5b", smoke=True)
    plan = plan_arch(cfg, backend="hopper-int8", dtype_bytes=4,
                     decode_batch=2, quantized_weights=True)
    assert plan.backend == "hopper-int8"
    assert {k[5] for k in plan.decisions} == {1}
    assert {k[6] for k in plan.decisions} == {4}
    assert {k[0] for k in plan.decisions} == {"gemm", "gemm_w8"}
    assert plan_arch(cfg).backend == "hopper"


def test_a_reference_saved_asic_plan_loads_in_the_port(tmp_path):
    cfg = get_config("qwen2-1.5b", smoke=True)
    ref = ref_all_configs(True)["qwen2-1.5b"]
    kw = dict(seq_len=32, dtype_bytes=4, decode_batch=2, admit_widths=(8,))
    path = tmp_path / "ref.json"
    jax_engine.plan_arch(ref, cost_model=jax_engine.AnalyticalCostModel(),
                         **kw).save(path)
    loaded = ExecutionPlan.load(path)
    mine = plan_arch(cfg, cost_model=AnalyticalCostModel(), **kw)
    assert ({k: _decision(d) for k, d in loaded.decisions.items()}
            == {k: _decision(d) for k, d in mine.decisions.items()})
    assert loaded.to_json() == path.read_text()
    assert mine.to_json() == path.read_text()
    eng = Engine(AnalyticalCostModel(), plan=loaded)
    a, b = torch.randn(2, cfg.d_model), torch.randn(cfg.d_model, cfg.d_ff)
    misses = eng.plan.misses
    torch.testing.assert_close(eng.matmul(a, b), a @ b, rtol=1e-4, atol=1e-4)
    assert eng.plan.misses == misses


# --------------------------------------------------------------------------
# Zero steady-state misses: warm-started SMOKE Scheduler serves
# --------------------------------------------------------------------------


SERVE_BATCH, SERVE_SEQ, BUCKET, PAGE = 4, 64, 16, 16
POSTURES = {
    "qwen2-contiguous": ("qwen2-1.5b", {}),
    "qwen2-paged": ("qwen2-1.5b", {"cache_layout": "paged"}),
    "qwen2-quantize": ("qwen2-1.5b", {"cache_layout": "paged",
                                      "quantize": True,
                                      "cache_dtype": "int8"}),
    "qwen2-sparsity": ("qwen2-1.5b", {"cache_layout": "paged",
                                      "sparsity": "2:4"}),
    "qwen2-speculate": ("qwen2-1.5b", {"cache_layout": "paged",
                                       "speculate_k": 2, "draft": "self"}),
    "qwen2-chunk": ("qwen2-1.5b", {"cache_layout": "paged",
                                   "prefill_chunk": 32}),
    "granite-sorted": ("granite-moe-1b-a400m", {"cache_layout": "paged"}),
    "gemma3": ("gemma3-12b", {"cache_layout": "paged"}),
    "mamba2": ("mamba2-780m", {}),
    "recurrentgemma": ("recurrentgemma-2b", {}),
}
TRACE = [(40, 6), (5, 9), (17, 3), (33, 8), (9, 12), (50, 4)]


def _posture_serve(arch, extra, plan_path=None):
    cfg = get_config(arch, smoke=True)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               impl="sort"))
    kw = dict(max_seq=SERVE_SEQ, batch=SERVE_BATCH, compute_dtype="float32",
              cache_dtype="float32", kernel_backend="hopper", device="cpu",
              page_size=PAGE, plan_path=plan_path)
    kw.update(extra)
    scfg = serve.ServeConfig(**kw)
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0))
    if scfg.sparsity:
        params = prune_params(params, 2, 4, quantize=scfg.quantize)
    elif scfg.quantize:
        params = quantize_params(params)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=u, prompt=rng.integers(0, cfg.vocab, p).astype(
        np.int32), max_new_tokens=g) for u, (p, g) in enumerate(TRACE)]
    return cfg, scfg, params, reqs


@pytest.mark.parametrize("posture", list(POSTURES))
def test_warm_started_serve_plans_nothing(posture, tmp_path):
    """plan_arch for the serve's posture, saved and loaded through
    `ServeConfig(plan_path=)`: the whole serve adds no miss, and its
    tokens are the cold serve's, per uid."""
    arch, extra = POSTURES[posture]
    cfg, scfg, params, reqs = _posture_serve(arch, extra)
    cold = Scheduler(params, cfg, scfg, engine=Engine(
        backend=scfg.kernel_backend), prefill_bucket=BUCKET)
    cold_out = cold.run([dataclasses.replace(r) for r in reqs])
    paged = scfg.cache_layout == "paged"
    plan = plan_arch(
        cfg, backend=scfg.kernel_backend, dtype_bytes=4,
        decode_batch=SERVE_BATCH,
        admit_widths=tuple(range(BUCKET, SERVE_SEQ + 1, BUCKET)),
        quantized_weights=scfg.quantize,
        sparse_weights=scfg.sparsity is not None,
        paged_pages=scfg.slot_pages if paged else 0,
        page_size=PAGE if paged else 0, verify_k=scfg.speculate_k,
        prefill_chunk=scfg.prefill_chunk or 0)
    path = tmp_path / "plan.json"
    plan.save(path)
    _, wscfg, _, _ = _posture_serve(arch, extra, str(path))
    eng = serve.warm_start_engine(wscfg)
    misses = eng.plan.misses
    warm = Scheduler(params, cfg, wscfg, prefill_bucket=BUCKET)
    assert warm.engine is eng
    warm_out = warm.run([dataclasses.replace(r) for r in reqs])
    assert eng.plan.misses == misses
    assert eng.plan.hits > 0
    assert set(eng.plan.decisions) == set(plan.decisions)
    assert sorted(warm_out) == sorted(cold_out) == list(range(len(TRACE)))
    for uid in cold_out:
        np.testing.assert_array_equal(warm_out[uid].tokens,
                                      cold_out[uid].tokens, err_msg=str(uid))
    assert warm.stats == cold.stats
    if scfg.speculate_k:
        assert warm.stats["spec_ticks"] > 0
    if scfg.prefill_chunk:
        assert 32 in warm.prefill_width_calls


def test_launcher_plan_in_trace_mode(tmp_path, capsys):
    """The launcher's `--plan` warm-starts a trace serve: the saved plan's
    decisions answer every request."""
    cfg = get_config("qwen2-1.5b", smoke=True)
    trace = "20x4,9x6*2"
    max_seq = 20 + 4 + 1
    path = tmp_path / "plan.json"
    plan = plan_arch(cfg, dtype_bytes=4, decode_batch=2,
                     admit_widths=(8, 16, 24, 25), paged_pages=-(-max_seq // 8),
                     page_size=8)
    plan.save(path)
    argv = ["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
            "--kernel-backend", "hopper", "--batch", "2", "--cache-layout",
            "paged", "--page-size", "8", "--trace", trace, "--plan",
            str(path)]
    out = launch_serve.main(argv)
    assert out["engine_plan"]["misses"] == plan.misses
    assert out["engine_plan"]["hits"] > plan.hits
    assert out["requests"] == 3
    capsys.readouterr()
    with pytest.raises(SystemExit):
        launch_serve.main(["--help"])
    assert "repro_torch.engine.plan_arch" in capsys.readouterr().out


def test_warm_start_warns_with_the_re_plan_hint(tmp_path):
    cfg = get_config("qwen2-1.5b", smoke=True)
    path = tmp_path / "bf16.json"
    plan_arch(cfg, seq_len=16, dtype_bytes=2).save(path)
    scfg = serve.ServeConfig(max_seq=8, batch=1, compute_dtype="float32",
                             kernel_backend="hopper", plan_path=str(path),
                             device="cpu")
    with pytest.warns(UserWarning, match=r"re-plan with "
                      r"plan_arch\(dtype_bytes=4\)"):
        serve.warm_start_engine(scfg)
