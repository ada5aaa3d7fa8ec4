"""The archs of the port's fifteenth slice against the JAX package, at
SMOKE in f32 on the CPU: qwen3-14b (qk-norm), mistral-large-123b,
gemma3-12b (5 "local" : 1 "attn" blocks, window 16) and mixtral-8x7b
(every block "local", MoE); and granite-moe-1b-a400m under --quantize
(int8 weights and KV, its expert stacks float) with either MoE dispatch
(the sorted one loops the int8 GEMM over the experts).  The weights
come from the JAX `init_params`
(and, for --quantize, the JAX `quantize_params`) through the bridge; the
prompts are made with numpy from a seed, most longer than the windows,
so every ring wraps.

  forward     logits within atol 2e-5 (f32 both sides; only the order of
              sums differs), and the port's `init_params` tree has the
              JAX tree's shapes;
  generate    greedy tokens identical to the JAX `generate`;
  scheduler   greedy tokens identical per uid to the JAX `Scheduler`, on
              both layouts, and its stats equal, at a prefill bucket of 8;
  paging      a paged ServeConfig pages only "attn" blocks: on
              mixtral-8x7b it builds no paged plane and runs the
              contiguous path, on gemma3-12b it pages the global blocks
              beside rings and shares no prefix, as in the JAX package.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro.quant import quantize_params as jax_quantize_params
from repro.serve_lib import serve as jax_serve
from repro.serve_lib.scheduler import Request as JaxRequest
from repro.serve_lib.scheduler import Scheduler as JaxScheduler
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as T
from repro_torch.serve_lib import serve
from repro_torch.serve_lib.scheduler import Request, Scheduler

ARCHS = ("qwen3-14b", "mistral-large-123b", "gemma3-12b", "mixtral-8x7b")
#: (arch, posture): --quantize (int8 weights and KV), a MoE dispatch, or
#: both joined by "+"
CASES = [("qwen3-14b", None), ("mistral-large-123b", None),
         ("gemma3-12b", None), ("gemma3-12b", "quantize"),
         ("mixtral-8x7b", "einsum"), ("mixtral-8x7b", "sort"),
         ("granite-moe-1b-a400m", "quantize+einsum"),
         ("granite-moe-1b-a400m", "quantize+sort")]
IDS = [f"{a}-{p}" if p else a for a, p in CASES]
FORWARD_TOL = {"rtol": 0, "atol": 2e-5}


def _parts(posture) -> set:
    return set(posture.split("+")) if posture else set()


def _configs(arch, posture):
    jcfg, cfg = jax_get_config(arch, True), get_config(arch, True)
    for impl in _parts(posture) & {"einsum", "sort"}:
        jcfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, impl=impl)) for c in (jcfg, cfg))
    return jcfg, cfg


_WEIGHTS = {}


def _weights(arch, posture):
    """(jcfg, jparams, cfg, params) for a case, built once per process."""
    key = (arch, posture)
    if key not in _WEIGHTS:
        jcfg, cfg = _configs(arch, posture)
        jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
        if "quantize" in _parts(posture):
            jparams = jax_quantize_params(jparams)
        params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
        _WEIGHTS[key] = (jcfg, jparams, cfg, params)
    return _WEIGHTS[key]


def _serve_kw(posture, jax_side: bool):
    quant = "quantize" in _parts(posture)
    if jax_side:
        return dict(compute_dtype=jnp.float32, quantize=quant,
                    cache_dtype=jnp.int8 if quant else jnp.float32,
                    kernel_backend="xla-einsum")
    return dict(compute_dtype="float32", quantize=quant,
                cache_dtype="int8" if quant else "float32",
                kernel_backend="hopper", device="cpu")


def _spec(vocab, seed=0):
    """Six requests of 3-39 prompt tokens (most past a 16-row window) and
    2-7 new tokens."""
    rng = np.random.default_rng(seed)
    return [(uid, rng.integers(0, vocab, int(rng.integers(3, 40))).astype(
        np.int32), int(rng.integers(2, 8))) for uid in range(6)]


# --------------------------------------------------------------------------
# forward and the parameter tree
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    jcfg, jparams, cfg, params = _weights(arch, None)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 40)).astype(
        np.int32)
    want, want_aux = JT.forward(jparams, jcfg, jnp.asarray(toks),
                                compute_dtype=jnp.float32)
    got, aux = T.forward(params, cfg, torch.from_numpy(toks),
                         compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FORWARD_TOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_reference_tree(arch):
    """The port's `init_params` tree has the JAX tree's paths and shapes
    (qk-norm scales, gemma3's `b0`..`b5` period, mixtral's expert
    stacks), and the bridge carries every JAX leaf across unchanged."""
    _, _, cfg, params = _weights(arch, None)
    jcfg = jax_get_config(arch, True)
    tree = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    mine = T.init_params(cfg, generator=torch.Generator().manual_seed(0))
    assert (jax.tree.map(lambda t: tuple(t.shape), mine)
            == jax.tree.map(lambda a: a.shape, tree))
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in flat:
        node = params
        for p in path:
            node = node[p.key if hasattr(p, "key") else p.idx]
        np.testing.assert_array_equal(node.numpy(), leaf)


# --------------------------------------------------------------------------
# generate and the Scheduler
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch,posture", CASES, ids=IDS)
def test_generate_tokens_identical_to_reference(arch, posture):
    """Two 40-token prompts and 8 new tokens each: the rings roll at
    prefill and wrap again in decode."""
    jcfg, jparams, cfg, params = _weights(arch, posture)
    prompt = np.random.default_rng(4).integers(0, cfg.vocab, (2, 40)).astype(
        np.int32)
    want = jax_serve.generate(jparams, jcfg, jax_serve.ServeConfig(
        max_seq=49, batch=2, **_serve_kw(posture, True)), jnp.asarray(prompt),
        8)
    got = serve.generate(params, cfg, serve.ServeConfig(
        max_seq=49, batch=2, **_serve_kw(posture, False)),
        torch.from_numpy(prompt), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _scheduler_pair(arch, posture, layout, spec, scfg_kw=None):
    """The JAX and the port's Scheduler over the same requests: 2 slots,
    max_seq 56, pages of 8, a prefill bucket of 8."""
    jcfg, jparams, cfg, params = _weights(arch, posture)
    kw = dict(max_seq=56, batch=2, cache_layout=layout, page_size=8,
              **(scfg_kw or {}))
    ref = JaxScheduler(jparams, jcfg, jax_serve.ServeConfig(
        **kw, **_serve_kw(posture, True)), prefill_bucket=8)
    ref.run([JaxRequest(uid=u, prompt=p.copy(), max_new_tokens=g)
             for u, p, g in spec], max_steps=300)
    sched = Scheduler(params, cfg, serve.ServeConfig(
        **kw, **_serve_kw(posture, False)), prefill_bucket=8)
    sched.run([Request(uid=u, prompt=p.copy(), max_new_tokens=g)
               for u, p, g in spec], max_steps=300)
    return ref, sched


def _same_tokens(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid].tokens, want[uid].tokens,
                                      err_msg=f"uid={uid}")


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("arch,posture", CASES, ids=IDS)
def test_scheduler_tokens_and_stats_identical_to_reference(arch, posture,
                                                           layout):
    ref, sched = _scheduler_pair(arch, posture, layout,
                                 _spec(get_config(arch, True).vocab))
    _same_tokens(sched.completions, ref.completions)
    assert sched.stats == ref.stats
    assert (sched.paged is None) == (ref.paged is None)
    if sched.paged is not None:
        sched.paged.check_invariants()


def test_paged_config_without_attn_layers_runs_contiguous():
    """mixtral-8x7b has no "attn" layer: a paged ServeConfig builds no
    paged plane and a cache of rings alone, and the Scheduler gives the
    JAX package's tokens and stats (which runs its contiguous path
    too)."""
    ref, sched = _scheduler_pair("mixtral-8x7b", "sort", "paged",
                                 _spec(128, seed=5))
    assert sched.paged is None and ref.paged is None
    leaves = [name for blk in [*sched.cache["slots"].values(),
                               *sched.cache["tail"]] for name in blk]
    assert leaves and "k_pages" not in leaves
    assert sched.cache["slots"]["b0"]["k"].shape[2] == 16   # the window
    _same_tokens(sched.completions, ref.completions)
    assert sched.stats == ref.stats


def test_mixed_pattern_pages_global_blocks_and_shares_no_prefix():
    """gemma3-12b on a paged ServeConfig with a 24-token prefix common to
    every request: block b5 ("attn") is paged, b0..b4 keep 16-row rings,
    no prefix is shared (it would have to live in the rings too), and
    the tokens and stats are the JAX package's."""
    rng = np.random.default_rng(6)
    prefix = rng.integers(0, 128, 24)
    spec = [(uid, np.concatenate([prefix, rng.integers(0, 128, 3 + uid)])
             .astype(np.int32), 3 + uid % 3) for uid in range(5)]
    ref, sched = _scheduler_pair("gemma3-12b", None, "paged", spec)
    slots = sched.cache["slots"]
    assert "k_pages" in slots["b5"]
    assert all(slots[f"b{j}"]["k"].shape[2] == 16 for j in range(5))
    assert sched.paged.index is None and ref.paged.index is None
    assert sched.stats["shared_prefix_tokens"] == 0
    _same_tokens(sched.completions, ref.completions)
    assert sched.stats == ref.stats


@pytest.mark.parametrize("arch,argv", [
    ("qwen3-14b", ["--batch", "2", "--prompt-len", "8", "--gen", "4"]),
    ("gemma3-12b", ["--batch", "2", "--prompt-len", "24", "--gen", "4"]),
    ("gemma3-12b", ["--batch", "2", "--cache-layout", "paged", "--page-size",
                    "8", "--trace", "24x8,8x4*3"]),
    ("mixtral-8x7b", ["--batch", "2", "--cache-layout", "paged",
                      "--page-size", "8", "--trace", "24x8,8x4*3"]),
    ("mistral-large-123b", ["--quantize", "--batch", "2", "--prompt-len", "8",
                            "--gen", "4"])],
    ids=["qwen3", "gemma3", "gemma3-paged", "mixtral-paged",
         "mistral-quantize"])
def test_cli_serves_new_archs_on_cpu_smoke(arch, argv):
    out = launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                             "--kernel-backend", "hopper", *argv])
    if "--trace" in argv:
        assert out["requests"] == 4 and out["tokens"] == 8 + 3 * 4
        assert (out["scheduler"].paged is None) == (arch == "mixtral-8x7b")
    else:
        assert out["shape"] == (2, 4)
        assert out["engine_plan"]["hits"] > 0
