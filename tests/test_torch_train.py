"""The port's training plane against the reference, f32 on the CPU:

  optimizer    `apply_updates` on random trees holding stacked 2-D norm
               leaves and 1-D tail leaves, two steps, clip_norm hit and
               missed: params, mu, nu and master within rtol 1e-6 / atol
               1e-7; step, grad_norm and lr within rtol 1e-6; the
               schedules at every step of a run;
  data         `SyntheticLM` (tokens, VLM patches, audio frames) and
               `MemmapCorpus` batches bit for bit;
  train step   microbatches 2 against the reference's 2 and the port's 1,
               `sparsity="2:4"` (dense weights on the sparse namespace),
               within the bounds of `test_torch_train_archs.py`;
               `quantize=True` ("torch-ref-int8" against "xla-int8") at the
               int8 plane's rounding bound (its test says why); a pruned
               or quantized tree refused, as `jax.value_and_grad` refuses
               it;
  checkpoints  6 steps straight equal 3, a save, a restore and 3 more;
               a reference checkpoint resumes in the port and continues as
               the reference continues, a port checkpoint (bf16 leaves
               too) restores in the reference's `Checkpointer.restore`; the
               Checkpointer's mechanics as in the reference's test;
  launcher     `repro_torch.launch.train` on `--device cpu --smoke`: 12
               steps with a checkpoint every 6, the loss falling, then
               `--resume auto` to 14.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import Checkpointer as JaxCheckpointer
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import make_source as jax_make_source
from repro.optim import adamw as jax_adamw
from repro.optim import schedule as jax_schedule
from repro.train_lib import train as jax_train
from repro_torch.checkpoint.checkpoint import Checkpointer, resume_or_init
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, make_source
from repro_torch.optim import adamw, schedule
from repro_torch.train_lib import train as train_lib
from repro_torch.tree import flatten_with_path
from test_torch_train_archs import (assert_metrics_close, assert_state_close,
                                    port_state, reference_step, step_both)

OPT_TOL = {"rtol": 1e-6, "atol": 1e-7}


# --------------------------------------------------------------------------
# optimizer and schedules
# --------------------------------------------------------------------------


def _tree(rng, scale=1.0):
    """A params-shaped tree: stacked (periods, ...) leaves, 2-D norms among
    them, a tail list with 1-D leaves, a top-level 1-D norm."""
    f = lambda *s: (scale * rng.normal(size=s)).astype(np.float32)
    return {"stack": {"b0": {"norm1": f(3, 8), "attn": {"w": f(3, 8, 6),
                                                         "b": f(3, 6)}}},
            "tail": [{"norm1": f(8), "mlp": {"w": f(8, 5)}}],
            "final_norm": f(8)}


@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["missed", "hit"])
def test_apply_updates_matches_reference(grad_scale):
    rng = np.random.default_rng(int(grad_scale * 100))
    params = _tree(rng)
    grads = [_tree(rng, grad_scale), _tree(rng, grad_scale)]
    jcfg = jax_adamw.AdamWConfig(
        lr=jax_schedule.linear_warmup_cosine(1e-2, 1, 10))
    cfg = adamw.AdamWConfig(lr=schedule.linear_warmup_cosine(1e-2, 1, 10))
    jstate = jax_adamw.init_state(jax.tree.map(jnp.asarray, params))
    state = adamw.init_state(port_state(params))
    master = state["master"]["stack"]["b0"]["attn"]["w"]
    assert master.dtype == torch.float32
    norms = []
    for g in grads:
        jp, jstate, jm = jax_adamw.apply_updates(
            jcfg, jstate, jax.tree.map(jnp.asarray, g),
            param_dtype=jnp.float32)
        p, state, m = adamw.apply_updates(cfg, state, port_state(g),
                                          param_dtype=torch.float32)
        assert_state_close({"p": p, "opt": state},
                           {"p": jax.tree.map(np.asarray, jp),
                            "opt": jax.tree.map(np.asarray, jstate)},
                           OPT_TOL)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-6)
        norms.append(float(m["grad_norm"]))
    assert int(state["step"]) == 2
    # the clip: hit at 10x, missed at 0.01x
    assert (min(norms) > 1.0) if grad_scale > 1 else (max(norms) < 1.0)


def test_decay_reads_each_leaf_ndim():
    """A stacked norm scale (periods, d) is decayed, a 1-D tail norm not,
    as the reference's `master.ndim >= 2` reads them (zero gradients:
    only the decay moves the master)."""
    rng = np.random.default_rng(0)
    params = port_state(_tree(rng))
    zeros = {"stack": {"b0": {"norm1": torch.zeros(3, 8), "attn": {
        "w": torch.zeros(3, 8, 6), "b": torch.zeros(3, 6)}}},
        "tail": [{"norm1": torch.zeros(8), "mlp": {"w": torch.zeros(8, 5)}}],
        "final_norm": torch.zeros(8)}
    state = adamw.init_state(params)
    new, _, _ = adamw.apply_updates(adamw.AdamWConfig(lr=0.5), state, zeros,
                                    param_dtype=torch.float32)
    moved = {path: not torch.equal(a, b) for (path, a), (_, b) in zip(
        flatten_with_path(new), flatten_with_path(params))}
    assert moved["['stack']['b0']['norm1']"] and moved["['stack']['b0']['attn']['b']"]
    assert not moved["['tail'][0]['norm1']"] and not moved["['final_norm']"]
    assert moved["['tail'][0]['mlp']['w']"]


def test_schedules_match_reference():
    jfn = jax_schedule.linear_warmup_cosine(3e-3, 20, 100)
    fn = schedule.linear_warmup_cosine(3e-3, 20, 100)
    steps = np.arange(0, 130, dtype=np.int32)
    got = np.array([float(fn(torch.tensor(s))) for s in steps])
    want = np.array([float(jfn(jnp.asarray(s))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert float(schedule.constant(2e-4)(torch.tensor(7))) == float(
        jax_schedule.constant(2e-4)(jnp.asarray(7)))


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "internvl2-1b",
                                  "hubert-xlarge"])
def test_synthetic_batches_bit_for_bit(arch):
    src = make_source(get_config(arch, smoke=True),
                      DataConfig(batch=3, seq_len=16, seed=7))
    jsrc = jax_make_source(jax_get_config(arch, smoke=True),
                           JaxDataConfig(batch=3, seq_len=16, seed=7))
    for step in (0, 5, 123):
        got, want = src.batch(step), jsrc.batch(step)
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])


def test_memmap_batches_bit_for_bit(tmp_path):
    path = tmp_path / "toks.bin"
    np.random.default_rng(1).integers(0, 10**6, 5000,
                                      dtype=np.int32).tofile(path)
    src = make_source(get_config("qwen2-1.5b", smoke=True),
                      DataConfig(batch=2, seq_len=8, seed=3), str(path))
    jsrc = jax_make_source(jax_get_config("qwen2-1.5b", smoke=True),
                           JaxDataConfig(batch=2, seq_len=8, seed=3),
                           str(path))
    for step in (0, 9):
        np.testing.assert_array_equal(src.batch(step)["tokens"],
                                      jsrc.batch(step)["tokens"])
    assert src.batch(0)["tokens"].shape == (2, 9)


# --------------------------------------------------------------------------
# the train step's postures
# --------------------------------------------------------------------------


def _batch(arch="qwen2-1.5b", b=4):
    return make_source(get_config(arch, smoke=True),
                       DataConfig(batch=b, seq_len=32)).batch(0)


def test_microbatches_match_reference_and_the_full_batch():
    """Two microbatches against the reference's two, and against the
    port's one full batch, from the reference's initial state."""
    cfg, batch = get_config("qwen2-1.5b", smoke=True), _batch()
    init, want, want_m = reference_step(
        "qwen2-1.5b", jax_train.TrainConfig(microbatches=2,
                                            compute_dtype=jnp.float32), batch)
    got = {}
    for micro in (2, 1):
        step = train_lib.make_train_step(cfg, train_lib.TrainConfig(
            microbatches=micro, compute_dtype=torch.float32))
        got[micro], metrics = step(port_state(init),
                                   train_lib.device_batch(batch, "cpu"))
        if micro == 2:
            assert_metrics_close(metrics, want_m)
    assert_state_close(got[2], want)
    assert_state_close(got[1], jax.tree.map(
        lambda t: t.detach().numpy(), got[2]))


@pytest.fixture(scope="module")
def int8_reference():
    """The reference's initial state and its "xla-int8" step (one jit for
    both backends' cases)."""
    batch = _batch()
    tcfg = jax_train.TrainConfig(compute_dtype=jnp.float32, quantize=True,
                                 kernel_backend="xla-einsum")
    return (batch, *reference_step("qwen2-1.5b", tcfg, batch))


@pytest.mark.parametrize("backend", ["torch-ref", "hopper"])
def test_quantize_step_matches_reference(backend, int8_reference):
    """`quantize=True` upgrades to the int8 sibling: int8 forward, float
    backward, held to the reference's "xla-int8" step.  The two forwards
    feed the int8 codec activations that differ in the last f32 bit, so
    an activation can round to the other int8 value (here one row of the
    128: 0.78% of the logits move, by up to 0.36% of their max); one such
    flip moves its row by up to 1/127 of the row's max.  So the step is
    held at that bound, not at the float step's: loss, ce and grad_norm
    within rtol 1e-4 (measured 2.0e-5), lr exactly; mu and nu within
    1/127 of each leaf's max (measured 3.0e-3 at most); the params and
    master within Adam's one-step reach of 2 lr of the reference, and
    all but 0.5% of their elements within the float step's 2e-4 (45 of
    90688 measured outside it).  At this bound the step cannot tell the
    float backward from one that quantizes its cotangents (about 0.5/127
    of a max); `test_torch_vjp.py::test_int8_vjp_matches_reference` holds
    the float backward, at rtol 2e-5."""
    batch, init, want, want_m = int8_reference
    step = train_lib.make_train_step(
        get_config("qwen2-1.5b", smoke=True),
        train_lib.TrainConfig(compute_dtype=torch.float32, quantize=True,
                              kernel_backend=backend))
    got, got_m = step(port_state(init), train_lib.device_batch(batch, "cpu"))
    for key in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(got_m[key]), want_m[key], rtol=1e-4)
    assert float(got_m["lr"]) == want_m["lr"]
    want_flat = {jax.tree_util.keystr(path): leaf for path, leaf in
                 jax.tree_util.tree_flatten_with_path(want)[0]}
    lr, outside, total = want_m["lr"], 0, 0
    for key, leaf in flatten_with_path(got):
        a, b = leaf.detach().numpy(), want_flat[key]
        gap = np.abs(a - b)
        if "['mu']" in key or "['nu']" in key:
            assert gap.max() <= np.abs(b).max() / 127, key
        elif "['step']" in key:
            assert int(a) == int(b) == 1
        else:
            assert gap.max() <= 2 * lr + 2e-4, key
            outside += int((gap > 2e-4 + 2e-4 * np.abs(b)).sum())
            total += a.size
    assert outside <= 0.005 * total, (outside, total)


def test_quantize_config_upgrades_like_the_reference():
    assert train_lib.TrainConfig(quantize=True).kernel_backend == "hopper-int8"
    assert train_lib.TrainConfig(
        quantize=True, kernel_backend="torch-ref").kernel_backend == \
        "torch-ref-int8"
    assert train_lib.TrainConfig(
        sparsity="2:4", kernel_backend="torch-ref").kernel_backend == \
        "torch-ref-sparse"
    assert train_lib.TrainConfig(
        quantize=True, sparsity="2:4").kernel_backend == "hopper-sparse"
    with pytest.raises(ValueError):
        train_lib.TrainConfig(sparsity="5:4")


def test_sparsity_trains_dense_weights_on_the_sparse_namespace():
    got, got_m, want, want_m = step_both(
        "qwen2-1.5b", jax_backend="xla-sparse", backend="torch-ref",
        batch=_batch(), jax_kw={"sparsity": "2:4"}, kw={"sparsity": "2:4"})
    assert_metrics_close(got_m, want_m)
    assert_state_close(got, want)


@pytest.mark.parametrize("posture", ["pruned", "quantized"])
def test_storage_trees_are_refused(posture):
    from repro_torch.quant import quantize_params
    from repro_torch.sparse import prune_params

    cfg = get_config("qwen2-1.5b", smoke=True)
    tcfg = train_lib.TrainConfig(compute_dtype=torch.float32,
                                 kernel_backend="torch-ref")
    state = train_lib.init_state(cfg, tcfg,
                                 generator=torch.Generator().manual_seed(0))
    state["params"] = (prune_params(state["params"], 2, 4)
                       if posture == "pruned"
                       else quantize_params(state["params"]))
    step = train_lib.make_train_step(cfg, tcfg)
    with pytest.raises(TypeError, match=r"int8 storage \(\['stack'\]"):
        step(state, train_lib.device_batch(_batch(), "cpu"))


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------


def _setup(micro=2):
    cfg = get_config("qwen2-1.5b", smoke=True)
    tcfg = train_lib.TrainConfig(
        microbatches=micro, compute_dtype=torch.float32,
        optimizer=adamw.AdamWConfig(
            lr=schedule.linear_warmup_cosine(1e-2, 5, 100)))
    src = make_source(cfg, DataConfig(batch=8, seq_len=32))
    init = lambda: train_lib.init_state(
        cfg, tcfg, generator=torch.Generator().manual_seed(0))
    return init, train_lib.make_train_step(cfg, tcfg), src


def _flat(tree):
    return {k: v.detach().float().numpy() for k, v in flatten_with_path(tree)}


def test_checkpoint_restart_bitexact(tmp_path):
    init, step, src = _setup()
    batches = [train_lib.device_batch(src.batch(s), "cpu") for s in range(6)]
    ref = init()
    for b in batches:
        ref, _ = step(ref, b)
    state = init()
    for b in batches[:3]:
        state, _ = step(state, b)
    ck = Checkpointer(str(tmp_path))
    ck.save(3, state, blocking=True)
    restored = ck.restore(3, init())
    for b in batches[3:]:
        restored, _ = step(restored, b)
    want = _flat(ref)
    for key, leaf in _flat(restored).items():
        np.testing.assert_allclose(leaf, want[key], rtol=1e-5, atol=1e-6,
                                   err_msg=key)


def _jax_setup():
    jcfg = jax_get_config("qwen2-1.5b", smoke=True)
    jtcfg = jax_train.TrainConfig(
        microbatches=2, compute_dtype=jnp.float32,
        optimizer=jax_adamw.AdamWConfig(
            lr=jax_schedule.linear_warmup_cosine(1e-2, 5, 100)))
    return jcfg, jtcfg


def test_checkpoints_load_across_packages(tmp_path):
    """A checkpoint the reference wrote after 2 steps resumes in the port
    (`resume_or_init`), and the port's next 2 steps stay within the
    train-step bound of the reference's; the port's checkpoint of that
    state restores in the reference's `Checkpointer.restore`."""
    jcfg, jtcfg = _jax_setup()
    init, step, src = _setup()
    jsrc = jax_make_source(jcfg, JaxDataConfig(batch=8, seq_len=32))
    jstep = jax.jit(jax_train.make_train_step(jcfg, jtcfg))
    jstate = jax_train.init_state(jax.random.PRNGKey(0), jcfg, jtcfg)
    for s in range(2):
        jstate, _ = jstep(jstate, jax.tree.map(jnp.asarray, jsrc.batch(s)))
    jdir = tmp_path / "ref"
    JaxCheckpointer(str(jdir)).save(2, jstate, blocking=True)
    start, state = resume_or_init(Checkpointer(str(jdir)), init)
    assert start == 2
    assert_state_close(state, jax.tree.map(np.asarray, jstate),
                       {"rtol": 0, "atol": 0})
    for s in range(2, 4):
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, jsrc.batch(s)))
        state, m = step(state, train_lib.device_batch(src.batch(s), "cpu"))
    assert_metrics_close(m, {k: float(v) for k, v in jm.items()})
    assert_state_close(state, jax.tree.map(np.asarray, jstate))

    pdir = tmp_path / "port"
    Checkpointer(str(pdir)).save(4, state, blocking=True)
    like = jax.eval_shape(lambda: jax_train.init_state(
        jax.random.PRNGKey(0), jcfg, jtcfg))
    back = JaxCheckpointer(str(pdir)).restore(4, like)
    assert_state_close(state, jax.tree.map(np.asarray, back),
                       {"rtol": 0, "atol": 0})


def test_bf16_leaves_round_trip_and_read_raw(tmp_path):
    """The port writes a bf16 leaf as f32 (exact), which the reference
    restores as bfloat16; a bf16 leaf stored raw, as the reference's
    `np.savez` writes ml_dtypes' bfloat16 (`|V2`), reads by its bits."""
    w = torch.randn(4, 6, generator=torch.Generator().manual_seed(2))
    state = {"w": w.bfloat16(), "n": torch.arange(3, dtype=torch.int32)}
    ck = Checkpointer(str(tmp_path / "a"))
    ck.save(1, state, blocking=True)
    back = ck.restore(1, state)
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"], state["w"])
    assert torch.equal(back["n"], state["n"])
    jback = JaxCheckpointer(str(tmp_path / "a")).restore(
        1, {"n": jnp.zeros(3, jnp.int32), "w": jnp.zeros((4, 6), jnp.bfloat16)})
    assert jback["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(jback["w"], np.float32),
                                  state["w"].float().numpy())
    jw = jnp.asarray(w.numpy(), jnp.bfloat16)
    JaxCheckpointer(str(tmp_path / "b")).save(
        1, {"n": jnp.arange(3, dtype=jnp.int32), "w": jw}, blocking=True)
    with np.load(tmp_path / "b" / "step_000000001.npz") as zf:
        assert zf["['w']"].dtype.str == "|V2"
    raw = Checkpointer(str(tmp_path / "b")).restore(1, state)
    np.testing.assert_array_equal(raw["w"].float().numpy(),
                                  np.asarray(jw, np.float32))


def test_checkpointer_mechanics(tmp_path):
    d = str(tmp_path)
    ck = Checkpointer(d, keep=2)
    state = {"w": torch.arange(4.0)}
    for s in (1, 2, 3):
        ck.save(s, state, blocking=True)
    assert ck.all_steps() == [2, 3]  # gc keeps 2
    assert ck.latest_step() == 3
    ck.save(4, state)                # async save + wait
    ck.wait()
    assert ck.latest_step() == 4
    assert not [f for f in os.listdir(d) if f.startswith("tmp")]
    step, got = resume_or_init(ck, lambda: {"w": torch.zeros(4)})
    assert step == 4
    assert torch.equal(got["w"], torch.arange(4.0))
    empty = Checkpointer(str(tmp_path / "none"))
    assert resume_or_init(empty, lambda: {"w": torch.ones(2)})[0] == 0
    # a background write that fails raises at the next wait
    gone = Checkpointer(str(tmp_path / "gone"))
    os.rmdir(tmp_path / "gone")
    gone.save(1, state)
    with pytest.raises(FileNotFoundError):
        gone.wait()
    gone.wait()                      # raised once


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------


def test_train_launcher_end_to_end(tmp_path):
    from repro_torch.launch.train import main

    d = str(tmp_path)
    common = ["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
              "--batch", "4", "--seq", "32", "--lr", "1e-2", "--ckpt-dir", d]
    out = main(common + ["--steps", "12", "--ckpt-every", "6"])
    assert out["final_ce"] < out["first_ce"]
    assert out["steps"] == 12 and len(out["ce"]) == 12
    assert Checkpointer(d).all_steps() == [6, 12]
    out2 = main(common + ["--steps", "14", "--resume", "auto"])
    assert out2["start"] == 12 and out2["steps"] == 14
    assert len(out2["ce"]) == 2
    out3 = main(common + ["--steps", "14", "--resume", "auto"])
    assert out3["final_ce"] is None and out3["steps"] == 14
