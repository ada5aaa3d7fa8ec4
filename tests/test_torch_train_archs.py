"""One train step of the port against the reference's, for every arch,
at SMOKE in f32 on the CPU, as the reference's `test_one_train_step`
steps them (`tests/test_archs_smoke.py:40-53`: B = 2, S = 32, one
microbatch, default AdamW): the port starts from the reference's own
initial state (`init_state(PRNGKey(0))`, params and optimizer state
through the bridge) and takes the same batch (the port's data pipeline,
bit for bit the reference's).

  metrics   loss, ce, aux, grad_norm and lr within rtol 1e-5;
  state     the params, mu, nu and master after the step within rtol /
            atol 2e-4, the reference's own bound for two f32 orders of
            summation (`tests/test_train_integration.py:49-51`); the step
            counter equal.

This file holds the five attention decoders; `test_torch_train_kinds.py`
the MoE, recurrent, encoder and VLM archs through the same helpers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.train_lib import train as jax_train
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, make_source
from repro_torch.train_lib import train as train_lib
from repro_torch.tree import flatten_with_path

B, S = 2, 32
STATE_TOL = {"rtol": 2e-4, "atol": 2e-4}
METRIC_RTOL = 1e-5


def reference_step(arch, jax_tcfg, batch, state=None, steps=1):
    """The reference's initial state and its state and metrics after
    `steps` jitted steps on `batch`, as numpy trees."""
    jcfg = jax_get_config(arch, smoke=True)
    if state is None:
        state = jax_train.init_state(jax.random.PRNGKey(0), jcfg, jax_tcfg)
    init = jax.tree.map(np.asarray, state)
    step = jax.jit(jax_train.make_train_step(jcfg, jax_tcfg))
    jb = jax.tree.map(jnp.asarray, batch)
    for _ in range(steps):
        state, metrics = step(state, jb)
    return (init, jax.tree.map(np.asarray, state),
            {k: float(v) for k, v in metrics.items()})


def port_state(np_state):
    return params_from_numpy(np_state, device="cpu")


def assert_state_close(got: dict, want: dict, tol=STATE_TOL) -> None:
    """Every leaf of the port's state against the reference's numpy state,
    by key path (the two trees name their leaves alike)."""
    want_flat = {jax.tree_util.keystr(path): leaf for path, leaf in
                 jax.tree_util.tree_flatten_with_path(want)[0]}
    got_flat = dict(flatten_with_path(got))
    assert set(got_flat) == set(want_flat)
    for key, leaf in got_flat.items():
        np.testing.assert_allclose(leaf.detach().float().numpy(),
                                   want_flat[key].astype(np.float32),
                                   err_msg=key, **tol)


def assert_metrics_close(got: dict, want: dict) -> None:
    assert set(got) == set(want) == {"loss", "ce", "aux", "grad_norm", "lr"}
    for key in want:
        np.testing.assert_allclose(float(got[key]), want[key],
                                   rtol=METRIC_RTOL, atol=1e-7, err_msg=key)


def step_both(arch, *, micro=1, quantize=False, jax_backend=None,
              backend=None, batch=None, jax_kw=None, kw=None):
    """One reference step and one port step from the reference's initial
    state: (port state, port metrics, reference state, its metrics)."""
    cfg = get_config(arch, smoke=True)
    if batch is None:
        batch = make_source(cfg, DataConfig(batch=B, seq_len=S)).batch(0)
    jax_tcfg = jax_train.TrainConfig(
        microbatches=micro, compute_dtype=jnp.float32, quantize=quantize,
        kernel_backend=jax_backend, **(jax_kw or {}))
    init, want, want_m = reference_step(arch, jax_tcfg, batch)
    tcfg = train_lib.TrainConfig(
        microbatches=micro, compute_dtype=torch.float32, quantize=quantize,
        kernel_backend=backend, **(kw or {}))
    step = train_lib.make_train_step(cfg, tcfg)
    got, got_m = step(port_state(init), train_lib.device_batch(batch, "cpu"))
    return got, got_m, want, want_m


ARCHS = ("qwen2-1.5b", "qwen3-14b", "mistral-large-123b", "gemma3-12b",
         "mixtral-8x7b")


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_reference(arch):
    got, got_m, want, want_m = step_both(arch)
    assert_metrics_close(got_m, want_m)
    assert int(got["opt"]["step"]) == int(want["opt"]["step"]) == 1
    assert_state_close(got, want)
