"""The port's watchdog (`repro_torch.launch.watchdog`, a copy of the
reference's) against the reference's on the same injected stalls and
crashes, and driving the port's train step on the CPU:

  harness     the three cases of `tests/test_watchdog_grouped.py` (a crash
              mid-run, a straggler past 3x the median step, a persistent
              failure past max_restarts; the straggler's floor 0.25 s
              and its stall 1.0 s) run through both modules with the
              same step functions: their stats (losses, restarts,
              final_step) equal, and the same refusal; the step budget
              and `check` on their own;
  train step  `run_with_recovery` over SMOKE qwen2-1.5b's train step with
              snapshots in host memory, a crash injected at one step and
              a stall past the budget at another: 2 restarts, and the
              final state and losses bit for bit an uninterrupted run's.
"""

import time

import pytest
import torch

from repro.launch import watchdog as ref_wd
from repro_torch.launch import watchdog as wd

MODULES = {"reference": ref_wd, "port": wd}


def _crash_case(mod):
    state = {"ckpt": 0}
    crashed = {"done": False}

    def run_step(s):
        if s == 5 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("injected node failure")
        return float(100 - s)

    return mod.run_with_recovery(
        steps=10, start_step=0, run_step=run_step,
        save=lambda s: state.update(ckpt=s), restore=lambda: state["ckpt"],
        ckpt_every=2, watchdog=mod.StepWatchdog(min_timeout_s=5))


def _straggler_case(mod):
    state = {"ckpt": 0}
    stalled = {"done": False}

    def run_step(s):
        if s == 4 and not stalled["done"]:
            stalled["done"] = True
            time.sleep(1.0)  # >> the 0.25 s floor over 3x median(0.01)
        else:
            time.sleep(0.01)
        return float(s)

    # the reference test's case with a wider floor, so that a 10 ms step
    # slowed by a loaded host is not taken for the straggler
    return mod.run_with_recovery(
        steps=6, start_step=0, run_step=run_step,
        save=lambda s: state.update(ckpt=s), restore=lambda: state["ckpt"],
        ckpt_every=2, watchdog=mod.StepWatchdog(timeout_factor=3.0,
                                                min_timeout_s=0.25))


def _give_up_case(mod):
    calls = []

    def run_step(s):
        calls.append(s)
        raise RuntimeError("persistent failure")

    with pytest.raises(RuntimeError, match="persistent failure"):
        mod.run_with_recovery(
            steps=3, start_step=0, run_step=run_step,
            save=lambda s: None, restore=lambda: 0,
            max_restarts=2, watchdog=mod.StepWatchdog(min_timeout_s=5))
    return {"calls": calls}


CASES = {"crash": _crash_case, "straggler": _straggler_case,
         "give_up": _give_up_case}
WANT = {"crash": {"restarts": 1, "final_step": 10,
                  "losses": [float(100 - s) for s in range(10)]},
        "straggler": {"restarts": 1, "final_step": 6,
                      "losses": [float(s) for s in range(6)]},
        "give_up": {"calls": [0, 0, 0]}}


@pytest.mark.parametrize("case", list(CASES))
def test_stats_equal_the_reference(case):
    got = CASES[case](wd)
    want = CASES[case](ref_wd)
    assert got == want == WANT[case]


@pytest.mark.parametrize("name", list(MODULES))
def test_step_budget(name):
    mod = MODULES[name]
    dog = mod.StepWatchdog(timeout_factor=4.0, min_timeout_s=0.5)
    assert dog._budget() == 60.0            # the first step: generous
    dog._times = [0.1, 0.3, 0.2]
    assert dog._budget() == pytest.approx(0.8)
    dog._times = [0.01]
    assert dog._budget() == 0.5             # never under min_timeout_s
    dog.fired.set()
    with pytest.raises(mod.StepTimeout, match="step exceeded"):
        dog.check()
    dog.check()                             # the flag is cleared


def test_the_port_is_a_copy():
    """Standard library only, the reference's names and signatures."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(wd))
    roots = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert roots <= {"__future__", "statistics", "threading", "time",
                     "typing"}
    assert issubclass(wd.StepTimeout, RuntimeError)
    for name in ("StepWatchdog", "run_with_recovery"):
        assert (inspect.signature(getattr(wd, name))
                == inspect.signature(getattr(ref_wd, name)))


def _snapshot(state):
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.detach().clone(), state)


def test_recovery_drives_the_train_step():
    """Snapshots in host memory every 2 steps; a RuntimeError at step 3 and
    a stall past the budget at step 5, each once: 2 restarts, and the run
    ends where an uninterrupted one does, bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.optim import AdamWConfig
    from repro_torch.train_lib import train as train_lib
    from repro_torch.tree import flatten_with_path

    cfg = get_config("qwen2-1.5b", smoke=True)
    tcfg = train_lib.TrainConfig(microbatches=2, compute_dtype=torch.float32,
                                 optimizer=AdamWConfig(lr=5e-3))
    src = make_source(cfg, DataConfig(batch=4, seq_len=16))
    step_fn = train_lib.make_train_step(cfg, tcfg)
    init = train_lib.init_state(cfg, tcfg,
                                generator=torch.Generator().manual_seed(0))
    steps = 8

    straight, want = _snapshot(init), []
    for s in range(steps):
        straight, m = step_fn(straight, train_lib.device_batch(src.batch(s),
                                                               "cpu"))
        want.append(float(m["ce"]))

    live = {"state": _snapshot(init)}
    snaps = {0: _snapshot(init)}
    faults = {3: "crash", 5: "stall"}

    def run_step(s):
        fault = faults.pop(s, None)
        if fault == "crash":
            raise RuntimeError(f"injected failure at step {s}")
        live["state"], m = step_fn(live["state"], train_lib.device_batch(
            src.batch(s), "cpu"))
        ce = float(m["ce"])                  # the step's host sync point
        if fault == "stall":
            time.sleep(2 * dog._budget())  # past the budget, however slow
        return ce

    def save(s):
        snaps[s] = _snapshot(live["state"])

    def restore():
        last = max(snaps)
        live["state"] = _snapshot(snaps[last])
        return last

    # a floor of 1.5 s: a step slowed by a loaded host is no straggler
    dog = wd.StepWatchdog(timeout_factor=4.0, min_timeout_s=1.5)
    stats = wd.run_with_recovery(
        steps=steps, start_step=0, run_step=run_step, save=save,
        restore=restore, ckpt_every=2, watchdog=dog)
    assert stats["restarts"] == 2 and stats["final_step"] == steps
    assert stats["losses"] == want
    for (k, a), (_, b) in zip(flatten_with_path(live["state"]),
                              flatten_with_path(straight)):
        assert torch.equal(a, b), k
