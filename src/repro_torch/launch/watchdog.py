"""Straggler / hang mitigation for synchronous SPMD training (a copy of
`repro/launch/watchdog.py`: standard library only).

In synchronous data parallelism a straggling or wedged host stalls every
peer at the next collective.  The recovery path is: detect -> abandon the
step -> relaunch from the last complete checkpoint on the surviving hosts
(the checkpoint layer reshards, the deterministic data pipeline replays
the exact stream).  This module provides the detect/relaunch harness
around a train loop:

  * `StepWatchdog` — arms a timer per step; if a step exceeds
    `timeout_factor` x the trailing-median step time, the step is
    abandoned (`check` raises `StepTimeout` after the step's host-side
    sync point);
  * `run_with_recovery` — drives step functions under the watchdog and
    performs restore-and-continue on failure, bounded by `max_restarts`.
    Its `save` and `restore` are callables, so the snapshots may live in
    a checkpoint directory or in host memory.
"""

from __future__ import annotations

import statistics
import threading
import time
from typing import Callable


class StepTimeout(RuntimeError):
    pass


class StepWatchdog:
    def __init__(self, timeout_factor: float = 5.0, min_timeout_s: float = 1.0,
                 history: int = 20):
        self.timeout_factor = timeout_factor
        self.min_timeout_s = min_timeout_s
        self._times: list[float] = []
        self._history = history
        self._timer: threading.Timer | None = None
        self.fired = threading.Event()

    def _budget(self) -> float:
        if not self._times:
            return max(self.min_timeout_s, 60.0)  # first step: generous
        return max(self.min_timeout_s,
                   self.timeout_factor * statistics.median(self._times))

    def __enter__(self):
        self._t0 = time.monotonic()
        self._timer = threading.Timer(self._budget(), self.fired.set)
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, *exc):
        assert self._timer is not None
        self._timer.cancel()
        if exc[0] is None:
            self._times.append(time.monotonic() - self._t0)
            del self._times[:-self._history]
        return False

    def check(self) -> None:
        """Call after the step's host-side sync point."""
        if self.fired.is_set():
            self.fired.clear()
            raise StepTimeout(
                f"step exceeded {self._budget():.1f}s "
                f"(median {statistics.median(self._times) if self._times else float('nan'):.2f}s)"
            )


def run_with_recovery(
    *,
    steps: int,
    start_step: int,
    run_step: Callable[[int], float],
    save: Callable[[int], None],
    restore: Callable[[], int],
    ckpt_every: int = 50,
    max_restarts: int = 3,
    watchdog: StepWatchdog | None = None,
) -> dict:
    """Drive `run_step(step)` with checkpoint/restart on StepTimeout or
    crash.  `restore()` returns the step to resume from.  Returns stats."""
    wd = watchdog or StepWatchdog()
    restarts = 0
    step = start_step
    losses: list[float] = []
    while step < steps:
        try:
            with wd:
                loss = run_step(step)
            wd.check()
        except (StepTimeout, RuntimeError) as e:
            restarts += 1
            if restarts > max_restarts:
                raise
            step = restore()
            losses = losses[: max(0, step - start_step)]
            print(f"[watchdog] {type(e).__name__}: {e} -> restored to "
                  f"step {step} (restart {restarts}/{max_restarts})",
                  flush=True)
            continue
        losses.append(loss)
        step += 1
        if step % ckpt_every == 0:
            save(step)
    return {"losses": losses, "restarts": restarts, "final_step": step}
