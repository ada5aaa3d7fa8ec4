"""Checkpointing (the port of `repro/checkpoint/checkpoint.py`): async
save, atomic rename, restore onto a like-shaped tree.

  * saves are step-granular and atomic: written to <dir>/tmp.<step>.npz,
    then renamed to <dir>/step_<step:09d>.npz, so a killed process never
    leaves a torn checkpoint visible;
  * `latest_step` picks the newest complete checkpoint, so `--resume
    auto` restarts from the last good step;
  * the state is copied to host memory before `save` returns, and written
    on a background thread; the next save (or `wait`) joins it first, so at
    most one is in flight, and re-raises what the write raised.

Format: one .npz a checkpoint, keyed by the reference's key paths
(`jax.tree_util.keystr`: `['opt']['mu']['stack']['b0']['attn']['wq']['w']`,
`[0]` for a list index; `tree.flatten_with_path` writes them), so a
checkpoint of either package restores in the other.  numpy has no
bfloat16: a bf16 leaf is written as float32, which holds it exactly and
which the reference's `restore` casts back; a bf16 leaf stored raw (the
reference writes ml_dtypes' bfloat16 as the void type `|V2`) is read by
its bits.
"""

from __future__ import annotations

import os
import re
import threading

import numpy as np
import torch

from ..tree import flatten_with_path, tree_unflatten


def _to_host(leaf) -> np.ndarray:
    t = torch.as_tensor(leaf).detach()
    if t.dtype == torch.bfloat16:
        t = t.float()           # exact; numpy has no bfloat16
    return t.cpu().numpy()


def _from_host(arr: np.ndarray, like: torch.Tensor, device) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device=device if device is not None else like.device,
                dtype=like.dtype)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state, blocking: bool = False) -> None:
        self.wait()  # at most one async save in flight
        host = {path: _to_host(leaf)
                for path, leaf in flatten_with_path(state)}

        def _write():
            tmp = os.path.join(self.dir, f"tmp.{step}.npz")
            final = os.path.join(self.dir, f"step_{step:09d}.npz")
            with open(tmp, "wb") as f:
                np.savez(f, **host)
            os.replace(tmp, final)
            self._gc()

        def _background():
            try:
                _write()
            except BaseException as err:   # re-raised by wait()
                self._error = err

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_background, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            os.remove(os.path.join(self.dir, f"step_{s:09d}.npz"))

    # -- restore --------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for f in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)\.npz", f)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like, device=None):
        """Rebuild the tree `like` (values ignored; layout, dtypes and
        devices used) from checkpoint `step`, on `device` if given."""
        path = os.path.join(self.dir, f"step_{step:09d}.npz")
        with np.load(path) as zf:
            leaves = [_from_host(zf[key], leaf, device)
                      for key, leaf in flatten_with_path(like)]
        return tree_unflatten(like, leaves)


def resume_or_init(ckpt: Checkpointer, init_fn, device=None):
    """--resume auto: (step, state) of the latest complete checkpoint,
    restored onto the layout `init_fn()` builds, else (0, init_fn())."""
    step = ckpt.latest_step()
    if step is None:
        return 0, init_fn()
    return step, ckpt.restore(step, init_fn(), device)
