"""The weight bridge: a parameter tree in the JAX `init_params` layout,
already converted to numpy, becomes the port's dict of tensors.

The layout is kept as it is: `stack` leaves keep their leading period
axis, `tail` stays a list, `embed` and `lm_head` keep their shapes.  The
bridge never imports JAX; the caller hands it numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, *, device, dtype: torch.dtype | None = None):
    """dict / list / ndarray tree -> the same tree of tensors on `device`
    (in `dtype` if given, else the arrays' own dtype)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=device, dtype=dtype)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device=device, dtype=dtype) for v in tree]
    t = torch.from_numpy(np.array(tree))  # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype)
