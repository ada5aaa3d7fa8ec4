"""The weight bridge: a parameter tree in the JAX `init_params` layout,
already converted to numpy, becomes the port's dict of tensors.

The layout is kept as it is: `stack` leaves keep their leading period
axis, `tail` stays a list, `embed` and `lm_head` keep their shapes.  The
bridge never imports JAX; the caller hands it numpy arrays.  A quantized
tree (`jax.tree.map(np.asarray, quantize_params(params))` keeps the JAX
package's QuantizedTensor nodes, with numpy children) becomes the port's
QuantizedTensor: any node with `q` and `scale` attributes.
"""

from __future__ import annotations

import numpy as np
import torch

from .quant.quantize import QuantizedTensor


def params_from_numpy(tree, *, device, dtype: torch.dtype | None = None):
    """dict / list / ndarray tree -> the same tree of tensors on `device`
    (in `dtype` if given, else the arrays' own dtype; a quantized node
    keeps `q` int8 and `scale` float32 whatever `dtype` says)."""
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        return QuantizedTensor(
            params_from_numpy(tree.q, device=device, dtype=torch.int8),
            params_from_numpy(tree.scale, device=device, dtype=torch.float32))
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=device, dtype=dtype)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device=device, dtype=dtype) for v in tree]
    t = torch.from_numpy(np.array(tree))  # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype)
