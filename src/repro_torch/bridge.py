"""The weight bridge: a parameter tree in the JAX `init_params` layout,
already converted to numpy, becomes the port's dict of tensors.

The layout is kept as it is: `stack` leaves keep their leading period
axis, `tail` stays a list, `embed` and `lm_head` keep their shapes.  The
bridge never imports JAX; the caller hands it numpy arrays.  A quantized
tree (`jax.tree.map(np.asarray, quantize_params(params))` keeps the JAX
package's QuantizedTensor nodes, with numpy children) becomes the port's
QuantizedTensor: any node with `q` and `scale` attributes.  A pruned tree
(`prune_params`, its SparseTensor nodes likewise kept with numpy
`values` and `indices`) becomes the port's SparseTensor: any node with
`values`, `indices`, `n`, `m` and `k_dense`.
"""

from __future__ import annotations

import numpy as np
import torch

from .quant.quantize import QuantizedTensor
from .sparse.nm import SparseTensor


def params_from_numpy(tree, *, device, dtype: torch.dtype | None = None):
    """dict / list / ndarray tree -> the same tree of tensors on `device`
    (in `dtype` if given, else the arrays' own dtype; a quantized node
    keeps `q` int8 and `scale` float32 whatever `dtype` says, a sparse
    node its int8 `indices`, and its values in `dtype` unless they are
    int8)."""
    if hasattr(tree, "indices") and hasattr(tree, "k_dense"):
        int8 = np.asarray(tree.values).dtype == np.int8
        scale = tree.scale
        return SparseTensor(
            params_from_numpy(tree.values, device=device,
                              dtype=torch.int8 if int8 else dtype),
            params_from_numpy(tree.indices, device=device, dtype=torch.int8),
            None if scale is None else params_from_numpy(
                scale, device=device, dtype=torch.float32),
            n=tree.n, m=tree.m, k_dense=tree.k_dense)
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
