"""The N:M structured-sparsity plane of the port (the port of
`repro/sparse/`).

  * `SparseTensor` — compressed kept values + int8 in-group offsets (a
    plain class: `models.transformer._index` slices it per period).
  * `sparsify` / `densify` — magnitude N:M pruning and its one-hot
    inverse, bit for bit the JAX package's.
  * `prune_params` / `densify_params` — swap every `models.layers.dense`
    weight for its pruned form (same walk and skip list as
    `quant.quantize_params`), and back.

Execution lives in `kernels/sparse_gemm.py` (the scatter-then-multiply
kernel) behind the engine's "hopper-sparse" / "torch-ref-sparse"
backends; `quantize=True` stores the kept values as int8 with
per-column scales (sparse x int8), which the same kernel takes.
"""

from .nm import (SparseTensor, densify, densify_params, parse_sparsity,
                 prune_params, sparsify)

__all__ = ["SparseTensor", "densify", "densify_params", "parse_sparsity",
           "prune_params", "sparsify"]
