"""N:M structured sparsity of the weights (the port of
`repro/sparse/nm.py`).

A dense (..., K, N) weight is pruned per group of M consecutive K
elements of each output column: the N largest magnitudes stay, the rest
go.  It is stored compressed:

  values   (..., K_eff, N)  the kept values, in the weight's dtype (int8
                            under sparse x int8 storage)
  indices  (..., K_eff, N)  int8 in-group offsets (0..M-1) of each kept
                            value, ascending within its group
  scale    (..., 1, N)      per-output-channel f32 scales of sparse x int8
                            storage (int8 values); None for float values

with K_eff = ceil(K / M) * N.  The arithmetic is the JAX package's, so
`sparsify`, `densify` and `prune_params` give its bits: f32 magnitudes,
a stable descending sort per group (the earlier offset wins a tie), K
zero-padded to a multiple of M, and the densify a one-hot sum over the
in-group offset.

Sparse x int8 storage (`quantize=True`) quantizes the kept f32 values
per output column with the int8 codec's eager arithmetic
(`quant.quantize`: scale amax / 127 over the compressed K axis, 1.0 for
an all-zero column; round half to even; clamp to +-127), as the JAX
package's eager `sparsify` does.
"""

from __future__ import annotations

import torch

from ..quant.quantize import SKIP_KEYS, quantize as _quantize


def parse_sparsity(spec: str) -> tuple[int, int]:
    """Parse an "N:M" sparsity spec ("2:4" -> (2, 4)) with validation:
    1 <= N < M.  N == M would be dense storage with pure overhead, and
    the in-group indices are int8, so M is capped at 128."""
    try:
        n_s, m_s = str(spec).split(":")
        n, m = int(n_s), int(m_s)
    except ValueError:
        raise ValueError(f"sparsity must look like 'N:M' (e.g. '2:4'), "
                         f"got {spec!r}") from None
    if not 1 <= n < m:
        raise ValueError(f"sparsity {spec!r}: need 1 <= N < M")
    if m > 128:
        raise ValueError(f"sparsity {spec!r}: M is capped at 128 "
                         f"(in-group indices are int8)")
    return n, m


class SparseTensor:
    """Compressed N:M values and int8 index metadata.

    `shape` and `ndim` give the DENSE shape (..., K, N), so `layers.dense`
    reshapes on `w.shape[-1]` unchanged.  `values`, `indices` and `scale`
    share their leading dims, so a stacked weight's period is
    `SparseTensor(values[i], indices[i], ...)` with `n`, `m` and the dense
    contraction length `k_dense` kept (`models.transformer._index`)."""

    def __init__(self, values: torch.Tensor, indices: torch.Tensor,
                 scale: torch.Tensor | None = None, *, n: int = 2, m: int = 4,
                 k_dense: int | None = None):
        self.values = values
        self.indices = indices
        self.scale = scale
        self.n = int(n)
        self.m = int(m)
        if k_dense is None:
            k_dense = values.shape[-2] // self.n * self.m
        self.k_dense = int(k_dense)

    @property
    def shape(self) -> tuple:
        return (*self.values.shape[:-2], self.k_dense, self.values.shape[-1])

    @property
    def ndim(self) -> int:
        return self.values.dim()

    @property
    def density(self) -> float:
        return self.n / self.m

    @property
    def quantized(self) -> bool:
        """True for sparse x int8 storage (int8 values + per-column
        scales)."""
        return self.scale is not None

    @property
    def nbytes(self) -> int:
        return (self.values.nbytes + self.indices.nbytes
                + (self.scale.nbytes if self.scale is not None else 0))

    def index(self, i: int) -> "SparseTensor":
        """The i-th slice of the leading (period) axis."""
        return SparseTensor(self.values[i], self.indices[i],
                            None if self.scale is None else self.scale[i],
                            n=self.n, m=self.m, k_dense=self.k_dense)

    def to(self, device) -> "SparseTensor":
        """The same storage on `device`."""
        return SparseTensor(self.values.to(device), self.indices.to(device),
                            None if self.scale is None else self.scale.to(device),
                            n=self.n, m=self.m, k_dense=self.k_dense)

    def densify(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """The dense (..., K, N) weight, zeros at pruned positions: the
        one-hot sum over the in-group offset, in f32 (int8 values are
        scaled first)."""
        v = self.values.float()
        if self.scale is not None:
            v = v * self.scale
        lead = v.shape[:-2]
        k_eff, ncols = v.shape[-2:]
        groups = k_eff // self.n
        v4 = v.reshape(*lead, groups, self.n, ncols)
        i4 = self.indices.reshape(*lead, groups, self.n, ncols)
        planes = [torch.where(i4 == off, v4, 0.0).sum(dim=-2)
                  for off in range(self.m)]
        dense = torch.stack(planes, dim=-2).reshape(*lead, groups * self.m,
                                                    ncols)
        return dense[..., :self.k_dense, :].to(dtype)

    def __repr__(self) -> str:
        return (f"SparseTensor({self.n}:{self.m}, dense_shape="
                f"{tuple(self.shape)}, values_shape="
                f"{tuple(self.values.shape)}, quantized={self.quantized})")


def _sparsify_2d(x: torch.Tensor, n: int, m: int, values: torch.Tensor,
                 indices: torch.Tensor, scale: torch.Tensor | None) -> None:
    """Prune one (K, N) matrix into `values` / `indices` (K_eff, N), and
    with `scale` (1, N) given, store the kept f32 values as int8."""
    k, ncols = x.shape
    groups = -(-k // m)
    xf = x.float()
    if groups * m != k:
        xf = torch.cat([xf, xf.new_zeros(groups * m - k, ncols)])
    xg = xf.reshape(groups, m, ncols)
    order = torch.sort(-xg.abs(), dim=1, stable=True).indices
    keep = torch.sort(order[:, :n], dim=1).values
    vals = torch.gather(xg, 1, keep).reshape(groups * n, ncols)
    if scale is not None:
        qt = _quantize(vals, -2)
        vals = qt.q
        scale.copy_(qt.scale)
    values.copy_(vals)
    indices.copy_(keep.reshape(groups * n, ncols))


def sparsify(x: torch.Tensor, n: int = 2, m: int = 4, *,
             quantize: bool = False) -> SparseTensor:
    """Magnitude N:M pruning of a dense (..., K, N) weight.

    Per group of `m` consecutive K elements of each output column, keep
    the `n` largest magnitudes (stable on ties: the earlier offset wins)
    and record their in-group offsets ascending.  K is zero-padded up to
    a multiple of `m` first; padded positions never displace real values
    and `densify` slices them off.  `quantize=True` stores the kept
    values as int8 with a per-output-column f32 scale (..., 1, N), taken
    from the f32 values (sparse x int8).  A stacked weight is pruned one
    (K, N) slice at a time, so the f32 temporaries stay one slice wide."""
    if not 1 <= n < m:
        raise ValueError(f"need 1 <= N < M, got {n}:{m}")
    lead = x.shape[:-2]
    k, ncols = x.shape[-2:]
    k_eff = -(-k // m) * n
    values = torch.empty(*lead, k_eff, ncols,
                         dtype=torch.int8 if quantize else x.dtype,
                         device=x.device)
    indices = torch.empty(*lead, k_eff, ncols, dtype=torch.int8,
                          device=x.device)
    scale = (torch.empty(*lead, 1, ncols, dtype=torch.float32,
                         device=x.device) if quantize else None)
    flat_x = x.reshape(-1, k, ncols)
    flat_v = values.view(-1, k_eff, ncols)
    flat_i = indices.view(-1, k_eff, ncols)
    flat_s = None if scale is None else scale.view(-1, 1, ncols)
    for s in range(flat_x.shape[0]):
        _sparsify_2d(flat_x[s], n, m, flat_v[s], flat_i[s],
                     None if flat_s is None else flat_s[s])
    return SparseTensor(values, indices, scale, n=n, m=m, k_dense=k)


def densify(st: SparseTensor, dtype: torch.dtype = torch.float32
            ) -> torch.Tensor:
    return st.densify(dtype)


def prune_params(params, n: int = 2, m: int = 4, *, quantize: bool = False):
    """Swap every `models.layers.dense` weight for its SparseTensor: each
    `{"w": <float tensor, ndim >= 2>}` outside `SKIP_KEYS` (the targeting
    of `quant.quantize_params`).  Norm scales, biases, embeddings, the LM
    head and MoE expert stacks keep their dtype.  `quantize=True` stores
    the kept values as int8 with per-column scales (sparse x int8); the
    tree then takes no `quant.quantize_params`.  One leaf is pruned at a
    time."""

    def walk(node, skip: bool):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if (k == "w" and not skip and isinstance(v, torch.Tensor)
                        and v.dim() >= 2 and v.is_floating_point()):
                    out[k] = sparsify(v, n, m, quantize=quantize)
                else:
                    out[k] = walk(v, skip or k in SKIP_KEYS)
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, skip) for v in node)
        return node

    return walk(params, False)


def densify_params(params, dtype: torch.dtype = torch.float32):
    """The densified oracle: every SparseTensor scattered back to a dense
    tensor (pruned positions zero), everything else untouched; serving it
    plain must give the sparse original's tokens."""
    if isinstance(params, SparseTensor):
        return params.densify(dtype)
    if isinstance(params, dict):
        return {k: densify_params(v, dtype) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(densify_params(v, dtype) for v in params)
    return params
