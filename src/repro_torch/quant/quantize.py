"""Symmetric per-channel int8 quantization (weights and the per-row
codec), the port of `repro/quant/quantize.py`.

Scales sit on the axis the consuming GEMM does NOT contract, so the
int32 accumulator is rescaled once per output element:

  weights (..., K, N) -> scale (..., 1, N), per output channel;
  rows    (..., D)    -> scale (...,), one per row.

The arithmetic is the JAX package's, step for step, so both give the
same bits: f32 throughout, a max-abs scale (1.0 for an all-zero
channel), a true division of the values by the scale (never a multiply
by its reciprocal), round half to even (`torch.round`, as `jnp.round`),
clamp to +-127.

The scale itself is `amax / 127` where the JAX package runs the codec
eagerly (`quantize_params`), but inside `jax.jit` XLA rewrites a
division by a constant into a multiply by its reciprocal, so there it
is `amax * f32(1/127)`: the two differ in the last bit for a few
percent of rows.  The int8 GEMM quantizes its activations inside the
reference's jit, so `kernels/quant_gemm.py` asks for that form
(`jitted=True`).  Both forms are spelled out here so that they give the
same bits on the CPU and on the card (torch itself divides a CUDA tensor
by a Python number through the reciprocal).
"""

from __future__ import annotations

import torch

#: int8 symmetric range: +-127 keeps the codomain symmetric (no -128).
QMAX = 127.0

#: f32(1 / 127), written exactly: the constant XLA multiplies by for
#: `amax / QMAX` inside jit.
INV_QMAX = 0.007874015718698502

#: param-dict keys whose "w" leaf is consumed by a raw `@` instead of
#: `models.layers.dense` (the MoE router, the SSM projections): never
#: quantized.
SKIP_KEYS = ("router", "in_proj", "out_proj")


class QuantizedTensor:
    """int8 values `q` and broadcastable float32 `scale`; `q * scale`
    reconstructs the tensor.  Both carry the same leading dims, so
    indexing a stacked weight's period is `QuantizedTensor(q[i],
    scale[i])`."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.dim()

    def to(self, device) -> "QuantizedTensor":
        """The same storage on `device` (q stays int8, scale f32)."""
        return QuantizedTensor(self.q.to(device), self.scale.to(device))

    @property
    def nbytes(self) -> int:
        return self.q.nbytes + self.scale.nbytes

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return (self.q.float() * self.scale).to(dtype)

    def __repr__(self) -> str:
        return (f"QuantizedTensor(shape={tuple(self.q.shape)}, "
                f"scale_shape={tuple(self.scale.shape)})")


def _scale_from_amax(amax: torch.Tensor, jitted: bool) -> torch.Tensor:
    """max-abs -> scale: `amax / 127` (a true division on every device:
    the divisor is a tensor), or under `jitted` XLA's `amax * f32(1/127)`;
    1.0 for an all-zero row or channel."""
    scale = (amax * INV_QMAX if jitted
             else amax / torch.full_like(amax, QMAX))
    return torch.where(amax > 0.0, scale, torch.ones_like(amax))


def _scale_for(x: torch.Tensor, axis: int, jitted: bool = False
               ) -> torch.Tensor:
    """Max-abs symmetric scale reducing `axis`, kept as a broadcastable
    dim."""
    return _scale_from_amax(x.float().abs().amax(dim=axis, keepdim=True),
                            jitted)


def quantize(x: torch.Tensor, axis: int = -2, *,
             jitted: bool = False) -> QuantizedTensor:
    """Symmetric per-channel quantization of `x`, reducing `axis` (the
    default -2 gives a (K, N) weight one scale per output channel, (1,
    N); a stacked (P, K, N) weight gets (P, 1, N)).  `jitted` gives the
    scale the JAX package computes inside `jax.jit`."""
    scale = _scale_for(x, axis, jitted)
    q = torch.clamp(torch.round(x.float() / scale), -QMAX, QMAX)
    return QuantizedTensor(q.to(torch.int8), scale)


def dequantize(qt: QuantizedTensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return qt.dequantize(dtype)


def quantize_params(params):
    """Swap every `models.layers.dense` weight for its QuantizedTensor:
    each `{"w": <float tensor, ndim >= 2>}` outside `SKIP_KEYS`.  Norm
    scales, biases, embeddings, the LM head and MoE expert stacks keep
    their dtype."""

    def walk(node, skip: bool):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if (k == "w" and not skip and isinstance(v, torch.Tensor)
                        and v.dim() >= 2 and v.is_floating_point()):
                    out[k] = quantize(v)
                else:
                    out[k] = walk(v, skip or k in SKIP_KEYS)
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, skip) for v in node)
        return node

    return walk(params, False)


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a dict / list tree (a QuantizedTensor
    counts q + scale, a `sparse.SparseTensor` its values, indices and
    scale: their `nbytes`)."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return getattr(tree, "nbytes", 0)


# --------------------------------------------------------------------------
# The per-row codec
# --------------------------------------------------------------------------


def kv_quantize(x: torch.Tensor, *, jitted: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., D) float -> (q int8 (..., D), scale float32 (...,)), one
    scale per row.  `jitted` gives the scale the JAX package computes
    inside `jax.jit`."""
    xf = x.float()
    scale = _scale_from_amax(xf.abs().amax(dim=-1), jitted)
    q = torch.clamp(torch.round(xf / scale[..., None]), -QMAX, QMAX)
    return q.to(torch.int8), scale


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of `kv_quantize`: q (..., D) int8, scale (...,) -> float."""
    return (q.float() * scale[..., None]).to(dtype)
