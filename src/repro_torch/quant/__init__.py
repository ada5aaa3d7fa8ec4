"""The int8 precision plane of the port (the port of `repro/quant/`).

  * `QuantizedTensor` — int8 values + float32 per-channel scales (a plain
    class: `models.transformer._index` slices it per period).
  * `quantize` / `dequantize` — symmetric per-channel max-abs int8.
  * `quantize_params` — swap every `models.layers.dense` weight for its
    quantized form (same walk and skip list as the JAX package).
  * `kv_quantize` / `kv_dequantize` — the per-row codec; the int8 GEMM's
    per-row activation quantization is this codec.

Execution lives in `kernels/quant_gemm.py` (the int8 x int8 -> int32
kernel) behind the engine's "hopper-int8" / "torch-ref-int8" backends.
"""

from .quantize import (QMAX, SKIP_KEYS, QuantizedTensor, dequantize,
                       kv_dequantize, kv_quantize, quantize, quantize_params,
                       tree_bytes)

__all__ = [
    "QMAX", "SKIP_KEYS", "QuantizedTensor", "dequantize", "kv_dequantize",
    "kv_quantize", "quantize", "quantize_params", "tree_bytes",
]
