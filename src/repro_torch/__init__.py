"""PyTorch/CUDA port of the ReDas reproduction for one NVIDIA H100.

A package beside the JAX reference `repro`: it imports nothing of it.
It runs the ten architectures of `configs` (decoders of "attn",
"local", "ssm" and "rglru" blocks, a VLM with prefix embeddings, an
encoder over frame embeddings): greedy serving in one static batch and
through the continuous-batching `serve_lib.scheduler.Scheduler` over a
contiguous or paged KV cache, with every engine GEMM on the
hand-written ReDas kernel (`kernels/csrc/redas_gemm.cu`), paged decode
attention on `kernels/csrc/paged_attention.cu`, and the int8, N:M-sparse
and grouped GEMMs under their postures; `kernels/csrc/flash_attention.cu`
sits behind `Engine.attention`.  Importing the package builds nothing;
the first CUDA tensor that reaches a kernel compiles it.
"""
