"""PyTorch/CUDA port of the ReDas reproduction for one NVIDIA H100.

A package beside the JAX reference `repro`: it imports nothing of it.
Ported so far: greedy serving of the dense decoder
(`configs.get_config("qwen2-1.5b")`), in one static batch and through
the continuous-batching `serve_lib.scheduler.Scheduler` over a
contiguous or paged KV cache, with every engine GEMM on the hand-written
ReDas kernel (`kernels/csrc/redas_gemm.cu`) and paged decode attention
on `kernels/csrc/paged_attention.cu`; `kernels/csrc/flash_attention.cu`
sits behind `Engine.attention`.  Importing the package builds nothing;
the first CUDA tensor that reaches a kernel compiles it.
"""
