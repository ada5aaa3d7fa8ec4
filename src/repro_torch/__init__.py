"""PyTorch/CUDA port of the ReDas reproduction for one NVIDIA H100.

A package beside the JAX reference `repro`: it imports nothing of it.
The slice ported so far is greedy serving of the dense decoder
(`configs.get_config("qwen2-1.5b")`) with every engine GEMM on the
hand-written ReDas kernel (`kernels/csrc/redas_gemm.cu`).  Importing the
package builds nothing; the first CUDA tensor that reaches a kernel
compiles it.
"""
