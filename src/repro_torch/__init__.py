"""PyTorch/CUDA port of the repro package, for one NVIDIA H100.

It serves the dense llama family (llama3.2-3b at its published width)
through the request-level ``serve.Engine``, with hand-written CUDA kernels
for RMSNorm, prefill flash attention and the decode-stat accumulation
(``kernels/``). It imports torch and numpy and nothing of the JAX package.
"""
