"""PyTorch/CUDA port of the repro package, for one NVIDIA H100.

It serves the dense llama family (llama3.2-3b) and Mamba2 (mamba2-780m),
each at its published width, through the request-level ``serve.Engine``,
with hand-written CUDA kernels for RMSNorm, prefill flash attention, the
decode-stat accumulation and the SSD chunked scan (``kernels/``), and it
carries the paper's collectives over ``torch.distributed`` (``core/``) with
the DMA allgather kernel. It trains the dense family with FSDP through the
locality-aware Bruck parameter gather and its reduce-scatter transpose
(``train/``, ``optim/``, ``data/``), with backward kernels for flash
attention and RMSNorm. It imports torch and numpy and nothing of the JAX
package.
"""
