"""Hand-written CUDA kernels of the port, one package per TPU kernel.

Each package holds ``ref.py`` (the plain PyTorch version, run for CPU
tensors and held against the kernel on the card) and ``ops.py`` (the
wrapper: checks, allocation, launch, a ``LAUNCHES`` count). The CUDA
sources live in ``csrc/`` and are built at first use by ``_build.py``.
"""
