"""PyTorch/CUDA port of the paged serving runtime.

A second package beside the JAX reference ``repro``: the same module names,
written for PyTorch, with the reference's Pallas TPU kernels replaced by
CUDA C++ kernels for Hopper (``kernels/csrc``).  It imports nothing of JAX
or of the reference package.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""
