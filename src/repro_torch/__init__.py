"""repro_torch — the checkpoint/restore stack of ``repro`` on PyTorch and CUDA.

The PyTorch counterpart of the JAX package ``repro``: the same modules under
the same names, the same on-disk format, with the Pallas kernels replaced by
hand-written CUDA kernels for Hopper (``repro_torch.kernels``). It imports
``torch`` and never ``jax`` or ``repro``. Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU.
"""
