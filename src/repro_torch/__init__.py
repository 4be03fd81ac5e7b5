"""PyTorch/CUDA port of the DynMo reproduction (``src/repro`` is the JAX
reference it is held against).

The port grows slice by slice; this package imports ``torch`` and never
``jax`` or anything of ``repro``.  Every entry point runs on the CUDA card
unless the caller asks for ``device="cpu"``, where each kernel wrapper
falls back to its plain PyTorch version (see ``repro_torch.kernels``).
"""
