"""PyTorch/CUDA port of the LITS learned string index.

Mirrors :mod:`repro` (the JAX reference) module for module: ``core/`` (host
builder, tensor index, walk), ``kernels/`` (hand-written CUDA kernels and
their plain PyTorch versions), ``index/`` (the ``StringIndex`` facade) and
``data/``.  It imports neither ``jax`` nor ``repro``.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""
