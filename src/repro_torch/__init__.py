"""PyTorch/CUDA port of the Provuse reproduction.

Mirrors ``repro``'s module paths and public names. Imports ``torch`` and
numpy only — never JAX and never the ``repro`` package; what it needs from a
framework-neutral ``repro`` module lives here as its own copy.
"""
