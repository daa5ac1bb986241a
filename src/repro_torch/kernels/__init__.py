"""Hand-written Hopper kernels for the port's compute hot spots.

flash_attention (K3) and decode_attention (K4) are CUDA C++ sources under
``csrc/``, built by ``build.py`` and launched through ctypes wrappers that
keep launch counters. Each has a plain PyTorch version in ``ref.py`` (the
counterpart of ``repro/kernels/ref.py``) that a wrapper runs only for
tensors on the CPU; ``ops.py`` holds the entry points the models call.
"""
