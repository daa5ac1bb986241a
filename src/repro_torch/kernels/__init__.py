"""Hand-written Hopper kernels for the port's compute hot spots.

flash_attention (K3), decode_attention (K4), the paged pair
paged_decode_attention (K1) / paged_chunk_attention (K2), the MoE layer's
per-expert grouped GEMM moe_gmm (K5) and the Mamba-2 SSD chunked scan
ssd_scan (K6) are CUDA C++ sources under ``csrc/``, built by ``build.py``
and launched through ctypes
wrappers that keep launch counters. Each has a plain PyTorch version in
``ref.py`` (the counterpart of ``repro/kernels/ref.py``) that a wrapper runs
only for tensors on the CPU; ``ops.py`` holds the entry points the models
call.
"""
