"""Hand-written CUDA kernels for Hopper (``sm_90a``).

Each kernel lives in its own folder: ``csrc/*.cu`` (the CUDA source, built
at first use with ``nvcc`` into a shared library loaded through ``ctypes``),
``ops.py`` (the wrapper, the build and a launch counter) and ``ref.py`` (the
plain PyTorch version, used for CPU tensors and as the test oracle).
"""
