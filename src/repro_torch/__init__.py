"""ACCL-X on PyTorch and CUDA: the port of the JAX package ``repro``.

The layout mirrors ``repro``: ``core/`` (configuration, plans, topology,
the stacked-rank communication backend), ``obs/`` (tracing and metrics),
``swe/`` (the shallow-water application) and ``kernels/`` (hand-written
CUDA kernels, each beside its plain PyTorch version).  Nothing here imports
JAX or the ``repro`` package.
"""
