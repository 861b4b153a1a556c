"""Stacked ``(data, model)`` and ``(pod, data, model)`` meshes.

On the stacked-rank backend a mesh is a shape, not a device set: every
rank is a row of the leading dimension of each tensor, row-major over
``(pod, data, model)`` as ``jax.make_mesh`` lays out devices.  These are
plain constructors of that shape
(:class:`~repro_torch.models.common.MeshContext`); they touch no device.
"""
from __future__ import annotations

from repro_torch.models.common import MeshContext


def make_production_mesh(*, multi_pod: bool = False) -> MeshContext:
    """16x16 = 256 ranks per pod; 2x16x16 = 512 ranks multi-pod."""
    if multi_pod:
        return make_test_mesh(16, 16, pod=2)
    return make_test_mesh(16, 16)


def make_test_mesh(data: int = 2, model: int = 4, pod: int = 0
                   ) -> MeshContext:
    """A ``(data, model)`` mesh of ``data · model`` stacked ranks, or with
    ``pod`` the ``(pod, data, model)`` mesh of ``pod · data · model``."""
    if pod:
        return MeshContext(data_axes=("pod", "data"), model_size=model,
                           data_sizes=(pod, data))
    return MeshContext.stacked(model, data)
