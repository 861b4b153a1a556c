"""Stacked ``(data, model)`` meshes.

On the stacked-rank backend a mesh is a shape, not a device set: every
rank is a row of the leading dimension of each tensor, row-major over
``(data, model)`` as ``jax.make_mesh`` lays out devices.  These are plain
constructors of that shape (:class:`~repro_torch.models.common.MeshContext`);
they touch no device.  A pod axis is not part of the port yet.
"""
from __future__ import annotations

from repro_torch.models.common import MeshContext


def make_production_mesh(*, multi_pod: bool = False) -> MeshContext:
    """The JAX package's 16x16 production mesh (256 ranks)."""
    if multi_pod:
        raise NotImplementedError(
            "the pod axis (hierarchical_all_reduce) is not ported yet; see "
            "ROADMAP.md Queue 1")
    return make_test_mesh(16, 16)


def make_test_mesh(data: int = 2, model: int = 4, pod: int = 0
                   ) -> MeshContext:
    """A ``(data, model)`` mesh of ``data · model`` stacked ranks."""
    if pod:
        raise NotImplementedError(
            "the pod axis (hierarchical_all_reduce) is not ported yet; see "
            "ROADMAP.md Queue 1")
    return MeshContext.stacked(model, data)
