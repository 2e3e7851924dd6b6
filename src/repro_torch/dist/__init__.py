"""The distribution layer's data axis (``repro/dist``) over
``torch.distributed``: one process a rank, the collectives explicit.

* :mod:`repro_torch.dist.compress`: the gradient all-reduce, exact or on the
  paper's power-of-two grid with error feedback;
* :mod:`repro_torch.dist.pipeline`: GPipe over point-to-point sends.

The reference's sharding rules (``repro/dist/sharding.py``: parameters
sharded over ``data`` and ``model``) wait for the port's distribution slice.
"""
from __future__ import annotations

MODEL_AXIS_LATER = ("a model axis (model > 1) and the sharding rules (axis_rules=) wait "
                    "for the port's distribution slice (ROADMAP.md queue 1)")


def axis_group(mesh, axis_name: str):
    """The process group along ``axis_name`` of a ``DeviceMesh``; every
    other axis must be of size 1, since parameters sharded over a second
    axis wait for the distribution slice."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis_name not in names:
        raise ValueError(f"the mesh has no axis {axis_name!r} (its axes: {names})")
    for name, size in zip(names, mesh.mesh.shape):
        if name != axis_name and size != 1:
            raise NotImplementedError(f"a mesh with {name}={size}: {MODEL_AXIS_LATER}")
    return mesh.get_group(axis_name)
