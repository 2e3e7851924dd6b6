"""The distribution layer (``repro/dist``) over ``torch.distributed``: one
process a rank, the collectives explicit.

* :mod:`repro_torch.dist.sharding`: the axis rules and the per-leaf specs
  (parameters sharded over ``data`` and ``model``);
* :mod:`repro_torch.dist.shard_ops`: the collectives of the sharded
  execution as autograd functions, counted;
* :mod:`repro_torch.dist.compress`: the gradient all-reduce, exact or on the
  paper's power-of-two grid with error feedback;
* :mod:`repro_torch.dist.pipeline`: GPipe over point-to-point sends.
"""
from __future__ import annotations


def axis_group(mesh, axis_name: str):
    """The process group along ``axis_name`` of a ``DeviceMesh``."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis_name not in names:
        raise ValueError(f"the mesh has no axis {axis_name!r} (its axes: {names})")
    return mesh.get_group(axis_name)
