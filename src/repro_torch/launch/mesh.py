"""Process groups and host meshes over ``torch.distributed``
(``repro/launch/mesh.py``).

One process a rank: ``torchrun`` starts them and sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT`` in each.
:func:`init_process_group` forms the group from that environment on an
explicit backend, and :func:`make_host_mesh` lays the group out as a
``(data, model)`` :class:`~torch.distributed.device_mesh.DeviceMesh`, rank
(d, m) at ``d * model + m``: the ``model`` ranks of one data index are
neighbours.  The reference's production mesh and its hardware table describe a TPU
pod and have no counterpart on the card.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.nn.module import resolve_device

BACKENDS = ("nccl", "gloo")


def launched() -> bool:
    """Whether this process is a rank that ``torchrun`` started."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_process_group(device: torch.device, backend: Optional[str] = None) -> str:
    """Form the default group of a ``torchrun`` launch on ``backend``
    (``nccl`` or ``gloo``; by default ``nccl`` on a card and ``gloo`` on
    the CPU) and return the backend.  On a card each rank takes device
    ``LOCAL_RANK``; NCCL refuses two ranks on one device, so a world larger
    than the card count raises here (gloo takes CUDA tensors for its
    all-reduce and broadcast and may share a card).  Nothing falls back:
    a group that does not form raises."""
    if not launched():
        raise RuntimeError("init_process_group: RANK and WORLD_SIZE are not set; "
                           "start the ranks with torchrun")
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    world = int(os.environ["WORLD_SIZE"])
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        if backend == "nccl" and world > cards:
            raise RuntimeError(f"nccl: {world} ranks on {cards} card(s); NCCL takes one rank "
                               "a card (use --backend gloo to share a card)")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % cards)
    elif backend == "nccl":
        raise ValueError("nccl carries CUDA tensors only; use gloo on the CPU")
    dist.init_process_group(backend, init_method="env://")
    return backend


def make_host_mesh(data: int = 1, model: int = 1, device=None):
    """A ``(data, model)`` :class:`DeviceMesh` over the group that is
    already up, on ``device``'s type (``cuda`` unless the caller passes
    ``"cpu"``); the world size must be ``data * model``."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh: no process group is up (init_process_group)")
    world = dist.get_world_size()
    if world != data * model:
        raise ValueError(f"make_host_mesh({data}, {model}): the world has {world} ranks")
    return DeviceMesh(resolve_device(device).type, torch.arange(world).reshape(data, model),
                      mesh_dim_names=("data", "model"))

