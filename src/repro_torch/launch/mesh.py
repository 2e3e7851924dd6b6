"""Process groups and host meshes over ``torch.distributed``
(``repro/launch/mesh.py``).

One process a rank: ``torchrun`` starts them and sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT`` in each.
:func:`init_process_group` forms the group from that environment on an
explicit backend, and :func:`make_host_mesh` lays the group out as a
``(data, model)`` :class:`~torch.distributed.device_mesh.DeviceMesh`, rank
(d, m) at ``d * model + m``: the ``model`` ranks of one data index are
neighbours.

:func:`make_production_mesh` gives the reference's two production meshes,
(16, 16) ``(data, model)`` and (2, 16, 16) ``(pod, data, model)``, as a
``DeviceMesh`` over a ``"fake"`` process group in one process (its
collectives return at once and move nothing): the dry-run account
(``launch/dryrun.py``) runs rank 0's step on ``meta`` tensors there.
:data:`HW` is the H100 SXM's data-sheet table for the account's roofline
terms; :func:`hw_table` adds what the card itself reports when one is
present.
"""
from __future__ import annotations

import contextlib
import functools
import math
import os
import subprocess
from typing import Dict, Iterator, Optional, Sequence

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


# the reference's production meshes: one pod, and two pods
PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}

# H100 SXM 80GB, per card, from NVIDIA's data sheet (dense rates)
HW: Dict[str, float | str] = {
    "name": "h100-sxm",
    "peak_bf16_flops": 989e12,     # FLOP/s, tensor cores
    "peak_int8_ops": 1979e12,      # OP/s, tensor cores
    "peak_f32_flops": 67e12,       # FLOP/s outside the tensor cores
    "hbm_bytes_per_s": 3.35e12,
    "nvlink_bytes_per_s_per_link": 50e9,   # 900 GB/s over 18 links, both directions
    "nvlink_links": 18,
    "hbm_bytes": 80e9,
}


def hw_table() -> Dict[str, float | str]:
    """:data:`HW`, plus the card's own name, memory and power limit when
    a card is visible (``torch.cuda`` and ``nvidia-smi``, read once a
    process)."""
    return dict(_hw_table())


@functools.lru_cache(maxsize=1)
def _hw_table() -> Dict[str, float | str]:
    out = dict(HW)
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        out["card"] = props.name
        out["card_memory_bytes"] = int(props.total_memory)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        out["card_power_limit"] = smi.stdout.strip().splitlines()[0].split(",")[-1].strip()
    return out


@contextlib.contextmanager
def fake_mesh(shape: Sequence[int], axes: Sequence[str]) -> Iterator:
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over a ``"fake"`` group
    of prod(shape) ranks in this process, as rank 0; the group is destroyed
    on exit.  Its collectives move nothing: the account reads their calls
    and bytes (``dist.shard_ops.collective_counts``).  A group that is
    already up is refused, and a fake group that does not form raises."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_mesh: a process group is already up in this process")
    world = math.prod(shape)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield DeviceMesh("cpu", torch.arange(world).reshape(tuple(shape)),
                         mesh_dim_names=tuple(axes))
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh as a context manager over a fake
    group (:func:`fake_mesh`): one pod (data=16, model=16), or two (pod=2,
    data=16, model=16)."""
    return fake_mesh(*PRODUCTION_MESHES[multi_pod])
