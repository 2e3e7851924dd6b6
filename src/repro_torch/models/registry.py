"""--arch registry: id -> ArchConfig -> model (``repro/models/registry.py``).

Only the archs the port serves so far are registered; the reference's other
ids raise ``KeyError`` naming the slice they wait for.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

_MODULES = {
    "smollm-135m": "repro_torch.configs.smollm_135m",
}

# Reference archs not ported yet: they wait for the other-architectures slice.
_WAITING = ("command-r-plus-104b", "glm4-9b", "qwen2.5-14b", "jamba-v0.1-52b",
            "phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b", "whisper-tiny",
            "internvl2-2b", "rwkv6-7b", "mamba-130m")


def list_archs() -> List[str]:
    return list(_MODULES)


_cache: Dict[str, object] = {}


def get_config(arch_id: str):
    """The ArchConfig for ``arch_id`` (``<id>-smoke`` gives its reduced config)."""
    if arch_id not in _cache:
        smoke = arch_id.endswith("-smoke")
        base_id = arch_id[:-6] if smoke else arch_id
        if base_id in _WAITING:
            raise KeyError(f"arch {arch_id!r} is not ported yet: it waits for the "
                           "other-architectures slice (ROADMAP.md queue 1)")
        if base_id not in _MODULES:
            raise KeyError(f"unknown arch {arch_id!r}; ported: {list_archs()}")
        cfg = importlib.import_module(_MODULES[base_id]).CONFIG
        _cache[arch_id] = cfg.smoke() if smoke else cfg
    return _cache[arch_id]

