"""--arch registry: id -> ArchConfig -> model (``repro/models/registry.py``).

The port serves the dense attention family: smollm-135m, glm4-9b,
qwen2.5-14b (untied head), command-r-plus-104b (LayerNorm, parallel block)
and internvl2-2b (a stub vision prefix); the recurrent family: mamba-130m
(Mamba mixers) and rwkv6-7b (RWKV-6 time- and channel-mix); and the
encoder-decoder whisper-tiny.  The reference's other ids raise ``KeyError``
naming the part of the other-architectures slice they wait for.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

_MODULES = {
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "qwen2.5-14b": "repro_torch.configs.qwen25_14b",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "mamba-130m": "repro_torch.configs.mamba_130m",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
}

# Reference archs not ported yet, by the part of the other-architectures
# slice (ROADMAP.md queue 1, item 1) that brings them.
_WAITING = {
    "phi3.5-moe-42b-a6.6b": "MoE and hybrid (item 1d)",
    "kimi-k2-1t-a32b": "MoE and hybrid (item 1d)",
    "jamba-v0.1-52b": "MoE and hybrid (item 1d)",
}


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
                           f"other-architectures slice, {_WAITING[base_id]} (ROADMAP.md "
                           "queue 1)")
        if base_id not in _MODULES:
            raise KeyError(f"unknown arch {arch_id!r}; ported: {list_archs()}")
        cfg = importlib.import_module(_MODULES[base_id]).CONFIG
        _cache[arch_id] = cfg.smoke() if smoke else cfg
    return _cache[arch_id]
