"""--arch registry: id -> ArchConfig -> model (``repro/models/registry.py``).

The port serves the dense attention family: smollm-135m, glm4-9b,
qwen2.5-14b (untied head), command-r-plus-104b (LayerNorm, parallel block)
and internvl2-2b (a stub vision prefix); the recurrent family: mamba-130m
(Mamba mixers) and rwkv6-7b (RWKV-6 time- and channel-mix); the
encoder-decoder whisper-tiny; and the MoE and hybrid family:
phi3.5-moe-42b-a6.6b, kimi-k2-1t-a32b (a dense prelude layer and a shared
expert) and jamba-v0.1-52b (Mamba and attention, MoE every other layer).
Every id of the reference's registry resolves: none waits for a later slice.
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
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v01_52b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi35_moe_42b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t",
}


def list_archs() -> List[str]:
    return list(_MODULES)


_cache: Dict[str, object] = {}


def get_config(arch_id: str):
    """The ArchConfig for ``arch_id`` (``<id>-smoke`` gives its reduced config)."""
    if arch_id not in _cache:
        smoke = arch_id.endswith("-smoke")
        base_id = arch_id[:-6] if smoke else arch_id
        if base_id not in _MODULES:
            raise KeyError(f"unknown arch {arch_id!r}; ported: {list_archs()}")
        cfg = importlib.import_module(_MODULES[base_id]).CONFIG
        _cache[arch_id] = cfg.smoke() if smoke else cfg
    return _cache[arch_id]
