"""Architecture registry of the port.

``get_config(name)`` returns the full :class:`ArchConfig`;
``get_config(name, reduced=True)`` the CPU-runnable smoke config. Every
arch of the reference's registry is registered: the dense, ssm, moe,
hybrid, encoder-decoder and vision-language families.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.core.config import ArchConfig

_ARCH_MODULES = [
    "qwen1_5_0_5b",
    "mamba2_130m",
    "llama2_7b",
    "llama2_13b",
    "llama2_70b",
    "granite_3_2b",
    "qwen2_5_14b",
    "chatglm3_6b",
    "qwen3_moe_30b_a3b",
    "dbrx_132b",
    "jamba_v0_1_52b",
    "seamless_m4t_large_v2",
    "internvl2_26b",
]

_REGISTRY: Dict[str, ArchConfig] = {}


def _load() -> None:
    if _REGISTRY:
        return
    for mod_name in _ARCH_MODULES:
        mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
        cfg: ArchConfig = mod.CONFIG
        _REGISTRY[cfg.name] = cfg


def list_archs() -> List[str]:
    _load()
    return list(_REGISTRY)


def get_config(name: str, reduced: bool = False) -> ArchConfig:
    _load()
    name = name.replace("_", "-")
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]
    return cfg.reduced() if reduced else cfg
