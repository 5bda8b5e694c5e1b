"""Architecture registry: ``--arch <id>`` resolution for launchers/tests
(data only, the same ten configurations as ``repro/configs``)."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import ArchConfig
from repro_torch.configs import (
    deepseek_v2_lite_16b, zamba2_7b, phi35_moe_42b, qwen3_4b,
    seamless_m4t_medium, command_r_35b, mamba2_2p7b, internvl2_26b,
    granite_20b, smollm_360m,
)

_ARCHS: Dict[str, ArchConfig] = {
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b.CONFIG,
    "zamba2-7b": zamba2_7b.CONFIG,
    "phi3.5-moe-42b-a6.6b": phi35_moe_42b.CONFIG,
    "qwen3-4b": qwen3_4b.CONFIG,
    "seamless-m4t-medium": seamless_m4t_medium.CONFIG,
    "command-r-35b": command_r_35b.CONFIG,
    "mamba2-2.7b": mamba2_2p7b.CONFIG,
    "internvl2-26b": internvl2_26b.CONFIG,
    "granite-20b": granite_20b.CONFIG,
    "smollm-360m": smollm_360m.CONFIG,
}

ARCH_IDS: List[str] = list(_ARCHS)


def get_config(arch: str) -> ArchConfig:
    if arch.endswith("-reduced"):
        return get_config(arch[: -len("-reduced")]).reduced()
    if arch not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; options: {ARCH_IDS}")
    return _ARCHS[arch]


def all_configs() -> Dict[str, ArchConfig]:
    return dict(_ARCHS)
