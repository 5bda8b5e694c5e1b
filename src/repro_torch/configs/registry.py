"""Architecture registry: ``--arch <id>`` resolution for launchers/tests
(data only).  ``ARCH_IDS`` are the same ten configurations as
``repro/configs``; ``get_config`` also resolves the port's own
``zamba2-7b-instruct`` (the published Zamba2 structure, which the JAX
package does not model) and its ``-reduced``."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import ArchConfig
from repro_torch.configs import (
    deepseek_v2_lite_16b, zamba2_7b, phi35_moe_42b, qwen3_4b,
    seamless_m4t_medium, command_r_35b, mamba2_2p7b, internvl2_26b,
    granite_20b, smollm_360m, zamba2_7b_instruct,
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
# the port's own configurations, beyond the JAX package's ten
_PORT_ONLY: Dict[str, ArchConfig] = {
    "zamba2-7b-instruct": zamba2_7b_instruct.CONFIG,
}


def get_config(arch: str) -> ArchConfig:
    if arch.endswith("-reduced"):
        return get_config(arch[: -len("-reduced")]).reduced()
    if arch in _PORT_ONLY:
        return _PORT_ONLY[arch]
    if arch not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; options: "
                       f"{ARCH_IDS + list(_PORT_ONLY)}")
    return _ARCHS[arch]


def all_configs() -> Dict[str, ArchConfig]:
    return dict(_ARCHS)
