"""--arch <id> registry over the assigned architecture pool."""
from __future__ import annotations

from typing import Dict

from .base import ArchConfig, SHAPES, ShapeSpec, cell_skip_reason, input_specs, runnable_cells
from .arctic_480b import CONFIG as ARCTIC
from .llama4_scout_17b_a16e import CONFIG as LLAMA4
from .nemotron_4_15b import CONFIG as NEMOTRON
from .deepseek_7b import CONFIG as DEEPSEEK
from .h2o_danube_3_4b import CONFIG as DANUBE
from .chatglm3_6b import CONFIG as CHATGLM
from .hymba_1_5b import CONFIG as HYMBA
from .internvl2_76b import CONFIG as INTERNVL
from .falcon_mamba_7b import CONFIG as FALCON_MAMBA
from .hubert_xlarge import CONFIG as HUBERT

ARCHS: Dict[str, ArchConfig] = {
    c.name: c
    for c in (
        ARCTIC, LLAMA4, NEMOTRON, DEEPSEEK, DANUBE,
        CHATGLM, HYMBA, INTERNVL, FALCON_MAMBA, HUBERT,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def all_cells():
    """Every (arch, shape) pair with its skip reason (None = runnable)."""
    out = []
    for cfg in ARCHS.values():
        for shape in SHAPES.values():
            out.append((cfg, shape, cell_skip_reason(cfg, shape)))
    return out
