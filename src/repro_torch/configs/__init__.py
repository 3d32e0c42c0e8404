"""Architecture configs (the port of :mod:`repro.configs`): ``ArchConfig``,
the shape cells and the ``--arch <id>`` registry."""
from .base import ArchConfig, SHAPES, ShapeSpec, cache_specs, cell_skip_reason, input_specs
from .registry import ARCHS, all_cells, get_arch

__all__ = ["ARCHS", "ArchConfig", "SHAPES", "ShapeSpec", "all_cells", "cache_specs",
           "cell_skip_reason", "get_arch", "input_specs"]
