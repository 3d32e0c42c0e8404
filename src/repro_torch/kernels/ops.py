"""Public wrappers for the hand-written CUDA kernels.

Each takes tensors and dispatches on their device: a CUDA tensor launches
the kernel (or the wrapper raises), a CPU tensor runs the plain PyTorch
version.  Nothing falls back from one to the other.

* :func:`hpt_cdf`      — batched GetCDF: K2 (``variant="gather"``,
  ``csrc/hpt_cdf.cu``) or K7 (``variant="onehot"``, ``csrc/hpt_cdf_onehot.cu``)
* :func:`hpt_locate`   — K1, GetCDF + model + clamp (``csrc/hpt_locate.cu``)
* :func:`cnode_probe`  — K3, h-pointer probe (``csrc/cnode_probe.cu``)
* :func:`fused_search` — K4, the whole point lookup (``csrc/traverse.cu``)
* :func:`fused_rank`   — K5, ordered rank (``csrc/rank.cu``)
* :func:`fused_scan`   — K6, delta-aware range scan (``csrc/scan.cu``)

:data:`LAUNCHES` counts the kernel launches of each wrapper.
"""
from ._build import LAUNCHES, build_all, reset_launches
from .cnode_probe import cnode_probe
from .hpt_cdf import hpt_cdf
from .hpt_locate import hpt_locate
from .rank import fused_rank
from .scan import fused_scan
from .traverse import fused_search

__all__ = ["LAUNCHES", "build_all", "reset_launches", "cnode_probe", "hpt_cdf",
           "hpt_locate", "fused_search", "fused_rank", "fused_scan"]
