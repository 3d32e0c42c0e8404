"""K4's (``fused_search_kernel``) share of its roofline in the traced
sub-window of a ``get_batch`` cell: ``k4_roofline``'s reading, every row a
get, its bytes from ``litsbench.roofline.k4_bytes``.  None when the trace
shows no K4."""
import importlib.util
from pathlib import Path

_path = Path(__file__).with_name("k4_roofline.py")
_spec = importlib.util.spec_from_file_location("bench_metric_k4_roofline", _path)
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)


def read(run):
    return _mod.read(run)
