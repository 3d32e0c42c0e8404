"""Share of the traced sub-window of a ``get_batch`` cell in which no
operation ran on the device: ``device_idle_pct``'s reading."""
import importlib.util
from pathlib import Path

_path = Path(__file__).with_name("device_idle_pct.py")
_spec = importlib.util.spec_from_file_location("bench_metric_device_idle_pct", _path)
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)


def read(run):
    return _mod.read(run)
