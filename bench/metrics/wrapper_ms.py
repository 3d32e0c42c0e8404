"""Host ms a window batch in the custom kernels' wrappers (every span
``lits.kernels.<name>``: argument checks, tables and the launch; on a CPU
device the plain versions)."""
from litsbench import program_spans


def read(run):
    recs = program_spans.window_calls(run)
    if recs is None:
        return None
    secs = sum(v[1] for r in recs for k, v in r["spans"].items()
               if k.startswith("lits.kernels."))
    return 1e3 * secs / len(recs)
