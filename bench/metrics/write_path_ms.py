"""Host ms a window batch in the write path's own work: the self time of
``_mutate_batch`` (span ``lits.ti.mutate``), the host's per-op torch
dispatch without K4's wrapper (the base walk, a child span)."""
from litsbench import program_spans


def read(run):
    return program_spans.per_batch_ms(run, "lits.ti.mutate", col=2)
