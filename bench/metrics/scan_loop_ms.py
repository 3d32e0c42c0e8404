"""Host ms a window batch in ``_scan_group``'s per-row, per-entry loop
(span ``lits.facade.scan_entries``, the program's own): building each
scan's ``(key, value)`` tuples from the answers copied to the host."""
from litsbench import program_spans


def read(run):
    return program_spans.per_batch_ms(run, "lits.facade.scan_entries")
