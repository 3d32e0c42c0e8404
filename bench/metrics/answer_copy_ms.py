"""Host ms a window batch in the device-to-host copies of answers (span
``lits.facade.answer_copy``: the write masks, a ``get_batch``'s arrays,
each scan group's windows).  A copy waits for the device work queued
before it, so this holds the device's time on the batch's path too."""
from litsbench import program_spans


def read(run):
    return program_spans.per_batch_ms(run, "lits.facade.answer_copy")
