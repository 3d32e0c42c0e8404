"""Host ms a window batch of ``get_batch`` in ``tensor_index.pad_queries``
(span ``lits.ti.pad_queries``): the batch's keys into zero-padded rows, a
key at a time."""
from litsbench import program_spans


def read(run):
    return program_spans.per_batch_ms(run, "lits.ti.pad_queries")
