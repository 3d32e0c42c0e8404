"""Host ms a window batch in ``tensor_index.lookup_values`` (span
``lits.ti.lookup_values``): the found entries' 64-bit values gathered as
two int32 halves, from the base or the delta."""
from litsbench import program_spans


def read(run):
    return program_spans.per_batch_ms(run, "lits.ti.lookup_values")
