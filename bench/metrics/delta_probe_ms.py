"""Host ms a window batch in the delta buffer's probe
(``tensor_index._delta_lookup``, span ``lits.ti.delta_probe``): the query
hashes and ``delta_probes`` open-addressing steps, launched even where the
delta is empty."""
from litsbench import program_spans


def read(run):
    return program_spans.per_batch_ms(run, "lits.ti.delta_probe")
