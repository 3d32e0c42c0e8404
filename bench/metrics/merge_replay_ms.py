"""Host ms a window merge in the replay of the delta into the host builder
(span ``lits.merge.replay``: ``delete_many``/``insert_many`` with their
height-bound folds); None without a merge in the window."""
from litsbench import program_spans


def read(run):
    return program_spans.per_merge_ms(run, "lits.merge.replay")
