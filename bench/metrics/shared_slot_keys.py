"""Keys the set-up's bulk load placed in a slot that another run of keys of
the same model node also takes: the counter
``lits.build.bulkload.shared_slot_keys`` of the set-up's
``StringIndex.bulk_load`` call (the last ``lits.index.bulk_load`` record
before the window).  With the builder's ``exact_slots`` mode these are the
keys it grouped into one child a slot; without it, the keys the reference's
placement can lose.  None on a program without the counter."""
from litsbench import program_spans

COUNTER = "lits.build.bulkload.shared_slot_keys"


def read(run):
    rec = program_spans.setup_call(run, "lits.index.bulk_load")
    return None if rec is None else rec["counts"].get(COUNTER)
