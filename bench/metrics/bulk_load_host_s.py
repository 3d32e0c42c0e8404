"""Host seconds of the builder's bulk load outside the kernels' wrappers:
the self time of ``LITSBuilder.bulkload`` (span ``lits.build.bulkload``)
in the set-up's ``StringIndex.bulk_load`` call (the last
``lits.index.bulk_load`` record before the window)."""
from litsbench import program_spans


def read(run):
    rec = program_spans.setup_call(run, "lits.index.bulk_load")
    if rec is None or "lits.build.bulkload" not in rec["spans"]:
        return None
    return rec["spans"]["lits.build.bulkload"][2]
