"""Host ms a window merge in the refreeze: ``freeze``'s host layout (span
``lits.ti.freeze``) and the upload of its arrays (``lits.ti.upload``);
None without a merge in the window."""
from litsbench import program_spans


def read(run):
    return program_spans.per_merge_ms(run, "lits.ti.freeze", "lits.ti.upload")
