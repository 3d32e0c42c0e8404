"""Host seconds of ``StringIndex.bulk_load`` in set-up, ending in a
device synchronise."""


def read(run):
    return run["setup"]["bulk_load_s"]
