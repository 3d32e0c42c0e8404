"""Peak device memory allocated (``torch.cuda.max_memory_allocated``) from
process start through the window's first ``memory_batches`` batches (the
mix's; the whole window where it names none or the window ran fewer), in
MB of 10**6 bytes.  A fixed amount of work, so that a program that gets
through more batches, and so holds more inserted keys, in the window does
not read as one that needs more memory for the same work."""


def read(run):
    batches = run["window"]["batches"]
    if not batches:
        return None
    n = run.get("memory_batches") or len(batches)
    peak = batches[min(n, len(batches)) - 1]["peak"]
    return peak / 1e6 if peak else None
