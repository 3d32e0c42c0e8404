"""Mean host ms of the window's batches that merged the delta
(``BatchResult.merged``); none without such a batch."""


def read(run):
    t = [b["t1"] - b["t_call"] for b in run["window"]["batches"] if b["merged"]]
    return 1e3 * sum(t) / len(t) if t else None
