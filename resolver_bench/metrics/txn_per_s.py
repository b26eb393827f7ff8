"""txn_per_s: transactions given a verdict inside the window, over the
window's seconds (host clock)."""


def read(run):
    return run.txns_done / run.window_s
