"""prefill_s: resolving the prefill's batches (one write life, closed
loop) through the window's entry, a share of setup_s (host clock)."""


def read(run):
    return run.prefill_s
