"""batch_p99_ms: the 99th percentile, over every batch due in the window,
of the time from when it was due (closed loop: the call to submit) to its
verdicts in hand (host clock)."""
import numpy as np


def read(run):
    if len(run.batch_ms) == 0:
        return None
    return float(np.percentile(run.batch_ms, 99))
