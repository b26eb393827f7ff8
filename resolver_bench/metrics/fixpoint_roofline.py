"""fixpoint_roofline: the commit fixpoint kernel's share of its roofline,
%: the mean bound a batch (bound.py, one round over the valid rows the
harness's traffic puts in the chunk) over the mean time of a
commit_fixpoint_kernel launch in the traced window (torch.profiler). It
reads cells whose batches are one chunk each, one launch a batch: with
launches and batches more than 2% apart it reads nothing. The means stand
when a trace loses a few kernel events."""
import statistics

KERNEL = "commit_fixpoint_kernel"


def read(run):
    if run.device is None or not run.fixpoint_bound_ms:
        return None
    seconds, n = run.device.kernel_s(KERNEL, exclude="stacked")
    if seconds <= 0 or abs(n - len(run.fixpoint_bound_ms)) > 0.02 * len(run.fixpoint_bound_ms):
        return None
    return 100.0 * statistics.fmean(run.fixpoint_bound_ms) / (seconds * 1e3 / n)
