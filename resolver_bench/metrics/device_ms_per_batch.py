"""device_ms_per_batch: the card's kernel time in the traced window
(torch.profiler), over the batches the window resolved: every window
batch's kernels run inside the trace, which closes after the last."""


def read(run):
    if run.device is None or not len(run.batch_ms):
        return None
    seconds, n = run.device.kernel_s()
    return seconds * 1e3 / len(run.batch_ms) if n else None
