"""device_idle_pct: 100 x (1 - the cards' busy seconds, averaged over the
cards a run uses, over the traced window's length); a card is busy while
a kernel, copy or memset of it runs (torch.profiler)."""


def read(run):
    if run.device is None or not run.device.ops:
        return None
    return 100.0 * (1.0 - run.device.busy_s() / run.device.window_s)
