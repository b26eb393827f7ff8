"""dispatch_host_ms: the harness's host clock around the engine's
columnar_dispatch (copies in, graph replay, copies out, an event), mean a
batch over the traced window."""
import statistics


def read(run):
    return statistics.fmean(run.dispatch_ms) if run.dispatch_ms else None
