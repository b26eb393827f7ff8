"""force_ms: the program's span engine.force (the wait on the batch's
outputs, the heat merge, the verdict decode), mean a batch over the traced
window."""
import statistics


def read(run):
    spans = run.spans_ms.get("engine.force")
    return statistics.fmean(spans) if spans else None
