"""pipeline_wait_ms: the program's span pipeline.force (the pipeline's
caller blocked on a dispatched batch), mean a batch over the traced
window."""
import statistics


def read(run):
    spans = run.spans_ms.get("pipeline.force")
    return statistics.fmean(spans) if spans else None
