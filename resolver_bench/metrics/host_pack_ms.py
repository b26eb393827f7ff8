"""host_pack_ms: the program's span engine.host_pack (columnar_pack, on the
pipeline's pack thread), mean a batch over the traced window."""
import statistics


def read(run):
    spans = run.spans_ms.get("engine.host_pack")
    return statistics.fmean(spans) if spans else None
