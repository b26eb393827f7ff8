"""The resolver pipeline of the port: several batches in flight, budget-driven
batch sizing and conflict-aware scheduling.

  * ResolverPipeline — wall-clock engine pipeline: host packing (inline or
    executor) overlapped with the engine's async dispatch, results forced
    in commit-version order.
  * PipelineConfig / PipelinedResolverService — the sim resolver role's
    virtual-time twin: the same window and stage structure, with measured
    pack and device times injected as delays (server/resolver.py drains its
    queue through it instead of blocking per batch).
  * latency_harness (imported lazily: it pulls in the whole sim cluster):
    open-loop arrivals through the static sim cluster, reporting
    client-observed commit-latency percentiles and sustained throughput.
"""
from .resolver_pipeline import BudgetBatcher, PendingResolve, ResolverPipeline
from .scheduler import ConflictScheduler, SchedConfig
from .service import PipelineConfig, PipelinedResolverService

__all__ = ["BudgetBatcher", "ConflictScheduler", "PendingResolve", "PipelineConfig",
           "PipelinedResolverService", "ResolverPipeline", "SchedConfig"]


def __getattr__(name):
    if name in ("latency_harness", "run_latency_under_load"):
        import importlib

        harness = importlib.import_module(".latency_harness", __name__)
        return harness if name == "latency_harness" else harness.run_latency_under_load
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
