"""The resolver pipeline of the port: several batches in flight, budget-driven
batch sizing and conflict-aware scheduling.

  * ResolverPipeline — wall-clock engine pipeline: host packing (inline or
    executor) overlapped with the engine's async dispatch, results forced
    in commit-version order.
  * PipelineConfig / PipelinedResolverService — the sim resolver role's
    virtual-time twin: the same window and stage structure, with measured
    pack and device times injected as delays (server/resolver.py drains its
    queue through it instead of blocking per batch).
"""
from .resolver_pipeline import BudgetBatcher, PendingResolve, ResolverPipeline
from .scheduler import ConflictScheduler, SchedConfig
from .service import PipelineConfig, PipelinedResolverService

__all__ = ["BudgetBatcher", "ConflictScheduler", "PendingResolve", "PipelineConfig",
           "PipelinedResolverService", "ResolverPipeline", "SchedConfig"]
