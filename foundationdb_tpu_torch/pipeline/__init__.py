"""The resolver pipeline of the port: several batches in flight, budget-driven
batch sizing and conflict-aware scheduling."""
from .resolver_pipeline import BudgetBatcher, PendingResolve, ResolverPipeline
from .scheduler import ConflictScheduler, SchedConfig

__all__ = ["BudgetBatcher", "ConflictScheduler", "PendingResolve", "ResolverPipeline",
           "SchedConfig"]
