"""The resolver pipeline of the port: several batches in flight."""
from .resolver_pipeline import PendingResolve, ResolverPipeline

__all__ = ["PendingResolve", "ResolverPipeline"]
