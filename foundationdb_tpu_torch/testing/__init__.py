"""Simulation test harness.

Port of ``foundationdb_tpu/testing/__init__.py``.

The analog of the reference's test stack (SURVEY.md §4): TestWorkload
classes (fdbserver/workloads/workloads.h:42-85) composed by declarative
specs, run against a simulated cluster with anti-quiescence fault injectors,
then checked after quiescence. Any failure replays exactly from its seed.
"""
from .workload import TestWorkload, WorkloadContext, run_spec, Spec

__all__ = ["TestWorkload", "WorkloadContext", "run_spec", "Spec"]
