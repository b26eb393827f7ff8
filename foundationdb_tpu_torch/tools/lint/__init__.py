"""fdbtpu-lint over the port: the AST invariant checker as the port's own
tool.

Port of ``foundationdb_tpu/tools/lint/``. Seven checkers over a shared
file-cache/policy core (core.py), each front-running a dynamic assertion
the runs otherwise only catch one seed at a time. Four are
package-neutral and port as they are, against the port's own registries;
three read the port's own mechanisms where the reference reads JAX's:

=================  ======================================================
rule               front-runs
=================  ======================================================
determinism        seed-replay parity (bit-identical journal replay)
host-sync          blocking_syncs == 0: no .item() / .cpu() of a *_dev
                   value / float()/bool()/int() of one / .synchronize()
                   outside drain points
donation           a captured graph owns its static buffers: ``state`` is
                   refilled with copy_, never rebound, and not read to the
                   host between a dispatch and its drain
recompile          zero steady-state captures: torch.cuda.graph /
                   capture_begin only in _capture / warmup, no
                   data-dependent shape into a static input
knob-drift         --knob override surface + the documented defaults
span-registry      telescoping latency sum identity (max_sum_err SLO)
blackbox-registry  closed black-box journal schema (strict_parse gate)
=================  ======================================================

    python -m foundationdb_tpu_torch.tools.lint [--json] [--rules a,b] [paths]

Pure AST: importing this package loads neither torch nor jax.
"""
from .blackbox_registry import BlackboxRegistryChecker
from .core import (DEFAULT_POLICY, Checker, FileCtx, Finding, LintResult,
                   RulePolicy, load_baseline, main, run_lint, write_baseline)
from .determinism import DeterminismChecker
from .donation import DonationChecker
from .host_sync import HostSyncChecker
from .knob_drift import KnobDriftChecker
from .recompile import RecompileChecker
from .span_registry import SpanRegistryChecker

#: the pluggable registry: construct once, shared by __main__, the cli
#: subcommand, chip_smoke and the tests. Adding a rule = one module + one
#: row here.
CHECKERS = (
    DeterminismChecker(),
    HostSyncChecker(),
    DonationChecker(),
    RecompileChecker(),
    KnobDriftChecker(),
    SpanRegistryChecker(),
    BlackboxRegistryChecker(),
)

__all__ = [
    "CHECKERS", "Checker", "DEFAULT_POLICY", "FileCtx", "Finding",
    "LintResult", "RulePolicy", "load_baseline", "main", "run_lint",
    "write_baseline",
]
