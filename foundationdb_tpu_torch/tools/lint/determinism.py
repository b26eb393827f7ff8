"""Rule `determinism`: wall clocks and unseeded entropy in sim packages.

Port of ``foundationdb_tpu/tools/lint/determinism.py``, package-neutral:
the same findings and messages over the port's tree and its own
registries.

Front-runs: the simulator's replay-from-seed guarantee and journal /
abort-set parity (a failing campaign must replay exactly from its seed —
one `time.time()` in a sim-deterministic package and the trace diverges
between runs, so the quarantine dump can never be reproduced).

Flags, inside the policy's sim-deterministic packages:

- any reference (call OR stored function value) to ``time.time`` /
  ``time.monotonic`` / ``os.urandom`` — sim time comes from the
  scheduler, entropy from ``core/rng.py`` DeterministicRandom;
- any use of the stdlib ``random`` module (``core/rng.py`` is the one
  sanctioned wrapper, exempt by policy);
- iteration over a set (set literal / ``set()`` / ``frozenset()`` / set
  comprehension) in a function that also emits through a trace or wire
  sink — str/bytes set order is PYTHONHASHSEED-dependent, so the emitted
  order differs between OS processes even under the same sim seed.  Wrap
  in ``sorted(...)``.

``time.perf_counter`` is deliberately allowed: duration measurement does
not feed trace/wire payloads, and the perf harnesses depend on it.
"""
from __future__ import annotations

import ast
from typing import Iterable, List

from .core import Checker, FileCtx, Finding, RulePolicy


def _is_set_expr(e: ast.AST) -> bool:
    if isinstance(e, (ast.Set, ast.SetComp)):
        return True
    return (isinstance(e, ast.Call) and isinstance(e.func, ast.Name)
            and e.func.id in ("set", "frozenset"))


class DeterminismChecker(Checker):
    rule = "determinism"
    description = "wall clocks / unseeded entropy / unordered iteration in sim packages"
    fronts = "seed-replay parity (journal replay bit-identical; quarantine reproducible)"

    def check(self, ctx: FileCtx, policy: RulePolicy) -> Iterable[Finding]:
        opts = policy.options
        banned = set(opts.get("banned",
                              ("time.time", "time.monotonic", "os.urandom")))
        banned_mods = tuple(opts.get("banned_modules", ("random",)))
        sinks = set(opts.get("sinks", ()))
        out: List[Finding] = []

        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.Attribute, ast.Name)):
                continue
            # only the OUTERMOST attribute of a chain reports (time.monotonic
            # contains a Name("time") child that must not double-fire)
            if isinstance(ctx.parents.get(node), ast.Attribute):
                continue
            q = ctx.qual_of(node)
            if q is None:
                continue
            if q in banned:
                out.append(Finding(
                    self.rule, ctx.rel, node.lineno,
                    f"`{q}` in a sim-deterministic package: sim time comes "
                    "from the scheduler's virtual clock; wall-clock reads "
                    "diverge between replays of the same seed "
                    "(docs/static_analysis.md#determinism)"))
            elif q.split(".")[0] in banned_mods:
                out.append(Finding(
                    self.rule, ctx.rel, node.lineno,
                    f"stdlib `{q}` in a sim-deterministic package: draw "
                    "from core/rng.py DeterministicRandom so a failing "
                    "run replays from its seed "
                    "(docs/static_analysis.md#determinism)"))

        # unordered iteration feeding a trace/wire sink
        for fn in ctx.functions:
            fn_calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)]
            has_sink = any(
                (isinstance(c.func, ast.Name) and c.func.id in sinks)
                or (isinstance(c.func, ast.Attribute) and c.func.attr in sinks)
                for c in fn_calls)
            if not has_sink:
                continue
            iters: List[ast.AST] = []
            for n in ast.walk(fn):
                if isinstance(n, ast.For):
                    iters.append(n.iter)
                elif isinstance(n, (ast.ListComp, ast.SetComp, ast.DictComp,
                                    ast.GeneratorExp)):
                    iters.extend(g.iter for g in n.generators)
            for it in iters:
                if _is_set_expr(it):
                    out.append(Finding(
                        self.rule, ctx.rel, it.lineno,
                        "iteration over a set in a function that feeds a "
                        "trace/wire sink: str/bytes set order is "
                        "PYTHONHASHSEED-dependent, so emitted order differs "
                        "across OS processes under the same sim seed — wrap "
                        "in sorted(...) "
                        "(docs/static_analysis.md#determinism)"))
        return out
