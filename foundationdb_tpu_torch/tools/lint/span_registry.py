"""Rule `span-registry`: segment names at Span sites must be registered.

Port of ``foundationdb_tpu/tools/lint/span_registry.py``, package-neutral:
the same findings and messages over the port's tree and its own
registries.

Front-runs: the telescoping sum identity of the latency attribution
(pipeline/latency_harness.py ``ATTRIBUTION_SEGMENTS``: named segments sum
EXACTLY to client-observed latency, machine-asserted by
tests/test_trace_spans.py and the chaos campaigns' ``max_sum_err``).  A
new ``span_event("resolver.<seg>", ...)`` whose segment is not in the
registry silently lands in the ``resolve_overhead`` residual — the
identity still "holds" numerically while the attribution quietly stops
naming where the time went.

Flags: span sites (``span`` / ``span_event`` / ``Span`` calls) whose name
argument is a string constant (conditional expressions check both arms)
with a policy prefix (``resolver.`` / ``engine.`` / ``pipeline.``) whose
final dotted component is not in ``ATTRIBUTION_SEGMENTS``.  The registry
is read from the latency harness by AST — the linter never imports the
package (no torch, no jax).  Dynamically-built names (f-strings, concatenation)
are outside the rule; give such sites an unprefixed process name or a
constant.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Tuple

from .core import PACKAGE, Checker, FileCtx, Finding, RulePolicy


def _parse_registry(path: Path, name: str) -> Optional[Tuple[str, ...]]:
    """The ATTRIBUTION_SEGMENTS tuple, by AST (no package import)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    try:
                        val = ast.literal_eval(node.value)
                    except (ValueError, SyntaxError):
                        return None
                    if isinstance(val, (tuple, list)):
                        return tuple(str(v) for v in val)
    return None


def _const_strings(e: ast.AST) -> Iterable[str]:
    """String constants an expression can evaluate to: plain constants and
    both arms of conditional expressions.  Dynamic names yield nothing."""
    if isinstance(e, ast.Constant) and isinstance(e.value, str):
        yield e.value
    elif isinstance(e, ast.IfExp):
        yield from _const_strings(e.body)
        yield from _const_strings(e.orelse)


class SpanRegistryChecker(Checker):
    rule = "span-registry"
    description = "Span segment names outside ATTRIBUTION_SEGMENTS"
    fronts = "telescoping latency sum identity (max_sum_err SLO)"
    repo_level = True

    def check_repo(self, root: Path, ctxs: Sequence[FileCtx],
                   policy: RulePolicy) -> Iterable[Finding]:
        opts = policy.options
        reg_path = root / opts.get(
            "registry_file", PACKAGE + "/pipeline/latency_harness.py")
        if not reg_path.exists():
            return []        # fixture tree without the harness
        registry = _parse_registry(
            reg_path, opts.get("registry_name", "ATTRIBUTION_SEGMENTS"))
        if registry is None:
            return [Finding(
                self.rule,
                reg_path.relative_to(root).as_posix(), 1,
                "ATTRIBUTION_SEGMENTS is no longer a literal tuple — the "
                "span-registry rule cannot read it "
                "(docs/static_analysis.md#span-registry)")]
        segs = set(registry)
        prefixes = tuple(opts.get("prefixes",
                                  ("resolver.", "engine.", "pipeline.")))
        #: policed prefix -> (segment set, registry name, registry file):
        #: the commit-waterfall prefixes share ATTRIBUTION_SEGMENTS; extra
        #: registries (reshard.* protocol arcs) bring their own tuple
        registries: List[Tuple[Tuple[str, ...], set, str, str]] = [
            (prefixes, segs, opts.get("registry_name",
                                      "ATTRIBUTION_SEGMENTS"),
             reg_path.relative_to(root).as_posix()),
        ]
        for pfx, rel_file, name in opts.get("extra_registries", ()):
            p = root / rel_file
            if not p.exists():
                continue
            extra = _parse_registry(p, name)
            if extra is None:
                return [Finding(
                    self.rule, rel_file, 1,
                    f"{name} is no longer a literal tuple — the "
                    "span-registry rule cannot read it "
                    "(docs/static_analysis.md#span-registry)")]
            registries.append(((pfx,), set(extra), name, rel_file))
        span_calls = set(opts.get("span_calls",
                                  ("span", "span_event", "Span", "subspan")))
        out: List[Finding] = []
        for ctx in ctxs:
            if not policy.applies(ctx.rel):
                continue
            for node in ast.walk(ctx.tree):
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                f = node.func
                fname = f.attr if isinstance(f, ast.Attribute) else (
                    f.id if isinstance(f, ast.Name) else None)
                if fname not in span_calls:
                    continue
                for s in _const_strings(node.args[0]):
                    if "." not in s:
                        continue
                    for pfxs, reg_segs, reg_name, reg_rel in registries:
                        if not s.startswith(pfxs):
                            continue
                        seg = s.rsplit(".", 1)[1]
                        if seg not in reg_segs:
                            out.append(Finding(
                                self.rule, ctx.rel, node.lineno,
                                f"span segment `{s}` is not in "
                                f"{reg_name} — its time lands in an "
                                "unnamed residual and the attribution "
                                "silently stops naming it; register the "
                                f"segment in {reg_rel} "
                                "(docs/static_analysis.md#span-registry)"))
                        break
        return out
