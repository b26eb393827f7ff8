"""Rule `blackbox-registry`: black-box event kinds must be registered.

Port of ``foundationdb_tpu/tools/lint/blackbox_registry.py``, package-neutral:
the same findings and messages over the port's tree and its own
registries.

Front-runs: the CLOSED journal format of core/blackbox.py.  The
forensics engine (`tools/forensics.py strict_parse`) rejects any event
whose kind is missing from ``BLACKBOX_EVENT_REGISTRY`` or whose payload
type disagrees with it — so an unregistered ``record_event("my_kind",
...)`` site ships a journal that every `make forensics-smoke` run and
`cli blackbox` strict parse refuses, and old journals become unreadable
the moment a kind silently changes shape.  This rule catches the drift
before it merges, exactly like `span-registry` does for span segments.

Flags: calls to the producer entry points (``record_event``, plus the
journal's own ``record`` method inside the registry file) whose kind
argument is a string constant (conditional expressions check both arms)
not present as a key of ``BLACKBOX_EVENT_REGISTRY``.  The registry is
read from core/blackbox.py by AST — the linter never imports the
package (no torch, no jax).  Dynamically-built kinds are outside the rule; use a
constant.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Set

from .core import PACKAGE, Checker, FileCtx, Finding, RulePolicy
from .span_registry import _const_strings


def _parse_registry_keys(path: Path, name: str) -> Optional[Set[str]]:
    """The string keys of the BLACKBOX_EVENT_REGISTRY dict literal, by
    AST (values are class names — never evaluated)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if (isinstance(t, ast.Name) and t.id == name
                        and isinstance(node.value, ast.Dict)):
                    keys = set()
                    for k in node.value.keys:
                        if not (isinstance(k, ast.Constant)
                                and isinstance(k.value, str)):
                            return None
                        keys.add(k.value)
                    return keys
    return None


class BlackboxRegistryChecker(Checker):
    rule = "blackbox-registry"
    description = "black-box event kinds outside BLACKBOX_EVENT_REGISTRY"
    fronts = "closed journal schema (strict_parse / forensics-smoke gate)"
    repo_level = True

    def check_repo(self, root: Path, ctxs: Sequence[FileCtx],
                   policy: RulePolicy) -> Iterable[Finding]:
        opts = policy.options
        reg_rel = opts.get("registry_file",
                           PACKAGE + "/core/blackbox.py")
        reg_path = root / reg_rel
        if not reg_path.exists():
            return []        # fixture tree without the journal
        reg_name = opts.get("registry_name", "BLACKBOX_EVENT_REGISTRY")
        kinds = _parse_registry_keys(reg_path, reg_name)
        if kinds is None:
            return [Finding(
                self.rule, reg_rel, 1,
                f"{reg_name} is no longer a dict literal with string "
                "keys — the blackbox-registry rule cannot read it "
                "(docs/static_analysis.md#blackbox-registry)")]
        record_calls = set(opts.get("record_calls", ("record_event",)))
        local_calls = set(opts.get("local_record_calls", ("record",)))
        out: List[Finding] = []
        for ctx in ctxs:
            if not policy.applies(ctx.rel):
                continue
            calls = set(record_calls)
            if ctx.rel == reg_rel:
                calls |= local_calls
            for node in ast.walk(ctx.tree):
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                f = node.func
                fname = f.attr if isinstance(f, ast.Attribute) else (
                    f.id if isinstance(f, ast.Name) else None)
                if fname not in calls:
                    continue
                for s in _const_strings(node.args[0]):
                    if s not in kinds:
                        out.append(Finding(
                            self.rule, ctx.rel, node.lineno,
                            f"black-box event kind `{s}` is not a key of "
                            f"{reg_name} — strict_parse rejects the "
                            "journal and forensics cannot decode it; "
                            f"register the kind (and its record type) in "
                            f"{reg_rel} "
                            "(docs/static_analysis.md#blackbox-registry)"))
        return out
