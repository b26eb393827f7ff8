"""Rule `knob-drift`: three-way knob / code / docs reconciliation.

Port of ``foundationdb_tpu/tools/lint/knob_drift.py``, package-neutral:
the same findings and messages over the port's tree and its own
registries. The documented defaults are the reference's ``docs/*.md``
knob tables: the port's family knobs are held to them, and port-only
knobs stay out of the families. The port's extra consumers are its own
tests (``tests/test_torch_*.py``) and ``chip_smoke.py``: ``extra_refs``
takes files, directories and glob patterns.

Front-runs: the operator contract.  Every ``resolver_*`` / ``real_*`` /
``chaos_*`` / ``trace_*`` / ``watchdog_*`` knob is a tuning surface the
docs advertise and campaigns override by name — a knob defined but never referenced is dead
weight, a knob without a doc row is an invisible tuning surface, a doc
row for a deleted knob teaches operators a ``--knob`` override that
raises ``KeyError``, and a drifted documented default misprices every
capacity estimate made from the docs.

The checker diffs three sources, each direction reported:

- **defined**: ``k.init("name", default)`` calls in ``core/knobs.py``
  (AST, no import — the linter never pulls in torch or jax);
- **referenced**: attribute reads ``SERVER_KNOBS.name`` (AST over every
  scanned file) plus quoted ``"name"`` literals anywhere in the package,
  and the policy's ``extra_refs`` (set_knob / campaign overrides count);
- **documented**: ``| `name` | default | ...`` table rows in
  ``docs/*.md``, with the documented default compared against the
  defined one (unit suffixes and backticks are normalized away; prose
  cells that don't parse as a literal are left alone).

This rule ships with an EMPTY baseline: drift is always fixed in the PR
that introduces it, never grandfathered.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from .core import PACKAGE, Checker, FileCtx, Finding, RulePolicy

_ROW_RE = re.compile(r"^\s*\|\s*`([a-z][a-z0-9_]*)`\s*\|\s*([^|]*)\|")
_KNOB_REGISTRY_NAMES = ("SERVER_KNOBS", "CLIENT_KNOBS", "FLOW_KNOBS")


def _parse_knob_defs(path: Path) -> Dict[str, Tuple[int, Any]]:
    """name -> (lineno, default literal or None) from k.init(...) calls."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out: Dict[str, Tuple[int, Any]] = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "init" and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            default: Any = None
            if len(node.args) > 1:
                try:
                    default = ast.literal_eval(node.args[1])
                except (ValueError, SyntaxError):
                    default = None   # computed default: skip value compare
            out[node.args[0].value] = (node.lineno, default)
    return out


def _norm_default(cell: str) -> Optional[str]:
    """Normalize a doc-table default cell to a comparable literal string.
    Returns None when the cell is prose (no compare)."""
    s = cell.strip().strip("`").strip()
    s = re.sub(r"\s*(s|ms|bytes|txns)\s*$", "", s)   # unit suffixes
    s = s.strip()
    if s in ('""', "''", "(empty)", "empty"):
        return ""
    if re.fullmatch(r"-?\d+(\.\d+)?(e-?\d+)?", s):
        return s
    if re.fullmatch(r'"[^"]*"', s):
        return s[1:-1]
    return None


def _defaults_equal(doc: str, actual: Any) -> bool:
    if isinstance(actual, bool):
        return doc.lower() == str(actual).lower()
    if isinstance(actual, (int, float)):
        try:
            return float(doc) == float(actual)
        except ValueError:
            return False
    return doc == str(actual)


class KnobDriftChecker(Checker):
    rule = "knob-drift"
    description = "resolver_*/real_*/chaos_*/trace_* knob vs code vs docs parity"
    fronts = "--knob override surface + documented capacity model"
    repo_level = True

    def check_repo(self, root: Path, ctxs: Sequence[FileCtx],
                   policy: RulePolicy) -> Iterable[Finding]:
        opts = policy.options
        families = tuple(opts.get("families",
                                  ("resolver_", "real_", "chaos_", "trace_",
                                   "watchdog_")))
        knobs_rel = opts.get("knobs_file", PACKAGE + "/core/knobs.py")
        knobs_path = root / knobs_rel
        docs_dir = root / opts.get("docs_dir", "docs")
        if not knobs_path.exists():
            return []        # fixture tree without a registry: nothing to diff

        defs = _parse_knob_defs(knobs_path)
        fam_defs = {k: v for k, v in defs.items() if k.startswith(families)}
        out: List[Finding] = []

        # -- referenced: registry attribute reads (AST) + quoted literals ----
        referenced: set = set()
        attr_refs: List[Tuple[str, int, str]] = []   # (rel, line, knob)
        for ctx in ctxs:
            if ctx.rel == knobs_rel:
                continue
            # registry names reachable in this file: the canonical three,
            # local aliases (`k = SERVER_KNOBS; k.resolver_...` is the
            # fault/resilient.py idiom) and import aliases (`from
            # ..core.knobs import SERVER_KNOBS as k`, pipeline/scheduler.py)
            reg_names = set(_KNOB_REGISTRY_NAMES)
            for node in ast.walk(ctx.tree):
                if (isinstance(node, ast.Assign)
                        and isinstance(node.value, ast.Name)
                        and node.value.id in _KNOB_REGISTRY_NAMES):
                    reg_names.update(t.id for t in node.targets
                                     if isinstance(t, ast.Name))
                elif isinstance(node, ast.ImportFrom):
                    reg_names.update(a.asname for a in node.names
                                     if a.asname
                                     and a.name in _KNOB_REGISTRY_NAMES)
            for node in ast.walk(ctx.tree):
                if (isinstance(node, ast.Attribute)
                        and isinstance(node.value, ast.Name)
                        and node.value.id in reg_names):
                    referenced.add(node.attr)
                    if node.attr.startswith(families):
                        attr_refs.append((ctx.rel, node.lineno, node.attr))
        sources = [c.source for c in ctxs if c.rel != knobs_rel]
        for extra in opts.get("extra_refs", ()):
            p = root / extra
            if any(ch in extra for ch in "*?["):
                sources.extend(q.read_text() for q in sorted(root.glob(extra))
                               if q.is_file())
            elif p.is_file():
                sources.append(p.read_text())
            elif p.is_dir():
                sources.extend(q.read_text() for q in sorted(p.rglob("*.py")))
        blob = "\n".join(sources)
        for name in fam_defs:
            if name in referenced:
                continue
            if re.search(r"""['"]%s['"]""" % re.escape(name), blob):
                referenced.add(name)

        # -- documented: doc-table rows -------------------------------------
        # Only rows inside a KNOB table count — a table whose header's
        # first cell reads `knob`. Other tables legitimately lead with
        # family-prefixed names that are NOT knobs (the operations.md
        # alert runbook names watchdog rules like `reshard_stalled`);
        # counting those would both fabricate doc rows for undefined
        # knobs and mask genuinely undocumented ones.
        doc_rows: Dict[str, List[Tuple[str, int, str]]] = {}
        for md in sorted(docs_dir.glob("*.md")) if docs_dir.exists() else []:
            rel = md.relative_to(root).as_posix()
            in_knob_table = False
            for i, line in enumerate(md.read_text().splitlines(), 1):
                if not line.lstrip().startswith("|"):
                    in_knob_table = False
                    continue
                cells = [c.strip().strip("`").lower()
                         for c in line.strip().strip("|").split("|")]
                if cells and cells[0] == "knob":
                    in_knob_table = True
                    continue
                if not in_knob_table:
                    continue
                m = _ROW_RE.match(line)
                if m and m.group(1).startswith(families):
                    doc_rows.setdefault(m.group(1), []).append(
                        (rel, i, m.group(2)))

        # -- the three-way diff ----------------------------------------------
        knobs_line = lambda name: fam_defs[name][0]
        for name in sorted(fam_defs):
            if name not in referenced:
                out.append(Finding(
                    self.rule, knobs_rel, knobs_line(name),
                    f"knob `{name}` is defined but never referenced by the "
                    "package, tests or bench — wire it or delete it "
                    "(docs/static_analysis.md#knob-drift)"))
            if name not in doc_rows:
                out.append(Finding(
                    self.rule, knobs_rel, knobs_line(name),
                    f"knob `{name}` has no doc-table row in docs/*.md — "
                    "operators can't discover the tuning surface "
                    "(docs/static_analysis.md#knob-drift)"))
        for name, rows in sorted(doc_rows.items()):
            if name not in defs:
                rel, line, _cell = rows[0]
                out.append(Finding(
                    self.rule, rel, line,
                    f"doc row documents knob `{name}` which core/knobs.py "
                    "does not define — a `--knob` override of it raises "
                    "KeyError (docs/static_analysis.md#knob-drift)"))
                continue
            actual = defs[name][1]
            if actual is None:
                continue
            for rel, line, cell in rows:
                doc_default = _norm_default(cell)
                if doc_default is None:
                    continue
                if not _defaults_equal(doc_default, actual):
                    out.append(Finding(
                        self.rule, rel, line,
                        f"doc row for `{name}` says default `{doc_default}` "
                        f"but core/knobs.py defines `{actual}` "
                        "(docs/static_analysis.md#knob-drift)"))
        for rel, line, name in attr_refs:
            if name not in defs:
                out.append(Finding(
                    self.rule, rel, line,
                    f"reference to undefined knob `{name}` — this raises "
                    "AttributeError at runtime "
                    "(docs/static_analysis.md#knob-drift)"))
        return out
