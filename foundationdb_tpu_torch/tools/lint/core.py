"""fdbtpu-lint core: file cache, policy table, suppressions, baseline, report.

Port of ``foundationdb_tpu/tools/lint/core.py``: the same framework over
the port's own tree. The linter is pure AST: it imports neither torch nor
jax, and nothing of either package; it reads the port's registries
(``ATTRIBUTION_SEGMENTS``, ``BLACKBOX_EVENT_REGISTRY``, the knobs) by
parsing them, so it runs wherever Python does:

    python -m foundationdb_tpu_torch.tools.lint            # the port's tree
    python -m foundationdb_tpu_torch.tools.lint --json     # machine-readable
    python -m foundationdb_tpu_torch.tools.cli lint        # same, via the cli

Framework pieces, shared by every checker:

- ``FileCtx``  — parse-once cache per file: AST + parent links, import
  alias resolution (``import time as _t`` still resolves ``_t.monotonic``),
  enclosing-function index, suppression + drain-point comment maps.
- ``RulePolicy`` — the per-package policy table: which packages a rule
  applies to, per-module exemptions, and rule options (drain names,
  static-buffer names, capture functions, knob families, ...). ``real/``
  and ``tools/`` are exempt from sim-determinism by policy.
- inline suppressions — ``# fdbtpu-lint: allow[rule] reason`` on the
  flagged line (or the line above), the reference's grammar, so one
  grammar serves both trees. The reason string is REQUIRED; a bare allow
  is itself a finding (rule ``suppression``).
- ``tools/lint/baseline.json`` — the port's own baseline of grandfathered
  findings keyed by (rule, path, content fingerprint), line-number free.
  Stale entries (the finding is gone) FAIL the run: the baseline can only
  shrink or hold (tests/test_torch_lint.py pins the ceiling). The root
  ``lint_baseline.json`` belongs to the reference and is never read here.

Report format and exit codes are the reference's: 0 clean, 1 on a new
finding or a stale baseline entry, 2 on a bad path or rule name.
"""
from __future__ import annotations

import argparse
import ast
import hashlib
import json
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Set, Tuple

REPO = Path(__file__).resolve().parents[3]
#: the scanned package, relative to the lint root
PACKAGE = "foundationdb_tpu_torch"
#: the port's baseline, relative to the lint root
BASELINE_REL = PACKAGE + "/tools/lint/baseline.json"

#: inline annotation grammar.  `allow[rule,rule2] reason...` suppresses the
#: named rules on the annotated line (same line, or a standalone comment on
#: the line above); `drain-point ...` marks the NEXT def as a sanctioned
#: device->host sync boundary (host_sync checker).
ANNOTATION_RE = re.compile(
    r"#\s*fdbtpu-lint:\s*(?P<kind>allow|drain-point)"
    r"(?:\[(?P<rules>[^\]]*)\])?\s*(?P<reason>.*?)\s*$")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # repo-relative, posix
    line: int
    message: str
    fingerprint: str = ""

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.fingerprint)

    def as_dict(self) -> Dict[str, Any]:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "fingerprint": self.fingerprint}


@dataclass(frozen=True)
class Suppression:
    line: int           # line the suppression is effective on
    rules: Tuple[str, ...]
    reason: str
    path: str = ""


@dataclass(frozen=True)
class RulePolicy:
    """Per-package policy for one rule.

    ``packages``: repo-relative directory prefixes the rule applies to
    (empty = everywhere under the scanned tree).  ``exempt``: file or
    directory prefixes carved back out (the sanctioned wrappers, e.g.
    ``core/rng.py`` for determinism).  ``options``: rule-specific tuning
    consumed by the checker (documented per rule in
    docs/static_analysis.md)."""
    packages: Tuple[str, ...] = ()
    exempt: Tuple[str, ...] = ()
    options: Mapping[str, Any] = field(default_factory=dict)

    def applies(self, rel: str) -> bool:
        if any(rel == e or rel.startswith(e.rstrip("/") + "/")
               for e in self.exempt):
            return False
        if not self.packages:
            return True
        return any(rel == p or rel.startswith(p.rstrip("/") + "/")
                   for p in self.packages)


class FileCtx:
    """Parse-once, share-everywhere cache for one source file.

    Built a single time per run; every checker reads the same AST, parent
    map, alias table and annotation maps (the shared visitor-dispatch core
    the checkers plug into)."""

    def __init__(self, root: Path, path: Path):
        self.root = root
        self.path = path
        self.rel = path.relative_to(root).as_posix()
        self.source = path.read_text()
        self.lines = self.source.splitlines()
        self.tree = ast.parse(self.source, filename=self.rel)
        #: child -> parent AST links (one walk, reused by every checker)
        self.parents: Dict[ast.AST, ast.AST] = {}
        #: node -> innermost enclosing function (def/async def) chain
        self._func_of: Dict[ast.AST, Optional[ast.AST]] = {}
        #: import alias -> dotted origin ("np" -> "numpy",
        #: "monotonic" -> "time.monotonic")
        self.imports: Dict[str, str] = {}
        self.functions: List[ast.AST] = []
        self._index()
        #: effective line -> Suppression
        self.suppressions: Dict[int, Suppression] = {}
        #: malformed allow annotations (missing reason/rule list)
        self.bad_suppressions: List[Finding] = []
        #: lines on which a drain-point annotation is effective
        self.drain_lines: Set[int] = set()
        self._scan_annotations()

    # -- indexes --------------------------------------------------------------
    def _index(self) -> None:
        stack: List[Tuple[ast.AST, Optional[ast.AST]]] = [(self.tree, None)]
        while stack:
            node, fn = stack.pop()
            self._func_of[node] = fn
            child_fn = fn
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions.append(node)
                child_fn = node
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
                stack.append((child, child_fn))
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.imports[a.asname or a.name.split(".")[0]] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                for a in node.names:
                    self.imports[a.asname or a.name] = f"{node.module}.{a.name}"

    def func_of(self, node: ast.AST) -> Optional[ast.AST]:
        """Innermost enclosing def of a node (None = module level)."""
        return self._func_of.get(node)

    def enclosing_funcs(self, node: ast.AST) -> List[ast.AST]:
        """Enclosing defs, innermost first."""
        out = []
        fn = self._func_of.get(node)
        while fn is not None:
            out.append(fn)
            fn = self._func_of.get(fn)
        return out

    def qual_of(self, node: ast.AST) -> Optional[str]:
        """Resolve an expression to the dotted name it references through
        this file's imports: Name("monotonic") -> "time.monotonic" under
        `from time import monotonic`; Attribute(_t, "monotonic") ->
        "time.monotonic" under `import time as _t`.  None when the root is
        not an imported module/name (locals, attributes of objects)."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        origin = self.imports.get(node.id)
        if origin is None:
            return None
        return ".".join([origin] + list(reversed(parts)))

    # -- annotations ----------------------------------------------------------
    def _scan_annotations(self) -> None:
        for i, raw in enumerate(self.lines, 1):
            if "#" not in raw or "fdbtpu-lint" not in raw:
                continue
            m = ANNOTATION_RE.search(raw)
            if m is None:
                continue
            standalone = raw.lstrip().startswith("#")
            effective = i
            if standalone:
                # a standalone annotation applies to the next code line,
                # skipping the rest of its own comment block
                effective = i + 1
                while effective <= len(self.lines) and (
                        not self.lines[effective - 1].strip()
                        or self.lines[effective - 1].lstrip().startswith("#")):
                    effective += 1
            if m.group("kind") == "drain-point":
                self.drain_lines.add(effective)
                continue
            rules = tuple(r.strip() for r in (m.group("rules") or "").split(",")
                          if r.strip())
            reason = m.group("reason").strip().lstrip("—-: ").strip()
            if not rules or not reason:
                self.bad_suppressions.append(Finding(
                    "suppression", self.rel, i,
                    "suppression requires an explicit rule list and a "
                    "non-empty reason: `# fdbtpu-lint: allow[rule] why this "
                    "is safe` (docs/static_analysis.md#suppressions)"))
                continue
            self.suppressions[effective] = Suppression(effective, rules, reason,
                                                       path=self.rel)

    def suppressed(self, rule: str, line: int) -> Optional[Suppression]:
        s = self.suppressions.get(line)
        if s is not None and (rule in s.rules or "*" in s.rules):
            return s
        return None

    def is_drain_function(self, fn: ast.AST, drain_names: Sequence[str]) -> bool:
        """A def is a drain point when annotated (`# fdbtpu-lint:
        drain-point` on the def line or the line above) or when its name is
        in the policy's sanctioned drain-name set (force / drain_loop)."""
        if fn.name in drain_names:
            return True
        return fn.lineno in self.drain_lines or (fn.lineno - 1) in self.drain_lines


class Checker:
    """One rule.  File-level checkers implement ``check(ctx, policy)``;
    repo-level checkers (cross-file diffs) set ``repo_level`` and implement
    ``check_repo(root, ctxs, policy)``.  Register instances in
    ``lint/__init__.py`` — the runner owns iteration, policy filtering,
    suppressions and the baseline."""

    rule: str = ""
    description: str = ""
    #: which dynamic assertion the rule front-runs (the report + docs show
    #: this so each rule's existence is justified by a measured invariant)
    fronts: str = ""
    repo_level: bool = False

    def check(self, ctx: FileCtx, policy: RulePolicy) -> Iterable[Finding]:
        return ()

    def check_repo(self, root: Path, ctxs: Sequence[FileCtx],
                   policy: RulePolicy) -> Iterable[Finding]:
        return ()


# -- default policy table -----------------------------------------------------
#: The per-package contract, rewritten against the port's paths. The four
#: package-neutral rules police what they police in the reference; the
#: torch rules (host-sync, recompile, donation) read the port's
#: mechanisms: stream syncs, graph captures and the static buffers a
#: captured graph owns.
_P = PACKAGE + "/"
DEFAULT_POLICY: Dict[str, RulePolicy] = {
    "determinism": RulePolicy(
        packages=(_P + "sim", _P + "server", _P + "pipeline", _P + "fault",
                  _P + "core"),
        # the sanctioned entropy wrapper: DeterministicRandom OWNS the
        # stdlib random import so nothing else needs one
        exempt=(_P + "core/rng.py",),
        options={
            "banned": ("time.time", "time.monotonic", "os.urandom"),
            "banned_modules": ("random",),
            # trace/wire sinks: set iteration is only flagged in functions
            # that also emit through one of these
            "sinks": ("TraceEvent", "span_event", "span", "pack", "encode",
                      "serialize", "send", "one_way", "request", "reply",
                      "write_frame", "log"),
        }),
    "host-sync": RulePolicy(
        packages=(_P + "ops", _P + "pipeline", _P + "parallel"),
        options={
            # functions sanctioned to sync by NAME (the engine force/drain
            # contract); anything else needs the drain-point annotation
            "drain_names": ("force", "drain_loop", "_drain_through"),
            # device-resident values follow the *_dev naming convention;
            # .cpu()/.numpy()/.tolist()/float()/bool()/int() of one of
            # these is a hidden blocking sync
            "device_suffixes": ("_dev", "_device"),
        }),
    "donation": RulePolicy(
        packages=(_P + "ops", _P + "pipeline", _P + "parallel"),
        options={
            # the static buffers a captured graph writes in place: a
            # captured graph holds their storage, so they are refilled
            # with copy_, never rebound
            "static": ("state",),
            # the functions that allocate them
            "owners": ("__init__",),
            # a call naming one of these, or a graph's .replay(), hands the
            # buffers to the card; one of the drains hands them back
            "triggers": ("dispatch", "enqueue"),
            "drains": ("force", "drain_loop", "_drain_through", "clear"),
        }),
    "recompile": RulePolicy(
        packages=(_P + "ops", _P + "pipeline", _P + "parallel"),
        options={
            # the functions sanctioned to capture a graph: a program's
            # one-time capture and the engines' warmup (every build is
            # counted by host_engine.CAPTURES)
            "capture_functions": ("_capture", "warmup"),
            # names a program's static input tensors are bound to
            # (`self.inputs[name][c].copy_(t)`, load_chunk)
            "static_inputs": ("inputs",),
            # local names program handles are bound to
            "entries": ("prog", "program", "compiled"),
        }),
    "knob-drift": RulePolicy(
        options={
            "families": ("resolver_", "real_", "chaos_", "trace_",
                         "watchdog_", "reshard_"),
            "knobs_file": _P + "core/knobs.py",
            # the documented defaults are the reference's docs: the rule
            # holds the port's family knobs to them
            "docs_dir": "docs",
            # the port's own consumers beyond the package tree (a glob or
            # a file): its tests and its chip check
            "extra_refs": ("tests/test_torch_*.py", "chip_smoke.py"),
        }),
    "span-registry": RulePolicy(
        packages=(PACKAGE,),
        # the Span primitive itself and the registry definition site
        exempt=(_P + "core/trace.py",),
        options={
            "prefixes": ("resolver.", "engine.", "pipeline."),
            "registry_file": _P + "pipeline/latency_harness.py",
            "registry_name": "ATTRIBUTION_SEGMENTS",
            # prefix -> own registry: these arcs run outside any one
            # transaction's latency, so outside the telescoping sum
            "extra_registries": (
                ("reshard.", _P + "server/reshard.py", "RESHARD_SEGMENTS"),
                ("sched.", _P + "pipeline/scheduler.py", "SCHED_SEGMENTS"),
                ("history.", _P + "fault/handoff.py", "HISTORY_SEGMENTS"),
            ),
            "span_calls": ("span", "span_event", "Span", "subspan"),
        }),
    "blackbox-registry": RulePolicy(
        packages=(PACKAGE,),
        options={
            "registry_file": _P + "core/blackbox.py",
            "registry_name": "BLACKBOX_EVENT_REGISTRY",
            # the producer entry point anywhere; the journal's own
            # `record` method only inside the registry file
            "record_calls": ("record_event",),
            "local_record_calls": ("record",),
        }),
}


# -- baseline -----------------------------------------------------------------
def fingerprint(rule: str, rel: str, norm: str, occurrence: int) -> str:
    """Line-number-free identity: rule + file + normalized source line +
    nth occurrence of that line among the rule's findings in the file.
    Survives unrelated edits above the finding; changes when the flagged
    code itself changes (which SHOULD re-surface the finding)."""
    h = hashlib.sha1(f"{rule}|{rel}|{norm}|{occurrence}".encode())
    return h.hexdigest()[:16]


def assign_fingerprints(findings: List[Finding],
                        ctxs: Mapping[str, FileCtx]) -> List[Finding]:
    seen: Dict[Tuple[str, str, str], int] = {}
    out = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        ctx = ctxs.get(f.path)
        norm = ""
        if ctx is not None and 1 <= f.line <= len(ctx.lines):
            norm = ctx.lines[f.line - 1].strip()
        k = (f.rule, f.path, norm)
        n = seen.get(k, 0)
        seen[k] = n + 1
        out.append(Finding(f.rule, f.path, f.line, f.message,
                           fingerprint(f.rule, f.path, norm, n)))
    return out


def load_baseline(path: Path) -> List[Dict[str, Any]]:
    if not path.exists():
        return []
    data = json.loads(path.read_text())
    return list(data.get("findings", []))


def write_baseline(path: Path, findings: Sequence[Finding]) -> None:
    path.write_text(json.dumps({
        "version": 1,
        "comment": "grandfathered fdbtpu-lint findings; shrink-or-hold only "
                   "(tests/test_torch_lint.py pins the ceiling). Regenerate "
                   "with `python -m foundationdb_tpu_torch.tools.lint "
                   "--write-baseline` "
                   "— but prefer fixing the finding.",
        "findings": [f.as_dict() for f in findings],
    }, indent=1, sort_keys=True) + "\n")


# -- runner -------------------------------------------------------------------
@dataclass
class LintResult:
    new: List[Finding]
    baselined: List[Finding]
    suppressed: List[Tuple[Finding, Suppression]]
    stale_baseline: List[Dict[str, Any]]
    files: int
    rules: Tuple[str, ...]

    @property
    def ok(self) -> bool:
        return not self.new and not self.stale_baseline

    def counts(self) -> Dict[str, Dict[str, int]]:
        out: Dict[str, Dict[str, int]] = {
            r: {"new": 0, "baselined": 0, "suppressed": 0} for r in self.rules}
        for f in self.new:
            out.setdefault(f.rule, {"new": 0, "baselined": 0,
                                    "suppressed": 0})["new"] += 1
        for f in self.baselined:
            out.setdefault(f.rule, {"new": 0, "baselined": 0,
                                    "suppressed": 0})["baselined"] += 1
        for f, _s in self.suppressed:
            out.setdefault(f.rule, {"new": 0, "baselined": 0,
                                    "suppressed": 0})["suppressed"] += 1
        return out


def discover_files(root: Path) -> List[Path]:
    """The port's sources: every .py under the package, less the kernel
    build directory, the bytecode caches and the linter itself."""
    pkg = root / PACKAGE
    me = Path(__file__).resolve().parent
    out = []
    for p in sorted(pkg.rglob("*.py")):
        rp = p.resolve()
        if me == rp.parent or me in rp.parents:
            continue          # the linter does not lint itself
        if "__pycache__" in p.parts or "_build" in p.relative_to(pkg).parts:
            continue
        out.append(p)
    return out


def run_lint(root: Path, checkers: Sequence[Checker],
             policy: Optional[Mapping[str, RulePolicy]] = None,
             files: Optional[Sequence[Path]] = None,
             baseline: Optional[Sequence[Dict[str, Any]]] = None,
             rules: Optional[Sequence[str]] = None) -> LintResult:
    policy = dict(DEFAULT_POLICY if policy is None else policy)
    paths = list(files) if files is not None else discover_files(root)
    ctxs: List[FileCtx] = [FileCtx(root, p) for p in paths]
    by_rel = {c.rel: c for c in ctxs}

    raw: List[Finding] = []
    active_rules: List[str] = []
    for ch in checkers:
        if rules is not None and ch.rule not in rules:
            continue
        pol = policy.get(ch.rule, RulePolicy())
        if ch.repo_level:
            if files is not None:
                continue   # cross-file diffs are only sound on a full scan
            active_rules.append(ch.rule)
            raw.extend(ch.check_repo(root, ctxs, pol))
        else:
            active_rules.append(ch.rule)
            for ctx in ctxs:
                if pol.applies(ctx.rel):
                    raw.extend(ch.check(ctx, pol))
    # malformed suppressions are findings of their own rule, never
    # suppressible (a bad allow cannot allow itself)
    meta: List[Finding] = []
    for ctx in ctxs:
        meta.extend(ctx.bad_suppressions)

    suppressed: List[Tuple[Finding, Suppression]] = []
    kept: List[Finding] = []
    for f in raw:
        ctx = by_rel.get(f.path)
        s = ctx.suppressed(f.rule, f.line) if ctx is not None else None
        if s is not None:
            suppressed.append((f, s))
        else:
            kept.append(f)

    kept = assign_fingerprints(kept, by_rel) + assign_fingerprints(meta, by_rel)
    base = list(baseline or [])
    base_keys = {(b.get("rule"), b.get("path"), b.get("fingerprint"))
                 for b in base}
    new = [f for f in kept if f.key() not in base_keys]
    grandfathered = [f for f in kept if f.key() in base_keys]
    current_keys = {f.key() for f in kept}
    # stale detection is only sound when the entry's rule actually ran over
    # the full tree: a --rules or path-limited invocation must not report
    # unscanned grandfathered findings as "fixed"
    if files is None:
        scanned = set(active_rules)
        stale = [b for b in base
                 if b.get("rule") in scanned
                 and (b.get("rule"), b.get("path"), b.get("fingerprint"))
                 not in current_keys]
    else:
        stale = []
    if "suppression" not in active_rules:
        active_rules.append("suppression")
    return LintResult(new=new, baselined=grandfathered, suppressed=suppressed,
                      stale_baseline=stale, files=len(ctxs),
                      rules=tuple(active_rules))


# -- report -------------------------------------------------------------------
def render_report(res: LintResult, checkers: Sequence[Checker],
                  out=None) -> None:
    """Same shape as tools/buggify_coverage.py: headline counts, a per-rule
    table, a per-package inventory, then the actionable lists."""
    out = out if out is not None else sys.stdout
    print(f"fdbtpu-lint: {res.files} files, "
          f"{len([r for r in res.rules if r != 'suppression'])} rules",
          file=out)
    counts = res.counts()
    width = max((len(r) for r in counts), default=10) + 2
    print(f"  {'rule':<{width}} {'new':>5} {'baselined':>10} "
          f"{'suppressed':>11}", file=out)
    for rule in sorted(counts):
        c = counts[rule]
        print(f"  {rule:<{width}} {c['new']:>5} {c['baselined']:>10} "
              f"{c['suppressed']:>11}", file=out)

    per_pkg: Dict[str, int] = {}
    for f in (res.new + res.baselined + [s for s, _ in res.suppressed]):
        pkg = "/".join(f.path.split("/")[:2])
        per_pkg[pkg] = per_pkg.get(pkg, 0) + 1
    print("per-package inventory (new + baselined + suppressed):", file=out)
    if not per_pkg:
        print("  (clean)", file=out)
    for pkg in sorted(per_pkg):
        print(f"  {pkg}: {per_pkg[pkg]}", file=out)

    if res.suppressed:
        print("active suppressions (each carries its reason on the line):",
              file=out)
        for f, s in sorted(res.suppressed, key=lambda t: (t[0].path,
                                                          t[0].line)):
            print(f"  {f.path}:{f.line} [{f.rule}] {s.reason}", file=out)
    if res.stale_baseline:
        print("stale baseline entries (finding is FIXED — delete the entry "
              "so the baseline shrinks):", file=out)
        for b in res.stale_baseline:
            print(f"  {b.get('path')} [{b.get('rule')}] "
                  f"{b.get('fingerprint')}", file=out)
    if res.new:
        print("new findings:", file=out)
        for f in sorted(res.new, key=lambda f: (f.path, f.line)):
            print(f"  {f.path}:{f.line}: [{f.rule}] {f.message}", file=out)
    else:
        print("no new findings", file=out)


def main(checkers: Sequence[Checker], argv: Optional[Sequence[str]] = None,
         out=None) -> int:
    # resolved at call time, not import time, so pytest capsys / cli
    # redirection see the report
    out = out if out is not None else sys.stdout
    ap = argparse.ArgumentParser(
        prog="python -m foundationdb_tpu_torch.tools.lint",
        description="AST invariant checker over the port: determinism, "
                    "stream-sync discipline, static-buffer ownership, graph "
                    "capture hazards, knob/doc drift, span and black-box "
                    "registries")
    ap.add_argument("paths", nargs="*",
                    help="limit to these files (default: the whole package)")
    ap.add_argument("--root", default=str(REPO), help=argparse.SUPPRESS)
    ap.add_argument("--baseline", default=None,
                    help=f"baseline JSON (default: <root>/{BASELINE_REL})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, grandfathered or not")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current findings as the new baseline "
                         "(prefer fixing; the ceiling test must be bumped)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated subset of rules to run")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable findings on stdout")
    args = ap.parse_args(argv)

    root = Path(args.root).resolve()
    baseline_path = Path(args.baseline) if args.baseline else (
        root / BASELINE_REL)
    baseline = [] if args.no_baseline else load_baseline(baseline_path)
    files: Optional[List[Path]] = []
    for p in args.paths:
        rp = Path(p).resolve()
        if not rp.is_file():
            print(f"lint: no such file: {p}", file=sys.stderr)
            return 2
        try:
            rp.relative_to(root)
        except ValueError:
            print(f"lint: {p} is outside the lint root {root} "
                  "(pass --root to lint another tree)", file=sys.stderr)
            return 2
        files.append(rp)
    files = files or None
    rules = ([r.strip() for r in args.rules.split(",") if r.strip()]
             if args.rules else None)
    if rules:
        unknown = sorted(set(rules) - {c.rule for c in checkers})
        if unknown:
            print(f"lint: unknown rule(s): {', '.join(unknown)} "
                  f"(known: {', '.join(sorted(c.rule for c in checkers))})",
                  file=sys.stderr)
            return 2

    res = run_lint(root, checkers, files=files, baseline=baseline,
                   rules=rules)
    if args.write_baseline:
        write_baseline(baseline_path, res.new + res.baselined)
        print(f"baseline written: {baseline_path} "
              f"({len(res.new) + len(res.baselined)} findings)", file=out)
        return 0
    if args.as_json:
        print(json.dumps({
            "files": res.files,
            # which rules ran, with their counts (the report's table)
            "rules": list(res.rules),
            "counts": res.counts(),
            "new": [f.as_dict() for f in res.new],
            "baselined": [f.as_dict() for f in res.baselined],
            "suppressed": [
                {**f.as_dict(), "reason": s.reason}
                for f, s in res.suppressed],
            "stale_baseline": res.stale_baseline,
        }, indent=1), file=out)
    else:
        render_report(res, checkers, out=out)
    return 0 if res.ok else 1
