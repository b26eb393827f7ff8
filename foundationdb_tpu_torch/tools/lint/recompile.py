"""Rule `recompile`: graph captures and data-dependent shapes off warmup.

The torch counterpart of ``foundationdb_tpu/tools/lint/recompile.py``.
The port's "compile" is a program build plus its CUDA graph captures,
counted by ``host_engine.CAPTURES`` (``count_capture``) and pinned at 0
after warmup by the engines' ``perf.*.compiles_steady`` series, the
reshard and perf smokes and chip_smoke. A graph holds fixed shapes and
fixed addresses: a capture on the serving path, or a batch whose shape
follows the data, is the per-value / per-shape recompile the bucket
ladder (``KernelConfig.bucket``) exists to prevent.

Flags, inside dispatch-path modules (``ops/``, ``pipeline/``,
``parallel/`` by policy):

- a graph capture site — ``torch.cuda.graph(...)`` or
  ``<graph>.capture_begin(...)`` — outside the functions the policy
  sanctions to capture (``capture_functions``: a program's ``_capture``
  and the engines' ``warmup``);
- a copy into a program's static input (``<static_inputs>[...].copy_(
  src)``, the load_chunk idiom) whose target or source holds a slice with
  a non-constant bound (one shape per distinct value) or a bare
  ``len(...)``;
- the same two hazards in an argument of a program handle (a local named
  in ``entries``: ``prog(...)``).

Indexing a static input by a chunk number (``inputs[name][c]``) is not a
slice and does not fire: the shape stays the bucket's.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Optional

from .core import Checker, FileCtx, Finding, RulePolicy


def _root_names(e: ast.AST) -> List[str]:
    """The names along an expression's receiver chain:
    `self.inputs[name][c]` -> ["inputs", "self"]."""
    out: List[str] = []
    while isinstance(e, (ast.Subscript, ast.Attribute)):
        if isinstance(e, ast.Attribute):
            out.append(e.attr)
        e = e.value
    if isinstance(e, ast.Name):
        out.append(e.id)
    return out


def _hazards(e: ast.AST) -> Iterable[ast.AST]:
    """Bare len(...) calls and slices with a non-constant bound."""
    for n in ast.walk(e):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                and n.func.id == "len":
            yield n
        elif isinstance(n, ast.Slice) and any(
                b is not None and not isinstance(b, ast.Constant)
                for b in (n.lower, n.upper)):
            yield n


class RecompileChecker(Checker):
    rule = "recompile"
    description = "graph captures off warmup / data-dependent shapes into static inputs"
    fronts = "zero steady-state captures (host_engine.CAPTURES, compiles_steady)"

    def check(self, ctx: FileCtx, policy: RulePolicy) -> Iterable[Finding]:
        opts = policy.options
        capture_fns = tuple(opts.get("capture_functions", ("_capture", "warmup")))
        static = tuple(opts.get("static_inputs", ("inputs",)))
        entries = tuple(opts.get("entries", ("prog", "program", "compiled")))
        out: List[Finding] = []

        def in_capture_fn(node: ast.AST) -> bool:
            return any(fn.name in capture_fns
                       for fn in ctx.enclosing_funcs(node))

        def shape_findings(where: ast.AST, into: str) -> None:
            for h in _hazards(where):
                what = ("bare `len(...)` (one shape per distinct value)"
                        if isinstance(h, ast.Call)
                        else "data-dependent slice (one shape per distinct "
                             "bound)")
                out.append(Finding(
                    self.rule, ctx.rel, h.lineno,
                    f"{what} flows into {into} — a captured graph holds "
                    "fixed shapes: pad to the KernelConfig.bucket ladder "
                    "and index whole chunks (tools/lint/recompile.py)"))

        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            capture: Optional[str] = None
            if ctx.qual_of(f) == "torch.cuda.graph":
                capture = "torch.cuda.graph(...)"
            elif isinstance(f, ast.Attribute) and f.attr == "capture_begin":
                capture = ".capture_begin(...)"
            if capture is not None and not in_capture_fn(node):
                out.append(Finding(
                    self.rule, ctx.rel, node.lineno,
                    f"graph capture {capture} outside the sanctioned capture "
                    f"functions ({', '.join(capture_fns)}) — a capture on the "
                    "serving path is a steady-state compile "
                    "(host_engine.CAPTURES); build it in warmup "
                    "(tools/lint/recompile.py)"))
                continue
            if isinstance(f, ast.Attribute) and f.attr == "copy_" \
                    and any(n in static for n in _root_names(f.value)):
                shape_findings(f.value, "a program's static input")
                for a in list(node.args) + [k.value for k in node.keywords]:
                    shape_findings(a, "a program's static input")
            elif isinstance(f, ast.Name) and f.id in entries:
                for a in list(node.args) + [k.value for k in node.keywords]:
                    shape_findings(a, "a captured program's call")
        return out
