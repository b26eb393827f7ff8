"""Rule `donation`: the static buffers a captured graph owns.

The torch counterpart of ``foundationdb_tpu/tools/lint/donation.py``.
JAX donates the engine's table to each dispatched program, which may
reuse its buffer. Torch donates nothing; instead a captured CUDA graph
owns the ADDRESSES of the tensors it was captured over: every replay
writes the engine's ``state`` tensors in place, asynchronously on the
engine's stream. Two contracts follow, and the rule front-runs both
(the dynamic checks: chip_smoke's replay-vs-eager parity, the engines'
``_set_state`` discipline, ``blocking_syncs == 0``):

- **own the storage** — a static buffer is refilled with ``copy_``
  (``_set_state``), never rebound. ``self.state = ...`` or
  ``self.state[k] = ...`` outside the owner functions (``__init__`` by
  policy) leaves every captured graph writing the old tensors: the
  engine then reads a table its programs no longer update.
- **own the contents until the drain** — within a function body, in
  source order (nested ``def``s are their own scope), a call whose name
  contains ``dispatch`` / ``enqueue`` or a ``.replay()`` ARMS the check;
  a host read of a static buffer (``.cpu()`` / ``.numpy()`` /
  ``.tolist()`` / ``.item()`` / ``np.asarray(...)`` of an expression
  rooted at ``state``) while armed flags: the in-flight replay may still
  be writing it, so the read either parks the host mid-dispatch or, from
  a ``non_blocking`` copy, sees a half-written table. A call to
  ``force`` / ``drain_loop`` / ``_drain_through`` / ``clear`` disarms.
  Torch ops on the table need no drain: the stream orders them.

Heuristic scope, as in the reference: branches are walked linearly.
"""
from __future__ import annotations

import ast
from typing import Iterable, Iterator, List, Optional

from .core import Checker, FileCtx, Finding, RulePolicy

#: tensor methods that read a value to the host
_HOST_READS = ("cpu", "numpy", "tolist", "item")
_NUMPY_READS = ("numpy.asarray", "numpy.array")


def _last_name(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _names_along(e: ast.AST) -> List[str]:
    """Attribute and name identifiers along a receiver chain:
    `self.state["hist"][:4]` -> ["state", "self"]."""
    out: List[str] = []
    while isinstance(e, (ast.Subscript, ast.Attribute, ast.Starred)):
        if isinstance(e, ast.Attribute):
            out.append(e.attr)
        e = e.value
    if isinstance(e, ast.Name):
        out.append(e.id)
    return out


def _linear_stmts(body: List[ast.stmt]) -> Iterator[ast.stmt]:
    """Statements in source order, recursing into compound bodies but NOT
    into nested function/class scopes."""
    for s in body:
        yield s
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            continue
        for attr in ("body", "orelse", "finalbody"):
            sub = getattr(s, attr, None)
            if sub:
                yield from _linear_stmts(sub)
        for h in getattr(s, "handlers", ()) or ():
            yield from _linear_stmts(h.body)


def _stmt_nodes(s: ast.stmt) -> List[ast.AST]:
    """All nodes of a statement, excluding nested def/class/lambda bodies
    and, for a compound statement, its nested statement bodies (those are
    walked as statements of their own)."""
    nodes: List[ast.AST] = []
    stack: List[ast.AST] = [s]
    while stack:
        n = stack.pop()
        nodes.append(n)
        for ch in ast.iter_child_nodes(n):
            if isinstance(ch, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef, ast.Lambda)):
                continue
            if n is s and isinstance(ch, ast.stmt):
                continue
            stack.append(ch)
    return nodes


class DonationChecker(Checker):
    rule = "donation"
    description = "rebinding or mid-flight host reads of a captured graph's static buffers"
    fronts = "captured graphs write the engine's state in place (_set_state, replay parity)"

    def check(self, ctx: FileCtx, policy: RulePolicy) -> Iterable[Finding]:
        opts = policy.options
        static = tuple(opts.get("static", ("state",)))
        owners = tuple(opts.get("owners", ("__init__",)))
        triggers = tuple(opts.get("triggers", ("dispatch", "enqueue")))
        drains = tuple(opts.get("drains",
                                ("force", "drain_loop", "_drain_through",
                                 "clear")))
        out: List[Finding] = []

        def static_target(t: ast.AST) -> Optional[str]:
            """The static name a store rebinds: an attribute (`x.state =`)
            or an entry of one (`x.state[k] =`, `state[k] =`)."""
            if isinstance(t, ast.Attribute) and t.attr in static:
                return t.attr
            if isinstance(t, ast.Subscript):
                names = _names_along(t.value)
                hit = [n for n in names if n in static]
                return hit[0] if hit else None
            return None

        # -- own the storage ---------------------------------------------
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign):
                targets = list(node.targets)
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                targets = [node.target]
            else:
                continue
            flat: List[ast.AST] = []
            while targets:
                t = targets.pop()
                if isinstance(t, (ast.Tuple, ast.List)):
                    targets.extend(t.elts)
                else:
                    flat.append(t)
            for t in flat:
                nm = static_target(t)
                if nm is None:
                    continue
                if any(fn.name in owners for fn in ctx.enclosing_funcs(node)):
                    continue
                out.append(Finding(
                    self.rule, ctx.rel, node.lineno,
                    f"rebinds the static buffer `{nm}` outside its owner "
                    f"({', '.join(owners)}) — every captured graph keeps "
                    "writing the old tensors; refill it in place with "
                    "copy_ (_set_state) (tools/lint/donation.py)"))

        # -- own the contents until the drain ----------------------------
        def host_read(n: ast.AST) -> Optional[str]:
            if not isinstance(n, ast.Call):
                return None
            f = n.func
            if isinstance(f, ast.Attribute) and f.attr in _HOST_READS:
                hit = [x for x in _names_along(f.value) if x in static]
                return hit[0] if hit else None
            if ctx.qual_of(f) in _NUMPY_READS and n.args:
                hit = [x for x in _names_along(n.args[0]) if x in static]
                return hit[0] if hit else None
            return None

        def classify(s: ast.stmt):
            is_trigger = is_drain = False
            reads: List[str] = []
            for n in _stmt_nodes(s):
                if isinstance(n, ast.Call):
                    name = _last_name(n.func)
                    if name is not None:
                        if name in drains:
                            is_drain = True
                        if name == "replay" or any(t in name for t in triggers):
                            is_trigger = True
                    r = host_read(n)
                    if r is not None:
                        reads.append(r)
            return is_trigger, is_drain, reads

        for fn in ctx.functions:
            armed_at: Optional[int] = None
            for s in _linear_stmts(fn.body):
                is_trigger, is_drain, reads = classify(s)
                if is_drain:
                    armed_at = None
                    continue
                if armed_at is not None and reads:
                    out.append(Finding(
                        self.rule, ctx.rel, s.lineno,
                        f"host read of static buffer `{reads[0]}` after the "
                        f"dispatch on line {armed_at} with no intervening "
                        "drain — the replay may still be writing it; call "
                        "force()/drain_loop() first "
                        "(tools/lint/donation.py)"))
                    armed_at = None   # one finding per window is actionable
                if is_trigger:
                    armed_at = s.lineno
        return out
