"""Rule `host-sync`: implicit device→host syncs in the dispatch path.

The torch counterpart of ``foundationdb_tpu/tools/lint/host_sync.py``.
Front-runs: ``blocking_syncs == 0`` (ops/device_loop.py ``loop_stats``,
parallel/mesh_engine.py) and the dispatch path that chip_smoke drives
under ``torch.cuda.set_sync_debug_mode("error")`` — one stray ``.item()``
in a dispatch-path function parks the host until the card drains its
stream, re-serializing the pack/dispatch overlap the pipeline depends on.
The dynamic check only sees the paths one run takes; this one sees every
path, but only what a name shows: an AST cannot tell a device tensor from
a host one, so it sees every ``.item()`` and ``.synchronize()``, and the
host reads of a value whose name says it lives on the device. A device
value named otherwise is invisible to it; the dispatch-path modules
therefore name theirs ``*_dev`` (ops/host_engine.py's split-step path,
ops/conflict_kernel.py's eager loops and exports), and a sync that is
their contract sits in a drain point that says why.

Flags, inside dispatch-path modules (``ops/``, ``pipeline/``,
``parallel/`` by policy), outside drain points:

- ``.item()`` on anything (scalar readback is always a sync);
- ``.tolist()`` / ``.cpu()`` / ``.numpy()`` of a value that terminates in
  a device-resident name per the codebase convention (``*_dev`` /
  ``*_device``), through subscripts and device-side method calls
  (``x_dev[:n]``, ``x_dev.sum()``; not through ``.cpu()``, whose result
  is on the host);
- ``float(x)`` / ``bool(x)`` / ``int(x)`` of such a value;
- ``torch.cuda.synchronize()``, and ``.synchronize()`` of an event or a
  stream (every ``.synchronize()`` call: each blocks the host).

A host tensor is not a device value: a pinned buffer that a drain already
waited on is named for what it is (``*_host``, ``*_pinned``), so its
``.numpy()`` does not fire; nothing exempts ``.numpy()`` as such.

A *drain point* is where syncing is the contract: a function named in the
policy's sanctioned set (``force`` / ``drain_loop`` / ``_drain_through``)
or one annotated ``# fdbtpu-lint: drain-point <why>`` on (or directly
above) its ``def`` line. Enclosing drain points cover nested helpers.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Optional

from .core import Checker, FileCtx, Finding, RulePolicy

#: tensor methods that copy a device value to the host
_HOST_READS = ("tolist", "cpu", "numpy")


def _terminal_name(e: ast.AST) -> Optional[str]:
    """The identifier an expression 'ends in': `ticket.commit_dev` ->
    commit_dev, `out_dev[:n]` -> out_dev, `merged_dev.sum()` -> merged_dev,
    `x` -> x. A host read's result (`x_dev.cpu()`) ends in no name."""
    while True:
        if isinstance(e, (ast.Subscript, ast.Starred)):
            e = e.value
        elif isinstance(e, ast.Call) and isinstance(e.func, ast.Attribute) \
                and e.func.attr not in _HOST_READS + ("item",):
            e = e.func.value
        else:
            break
    if isinstance(e, ast.Attribute):
        return e.attr
    if isinstance(e, ast.Name):
        return e.id
    return None


class HostSyncChecker(Checker):
    rule = "host-sync"
    description = "implicit device->host syncs outside drain points"
    fronts = ("blocking_syncs == 0 (loop_stats) + a dispatch path clean "
              "under sync debug mode 'error'")

    def check(self, ctx: FileCtx, policy: RulePolicy) -> Iterable[Finding]:
        opts = policy.options
        drain_names = tuple(opts.get("drain_names",
                                     ("force", "drain_loop", "_drain_through")))
        suffixes = tuple(opts.get("device_suffixes", ("_dev", "_device")))
        out: List[Finding] = []

        def in_drain(node: ast.AST) -> bool:
            return any(ctx.is_drain_function(fn, drain_names)
                       for fn in ctx.enclosing_funcs(node))

        def device_ish(e: ast.AST) -> bool:
            name = _terminal_name(e)
            return name is not None and name.endswith(suffixes)

        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            hit: Optional[str] = None
            if isinstance(f, ast.Attribute) and f.attr == "item" \
                    and not node.args:
                hit = ".item() forces a scalar device readback"
            elif isinstance(f, ast.Attribute) and f.attr in _HOST_READS \
                    and device_ish(f.value):
                hit = (f".{f.attr}() of a device value "
                       f"(`{_terminal_name(f.value)}`) blocks on the device")
            elif isinstance(f, ast.Attribute) and f.attr == "synchronize":
                q = ctx.qual_of(f)
                hit = ("torch.cuda.synchronize() blocks the host on the card"
                       if q == "torch.cuda.synchronize" else
                       ".synchronize() of an event or stream blocks the host")
            elif isinstance(f, ast.Name) and f.id in ("float", "bool", "int") \
                    and len(node.args) == 1 and device_ish(node.args[0]):
                hit = (f"{f.id}() of a device value "
                       f"(`{_terminal_name(node.args[0])}`) blocks on the "
                       "device")
            if hit is None or in_drain(node):
                continue
            out.append(Finding(
                self.rule, ctx.rel, node.lineno,
                f"{hit} in a dispatch-path module outside a drain point — "
                "move it behind force()/drain_loop(), or annotate the "
                "function `# fdbtpu-lint: drain-point <why>` if syncing is "
                "its contract (tools/lint/host_sync.py)"))
        return out
