"""Conditional IF and WHILE nodes in a captured CUDA graph: the wrapper of
``csrc/graph_if.cu`` (runtime API, CUDA >= 12.4).

torch.cuda.CUDAGraph has no binding for conditional nodes in the torch the
card runs (2.11), so a node is built by the C helper on the stream torch is
capturing, and its body is captured on a stream of its own. While a body is
captured its stream is torch's current stream and torch's caching allocator
serves that stream from a private pool, which the graph's nodes then use at
every replay: the pool is never released (it lives as long as the process).
Bodies of different graphs share it, as graphs share the engine's graph
pool: replays are serialized on one stream.

A node may sit in another node's body (the tiered merge's IF node in the
server loop's WHILE body). Each nesting level captures on its own stream
into its own pool: `bodies` takes one (stream, pool) level per depth. The
pools must differ from one another and from the graph's pool: the allocator
refuses two stream filters on one pool, and _cuda_endAllocateToPool drops
the first filter of a pool, not the newest.

    with graph_if.bodies([(s1, p1), (s2, p2)]):   # around torch.cuda.graph(...)
        ...
        with graph_if.if_node(pred):              # pred: 0-d bool on the card
            ...                                   # runs only where pred holds
        with graph_if.while_node(pred) as again:  # pred: the first condition
            ...                                   # the body
            again(pred2)                          # the next condition

A body must write its results into tensors that exist before the node. A
missing mechanism raises: no card, a failed build, an unsupported runtime,
a node asked for outside `bodies`, or nested deeper than its levels.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Sequence, Tuple

import torch

_LOCAL = threading.local()
_IF, _WHILE = 0, 1


class GraphIf:
    """The helper library and its counts of conditional nodes captured:
    IF nodes (`nodes`) and WHILE nodes (`while_nodes`)."""

    def __init__(self):
        self.nodes = 0
        self.while_nodes = 0
        self._lib = None
        self._devices = set()

    def lib(self):
        if self._lib is None:
            from ..native import build

            lib = build.load("graph_if")
            lib.fdb_cond_begin.argtypes = [ctypes.c_void_p] * 3 + [
                ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong)]
            lib.fdb_cond_set.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_void_p]
            lib.fdb_cond_end.argtypes = [ctypes.c_void_p]
            for fn in (lib.fdb_cond_begin, lib.fdb_cond_set, lib.fdb_cond_end,
                       lib.fdb_cond_init):
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def ready(self, device: int) -> None:
        """Load the set-conditional kernel on card `device` (outside any
        capture: a node captured on that card launches it)."""
        lib = self.lib()
        if device not in self._devices:
            with torch.cuda.device(device):
                _check(lib.fdb_cond_init(), "loading the set-conditional kernel")
            self._devices.add(device)


GRAPH_IF = GraphIf()


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA graph conditional node: {what} failed with cudaError_t {rc}")


@contextlib.contextmanager
def bodies(levels: Sequence[Tuple["torch.cuda.Stream", object]]):
    """Let if_node() / while_node() capture bodies: the body of a node at
    nesting depth d (0 = in the graph itself) on levels[d]'s stream (idle,
    not the capturing stream), allocating from its private pool
    (torch.cuda.graph_pool_handle()). Enter it outside the capture, on
    the card being captured: it loads the helper there first."""
    GRAPH_IF.ready(torch.cuda.current_device())
    prev = getattr(_LOCAL, "ctx", None)
    _LOCAL.ctx = [list(levels), 0]
    try:
        yield
    finally:
        _LOCAL.ctx = prev


def _check_pred(pred: torch.Tensor, kind: str) -> None:
    if pred.device.type != "cuda" or pred.dtype != torch.bool or pred.numel() != 1:
        raise ValueError(f"{kind}-node condition must be one bool on the card, got "
                         f"{pred.dtype} {tuple(pred.shape)} on {pred.device}")


@contextlib.contextmanager
def _node(pred: torch.Tensor, kind: int):
    name = "IF" if kind == _IF else "WHILE"
    ctx = getattr(_LOCAL, "ctx", None)
    if ctx is None:
        raise RuntimeError(f"{name} nodes need a body stream and pool: capture inside "
                           "graph_if.bodies(levels)")
    levels, depth = ctx
    if depth >= len(levels):
        raise RuntimeError(f"{name} nodes at nesting depth {depth} need {depth + 1} body "
                           f"levels; graph_if.bodies was given {len(levels)}")
    _check_pred(pred, name)
    stream, pool = levels[depth]
    lib = GRAPH_IF.lib()
    parent = torch.cuda.current_stream(pred.device)
    handle = ctypes.c_ulonglong(0)
    _check(lib.fdb_cond_begin(parent.cuda_stream, stream.cuda_stream, pred.data_ptr(), kind,
                              ctypes.byref(handle)), f"begin of a {name} node")
    dev = pred.device.index
    ctx[1] = depth + 1
    try:
        with torch.cuda.stream(stream):
            torch._C._cuda_beginAllocateCurrentStreamToPool(dev, pool)
            try:
                yield stream, handle.value
            finally:
                torch._C._cuda_endAllocateToPool(dev, pool)
    finally:
        ctx[1] = depth
        _check(lib.fdb_cond_end(stream.cuda_stream), f"end of a {name} body capture")
    if kind == _IF:
        GRAPH_IF.nodes += 1
    else:
        GRAPH_IF.while_nodes += 1


@contextlib.contextmanager
def if_node(pred: torch.Tensor):
    """Capture the block as the body of an IF node on `pred`, a 0-d bool
    tensor on the card that the graph computes before the node."""
    with _node(pred, _IF):
        yield


@contextlib.contextmanager
def while_node(pred: torch.Tensor):
    """Capture the block as the body of a WHILE node: the body runs while
    the condition holds, first `pred` (a 0-d bool on the card the graph
    computes before the node), then the one the body passes to the function
    this yields, which it must call last, once."""
    with _node(pred, _WHILE) as (stream, handle):
        lib = GRAPH_IF.lib()
        set_once = []

        def again(cond: torch.Tensor) -> None:
            _check_pred(cond, "WHILE")
            if set_once:
                raise RuntimeError("a WHILE body sets its next condition once")
            _check(lib.fdb_cond_set(stream.cuda_stream, handle, cond.data_ptr()),
                   "the WHILE body's condition")
            set_once.append(True)

        yield again
        if not set_once:
            raise RuntimeError("a WHILE body must set its next condition (again(cond))")
