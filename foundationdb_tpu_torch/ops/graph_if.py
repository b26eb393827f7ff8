"""Conditional IF nodes in a captured CUDA graph: the wrapper of
``csrc/graph_if.cu`` (runtime API, CUDA >= 12.4).

torch.cuda.CUDAGraph has no binding for conditional nodes in the torch the
card runs (2.11), so the node is built by the C helper on the stream torch
is capturing, and its body is captured on a stream of its own. While the
body is captured the engine's body stream is torch's current stream and
torch's caching allocator serves that stream from a private pool, which the
graph's nodes then use at every replay: the pool is never released (it
lives as long as the process). Bodies of different graphs share it, as
graphs share the engine's graph pool: replays are serialized on one stream.

    with graph_if.bodies(stream, pool):       # around torch.cuda.graph(...)
        ...
        with graph_if.if_node(pred):          # pred: 0-d bool on the card
            ...                               # runs only where pred holds

A body must write its results into tensors that exist before the node. A
missing mechanism raises: no card, a failed build, an unsupported runtime,
or an IF node asked for outside `bodies`.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

_LOCAL = threading.local()


class GraphIf:
    """The helper library and its count of IF nodes captured (`nodes`)."""

    def __init__(self):
        self.nodes = 0
        self._lib = None

    def lib(self):
        if self._lib is None:
            from ..native import build

            lib = build.load("graph_if")
            lib.fdb_if_begin.argtypes = [ctypes.c_void_p] * 3
            lib.fdb_if_end.argtypes = [ctypes.c_void_p]
            for fn in (lib.fdb_if_begin, lib.fdb_if_end, lib.fdb_if_init):
                fn.restype = ctypes.c_int
            _check(lib.fdb_if_init(), "loading the set-conditional kernel")
            self._lib = lib
        return self._lib


GRAPH_IF = GraphIf()


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA graph IF node: {what} failed with cudaError_t {rc}")


@contextlib.contextmanager
def bodies(stream: "torch.cuda.Stream", pool):
    """Let if_node() capture bodies on `stream` (idle, not the capturing
    stream), allocating from the private pool `pool`
    (torch.cuda.graph_pool_handle()). Enter it outside the capture: it
    loads the helper first."""
    GRAPH_IF.lib()
    prev = getattr(_LOCAL, "ctx", None)
    _LOCAL.ctx = (stream, pool)
    try:
        yield
    finally:
        _LOCAL.ctx = prev


@contextlib.contextmanager
def if_node(pred: torch.Tensor):
    """Capture the block as the body of an IF node on `pred`, a 0-d bool
    tensor on the card that the graph computes before the node."""
    ctx = getattr(_LOCAL, "ctx", None)
    if ctx is None:
        raise RuntimeError("an IF node needs a body stream and pool: capture inside "
                           "graph_if.bodies(stream, pool)")
    if pred.device.type != "cuda" or pred.dtype != torch.bool or pred.numel() != 1:
        raise ValueError(f"IF-node predicate must be one bool on the card, got "
                         f"{pred.dtype} {tuple(pred.shape)} on {pred.device}")
    stream, pool = ctx
    lib = GRAPH_IF.lib()
    parent = torch.cuda.current_stream(pred.device)
    _check(lib.fdb_if_begin(parent.cuda_stream, stream.cuda_stream, pred.data_ptr()),
           "begin")
    dev = pred.device.index
    try:
        with torch.cuda.stream(stream):
            torch._C._cuda_beginAllocateCurrentStreamToPool(dev, pool)
            try:
                yield
            finally:
                torch._C._cuda_endAllocateToPool(dev, pool)
    finally:
        _check(lib.fdb_if_end(stream.cuda_stream), "end of body capture")
    GRAPH_IF.nodes += 1
