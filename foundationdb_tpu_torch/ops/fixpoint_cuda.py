"""The commit fixpoint on the card: wrapper of the CUDA kernel
``csrc/fixpoint.cu`` beside its plain torch version.

Replaces the TPU kernel ``commit_fixpoint_pallas``
(foundationdb_tpu/ops/fixpoint_pallas.py:343). The kernel runs the whole
convergence loop in one launch of one 1024-thread CTA; the note at the top
of the source says what bounds it and what the design does about it.

Dispatch is by device (``commit_fixpoint``): CPU tensors take the plain
version, CUDA tensors the kernel — or an error when the config is not
kernel-supported. Nothing falls back. The plain version on CUDA tensors is
called only to check the kernel against it (``commit_fixpoint_plain``);
``FIXPOINT`` counts both, so a run can show which one its path took.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import conflict_kernel as ck
from .conflict_kernel import KernelConfig

Tensor = torch.Tensor

#: fdb_commit_fixpoint's C signature: 14 input pointers, the gid scratch
#: table, 2 output pointers; T, Rp, Rr, Wp, Wr, WRW, WPW, G; the stream
_ARGTYPES = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


class FixpointKernel:
    """Launch bookkeeping of the kernel: `launches` counts kernel launches,
    `plain_cuda_calls` counts plain-version calls on CUDA tensors, and
    `last_rounds` holds the device int32 [1] round count of the newest
    launch."""

    def __init__(self):
        self.launches = 0
        self.plain_cuda_calls = 0
        self.last_rounds: Optional[Tensor] = None
        self._fn = None

    def reset_counts(self) -> None:
        self.launches = 0
        self.plain_cuda_calls = 0

    def fn(self):
        if self._fn is None:
            from ..native import build

            fn = build.load("fixpoint").fdb_commit_fixpoint
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn


FIXPOINT = FixpointKernel()


def supported(cfg: KernelConfig) -> bool:
    """Shapes the kernel handles: whole 32-txn words (warp ballots) and a
    gid table indexable by int32 (the same rule as the TPU kernel's)."""
    if cfg.max_txns % 32:
        return False
    return 2 * (cfg.gid_space + 2) < 2**31


def commit_fixpoint_plain(cfg: KernelConfig, t_ok: Tensor, hist_hits: Tensor,
                          edges: Dict[str, Tensor], batch: Dict) -> Tensor:
    """The plain version: the torch port of the XLA-form commit_fixpoint."""
    if t_ok.is_cuda:
        FIXPOINT.plain_cuda_calls += 1
    return ck.commit_fixpoint(cfg, t_ok, hist_hits, edges, batch)


def _check(name: str, x: Tensor, shape, dtype, device) -> Tensor:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    return x


def commit_fixpoint_kernel(cfg: KernelConfig, t_ok: Tensor, hist_hits: Tensor,
                           edges: Dict[str, Tensor], batch: Dict) -> Tensor:
    """committed bool [T] from the CUDA kernel, on PyTorch's current stream."""
    if not t_ok.is_cuda:
        raise ValueError("commit_fixpoint_kernel needs CUDA tensors")
    if not supported(cfg):
        raise ValueError(
            "the CUDA fixpoint does not support this config (need max_txns % 32 == 0 "
            "and 2*(gid_space+2) < 2^31)")
    dev = t_ok.device
    T, Rp, Rr, Wp, Wr = cfg.max_txns, cfg.rp, cfg.max_reads, cfg.wp, cfg.max_writes
    WRW, WPW, G = cfg.wr_words, cfg.wp_words, cfg.gid_space
    i32, b = torch.int32, torch.bool
    ins = [
        _check("t_ok", t_ok, (T,), b, dev),
        _check("hist_hits", hist_hits, (T,), i32, dev),
        _check("rp_txn", batch["rp_txn"], (Rp,), i32, dev),
        _check("rp_valid", batch["rp_valid"], (Rp,), b, dev),
        _check("gid_rp", edges["gid_rp"], (Rp,), i32, dev),
        _check("r_txn", batch["r_txn"], (Rr,), i32, dev),
        _check("r_valid", batch["r_valid"], (Rr,), b, dev),
        _check("wp_txn", batch["wp_txn"], (Wp,), i32, dev),
        _check("wp_valid", batch["wp_valid"], (Wp,), b, dev),
        _check("gid_wp", edges["gid_wp"], (Wp,), i32, dev),
        _check("w_txn", batch["w_txn"], (Wr,), i32, dev),
        _check("w_valid", batch["w_valid"], (Wr,), b, dev),
        _check("ovw", edges["ovw"], (cfg.r_all, WRW), i32, dev),
        _check("ovrp", edges["ovrp"], (Rr, WPW), i32, dev),
    ]
    fn = FIXPOINT.fn()
    with torch.cuda.device(dev):
        mn = torch.empty(G + 2, dtype=i32, device=dev)
        committed = torch.empty(T, dtype=b, device=dev)
        rounds = torch.empty(1, dtype=i32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*[x.data_ptr() for x in ins], mn.data_ptr(), committed.data_ptr(),
                rounds.data_ptr(), T, Rp, Rr, Wp, Wr, WRW, WPW, G, stream)
    if rc != 0:
        raise RuntimeError(f"fdb_commit_fixpoint launch failed: cudaError_t {rc}")
    FIXPOINT.launches += 1
    FIXPOINT.last_rounds = rounds
    return committed


def commit_fixpoint(cfg: KernelConfig, t_ok: Tensor, hist_hits: Tensor,
                    edges: Dict[str, Tensor], batch: Dict) -> Tensor:
    """The fixpoint on the tensors' device: CPU -> plain version, CUDA ->
    kernel (raising on an unsupported config, never falling back)."""
    if t_ok.device.type == "cpu":
        return ck.commit_fixpoint(cfg, t_ok, hist_hits, edges, batch)
    return commit_fixpoint_kernel(cfg, t_ok, hist_hits, edges, batch)
