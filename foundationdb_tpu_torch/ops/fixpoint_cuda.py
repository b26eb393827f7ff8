"""The commit fixpoint on the card: wrapper of the CUDA kernel
``csrc/fixpoint.cu`` beside its plain torch version.

Replaces the TPU kernel ``commit_fixpoint_pallas``
(foundationdb_tpu/ops/fixpoint_pallas.py:343). The kernel runs the whole
convergence loop in one launch of one thread-block cluster of 1024-thread
CTAs; the note at the top of the source says what bounds it and what the
design does about it. ``launch_plan`` sizes the launch (cluster, row
slices, shared memory, scratch) in plain Python, so it runs without a card.

Dispatch is by device (``commit_fixpoint``): CPU tensors take the plain
version, CUDA tensors the kernel — or an error when the config is not
kernel-supported. Nothing falls back. The plain version on CUDA tensors is
called only to check the kernel against it (``commit_fixpoint_plain``);
``FIXPOINT`` counts both, so a run can show which one its path took.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from . import conflict_kernel as ck
from .conflict_kernel import KernelConfig

Tensor = torch.Tensor

#: fdb_commit_fixpoint's C signature: 14 input pointers, the gid table and
#: the two spill lists, 2 output pointers; T, Rp, Rr, Wp, Wr, WRW, WPW, G;
#: the launch plan's 7 ints; the stream
_ARGTYPES = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 15 + [ctypes.c_void_p]

#: CTAs in the kernel's cluster: 16, the most a Hopper cluster takes (above
#: the portable 8, so the C entry point sets the non-portable attribute).
#: 16 measured faster than 8 at every shape (PERF.md).
CLUSTER_CTAS = 16
THREADS = 1024
#: shared memory a CTA may use on Hopper (227 KB)
SMEM_LIMIT = 232448
#: bytes of one compacted edge word (bits, mask word, txn) and one point row
#: (gid slot, txn): the Entry and PointRow structs of csrc/fixpoint.cu
ENTRY_BYTES = 12
POINT_BYTES = 8


class FixpointKernel:
    """Launch bookkeeping of the kernel: `launches` counts the wrapper's
    launches (eager, or recorded into a CUDA graph while it is captured),
    `graph_launches` the kernel launches made by replaying captured graphs
    (the replaying engine adds each graph's captured count at every
    replay), `plain_cuda_calls` counts plain-version calls on CUDA tensors,
    and `last_rounds` holds the device int32 [1] round count of the newest
    launch."""

    def __init__(self):
        self.launches = 0
        self.graph_launches = 0
        self.plain_cuda_calls = 0
        self.last_rounds: Optional[Tensor] = None
        self._lib = None
        self._schedulable = set()

    def reset_counts(self) -> None:
        self.launches = 0
        self.graph_launches = 0
        self.plain_cuda_calls = 0

    def lib(self):
        if self._lib is None:
            from ..native import build

            lib = build.load("fixpoint")
            lib.fdb_commit_fixpoint.argtypes = _ARGTYPES
            lib.fdb_commit_fixpoint.restype = ctypes.c_int
            lib.fdb_fixpoint_active_clusters.argtypes = [ctypes.c_int, ctypes.c_int,
                                                         ctypes.POINTER(ctypes.c_int)]
            lib.fdb_fixpoint_active_clusters.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def check_schedulable(self, plan: Dict, dev: torch.device) -> None:
        """Raise unless the card can hold one cluster of the plan's shape,
        asked once per card and shape (cudaOccupancyMaxActiveClusters)."""
        key = (dev.index, plan["cluster"], plan["smem_bytes"])
        if key in self._schedulable:
            return
        n = ctypes.c_int(0)
        rc = self.lib().fdb_fixpoint_active_clusters(plan["cluster"], plan["smem_bytes"],
                                                     ctypes.byref(n))
        if rc != 0:
            raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: cudaError_t {rc}")
        if n.value < 1:
            raise RuntimeError(
                f"{torch.cuda.get_device_name(dev)} cannot schedule one cluster of "
                f"{plan['cluster']} CTAs of {plan['threads']} threads and {plan['smem_bytes']} "
                "bytes of shared memory each, which the CUDA fixpoint launches")
        self._schedulable.add(key)


FIXPOINT = FixpointKernel()


def launch_plan(cfg: KernelConfig) -> Dict:
    """How the kernel launches for `cfg`: one cluster of ``cluster`` CTAs;
    CTA k owns read rows [k * rows_per_cta, (k+1) * rows_per_cta) of the
    point-then-range row order (``slices``), a multiple of 32 rows each, and
    point writers [k * writers_per_cta, ...). Its shared memory holds the
    fixed part (counters, c, base, local blocked, two leader bitmaps, both
    writer masks, every writer's txn, the CTA's point writers' gid slots and
    txns, its read rows' txns), then up to ``point_cap`` point rows and ``entry_cap``
    edge entries; the rest of each list spills to global scratch sized for
    the worst case (every point row valid, every edge word nonzero). The
    gid table, [G+2] 64-bit round-tagged keys, lives in global memory
    (``gid_table``).
    Raises ValueError when the fixed part passes the 227 KB a CTA has."""
    return dict(_plan(cfg, CLUSTER_CTAS))


@functools.lru_cache(maxsize=64)
def _plan(cfg: KernelConfig, nc: int) -> Dict:
    T, Rp, Rr = cfg.max_txns, cfg.rp, cfg.max_reads
    WRW, WPW = cfg.wr_words, cfg.wp_words
    r_all = Rp + Rr
    rows_per_cta = -(-r_all // (32 * nc)) * 32 if r_all else 32
    slices = [(min(k * rows_per_cta, r_all), min((k + 1) * rows_per_cta, r_all))
              for k in range(nc)]
    worst_points = max(max(0, min(g1, Rp) - g0) for g0, g1 in slices)
    worst_entries = max((g1 - g0) * WRW + max(0, g1 - max(g0, Rp)) * WPW
                        for g0, g1 in slices)
    writers_per_cta = -(-cfg.wp // nc)
    fixed = 4 * (4 + 5 * (T // 32) + 33 * (WRW + WPW) + 2 * writers_per_cta + rows_per_cta)
    if fixed > SMEM_LIMIT:
        raise ValueError(
            f"the CUDA fixpoint needs {fixed} bytes of shared memory per CTA for "
            f"T={T}, {WRW}+{WPW} mask words; a CTA has {SMEM_LIMIT}")
    if worst_entries >= 2**31:
        raise ValueError(f"{worst_entries} edge words per CTA overflow the kernel's int32 list index")
    point_cap = min(worst_points, (SMEM_LIMIT - fixed) // 2 // POINT_BYTES)
    entry_cap = min(worst_entries, (SMEM_LIMIT - fixed - POINT_BYTES * point_cap) // ENTRY_BYTES)
    point_spill = worst_points - point_cap
    entry_spill = worst_entries - entry_cap
    return {
        "cluster": nc, "threads": THREADS, "rows_per_cta": rows_per_cta, "slices": slices,
        "writers_per_cta": writers_per_cta,
        "smem_bytes": fixed + POINT_BYTES * point_cap + ENTRY_BYTES * entry_cap,
        "point_cap": point_cap, "entry_cap": entry_cap,
        "point_spill_cap": point_spill, "entry_spill_cap": entry_spill,
        "point_scratch_bytes": nc * point_spill * POINT_BYTES,
        "entry_scratch_bytes": nc * entry_spill * ENTRY_BYTES,
        "gid_table": "global", "gid_table_bytes": 8 * (cfg.gid_space + 2),
    }


def supported(cfg: KernelConfig) -> bool:
    """Shapes the kernel handles: whole 32-txn words (warp ballots), a gid
    table indexable by int32 (the same rule as the TPU kernel's), and a
    launch plan whose fixed shared memory fits a CTA."""
    if cfg.max_txns % 32 or 2 * (cfg.gid_space + 2) >= 2**31:
        return False
    try:
        launch_plan(cfg)
    except ValueError:
        return False
    return True


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
            "the CUDA fixpoint does not support this config (need max_txns % 32 == 0, "
            "2*(gid_space+2) < 2^31 and the launch plan's shared memory within a CTA's)")
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
    plan = launch_plan(cfg)
    fn = FIXPOINT.lib().fdb_commit_fixpoint
    # one scratch buffer: the [G+2] 64-bit gid table, then both spill lists
    gid_bytes = 8 * (G + 2)
    spill_at = -(-gid_bytes // 16) * 16
    point_at = spill_at + -(-plan["entry_scratch_bytes"] // 16) * 16
    with torch.cuda.device(dev):
        FIXPOINT.check_schedulable(plan, dev)
        scratch = torch.empty(point_at + plan["point_scratch_bytes"], dtype=torch.uint8, device=dev)
        committed = torch.empty(T, dtype=b, device=dev)
        rounds = torch.empty(1, dtype=i32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        p = scratch.data_ptr()
        rc = fn(*[x.data_ptr() for x in ins], p, p + spill_at, p + point_at,
                committed.data_ptr(), rounds.data_ptr(),
                T, Rp, Rr, Wp, Wr, WRW, WPW, G,
                plan["cluster"], plan["rows_per_cta"], plan["point_cap"], plan["entry_cap"],
                plan["point_spill_cap"], plan["entry_spill_cap"], plan["smem_bytes"], stream)
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
