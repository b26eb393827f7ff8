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
kernel-supported (a batch of T % 32 != 0 txns is: the wrapper pads it to
whole 32-txn words with txns that never commit). Nothing falls back. The
plain version on CUDA tensors is
called only to check the kernel against it (``commit_fixpoint_plain``);
``FIXPOINT`` counts both, so a run can show which one its path took.

The stacked entry (``commit_fixpoint_stacked_kernel``, counted by
``FIXPOINT_STACKED``) runs the fixpoint of S key-range sub-shards of one
batch in one launch: the counterpart of JAX's commit_fixpoint_stacked, an
XLA while_loop around the function the Pallas kernel computes. It launches
K clusters cooperatively, each owning whole sub-shards (K = S where the
card holds S clusters at once), joined once a round through a bitmap in
L2 under a grid barrier. ``launch_plan_stacked`` sizes it in plain Python
for a given co-resident cluster count; on the card that count comes from
cudaOccupancyMaxActiveClusters, and a grid the card cannot hold raises.
``supported(cfg, S)`` says which (S, cfg) pairs fit a CTA.
``commit_fixpoint_stacked`` dispatches it by device as ``commit_fixpoint``
does.
"""
from __future__ import annotations

import ctypes
import dataclasses
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
#: fdb_commit_fixpoint_stacked's: 14 inputs, the gid table, the wtx
#: scratch, the cross-cluster bitmaps, the two spill lists, 2 outputs; S, T,
#: Rp, Rr, Wp, Wr, WRW, WPW, G; the plan's 10 ints and the shared memory;
#: the stream
_ARGTYPES_STACKED = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 20 + [ctypes.c_void_p]

#: CTAs in the kernel's cluster: 16, the most a Hopper cluster takes (above
#: the portable 8, so the C entry point sets the non-portable attribute).
#: 16 measured faster than 8 at every shape (PERF.md).
CLUSTER_CTAS = 16
#: cluster sizes the stacked entry chooses among (choose_plan_stacked): an
#: H100 holds 7 clusters of 10-16 CTAs at once, 9 of 9, 15 of 7-8, 17 of 6,
#: 22 of 5, 30 of 4, 39 of 3
STACKED_CLUSTER_SIZES = tuple(range(16, 0, -1))
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

    def __init__(self, entry: str = "fdb_commit_fixpoint",
                 occupancy: str = "fdb_fixpoint_active_clusters", argtypes=None):
        self.launches = 0
        self.graph_launches = 0
        self.plain_cuda_calls = 0
        self.last_rounds: Optional[Tensor] = None
        #: the launch plan of the newest launch (the stacked entry's K and
        #: cluster size depend on the card)
        self.last_plan: Optional[Dict] = None
        self._entry, self._occupancy = entry, occupancy
        self._argtypes = _ARGTYPES if argtypes is None else argtypes
        self._lib = None
        self._schedulable = set()
        self._active: Dict[tuple, int] = {}

    def reset_counts(self) -> None:
        self.launches = 0
        self.graph_launches = 0
        self.plain_cuda_calls = 0

    def lib(self):
        if self._lib is None:
            from ..native import build

            lib = build.load("fixpoint")
            getattr(lib, self._entry).argtypes = self._argtypes
            getattr(lib, self._entry).restype = ctypes.c_int
            occ = getattr(lib, self._occupancy)
            occ.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            occ.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def entry(self):
        """The C entry point this kernel launches through."""
        return getattr(self.lib(), self._entry)

    def active_clusters(self, nc: int, smem_bytes: int, dev: torch.device) -> int:
        """How many clusters of `nc` CTAs with `smem_bytes` of shared memory
        each the card holds at once (cudaOccupancyMaxActiveClusters), asked
        once per card and shape: the engines ask eagerly before they
        capture, since the query must not run under capture."""
        key = (dev.index, nc, smem_bytes)
        if key not in self._active:
            n = ctypes.c_int(0)
            rc = getattr(self.lib(), self._occupancy)(nc, smem_bytes, ctypes.byref(n))
            if rc != 0:
                raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: cudaError_t {rc}")
            self._active[key] = n.value
        return self._active[key]

    def check_schedulable(self, plan: Dict, dev: torch.device) -> None:
        """Raise unless the card can hold one cluster of the plan's shape."""
        key = (dev.index, plan["cluster"], plan["smem_bytes"])
        if key in self._schedulable:
            return
        if self.active_clusters(plan["cluster"], plan["smem_bytes"], dev) < 1:
            raise RuntimeError(
                f"{torch.cuda.get_device_name(dev)} cannot schedule one cluster of "
                f"{plan['cluster']} CTAs of {plan['threads']} threads and {plan['smem_bytes']} "
                "bytes of shared memory each, which the CUDA fixpoint launches")
        self._schedulable.add(key)

    def check_grid(self, plan: Dict, cfg: KernelConfig, dev: torch.device) -> None:
        """Raise ValueError unless the card holds all of the plan's clusters
        at once: the stacked entry's grid barrier needs every CTA resident,
        so a grid that does not fit is refused here, never launched."""
        active = self.active_clusters(plan["cluster"], plan["smem_bytes"], dev)
        if plan["clusters"] > active:
            raise ValueError(
                f"{torch.cuda.get_device_name(dev)} holds {active} clusters of {plan['cluster']} "
                f"CTAs of {plan['threads']} threads and {plan['smem_bytes']} bytes of shared "
                f"memory at once; the stacked CUDA fixpoint at S={plan['sub_shards']}, "
                f"T={cfg.max_txns}, Rp={cfg.rp}, Rr={cfg.max_reads}, Wp={cfg.wp}, "
                f"Wr={cfg.max_writes} asks for {plan['clusters']}")


FIXPOINT = FixpointKernel()
#: the stacked entry's launches, counted apart from the single-table one's
FIXPOINT_STACKED = FixpointKernel("fdb_commit_fixpoint_stacked",
                                  "fdb_fixpoint_stacked_active_clusters", _ARGTYPES_STACKED)


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


def launch_plan_stacked(cfg: KernelConfig, S: int, max_clusters: Optional[int] = None,
                        cluster_ctas: Optional[int] = None) -> Dict:
    """How the stacked entry launches for S sub-shards at `cfg` on a card
    that holds `max_clusters` clusters at once (None: as many as S):
    ``clusters`` = K clusters of ``cluster`` CTAs, cluster k owning the
    ``sub_shards_per_cluster`` = ceil(S / K) sub-shards ``cluster_sub_shards[k]``
    (K = S where the card holds S clusters; else each cluster takes
    ceil(S / max_clusters) of them). Inside a cluster the CTAs split its
    sub-shards' read rows (sub-shard s's point rows, then its range rows,
    then s+1's), ``rows_per_cta`` each, and its point writers,
    ``writers_per_cta`` each, as launch_plan splits one table's.
    ``slices`` and ``writer_slices`` give each CTA of the grid, in grid
    order, its rows of the S * (Rp + Rr) row space and its writers of the
    S * Wp writer space. Shared memory holds launch_plan's fixed part with
    one cluster's writer masks, and its writers' txn indices
    (``wtx_in_smem``) where that fits; else the S * 32 * (WRW + WPW) ints
    are ``wtx_bytes`` of global scratch. The lists and spills follow
    launch_plan's rule, one spill segment per CTA of the grid; the gid
    table has S segments of G + 2 slots; ``gx_bytes`` is the cross-cluster
    bitmap scratch ([3][T/32] words when K > 1).
    Raises ValueError when even the fixed part without the txn indices
    passes the 227 KB a CTA has."""
    nc = CLUSTER_CTAS if cluster_ctas is None else cluster_ctas
    return dict(_plan_stacked(cfg, S, nc, S if max_clusters is None else max_clusters))


def choose_plan_stacked(cfg: KernelConfig, S: int, active: Dict[int, int],
                        card: str = "a card") -> Dict:
    """The stacked entry's plan on a card that holds ``active[nc]`` clusters
    of nc CTAs at once, among the cluster sizes given: one cluster per
    sub-shard at the largest size the card holds S of; where no size does,
    the plan whose busiest cluster has the most CTAs per sub-shard (nc /
    spc: the launch lasts as long as its busiest cluster), a tie going to
    the most CTAs in all. On an H100: 16 CTAs a cluster up to S = 7, 9 at
    S = 8, 6 at S = 16, 3 at S = 32, each faster than every other size
    measured (PERF.md §6). Raises ValueError when no size holds a
    cluster, or a CTA cannot hold the sub-shards each of its clusters must
    take."""
    best, refused = None, []
    for nc in sorted(active, reverse=True):
        if active[nc] < 1:
            refused.append(f"no cluster of {nc} CTAs")
            continue
        try:
            plan = launch_plan_stacked(cfg, S, active[nc], nc)
        except ValueError as e:
            refused.append(str(e))
            continue
        spc = plan["sub_shards_per_cluster"]
        score = (spc == 1, nc / spc, plan["ctas"])
        if best is None or score > best[0]:
            best = (score, plan)
    if best is None:
        raise ValueError(
            f"{card} cannot hold the stacked CUDA fixpoint at S={S}, T={cfg.max_txns} with the "
            f"clusters it holds at once ({active}): " + "; ".join(refused))
    return best[1]


@functools.lru_cache(maxsize=256)
def _plan_stacked(cfg: KernelConfig, S: int, nc: int, max_clusters: int) -> Dict:
    if S < 1:
        raise ValueError(f"the stacked fixpoint needs S >= 1 sub-shards, got {S}")
    if max_clusters < 1:
        raise ValueError(f"the stacked fixpoint needs at least one cluster, got {max_clusters}")
    if not 1 <= nc <= 16:
        raise ValueError(f"a Hopper cluster holds 1 to 16 CTAs, not {nc}")
    T, Rp, Rr, Wp = cfg.max_txns, cfg.rp, cfg.max_reads, cfg.wp
    WRW, WPW = cfg.wr_words, cfg.wp_words
    RA = Rp + Rr
    spc = -(-S // min(S, max_clusters))
    K = -(-S // spc)
    rows_per_cta = -(-(spc * RA) // (32 * nc)) * 32 if RA else 32
    writers_per_cta = -(-(spc * Wp) // nc)
    cluster_sub_shards, slices, writer_slices = [], [], []
    for k in range(K):
        s0 = k * spc
        ns = min(spc, S - s0)
        cluster_sub_shards.append((s0, s0 + ns))
        for r in range(nc):
            g0 = min(r * rows_per_cta, ns * RA)
            w0 = min(r * writers_per_cta, ns * Wp)
            slices.append((s0 * RA + g0, s0 * RA + min(g0 + rows_per_cta, ns * RA)))
            writer_slices.append((s0 * Wp + w0, s0 * Wp + min(w0 + writers_per_cta, ns * Wp)))

    def overlap(g0, g1, lo, hi):
        return max(0, min(g1, hi) - max(g0, lo))

    def sub_shards_of(g0, g1):
        return range(g0 // RA, (g1 - 1) // RA + 1) if g1 > g0 else range(0)

    worst_points = max(sum(overlap(g0, g1, s * RA, s * RA + Rp) for s in sub_shards_of(g0, g1))
                       for g0, g1 in slices)
    worst_entries = max((g1 - g0) * WRW
                        + sum(overlap(g0, g1, s * RA + Rp, (s + 1) * RA)
                              for s in sub_shards_of(g0, g1)) * WPW
                        for g0, g1 in slices)
    words = spc * (WRW + WPW)
    fixed = 4 * (4 + 5 * (T // 32) + words + 2 * writers_per_cta + rows_per_cta)
    if fixed > SMEM_LIMIT:
        raise ValueError(
            f"the stacked CUDA fixpoint needs {fixed} bytes of shared memory per CTA for "
            f"S={S} in {K} clusters, T={T}, {words} mask words; a CTA has {SMEM_LIMIT}")
    if worst_entries >= 2**31:
        raise ValueError(f"{worst_entries} edge words per CTA overflow the kernel's int32 list index")
    wtx_bytes = 4 * 32 * words
    wtx_in_smem = fixed + wtx_bytes <= SMEM_LIMIT
    if wtx_in_smem:
        fixed += wtx_bytes
    point_cap = min(worst_points, (SMEM_LIMIT - fixed) // 2 // POINT_BYTES)
    entry_cap = min(worst_entries, (SMEM_LIMIT - fixed - POINT_BYTES * point_cap) // ENTRY_BYTES)
    point_spill = worst_points - point_cap
    entry_spill = worst_entries - entry_cap
    ctas = K * nc
    return {
        "cluster": nc, "clusters": K, "ctas": ctas, "threads": THREADS, "sub_shards": S,
        "sub_shards_per_cluster": spc, "cluster_sub_shards": cluster_sub_shards,
        "rows_per_cta": rows_per_cta, "slices": slices,
        "writers_per_cta": writers_per_cta, "writer_slices": writer_slices,
        "smem_bytes": fixed + POINT_BYTES * point_cap + ENTRY_BYTES * entry_cap,
        "point_cap": point_cap, "entry_cap": entry_cap,
        "point_spill_cap": point_spill, "entry_spill_cap": entry_spill,
        "point_scratch_bytes": ctas * point_spill * POINT_BYTES,
        "entry_scratch_bytes": ctas * entry_spill * ENTRY_BYTES,
        "wtx_in_smem": wtx_in_smem, "wtx_bytes": 0 if wtx_in_smem else 4 * 32 * S * (WRW + WPW),
        "gx_bytes": 4 * 3 * (T // 32) if K > 1 else 0,
        "gid_table": "global", "gid_table_bytes": 8 * S * (cfg.gid_space + 2),
    }


def supported(cfg: KernelConfig, S: Optional[int] = None) -> bool:
    """Shapes the kernel handles: whole 32-txn words (warp ballots), a gid
    table indexable by int32 (the same rule as the TPU kernel's), and a
    launch plan whose fixed shared memory fits a CTA. `S` asks about the
    stacked entry for S sub-shards (its gid table has S segments), at its
    plan of one cluster per sub-shard: a card that holds fewer clusters
    groups sub-shards, and the launch raises where that plan does not fit;
    None asks about the single-table entry."""
    segments = 1 if S is None else S
    if cfg.max_txns % 32 or 2 * segments * (cfg.gid_space + 2) >= 2**31:
        return False
    try:
        launch_plan(cfg) if S is None else launch_plan_stacked(cfg, S)
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


def _whole_words(cfg: KernelConfig, t_ok: Tensor, hist: Tensor):
    """A batch of T % 32 != 0 txns as one of whole 32-txn words (the
    kernel's warp ballots): the config widened to the next multiple of 32,
    t_ok and the history hits ([T], or [S, T] stacked) padded with txns
    that never commit and that no row names. The caller drops the padding
    from the result; nothing else of the batch depends on T."""
    T = cfg.max_txns
    pad = -T % 32
    _check("t_ok", t_ok, (T,), torch.bool, t_ok.device)
    _check("hist", hist, tuple(hist.shape[:-1]) + (T,), torch.int32, t_ok.device)
    t_ok = torch.cat([t_ok, t_ok.new_zeros(pad)])
    hist = torch.cat([hist, hist.new_zeros(tuple(hist.shape[:-1]) + (pad,))], dim=-1)
    return dataclasses.replace(cfg, max_txns=T + pad), t_ok, hist.contiguous()


def commit_fixpoint_kernel(cfg: KernelConfig, t_ok: Tensor, hist_hits: Tensor,
                           edges: Dict[str, Tensor], batch: Dict) -> Tensor:
    """committed bool [T] from the CUDA kernel, on PyTorch's current stream
    (a T that is not a whole number of 32-txn words runs padded to one)."""
    if not t_ok.is_cuda:
        raise ValueError("commit_fixpoint_kernel needs CUDA tensors")
    if cfg.max_txns % 32:
        wide, t_ok, hist_hits = _whole_words(cfg, t_ok, hist_hits)
        return commit_fixpoint_kernel(wide, t_ok, hist_hits, edges, batch)[:cfg.max_txns]
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
    fn = FIXPOINT.entry()
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


def commit_fixpoint_stacked_plain(cfg: KernelConfig, t_ok: Tensor, hist_stacked: Tensor,
                                  edges: Dict[str, Tensor], batch: Dict) -> Tensor:
    """The stacked entry's plain version (conflict_kernel's)."""
    if t_ok.is_cuda:
        FIXPOINT_STACKED.plain_cuda_calls += 1
    return ck.commit_fixpoint_stacked(cfg, t_ok, hist_stacked, edges, batch)


def commit_fixpoint_stacked_kernel(cfg: KernelConfig, t_ok: Tensor, hist_stacked: Tensor,
                                   edges: Dict[str, Tensor], batch: Dict) -> Tensor:
    """committed bool [T] for S sub-shards (hist_stacked [S, T], edges and
    batch leaves [S, ...], t_ok [T]) from ONE launch of the CUDA kernel's
    stacked entry, on PyTorch's current stream (a T that is not a whole
    number of 32-txn words runs padded to one). The plan is
    choose_plan_stacked's over STACKED_CLUSTER_SIZES for what the card
    holds at once; a grid the card cannot hold raises ValueError before
    any launch."""
    if not t_ok.is_cuda:
        raise ValueError("commit_fixpoint_stacked_kernel needs CUDA tensors")
    # the kernel reads the history hits as one dense [S, T] array; the
    # batched phases leave them as a view with a dustbin column per row
    hist_stacked = hist_stacked.contiguous()
    if cfg.max_txns % 32 and hist_stacked.dim() == 2:
        wide, t_ok, hist_stacked = _whole_words(cfg, t_ok, hist_stacked)
        return commit_fixpoint_stacked_kernel(wide, t_ok, hist_stacked, edges,
                                              batch)[:cfg.max_txns]
    S = hist_stacked.shape[0] if hist_stacked.dim() == 2 else -1
    if S < 1 or not supported(cfg, S):
        raise ValueError(
            f"the stacked CUDA fixpoint does not support S={S} at this config (need "
            "max_txns % 32 == 0, 2*S*(gid_space+2) < 2^31 and the launch plan's shared "
            "memory within a CTA's)")
    dev = t_ok.device
    T, Rp, Rr, Wp, Wr = cfg.max_txns, cfg.rp, cfg.max_reads, cfg.wp, cfg.max_writes
    WRW, WPW, G = cfg.wr_words, cfg.wp_words, cfg.gid_space
    i32, b = torch.int32, torch.bool
    ins = [
        _check("t_ok", t_ok, (T,), b, dev),
        _check("hist", hist_stacked, (S, T), i32, dev),
        _check("rp_txn", batch["rp_txn"], (S, Rp), i32, dev),
        _check("rp_valid", batch["rp_valid"], (S, Rp), b, dev),
        _check("gid_rp", edges["gid_rp"], (S, Rp), i32, dev),
        _check("r_txn", batch["r_txn"], (S, Rr), i32, dev),
        _check("r_valid", batch["r_valid"], (S, Rr), b, dev),
        _check("wp_txn", batch["wp_txn"], (S, Wp), i32, dev),
        _check("wp_valid", batch["wp_valid"], (S, Wp), b, dev),
        _check("gid_wp", edges["gid_wp"], (S, Wp), i32, dev),
        _check("w_txn", batch["w_txn"], (S, Wr), i32, dev),
        _check("w_valid", batch["w_valid"], (S, Wr), b, dev),
        _check("ovw", edges["ovw"], (S, cfg.r_all, WRW), i32, dev),
        _check("ovrp", edges["ovrp"], (S, Rr, WPW), i32, dev),
    ]
    with torch.cuda.device(dev):
        # asked at the most shared memory a plan may take: a CTA of 1024
        # threads holds its SM either way
        active = {nc: FIXPOINT_STACKED.active_clusters(nc, SMEM_LIMIT, dev)
                  for nc in STACKED_CLUSTER_SIZES}
        plan = choose_plan_stacked(cfg, S, active, torch.cuda.get_device_name(dev))
        FIXPOINT_STACKED.check_grid(plan, cfg, dev)
        fn = FIXPOINT_STACKED.entry()
        # one scratch buffer: the S * (G+2) gid table, the wtx ints, the
        # cross-cluster bitmaps, both spills
        at = [0]

        def take(nbytes):
            off = at[0]
            at[0] = off + -(-nbytes // 16) * 16
            return off

        gid_at = take(8 * S * (G + 2))
        wtx_at = take(plan["wtx_bytes"])
        gx_at = take(plan["gx_bytes"])
        entry_at = take(plan["entry_scratch_bytes"])
        point_at = take(plan["point_scratch_bytes"])
        scratch = torch.empty(max(at[0], 16), dtype=torch.uint8, device=dev)
        committed = torch.empty(T, dtype=b, device=dev)
        rounds = torch.empty(1, dtype=i32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        p = scratch.data_ptr()
        rc = fn(*[x.data_ptr() for x in ins], p + gid_at, p + wtx_at, p + gx_at, p + entry_at,
                p + point_at, committed.data_ptr(), rounds.data_ptr(),
                S, T, Rp, Rr, Wp, Wr, WRW, WPW, G,
                plan["clusters"], plan["cluster"], plan["sub_shards_per_cluster"],
                plan["rows_per_cta"], plan["writers_per_cta"], plan["point_cap"],
                plan["entry_cap"], plan["point_spill_cap"], plan["entry_spill_cap"],
                int(plan["wtx_in_smem"]), plan["smem_bytes"], stream)
    if rc != 0:
        raise RuntimeError(f"fdb_commit_fixpoint_stacked launch failed: cudaError_t {rc}")
    FIXPOINT_STACKED.launches += 1
    FIXPOINT_STACKED.last_rounds = rounds
    FIXPOINT_STACKED.last_plan = plan
    return committed


def commit_fixpoint_stacked(cfg: KernelConfig, t_ok: Tensor, hist_stacked: Tensor,
                            edges: Dict[str, Tensor], batch: Dict) -> Tensor:
    """The stacked fixpoint on the tensors' device: CPU -> plain version,
    CUDA -> the stacked entry (raising on an unsupported (S, cfg))."""
    if t_ok.device.type == "cpu":
        return ck.commit_fixpoint_stacked(cfg, t_ok, hist_stacked, edges, batch)
    return commit_fixpoint_stacked_kernel(cfg, t_ok, hist_stacked, edges, batch)


def commit_fixpoint(cfg: KernelConfig, t_ok: Tensor, hist_hits: Tensor,
                    edges: Dict[str, Tensor], batch: Dict) -> Tensor:
    """The fixpoint on the tensors' device: CPU -> plain version, CUDA ->
    kernel (raising on an unsupported config, never falling back)."""
    if t_ok.device.type == "cpu":
        return ck.commit_fixpoint(cfg, t_ok, hist_hits, edges, batch)
    return commit_fixpoint_kernel(cfg, t_ok, hist_hits, edges, batch)
