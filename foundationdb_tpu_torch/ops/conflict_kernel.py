"""Batched conflict detection in PyTorch — the resolver's conflict step.

Port of ``foundationdb_tpu/ops/conflict_kernel.py`` (monolithic and tiered
history, keyspace heat). The step is the same fixed-shape program:

  local_phases        reads vs history (phase 1) + intra-batch overlap
                      edges (phase 2), in ``fused_sort`` or ``bsearch`` mode;
                      under the tiered structure every run is probed too
  commit fixpoint     earlier-in-batch-wins verdicts; a CUDA kernel on the
                      card (fixpoint_cuda.py), the plain torch loop below on
                      the CPU
  apply_writes_and_gc committed-write union, then either the boundary-table
                      merge + GC/rebase (monolithic) or the run append,
                      elementwise GC rebase and lazy run merge (tiered)
  status_of           per-transaction verdict codes
  heat_of             the per-batch keyspace-heat aggregate (cfg.heat_buckets
                      > 0): a read/write/conflict histogram over boundary
                      keys sampled from the table, verdict counts and the
                      first-witness abort attribution
  resolve_step_scan   C same-shape batches as one program, threading the
                      table through (the engine captures it as a CUDA graph)
  resolve_server_loop the filled prefix of a Q-chunk queue slot as one
                      program whose chunk count is a device scalar (the
                      loop engine captures it with a CUDA graph WHILE node)

Every output equals the JAX function's element for element, padding rows
included (tests/test_torch_conflict_kernel.py).

Representation. Packed keys travel as int64 tensors [N, K] holding the
zero-extended uint32 words: torch has no `<`, `>>`, sort or searchsorted for
uint32, and int64 keeps the all-ones sentinel 0xFFFFFFFF (invalid rows)
sorting after every real key word. Versions, txn indices, group ids and bit
words are int32 as in the JAX package; bit words hold the uint32 bits of the
JAX words (``Tensor.view`` reinterprets them). Positions and counts are
int64 inside a function (torch's index type) and int32 at its outputs.
``now`` and ``gc`` are 0-d int32 tensors in the batch dict, so a captured
CUDA graph reads them from its input buffers at every replay. The GC
branch (JAX's ``lax.cond(gc > 0, ...)``) is chosen on the host: every
caller passes ``gc_branch``, the host's answer to ``gc > 0``, so the step
never reads ``gc`` back from the card.

JAX semantics the port reproduces explicitly:
  * out-of-range gathers clamp (after wrapping a negative index once) —
    ``_take``; torch raises instead, and on CUDA that is a device-side
    assert that kills the process;
  * ``.at[].set/add/max/min(mode="drop")`` scatters drop out-of-range
    indices — every scatter here targets a buffer with one extra dustbin
    slot (``_drop``) that is sliced off;
  * ``torch.cumsum``/``sum`` of int32 return int64 — cast back at outputs.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.types import TransactionCommitResult
from . import graph_if, keypack

NEG_VERSION = -(2**30)
#: all-ones uint32 key word: no real key reaches length 2^32-1, so rows
#: carrying it sort after every real key (int64 keeps it positive)
U32_ALL = 0xFFFFFFFF

HISTORY_SEARCH_MODES = ("fused_sort", "bsearch", "auto")
HISTORY_STRUCTURES = ("monolithic", "tiered")

Tensor = torch.Tensor


@dataclass(frozen=True)
class KernelConfig:
    """The JAX package's KernelConfig without its ``fixpoint`` switch: the
    port dispatches the fixpoint on the tensors' device (CPU -> plain
    version, CUDA -> kernel), never on a config string. Every other field
    converts from a JAX-built config field for field."""

    key_words: int = 4          # exact-compare width = 4*key_words bytes
    capacity: int = 1 << 16     # H: max boundaries in the interval table
    max_reads: int = 1 << 12    # Rr: RANGE read rows per device batch
    max_writes: int = 1 << 12   # Wr: RANGE write rows per device batch
    max_txns: int = 1 << 12     # T: transactions per device batch
    max_point_reads: int = -1   # Rp: POINT read rows (-1: same as max_reads)
    max_point_writes: int = -1  # Wp: POINT write rows (-1: same as max_writes)
    history_search: str = "auto"
    heat_buckets: int = 0
    history_structure: str = "monolithic"
    history_runs: int = 8
    history_run_rows: int = 0

    @property
    def lanes(self) -> int:     # K: words per packed key incl. length
        return self.key_words + 1

    @property
    def rp(self) -> int:
        return self.max_point_reads if self.max_point_reads >= 0 else self.max_reads

    @property
    def wp(self) -> int:
        return self.max_point_writes if self.max_point_writes >= 0 else self.max_writes

    @property
    def r_all(self) -> int:     # total read rows (point ++ range)
        return self.rp + self.max_reads

    @property
    def w_all(self) -> int:     # total write rows (point ++ range)
        return self.wp + self.max_writes

    @property
    def wr_words(self) -> int:  # RANGE write rows as 32-bit words
        return (self.max_writes + 31) // 32

    @property
    def wp_words(self) -> int:  # POINT write rows as 32-bit words
        return (self.wp + 31) // 32

    @property
    def batch_rows(self) -> int:  # rows the fused sort adds to the table
        return self.rp + 3 * self.max_reads + self.wp + 2 * self.max_writes

    @property
    def gid_space(self) -> int:  # upper bound on per-key group ids
        return self.capacity + self.batch_rows

    @property
    def levels(self) -> int:    # sparse-table levels
        return int(math.ceil(math.log2(self.capacity))) + 1

    @property
    def run_slots(self) -> int:
        return self.history_runs

    @property
    def run_rows(self) -> int:
        return self.history_run_rows if self.history_run_rows > 0 else 2 * self.w_all

    @property
    def run_levels(self) -> int:
        return int(math.ceil(math.log2(max(2, self.run_rows)))) + 1

    def bucket(self, t: int) -> "KernelConfig":
        """Sub-capacity clone: batch-side shapes scale down to `t`
        transactions (row caps pro rata, rounded up to a multiple of 32)
        while the capacity-sized table stays shape-invariant. t == max_txns
        returns self."""
        if t == self.max_txns:
            return self
        if not (0 < t < self.max_txns):
            raise ValueError(f"bucket size {t} outside (0, {self.max_txns}]")
        if t % 32:
            raise ValueError(f"bucket size {t} must be a multiple of 32")

        def scale(rows: int) -> int:
            if rows <= 0:
                return rows
            return min(rows, max(32, -(-rows * t // self.max_txns) + 31 & ~31))

        return KernelConfig(
            key_words=self.key_words,
            capacity=self.capacity,
            max_reads=scale(self.max_reads),
            max_writes=scale(self.max_writes),
            max_txns=t,
            max_point_reads=scale(self.rp),
            max_point_writes=scale(self.wp),
            history_search=self.history_search,
            heat_buckets=self.heat_buckets,
            history_structure=self.history_structure,
            history_runs=self.history_runs,
            history_run_rows=self.run_rows,
        )


def pick_history_search(cfg: KernelConfig) -> str:
    """The `auto` rule: bsearch when the batch rows are at most a quarter of
    the boundary table, else the fused sort."""
    return "bsearch" if cfg.batch_rows * 4 <= cfg.capacity else "fused_sort"


def resolved_history_search(cfg: KernelConfig) -> str:
    """Concrete mode ("fused_sort" | "bsearch") a given config runs."""
    mode = cfg.history_search
    if mode not in HISTORY_SEARCH_MODES:
        raise ValueError(
            f"unknown history_search mode {mode!r}; expected one of "
            f"{HISTORY_SEARCH_MODES}")
    return pick_history_search(cfg) if mode == "auto" else mode


def resolved_history_structure(cfg: KernelConfig) -> str:
    """Concrete structure ("monolithic" | "tiered"), with the tiered
    geometry checked as the JAX package checks it (same messages)."""
    structure = cfg.history_structure
    if structure not in HISTORY_STRUCTURES:
        raise ValueError(
            f"unknown history_structure {structure!r}; expected one of "
            f"{HISTORY_STRUCTURES}")
    if structure == "tiered":
        if cfg.history_runs < 2:
            raise ValueError(
                f"history_runs={cfg.history_runs} must be >= 2 for the "
                f"tiered structure (one slot would merge on every batch — "
                f"strictly worse than monolithic — and the heat-borne run "
                f"accounting could not distinguish append from merge)")
        if cfg.run_rows < 2 * cfg.w_all:
            raise ValueError(
                f"history_run_rows={cfg.run_rows} cannot hold one batch's "
                f"committed-write union (needs >= 2*w_all = {2 * cfg.w_all})")
    return structure


def is_tiered(cfg: KernelConfig) -> bool:
    return resolved_history_structure(cfg) == "tiered"


def check_supported(cfg: KernelConfig) -> None:
    """Raise on a config the port does not run: an unknown search mode or
    structure, or a tiered geometry the JAX package rejects."""
    resolved_history_search(cfg)
    resolved_history_structure(cfg)


# ---------------------------------------------------------------------------
# JAX gather / scatter semantics
# ---------------------------------------------------------------------------

def _take(x: Tensor, idx: Tensor) -> Tensor:
    """x[idx] along dim 0 with JAX's out-of-range rule: a negative index
    wraps once, then the index clamps into [0, len-1]. Known clamp sites:
    _present at s == n == H (a full table whose last row sorts before the
    query), eq_wpb2's s_wpb + eq_wpb, and _lower_bound_n's frozen lanes."""
    n = x.shape[0]
    idx = torch.where(idx < 0, idx + n, idx).clamp_(0, n - 1)
    return x[idx]


def _drop(idx: Tensor, n: int) -> Tensor:
    """Scatter index with JAX's mode="drop": out-of-range -> dustbin n."""
    return torch.where((idx >= 0) & (idx < n), idx, n)


def _i32(x: Tensor) -> Tensor:
    return x.to(torch.int32)


def _u32_to_i32(x: Tensor) -> Tensor:
    """int64 holding a uint32 value -> int32 with the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _arange(n: int, dev) -> Tensor:
    return torch.arange(n, dtype=torch.int64, device=dev)


# ---------------------------------------------------------------------------
# packed-key helpers
# ---------------------------------------------------------------------------

def _key_less(a: Tensor, b: Tensor) -> Tensor:
    """Lexicographic a < b over the trailing lane axis (the first differing
    lane decides, as the JAX argmax form does)."""
    less = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    for c in range(a.shape[-1] - 1, -1, -1):
        ac, bc = a[..., c], b[..., c]
        less = (ac < bc) | ((ac == bc) & less)
    return less


def _key_eq(a: Tensor, b: Tensor) -> Tensor:
    return torch.all(a == b, dim=-1)


def _bump(q: Tensor) -> Tensor:
    """Successor of a packed key in packed order: (words, len) -> (words,
    len+1), with the uint32 wrap of the JAX add."""
    return torch.cat([q[..., :-1], (q[..., -1:] + 1) & U32_ALL], dim=-1)


def _present(table: Tensor, q: Tensor, s: Tensor) -> Tensor:
    """1 iff q occurs in the table, given s = lower_bound(q): one row gather
    (clamped at s == H). upper_bound(q) == s + _present(table, q, s)."""
    return _key_eq(_take(table, s), q).to(torch.int64)


def _lower_bound(cfg: KernelConfig, hkeys: Tensor, n: Tensor, q: Tensor) -> Tensor:
    return _lower_bound_n(hkeys, n, q, cfg.levels)


def _lower_bound_n(table: Tensor, n: Tensor, q: Tensor, levels: int) -> Tensor:
    """Branchless K-word binary search: lower_bound of every query row into
    the key-sorted valid prefix table[0:n], all queries in lockstep for
    `levels` rounds. A converged lane (lo == hi == n) may probe row n == H:
    the JAX gather clamps it, and so does _take."""
    lo = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    hi = lo + n.to(torch.int64)
    for _ in range(levels):
        active = lo < hi
        mid = (lo + hi) >> 1
        go_right = _key_less(_take(table, mid), q)
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def _build_sparse_max(cfg: KernelConfig, vers: Tensor, n: Tensor) -> Tensor:
    return _build_sparse_max_n(vers, n, cfg.capacity, cfg.levels)


def _build_sparse_max_n(vers: Tensor, n: Tensor, h: int, n_levels: int) -> Tensor:
    """out[k, i] = max(vers[i : i+2^k]) with invalid slots -> NEG."""
    dev = vers.device
    base = torch.where(_arange(h, dev) < n.to(torch.int64), vers,
                       torch.full_like(vers, NEG_VERSION))
    levels = [base]
    for k in range(1, n_levels):
        half = 1 << (k - 1)
        prev = levels[-1]
        shifted = torch.cat([prev[half:], torch.full((half,), NEG_VERSION,
                                                     dtype=prev.dtype, device=dev)])
        levels.append(torch.maximum(prev, shifted))
    return torch.stack(levels)


def _bit_length(v: Tensor) -> Tensor:
    """Bit length of int64 values in [0, 2^32) by a 5-step binary search —
    the port of ``31 - lax.clz`` (a float log2 would round wrongly)."""
    n = torch.zeros_like(v)
    for sh in (16, 8, 4, 2, 1):
        big = (v >> sh) > 0
        n = n + torch.where(big, sh, 0)
        v = torch.where(big, v >> sh, v)
    return n + (v > 0).to(v.dtype)


def _range_max(cfg: KernelConfig, sparse: Tensor, lo: Tensor, hi: Tensor) -> Tensor:
    return _range_max_n(sparse, lo, hi, cfg.capacity)


def _range_max_n(sparse: Tensor, lo: Tensor, hi: Tensor, h: int) -> Tensor:
    """max(vers[lo:hi]) for hi > lo, via two overlapping power-of-two
    blocks. For hi == lo the JAX form gets k = -1 (clz(0) = 32) and a
    negative, wrapped index; the same arithmetic and _take reproduce it."""
    s = (hi - lo) & U32_ALL
    k = _bit_length(s) - 1
    flat = sparse.reshape(-1)
    pw = torch.where(k >= 0, torch.ones_like(k) << k.clamp(min=0), 0)
    m1 = _take(flat, k * h + lo)
    m2 = _take(flat, k * h + hi - pw)
    return torch.maximum(m1, m2)


def _pack_bits(bits: Tensor, n_words: int) -> Tensor:
    """Pack a [..., W] bool tensor into [..., n_words] int32 words holding
    the uint32 bits of JAX's _pack_bits (bit j of word i = column 32i+j).
    The JAX sum runs in uint32; here the OR of the bits runs in int64 and
    the low 32 bits are kept in an int32 word."""
    w = bits.shape[-1]
    pad = 32 * n_words - w
    if pad:
        bits = torch.cat([bits, torch.zeros(bits.shape[:-1] + (pad,), dtype=torch.bool,
                                            device=bits.device)], dim=-1)
    b = bits.reshape(bits.shape[:-1] + (n_words, 32))
    acc = torch.zeros(b.shape[:-1], dtype=torch.int64, device=bits.device)
    for j in range(32):
        acc |= b[..., j].to(torch.int64) << j
    return _u32_to_i32(acc)


def _lex_sort_perm(cols: List[Tensor]) -> Tensor:
    """Permutation sorting rows by the int64 columns `cols` (each holding
    uint32 values) lexicographically — the port of
    ``lax.sort(ops, num_keys=len(ops))``. torch has no multi-key sort, so
    this runs stable LSD passes of torch.sort from the last key to the
    first. Two uint32 columns fuse into one int64 key,
    (hi - 2^31) * 2^32 + lo, whose signed order is their lexicographic
    order, so K+1 operands take ceil((K+1)/2) passes. The callers' last
    operand (code | original index) is unique per row, so the order is total
    and the permutation equals JAX's exactly."""
    keys = []
    for i in range(0, len(cols) - 1, 2):
        keys.append((cols[i] - 2**31) * 2**32 + cols[i + 1])
    if len(cols) % 2:
        keys.append(cols[-1])
    perm = None
    for k in reversed(keys):
        v = k if perm is None else k[perm]
        order = torch.sort(v, stable=True).indices
        perm = order if perm is None else perm[order]
    return perm


def _inverse_perm(perm: Tensor) -> Tensor:
    pos = torch.empty_like(perm)
    pos[perm] = _arange(perm.shape[0], perm.device)
    return pos


def _group_ids(skeys: Tensor) -> Tensor:
    """1-based per-key group ids of key-sorted rows: a new group starts
    where a row's key differs from its predecessor's."""
    new = torch.ones(skeys.shape[0], dtype=torch.bool, device=skeys.device)
    new[1:] = torch.any(skeys[1:] != skeys[:-1], dim=-1)
    return torch.cumsum(new, 0)


def _sorted_rows(keys: Tensor, codes: Tensor, valid: Tensor):
    """One lexicographic sort of rows by (key words, tie code, index):
    invalid rows carry all-ones keys and code 7. Returns (perm, sorted
    keys)."""
    N, K = keys.shape
    dev = keys.device
    idx_bits = max(1, (N - 1).bit_length())
    keys_eff = torch.where(valid[:, None], keys, U32_ALL)
    codeidx = (torch.where(valid, codes, 7) << idx_bits) | _arange(N, dev)
    perm = _lex_sort_perm([keys_eff[:, c] for c in range(K)] + [codeidx])
    return perm, keys_eff[perm]


# ---------------------------------------------------------------------------
# the tiered structure's run probe
# ---------------------------------------------------------------------------

def _take_rows(x: Tensor, idx: Tensor) -> Tensor:
    """Per-run _take: x [NR, N, ...], idx [NR, Q] -> x[j, idx[j, q]] with
    JAX's clamp inside each run's own N rows, as the JAX probe's per-run
    gathers clamp."""
    nr, n = x.shape[0], x.shape[1]
    idx = torch.where(idx < 0, idx + n, idx).clamp_(0, n - 1)
    flat = x.reshape((nr * n,) + tuple(x.shape[2:]))
    return flat[idx + _arange(nr, x.device)[:, None] * n]


def _lower_bound_runs(tables: Tensor, n: Tensor, q: Tensor, levels: int) -> Tensor:
    """_lower_bound_n of the same queries into every run at once: tables
    [NR, RC, K] with valid prefixes n [NR], q [Q, K] -> [NR, Q]. One [NR,
    Q, K] gather a round instead of NR gathers."""
    nr = tables.shape[0]
    lo = torch.zeros((nr, q.shape[0]), dtype=torch.int64, device=q.device)
    hi = lo + n.to(torch.int64)[:, None]
    for _ in range(levels):
        active = lo < hi
        mid = (lo + hi) >> 1
        go_right = _key_less(_take_rows(tables, mid), q[None])
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def _build_sparse_max_runs(vers: Tensor, n: Tensor, n_levels: int) -> Tensor:
    """_build_sparse_max_n of every run at once: vers [NR, RC], n [NR] ->
    [NR, n_levels, RC]."""
    nr, rc = vers.shape
    dev = vers.device
    base = torch.where(_arange(rc, dev)[None, :] < n.to(torch.int64)[:, None], vers,
                       torch.full_like(vers, NEG_VERSION))
    levels = [base]
    for k in range(1, n_levels):
        half = 1 << (k - 1)
        prev = levels[-1]
        shifted = torch.cat([prev[:, half:], torch.full((nr, half), NEG_VERSION,
                                                        dtype=prev.dtype, device=dev)], dim=1)
        levels.append(torch.maximum(prev, shifted))
    return torch.stack(levels, dim=1)


def _tiered_read_probe(cfg: KernelConfig, state: Dict[str, Tensor], rpb: Tensor,
                       rp_valid: Tensor, rb: Tensor, re: Tensor, r_valid: Tensor,
                       empty_r: Tensor) -> Tuple[Tensor, Tensor]:
    """The runs' history answers for both read classes: (point_max [Rp],
    range_max [Rr]), max-folded into the base table's answers before any
    hit. The JAX function loops over the NR runs; here all runs are probed
    in one batched pass ([NR, Q, K] gathers, an [NR, levels, RC] sparse
    table) with the same values. Each run is a mini interval table whose
    rows alternate (union-begin, now) / (union-end, NEG gap); a run has no
    minimal-key row, so an upper bound of 0 or an empty row window answers
    NEG — except an empty read at b'', which takes the run's row AT b''
    (the oracle clamps its predecessor scan to the minimal key)."""
    RC, levels = cfg.run_rows, cfg.run_levels
    Rp, Rr = cfg.rp, cfg.max_reads
    rkeys, rvers, rn = state["rkeys"], state["rvers"], state["rn"]

    qvalid = torch.cat([rp_valid, r_valid, r_valid, r_valid])
    qkeys = torch.cat([rpb, rb, _bump(rb), re])
    q_eff = torch.where(qvalid[:, None], qkeys, U32_ALL)
    lb = _lower_bound_runs(rkeys, rn, q_eff, levels)                  # [NR, Q]
    lb_p, lb_b, lb_bb, lb_e = torch.split(lb, [Rp, Rr, Rr, Rr], dim=1)

    # point read: value at k = vers[upper(k) - 1], NEG before the run
    up_p = lb_p + _key_eq(_take_rows(rkeys, lb_p), rpb[None]).to(torch.int64)
    vp = torch.where(up_p > 0, _take_rows(rvers, torch.clamp(up_p - 1, min=0)),
                     NEG_VERSION).amax(dim=0)
    if Rr == 0:
        return vp, torch.full((0,), NEG_VERSION, dtype=torch.int32, device=vp.device)
    sparse = _build_sparse_max_runs(rvers, rn, levels)               # [NR, L, RC]
    is_min = torch.all(rb == 0, dim=-1)         # q == b'' (packed zero)
    eq_b = _key_eq(_take_rows(rkeys, lb_b), rb[None]).to(torch.int64)
    s_qlo = torch.where(empty_r, lb_b + torch.where(is_min, eq_b, 0), lb_bb)
    lo = torch.clamp(s_qlo - 1, min=0)
    hi = torch.where(empty_r, s_qlo, lb_e)
    # _range_max_n per run: indices clamp inside the run's own flat table
    hi1 = torch.maximum(hi, lo + 1)
    k = _bit_length((hi1 - lo) & U32_ALL) - 1
    pw = torch.where(k >= 0, torch.ones_like(k) << k.clamp(min=0), 0)
    flat = sparse.reshape(sparse.shape[0], -1, 1)
    m1 = _take_rows(flat, k * RC + lo)[..., 0]
    m2 = _take_rows(flat, k * RC + hi1 - pw)[..., 0]
    vr = torch.where(hi > lo, torch.maximum(m1, m2), NEG_VERSION).amax(dim=0)
    return vp, vr


# ---------------------------------------------------------------------------
# phases 1-2
# ---------------------------------------------------------------------------

def local_phases(cfg: KernelConfig, state: Dict[str, Tensor], batch: Dict):
    """Phases 1-2: reads vs history + intra-batch overlap edges.

    Returns (hist_hits int32 [T], edges, wpos) exactly as the JAX function:
    edges = {"ovw" int32 [r_all, wr_words], "ovrp" int32 [Rr, wp_words],
    "gid_rp" int32 [Rp], "gid_wp" int32 [Wp]} and wpos = {"lo_b", "lo_e",
    "up_e"} int32 [w_all]. See the JAX docstring for the tie-code ladder
    (end-read 0 < end-write 1 < begin-write 2 < {begin-read, point-read} 3
    < point-write 4 < table 5) that makes position compares exact
    half-open interval logic."""
    check_supported(cfg)
    hkeys, hvers, n = state["hkeys"], state["hvers"], state["n"]
    dev = hkeys.device
    Rp, Rr = cfg.rp, cfg.max_reads
    Wp, Wr = cfg.wp, cfg.max_writes
    T, H = cfg.max_txns, cfg.capacity
    n64 = n.to(torch.int64)

    rpb = batch["rpb"]
    rb, re = batch["rb"], batch["re"]
    wpb = batch["wpb"]
    wb, we = batch["wb"], batch["we"]
    rp_valid, r_valid = batch["rp_valid"], batch["r_valid"]
    wp_valid, w_valid = batch["wp_valid"], batch["w_valid"]
    rp_txn, r_txn = batch["rp_txn"].long(), batch["r_txn"].long()
    wp_txn, w_txn = batch["wp_txn"].long(), batch["w_txn"].long()
    empty_r = ~_key_less(rb, re)

    def codes(groups):
        return torch.cat([torch.full((g[0].shape[0],), g[1], dtype=torch.int64, device=dev)
                          for g in groups])

    mode = resolved_history_search(cfg)
    if mode == "fused_sort":
        # ONE sort of table ++ batch rows: table rows sort after every equal
        # batch key, so a batch row's lower bound is the count of valid
        # table rows before its sorted position. bump(rb) rows ride along
        # to give upper(rb) for non-empty range reads.
        groups = (
            (rpb, 3, rp_valid), (rb, 3, r_valid), (re, 0, r_valid),
            (_bump(rb), 0, r_valid), (wpb, 4, wp_valid),
            (wb, 2, w_valid), (we, 1, w_valid),
        )
        keys_all = torch.cat([hkeys] + [g[0] for g in groups])
        code_all = torch.cat([torch.full((H,), 5, dtype=torch.int64, device=dev),
                              codes(groups)])
        valid_all = torch.cat([_arange(H, dev) < n64] + [g[2] for g in groups])
        perm, skeys = _sorted_rows(keys_all, code_all, valid_all)
        pos = _inverse_perm(perm)
        is_tab = (perm < H) & (perm < n64)
        cum_tab = torch.cumsum(is_tab, 0)
        gid_sorted = _group_ids(skeys)
        bpos = pos[H:]
        lb = cum_tab[bpos]
        gid = gid_sorted[bpos]
        pos_rpb, pos_rb, pos_re, _, pos_wpb, pos_wb, pos_we = torch.split(
            bpos, [Rp, Rr, Rr, Rr, Wp, Wr, Wr])
        lb_rp, lb_rb, s_re, lb_rbb, s_wpb, s_wb, s_we = torch.split(
            lb, [Rp, Rr, Rr, Rr, Wp, Wr, Wr])
        gid_rp = gid[:Rp]
        gid_wp = gid[Rp + 3 * Rr:Rp + 3 * Rr + Wp]
    else:
        # Sort only the batch rows (same ladder minus table and bump rows)
        # and recover every lower bound by binary search into hkeys[0:n].
        groups = (
            (rpb, 3, rp_valid), (rb, 3, r_valid), (re, 0, r_valid),
            (wpb, 4, wp_valid), (wb, 2, w_valid), (we, 1, w_valid),
        )
        perm, skeys = _sorted_rows(torch.cat([g[0] for g in groups]), codes(groups),
                                   torch.cat([g[2] for g in groups]))
        pos = _inverse_perm(perm)
        gid = _group_ids(skeys)[pos]
        pos_rpb, pos_rb, pos_re, pos_wpb, pos_wb, pos_we = torch.split(
            pos, [Rp, Rr, Rr, Wp, Wr, Wr])
        gid_rp = gid[:Rp]
        gid_wp = gid[Rp + 2 * Rr:Rp + 2 * Rr + Wp]
        qvalid = torch.cat([rp_valid, r_valid, r_valid, r_valid, wp_valid, w_valid, w_valid])
        qkeys = torch.cat([rpb, rb, _bump(rb), re, wpb, wb, we])
        q_eff = torch.where(qvalid[:, None], qkeys, U32_ALL)
        lb = _lower_bound(cfg, hkeys, n, q_eff)
        lb_rp, lb_rb, lb_rbb, s_re, s_wpb, s_wb, s_we = torch.split(
            lb, [Rp, Rr, Rr, Rr, Wp, Wr, Wr])
    s_rp = lb_rp

    # Equality gathers (one table row each) derive every upper bound.
    eq_rp = _present(hkeys, rpb, s_rp)
    eq_wpb = _present(hkeys, wpb, s_wpb)
    eq_we = _present(hkeys, we, s_we)
    eq_wpb2 = _present(hkeys, _bump(wpb), s_wpb + eq_wpb)

    # Write-interval endpoint positions in the OLD table, for the apply.
    wpos = {
        "lo_b": _i32(torch.cat([s_wpb, s_wb])),
        "lo_e": _i32(torch.cat([s_wpb + eq_wpb, s_we])),
        "up_e": _i32(torch.cat([s_wpb + eq_wpb + eq_wpb2, s_we + eq_we])),
    }

    # ---- Phase 1: reads vs. history ----
    # Tiered: every run's answer folds into the base table's before any hit.
    tiered = is_tiered(cfg)
    if tiered:
        run_vp, run_vr = _tiered_read_probe(cfg, state, rpb, rp_valid, rb, re, r_valid,
                                            empty_r)
    vmax_p = _take(hvers, torch.clamp(s_rp + eq_rp - 1, min=0))
    if tiered:
        vmax_p = torch.maximum(vmax_p, run_vp)
    hit_p = rp_valid & (vmax_p > batch["rp_snap"])
    hist = torch.zeros(T + 1, dtype=torch.int32, device=dev)
    hist.scatter_reduce_(0, _drop(rp_txn, T), _i32(hit_p), "amax", include_self=True)
    if Rr > 0:
        sparse = _build_sparse_max(cfg, hvers, n)
        s_qlo = torch.where(empty_r, lb_rb, lb_rbb)
        lo_e = torch.clamp(s_qlo - 1, min=0)
        lo = torch.where(empty_r, lo_e, s_qlo - 1)
        hi = torch.where(empty_r, lo_e + 1, s_re)
        rmax = _range_max(cfg, sparse, lo, hi)
        if tiered:
            rmax = torch.maximum(rmax, run_vr)
        hit_rg = r_valid & (rmax > batch["r_snap"])
        hist.scatter_reduce_(0, _drop(r_txn, T), _i32(hit_rg), "amax", include_self=True)
    hist_hits = hist[:T]

    # ---- Phase 2: intra-batch overlap edges (earlier txn -> later txn) ----
    ov_pr = ((pos_wb[None, :] < pos_rpb[:, None])        # wb <= k
             & (pos_rpb[:, None] < pos_we[None, :])      # k < we
             & (w_txn[None, :] < rp_txn[:, None])
             & rp_valid[:, None] & w_valid[None, :])
    nonempty = ~empty_r & r_valid
    ov_rp = ((pos_rb[:, None] < pos_wpb[None, :])        # rb <= k
             & (pos_wpb[None, :] < pos_re[:, None])      # k < re
             & (wp_txn[None, :] < r_txn[:, None])
             & nonempty[:, None] & wp_valid[None, :])
    ov_rr = ((pos_rb[:, None] < pos_we[None, :])
             & (pos_wb[None, :] < pos_re[:, None])
             & (w_txn[None, :] < r_txn[:, None])
             & nonempty[:, None] & w_valid[None, :])
    edges = {
        "ovw": _pack_bits(torch.cat([ov_pr, ov_rr]), cfg.wr_words),
        "ovrp": _pack_bits(ov_rp, cfg.wp_words),
        "gid_rp": _i32(gid_rp),
        "gid_wp": _i32(gid_wp),
    }
    if cfg.heat_buckets > 0:
        # the heat aggregate's history-witness context (heat_of): which read
        # rows hit history, at what stored version; the fixpoint reads edges
        # by key and ignores these
        edges["heat_hhit_p"] = hit_p
        edges["heat_hver_p"] = vmax_p
        if Rr > 0:
            edges["heat_hhit_r"] = hit_rg
            edges["heat_hver_r"] = rmax
        else:
            edges["heat_hhit_r"] = torch.zeros((0,), dtype=torch.bool, device=dev)
            edges["heat_hver_r"] = torch.zeros((0,), dtype=torch.int32, device=dev)
    return hist_hits, edges, wpos


# ---------------------------------------------------------------------------
# the commit fixpoint, plain form (the CUDA kernel's reference)
# ---------------------------------------------------------------------------

def _group_bounds(txn: Tensor, valid: Tensor, T: int) -> Tuple[Tensor, Tensor]:
    """Row range [starts[t], ends[t]) of txn t's rows within one group
    (valid rows are a prefix, grouped by ascending txn)."""
    idx = _drop(torch.where(valid, txn.long(), T), T)
    cnt = torch.zeros(T + 1, dtype=torch.int64, device=txn.device)
    cnt.index_add_(0, idx, torch.ones_like(idx))
    cnt = cnt[:T]
    ends = torch.cumsum(cnt, 0)
    return ends - cnt, ends


def _read_group_bounds(cfg: KernelConfig, batch: Dict):
    """Per-txn row windows of the two read groups (loop-invariant)."""
    T = cfg.max_txns
    ps, pe = _group_bounds(batch["rp_txn"], batch["rp_valid"], T)
    rs, re_ = _group_bounds(batch["r_txn"], batch["r_valid"], T)
    return ps, pe, rs, re_


def _blocked_rows(cfg: KernelConfig, edges: Dict[str, Tensor], batch: Dict,
                  c: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-read-row intra-batch blocked flags under committed mask c:
    (point rows [Rp], range rows [Rr])."""
    T, Rp, G = cfg.max_txns, cfg.rp, cfg.gid_space
    wp_txn = batch["wp_txn"].long()
    cwp = _take(c, wp_txn) & batch["wp_valid"]
    cwr = _take(c, batch["w_txn"].long()) & batch["w_valid"]
    maskw = _pack_bits(cwr, cfg.wr_words)
    hit_w = torch.any((edges["ovw"] & maskw[None, :]) != 0, dim=-1)
    maskp = _pack_bits(cwp, cfg.wp_words)
    hit_rp = torch.any((edges["ovrp"] & maskp[None, :]) != 0, dim=-1)
    # point-point: per-gid min of committed writer txns (T = +inf); G+1 is
    # the dustbin slot for uncommitted rows, G+2 the dropped-index slot
    mn = torch.full((G + 3,), T, dtype=torch.int64, device=c.device)
    gsl = _drop(torch.where(cwp, edges["gid_wp"].long(), G + 1), G + 2)
    mn.scatter_reduce_(0, gsl, wp_txn, "amin", include_self=True)
    hit_pp = _take(mn[:G + 2], edges["gid_rp"].long()) < batch["rp_txn"]
    return hit_w[:Rp] | hit_pp, hit_w[Rp:] | hit_rp


def _blocked_txns(cfg: KernelConfig, edges: Dict[str, Tensor], batch: Dict,
                  c: Tensor, bounds=None) -> Tensor:
    """Per-txn blocked counts [T] under the committed mask c."""
    ps, pe, rs, re_ = bounds if bounds is not None else _read_group_bounds(cfg, batch)

    def seg_count(hit, starts, ends):
        csum = torch.cat([torch.zeros(1, dtype=torch.int64, device=hit.device),
                          torch.cumsum(hit, 0)])
        return csum[ends] - csum[starts]

    hit_point, hit_range = _blocked_rows(cfg, edges, batch, c)
    return seg_count(hit_point, ps, pe) + seg_count(hit_range, rs, re_)


def commit_fixpoint(cfg: KernelConfig, t_ok: Tensor, hist_hits: Tensor,
                    edges: Dict[str, Tensor], batch: Dict) -> Tensor:
    """Earlier-in-batch-wins verdicts, the plain torch form of the JAX
    while_loop: start from base = t_ok & ~hist_hit and iterate
    c <- base & ~blocked(c) to its fixpoint, at most T rounds after the
    first. The loop test reads a device value, so on the card every round
    syncs with the host; the engine's path uses the CUDA kernel there
    (fixpoint_cuda.py) and this form runs on the card only to check it."""
    T = cfg.max_txns
    base = t_ok & ~(hist_hits > 0)
    bounds = _read_group_bounds(cfg, batch)

    def step(c):
        return base & ~(_blocked_txns(cfg, edges, batch, c, bounds) > 0)

    prev, c, it = base, step(base), 0
    while it < T and bool(torch.any(c != prev)):
        prev, c, it = c, step(c), it + 1
    return c


def _fixpoint(cfg: KernelConfig, t_ok, hist_hits, edges, batch) -> Tensor:
    """Dispatch on the tensors' device: CPU tensors take the plain version,
    CUDA tensors the kernel (which raises on an unsupported config rather
    than fall back)."""
    from . import fixpoint_cuda

    return fixpoint_cuda.commit_fixpoint(cfg, t_ok, hist_hits, edges, batch)


# ---------------------------------------------------------------------------
# phases 3-5
# ---------------------------------------------------------------------------

def apply_writes_and_gc(cfg: KernelConfig, state: Dict[str, Tensor], batch: Dict,
                        committed: Tensor, wpos: Dict[str, Tensor], gc_branch: bool):
    """Phases 3-5: committed-write union, boundary-table merge, GC/rebase.
    `gc_branch` is the host's answer to batch["gc"] > 0. Returns
    (new_state, overflow bool 0-d, reclaimed int32 0-d). The tiered
    structure updates the state's tensors in place (_tiered_apply)."""
    return _apply_writes(cfg, state, batch, committed, wpos, gc_branch)[:3]


def _apply_writes(cfg: KernelConfig, state: Dict[str, Tensor], batch: Dict,
                  committed: Tensor, wpos: Dict[str, Tensor], gc_branch: bool):
    """apply_writes_and_gc, plus the merge flag: (new_state, overflow,
    reclaimed, merged bool 0-d under the tiered structure, else None)."""
    check_supported(cfg)
    hkeys, hvers, n = state["hkeys"], state["hvers"], state["n"]
    dev = hkeys.device
    Wa, H, K = cfg.w_all, cfg.capacity, cfg.lanes
    now = batch["now"].to(torch.int64)
    n64 = n.to(torch.int64)
    w_txn_all = torch.cat([batch["wp_txn"], batch["w_txn"]]).long()
    w_valid_all = torch.cat([batch["wp_valid"], batch["w_valid"]])
    bkeys = torch.cat([batch["wpb"], batch["wb"]])
    ekeys = torch.cat([_bump(batch["wpb"]), batch["we"]])

    # ---- Phase 3: committed-write union ----
    cw = w_valid_all & _take(committed, w_txn_all)
    allk = torch.cat([bkeys, ekeys])                                  # [2Wa, K]
    ecode = torch.cat([torch.zeros(Wa, dtype=torch.int64, device=dev),
                       torch.ones(Wa, dtype=torch.int64, device=dev)])
    evalid = torch.cat([cw, cw])
    perm, s_keys = _sorted_rows(allk, ecode, evalid)
    # invalid rows sort last with code 7 (the JAX form writes 3; both are
    # >= 2, which is all s_valid reads)
    s_valid = evalid[perm]
    s_delta = torch.where(ecode[perm] == 0, 1, -1)
    d = torch.where(s_valid, s_delta, 0)
    cum = torch.cumsum(d, 0)
    is_ub = s_valid & (s_delta > 0) & ((cum - d) == 0)
    is_ue = s_valid & (s_delta < 0) & (cum == 0)
    ubi = torch.cumsum(is_ub, 0) - 1
    uei = torch.cumsum(is_ue, 0) - 1
    u_count = is_ub.sum()
    pe_lo = torch.cat([wpos["lo_b"], wpos["lo_e"]]).long()
    pe_up = torch.cat([wpos["lo_b"], wpos["up_e"]]).long()
    sc = torch.cat([s_keys, pe_lo[perm][:, None], pe_up[perm][:, None]], dim=1)
    ubc = torch.zeros((Wa + 1, K + 2), dtype=torch.int64, device=dev)
    ubc[_drop(torch.where(is_ub, ubi, Wa), Wa)] = sc
    uec = torch.zeros((Wa + 1, K + 2), dtype=torch.int64, device=dev)
    uec[_drop(torch.where(is_ue, uei, Wa), Wa)] = sc
    ub_keys, ue_keys = ubc[:Wa, :K], uec[:Wa, :K]
    u_start, u_stop = ubc[:Wa, K], uec[:Wa, K]
    if is_tiered(cfg):
        # phase 3's union IS the new run: the capacity-H re-merge and GC
        # compaction of phases 4-5 give way to append, rebase, lazy merge
        return _tiered_apply(cfg, state, batch, ub_keys, ue_keys, u_count, gc_branch)
    ue_ver = _take(hvers, torch.clamp(uec[:Wa, K + 1] - 1, min=0))

    # ---- Phase 4: merge the union into the table at version `now` ----
    jslot = _arange(H, dev)
    valid_u = _arange(Wa, dev) < u_count
    cov_delta = torch.zeros(H + 2, dtype=torch.int64, device=dev)
    cov_delta.index_add_(0, _drop(torch.where(valid_u, u_start, H + 1), H + 1),
                         torch.ones(Wa, dtype=torch.int64, device=dev))
    cov_delta.index_add_(0, _drop(torch.where(valid_u, u_stop, H + 1), H + 1),
                         torch.full((Wa,), -1, dtype=torch.int64, device=dev))
    covered = torch.cumsum(cov_delta[:H], 0) > 0
    old_keep = (jslot < n64) & ~covered

    # new rows interleave begins (version now) and ends (version ue_ver)
    nb_keys = torch.stack([ub_keys, ue_keys], dim=1).reshape(2 * Wa, K)
    nb_vers = torch.stack([now.expand(Wa), ue_ver.long()], dim=1).reshape(2 * Wa)
    nb_lb = torch.stack([u_start, u_stop], dim=1).reshape(2 * Wa)
    j_of = _arange(2 * Wa, dev) >> 1
    is_end_row = (_arange(2 * Wa, dev) & 1) == 1
    nb_valid = j_of < u_count
    # drop an end row when an equal, uncovered old boundary already exists
    lbc = torch.clamp(nb_lb, max=H - 1)
    eq_exists = (nb_lb < n64) & _key_eq(hkeys[lbc], nb_keys) & ~covered[lbc]
    nb_keep = nb_valid & ~(is_end_row & eq_exists)

    ncomp_pos = torch.cumsum(nb_keep, 0) - 1
    nc = nb_keep.sum()
    ncc = torch.zeros((2 * Wa + 1, K + 2), dtype=torch.int64, device=dev)
    ncc[_drop(torch.where(nb_keep, ncomp_pos, 2 * Wa), 2 * Wa)] = torch.cat(
        [nb_keys, nb_vers[:, None], nb_lb[:, None]], dim=1)
    nck, ncv, lb_old = ncc[:2 * Wa, :K], ncc[:2 * Wa, K], ncc[:2 * Wa, K + 1]

    cum_keep = torch.cumsum(old_keep, 0)
    new_cnt = torch.zeros(H + 2, dtype=torch.int64, device=dev)
    new_cnt.index_add_(0, _drop(torch.where(_arange(2 * Wa, dev) < nc, lb_old, H + 1), H + 1),
                       torch.ones(2 * Wa, dtype=torch.int64, device=dev))
    new_before_old = torch.cumsum(new_cnt[:H], 0)
    pos_old = cum_keep - 1 + new_before_old
    cum_cov = torch.cumsum(covered, 0)
    cov_before = torch.where(lb_old > 0, _take(cum_cov, torch.clamp(lb_old - 1, min=0)), 0)
    pos_new = _arange(2 * Wa, dev) + (lb_old - cov_before)

    # merged rows (keys | version) in one int64 matrix, with a dustbin row H
    outc = torch.zeros((H + 1, K + 1), dtype=torch.int64, device=dev)
    outc[:, K] = NEG_VERSION
    outc[_drop(torch.where(old_keep, pos_old, H), H)] = torch.cat(
        [hkeys, hvers.long()[:, None]], dim=1)
    nc_mask = _arange(2 * Wa, dev) < nc
    outc[_drop(torch.where(nc_mask, pos_new, H), H)] = torch.cat(
        [nck, ncv[:, None]], dim=1)
    outc = outc[:H]
    out_v = outc[:, K]
    n1 = cum_keep[-1] + nc
    overflow = n1 > H

    # ---- Phase 5: GC + rebase (keep rule of removeBefore) ----
    # The branch is the host's (gc_branch): a captured graph holds one.
    gc = batch["gc"].to(torch.int64)
    if gc_branch:
        prev_v = torch.cat([torch.full((1,), 2**30, dtype=torch.int64, device=dev), out_v[:-1]])
        keep = (jslot < n1) & ((jslot == 0) | (out_v >= gc) | (prev_v >= gc))
        cpos = torch.cumsum(keep, 0) - 1
        finc = torch.zeros((H + 1, K + 1), dtype=torch.int64, device=dev)
        finc[:, K] = NEG_VERSION
        finc[_drop(torch.where(keep, cpos, H), H)] = outc
        n2 = keep.sum()
        fin_v = torch.where(jslot < n2, torch.clamp(finc[:H, K] - gc, min=-1), NEG_VERSION)
        hk = finc[:H, :K]
    else:
        fin_v = torch.where(jslot < n1, torch.clamp(out_v, min=-1), NEG_VERSION)
        hk = outc[:, :K]
        n2 = n1
    new_state = {"hkeys": hk.contiguous(), "hvers": _i32(fin_v), "n": _i32(n2)}
    return new_state, overflow, _i32(n1 - n2), None


# ---------------------------------------------------------------------------
# the tiered structure: run append, GC rebase, lazy merge
# ---------------------------------------------------------------------------

def _merge_runs(cfg: KernelConfig, hkeys: Tensor, hvers: Tensor, n: Tensor,
                rkeys: Tensor, rvers: Tensor, rn: Tensor, nruns: Tensor):
    """The lazy compaction: fold base + every active run into one key-sorted
    boundary table. Returns (mkeys [H, K], mvers int32 [H], m_n int32 0-d,
    overflow bool 0-d, dropped int32 0-d) as the JAX function does.

    Stage 1 folds the runs alone: one sort of the NR*RC run rows, an [NR,
    NR*RC] cummax forward fill (each run's value at every sorted run key;
    the runs' combined value is the max), one delta row per distinct run
    key, value-redundant delta rows dropped. Stage 2 merges the delta into
    the sorted base positionally, as the monolithic phase 4 does, then one
    value-equal-predecessor pass over the merged image of H + NR*RC rows, so
    an overflowing merge still counts m_n exactly before truncating."""
    NR, RC = cfg.run_slots, cfg.run_rows
    H, K = cfg.capacity, cfg.lanes
    Md = NR * RC
    dev = hkeys.device
    n64 = n.to(torch.int64)
    posn = _arange(Md, dev)

    # ---- Stage 1: fold the runs into one coalesced delta boundary list ----
    akeys = rkeys.reshape(Md, K)
    avers = rvers.reshape(Md)
    asrc = posn // RC
    avalid = ((_arange(RC, dev)[None, :] < rn.to(torch.int64)[:, None])
              & (_arange(NR, dev)[:, None] < nruns.to(torch.int64))).reshape(Md)
    # valid rows sort first, invalid ones (all-ones keys) after them by index
    perm, skeys = _sorted_rows(akeys, torch.zeros(Md, dtype=torch.int64, device=dev), avalid)
    svalid = avalid[perm]
    ssrc = asrc[perm]
    svers = avers[perm]
    tag2 = torch.where(svalid[None, :] & (ssrc[None, :] == _arange(NR, dev)[:, None]),
                       posn[None, :], -1)
    last2 = torch.cummax(tag2, dim=1).values
    val2 = torch.where(last2 >= 0, svers[torch.clamp(last2, min=0)], NEG_VERSION)
    dval = val2.amax(dim=0)

    # one delta row per distinct run key: the last row of each equal-key group
    diff_next = torch.ones(Md, dtype=torch.bool, device=dev)
    diff_next[:-1] = torch.any(skeys[:-1] != skeys[1:], dim=-1)
    is_cand = svalid & diff_next
    ptag = torch.where(is_cand, posn, -1)
    prevc = torch.cat([torch.full((1,), -1, dtype=torch.int64, device=dev),
                       torch.cummax(ptag, dim=0).values[:-1]])
    prev_val = torch.where(prevc >= 0, dval[torch.clamp(prevc, min=0)], 2**30)
    dkeep = is_cand & (dval != prev_val)

    dpos = torch.cumsum(dkeep, 0) - 1
    d_n = dkeep.sum()
    dc = torch.zeros((Md + 1, K + 1), dtype=torch.int64, device=dev)
    dc[_drop(torch.where(dkeep, dpos, Md), Md)] = torch.cat(
        [skeys, dval.to(torch.int64)[:, None]], dim=1)
    dkeys, dvers = dc[:Md, :K], dc[:Md, K]

    # ---- Stage 2: positional merge of the delta into the sorted base ----
    valid_d = posn < d_n
    lo = _lower_bound_n(hkeys, n, dkeys, cfg.levels)
    eq = valid_d & (lo < n64) & _key_eq(hkeys[torch.clamp(lo, max=H - 1)], dkeys)
    # a NEG delta row takes the base's value there, hvers[upper - 1]
    ubm1 = lo + eq.to(torch.int64) - 1
    fill = torch.where(ubm1 >= 0, _take(hvers, torch.clamp(ubm1, min=0)).to(torch.int64),
                       NEG_VERSION)
    dv2 = torch.where(dvers == NEG_VERSION, fill, dvers)

    # base rows inside a covering delta segment are overwritten; an
    # equal-key base row is superseded by its delta row either way
    covering = valid_d & (dvers != NEG_VERSION)
    nxt_lo = torch.cat([lo[1:], torch.zeros(1, dtype=torch.int64, device=dev)])
    stop = torch.where(posn + 1 < d_n, nxt_lo, n64)
    cov_delta = torch.zeros(H + 2, dtype=torch.int64, device=dev)
    ones = torch.ones(Md, dtype=torch.int64, device=dev)
    cov_delta.index_add_(0, _drop(torch.where(covering, lo, H + 1), H + 1), ones)
    cov_delta.index_add_(0, _drop(torch.where(covering, stop, H + 1), H + 1), -ones)
    covered = torch.cumsum(cov_delta[:H], 0) > 0
    eq_kill = torch.zeros(H + 1, dtype=torch.bool, device=dev).index_fill_(
        0, _drop(torch.where(eq, lo, H), H), True)[:H]
    old_keep = (_arange(H, dev) < n64) & ~covered & ~eq_kill

    # merged positions: kept base rows shift by the delta rows before them,
    # delta rows by the kept base rows before them
    cum_keep = torch.cumsum(old_keep, 0)
    new_cnt = torch.zeros(H + 2, dtype=torch.int64, device=dev)
    new_cnt.index_add_(0, _drop(torch.where(valid_d, lo, H + 1), H + 1), ones)
    pos_old = cum_keep - 1 + torch.cumsum(new_cnt[:H], 0)
    drop_before = torch.cumsum(covered | eq_kill, 0)
    db = torch.where(lo > 0, _take(drop_before, torch.clamp(lo - 1, min=0)), 0)
    pos_new = posn + (lo - db)

    G = H + Md
    img = torch.zeros((G + 1, K + 1), dtype=torch.int64, device=dev)
    img[:, K] = NEG_VERSION
    img[_drop(torch.where(old_keep, pos_old, G), G)] = torch.cat(
        [hkeys, hvers.to(torch.int64)[:, None]], dim=1)
    img[_drop(torch.where(valid_d, pos_new, G), G)] = torch.cat([dkeys, dv2[:, None]], dim=1)
    img = img[:G]
    gvers = img[:, K]
    mn_raw = cum_keep[H - 1] + d_n

    # boundary redundancy over the merged image: drop rows whose value
    # equals the previous row's (the first row's sentinel matches nothing)
    pv = torch.cat([torch.full((1,), 2**30, dtype=torch.int64, device=dev), gvers[:-1]])
    keep = (_arange(G, dev) < mn_raw) & (gvers != pv)
    cpos = torch.cumsum(keep, 0) - 1
    m_n = keep.sum()
    out = torch.zeros((H + 1, K + 1), dtype=torch.int64, device=dev)
    out[:, K] = NEG_VERSION
    out[_drop(torch.where(keep, cpos, H), H)] = img
    total = n64 + torch.where(_arange(NR, dev) < nruns.to(torch.int64), rn.to(torch.int64),
                              0).sum()
    return (out[:H, :K], _i32(out[:H, K]), _i32(m_n), m_n > H, _i32(total - m_n))


class HostReads:
    """Host reads of a device-dependent branch made on the card outside a
    CUDA graph capture: each one is a sync. Under capture the branch is a
    conditional node (graph_if.GRAPH_IF counts them)."""

    def __init__(self):
        self.host_reads = 0


#: reads of the tiered step's merge predicate (is the run stack full when a
#: run must append?) — an IF node under capture
MERGE = HostReads()
#: reads of the server loop's condition (another chunk to run?) — a WHILE
#: node under capture
LOOP = HostReads()


def run_if(pred: Tensor, body) -> None:
    """body() iff the 0-d bool `pred` holds, without computing body when it
    does not: on the CPU a host branch; on the card under CUDA graph
    capture a conditional IF node whose body replays only when `pred` holds
    (graph_if; body must write its results into tensors that exist before
    the node); on the card outside a capture a host read of `pred`, a
    sync, counted in MERGE.host_reads. Nothing computes both sides and
    selects."""
    if pred.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        with graph_if.if_node(pred):
            body()
        return
    if pred.device.type == "cuda":
        MERGE.host_reads += 1
    if bool(pred):
        body()


def run_while(cond, body) -> None:
    """while cond(): body(), where cond() returns a 0-d bool tensor: on the
    CPU a host loop; on the card under CUDA graph capture a conditional
    WHILE node whose body replays as long as the condition the body sets
    last holds (graph_if; the body must write its results into tensors that
    exist before the node, and cond() reads only such tensors); on the card
    outside a capture a host loop that reads the condition, a sync each
    time, counted in LOOP.host_reads."""
    pred = cond()
    if pred.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        with graph_if.while_node(pred) as again:
            body()
            again(cond())
        return
    while True:
        if pred.device.type == "cuda":
            LOOP.host_reads += 1
        if not bool(pred):
            return
        body()
        pred = cond()


def _tiered_apply(cfg: KernelConfig, state: Dict[str, Tensor], batch: Dict,
                  ub_keys: Tensor, ue_keys: Tensor, u_count: Tensor, gc_branch: bool):
    """Tiered phases 4-5, IN PLACE on the state's tensors: merge the run
    stack into the base when the incoming run finds no free slot
    (run_if), append the batch's committed-write union as one sorted run
    (O(RC*K): one slot written, branch-free), then the GC as an elementwise
    horizon rebase of base and runs (NEG gap rows stay NEG). Returns
    (state, overflow bool 0-d, reclaimed int32 0-d, merged bool 0-d)."""
    NR, RC = cfg.run_slots, cfg.run_rows
    H, K, Wa = cfg.capacity, cfg.lanes, cfg.w_all
    dev = ub_keys.device
    hkeys, hvers, n = state["hkeys"], state["hvers"], state["n"]
    rkeys, rvers, rn, nruns = state["rkeys"], state["rvers"], state["rn"], state["nruns"]

    # the new run: interleaved (union-begin, now) / (union-end, NEG) rows,
    # padded with all-ones keys and NEG versions
    row_valid = (_arange(2 * Wa, dev) >> 1) < u_count
    nrk = torch.stack([ub_keys, ue_keys], dim=1).reshape(2 * Wa, K)
    nrv = torch.stack([batch["now"].expand(Wa),
                       torch.full((Wa,), NEG_VERSION, dtype=torch.int32, device=dev)],
                      dim=1).reshape(2 * Wa)
    runk = torch.full((RC, K), U32_ALL, dtype=torch.int64, device=dev)
    runk[:2 * Wa] = torch.where(row_valid[:, None], nrk, U32_ALL)
    runv = torch.full((RC,), NEG_VERSION, dtype=torch.int32, device=dev)
    runv[:2 * Wa] = torch.where(row_valid, nrv, NEG_VERSION)
    has_rows = u_count > 0

    # lazy merge: only when a run must append and every slot is taken
    do_merge = has_rows & (nruns >= NR)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    reclaimed = torch.zeros((), dtype=torch.int32, device=dev)

    def merge():
        mk, mv, mn, moverflow, dropped = _merge_runs(cfg, hkeys, hvers, n, rkeys, rvers,
                                                     rn, nruns)
        hkeys.copy_(mk)
        hvers.copy_(mv)
        n.copy_(mn)
        rkeys.fill_(U32_ALL)
        rvers.fill_(NEG_VERSION)
        rn.zero_()
        nruns.zero_()
        overflow.copy_(moverflow)
        reclaimed.copy_(dropped)

    run_if(do_merge, merge)

    # append at the first free slot (slot 0 after a merge); a read-only
    # batch rewrites that slot with what it holds
    slot = torch.clamp(nruns.to(torch.int64), max=NR - 1).reshape(1)
    rkeys.index_copy_(0, slot, torch.where(has_rows, runk, rkeys.index_select(0, slot)[0])[None])
    rvers.index_copy_(0, slot, torch.where(has_rows, runv, rvers.index_select(0, slot)[0])[None])
    rn.index_copy_(0, slot, torch.where(has_rows, _i32(2 * u_count),
                                        rn.index_select(0, slot)[0]).reshape(1))
    nruns.add_(has_rows.to(torch.int32))

    # GC as a range deletion; the branch is the host's (gc_branch)
    if gc_branch:
        gc = batch["gc"]
        hvers.copy_(torch.where(_arange(H, dev) < n.to(torch.int64),
                                torch.clamp(hvers - gc, min=-1), NEG_VERSION))
        rvers.copy_(torch.where(rvers == NEG_VERSION, NEG_VERSION,
                                torch.clamp(rvers - gc, min=-1)))
    return state, overflow, reclaimed, do_merge


def detect_step(cfg: KernelConfig, state: Dict[str, Tensor], batch: Dict):
    """Phases 1-2 only, for the host long-key tier, which combines global
    verdicts across device and host tiers BEFORE any tier applies writes."""
    return local_phases(cfg, state, batch)


def fix_step(cfg: KernelConfig, t_ok: Tensor, hist_hits: Tensor,
             edges: Dict[str, Tensor], batch: Dict) -> Tensor:
    """Re-run the fixpoint with an updated t_ok (host-tier aborts folded in)."""
    return _fixpoint(cfg, t_ok, hist_hits, edges, batch)


def apply_step(cfg: KernelConfig, state: Dict[str, Tensor], batch: Dict,
               committed: Tensor, wpos: Dict[str, Tensor], gc_branch: bool):
    """Apply the globally agreed committed writes (+GC): (new_state, overflow)."""
    new_state, overflow, _ = apply_writes_and_gc(cfg, state, batch, committed, wpos,
                                                 gc_branch)
    return new_state, overflow


def status_of(t_too_old: Tensor, committed: Tensor) -> Tensor:
    return torch.where(
        t_too_old, int(TransactionCommitResult.TOO_OLD),
        torch.where(committed, int(TransactionCommitResult.COMMITTED),
                    int(TransactionCommitResult.CONFLICT))).to(torch.int32)


# ---------------------------------------------------------------------------
# keyspace heat
# ---------------------------------------------------------------------------

#: lanes of the heat aggregate's per-bucket histogram (heat_of)
HEAT_HIST_LANES = 3          # 0: read rows, 1: write rows, 2: conflict rows
#: lanes of the heat aggregate's scalar counts vector
HEAT_COUNT_LANES = 4         # 0: committed, 1: conflicts, 2: too_old, 3: gc_reclaimed


def _heat_bounds(cfg: KernelConfig, hkeys: Tensor, n: Tensor) -> Tensor:
    """B boundary keys sampled at equally spaced POSITIONS of the sorted
    valid table prefix hkeys[0:n]: the bucket delimiters of the heat
    histogram. Bucket i covers [bounds[i], bounds[i+1]) (the last bucket
    extends to +inf; keys below bounds[0] fold into bucket 0)."""
    B = cfg.heat_buckets
    pos = (_arange(B, hkeys.device) * torch.clamp(n.to(torch.int64), min=1)) // B
    # an overflowing apply leaves n > H: the JAX gather clamps, so does _take
    return _take(hkeys, pos)                                 # [B, K]


def _heat_bucket_of(cfg: KernelConfig, bounds: Tensor, q: Tensor) -> Tensor:
    """Bucket index of every query key row q[i] under `bounds`: the last
    boundary <= q (clamped to 0 below bounds[0]), a branchless binary
    search of B.bit_length() rounds in lockstep."""
    B = cfg.heat_buckets
    lo = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    hi = torch.full_like(lo, B)
    for _ in range(max(1, B.bit_length())):
        active = lo < hi
        mid = (lo + hi) >> 1
        # go right iff bounds[mid] <= q (upper-bound discipline)
        go_right = ~_key_less(q, bounds[torch.clamp(mid, max=B - 1)])
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return torch.clamp(lo - 1, min=0)


def heat_of(cfg: KernelConfig, state: Dict[str, Tensor], batch: Dict, committed: Tensor,
            edges: Dict[str, Tensor], reclaimed: Tensor) -> Dict[str, Tensor]:
    """The per-batch keyspace-heat aggregate, computed on the device from
    values the verdict path already produced, so it changes no verdict:

      bounds     int64 [B, K]  sampled bucket-boundary keys (uint32 words)
      hist       int32 [B, 3]  read / write / conflict-attributed rows
      counts     int32 [4]     committed, conflicts, too_old, gc_reclaimed
      occupancy  int32 []      boundary-table rows after this batch
      wit_ver    int32 [T]     first-witness conflicting-write version
                               (history hit: the stored version that beat
                               the snapshot; intra-batch: `now`); NEG_VERSION
                               where the txn did not conflict
      wit_bucket int32 [T]     the witness read row's bucket; -1 where none

    plus, under the tiered structure, `runs` (the run-stack depth) and
    `run_rows` (valid rows in live runs), int32 []. `state` is the
    post-apply table; every leaf is a tensor of its own (none aliases the
    state, which the tiered apply updates in place)."""
    B, T = cfg.heat_buckets, cfg.max_txns
    Rp, Rr = cfg.rp, cfg.max_reads
    dev = committed.device
    bounds = _heat_bounds(cfg, state["hkeys"], state["n"])
    conflicted = batch["t_ok"] & ~committed
    counts = _i32(torch.stack([committed.sum(), conflicted.sum(), batch["t_too_old"].sum(),
                               reclaimed.to(torch.int64)]))

    # one packed bucket search serves every row class (range rows bin by
    # their begin key)
    qkeys = torch.cat([batch["rpb"], batch["rb"], batch["wpb"], batch["wb"]])
    bk = _heat_bucket_of(cfg, bounds, qkeys)
    rbk, wbk = bk[:Rp + Rr], bk[Rp + Rr:]
    rvalid = torch.cat([batch["rp_valid"], batch["r_valid"]])
    wvalid = torch.cat([batch["wp_valid"], batch["w_valid"]])
    r_txn_all = torch.cat([batch["rp_txn"], batch["r_txn"]]).long()
    r_conflicted = _take(conflicted, r_txn_all)
    crow = rvalid & r_conflicted                             # conflict rows
    # a [B+1, 3] histogram whose row B is the dustbin of JAX's mode="drop"
    hist = torch.zeros((B + 1) * HEAT_HIST_LANES, dtype=torch.int32, device=dev)
    for lane, (valid, bkt) in enumerate(((rvalid, rbk), (wvalid, wbk), (crow, rbk))):
        idx = torch.where(valid, bkt, B) * HEAT_HIST_LANES + lane
        hist.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    hist = hist.reshape(B + 1, HEAT_HIST_LANES)[:B]

    # first-witness abort attribution: each conflicted txn's first (lowest
    # index) read row that was hit, by history or by an earlier committed
    # write in this batch (witness version `now`)
    ihit_p, ihit_r = _blocked_rows(cfg, edges, batch, committed)
    hhit_p, hver_p = edges["heat_hhit_p"], edges["heat_hver_p"]
    hhit_r, hver_r = edges["heat_hhit_r"], edges["heat_hver_r"]
    now = batch["now"]
    act = torch.cat([batch["rp_valid"] & (hhit_p | ihit_p),
                     batch["r_valid"] & (hhit_r | ihit_r)]) & r_conflicted
    wver = torch.cat([torch.where(hhit_p, hver_p, now), torch.where(hhit_r, hver_r, now)])
    R = Rp + Rr
    first = torch.full((T + 1,), R, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, _drop(torch.where(act, r_txn_all, T), T), _arange(R, dev),
                          "amin", include_self=True)
    first = first[:T]
    has = first < R
    fc = torch.clamp(first, max=R - 1)
    out = {"bounds": bounds, "hist": hist, "counts": counts,
           "occupancy": state["n"].clone(),
           "wit_ver": torch.where(has, wver[fc], NEG_VERSION).to(torch.int32),
           "wit_bucket": _i32(torch.where(has, rbk[fc], -1))}
    if is_tiered(cfg):
        live = _arange(cfg.run_slots, dev) < state["nruns"].to(torch.int64)
        out["runs"] = state["nruns"].clone()
        out["run_rows"] = _i32(torch.where(live, state["rn"], 0).sum())
    return out


def heat_shapes(cfg: KernelConfig) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """Shapes and dtypes of one batch's heat aggregate (the port of
    heat_struct); {} when heat is off."""
    if cfg.heat_buckets <= 0:
        return {}
    B, K, T = cfg.heat_buckets, cfg.lanes, cfg.max_txns
    i32 = torch.int32
    out = {
        "bounds": ((B, K), torch.int64),
        "hist": ((B, HEAT_HIST_LANES), i32),
        "counts": ((HEAT_COUNT_LANES,), i32),
        "occupancy": ((), i32),
        "wit_ver": ((T,), i32),
        "wit_bucket": ((T,), i32),
    }
    if is_tiered(cfg):
        out["runs"] = ((), i32)
        out["run_rows"] = ((), i32)
    return out


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

def resolve_step(cfg: KernelConfig, state: Dict[str, Tensor], batch: Dict,
                 gc_branch: bool):
    """One resolver batch: (state, batch) -> (state', {"status", "overflow",
    "n"}, plus "merged" under the tiered structure: whether this step merged
    the run stack, and "heat" (heat_of) with cfg.heat_buckets > 0).
    `gc_branch`: whether batch["gc"] > 0."""
    hist_hits, edges, wpos = local_phases(cfg, state, batch)
    committed = _fixpoint(cfg, batch["t_ok"], hist_hits, edges, batch)
    new_state, overflow, reclaimed, merged = _apply_writes(cfg, state, batch, committed, wpos,
                                                           gc_branch)
    out = {"status": status_of(batch["t_too_old"], committed),
           "overflow": overflow, "n": new_state["n"]}
    if merged is not None:
        out["merged"] = merged
    if cfg.heat_buckets > 0:
        out["heat"] = heat_of(cfg, new_state, batch, committed, edges, reclaimed)
    return new_state, out


def resolve_step_scan(cfg: KernelConfig, state: Dict[str, Tensor], batches: Dict,
                      gc_last: bool):
    """C same-shape batches (leaves [C, ...]) as one program: resolve_step
    chunk by chunk, threading the table through — the port of JAX's
    lax.scan form, so status [C, T] and overflow [C] equal C serial
    resolve_steps. `gc_last`: whether the LAST chunk carries gc > 0;
    earlier chunks take the no-GC branch (only a batch's last chunk carries
    its GC horizon). Under the tiered structure the outputs gain "merged"
    [C]; with heat on, "heat" holds the per-chunk aggregates stacked [C,
    ...]."""
    C = batches["t_ok"].shape[0]
    outs = []
    for c in range(C):
        state, out = resolve_step(cfg, state, {k: v[c] for k, v in batches.items()},
                                  gc_last and c == C - 1)
        outs.append(out)
    stacked = {k: torch.stack([o[k] for o in outs]) for k in outs[0] if k not in ("n", "heat")}
    if "heat" in outs[0]:
        stacked["heat"] = {k: torch.stack([o["heat"][k] for o in outs]) for k in outs[0]["heat"]}
    return state, stacked


#: the batch fields that hold packed keys: the step computes on them as
#: int64 words; a program's static inputs may hold them as the int32 bits
#: of their uint32 words (resolve_server_loop widens a selected chunk)
KEY_FIELDS = frozenset(("rpb", "wpb", "rb", "re", "wb", "we"))


def status_words(cfg: KernelConfig) -> int:
    """32-bit words per verdict bitmap lane: the server loop emits
    committed / too-old bitmaps [Q, status_words] instead of [Q, T]
    statuses (device_loop.decode_status_bits decodes them)."""
    return (cfg.max_txns + 31) // 32


def server_outputs(cfg: KernelConfig, q: int, device) -> Dict:
    """Zeroed output buffers of resolve_server_loop for a Q-chunk slot:
    "commit_bits" / "too_old_bits" int32 [Q, status_words] (the uint32 bits
    of JAX's words), "overflow" bool [], "merged" bool [Q] under the tiered
    structure, and "heat" {leaf: [Q, ...]} with heat on."""
    TW = status_words(cfg)
    out = {"commit_bits": torch.zeros((q, TW), dtype=torch.int32, device=device),
           "too_old_bits": torch.zeros((q, TW), dtype=torch.int32, device=device),
           "overflow": torch.zeros((), dtype=torch.bool, device=device)}
    if is_tiered(cfg):
        out["merged"] = torch.zeros((q,), dtype=torch.bool, device=device)
    heat = heat_shapes(cfg)
    if heat:
        out["heat"] = {k: torch.zeros((q,) + shape, dtype=dtype, device=device)
                       for k, (shape, dtype) in heat.items()}
    return out


def resolve_server_loop(cfg: KernelConfig, state: Dict[str, Tensor], batches: Dict,
                        n_chunks: Tensor, gc_last: bool, out: Optional[Dict] = None):
    """The device-resident server step: the filled prefix of a Q-chunk
    queue slot (leaves [Q, ...]) under one loop whose chunk count
    `n_chunks` (0-d int, >= 1) is a device value, so ONE program per bucket
    serves every fill level 1..Q. Chunks 0 .. n-2 take the no-GC step in a
    run_while loop (a CUDA graph WHILE node under capture) over a 0-d
    device counter that selects each chunk (index_select); chunk n-1, the
    only one that may carry the GC horizon, follows with the host's
    `gc_last` branch. Loop order is fill order, so the table evolves as
    under n serial resolve_steps.

    Updates `state`'s tensors in place and writes `out` (server_outputs;
    zeroed first, so rows past the prefix read 0): the committed and
    too-old bitmaps of each chunk, the OR of the overflows, the tiered
    merge flags and the heat planes. Key fields given as int32 hold uint32
    bits and widen after selection. Returns (state, out)."""
    Q = batches["t_ok"].shape[0]
    dev = batches["t_ok"].device
    TW = status_words(cfg)
    if out is None:
        out = server_outputs(cfg, Q, dev)
    for v in list(out.values()) + list(out.get("heat", {}).values()):
        if isinstance(v, Tensor):
            v.zero_()
    committed_code = int(TransactionCommitResult.COMMITTED)
    too_old_code = int(TransactionCommitResult.TOO_OLD)
    i = torch.zeros((), dtype=torch.int64, device=dev)
    last = torch.clamp(n_chunks.to(torch.int64) - 1, min=0)

    def chunk(idx: Tensor) -> Dict[str, Tensor]:
        sel = idx.reshape(1)
        b = {}
        for name, v in batches.items():
            x = v.index_select(0, sel)[0]
            if name in KEY_FIELDS and x.dtype == torch.int32:
                x = x.to(torch.int64) & U32_ALL
            b[name] = x
        return b

    def step(idx: Tensor, gc_branch: bool) -> None:
        sel = idx.reshape(1)
        new_state, o = resolve_step(cfg, state, chunk(idx), gc_branch)
        for k, v in state.items():
            if new_state[k] is not v:
                v.copy_(new_state[k])
        out["commit_bits"].index_copy_(0, sel, _pack_bits(o["status"] == committed_code, TW)[None])
        out["too_old_bits"].index_copy_(0, sel, _pack_bits(o["status"] == too_old_code, TW)[None])
        out["overflow"].logical_or_(o["overflow"])
        if "merged" in out:
            out["merged"].index_copy_(0, sel, o["merged"].reshape(1))
        for k, acc in out.get("heat", {}).items():
            acc.index_copy_(0, sel, o["heat"][k].to(acc.dtype)[None])

    def body() -> None:
        step(i, False)
        i.add_(1)

    run_while(lambda: i < last, body)
    step(last, gc_last)
    return state, out


# ---------------------------------------------------------------------------
# shapes, state and batches
# ---------------------------------------------------------------------------

def state_shapes(cfg: KernelConfig) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """Shapes and dtypes of the device interval table (the port of
    state_struct): the run planes exist only under the tiered structure."""
    out = {
        "hkeys": ((cfg.capacity, cfg.lanes), torch.int64),
        "hvers": ((cfg.capacity,), torch.int32),
        "n": ((), torch.int32),
    }
    if is_tiered(cfg):
        out["rkeys"] = ((cfg.run_slots, cfg.run_rows, cfg.lanes), torch.int64)
        out["rvers"] = ((cfg.run_slots, cfg.run_rows), torch.int32)
        out["rn"] = ((cfg.run_slots,), torch.int32)
        out["nruns"] = ((), torch.int32)
    return out


def batch_shapes(cfg: KernelConfig) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """Shapes and dtypes of one device batch (the port of batch_struct)."""
    K = cfg.lanes
    i32, i64, b = torch.int32, torch.int64, torch.bool
    return {
        "rpb": ((cfg.rp, K), i64),
        "rp_snap": ((cfg.rp,), i32),
        "rp_txn": ((cfg.rp,), i32),
        "rp_valid": ((cfg.rp,), b),
        "rb": ((cfg.max_reads, K), i64),
        "re": ((cfg.max_reads, K), i64),
        "r_snap": ((cfg.max_reads,), i32),
        "r_txn": ((cfg.max_reads,), i32),
        "r_valid": ((cfg.max_reads,), b),
        "wpb": ((cfg.wp, K), i64),
        "wp_txn": ((cfg.wp,), i32),
        "wp_valid": ((cfg.wp,), b),
        "wb": ((cfg.max_writes, K), i64),
        "we": ((cfg.max_writes, K), i64),
        "w_txn": ((cfg.max_writes,), i32),
        "w_valid": ((cfg.max_writes,), b),
        "t_ok": ((cfg.max_txns,), b),
        "t_too_old": ((cfg.max_txns,), b),
        "now": ((), i32),
        "gc": ((), i32),
    }


_NP_OF = {torch.int64: np.int64, torch.int32: np.int32, torch.bool: np.bool_}


def _to_tensor(a, shape, dtype, name: str, device) -> Tensor:
    a = np.asarray(a)
    if a.shape != tuple(shape):
        raise ValueError(f"{name}: shape {a.shape}, expected {tuple(shape)}")
    # uint32 key words widen to int64 by zero extension
    return torch.from_numpy(np.array(a, dtype=_NP_OF[dtype], order="C")).to(device)


def batch_from_numpy(cfg: KernelConfig, arrays: Dict, device) -> Dict:
    """Device batch from the numpy dict build_batch_arrays returns (the JAX
    package's build_batch_arrays gives the same dict)."""
    return {name: _to_tensor(arrays[name], shape, dtype, name, device)
            for name, (shape, dtype) in batch_shapes(cfg).items()}


def state_from_numpy(cfg: KernelConfig, arrays: Dict, device) -> Dict[str, Tensor]:
    """Device table from numpy {"hkeys" uint32 [H, K], "hvers" int32 [H],
    "n"}, and under the tiered structure {"rkeys" uint32 [NR, RC, K],
    "rvers" int32 [NR, RC], "rn" int32 [NR], "nruns"} — initial_state's
    arrays in either package."""
    return {name: _to_tensor(arrays[name], shape, dtype, name, device)
            for name, (shape, dtype) in state_shapes(cfg).items()}


def state_to_numpy(state: Dict[str, Tensor]) -> Dict[str, np.ndarray]:
    """Inverse of state_from_numpy: key planes back to uint32."""
    out = {}
    for name, t in state.items():
        a = t.cpu().numpy()
        out[name] = a.astype(np.uint32) if name in ("hkeys", "rkeys") else a
    return out


def initial_state(cfg: KernelConfig, version_rel: int = 0, first_key: bytes = b"",
                  device="cpu") -> Dict[str, Tensor]:
    """Fresh boundary table whose single interval [first_key, +inf) carries
    version_rel; under the tiered structure, empty run planes (all-ones
    keys, NEG versions)."""
    hkeys = np.zeros((cfg.capacity, cfg.lanes), np.uint32)
    hkeys[0] = keypack.pack_key(first_key, cfg.key_words)
    hvers = np.full((cfg.capacity,), NEG_VERSION, np.int32)
    hvers[0] = version_rel
    arrays = {"hkeys": hkeys, "hvers": hvers, "n": 1}
    if is_tiered(cfg):
        NR, RC = cfg.run_slots, cfg.run_rows
        arrays.update(rkeys=np.full((NR, RC, cfg.lanes), U32_ALL, np.uint32),
                      rvers=np.full((NR, RC), NEG_VERSION, np.int32),
                      rn=np.zeros((NR,), np.int32), nruns=0)
    return state_from_numpy(cfg, arrays, device)


def history_run_snapshot(cfg: KernelConfig, state: Dict, since_runs: int = 0) -> Dict[str, object]:
    """Host copy of the ACTIVE run planes only, the O(delta) export: the
    runs appended since the caller's watermark `since_runs` (the nruns of
    its last snapshot). A merge resets nruns to 0 or 1, so nruns <
    since_runs in the result tells the caller a compaction killed its
    watermark and it must resync. Returns {"structure", "nruns", "runs":
    [(keys uint32 [rn_j, K], vers int32 [rn_j]), ...]}, rows alternating
    (interval-begin, version) / (interval-end, NEG gap). `state` holds
    tensors or arrays."""
    structure = resolved_history_structure(cfg)
    if structure != "tiered":
        return {"structure": structure, "nruns": 0, "runs": []}

    def host(x):
        return x.cpu().numpy() if isinstance(x, Tensor) else np.asarray(x)

    nruns = int(host(state["nruns"]))
    rn = host(state["rn"])
    lo = min(max(int(since_runs), 0), nruns)
    runs = []
    for j in range(lo, nruns):
        rows = int(rn[j])
        runs.append((host(state["rkeys"][j, :rows]).astype(np.uint32),
                     host(state["rvers"][j, :rows])))
    return {"structure": structure, "nruns": nruns, "runs": runs}


def run_intervals(snapshot: Dict[str, object]):
    """Decode a history_run_snapshot into (begin_row, end_row, version)
    packed-key interval triples, oldest run first: even rows open a
    committed-write union range at their version, odd rows close it."""
    for keys, vers in snapshot["runs"]:
        for i in range(0, keys.shape[0] - 1, 2):
            yield keys[i], keys[i + 1], int(vers[i])


def build_batch_arrays(
    cfg: KernelConfig,
    rp_keys: List[bytes], rp_snap: List[int], rp_txn: List[int],
    r_keys_b: List[bytes], r_keys_e: List[bytes], r_snap: List[int], r_txn: List[int],
    wp_keys: List[bytes], wp_txn: List[int],
    w_keys_b: List[bytes], w_keys_e: List[bytes], w_txn: List[int],
    t_ok: np.ndarray, t_too_old: np.ndarray,
    now_rel: int, gc_rel: int,
) -> Dict[str, np.ndarray]:
    """Pad host-side range lists to the kernel's fixed shapes (numpy; the
    same arrays as the JAX package's build_batch_arrays).

    Layout invariant the fixpoint relies on: within each group, valid rows
    are a contiguous prefix grouped by ascending owning transaction."""
    for lst in (rp_txn, r_txn):
        if any(a > b for a, b in zip(lst, lst[1:])):
            raise ValueError("read rows must be grouped by ascending txn")
    Rp, Rr, Wp, Wr, K = cfg.rp, cfg.max_reads, cfg.wp, cfg.max_writes, cfg.lanes

    def padk(keys: List[bytes], cap: int, endpoint: bool = False) -> np.ndarray:
        arr = np.zeros((cap, K), np.uint32)
        if keys:
            pack = keypack.pack_endpoint_keys if endpoint else keypack.pack_keys
            arr[: len(keys)] = pack(keys, cfg.key_words)
        return arr

    def padi(vals: List[int], cap: int) -> np.ndarray:
        return np.pad(np.asarray(vals, np.int32), (0, cap - len(vals)))

    return {
        "rpb": padk(rp_keys, Rp),
        "rp_snap": padi(rp_snap, Rp),
        "rp_txn": padi(rp_txn, Rp),
        "rp_valid": np.arange(Rp) < len(rp_txn),
        "rb": padk(r_keys_b, Rr, endpoint=True),
        "re": padk(r_keys_e, Rr, endpoint=True),
        "r_snap": padi(r_snap, Rr),
        "r_txn": padi(r_txn, Rr),
        "r_valid": np.arange(Rr) < len(r_txn),
        "wpb": padk(wp_keys, Wp),
        "wp_txn": padi(wp_txn, Wp),
        "wp_valid": np.arange(Wp) < len(wp_txn),
        "wb": padk(w_keys_b, Wr, endpoint=True),
        "we": padk(w_keys_e, Wr, endpoint=True),
        "w_txn": padi(w_txn, Wr),
        "w_valid": np.arange(Wr) < len(w_txn),
        "t_ok": np.asarray(t_ok, bool),
        "t_too_old": np.asarray(t_too_old, bool),
        "now": np.asarray(now_rel, np.int32),
        "gc": np.asarray(gc_rel, np.int32),
    }
