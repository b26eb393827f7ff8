"""The plain resolver that decides `correct`: serial, earlier transaction wins.

It reads the generator's key ids and snapshots (traffic.py; a range as
every id it holds), never the program's state or output, and works the
conflict history out again by itself: for each key the version of its last committed write, with the
keys written at each version listed so that GC at each batch's horizon
drops them. Each transaction of a batch, in order, is

  * TOO_OLD when it reads and its snapshot is below the horizon the batch
    before set;
  * CONFLICT when a key it reads was last written at a version above its
    snapshot, or by a transaction committed earlier in the same batch;
  * COMMITTED otherwise.

The history test is one numpy pass over the batch's reads. The batch test
walks in order only the transactions that read or write a key that both a
read and a write of the batch touch: no other write can block a read of
the batch. The batch's committed writes then take its version, and every
write below its horizon is dropped. `rows_max` counts the boundary rows a
table of point writes holds at its fullest, 1 + 2 per live key once a
batch's writes are in and before its GC (a range write counted as its
keys' points: an upper bound); `rows_last` the rows after the last
batch's GC.

The control (`intra_batch=False`) is this resolver without the batch test:
each transaction judged against the history alone, which breaks the
configuration's "within a batch the earlier transaction wins".
Imports nothing of the program.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np

#: verdict codes (the proxy combines them with min)
CONFLICT, TOO_OLD, COMMITTED = 0, 1, 2
#: the last-write version of a key with no live write
NEVER = -(2**62)


class Resolution(NamedTuple):
    verdicts: List[np.ndarray]   # one int8 array a batch
    rows_max: int                # rows at the fullest, before a batch's GC
    rows_last: int               # rows after the last batch's GC


def resolve(traffic, n_batches: int, intra_batch: bool = True) -> Resolution:
    """Verdicts of batches [0, n_batches) and the table's row counts."""
    last = np.full(int(traffic.cfg["keys"]), NEVER, dtype=np.int64)
    written_at: Dict[int, np.ndarray] = {}
    live = oldest = 0
    rows_max = 1
    out: List[np.ndarray] = []
    for b in range(n_batches):
        now = traffic.now(b)
        lo, hi = traffic.batch(b)
        nr = np.diff(traffic.r_off[lo:hi + 1])
        nw = np.diff(traffic.w_off[lo:hi + 1])
        rk = traffic.r_key[traffic.r_off[lo]:traffic.r_off[hi]].astype(np.int64)
        wk = traffic.w_key[traffic.w_off[lo]:traffic.w_off[hi]].astype(np.int64)
        rt = np.repeat(np.arange(hi - lo), nr)        # the transaction of each read
        wt = np.repeat(np.arange(hi - lo), nw)
        snap = traffic.snap[lo:hi]
        too_old = (snap < oldest) & (nr > 0)
        committed = ~too_old
        committed[rt[last[rk] > snap[rt]]] = False
        if intra_batch:
            _earlier_wins(committed, rk, rt, wk, wt)
        out.append(np.where(too_old, TOO_OLD,
                            np.where(committed, COMMITTED, CONFLICT)).astype(np.int8))
        keys = np.unique(wk[committed[wt]])
        live += int(np.count_nonzero(last[keys] == NEVER))
        last[keys] = now
        written_at[now] = keys
        rows_max = max(rows_max, 1 + 2 * live)
        oldest = max(oldest, traffic.new_oldest(b))
        for v in sorted(v for v in written_at if v < oldest):
            keys = written_at.pop(v)
            dead = keys[last[keys] == v]
            last[dead] = NEVER
            live -= len(dead)
    return Resolution(out, rows_max, 1 + 2 * live)


def _earlier_wins(committed: np.ndarray, rk, rt, wk, wt) -> None:
    """Within one batch, in transaction order: a transaction still
    committed that reads a key an earlier committed one wrote conflicts."""
    r_ok, w_ok = committed[rt], committed[wt]
    shared = np.intersect1d(rk[r_ok], wk[w_ok])
    if not shared.size:
        return
    r_rel = r_ok & np.isin(rk, shared)
    w_rel = w_ok & np.isin(wk, shared)
    reads: Dict[int, List[int]] = {}
    for t, k in zip(rt[r_rel].tolist(), rk[r_rel].tolist()):
        reads.setdefault(t, []).append(k)
    writes: Dict[int, List[int]] = {}
    for t, k in zip(wt[w_rel].tolist(), wk[w_rel].tolist()):
        writes.setdefault(t, []).append(k)
    batch_writes = set()
    for t in sorted(reads.keys() | writes.keys()):
        if any(k in batch_writes for k in reads.get(t, ())):
            committed[t] = False
        else:
            batch_writes.update(writes.get(t, ()))


def mismatches(got: List[np.ndarray], want: List[np.ndarray]) -> int:
    """Transactions whose verdicts differ; a batch of another length counts
    every transaction of the longer, a batch missing from `got` all of its."""
    n = sum(len(w) for w in want[len(got):])
    for g, w in zip(got, want):
        if len(g) != len(w):
            n += max(len(g), len(w))
        else:
            n += int(np.count_nonzero(g != w))
    return n
