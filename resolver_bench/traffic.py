"""Commit batches of one resolver deployment, generated from a seed.

One general generator reads a configuration (configs/<name>.json) and
builds from `--seed`:

  * each batch's commit version, which advances by a fixed step worked out
    from the deployment's nominal rate (never from the measured speed), and
    its GC horizon, the version less the write life;
  * each transaction's read snapshot, its reads and writes, and the
    conflict-wire block a client encodes for its commit request
    (core/wire.py's format, written here with numpy).

What a configuration says, and what each key defaults to:

  * the rate: `cluster_txn_per_s`, or `cluster_ops_per_s` over the
    binomial shape below (only transactions that write reach a resolver);
    `resolvers` in the cluster, of which the engine serves
    `resolvers_served` (1); `proxies` batching every `batch_interval_s`;
    `versions_per_second`; `max_write_transaction_life_versions`;
  * the shape: `ops_per_txn` ops, each a write with `write_probability`
    (binomial), or `reads_per_txn` and `writes_per_txn` (fixed), with
    `writes_on_read_keys` (false) to write the first keys read;
  * the keys: `keys` ids of `key_bytes` bytes, drawn by
    `key_distribution` ("uniform", or "zipf" with `zipf_theta` and
    `zipf_key_seed`); with `keys_adjacent` (false) a transaction's keys run
    on from one draw, as a ring's neighbours do;
  * ranges: a read is the range of `range_keys` [lo, hi] ids from its key
    with probability `range_read_share` (0), a write with
    `range_write_share` (0);
  * snapshots: one step plus `snapshot_lag_versions` [lo, hi] behind the
    batch's version, and `long_lived_share` of transactions
    `long_lived_lag_versions` [lo, hi] behind.

Every seed gives the same number of batches and transactions a batch; the
seed draws the operations, keys and snapshot lags. The program gets only
the transactions; the reference (reference.py) gets the key ids, a range
expanded to the ids it holds. Imports nothing of the program.
"""
from __future__ import annotations

import gc
import math
import struct
from dataclasses import dataclass
from itertools import repeat
from operator import itemgetter
from typing import List, NamedTuple, Tuple

import numpy as np

#: every key starts with these 8 bytes; the key id follows big-endian
KEY_PREFIX = b"fdbbench"
#: batches generated per numpy pass (bounds the temporaries)
CHUNK_BATCHES = 64
#: conflict-wire kinds of a point and of a range (core/wire.py)
KIND_POINT, KIND_RANGE = 0, 1


@dataclass(frozen=True)
class Sizes:
    """What the configuration's published numbers give one resolver."""

    txn_per_s: float          # nominal rate of the resolvers the engine serves
    batches_per_s: float      # commit batches a second over all proxies
    txns_per_batch: int
    version_step: int         # versions between consecutive batches
    horizon_batches: int      # batches in one write life


def sizes(cfg: dict) -> Sizes:
    """The engine's share of the cluster: the cluster's transactions that
    write (read-only ones never reach a resolver), times the share of its
    resolvers the engine serves; batches from the proxies' interval."""
    if "cluster_txn_per_s" in cfg:
        cluster = float(cfg["cluster_txn_per_s"])
    else:
        ops, p = cfg["ops_per_txn"], cfg["write_probability"]
        cluster = cfg["cluster_ops_per_s"] / ops * (1 - (1 - p) ** ops)
    txn_per_s = cluster * cfg.get("resolvers_served", 1) / cfg["resolvers"]
    batches_per_s = cfg["proxies"] / cfg["batch_interval_s"]
    step = round(cfg["versions_per_second"] / batches_per_s)
    return Sizes(txn_per_s=txn_per_s, batches_per_s=batches_per_s,
                 txns_per_batch=round(txn_per_s / batches_per_s), version_step=step,
                 horizon_batches=math.ceil(cfg["max_write_transaction_life_versions"] / step))


class Range(NamedTuple):
    """A conflict range as the engine's general router reads it."""

    begin: bytes
    end: bytes


class WireTxn(tuple):
    """A transaction as the resolver receives it, (read snapshot, wire
    info): its conflict-wire block encoded once, as a client encodes its
    commit request, with (all point rows, longest key) beside it (the
    engine's columnar pack reads `conflict_wire_info`; its general router
    reads the ranges, decoded from the block when asked). A tuple, so a
    batch of them is built without a Python call each."""

    __slots__ = ()
    read_snapshot = property(itemgetter(0))

    def conflict_wire_info(self) -> Tuple[bytes, bool, int]:
        return self[1]

    @property
    def read_conflict_ranges(self) -> List[Range]:
        return decode_block(self[1][0])[0]

    @property
    def write_conflict_ranges(self) -> List[Range]:
        return decode_block(self[1][0])[1]


def decode_block(block: bytes) -> Tuple[List[Range], List[Range]]:
    """A conflict-wire block's (reads, writes)."""
    nr, nw = struct.unpack_from("<II", block, 0)
    off, out = 8, []
    for _ in range(nr + nw):
        (hdr,) = struct.unpack_from("<I", block, off)
        n, kind = hdr & (1 << 30) - 1, hdr >> 30
        begin = block[off + 4:off + 4 + n]
        off += 4 + n
        if kind == KIND_POINT:
            out.append(Range(begin, begin + b"\0"))
            continue
        (n,) = struct.unpack_from("<I", block, off)
        out.append(Range(begin, block[off + 4:off + 4 + n]))
        off += 4 + n
    return out[:nr], out[nr:]


class KeySampler:
    """Key ids over [0, keys): uniform, or Zipf(theta) by YCSB's
    ZipfianGenerator (Gray et al., "Quickly generating billion-record
    synthetic databases"), whose ranks a permutation maps to ids. Which
    keys are hot belongs to the data set, not to a run: the permutation
    comes from the configuration's `zipf_key_seed`, and a run's seed draws
    only the requests."""

    def __init__(self, cfg: dict):
        self.n = int(cfg["keys"])
        self.kind = cfg["key_distribution"]
        if self.kind == "zipf":
            theta = float(cfg["zipf_theta"])
            ranks = np.arange(1, self.n + 1, dtype=np.float64)
            self.zetan = float(np.sum(ranks ** -theta))
            zeta2 = 1.0 + 0.5 ** theta
            self.theta = theta
            self.alpha = 1.0 / (1.0 - theta)
            self.eta = (1 - (2.0 / self.n) ** (1 - theta)) / (1 - zeta2 / self.zetan)
            self.perm = np.random.default_rng(int(cfg["zipf_key_seed"])).permutation(
                self.n).astype(np.int64)
        elif self.kind != "uniform":
            raise ValueError(f"unknown key_distribution {self.kind!r}")

    def rank_share(self, rank: int) -> float:
        """The share of draws that rank takes (0 is the hottest)."""
        if self.kind == "uniform":
            return 1.0 / self.n
        return (rank + 1) ** -self.theta / self.zetan

    def draw(self, rng: np.random.Generator, size: int) -> np.ndarray:
        if self.kind == "uniform":
            return rng.integers(0, self.n, size, dtype=np.int64)
        u = rng.random(size)
        uz = u * self.zetan
        rank = (self.n * (self.eta * u - self.eta + 1) ** self.alpha).astype(np.int64)
        rank = np.where(uz < 1.0 + 0.5 ** self.theta, 1, rank)
        rank = np.where(uz < 1.0, 0, np.minimum(rank, self.n - 1))
        return self.perm[rank]


class Traffic:
    """`n_batches` commit batches of one deployment from one seed.

    Per transaction (batch b holds transactions [b*T, (b+1)*T)): `snap`,
    and the ids it reads r_key[r_off[i]:r_off[i+1]] and writes
    w_key[w_off[i]:w_off[i+1]] (a range as every id it holds); `rows` the
    point and range reads and writes it sends (n, 4); `txns[b]` the batch
    as WireTxn objects."""

    def __init__(self, cfg: dict, seed: int, n_batches: int):
        self.cfg = cfg
        s = sizes(cfg)
        self.n_batches = n_batches
        self.T = T = s.txns_per_batch
        self.step = s.version_step
        self.life = int(cfg["max_write_transaction_life_versions"])
        #: the first batch's version: one write life in, so no horizon or
        #: snapshot is below 0
        self.v0 = 2 * self.life
        self.key_bytes = int(cfg["key_bytes"])
        if self.key_bytes < len(KEY_PREFIX) + 8 or self.key_bytes % 4:
            raise ValueError(f"key_bytes {self.key_bytes}: not whole words after an "
                             f"{len(KEY_PREFIX)}-byte prefix and an 8-byte key id")
        rng = np.random.default_rng(int(seed) % 2**64)
        self.keys = KeySampler(cfg)
        parts = {k: [] for k in ("snap", "r_key", "w_key", "r_cnt", "w_cnt", "rows")}
        self.txns: List[List[WireTxn]] = []
        collecting = gc.isenabled()
        gc.disable()        # millions of small objects: no collection can free one
        try:
            for b0 in range(0, n_batches, CHUNK_BATCHES):
                nb = min(CHUNK_BATCHES, n_batches - b0)
                snap, ops, ids = self._draw(rng, b0, nb)
                blocks = self._encode(ops)
                ranges = ops["rows"][:, 2:].sum(axis=1)
                points = (ranges == 0).tolist() if ranges.any() else repeat(True)
                infos = zip(blocks, points, repeat(self.key_bytes))
                chunk = list(map(WireTxn, zip(snap.tolist(), infos)))
                self.txns.extend(chunk[i * T:(i + 1) * T] for i in range(nb))
                parts["snap"].append(snap)
                for side in ("r", "w"):
                    parts[f"{side}_cnt"].append(ids[side][0])
                    parts[f"{side}_key"].append(ids[side][1])
                parts["rows"].append(ops["rows"])
        finally:
            if collecting:
                gc.enable()
        self.snap = np.concatenate(parts["snap"])
        self.r_key = np.concatenate(parts["r_key"])
        self.w_key = np.concatenate(parts["w_key"])
        self.r_off = np.concatenate([[0], np.cumsum(np.concatenate(parts["r_cnt"]))])
        self.w_off = np.concatenate([[0], np.cumsum(np.concatenate(parts["w_cnt"]))])
        #: point reads, point writes, range reads, range writes a transaction
        self.rows = np.concatenate(parts["rows"])

    # -- versions ------------------------------------------------------------
    def now(self, b: int) -> int:
        return self.v0 + b * self.step

    def new_oldest(self, b: int) -> int:
        return self.now(b) - self.life

    # -- generation ------------------------------------------------------------
    def _draw(self, rng: np.random.Generator, b0: int, nb: int):
        """nb batches from batch b0: (snapshots; the ops in block order, each
        transaction's reads then its writes by first id, repeats of a point
        coalesced as a client does: `txn`, `write`, `range`, `first` id,
        `end` id, and `rows`, each transaction's point reads, point writes,
        range reads and range writes; for each side the ids each
        transaction touches, as (count a transaction, ids))."""
        cfg, T, nk = self.cfg, self.T, self.keys.n
        n = nb * T
        if "ops_per_txn" in cfg:
            # writes a transaction: Binomial(ops, p) given at least one,
            # since only transactions that write are sent; keys are drawn
            # alike for every op, so the first `writes` ops are the writes
            ops, p = int(cfg["ops_per_txn"]), float(cfg["write_probability"])
            k = np.arange(1, ops + 1)
            pmf = np.array([math.comb(ops, int(i)) for i in k]) * p ** k * (1 - p) ** (ops - k)
            cdf = np.cumsum(pmf) / pmf.sum()
            writes = 1 + np.searchsorted(cdf[:-1], rng.random(n), side="right")
            is_w = np.arange(ops) < writes[:, None]
            cols, col_of_op = ops, None
        else:
            nr, nw = int(cfg["reads_per_txn"]), int(cfg["writes_per_txn"])
            on_reads = bool(cfg.get("writes_on_read_keys", False))
            cols = max(nr, nw) if on_reads else nr + nw
            is_w = np.broadcast_to(np.arange(nr + nw) >= nr, (n, nr + nw))
            col_of_op = np.concatenate([np.arange(nr), np.arange(nw) + (0 if on_reads else nr)])
        if cfg.get("keys_adjacent", False):
            keys = (self.keys.draw(rng, n)[:, None] + np.arange(cols)) % nk
        else:
            keys = self.keys.draw(rng, n * cols).reshape(n, cols)
        first = keys if col_of_op is None else keys[:, col_of_op]
        shares = (float(cfg.get("range_read_share", 0.0)), float(cfg.get("range_write_share", 0.0)))
        ranges = any(shares)
        # an op's code orders reads before writes, each by first id, a
        # point before a range from the same id; a point's code repeated
        # on one side is sent once
        code = (is_w * (2 * nk) + first) * 2
        if ranges:
            is_range = rng.random(first.shape) < np.where(is_w, shares[1], shares[0])
            lo, hi = cfg["range_keys"]
            end = np.minimum(first + np.where(is_range, rng.integers(lo, hi + 1, first.shape), 1),
                             nk)
            code += is_range
            order = np.lexsort((end, code), axis=1)
            code, end = np.take_along_axis(code, order, axis=1), np.take_along_axis(end, order, axis=1)
        else:
            code = np.sort(code, axis=1)
        keep = np.ones(code.shape, dtype=bool)
        write = code >= 4 * nk
        first = code // 2 - write * (2 * nk)
        if ranges:
            is_range = code % 2 == 1
            keep[:, 1:] = (code[:, 1:] != code[:, :-1]) | is_range[:, 1:]
        else:
            keep[:, 1:] = code[:, 1:] != code[:, :-1]
        kept_w = keep & write
        rows = np.zeros((n, 4), dtype=np.int64)
        rows[:, 1] = np.count_nonzero(kept_w, axis=1)
        rows[:, 0] = np.count_nonzero(keep, axis=1) - rows[:, 1]
        if ranges:
            rows[:, 3] = np.count_nonzero(kept_w & is_range, axis=1)
            rows[:, 2] = np.count_nonzero(keep & is_range, axis=1) - rows[:, 3]
            rows[:, :2] -= rows[:, 2:]
        txn = np.nonzero(keep)[0]
        out = {"txn": txn, "write": write[keep], "first": first[keep], "rows": rows,
               "range": is_range[keep] if ranges else np.zeros(len(txn), dtype=bool)}
        out["end"] = end[keep] if ranges else out["first"] + 1
        ids = {}
        for side, is_write in (("r", False), ("w", True)):
            sel = out["write"] == is_write
            a = out["first"][sel]
            if ranges:
                width = out["end"][sel] - a
                rep = np.repeat(np.arange(len(a)), width)
                a = a[rep] + np.arange(len(rep)) - np.repeat(np.cumsum(width) - width, width)
                count = np.bincount(txn[sel][rep], minlength=n)
            else:
                count = rows[:, int(is_write)]
            ids[side] = (count, a.astype(np.int32))
        lo, hi = cfg["snapshot_lag_versions"]
        lag = rng.integers(lo, hi + 1, n, dtype=np.int64)
        long_lived = rng.random(n) < float(cfg.get("long_lived_share", 0.0))
        if long_lived.any():
            llo, lhi = cfg["long_lived_lag_versions"]
            lag[long_lived] = rng.integers(llo, lhi + 1, int(long_lived.sum()), dtype=np.int64)
        now = self.v0 + (b0 + np.arange(n, dtype=np.int64) // T) * self.step
        return now - self.step - lag, out, ids

    def _encode(self, ops: dict) -> List[bytes]:
        """Each transaction's conflict-wire block: [u32 n_read][u32 n_write],
        then its ops in order, a point [u32 len | POINT << 30][key] and a
        range [u32 len | RANGE << 30][begin][u32 len][end]. Every field is
        whole 32-bit words, so the blocks are one word stream: two header
        words a transaction, every other word the next op's, in order."""
        L = self.key_bytes
        kw = L // 4
        is_range, rows = ops["range"], ops["rows"]
        n = len(rows)
        ranges = bool(is_range.any())
        op_words = 1 + kw + is_range * (1 + kw)
        size = 2 + rows[:, :2].sum(axis=1) * (1 + kw) + rows[:, 2:].sum(axis=1) * (2 + 2 * kw)
        starts = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(size, out=starts[1:])
        op = np.zeros((len(op_words), 2 + 2 * kw if ranges else 1 + kw), dtype="<u4")
        prefix = np.frombuffer(KEY_PREFIX + b"\0" * (L - len(KEY_PREFIX) - 8), dtype="<u4")
        op[:, 0] = L | np.where(is_range, KIND_RANGE, KIND_POINT).astype("<u4") << 30
        op[:, 1:1 + len(prefix)] = prefix
        op[:, kw - 1:kw + 1] = ops["first"].astype(">u8").view("<u4").reshape(-1, 2)
        if ranges:
            op[:, kw + 1] = L
            op[:, kw + 2:kw + 2 + len(prefix)] = prefix
            op[:, 2 * kw:] = ops["end"].astype(">u8").view("<u4").reshape(-1, 2)
            body = op[np.arange(op.shape[1]) < op_words[:, None]]
        else:
            body = op.ravel()
        words = np.empty(int(starts[-1]), dtype="<u4")
        header = np.zeros(len(words), dtype=bool)
        header[starts[:-1]] = header[starts[:-1] + 1] = True
        words[starts[:-1]] = rows[:, 0::2].sum(axis=1)
        words[starts[:-1] + 1] = rows[:, 1::2].sum(axis=1)
        words[~header] = body
        data = words.tobytes()
        s = (4 * starts).tolist()
        return list(map(data.__getitem__, map(slice, s[:-1], s[1:])))

    # -- views -------------------------------------------------------------------
    def key_bytes_of(self, key_id: int) -> bytes:
        """The key a key id stands for."""
        pad = self.key_bytes - len(KEY_PREFIX) - 8
        return KEY_PREFIX + b"\x00" * pad + int(key_id).to_bytes(8, "big")

    def batch(self, b: int) -> Tuple[int, int]:
        """Batch b's transactions as [lo, hi)."""
        return b * self.T, (b + 1) * self.T

    def too_old(self, b: int) -> np.ndarray:
        """Which of batch b's transactions read below the horizon the
        batch before set (the resolver answers TOO_OLD)."""
        lo, hi = self.batch(b)
        oldest = self.new_oldest(b - 1) if b else 0
        reads = np.diff(self.r_off[lo:hi + 1]) > 0
        return (self.snap[lo:hi] < oldest) & reads

    def valid_rows(self, b: int) -> Tuple[int, int, int, int]:
        """Point reads, point writes, range reads and range writes batch b
        puts on the device: a TOO_OLD transaction's rows are left out."""
        lo, hi = self.batch(b)
        return tuple(int(x) for x in self.rows[lo:hi][~self.too_old(b)].sum(axis=0))
