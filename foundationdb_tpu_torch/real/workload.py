"""Open-loop Zipfian workload fleet for the wall-clock cluster.

Port of ``foundationdb_tpu/real/workload.py``.

The bench's latency harness drives the SIM cluster with a Poisson stream;
nothing modelled realistic traffic against the real transport (ROADMAP
item 4). This fleet does: multi-tenant open-loop streams over real
sockets, each tenant an independent Poisson arrival process at its own
target txn/s over its own Zipf(s)-skewed hot-key pool. Open-loop is the
honest shape (Harmonia-style offered load): a txn is submitted at its
arrival time regardless of outstanding ones, so server-side queueing
shows up as client latency, never as politely reduced load. Skew is the
point — Proust's design-space analysis (PAPERS.md) shows optimistic
schemes bite under hot-key contention, so robustness is proven at
s ∈ {0, 0.9, 1.2}, not under uniform smoke traffic.

The fleet is transport-agnostic: it drives a `submit(spec, reads,
writes)` coroutine (real/nemesis.py supplies one over ChaosTransport) and
records (t_submit, latency_s, ok, version, err_name) per tenant — the
shape `pipeline/latency_harness.percentile_outside_windows` asserts SLOs
over (docs/real_cluster.md).
"""
from __future__ import annotations

import asyncio
import bisect
import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..core.rng import DeterministicRandom

#: ack error names that are honest, full-path verdicts (their latency
#: belongs in the SLO population, like the sim harness's conflict acks)
VERDICT_ERRORS = ("not_committed", "transaction_too_old")
#: txn-shape registry (docs/scenarios.md): how a tenant stream turns
#: sampled key indices into (reads, writes) lists. "zipf" is the classic
#: independent point-read/point-write stream every pre-atlas campaign
#: ran; the rest model the scenario atlas's production access shapes. A
#: write entry is either a point key (bytes) or a (begin, end) RANGE
#: tuple — TTL sweeps clear whole segments in one conflict range.
TXN_SHAPES = ("zipf", "rmw", "fanout", "monotone", "queue", "ttl_cache")
#: fast typed rejection from per-tenant admission control — NOT a latency
#: sample (the tenant was told to back off in microseconds); reported as
#: rejected_frac instead
THROTTLE_ERROR = "transaction_throttled"


def zipf_cdf(n_keys: int, s: float) -> List[float]:
    """Cumulative Zipf(s) distribution over ranks 1..n (s=0 -> uniform)."""
    weights = [1.0 / (k ** s) for k in range(1, n_keys + 1)]
    total = sum(weights)
    cdf, acc = [], 0.0
    for w in weights:
        acc += w / total
        cdf.append(acc)
    cdf[-1] = 1.0
    return cdf


class ZipfKeySampler:
    """Seeded rank-Zipf sampler: rank 0 is the hottest key. Inverse-CDF
    via bisect — O(log n) per draw, no numpy in the hot path.

    `drift` rotates the rank->key mapping over time: at elapsed time t
    the hottest RANK lands on key index `int(drift * t) % n_keys`, so the
    hot range sweeps the tenant's keyspace — the diurnal-shift model the
    drift campaign (real/nemesis.py) reshards under. drift=0 keeps the
    classic static mapping."""

    def __init__(self, n_keys: int, s: float, rng: DeterministicRandom,
                 drift: float = 0.0):
        self.n_keys = n_keys
        self.s = s
        self.rng = rng
        self.drift = float(drift)
        self._cdf = zipf_cdf(n_keys, s)

    def sample(self, t_rel: float = 0.0) -> int:
        rank = bisect.bisect_left(self._cdf, self.rng.random01())
        if self.drift:
            rank = (rank + int(self.drift * t_rel)) % self.n_keys
        return rank


@dataclass
class TenantSpec:
    """One tenant's stream: open-loop Poisson at `target_tps` over a
    `n_keys` pool with Zipf skew `s` (0 = uniform)."""

    name: str
    target_tps: float
    s: float = 0.0
    n_keys: int = 512
    reads_per_txn: int = 2
    writes_per_txn: int = 2
    key_prefix: bytes = b""
    #: hot-range drift in key indices per second (0 = stationary): the
    #: Zipf head sweeps the pool at this speed, so load concentration
    #: MOVES through the keyspace over the campaign
    drift_keys_per_s: float = 0.0
    #: txn shape (one of TXN_SHAPES): how sampled indices become the
    #: commit's reads/writes. "zipf" keeps the pre-atlas stream
    #: byte-identical (same rng draws in the same order).
    shape: str = "zipf"
    #: ttl_cache only: one commit in `ttl_sweep_every` is a TTL sweep —
    #: ONE (begin, end) range delete spanning `ttl_sweep_span` key
    #: indices of the tenant's pool
    ttl_sweep_every: int = 24
    ttl_sweep_span: int = 64

    def prefix(self) -> bytes:
        return self.key_prefix or self.name.encode()


class TxnShaper:
    """Per-stream seeded (reads, writes) generator for one tenant.

    One instance per tenant stream: the monotone/queue shapes carry a
    tail counter, and the op-mix shapes draw from their OWN
    DeterministicRandom so the sampler's Zipf stream stays untouched.
    The "zipf" shape is stateless and never touches `rng` — the fleet
    passes rng=None there so the legacy per-tenant seed stream (and
    therefore every pre-atlas campaign) is byte-identical."""

    def __init__(self, spec: TenantSpec, sampler: ZipfKeySampler,
                 rng: Optional[DeterministicRandom] = None):
        if spec.shape not in TXN_SHAPES:
            raise ValueError(
                f"unknown txn shape {spec.shape!r} (one of {TXN_SHAPES})")
        self.spec = spec
        self.sampler = sampler
        self.rng = rng
        #: monotone/queue tail position (key index of the newest row)
        self.counter = 0

    def build(self, t_rel: float = 0.0) -> Tuple[List, List]:
        spec, sampler = self.spec, self.sampler
        pfx = spec.prefix()

        def key(i: int) -> bytes:
            return b"%s/%06d" % (pfx, max(int(i), 0))

        shape = spec.shape
        if shape == "zipf":
            reads = [key(sampler.sample(t_rel))
                     for _ in range(spec.reads_per_txn)]
            writes = [key(sampler.sample(t_rel))
                      for _ in range(spec.writes_per_txn)]
            return reads, writes
        if shape == "rmw":
            # read-modify-write chain: every written row is read first
            # at the same snapshot (the balance rows of a payment
            # ledger) — the conflict-heavy shape Proust's design-space
            # analysis shows optimistic schemes bite on
            ks, seen = [], set()
            for _ in range(max(spec.writes_per_txn, 1)):
                i = sampler.sample(t_rel)
                if i not in seen:
                    seen.add(i)
                    ks.append(i)
            keys = [key(i) for i in ks]
            return keys, list(keys)
        if shape == "fanout":
            # secondary-index maintenance: one base-row update fans out
            # to index entries under disjoint `.ixN` prefixes — ONE txn
            # whose conflict ranges span multiple key ranges
            base = sampler.sample(t_rel)
            writes = [key(base)] + [
                b"%s.ix%d/%06d" % (pfx, j, sampler.sample(t_rel))
                for j in range(max(spec.writes_per_txn, 1))]
            return [key(base)], writes
        if shape == "monotone":
            # time-series ingest: every commit appends at the tail, so
            # the hottest range is always the NEWEST one — adversarial
            # for static key-range splits (the tail outruns any split
            # chosen from past heat)
            self.counter += 1
            tail = self.counter
            reads = [key(tail - 1 - self.rng.random_int(0, 8))
                     for _ in range(max(spec.reads_per_txn, 1))]
            return reads, [key(tail)]
        if shape == "queue":
            # task queue: producers append at the tail, consumers claim
            # at the head by read-then-write of the same slot — the
            # future commutative-lane showcase (appends commute; claims
            # contend on the head)
            if self.rng.random01() < 0.5:
                self.counter += 1
                return [], [key(self.counter)]
            head = self.counter - self.rng.random_int(0, 15)
            return [key(head)], [key(head)]
        # ttl_cache — session cache: read-mostly point gets with a
        # cadenced TTL sweep: ONE (begin, end) RANGE delete clearing a
        # cold segment of the pool in a single conflict range
        self.counter += 1
        if self.counter % max(spec.ttl_sweep_every, 1) == 0:
            lo = sampler.sample(t_rel)
            return [], [(key(lo), key(lo + max(spec.ttl_sweep_span, 1)))]
        reads = [key(sampler.sample(t_rel))
                 for _ in range(max(spec.reads_per_txn, 1))]
        writes = ([key(sampler.sample(t_rel))]
                  if self.rng.random01() < 0.125 else [])
        return reads, writes


@dataclass
class FleetReport:
    """What the fleet observed, per tenant and overall."""

    #: tenant -> [(t_submit, latency_s, ok, version, err_name)]
    records: Dict[str, List[Tuple]] = field(default_factory=dict)
    #: tenant -> error name -> count (transport errors, throttles, ...)
    errors: Dict[str, Dict[str, int]] = field(default_factory=dict)
    offered: Dict[str, int] = field(default_factory=dict)
    t_start: float = 0.0
    t_end: float = 0.0

    def ack_records(self, tenant: Optional[str] = None) -> List[Tuple]:
        """Latency-population records (committed + verdict acks): the SLO
        sample set, as (t0, lat, ok, version) 4-tuples."""
        out = []
        for name, recs in self.records.items():
            if tenant is not None and name != tenant:
                continue
            for t0, lat, ok, version, err in recs:
                if ok or err in VERDICT_ERRORS:
                    out.append((t0, lat, ok, version))
        out.sort(key=lambda r: r[0])
        return out

    def counts(self, tenant: Optional[str] = None) -> Dict[str, int]:
        sel = [(n, r) for n, r in self.records.items()
               if tenant is None or n == tenant]
        committed = sum(1 for _n, recs in sel for r in recs if r[2])
        conflicted = sum(1 for _n, recs in sel for r in recs
                         if not r[2] and r[4] in VERDICT_ERRORS)
        throttled = sum(e.get(THROTTLE_ERROR, 0)
                        for n, e in self.errors.items()
                        if tenant is None or n == tenant)
        transport = sum(c for n, e in self.errors.items()
                        if tenant is None or n == tenant
                        for k, c in e.items()
                        if k not in VERDICT_ERRORS + (THROTTLE_ERROR,))
        offered = sum(c for n, c in self.offered.items()
                      if tenant is None or n == tenant)
        return {"offered": offered, "committed": committed,
                "conflicted": conflicted, "throttled": throttled,
                "transport_errors": transport}

    def sustained_tps(self, tenant: Optional[str] = None) -> float:
        acks = self.ack_records(tenant)
        if len(acks) < 2:
            return 0.0
        span = acks[-1][0] - acks[0][0]
        return len(acks) / max(span, 1e-9)


class WorkloadFleet:
    """Drive every tenant's open-loop stream concurrently on asyncio."""

    def __init__(self, tenants: List[TenantSpec],
                 submit: Callable, seed: int = 0,
                 duration_s: float = 5.0,
                 max_outstanding: int = 2048,
                 report: Optional[FleetReport] = None):
        self.tenants = tenants
        self.submit = submit
        self.seed = seed
        self.duration_s = duration_s
        #: open-loop guard rail: past this many outstanding submissions a
        #: tenant sheds locally (records a client_overload error) instead
        #: of growing the task set without bound while the server is
        #: partitioned away — the open-loop contract holds far beyond any
        #: SLO-passing regime, this only bounds memory in the failed one
        self.max_outstanding = max_outstanding
        #: pass an existing report to APPEND a phase (the campaign's
        #: post-recovery cooldown records into the same population)
        self.report = report if report is not None else FleetReport()
        self._outstanding: Dict[str, int] = {}
        self._phase_start = 0.0

    async def _one_txn(self, spec: TenantSpec, shaper: TxnShaper) -> None:
        from ..core import error as _error

        rep = self.report
        t_rel = time.monotonic() - (rep.t_start or self._phase_start)
        reads, writes = shaper.build(t_rel)
        t0 = time.monotonic()
        ok, version, err = False, None, None
        try:
            version = await self.submit(spec, reads, writes)
            ok = True
        except _error.FDBError as e:
            err = e.name
        except (ConnectionError, OSError) as e:
            err = type(e).__name__
        lat = time.monotonic() - t0
        if err is not None and err not in VERDICT_ERRORS:
            rep.errors[spec.name][err] = rep.errors[spec.name].get(err, 0) + 1
        if ok or err in VERDICT_ERRORS:
            rep.records[spec.name].append((t0, lat, ok, version, err))
        self._outstanding[spec.name] -= 1

    async def _tenant_stream(self, spec: TenantSpec,
                             rng: DeterministicRandom) -> None:
        sampler = ZipfKeySampler(spec.n_keys, spec.s,
                                 DeterministicRandom(rng.random_int(0, 2**31 - 1)),
                                 drift=spec.drift_keys_per_s)
        # the zipf shape draws NO extra seed: the legacy arrival stream
        # (and every pre-atlas campaign) stays byte-identical
        shape_rng = (DeterministicRandom(rng.random_int(0, 2**31 - 1))
                     if spec.shape != "zipf" else None)
        shaper = TxnShaper(spec, sampler, shape_rng)
        lam = max(spec.target_tps, 1e-3)
        t_end = self._phase_start + self.duration_s
        tasks: set = set()
        while time.monotonic() < t_end:
            await asyncio.sleep(-math.log(max(rng.random01(), 1e-12)) / lam)
            self.report.offered[spec.name] = \
                self.report.offered.get(spec.name, 0) + 1
            if self._outstanding[spec.name] >= self.max_outstanding:
                e = self.report.errors[spec.name]
                e["client_overload"] = e.get("client_overload", 0) + 1
                continue
            self._outstanding[spec.name] += 1
            t = asyncio.ensure_future(self._one_txn(spec, shaper))
            tasks.add(t)
            t.add_done_callback(tasks.discard)
        if tasks:
            await asyncio.wait(tasks, timeout=10.0)

    async def run(self) -> FleetReport:
        rng = DeterministicRandom(self.seed)
        rep = self.report
        if not rep.t_start:
            rep.t_start = time.monotonic()
        self._phase_start = time.monotonic()
        for spec in self.tenants:
            rep.records.setdefault(spec.name, [])
            rep.errors.setdefault(spec.name, {})
            rep.offered.setdefault(spec.name, 0)
            self._outstanding[spec.name] = 0
        streams = [
            self._tenant_stream(spec,
                                DeterministicRandom(rng.random_int(0, 2**31 - 1)))
            for spec in self.tenants
        ]
        await asyncio.gather(*streams)
        rep.t_end = time.monotonic()
        return rep
