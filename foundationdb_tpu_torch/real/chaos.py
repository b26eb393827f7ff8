"""Wall-clock network nemesis: seeded fault injection for the real transport.

Port of ``foundationdb_tpu/real/chaos.py``.

The sim cluster's nemesis coverage stops at the process boundary — the
wall-clock layer (real/transport.py) that actually fronts traffic had no
fault injection at all (ROADMAP item 4). This module is the missing
counterpart of sim2's clogging/partition machinery for REAL sockets:

  * `NetworkNemesis` — one seeded decision engine per campaign, shared by
    every endpoint in the process. It draws background faults (added
    latency, frame drops, connection resets, handshake stalls) from knob
    defaults (`chaos_net_*`, core/knobs.py) and holds the asymmetric
    partition schedule between NAMED processes ("client-a" -> "resolver"
    blocked while the reverse direction flows — the classic one-way
    blackhole the sim's symmetric clogs never model).
  * `ChaosTransport` — the shim over a `RealNetwork`: same request /
    one_way surface, faults applied around the inner call. Requests inside
    a partition window fail as `connection_failed`; drops surface as
    `request_maybe_delivered` (the transport's redelivery semantics);
    resets tear the peer connection down mid-flight so reconnect backoff
    (real/transport.py) is exercised for real.

Every injected fault is recorded in the telemetry hub (`chaos.<kind>`
counters + the bounded event ring) — `tools/cli.py chaos-status` renders
them — and every partition/stall window is logged with wall timestamps so
the SLO assertion (real/nemesis.py) can exclude exactly the injected
windows and hold p99 to budget everywhere else (docs/real_cluster.md).
"""
from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..core import error, telemetry
from ..core.knobs import SERVER_KNOBS
from ..core.rng import DeterministicRandom
from .transport import RealNetwork


@dataclass
class ChaosConfig:
    """Background fault mix. Defaults come from the `chaos_net_*` knobs so
    campaigns are steered by knob overrides, not code edits."""

    latency_prob: float = field(
        default_factory=lambda: float(SERVER_KNOBS.chaos_net_latency_prob))
    latency_ms: float = field(
        default_factory=lambda: float(SERVER_KNOBS.chaos_net_latency_ms))
    drop_prob: float = field(
        default_factory=lambda: float(SERVER_KNOBS.chaos_net_drop_prob))
    reset_prob: float = field(
        default_factory=lambda: float(SERVER_KNOBS.chaos_net_reset_prob))
    handshake_stall_prob: float = field(
        default_factory=lambda: float(SERVER_KNOBS.chaos_handshake_stall_prob))
    #: how long a dropped request burns before the typed error surfaces
    #: (a real drop costs the client its timeout; campaigns keep this low
    #: so wall clock goes to load, not waiting)
    drop_detect_s: float = 0.05
    #: injected handshake stall length. The stall runs INSIDE the
    #: handshake-bounded region of _Peer.connect, so a stall below the
    #: real_handshake_timeout_s knob is a slow connect (window recorded)
    #: and one above it surfaces as connection_failed within the knob
    #: bound — never an unbounded hang either way
    stall_s: float = 0.25


class NetworkNemesis:
    """Seeded fault schedule shared by every ChaosTransport of a campaign.

    All decisions draw from one DeterministicRandom stream, so a campaign
    seed reproduces the same fault sequence against the same traffic
    interleaving (wall-clock runs are not bit-reproducible like the sim,
    but the INJECTION schedule is)."""

    def __init__(self, seed: int, cfg: Optional[ChaosConfig] = None):
        self.seed = seed
        self.rng = DeterministicRandom(seed)
        self.cfg = cfg or ChaosConfig()
        #: (src, dst) -> wall time the one-way partition heals
        self._partitions: Dict[Tuple[str, str], float] = {}
        #: every injected window, for SLO exclusion: {kind, src, dst, t0, t1}
        self.windows: List[dict] = []
        self.enabled = True

    # -- partitions ----------------------------------------------------------
    def partition(self, src: str, dst: str, duration_s: float,
                  symmetric: bool = False) -> None:
        """Block src->dst requests for `duration_s` (both directions when
        `symmetric`). Named-process asymmetric partitions are the point:
        a client that cannot reach the resolver while the resolver's
        replies to OTHERS still flow."""
        t0 = time.monotonic()
        pairs = [(src, dst)] + ([(dst, src)] if symmetric else [])
        for a, b in pairs:
            self._partitions[(a, b)] = t0 + duration_s
            self.windows.append({"kind": "partition", "src": a, "dst": b,
                                 "t0": t0, "t1": t0 + duration_s})
        telemetry.hub().chaos_event(
            "partition", src=src, dst=dst, seconds=round(duration_s, 3),
            symmetric=symmetric)

    def heal(self, src: Optional[str] = None, dst: Optional[str] = None) -> None:
        """Heal matching partitions now (None = wildcard)."""
        t = time.monotonic()
        for (a, b), until in list(self._partitions.items()):
            if (src in (None, a)) and (dst in (None, b)) and until > t:
                self._partitions[(a, b)] = t
                for w in self.windows:
                    if (w["kind"] == "partition" and w["src"] == a
                            and w["dst"] == b and w["t1"] > t):
                        w["t1"] = t

    def partitioned(self, src: str, dst: str) -> bool:
        until = self._partitions.get((src, dst))
        return until is not None and time.monotonic() < until

    def fault_windows(self, pad_s: float = 0.0) -> List[Tuple[float, float]]:
        """(t0, t1) of every injected window, padded — requests SUBMITTED
        up to `pad_s` before a window can still be caught by it (they're
        in flight when it lands), so SLO exclusion pads backwards."""
        return [(w["t0"] - pad_s, w["t1"]) for w in self.windows]

    # -- background fault draws ---------------------------------------------
    def decide(self, src: str, dst: str) -> Optional[Tuple[str, float]]:
        """One seeded draw per request: (kind, magnitude) or None."""
        if not self.enabled:
            return None
        c, r = self.cfg, self.rng
        x = r.random01()
        for kind, p in (("latency", c.latency_prob), ("drop", c.drop_prob),
                        ("reset", c.reset_prob)):
            if x < p:
                mag = (c.latency_ms / 1e3 * (0.5 + r.random01())
                       if kind == "latency" else 0.0)
                telemetry.hub().chaos_event(kind, src=src, dst=dst)
                return kind, mag
            x -= p
        return None

    async def on_connect(self, src: str, dst: str) -> None:
        """Connect-time hook (real/transport._Peer.connect): an injected
        handshake stall sleeps past the handshake bound, which must then
        surface as connection_failed within the knob window."""
        if not self.enabled:
            return
        if self.partitioned(src, dst):
            telemetry.hub().chaos_event("connect_blackhole", src=src, dst=dst)
            raise error.connection_failed(
                f"injected partition {src}->{dst} (connect)")
        if self.rng.random01() < self.cfg.handshake_stall_prob:
            t0 = time.monotonic()
            stall = max(self.cfg.stall_s, 0.0)
            self.windows.append({"kind": "handshake_stall", "src": src,
                                 "dst": dst, "t0": t0, "t1": t0 + stall})
            telemetry.hub().chaos_event("handshake_stall", src=src, dst=dst,
                                        seconds=round(stall, 3))
            await asyncio.sleep(stall)


class ChaosTransport:
    """The fault-injecting shim over a RealNetwork: same surface, seeded
    faults applied around the inner call. One per named client process."""

    def __init__(self, inner: RealNetwork, nemesis: NetworkNemesis,
                 name: str = ""):
        self.inner = inner
        self.nemesis = nemesis
        self.name = name or inner.name or "client"
        # hand identity + the connect-time hook down to the peers
        inner.name = self.name
        inner.chaos = nemesis
        for p in inner._peers.values():
            p.src, p.chaos = self.name, nemesis
        #: what this endpoint suffered, by kind (campaign report fodder)
        self.suffered: Dict[str, int] = {}

    def _count(self, kind: str) -> None:
        self.suffered[kind] = self.suffered.get(kind, 0) + 1

    def transport_degraded(self) -> bool:
        return self.inner.transport_degraded()

    async def request(self, src: str, ep, payload, priority: int = 0,
                      timeout: Optional[float] = None):
        nem = self.nemesis
        if nem.partitioned(self.name, ep.address):
            # one-way blackhole: the frame leaves and dies. A real client
            # burns its timeout; we charge a bounded detection cost so
            # campaign wall clock goes to load, then raise the same typed
            # error an unreachable peer produces.
            self._count("partitioned")
            await asyncio.sleep(min(timeout or 1.0, nem.cfg.drop_detect_s))
            raise error.connection_failed(
                f"injected partition {self.name}->{ep.address}")
        fault = nem.decide(self.name, ep.address)
        if fault is not None:
            kind, mag = fault
            self._count(kind)
            if kind == "latency":
                await asyncio.sleep(mag)
            elif kind == "drop":
                await asyncio.sleep(min(timeout or 1.0, nem.cfg.drop_detect_s))
                raise error.request_maybe_delivered(
                    f"injected frame drop {self.name}->{ep.address}")
            elif kind == "reset":
                peer = self.inner._peers.get(ep.address)
                if peer is not None:
                    peer._fail_all()
                raise error.connection_failed(
                    f"injected connection reset {self.name}->{ep.address}")
        return await self.inner.request(src, ep, payload, priority,
                                        timeout=timeout)

    async def one_way(self, src: str, ep, payload, priority: int = 0) -> None:
        nem = self.nemesis
        if nem.partitioned(self.name, ep.address):
            self._count("partitioned")
            return   # one-ways are unreliable by contract: silently eaten
        fault = nem.decide(self.name, ep.address)
        if fault is not None:
            # every counted fault is APPLIED — the injected-fault
            # inventory must match what the system actually suffered
            kind, mag = fault
            self._count(kind)
            if kind == "drop":
                return
            if kind == "latency":
                await asyncio.sleep(mag)
            elif kind == "reset":
                peer = self.inner._peers.get(ep.address)
                if peer is not None:
                    peer._fail_all()
                return   # the frame died with the connection
        await self.inner.one_way(src, ep, payload, priority)

    def close(self) -> None:
        self.inner.close()


class DiskNemesis:
    """Seeded disk-fault nemesis for the durability surfaces — the
    campaign-facing wrapper over `fault/inject.DiskFaults`, shaped like
    NetworkNemesis: one seeded decision engine per campaign, every
    injection counted in the telemetry hub (`chaos.disk_*` counters +
    event ring, so `cli chaos-status` renders them) and every stall
    logged as a wall-clock window for SLO exclusion.

    A DiskNemesis IS the `disk=` hook the black-box journal
    (core/blackbox.py), the snapshot writer (fault/recovery.py) and the
    AOT program cache (core/progcache.py) accept: `apply(surface, data)`
    per durable write. The serving path's contract is that every fault
    this injects degrades gracefully — shed-to-memory journaling, a
    skipped snapshot, a compile instead of a cache hit — never a crash
    or silent corruption (crc framing catches the bit-rot at read)."""

    def __init__(self, seed: int, rates: Optional["object"] = None,
                 surface_rates: Optional[Dict[str, "object"]] = None):
        from ..fault.inject import DiskFaultRates, DiskFaults

        self.seed = seed
        self.rates = rates or DiskFaultRates.from_knobs()
        #: every injected fault: {kind, surface, t0, t1} (stalls have
        #: real width; point faults are zero-width windows)
        self.windows: List[dict] = []
        self.faults = DiskFaults(rates=self.rates, seed=seed,
                                 on_fault=self._on_fault)
        #: per-surface overrides: the crash campaign keeps the JOURNAL
        #: surface stall-only (no record loss, so post-recovery replay
        #: parity stays provable) while the snapshot and progcache
        #: surfaces take the destructive kinds their readers must
        #: tolerate by design (torn-tail fallback, poisoned-entry miss)
        self._by_surface = {
            s: DiskFaults(rates=r, seed=seed + 1 + i,
                          on_fault=self._on_fault)
            for i, (s, r) in enumerate(sorted(
                (surface_rates or {}).items()))}
        self.enabled = True

    def _on_fault(self, surface: str, kind: str) -> None:
        t0 = time.monotonic()
        width = (self.rates.stall_ms / 1e3) if kind == "stall" else 0.0
        self.windows.append({"kind": f"disk_{kind}", "surface": surface,
                             "t0": t0, "t1": t0 + width})
        telemetry.hub().chaos_event(f"disk_{kind}", surface=surface)

    def apply(self, surface: str, data: bytes) -> bytes:
        """The durable-write hook (see DiskFaults.apply): returns the
        bytes to write (possibly bit-rotted), sleeps through a stall, or
        raises OSError/TornWrite for the caller's degraded path."""
        if not self.enabled:
            return data
        return self._by_surface.get(surface, self.faults).apply(
            surface, data)

    def fault_windows(self, pad_s: float = 0.0) -> List[Tuple[float, float]]:
        """(t0, t1) of every injected disk window, padded backwards like
        NetworkNemesis.fault_windows — a write submitted just before a
        stall lands inside it."""
        return [(w["t0"] - pad_s, w["t1"]) for w in self.windows]

    def summary(self) -> dict:
        """Campaign-report fragment: the seeded rates and what actually
        got injected, per (surface, kind) — the `disk-fault incidents
        explained` half of the chaos-crash acceptance gate."""
        injected = dict(self.faults.injected)
        for df in self._by_surface.values():
            for k, n in df.injected.items():
                injected[k] = injected.get(k, 0) + n
        return {"seed": self.seed,
                "rates": {"stall": self.rates.stall,
                          "stall_ms": self.rates.stall_ms,
                          "torn": self.rates.torn,
                          "enospc": self.rates.enospc,
                          "rot": self.rates.rot},
                "injected": injected}


def chaos_status_lines() -> List[str]:
    """Render this process's nemesis activity from the telemetry hub —
    the body of `tools/cli.py chaos-status` and the campaign's summary
    printer (real/nemesis.py). Counters first, then the recent event ring
    with details."""
    hub = telemetry.hub()
    counts = hub.chaos_counts()
    lines: List[str] = []
    if not counts and not hub.chaos_events:
        return ["no nemesis activity recorded in this process"]
    lines.append("nemesis event counts:")
    for kind in sorted(counts):
        lines.append(f"  {kind:<18} {counts[kind]}")
    recent = list(hub.chaos_events)[-10:]
    if recent:
        lines.append(f"recent events ({len(recent)} of {len(hub.chaos_events)}):")
        for ev in recent:
            detail = ", ".join(f"{k}={v}" for k, v in sorted(ev.items())
                               if k not in ("kind", "t"))
            lines.append(f"  t={ev['t']:.3f} {ev['kind']}"
                         + (f" ({detail})" if detail else ""))
    return lines
