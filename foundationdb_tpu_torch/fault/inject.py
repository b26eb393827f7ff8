"""Deterministic device-fault injection at the conflict-engine boundary.

Port of ``foundationdb_tpu/fault/inject.py``: the same fault kinds, rates,
rng draws (one seed off the simulation stream at construction, then one
or two draws a dispatch, in the same order) and typed errors.

The analog of the reference's machine-level fault injection
(sim2.actor.cpp's AsyncFileNonDurable, clogging, kills) applied to OUR
new failure domain: the accelerator dispatch. A FaultInjectingEngine
wraps any conflict engine and, from its own seeded rng (one draw off the
simulation stream at construction, so per-dispatch draws never perturb
the rest of the world), injects the fault menagerie a real card's serving
path sees:

  * dispatch exceptions   — CUDA runtime errors, transfer failures;
  * hangs                 — a dispatch that never completes (the watchdog
                            in fault/resilient.py must fire);
  * slow batches          — stragglers that complete late;
  * outages               — bursty windows (the preemption model) where
                            EVERY dispatch fails until the device returns;
  * flipped verdict bits  — silent corruption (off by default: an escaped
                            flip is data loss; the supervisor's sampled
                            probe exists to catch exactly this).

Faults that surface after the inner engine ran (`applied_fraction`) model
the nastiest shape: the dispatch landed on the device, only the reply was
lost — device state holds the batch, the host does not know. The
supervisor must re-warm device state before any retry or the batch's own
writes would alias into its history and change verdicts.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..core import error
from ..core.rng import DeterministicRandom
from ..core.types import TransactionCommitResult
from ..sim.loop import TaskPriority, current_scheduler, delay, never, now


@dataclass
class FaultRates:
    """Per-dispatch fault probabilities (the nemesis campaign's defaults).

    The nemesis campaign runs exceptions, hangs and slow batches at
    these rates; `flip` defaults to 0 because a flipped verdict that the
    sampled probe misses is emitted — corruption coverage lives in the
    supervisor unit tests with probe_rate=1, not in cluster sims."""

    exception: float = 0.01
    hang: float = 0.008
    slow: float = 0.04
    flip: float = 0.0
    #: probability of entering a bursty outage window in which every
    #: dispatch faults until it expires (a card reset / runtime restart)
    outage: float = 0.02
    #: outage length in virtual seconds, uniform in [0.5x, 1.5x]
    outage_seconds: float = 1.5
    #: mean straggler delay, uniform in [0.5x, 1.5x]
    slow_seconds: float = 0.2
    #: fraction of exception/hang faults where the inner engine RAN before
    #: the fault surfaced (dispatch landed, reply lost)
    applied_fraction: float = 0.5


class FaultInjectingEngine:
    """Seed-driven fault wrapper over any ConflictSet engine."""

    name = "fault-injecting"

    def __init__(self, inner, rates: Optional[FaultRates] = None,
                 rng: Optional[DeterministicRandom] = None):
        self.inner = inner
        self.rates = rates or FaultRates()
        if rng is None:
            rng = DeterministicRandom(
                current_scheduler().rng.random_int(0, 2**31 - 1))
        self.rng = rng
        self.injected = {"exceptions": 0, "hangs": 0, "slow": 0, "flips": 0,
                         "outages": 0}
        self._outage_until = 0.0

    # -- engine interface ----------------------------------------------------
    def clear(self, version) -> None:
        self.inner.clear(version)

    def rewarm_target(self):
        """State-rebuild bypass: re-warming device state goes through the
        trusted host-side path (a real system DMAs the rebuilt table rather
        than re-running every historical program through the flaky dispatch
        queue). The supervisor still models re-warm failure via its own
        buggify site."""
        return self.inner

    def resolve(self, transactions, now_v, new_oldest):
        """Synchronous dispatch: exceptions and flips only (a sync call
        cannot hang or straggle in zero virtual time)."""
        kind = self._fault_kind()
        if kind in (None, "slow"):
            return self.inner.resolve(transactions, now_v, new_oldest)
        if kind == "flip":
            return self._flipped(transactions, now_v, new_oldest)
        self._maybe_apply(transactions, now_v, new_oldest)
        self.injected["exceptions"] += 1
        raise error.device_fault(f"injected dispatch {kind} at {now_v}")

    async def resolve_async(self, transactions, now_v, new_oldest):
        """Asynchronous dispatch: the full fault menagerie. The supervisor
        awaits this under its watchdog."""
        kind = self._fault_kind()
        if kind is None:
            return self.inner.resolve(transactions, now_v, new_oldest)
        if kind == "slow":
            self.injected["slow"] += 1
            await delay(self.rates.slow_seconds * (0.5 + self.rng.random01()),
                        TaskPriority.PROXY_RESOLVER_REPLY)
            return self.inner.resolve(transactions, now_v, new_oldest)
        if kind == "flip":
            return self._flipped(transactions, now_v, new_oldest)
        applied = self._maybe_apply(transactions, now_v, new_oldest)
        if kind == "hang":
            self.injected["hangs"] += 1
            await never()
        self.injected["exceptions"] += 1
        raise error.device_fault(
            f"injected dispatch exception at {now_v} (applied={applied})")

    # -- internals -----------------------------------------------------------
    def _fault_kind(self) -> Optional[str]:
        r, rng = self.rates, self.rng
        t = now()
        if t < self._outage_until:
            # device down wholesale: nothing completes until it returns
            return "hang" if rng.random01() < 0.5 else "exception"
        if r.outage > 0 and rng.random01() < r.outage:
            self.injected["outages"] += 1
            self._outage_until = t + r.outage_seconds * (0.5 + rng.random01())
            return "exception"
        x = rng.random01()
        for kind, p in (("exception", r.exception), ("hang", r.hang),
                        ("slow", r.slow), ("flip", r.flip)):
            if x < p:
                return kind
            x -= p
        return None

    def _maybe_apply(self, transactions, now_v, new_oldest) -> bool:
        applied = self.rng.random01() < self.rates.applied_fraction
        if applied:
            self.inner.resolve(transactions, now_v, new_oldest)
        return applied

    def _flipped(self, transactions, now_v, new_oldest):
        """Silent corruption: the device computed (and applied) the true
        verdicts; one reported bit flips on the way back."""
        verdicts = list(self.inner.resolve(transactions, now_v, new_oldest))
        if verdicts:
            self.injected["flips"] += 1
            i = self.rng.random_int(0, len(verdicts))
            flip = (TransactionCommitResult.CONFLICT
                    if int(verdicts[i]) == int(TransactionCommitResult.COMMITTED)
                    else TransactionCommitResult.COMMITTED)
            verdicts[i] = flip
        return verdicts


# -- disk faults ---------------------------------------------------------------

class TornWrite(OSError):
    """A write that persisted only a prefix before failing — the
    crash-mid-append shape. `prefix` is what DID reach the disk; the
    journal writes it so the crc-framed reader's torn-tail tolerance is
    exercised against real torn bytes, not just truncated files."""

    def __init__(self, prefix: bytes):
        super().__init__("injected torn write")
        self.prefix = prefix


@dataclass
class DiskFaultRates:
    """Per-durable-write fault probabilities for the disk nemesis. All
    zero by default (campaign-armed); `from_knobs()` reads the
    `chaos_disk_*` family so campaigns steer injection by knob override,
    the ChaosConfig pattern (real/chaos.py)."""

    stall: float = 0.0
    stall_ms: float = 20.0
    torn: float = 0.0
    enospc: float = 0.0
    rot: float = 0.0

    @classmethod
    def from_knobs(cls) -> "DiskFaultRates":
        from ..core.knobs import SERVER_KNOBS

        return cls(
            stall=float(SERVER_KNOBS.chaos_disk_stall_prob),
            stall_ms=float(SERVER_KNOBS.chaos_disk_stall_ms),
            torn=float(SERVER_KNOBS.chaos_disk_torn_prob),
            enospc=float(SERVER_KNOBS.chaos_disk_enospc_prob),
            rot=float(SERVER_KNOBS.chaos_disk_rot_prob))


class DiskFaults:
    """Seeded per-write fault decisions for the durability surfaces: the
    black-box journal writer, the recovery snapshot writer and the AOT
    program cache (the sim2 AsyncFileNonDurable role for OUR disk layer).

    One `apply(surface, data)` call per durable write draws at most one
    fault: a stall sleeps (a contended fsync), ENOSPC raises plain
    OSError, a torn write raises `TornWrite` carrying the prefix that
    landed, and bit-rot returns silently-corrupted bytes the crc framing
    must catch at read time. Every injection is counted per (surface,
    kind) and reported through `on_fault` — real/chaos.py's DiskNemesis
    wires that to the telemetry hub's chaos.* counters and its kinded
    fault-window log."""

    def __init__(self, rates: Optional[DiskFaultRates] = None,
                 rng: Optional[DeterministicRandom] = None,
                 seed: int = 0, sleep_fn=None, on_fault=None):
        self.rates = rates or DiskFaultRates()
        self.rng = rng if rng is not None else DeterministicRandom(seed)
        #: injected-fault counters keyed "surface.kind"
        self.injected: dict = {}
        self.on_fault = on_fault
        if sleep_fn is None:
            import time as _time

            sleep_fn = _time.sleep
        self._sleep = sleep_fn

    def _draw(self) -> Optional[str]:
        r = self.rates
        x = self.rng.random01()
        for kind, p in (("stall", r.stall), ("torn", r.torn),
                        ("enospc", r.enospc), ("rot", r.rot)):
            if x < p:
                return kind
            x -= p
        return None

    def _count(self, surface: str, kind: str) -> None:
        key = f"{surface}.{kind}"
        self.injected[key] = self.injected.get(key, 0) + 1
        if self.on_fault is not None:
            self.on_fault(surface, kind)

    def apply(self, surface: str, data: bytes) -> bytes:
        """Draw for one durable write of `data` to `surface`. Returns the
        (possibly bit-rotted) bytes to write, sleeps through a stall, or
        raises OSError/TornWrite. Callers must already treat any OSError
        as a degraded write, never a crash."""
        kind = self._draw()
        if kind is None:
            return data
        self._count(surface, kind)
        if kind == "stall":
            self._sleep(self.rates.stall_ms
                        * (0.5 + self.rng.random01()) / 1e3)
            return data
        if kind == "enospc":
            raise OSError(28, f"injected ENOSPC on {surface}")
        if kind == "torn":
            raise TornWrite(bytes(data[:self.rng.random_int(
                1, max(2, len(data)))]))
        # rot: flip one bit in place — the write SUCCEEDS; only the crc
        # framing at read time can tell, and it must quarantine, not crash
        buf = bytearray(data)
        i = self.rng.random_int(0, len(buf))
        buf[i] ^= 1 << self.rng.random_int(0, 8)
        return bytes(buf)
