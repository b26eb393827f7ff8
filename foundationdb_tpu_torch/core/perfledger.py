"""Compile & memory ledger: every device-program build, priced.

Port of ``foundationdb_tpu/core/perfledger.py``. `PerfLedger` is a bounded
ring of per-build records plus running totals, one per engine, registered
with the telemetry hub (`perf.<label>.*` series, the `fdbtpu_perf`
Prometheus family). A build here is one (bucket, C) program: on the card
its captured CUDA graphs, on the CPU the eager program object. Where the
JAX package reads XLA's cost and memory analysis off a compiled artifact
(`analyze_compiled`), the port records what a graph build shows
(`analyze_program`): the peak device memory the build needed, and no
flop, byte-traffic or code-size estimate (None, which the row schema
allows).

Sampled device timing lives next door (ops/host_engine.py): the
`resolver_device_time_sample_rate` knob makes every Nth dispatch unit
time itself; `sample_every_from_rate` converts the knob's fraction into
that deterministic 1-in-N cadence (counter based — no rng draw, so
enabling sampling never shifts a random stream, and verdicts are
identical either way).
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

#: ledger-ring size fallback when the knob registry is unavailable
DEFAULT_LEDGER_SIZE = 128

#: the per-record fields every ledger row carries (tests pin the schema;
#: analysis fields may be None when the backend exposes no analysis —
#: e.g. jit-warm mesh programs, where the build is not an AOT artifact)
RECORD_FIELDS = ("engine", "bucket", "n_chunks", "search_mode",
                 "dispatch_mode", "kind", "duration_ms", "flops",
                 "bytes_accessed", "peak_bytes", "generated_code_bytes")


def ledger_size_from_knobs() -> int:
    from .knobs import SERVER_KNOBS

    try:
        return int(getattr(SERVER_KNOBS, "resolver_perf_ledger_size"))
    except (AttributeError, TypeError, ValueError):
        return DEFAULT_LEDGER_SIZE


def sample_every_from_rate(rate: Optional[float]) -> int:
    """The `resolver_device_time_sample_rate` knob (or a constructor
    override) as a deterministic 1-in-N dispatch cadence: 0 disables
    (returns 0), otherwise every `round(1/rate)`-th dispatch is sampled
    (1.0 -> every dispatch). Counter-based on purpose — a rng draw here
    would shift every simulation's random stream for a knob that only
    reads clocks."""
    if rate is None:
        from .knobs import SERVER_KNOBS

        rate = float(getattr(SERVER_KNOBS, "resolver_device_time_sample_rate",
                             0.0) or 0.0)
    rate = float(rate)
    if rate <= 0.0:
        return 0
    return max(1, round(1.0 / min(rate, 1.0)))


def analyze_program(peak_bytes: Optional[int] = None) -> Dict[str, Optional[int]]:
    """The analysis fields of one program build: `peak_bytes` as the
    builder measured it (on the card: the peak device memory allocated
    during the build above what was allocated when it began — the
    program's static buffers, a scratch table and the step's
    temporaries; None on the CPU), and no flop, byte-traffic or
    generated-code figure, which a captured graph does not report."""
    return {"flops": None, "bytes_accessed": None,
            "peak_bytes": None if peak_bytes is None else int(peak_bytes),
            "generated_code_bytes": None}


class PerfLedger:
    """Bounded ring of per-compile records + running totals for one
    engine (registered per engine like EnginePerf, so a process hosting
    several engines keeps their compile bills apart)."""

    def __init__(self, size: Optional[int] = None):
        self.records: deque = deque(maxlen=size if size is not None
                                    else ledger_size_from_knobs())
        #: compile counts / total build ms split by kind ("warmup" =
        #: inside warmup()/ensure_warm, "steady" = a serving-path build —
        #: the compile-stall the AOT ladder exists to prevent)
        self.compiles: Dict[str, int] = {}
        self.compile_ms: Dict[str, float] = {}
        #: max peak_bytes over every analyzed record — the engine's
        #: largest single-program device-memory peak
        self.peak_bytes = 0
        self.flops_total = 0
        self.bytes_accessed_total = 0
        #: on-disk program-cache accounting (core/progcache.py): event
        #: counts ("hit"/"miss"/"store") + bytes moved + wall ms — kept
        #: OUT of `compiles` so a progcache-warm engine still reports
        #: zero compiles (a port build is never stored: a CUDA graph has
        #: no serialized form, so `store` counts it under errors)
        self.progcache: Dict[str, int] = {}
        self.progcache_bytes = 0
        self.progcache_ms = 0.0

    def record_compile(self, *, engine: str, bucket: int, n_chunks: int,
                       search_mode: str, dispatch_mode: str, kind: str,
                       duration_ms: float,
                       analysis: Optional[Dict[str, Optional[int]]] = None
                       ) -> dict:
        """File one program build; `analysis` is analyze_program()'s dict
        (default: no analysis)."""
        if analysis is None:
            analysis = analyze_program()
        rec = {"engine": engine, "bucket": int(bucket),
               "n_chunks": int(n_chunks), "search_mode": search_mode,
               "dispatch_mode": dispatch_mode, "kind": kind,
               "duration_ms": round(float(duration_ms), 3), **analysis}
        self.records.append(rec)
        self.compiles[kind] = self.compiles.get(kind, 0) + 1
        self.compile_ms[kind] = (self.compile_ms.get(kind, 0.0)
                                 + float(duration_ms))
        if analysis.get("peak_bytes"):
            self.peak_bytes = max(self.peak_bytes, analysis["peak_bytes"])
        if analysis.get("flops"):
            self.flops_total += analysis["flops"]
        if analysis.get("bytes_accessed"):
            self.bytes_accessed_total += analysis["bytes_accessed"]
        return rec

    def record_progcache(self, *, engine: str, bucket: int, event: str,
                         nbytes: int = 0, duration_ms: float = 0.0) -> None:
        """File one on-disk program-cache event (`hit` / `miss` /
        `store`, core/progcache.py). Deliberately NOT a compile record:
        a cache hit is the absence of a compile, so it must not touch
        `compiles` (the zero-steady-state-compile guard keeps its
        meaning) or the pinned RECORD_FIELDS row schema."""
        del engine, bucket  # keyed per-ledger already (one ledger/engine)
        self.progcache[event] = self.progcache.get(event, 0) + 1
        self.progcache_bytes += int(nbytes)
        self.progcache_ms += float(duration_ms)

    def rows(self) -> List[dict]:
        return list(self.records)

    def snapshot(self, max_rows: int = 16) -> dict:
        """The status-document fragment (engine_health -> ratekeeper ->
        CC status doc -> `cli perf`): totals plus the newest rows."""
        return {
            "compiles": dict(sorted(self.compiles.items())),
            "compile_ms": {k: round(v, 1)
                           for k, v in sorted(self.compile_ms.items())},
            "peak_bytes": self.peak_bytes,
            "flops_total": self.flops_total,
            "bytes_accessed_total": self.bytes_accessed_total,
            "progcache": dict(sorted(self.progcache.items())),
            "progcache_bytes": self.progcache_bytes,
            "progcache_ms": round(self.progcache_ms, 1),
            "rows": list(self.records)[-max_rows:],
        }
