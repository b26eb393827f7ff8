"""Cluster watchdog: a deterministic rule engine over the telemetry hub.

Port of ``foundationdb_tpu/core/watchdog.py``.

Everything before this module MEASURES (spans, heat, the compile/memory
ledger, sampled device timing); nothing EVALUATES. SLOs were asserted
post-hoc at campaign end, so a degrading cluster only learned about it
from the autopsy. The watchdog closes that gap: declarative `AlertRule`s
are evaluated on every `TelemetryHub.sync()` over the hub's existing
series — no new collection path, no device interaction, zero extra host
syncs — and firing alerts group into `Incident`s machine-correlated
against injected fault windows, ResilientEngine health transitions and
the tail-sampled trace root cause, so a breach reads
"slo_p99_burn firing · overlaps partition window · dominant=server_resolve
· resolver resilient.2 state=probation" instead of a bare gauge.

Rule classes (docs/observability.md "Watchdog, burn rates & incidents"):

  * `ThresholdRule`   — level/counter compare (blocking_syncs > 0,
    steady-state compiles > 0, state_memory_pressure, resolver health
    state >= suspect);
  * `StalenessRule`   — a counter that must advance under traffic stops
    changing (commit flow stalled);
  * `AnomalyRule`     — EWMA mean/variance z-score bands (heat
    concentration shifts that announce a moving hot spot);
  * `BurnRateRule`    — multi-window SLO burn rates (Google-SRE style
    fast+slow window pair over an error budget: p99-vs-budget, abort
    fraction, tenant throttle rate). Both windows must burn above the
    threshold, so a blip can't fire and a slow leak can't hide.

Lifecycle: ok -> pending (condition active) -> firing (active for
`watchdog_hold_s`) -> resolved (clear for `watchdog_clear_s`) -> ok.
Every transition lands in a bounded ring (`watchdog_alert_ring`) and the
firing set is exported as `alerts.*` hub series — the ALERTS-style
`fdbtpu_alerts` Prometheus family.

Determinism contract: the clock is `span_now()` (the sim's virtual
clock when one is installed), evaluation draws no rng, iterates only
insertion-ordered dicts, and reads only host-side python values, never a
device tensor — abort sets are bit-identical with the watchdog on and
`blocking_syncs` stays 0. The disabled path is one attribute check in
`sync()`: `watchdog_enabled` off allocates nothing.
(tests/test_torch_watchdog.py holds the rules' alerts, incidents and
snapshots to the JAX package's.)
"""
from __future__ import annotations

import re
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import blackbox
from .trace import span_now

#: allocation counter for the disabled-path regression guard
#: (tests/test_watchdog.py, the core/trace.py span_allocations pattern):
#: bumped whenever the watchdog allocates evaluation state — with the
#: watchdog off, `hub().sync()` must leave it untouched
watchdog_allocations = [0]

#: alert lifecycle states (exposition index: `alerts.<...>.state`)
OK, PENDING, FIRING = 0, 1, 2
STATE_NAMES = {OK: "ok", PENDING: "pending", FIRING: "firing"}

#: incidents retained (closed ones age out oldest-first)
MAX_INCIDENTS = 64
#: resolver health-state transitions retained for incident correlation
MAX_HEALTH_TRANSITIONS = 128
#: minimum good+bad events inside a burn window before the rule may fire
#: (a single bad request out of two must never page)
BURN_MIN_EVENTS = 8


def _pattern_re(pattern: str) -> "re.Pattern":
    """A dotted series pattern with `*` wildcards -> regex with one
    capture group per `*` (the captures key multi-series rules)."""
    parts = [re.escape(p) for p in pattern.split("*")]
    return re.compile("^" + "(.+)".join(parts) + "$")


class _SeriesView:
    """One evaluation tick's read model over the hub's TDMetric series:
    current values plus a per-rule match cache invalidated when the
    series population grows (it only grows — metrics are never deleted).
    `hub` (when the evaluator passes it) lets a rule read a registered
    source's richer detail — e.g. the stalled-reshard rule naming the
    frozen range — without growing the series surface."""

    def __init__(self, metrics: Dict[str, Any], hub: Any = None):
        self.metrics = metrics
        self.hub = hub

    def value(self, name: str) -> Optional[float]:
        m = self.metrics.get(name)
        if m is None:
            return None
        return float(getattr(m, "value", 0))


class AlertRule:
    """Base declarative rule: subclasses implement `conditions(t, view)`
    yielding (series_key, active, value, detail) per tracked series
    group. hold/clear default to the watchdog_* knobs at evaluation time
    so `--knob` overrides steer a running campaign."""

    kind = "rule"

    def __init__(self, name: str, hold_s: Optional[float] = None,
                 clear_s: Optional[float] = None):
        self.name = name
        self.hold_s = hold_s
        self.clear_s = clear_s
        #: series-population size the match cache was built at
        self._cache_n = -1
        self._cache: Dict[str, List] = {}

    def _matches(self, view: _SeriesView, pattern_key: str,
                 rx: "re.Pattern") -> List[Tuple[str, Tuple[str, ...]]]:
        """(series_name, wildcard captures) for every matching series,
        cached until the hub grows a new series."""
        if self._cache_n != len(view.metrics):
            self._cache.clear()
            self._cache_n = len(view.metrics)
        hit = self._cache.get(pattern_key)
        if hit is None:
            hit = [(name, m.groups()) for name in view.metrics
                   for m in (rx.match(name),) if m is not None]
            self._cache[pattern_key] = hit
        return hit

    def resolved_hold_s(self) -> float:
        if self.hold_s is not None:
            return float(self.hold_s)
        from .knobs import SERVER_KNOBS

        return float(SERVER_KNOBS.watchdog_hold_s)

    def resolved_clear_s(self) -> float:
        if self.clear_s is not None:
            return float(self.clear_s)
        from .knobs import SERVER_KNOBS

        return float(SERVER_KNOBS.watchdog_clear_s)

    def conditions(self, t: float, view: _SeriesView):
        raise NotImplementedError

    def describe(self) -> Dict[str, Any]:
        return {"name": self.name, "kind": self.kind}


class ThresholdRule(AlertRule):
    """value OP threshold over every series matching `pattern`."""

    kind = "threshold"
    _OPS = {">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
            "<": lambda a, b: a < b, "<=": lambda a, b: a <= b}

    def __init__(self, name: str, pattern: str, threshold: float,
                 op: str = ">", **kw):
        super().__init__(name, **kw)
        self.pattern = pattern
        self.threshold = float(threshold)
        self.op = op
        self._rx = _pattern_re(pattern)
        self._cmp = self._OPS[op]

    def conditions(self, t, view):
        for series, _caps in self._matches(view, self.pattern, self._rx):
            v = view.value(series)
            if v is None:
                continue
            yield (series, self._cmp(v, self.threshold), v,
                   f"{self.op} {self.threshold:g}")

    def describe(self):
        return {**super().describe(), "pattern": self.pattern,
                "op": self.op, "threshold": self.threshold}


class StalenessRule(AlertRule):
    """A series that must keep advancing under live traffic (a commit
    SLI total, a batch counter) has not changed for `max_age_s`. Arms at
    first sighting; absence before first sighting is not staleness (a
    cluster that never served is cold, not stalled)."""

    kind = "staleness"

    def __init__(self, name: str, pattern: str, max_age_s: float, **kw):
        super().__init__(name, **kw)
        self.pattern = pattern
        self.max_age_s = float(max_age_s)
        self._rx = _pattern_re(pattern)
        #: series -> [last value, t of last change]
        self._last: Dict[str, List[float]] = {}

    def conditions(self, t, view):
        for series, _caps in self._matches(view, self.pattern, self._rx):
            v = view.value(series)
            if v is None:
                continue
            st = self._last.get(series)
            if st is None:
                watchdog_allocations[0] += 1
                self._last[series] = [v, t]
                yield (series, False, 0.0, "armed")
                continue
            if v != st[0]:
                st[0], st[1] = v, t
            age = t - st[1]
            yield (series, age > self.max_age_s, age,
                   f"no change in {age:.2f}s (max {self.max_age_s:g}s)")

    def describe(self):
        return {**super().describe(), "pattern": self.pattern,
                "max_age_s": self.max_age_s}


class AnomalyRule(AlertRule):
    """EWMA z-score bands: the series' running mean/variance define the
    expected band; a sample more than `z_threshold` deviations out is
    anomalous. The band keeps adapting (the anomalous value folds into
    the EWMA), so a persistent level shift re-centres and the alert
    resolves — this rule flags CHANGE, the threshold rules flag state."""

    kind = "anomaly"
    #: EWMA smoothing for mean and variance
    ALPHA = 0.2
    #: observations before the band is trusted
    WARMUP = 8
    #: std floor: constant series jittering by one quantum must not page
    STD_FLOOR = 1.0

    def __init__(self, name: str, pattern: str,
                 z_threshold: Optional[float] = None, **kw):
        super().__init__(name, **kw)
        self.pattern = pattern
        self.z_threshold = z_threshold
        self._rx = _pattern_re(pattern)
        #: series -> [mean, var, n_seen]
        self._bands: Dict[str, List[float]] = {}

    def _z(self) -> float:
        if self.z_threshold is not None:
            return float(self.z_threshold)
        from .knobs import SERVER_KNOBS

        return float(SERVER_KNOBS.watchdog_z_threshold)

    def conditions(self, t, view):
        z_thr = self._z()
        for series, _caps in self._matches(view, self.pattern, self._rx):
            v = view.value(series)
            if v is None:
                continue
            band = self._bands.get(series)
            if band is None:
                watchdog_allocations[0] += 1
                self._bands[series] = [v, 0.0, 1]
                yield (series, False, 0.0, "warming")
                continue
            mean, var, n = band
            std = max(var ** 0.5, self.STD_FLOOR,
                      0.02 * abs(mean))
            z = (v - mean) / std
            active = n >= self.WARMUP and abs(z) > z_thr
            d = v - mean
            if active:
                # clamp the update for anomalous samples: the band WALKS
                # toward a level shift instead of swallowing it in one
                # EWMA step (which would collapse the z-score before the
                # hold window could fire) — the alert stays active while
                # the shift is still outside the widening band, then
                # resolves as the band converges on the new level
                d = (z_thr if d > 0 else -z_thr) * std
            band[0] = mean + self.ALPHA * d
            band[1] = (1 - self.ALPHA) * (var + self.ALPHA * d * d)
            band[2] = n + 1
            yield (series, active, round(z, 3),
                   f"z={z:.2f} band={mean:.1f}±{z_thr:g}·{std:.1f}")

    def describe(self):
        return {**super().describe(), "pattern": self.pattern,
                "z_threshold": self.z_threshold}


class BurnRateRule(AlertRule):
    """Multi-window SLO burn rate over a good/bad counter pair.

    burn = (bad / (good + bad)) / budget_frac over a trailing window;
    1.0 means the error budget is being spent exactly at the sustainable
    rate. The rule fires only when BOTH the fast and the slow window
    burn above `watchdog_burn_threshold` — the fast window gives
    detection latency, the slow window stops a blip from paging and
    makes the alert self-clearing once the bad rate stops (the standard
    multiwindow multi-burn-rate construction). Series pairs are joined
    by their `*` captures (one alert per engine/admission/SLI label);
    a missing bad-side series reads 0 (no errors yet)."""

    kind = "burn"

    def __init__(self, name: str, good_pattern: str, bad_pattern: str,
                 budget_frac: float, fast_s: Optional[float] = None,
                 slow_s: Optional[float] = None,
                 threshold: Optional[float] = None,
                 min_events: int = BURN_MIN_EVENTS, **kw):
        super().__init__(name, **kw)
        self.good_pattern = good_pattern
        self.bad_pattern = bad_pattern
        self.budget_frac = float(budget_frac)
        self.fast_s = fast_s
        self.slow_s = slow_s
        self.threshold = threshold
        self.min_events = int(min_events)
        self._good_rx = _pattern_re(good_pattern)
        self._bad_rx = _pattern_re(bad_pattern)
        #: capture key -> deque[(t, good, bad)]
        self._hist: Dict[Tuple[str, ...], deque] = {}

    def _knobs(self) -> Tuple[float, float, float]:
        from .knobs import SERVER_KNOBS

        k = SERVER_KNOBS
        return (float(self.fast_s if self.fast_s is not None
                      else k.watchdog_burn_fast_s),
                float(self.slow_s if self.slow_s is not None
                      else k.watchdog_burn_slow_s),
                float(self.threshold if self.threshold is not None
                      else k.watchdog_burn_threshold))

    @staticmethod
    def _at(hist: deque, target_t: float) -> Tuple[float, float]:
        """(good, bad) as of target_t: the newest sample at or before it,
        else the oldest sample (pre-history = the earliest observation,
        so a window wider than the history reads the full span)."""
        best = hist[0]
        for s in hist:
            if s[0] <= target_t:
                best = s
            else:
                break
        return best[1], best[2]

    def window_burn(self, key: Tuple[str, ...], window_s: float,
                    now_t: float) -> Tuple[float, float]:
        """(burn rate, events) over the trailing window — exposed so the
        smoke's hand computation checks the exact arithmetic the alert
        uses."""
        hist = self._hist.get(key)
        if not hist or len(hist) < 2:
            return 0.0, 0.0
        g1, b1 = hist[-1][1], hist[-1][2]
        g0, b0 = self._at(hist, now_t - window_s)
        dg, db = max(0.0, g1 - g0), max(0.0, b1 - b0)
        events = dg + db
        if events <= 0:
            return 0.0, 0.0
        return (db / events) / self.budget_frac, events

    def conditions(self, t, view):
        fast_s, slow_s, thr = self._knobs()
        bads = {caps: series for series, caps
                in self._matches(view, self.bad_pattern, self._bad_rx)}
        for series, caps in self._matches(view, self.good_pattern,
                                          self._good_rx):
            good = view.value(series) or 0.0
            bad_series = bads.get(caps)
            bad = (view.value(bad_series) or 0.0) \
                if bad_series is not None else 0.0
            hist = self._hist.get(caps)
            if hist is None:
                watchdog_allocations[0] += 1
                hist = self._hist[caps] = deque()
            hist.append((t, good, bad))
            while hist and hist[0][0] < t - 2 * slow_s:
                hist.popleft()
            burn_fast, ev_fast = self.window_burn(caps, fast_s, t)
            burn_slow, ev_slow = self.window_burn(caps, slow_s, t)
            active = (burn_fast > thr and burn_slow > thr
                      and ev_slow >= self.min_events)
            key = ".".join(caps) or series
            yield (key, active, round(min(burn_fast, burn_slow), 3),
                   f"burn fast={burn_fast:.2f}/slow={burn_slow:.2f} "
                   f"(thr {thr:g}, budget {self.budget_frac:g})")

    def describe(self):
        return {**super().describe(), "good": self.good_pattern,
                "bad": self.bad_pattern, "budget_frac": self.budget_frac}


class ReshardStalledRule(AlertRule):
    """An online reshard has been in flight longer than the
    `reshard_stall_s` knob (server/reshard.py publishes
    `reshard.<label>.in_flight_age_us`; a completed or abandoned op
    resets it to 0, clearing the alert). The detail reads like a page:
    "reshard of [k1,k2) frozen · donor r1 state=probation" — composed
    from the live controller through the hub registry, so the incident
    names the range and the donor engine's health, not a bare gauge.
    Fires immediately (hold 0): a stalled handoff is a fact, not a
    rate."""

    kind = "reshard"

    def __init__(self, name: str = "reshard_stalled",
                 pattern: str = "reshard.*.in_flight_age_us", **kw):
        kw.setdefault("hold_s", 0.0)
        super().__init__(name, **kw)
        self.pattern = pattern
        self._rx = _pattern_re(pattern)

    def conditions(self, t, view):
        from .knobs import SERVER_KNOBS

        stall_us = float(SERVER_KNOBS.reshard_stall_s) * 1e6
        for series, caps in self._matches(view, self.pattern, self._rx):
            v = view.value(series)
            if v is None:
                continue
            active = v > stall_us
            detail = (f"in flight {v / 1e6:.2f}s "
                      f"(stall after {stall_us / 1e6:g}s)")
            if active and view.hub is not None and caps:
                rc = view.hub.reshard_source(caps[0])
                if rc is not None:
                    live = rc.in_flight_detail()
                    if live:
                        detail = f"{live} · {detail}"
            yield (series, active, round(v / 1e6, 3), detail)

    def describe(self):
        return {**super().describe(), "pattern": self.pattern}


class RecoveryStalledRule(AlertRule):
    """A crash-stop recovery has been in flight longer than the
    `resolver_recovery_stall_s` knob (fault/recovery.py's
    RecoveryTracker publishes `recovery.<label>.in_flight_age_us`; a
    completed — even failed — recovery resets it to 0, clearing the
    alert). A stalled recovery is the worst blackout shape: the process
    is up but serving nothing, which no liveness probe distinguishes
    from warm. Fires immediately (hold 0): a wedged restart is a fact,
    not a rate."""

    kind = "recovery"

    def __init__(self, name: str = "recovery_stalled",
                 pattern: str = "recovery.*.in_flight_age_us", **kw):
        kw.setdefault("hold_s", 0.0)
        super().__init__(name, **kw)
        self.pattern = pattern
        self._rx = _pattern_re(pattern)

    def conditions(self, t, view):
        from .knobs import SERVER_KNOBS

        stall_us = float(SERVER_KNOBS.resolver_recovery_stall_s) * 1e6
        for series, caps in self._matches(view, self.pattern, self._rx):
            v = view.value(series)
            if v is None:
                continue
            active = v > stall_us
            detail = (f"in flight {v / 1e6:.2f}s "
                      f"(stall after {stall_us / 1e6:g}s)")
            if active and view.hub is not None and caps:
                rt = view.hub.recovery_source(caps[0])
                if rt is not None:
                    live = rt.in_flight_detail()
                    if live:
                        detail = f"{live} · {detail}"
            yield (series, active, round(v / 1e6, 3), detail)

    def describe(self):
        return {**super().describe(), "pattern": self.pattern}


class _AlertState:
    """Lifecycle state of one (rule, series) pair."""

    __slots__ = ("state", "since", "clear_since", "value", "detail",
                 "t_firing", "fired_count")

    def __init__(self) -> None:
        watchdog_allocations[0] += 1
        self.state = OK
        self.since = 0.0
        self.clear_since: Optional[float] = None
        self.value: float = 0.0
        self.detail = ""
        self.t_firing: Optional[float] = None
        self.fired_count = 0


class Incident:
    """A group of alerts firing in one contiguous interval, correlated
    after the fact against injected fault windows, health transitions
    and the trace root cause (real/nemesis.py hands those in)."""

    def __init__(self, ident: int, t0: float):
        watchdog_allocations[0] += 1
        self.id = ident
        self.t0 = t0
        self.t1: Optional[float] = None
        #: alert key -> {name, series, value, detail} at firing time
        self.alerts: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self.windows: List[Dict[str, Any]] = []
        self.health: List[Dict[str, Any]] = []
        self.root_cause: Optional[Dict[str, Any]] = None
        self.explained = False
        self.explanation: Optional[str] = None
        #: already sunk to the black-box journal (correlate() may run
        #: more than once; the append-only journal must not duplicate)
        self.journaled = False

    def summary(self) -> str:
        parts = [" ".join(f"{a['name']} firing"
                          for a in list(self.alerts.values())[:1])]
        extra = len(self.alerts) - 1
        if extra > 0:
            parts[0] += f" (+{extra} more)"
        if self.windows:
            kinds = sorted({w.get("kind", "?") for w in self.windows})
            parts.append("overlaps " + "+".join(kinds) + " window")
        if self.root_cause:
            parts.append(f"dominant={self.root_cause.get('dominant_segment')}")
        if self.health:
            # the WORST state the incident spanned explains it better
            # than whichever transition happened to come last (an arc
            # usually ends back at healthy)
            sev = {"healthy": 0, "suspect": 1, "failed": 2,
                   "probation": 3, "quarantined": 4}
            h = max(self.health, key=lambda h: sev.get(h["state"], -1))
            parts.append(f"resolver {h['label']} state={h['state']}")
        return " · ".join(parts)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "t0": round(self.t0, 4),
            "t1": round(self.t1, 4) if self.t1 is not None else None,
            "alerts": list(self.alerts.values()),
            "windows": [{"kind": w.get("kind"),
                         "t0": round(float(w.get("t0", 0)), 4),
                         "t1": round(float(w.get("t1", 0)), 4)}
                        for w in self.windows],
            "health": list(self.health),
            "root_cause": self.root_cause,
            "explained": self.explained,
            "explanation": self.explanation,
            "summary": self.summary(),
        }


def default_rules() -> List[AlertRule]:
    """The knob-driven default ruleset (docs/observability.md rule
    catalog). Budgets come from the watchdog_* knobs so one `--knob`
    override retunes a live campaign; hold/clear default per-rule to the
    global knobs. Health-state and discipline rules fire immediately
    (hold 0): a blocking sync or a failed engine is a fact, not a rate."""
    from .knobs import SERVER_KNOBS

    k = SERVER_KNOBS
    return [
        # -- burn-rate pairs (SLO spend) ---------------------------------
        BurnRateRule("slo_p99_burn", "sli.*.good", "sli.*.bad",
                     budget_frac=float(k.watchdog_slo_bad_frac)),
        BurnRateRule("abort_frac_burn",
                     "engine.*.verdicts.committed",
                     "engine.*.verdicts.conflicts",
                     budget_frac=float(k.watchdog_abort_budget_frac)),
        BurnRateRule("tenant_throttle_burn",
                     "admission.*.admitted", "admission.*.rejected",
                     budget_frac=float(k.watchdog_throttle_budget_frac)),
        # conflict-scheduler predictor health (pipeline/scheduler.py):
        # probes are predicted-doomed transactions dispatched anyway —
        # one that COMMITS is a mispredict. A mispredict share above the
        # budget means the predictor has gone stale and pre-abort is
        # refusing transactions that would have won.
        BurnRateRule("sched_mispredict",
                     "sched.*.probe_ok", "sched.*.mispredicts",
                     budget_frac=float(k.resolver_sched_mispredict_frac)),
        # -- discipline thresholds (must-be-zero invariants, live) -------
        ThresholdRule("blocking_syncs", "loop.*.blocking_syncs", 0, ">",
                      hold_s=0.0),
        ThresholdRule("steady_state_compiles", "perf.*.compiles_steady",
                      0, ">", hold_s=0.0),
        ThresholdRule("state_memory_pressure",
                      "resolver.*.state_memory_pressure", 0, ">"),
        # state index >= 1 == suspect or worse (telemetry.HEALTH_STATE_INDEX)
        ThresholdRule("engine_unhealthy", "resolver.*.state", 1, ">=",
                      hold_s=0.0),
        # -- anomaly bands ------------------------------------------------
        AnomalyRule("heat_concentration_shift",
                    "heat.*.concentration_x1000"),
        # -- online resharding (server/reshard.py) ------------------------
        ReshardStalledRule("reshard_stalled"),
        # blackout burn: an executed reshard whose freeze -> cutover
        # interval exceeded reshard_blackout_budget_ms — a fact the
        # moment the counter moves, like the discipline rules
        ThresholdRule("reshard_blackout",
                      "reshard.*.blackout_over_budget", 0, ">",
                      hold_s=0.0),
        # -- crash-stop recovery (fault/recovery.py) ----------------------
        RecoveryStalledRule("recovery_stalled"),
        # -- staleness/absence -------------------------------------------
        StalenessRule("commit_flow_stalled", "sli.*.total",
                      max_age_s=float(k.watchdog_staleness_s)),
    ]


class Watchdog:
    """The rule engine. One per process, attached to the telemetry hub
    (`hub().attach_watchdog(...)` — or automatically at hub construction
    when `watchdog_enabled` is on); `evaluate()` runs on every
    `TelemetryHub.sync()`."""

    def __init__(self, rules: Optional[Sequence[AlertRule]] = None,
                 now_fn=None):
        from .knobs import SERVER_KNOBS

        self.rules: List[AlertRule] = list(
            rules if rules is not None else default_rules())
        self.now_fn = now_fn or span_now
        self._states: Dict[Tuple[str, str], _AlertState] = {}
        self._rule_by_name = {r.name: r for r in self.rules}
        #: bounded transition ring: every pending/firing/resolved edge
        self.ring: deque = deque(
            maxlen=int(SERVER_KNOBS.watchdog_alert_ring))
        self.incidents: List[Incident] = []
        self._open: Optional[Incident] = None
        self._next_incident = 1
        self.evaluations = 0
        #: resolver health transitions observed through the hub series
        #: (resolver.<label>.state change history, correlation input)
        self.health_transitions: deque = deque(maxlen=MAX_HEALTH_TRANSITIONS)
        self._health_rx = _pattern_re("resolver.*.state")
        self._health_last: Dict[str, int] = {}

    def _edge(self, entry: Dict[str, Any]) -> None:
        """One alert lifecycle edge: into the bounded ring AND, when a
        black-box journal is installed, onto disk — post-hoc forensics
        (`cli explain`) joins these against the batch/fault timeline."""
        self.ring.append(entry)
        if blackbox.enabled():
            blackbox.record_alert(entry["alert"], entry["series"],
                                  entry["state"], entry["value"],
                                  entry["detail"])

    # -- evaluation ----------------------------------------------------------
    def _track_health(self, t: float, view: _SeriesView) -> None:
        from .telemetry import HEALTH_STATE_INDEX

        names = {v: n for n, v in HEALTH_STATE_INDEX.items()}
        for series in view.metrics:
            m = self._health_rx.match(series)
            if m is None:
                continue
            v = int(view.value(series) or 0)
            if self._health_last.get(series) == v:
                continue
            self._health_last[series] = v
            self.health_transitions.append({
                "t": round(t, 4), "label": m.group(1),
                "state": names.get(v, str(v))})

    def _step(self, t: float, rule: AlertRule, series: str, active: bool,
              value: float, detail: str) -> None:
        key = (rule.name, series)
        st = self._states.get(key)
        if st is None:
            st = self._states[key] = _AlertState()
            st.since = t
        st.value, st.detail = value, detail
        if st.state == OK:
            if active:
                st.state, st.since = PENDING, t
                self._edge({"t": round(t, 4), "alert": rule.name,
                                  "series": series, "state": "pending",
                                  "value": value, "detail": detail})
                # hold 0 = fire on the same tick the condition appears
                if t - st.since >= rule.resolved_hold_s():
                    self._fire(t, rule, series, st)
        elif st.state == PENDING:
            if not active:
                st.state = OK
                self._edge({"t": round(t, 4), "alert": rule.name,
                                  "series": series, "state": "cleared",
                                  "value": value, "detail": detail})
            elif t - st.since >= rule.resolved_hold_s():
                self._fire(t, rule, series, st)
        elif st.state == FIRING:
            if active:
                st.clear_since = None
                if self._open is not None:
                    a = self._open.alerts.get((rule.name, series))
                    if a is not None:
                        a["value"] = value
            else:
                if st.clear_since is None:
                    st.clear_since = t
                if t - st.clear_since >= rule.resolved_clear_s():
                    st.state, st.clear_since = OK, None
                    self._edge({"t": round(t, 4), "alert": rule.name,
                                      "series": series, "state": "resolved",
                                      "value": value, "detail": detail})

    def _fire(self, t: float, rule: AlertRule, series: str,
              st: _AlertState) -> None:
        st.state, st.t_firing, st.clear_since = FIRING, t, None
        st.fired_count += 1
        self._edge({"t": round(t, 4), "alert": rule.name,
                          "series": series, "state": "firing",
                          "value": st.value, "detail": st.detail})
        if self._open is None:
            self._open = Incident(self._next_incident, t)
            self._next_incident += 1
            self.incidents.append(self._open)
            del self.incidents[:-MAX_INCIDENTS]
        self._open.alerts[(rule.name, series)] = {
            "name": rule.name, "kind": rule.kind, "series": series,
            "value": st.value, "detail": st.detail, "t": round(t, 4)}

    def evaluate(self, hub) -> None:
        """One tick: read every rule's series off the hub, step the
        lifecycles, export the alert set as `alerts.*` series, and
        open/close the incident envelope. Called from sync()."""
        t = self.now_fn()
        self.evaluations += 1
        view = _SeriesView(hub.tdmetrics.metrics, hub)
        self._track_health(t, view)
        for rule in self.rules:
            for series, active, value, detail in rule.conditions(t, view):
                self._step(t, rule, series, active, value, detail)
        # incident envelope: closes when the firing set drains
        if self._open is not None and not any(
                st.state == FIRING for st in self._states.values()):
            self._open.t1 = t
            self._open = None
        # ALERTS-style exposition (`fdbtpu_alerts` family): one state
        # gauge per tracked alert + the global firing count
        td = hub.tdmetrics
        n_firing = 0
        for (rule_name, series), st in self._states.items():
            if st.state == FIRING:
                n_firing += 1
            td.int64(f"alerts.{rule_name}.{series}.state").set(st.state)
        td.int64("alerts.firing").set(n_firing)

    # -- read model ----------------------------------------------------------
    def firing(self) -> List[Dict[str, Any]]:
        return [{"name": rule_name, "series": series, "value": st.value,
                 "detail": st.detail, "since": round(st.t_firing or 0, 4),
                 "kind": getattr(self._rule_by_name.get(rule_name), "kind",
                                 "rule")}
                for (rule_name, series), st in self._states.items()
                if st.state == FIRING]

    def burn_firing(self) -> bool:
        """Any burn-rate alert currently firing — the signal the
        ratekeeper consumes as a rate clamp alongside resolver_degraded
        (server/ratekeeper.py), and the hook an online resharding
        controller will drive from (ROADMAP item 4)."""
        return any(a["kind"] == "burn" for a in self.firing())

    def alerts_snapshot(self) -> List[Dict[str, Any]]:
        """Every tracked (rule, series) pair's current lifecycle state."""
        return [{"name": rule_name, "series": series,
                 "state": STATE_NAMES.get(st.state, str(st.state)),
                 "value": st.value, "detail": st.detail,
                 "fired_count": st.fired_count}
                for (rule_name, series), st in self._states.items()]

    def timeline(self) -> List[Tuple]:
        """The deterministic replay identity: every ring transition plus
        per-incident (alert names, window kinds, root cause) — two runs
        of the same seed must produce equal timelines."""
        out: List[Tuple] = [
            (round(e["t"], 3), e["alert"], e["series"], e["state"])
            for e in self.ring]
        for inc in self.incidents:
            out.append((
                "incident", inc.id,
                tuple(sorted(a["name"] for a in inc.alerts.values())),
                tuple(sorted({w.get("kind") for w in inc.windows})),
                (inc.root_cause or {}).get("dominant_segment"),
                inc.explained))
        return out

    def snapshot(self) -> Dict[str, Any]:
        """The engine_health / status-doc fragment (server/resolver.py
        attaches it; `tools/cli.py alerts|incidents` renders it)."""
        firing = self.firing()
        return {
            "evaluations": self.evaluations,
            "rules": [r.describe() for r in self.rules],
            "firing": firing,
            "burn_firing": any(a["kind"] == "burn" for a in firing),
            "alerts": self.alerts_snapshot(),
            "ring": list(self.ring)[-32:],
            "incidents": [i.as_dict() for i in self.incidents],
            "health_transitions": list(self.health_transitions)[-16:],
        }

    # -- correlation ---------------------------------------------------------
    def correlate(self, windows: Sequence[Dict[str, Any]],
                  root_cause: Optional[Dict[str, Any]] = None,
                  breached_slo: Optional[str] = None,
                  margin_s: float = 0.25) -> List[Incident]:
        """Machine-correlate every incident against injected fault
        windows ({kind, t0, t1} dicts — the nemesis' own records), the
        observed health transitions, and the campaign's trace root cause.
        An incident is EXPLAINED when it overlaps an injected window, or
        when `breached_slo` names a breach one of its burn alerts
        measures (the incident then IS the breach's alert, not noise).
        Anything else is an unexplained incident — `assert_slos` fails
        the campaign on it, alert name first."""
        from .knobs import SERVER_KNOBS

        end_default = self.now_fn()
        burn_look_back = float(SERVER_KNOBS.watchdog_burn_slow_s)
        for inc in self.incidents:
            lo, hi = inc.t0 - margin_s, (inc.t1 or end_default) + margin_s
            if any(a.get("kind") == "burn" for a in inc.alerts.values()):
                # a burn alert's firing evidence is its trailing slow
                # window: bad events inside [t0 - slow_s, t0] lit it, so
                # a fault window anywhere in that span explains the
                # incident even when the alert fired after the window
                # closed (burn trails the cause by construction)
                lo -= burn_look_back
            inc.windows = [w for w in windows
                           if float(w.get("t0", 0)) <= hi
                           and float(w.get("t1", 0)) >= lo]
            inc.health = [h for h in self.health_transitions
                          if lo <= h["t"] <= hi]
            inc.root_cause = root_cause
            if inc.windows:
                inc.explained = True
                kinds = sorted({w.get("kind", "?") for w in inc.windows})
                inc.explanation = "overlaps injected " + "+".join(kinds)
            elif breached_slo is not None and any(
                    a["kind"] == "burn" for a in inc.alerts.values()):
                inc.explained = True
                inc.explanation = f"names the {breached_slo} breach"
        if blackbox.enabled():
            # correlated incidents onto the black-box journal, ONCE per
            # incident even when correlate() runs again: the post-hoc
            # explain joins them against batch/fault timelines
            for inc in self.incidents:
                if not inc.journaled:
                    inc.journaled = True
                    blackbox.record_incident(inc.as_dict())
        return self.incidents


# -- SLI recording ------------------------------------------------------------

def record_commit_sli(hub, latency_ms: float, budget_ms: float,
                      label: str = "commit") -> None:
    """One served commit ack into the p99-vs-budget SLI counters the
    `slo_p99_burn` rule consumes: good = acked within the budget, bad =
    acked late. Transport failures and throttles are NOT SLI events —
    they burn the throttle/abort budgets, not the latency one. Callers
    gate on `hub.watchdog is not None` so the disabled path records
    nothing."""
    td = hub.tdmetrics
    td.int64(f"sli.{label}.total").increment()
    if latency_ms <= budget_ms:
        td.int64(f"sli.{label}.good").increment()
    else:
        td.int64(f"sli.{label}.bad").increment()


def watchdog_from_knobs() -> Optional[Watchdog]:
    """A default-ruleset watchdog when `watchdog_enabled` is on, else
    None (the disabled path constructs nothing)."""
    from .knobs import SERVER_KNOBS

    if not bool(getattr(SERVER_KNOBS, "watchdog_enabled", False)):
        return None
    return Watchdog(default_rules())
