"""Measured multi-shard mesh resolution with a non-blocking result ring.

Port of ``foundationdb_tpu/parallel/mesh_engine.py``. ShardedConflictEngine
(sharding.py) runs one fused program per dispatch unit and its force()
waits on every batch. This engine gives the sharded path the device
loop's serving treatment, so the cost of combining shards is measured:

  * SPLIT dispatch unit: a one-chunk unit is two programs, each built
    through `_build_and_record` under its own progcache `variant=`:
    "scan", the shard-local phases 1-2 of every shard
    (make_mesh_scan_step, nothing that combines shards), and
    "exchange", the combine of the shards' [T] planes with the commit
    fixpoint, then each shard's apply (make_mesh_exchange_step). On the
    card each is a captured CUDA graph (the exchange: two, with and
    without a GC horizon); the exchange's fixpoint is one launch of the
    CUDA kernel's stacked entry, in which each round's blocked counts of
    all shards are summed in place. A C-chunk unit (C > 1) is one fused
    program (make_sharded_scan_step): chunk c+1's scan reads the table
    chunk c's apply wrote, so the split cannot span chunks.
  * RESULT RING: a unit's outputs are copied to pinned host buffers behind
    one event and the unit joins a ring; `poll()` finishes exactly the
    ready prefix (Event.query(), never a sync), and `loop_stats` files
    every drain as drained_nonblocking / forced_waits / blocking_syncs
    (the deadline fallback; 0 in a healthy run). With overlap on (knob
    `resolver_mesh_overlap`, default "on") the host packs and enqueues the
    next unit while the previous one runs, bounded by
    `resolver_mesh_queue_depth`; "serial" forces every unit at dispatch,
    the A/B baseline of tools/mesh_bench.py.
  * MEASURED exchange: the ticket keeps an event recorded after the scan
    program; the drain stamps when it first saw the scan done and when the
    unit was done, so `mesh_stats` carries a host-observed scan-ready ->
    exchange-ready interval per drained unit (`last_collective_ms`).
  * GROUPS (sharding.placement): with the shards in several groups, a
    unit of any C is one exchange.GroupedProgram: each group's scan on
    its device and stream, the leader's gather and one stacked launch,
    each group's apply. The ticket's scan probe is the leader's event
    after the last group's scan, and its exchange interval ends at the
    leader's fixpoint event. The unit's done event is recorded on the
    leader after it waited on every group's last event, so it passes
    Event.query() only once every group's has.
  * A shard is an entry of the engine's device list. The shard map may be
    adopted from the heat aggregator's measured equal-load split keys
    (`measured_shard_map`); under ElasticResolverGroup a mesh engine is a
    slot like any other (same resolve() / journal / handoff contract), and
    `device_view()` gives the per-shard placement rows that
    server/reshard.py collects.

Exactness: the split pair composes the same phases as the fused step, so
abort sets equal the sharded and single-table engines' and the oracle's
at every shard count (tests/test_torch_mesh.py).
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import telemetry
from ..core.keyshard import KeyShardMap, _fmt_key
from ..core.knobs import SERVER_KNOBS
from ..core.types import Version
from ..ops import conflict_kernel as ck
from ..ops import fixpoint_cuda, graph_if
from ..ops.conflict_kernel import KernelConfig
from ..ops.host_engine import _KEY_MASK, count_capture, input_shapes, load_chunk
from .sharding import ShardedConflictEngine, make_mesh_exchange_step, make_mesh_scan_step

__all__ = ["MeshShardedConflictEngine", "measured_shard_map", "mesh_overlap_requested",
           "mesh_device_count"]

#: legal values of the `resolver_mesh_overlap` knob
MESH_OVERLAP_MODES = ("", "on", "serial")


def mesh_overlap_requested() -> bool:
    """False iff the `resolver_mesh_overlap` knob selects the serialized
    A/B baseline (force every dispatch unit before the next enqueue)."""
    raw = str(getattr(SERVER_KNOBS, "resolver_mesh_overlap", "on") or "").strip()
    if raw not in MESH_OVERLAP_MODES:
        raise ValueError(
            f"unknown resolver_mesh_overlap mode {raw!r}; expected one of {MESH_OVERLAP_MODES}")
    return raw != "serial"


def mesh_device_count(device=None) -> int:
    """Shards the mesh engine spans by default: the `resolver_mesh_devices`
    knob, 0 meaning every visible device of the engine's kind (the CUDA
    device count; 1 on the CPU)."""
    n = int(getattr(SERVER_KNOBS, "resolver_mesh_devices", 0) or 0)
    if n > 0:
        return n
    kind = torch.device(device).type if device is not None else (
        "cuda" if torch.cuda.is_available() else "cpu")
    return max(1, torch.cuda.device_count()) if kind == "cuda" else 1


def measured_shard_map(heat, n_shards: int) -> KeyShardMap:
    """The shard map a mesh (re)build adopts: the heat aggregator's
    measured equal-load split keys when the histogram can supply a full
    set, byte-uniform otherwise (KeyShardMap.from_split_points
    sanitizes)."""
    splits: List[bytes] = []
    if heat is not None:
        try:
            splits = list(heat.split_points(shards=n_shards) or [])
        except Exception:
            splits = []
    return KeyShardMap.from_split_points(splits, n_shards)


class _MeshTicket:
    """One dispatched mesh unit's place in the result ring: its outputs in
    host buffers (pinned, filled behind `event` on the card; filled at
    dispatch on the CPU, where `event` is None)."""

    __slots__ = ("host", "event", "scan_probe", "fix_probe", "n_chunks", "heat_layout",
                 "heat_base", "heat_version", "keep", "enq_t", "scan_ready_t", "fix_ready_t",
                 "sample", "timing", "status", "overflow", "done")

    def __init__(self, host, event, scan_probe, n_chunks: int, heat_layout: str,
                 heat_base: int, heat_version, keep, sample=None, timing=None, fix_probe=None):
        self.host = host
        self.event = event
        #: the scan program's completion (split units only): an event on
        #: the card, True on the CPU (done at dispatch)
        self.scan_probe = scan_probe
        #: a grouped unit's leader fixpoint completion (as scan_probe), the
        #: end of its measured exchange interval; None: the unit's end
        self.fix_probe = fix_probe
        self.n_chunks = n_chunks
        self.heat_layout = heat_layout
        self.heat_base = heat_base
        self.heat_version = heat_version
        #: everything the unit's copies may still read (host pack buffers)
        self.keep = keep
        self.enq_t = time.perf_counter()
        self.scan_ready_t: Optional[float] = None
        self.fix_ready_t: Optional[float] = None
        #: (bucket T, chunks, stamp) of a sampled unit, and its two timing
        #: events on the card
        self.sample = sample
        self.timing = timing
        self.status: Optional[np.ndarray] = None
        self.overflow = False
        self.done = False

    def probe_scan(self) -> None:
        """Stamp the moment the scan outputs were first seen ready
        (non-blocking; the exchange-interval measurement only)."""
        if self.scan_ready_t is None and self.scan_probe is not None and (
                self.scan_probe is True or self.scan_probe.query()):
            self.scan_ready_t = time.perf_counter()
        if self.scan_ready_t is not None and self.fix_ready_t is None and \
                self.fix_probe is not None and (self.fix_probe is True or self.fix_probe.query()):
            self.fix_ready_t = time.perf_counter()

    def ready(self) -> bool:
        """Non-blocking: have this unit's outputs landed?"""
        self.probe_scan()
        return self.event is None or self.event.query()


class _ScanProgram:
    """The "scan" half of a split unit at one bucket: static inputs [1, S,
    ...] (load_chunk's layout), the shard-local phases over the engine's
    table into static output buffers (hist, edges, wpos). On the card one
    captured graph; on the CPU the scan runs eagerly and `out` holds its
    tensors."""

    def __init__(self, engine: "MeshShardedConflictEngine", bucket: KernelConfig):
        dev = engine.device
        self.engine, self.bucket, self.S = engine, bucket, engine.stack
        self.inputs = {name: torch.zeros((1, self.S) + shape, dtype=dtype, device=dev)
                       for name, (shape, dtype) in input_shapes(bucket).items()}
        self.cold_dirty = [False]
        self.fn = make_mesh_scan_step(bucket, engine.devices)
        self.out = None
        self.graph = None
        if dev.type == "cuda":
            self._capture()

    def batch(self) -> Dict[str, torch.Tensor]:
        """The stacked batch over the static inputs, keys widened."""
        return {name: (v[0].to(torch.int64) & _KEY_MASK) if name in ck.KEY_FIELDS else v[0]
                for name, v in self.inputs.items()}

    def _capture(self) -> None:
        eng = self.engine
        stream = eng.capture_stream
        stream.wait_stream(torch.cuda.current_stream(eng.device))
        with torch.cuda.stream(stream):
            warm = self.fn(eng.state, self.batch())        # reads the table only
            self.out = (torch.empty_like(warm[0]),
                        {k: torch.empty_like(v) for k, v in warm[1].items()},
                        {k: torch.empty_like(v) for k, v in warm[2].items()})
        torch.cuda.current_stream(eng.device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=eng.graph_pool, stream=stream,
                              capture_error_mode="relaxed"):
            hist, edges, wpos = self.fn(eng.state, self.batch())
            self.out[0].copy_(hist)
            for k, v in edges.items():
                self.out[1][k].copy_(v)
            for k, v in wpos.items():
                self.out[2][k].copy_(v)
        self.graph = graph
        count_capture(eng.perf)

    def load(self, per, pack) -> None:
        load_chunk(self.inputs, self.cold_dirty, 0, self.bucket, self.S, per, pack)

    def run(self) -> None:
        if self.graph is not None:
            self.graph.replay()
        else:
            self.out = self.fn(self.engine.state, self.batch())


class _ExchangeProgram:
    """The "exchange" half of a split unit at one bucket: reads the scan
    program's batch and outputs, runs the stacked fixpoint, each shard's
    apply (in place on the engine's table) and the heat aggregates, and
    writes static status [1, T], overflow [1], merged [1, S] (tiered) and
    heat [S, ...] buffers. On the card two captured graphs (with and
    without a GC horizon), each launching the fixpoint's stacked entry
    once; the eager warm run before each capture runs on a scratch copy of
    the table (both merge branch sides under the tiered structure)."""

    def __init__(self, engine: "MeshShardedConflictEngine", bucket: KernelConfig,
                 scan: _ScanProgram):
        dev = engine.device
        self.engine, self.bucket, self.scan, self.S = engine, bucket, scan, engine.stack
        self.fn = make_mesh_exchange_step(bucket, engine.devices)
        self.status = torch.zeros((1, bucket.max_txns), dtype=torch.int32, device=dev)
        self.overflow = torch.zeros((1,), dtype=torch.bool, device=dev)
        self.merged = (torch.zeros((1, self.S), dtype=torch.bool, device=dev)
                       if ck.is_tiered(bucket) else None)
        self.heat = {k: torch.zeros(shape, dtype=dtype, device=dev)
                     for k, (shape, dtype) in ck.heat_shapes(bucket, (self.S,)).items()}
        self.graphs: Dict[bool, "torch.cuda.CUDAGraph"] = {}
        if dev.type == "cuda":
            for gc_branch in (False, True):
                self._capture(gc_branch)

    def _body(self, state, gc_branch: bool, batch=None) -> None:
        hist, edges, wpos = self.scan.out
        new_state, out = self.fn(state, self.scan.batch() if batch is None else batch,
                                 hist, edges, wpos, gc_branch)
        for k, v in state.items():
            v.copy_(new_state[k])
        self.status[0].copy_(out["status"][0])
        self.overflow[0].copy_(out["overflow"][0])
        if self.merged is not None:
            self.merged[0].copy_(out["merged"])
        for k, v in self.heat.items():
            v.copy_(out["heat"][k])

    def _merge_warm_batch(self):
        b = {k: v.clone() for k, v in self.scan.batch().items()}
        b["t_ok"][:, 0] = True
        b["t_too_old"][:, 0] = False
        b["wp_valid"][0, 0] = True
        b["wp_txn"][0, 0] = 0
        return b

    def _capture(self, gc_branch: bool) -> None:
        eng = self.engine
        stream = eng.capture_stream
        stream.wait_stream(torch.cuda.current_stream(eng.device))
        with torch.cuda.stream(stream):
            scratch = {k: v.clone() for k, v in eng.state.items()}
            self._body(scratch, gc_branch)
            if self.merged is not None:
                scratch["nruns"].fill_(self.bucket.run_slots)
                self._body(scratch, gc_branch, self._merge_warm_batch())
        torch.cuda.current_stream(eng.device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        before = fixpoint_cuda.FIXPOINT_STACKED.launches
        if_before = graph_if.GRAPH_IF.nodes
        with graph_if.bodies(eng.body_levels[:1]), \
                torch.cuda.graph(graph, pool=eng.graph_pool, stream=stream,
                                 capture_error_mode="relaxed"):
            self._body(eng.state, gc_branch)
        launches = fixpoint_cuda.FIXPOINT_STACKED.launches - before
        if launches != 1:
            raise RuntimeError(f"captured {launches} stacked fixpoint launches in an exchange")
        if_nodes = graph_if.GRAPH_IF.nodes - if_before
        if if_nodes != (1 if self.merged is not None else 0):
            raise RuntimeError(f"captured {if_nodes} merge IF nodes in an exchange")
        self.graphs[gc_branch] = graph
        count_capture(eng.perf)

    def run(self, gc_branch: bool) -> None:
        if self.graphs:
            self.graphs[gc_branch].replay()
            fixpoint_cuda.FIXPOINT_STACKED.graph_launches += 1
        else:
            self._body(self.engine.state, gc_branch)


class MeshShardedConflictEngine(ShardedConflictEngine):
    """N-shard mesh ConflictSet engine: split scan / exchange programs, the
    non-blocking result ring, measured exchange intervals. Same resolve()
    contract as every other engine family; `devices` lists one device per
    shard (None: `device` repeated, or the cards as
    sharding.resolve_devices spreads them) and `groups` places them as
    sharding.placement does."""

    name = "mesh"
    dispatch_mode = "mesh"

    def __init__(self, cfg: KernelConfig = KernelConfig(), shards: Optional[KeyShardMap] = None,
                 devices: Optional[Sequence] = None, initial_version: Version = 0,
                 ladder=None, scan_sizes: Sequence[int] = (2, 4, 8), arena: bool = True,
                 history_search: Optional[str] = None, heat_buckets: Optional[int] = None,
                 device_time_sample_rate: Optional[float] = None,
                 queue_depth: Optional[int] = None, overlap: Optional[bool] = None,
                 drain_deadline_s: float = 5.0, history_structure: Optional[str] = None,
                 device=None, groups: Optional[Sequence[int]] = None):
        n = (shards.n_shards if shards is not None
             else len(devices) if devices is not None else mesh_device_count(device))
        #: dispatched-but-undrained tickets: the result ring
        self._ring: deque = deque()
        self.queue_depth = max(1, int(
            queue_depth if queue_depth is not None
            else int(getattr(SERVER_KNOBS, "resolver_mesh_queue_depth", 2))))
        self.overlap = bool(overlap if overlap is not None else mesh_overlap_requested())
        self.drain_deadline_s = drain_deadline_s
        #: the device loop's sync-accounting keys, so
        #: ElasticResolverGroup.loop_stats and blocking_syncs == 0 read
        #: mesh slots unchanged
        self.loop_stats = {"enqueued_chunks": 0, "units": 0,
                           "drained_nonblocking": 0, "forced_waits": 0,
                           "blocking_syncs": 0, "wait_ms": 0.0,
                           "enqueue_ms": 0.0, "decode_ms": 0.0}
        #: topology and measured-exchange gauges (fdbtpu_mesh family)
        self.mesh_stats: Dict[str, float] = {
            "n_devices": int(n), "n_shards": int(n),
            "exchanges": 0, "timed_exchanges": 0,
            "table_bytes_per_shard": 0,
            "last_collective_ms": 0.0, "exchange_ms_total": 0.0,
            "scan_ms_total": 0.0,
        }
        super().__init__(cfg, shards or KeyShardMap.uniform(n), devices=devices,
                         initial_version=initial_version, ladder=ladder, scan_sizes=scan_sizes,
                         arena=arena, history_search=history_search,
                         heat_buckets=heat_buckets,
                         device_time_sample_rate=device_time_sample_rate,
                         history_structure=history_structure, device=device, groups=groups)
        self.mesh_stats["table_bytes_per_shard"] = self._table_bytes_per_shard()
        self._mesh_telemetry_label = telemetry.hub().register_mesh(self, name=self.name)

    # -- telemetry ------------------------------------------------------------
    def ring_depth(self) -> int:
        """Dispatched-but-undrained tickets in the result ring."""
        return len(self._ring)

    def _table_bytes_per_shard(self) -> int:
        total = sum(v.numel() * v.element_size() for v in self.state.values())
        return total // max(self.n_shards, 1)

    def mesh_stats_snapshot(self) -> Dict[str, float]:
        """The topology and measured-exchange gauges plus the sync
        accounting, as one batch-attachable snapshot."""
        snap = {k: (round(v, 4) if isinstance(v, float) else v)
                for k, v in self.mesh_stats.items()}
        snap.update({k: (round(v, 4) if isinstance(v, float) else v)
                     for k, v in self.loop_stats.items()})
        snap["ring_depth"] = self.ring_depth()
        snap["overlap"] = self.overlap
        return snap

    def loop_stats_snapshot(self) -> Dict[str, float]:
        return self.mesh_stats_snapshot()

    def device_view(self) -> List[dict]:
        """Per-shard placement rows: shard id, owning device, table bytes,
        the last measured exchange interval, and, with several groups, the
        shard's group."""
        tb = self._table_bytes_per_shard()
        last = round(float(self.mesh_stats["last_collective_ms"]), 4)
        rows = [{"shard": s,
                 "device": int(d.index) if d.index is not None else 0,
                 "platform": d.type,
                 "span_begin": _fmt_key(self.shards.begins[s]),
                 "table_bytes": tb,
                 "last_collective_ms": last}
                for s, d in enumerate(self.devices)]
        if self.grouped:
            # one group keeps JAX's rows; several name each shard's group
            for row in rows:
                row["group"] = self._group_of(row["shard"])
        return rows

    # -- device state ---------------------------------------------------------
    def _reset_device_state(self, version_rel: int) -> None:
        self.drain_ring()
        super()._reset_device_state(version_rel)

    def _device_states_for_snapshot(self):
        # quiesce the ring first: a unit in flight may still own the table
        self.drain_ring()
        return super()._device_states_for_snapshot()

    # -- programs ---------------------------------------------------------------
    def _program(self, bucket: KernelConfig, n_chunks: int):
        key = (bucket.max_txns, n_chunks)
        prog = self._programs.get(key)
        if prog is None:
            if n_chunks == 1 and not self.grouped:
                # the split pair: each half builds under its own variant
                scan = self._build_and_record(
                    bucket, 1, variant="scan", make=lambda b, c: _ScanProgram(self, b))
                exch = self._build_and_record(
                    bucket, 1, variant="exchange",
                    make=lambda b, c: _ExchangeProgram(self, b, scan))
                prog = (scan, exch)
            else:
                prog = self._build_and_record(bucket, n_chunks)
            self._programs[key] = prog
        return prog

    # -- dispatch / result ring -------------------------------------------------
    def _dispatch_unit(self, bucket: KernelConfig, per_chunks: List[List[Dict[str, np.ndarray]]],
                       packs=None, sample=None):
        with self._on_leader():
            return self._enqueue_unit(bucket, per_chunks, packs, sample)

    def _enqueue_unit(self, bucket: KernelConfig, per_chunks: List[List[Dict[str, np.ndarray]]],
                      packs, sample):
        C = len(per_chunks)
        gcs = [int(per[0]["gc"]) for per in per_chunks]
        if any(gcs[:-1]):
            raise ValueError("only the last chunk of a dispatch unit may carry a GC horizon")
        prog = self._program(bucket, C)
        cuda = self.device.type == "cuda"
        t_enq = time.perf_counter()
        timing = None
        if sample is not None and cuda:
            timing = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            timing[0].record()
        scan_probe = fix_probe = None
        if self.grouped:
            for c, per in enumerate(per_chunks):
                prog.load(c, per, packs[c] if packs else None)
            prog.run(gcs[-1] > 0)
            outs = {"status": prog.status, "overflow": prog.overflow, **prog.heat}
            merged = prog.merged
            layout = "sc"
            if C == 1:
                scan_probe, fix_probe = prog.probes if cuda else (True, True)
                self.mesh_stats["exchanges"] += 1
        elif C == 1:
            scan, exch = prog
            scan.load(per_chunks[0], packs[0] if packs else None)
            scan.run()
            if cuda:
                scan_probe = torch.cuda.Event()
                scan_probe.record()
            else:
                scan_probe = True
            exch.run(gcs[0] > 0)
            outs = {"status": exch.status, "overflow": exch.overflow, **exch.heat}
            merged = exch.merged
            layout = "s"
            self.mesh_stats["exchanges"] += 1
        else:
            for c, per in enumerate(per_chunks):
                prog.load(c, per, packs[c] if packs else None)
            prog.run(gcs[-1] > 0)
            outs = {"status": prog.status, "overflow": prog.overflow, **prog.heat}
            merged = prog.merged
            layout = "sc"
        if merged is not None:
            outs["merged"] = merged
        if cuda:
            host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    for k, v in outs.items()}
            for k, v in outs.items():
                host[k].copy_(v, non_blocking=True)
            if timing is not None:
                timing[1].record()
            event = torch.cuda.Event()
            event.record()
        else:
            host = {k: v.clone() for k, v in outs.items()}
            event = None
        self.loop_stats["enqueue_ms"] += (time.perf_counter() - t_enq) * 1e3
        ticket = _MeshTicket(host, event, scan_probe, C, layout, self.base, self._heat_version,
                             keep=(per_chunks, packs),
                             sample=None if sample is None else (bucket.max_txns, C, sample),
                             timing=timing, fix_probe=fix_probe)
        self._ring.append(ticket)
        self.loop_stats["units"] += 1
        self.loop_stats["enqueued_chunks"] += C
        if not self.overlap:
            # the serialized A/B baseline: retire the unit before the host
            # packs anything else
            self._drain_through(ticket)
        else:
            # bound the in-flight depth, then finish what already landed
            while len(self._ring) > self.queue_depth:
                self._drain_through(self._ring[0])
            self.poll()

        def force() -> Tuple[np.ndarray, bool]:
            self._drain_through(ticket)
            return ticket.status, ticket.overflow

        return force

    def poll(self) -> int:
        """Finish the READY prefix of the result ring, the non-blocking
        steady-state path. Returns the number of tickets finished."""
        for t in self._ring:
            # stamp every unit's scan in flight, not only the head's
            t.probe_scan()
        n = 0
        while self._ring and self._ring[0].ready():
            self._finish(self._ring.popleft())
            self.loop_stats["drained_nonblocking"] += 1
            n += 1
        return n

    def drain_ring(self) -> None:
        """Block until every unit in flight drained: the barrier before host
        code reads or resets the table (clear, the split-step path,
        snapshots)."""
        if getattr(self, "_ring", None):
            self._drain_through(self._ring[-1])

    def _drain_through(self, ticket: _MeshTicket) -> None:
        while not ticket.done:
            head = self._ring[0]
            if not head.ready():
                # poll-wait (no device sync call); only the deadline
                # fallback is a blocking sync
                self.loop_stats["forced_waits"] += 1
                t0 = time.perf_counter()
                deadline = t0 + self.drain_deadline_s
                while not head.ready() and time.perf_counter() < deadline:
                    time.sleep(2e-5)
                if not head.ready():
                    self.loop_stats["blocking_syncs"] += 1
                    head.event.synchronize()
                self.loop_stats["wait_ms"] += (time.perf_counter() - t0) * 1e3
            self._finish(self._ring.popleft())

    # fdbtpu-lint: drain-point — only reached once ticket.ready() (or the
    # deadline fallback, which loop_stats charges as a blocking sync): the
    # .numpy() reads below copy COMPLETED pinned buffers, they never park
    # in the device
    def _finish(self, ticket: _MeshTicket) -> None:
        """Decode a landed ticket from its host buffers."""
        t_dec = time.perf_counter()
        host = {k: v.numpy() for k, v in ticket.host.items()}
        ticket.status = host["status"]
        ticket.overflow = bool(host["overflow"].any())
        if "merged" in host:
            self.perf.merges += int(host["merged"].sum())
        if self.heat is not None:
            self._merge_heat({k: host[k] for k in ck.heat_shapes(self.cfg)},
                             version=ticket.heat_version, base=ticket.heat_base,
                             layout=ticket.heat_layout)
        self.loop_stats["decode_ms"] += (time.perf_counter() - t_dec) * 1e3
        if ticket.scan_ready_t is not None:
            # host-observed scan-ready -> unit-ready interval: the measured
            # cost of the combine, the fixpoint and the apply (an upper
            # bound with overlap on: the drain may look late); a grouped
            # unit's ends at its leader fixpoint event
            end = t_dec
            if ticket.fix_probe is not None:
                end = ticket.fix_ready_t if ticket.fix_ready_t is not None else t_dec
            ex_ms = (end - ticket.scan_ready_t) * 1e3
            self.mesh_stats["last_collective_ms"] = ex_ms
            self.mesh_stats["exchange_ms_total"] += ex_ms
            self.mesh_stats["scan_ms_total"] += (ticket.scan_ready_t - ticket.enq_t) * 1e3
            self.mesh_stats["timed_exchanges"] += 1
        if ticket.sample is not None:
            # the unit was done when this drain decoded it, so its timing
            # events are too: reading them adds no sync
            ms = (ticket.timing[0].elapsed_time(ticket.timing[1])
                  if ticket.timing is not None else None)
            self._record_device_sample(*ticket.sample, ms=ms)
        ticket.done = True
        ticket.host = ticket.keep = ticket.timing = ticket.sample = None
        ticket.event = ticket.scan_probe = ticket.fix_probe = None

    # -- the split-step path (host long-key tier) ----------------------------------
    def _run_detect(self, per_shard):
        # the split steps read and write the table directly: quiesce first
        self.drain_ring()
        return super()._run_detect(per_shard)
