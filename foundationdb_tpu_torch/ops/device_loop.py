"""Device-resident resolver loop: the engine whose serving program runs a
queue slot's chunks under one device-side loop.

Port of ``foundationdb_tpu/ops/device_loop.py``. Step dispatch (one
captured program per (bucket, chunk count), a blocking wait on each
batch's verdicts) becomes:

  * one program per ladder bucket: conflict_kernel.resolve_server_loop over
    a Q-chunk queue slot, its chunk count a device scalar. On the card it
    is two captured CUDA graphs (last chunk with / without a GC horizon)
    whose loop over the filled prefix is a conditional WHILE node
    (graph_if), so one graph serves every fill level 1..Q;
  * a double-buffered queue: LoopSlotPool keeps `queue_depth` slots per
    bucket, each a set of pinned host buffers — the slot's [Q, ...] input
    columns and its result buffers. While one slot's program runs, the
    host packs the next batch into another; a slot is reused only after
    its ticket drained;
  * a result ring the host drains without a blocking sync: after the
    replay the engine queues async copies of the committed / too-old
    bitmaps (status_words, a 16x smaller readback than [T] statuses), the
    overflow flag, the tiered merge flags and the heat planes into the
    slot's pinned result buffers and records one event; poll() finishes
    exactly the ready prefix of the ring (Event.query()), reading host
    memory only.

Sync accounting: `loop_stats` files every drain under one kind —
`drained_nonblocking` (ready when the host looked), `forced_waits` (the
host needed a result that had not landed and poll-waited for it) and
`blocking_syncs` (that wait passed `drain_deadline_s` and the host fell
back to a blocking Event.synchronize(); 0 in a healthy run).

drain_loop() blocks until every in-flight slot drained; clear(), the
split-step long-key path and run snapshots call it first, so a caller never
reads or resets the table under a program still in flight.

Telemetry: the engine registers its loop gauges with the hub
(`loop.<label>.*`); a sampled dispatch unit's ticket carries its stamp and,
on the card, two timing events around its copies and replay (an
interval on the stream: device work and the time the stream idles while
the host issues it), and the sample is recorded where the drain finishes
the ticket (poll() or _finish, once Event.query() is true): no sync of
its own.

The `resolver_device_loop` knob ("" | "on" | "pallas") selects this engine
as the default single-card mode (host_engine.default_engine_mode). In the
JAX package "pallas" also bakes its Pallas fixpoint into the loop bodies;
the port's loop always runs the CUDA fixpoint on the card, so "on" and
"pallas" select the same engine.

Exactness: the loop body is resolve_step, and decode_status_bits is the
same function of (committed, t_too_old) as conflict_kernel.status_of, so
verdicts equal the step engine's and the oracle's
(tests/test_torch_device_loop.py).
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import telemetry
from ..core.knobs import SERVER_KNOBS
from ..core.types import TransactionCommitResult, Version
from . import conflict_kernel as ck
from . import fixpoint_cuda, graph_if
from .conflict_kernel import KernelConfig
from .host_engine import (COLD_FIELDS, HOT_FIELDS, TorchConflictEngine, count_capture,
                          input_shapes)

#: legal values of the `resolver_device_loop` knob: "" (off — step
#: dispatch), "on" and "pallas" (the loop engine; both run the CUDA
#: fixpoint on the card)
DEVICE_LOOP_MODES = ("", "on", "pallas")


def device_loop_requested() -> bool:
    """True iff the `resolver_device_loop` knob asks for the loop engine."""
    return bool(_loop_knob())


def _loop_knob() -> str:
    raw = str(getattr(SERVER_KNOBS, "resolver_device_loop", "") or "").strip()
    if raw not in DEVICE_LOOP_MODES:
        raise ValueError(
            f"unknown resolver_device_loop mode {raw!r}; expected one of "
            f"{DEVICE_LOOP_MODES}")
    return raw


def decode_status_bits(commit_words: np.ndarray, too_words: np.ndarray,
                       n_txns: int) -> np.ndarray:
    """[C, status_words] committed / too-old bit planes (uint32 words, or
    int32 words holding their bits) -> [C, T] int32 statuses: the same
    function of (committed, t_too_old) as conflict_kernel.status_of."""
    commit_words = np.asarray(commit_words).astype(np.uint32)
    too_words = np.asarray(too_words).astype(np.uint32)
    idx = np.arange(n_txns)
    w, b = idx >> 5, (idx & 31).astype(np.uint32)
    commit = (commit_words[:, w] >> b) & 1
    too = (too_words[:, w] >> b) & 1
    return np.where(
        too, np.int32(int(TransactionCommitResult.TOO_OLD)),
        np.where(commit, np.int32(int(TransactionCommitResult.COMMITTED)),
                 np.int32(int(TransactionCommitResult.CONFLICT)))).astype(np.int32)


class _LoopTicket:
    """One dispatched queue slot's place in the result ring."""

    __slots__ = ("slot", "event", "n_txns", "n_chunks", "heat_base", "heat_version",
                 "status", "overflow", "done", "sample", "timing")

    def __init__(self, slot: "_LoopSlot", event: Optional["torch.cuda.Event"], n_txns: int,
                 n_chunks: int, heat_base: int = 0, heat_version=None, sample=None,
                 timing=None):
        self.slot = slot
        #: recorded after the copies of the results to the slot's pinned
        #: buffers (None on the CPU, where they are there at once)
        self.event = event
        #: a sampled unit's stamp (_dispatch_sampled) or None, and on the
        #: card its (start, end) timing events, recorded before the copies
        #: in and after the copies out (so done once `event` is)
        self.sample = sample
        self.timing = timing
        self.n_txns = n_txns
        self.n_chunks = n_chunks
        self.heat_base = heat_base
        self.heat_version = heat_version
        self.status: Optional[np.ndarray] = None
        self.overflow = False
        self.done = False

    def ready(self) -> bool:
        """Non-blocking: have this slot's results landed in host memory?"""
        return self.event is None or self.event.query()


class _LoopSlot:
    """One queue slot's pinned host buffers: the [Q, ...] input columns a
    dispatched program copies to the card (input_shapes: keys as the int32
    bits of their words) and the buffers its results come back to. Reused
    only after its ticket drained."""

    __slots__ = ("inputs", "arrays", "cold", "n_host", "results", "ticket")

    def __init__(self, cfg: KernelConfig, q: int, pin: bool):
        self.inputs = {name: torch.zeros((q,) + shape, dtype=dtype, pin_memory=pin)
                       for name, (shape, dtype) in input_shapes(cfg).items()}
        self.arrays = {name: t.numpy().view(np.uint32) if name in ck.KEY_FIELDS else t.numpy()
                       for name, t in self.inputs.items()}
        #: rows whose range-row fields hold a general-router chunk's rows
        self.cold = [False] * q
        self.n_host = torch.zeros((), dtype=torch.int32, pin_memory=pin)
        out = ck.server_outputs(cfg, q, "cpu")
        heat = out.pop("heat", {})
        self.results = {k: v.pin_memory() if pin else v for k, v in {**out, **heat}.items()}
        self.ticket: Optional[_LoopTicket] = None

    def fill(self, chunks: List[Dict[str, np.ndarray]],
             packs: Optional[Sequence[object]] = None) -> None:
        """Copy each chunk's arrays into its row: a columnar chunk (one with
        a pack set) writes its hot fields, its range rows being zero (the
        row's are zeroed if a router chunk left some); any other chunk
        writes every field."""
        for i, chunk in enumerate(chunks):
            if packs and packs[i] is not None:
                names = HOT_FIELDS
                if self.cold[i]:
                    for name in COLD_FIELDS:
                        self.arrays[name][i] = 0
                    self.cold[i] = False
            else:
                names = self.arrays
                self.cold[i] = True
            for name in names:
                self.arrays[name][i] = chunk[name]
        self.n_host.fill_(len(chunks))


class LoopSlotPool:
    """`queue_depth` slots per bucket shape, handed out round-robin — the
    double buffer: the host packs into one slot while another's program is
    in flight. The engine drains a slot's previous ticket before it refills
    the slot."""

    def __init__(self, queue_depth: int, slot_chunks: int, pin: bool = False):
        self.queue_depth = max(2, int(queue_depth))
        self.slot_chunks = max(1, int(slot_chunks))
        self.pin = pin
        self._slots: Dict[int, List[_LoopSlot]] = {}
        self._next: Dict[int, int] = {}

    def prepare(self, bucket: KernelConfig) -> List[_LoopSlot]:
        """The bucket's slots, made on first use (pinned allocation: the
        engine's warmup() makes them before any dispatch)."""
        key = bucket.max_txns
        slots = self._slots.get(key)
        if slots is None:
            slots = self._slots[key] = [_LoopSlot(bucket, self.slot_chunks, self.pin)
                                        for _ in range(self.queue_depth)]
            self._next[key] = 0
        return slots

    def acquire(self, bucket: KernelConfig) -> _LoopSlot:
        slots = self.prepare(bucket)
        key = bucket.max_txns
        i = self._next[key]
        self._next[key] = (i + 1) % len(slots)
        return slots[i]


class _LoopProgram:
    """One bucket's server program: resolve_server_loop over static [Q,
    ...] inputs, a 0-d chunk count and the engine's static table, writing
    static outputs (ck.server_outputs). On the card, two captured CUDA
    graphs (gc_last False / True), each with one WHILE node over chunks 0
    .. n-2 (and, under the tiered structure, the merge's IF node nested in
    its body and another in the last chunk's step); on the CPU the same
    function runs eagerly."""

    def __init__(self, engine: "DeviceLoopEngine", bucket: KernelConfig, q: int):
        dev = engine.device
        self.engine = engine
        self.bucket, self.Q = bucket, q
        self.inputs = {name: torch.zeros((q,) + shape, dtype=dtype, device=dev)
                       for name, (shape, dtype) in input_shapes(bucket).items()}
        self.n_chunks = torch.ones((), dtype=torch.int32, device=dev)
        self.out = ck.server_outputs(bucket, q, dev)
        #: rows of the static inputs whose range-row fields are not zero
        self.dirty = set()
        self.graphs: Dict[bool, "torch.cuda.CUDAGraph"] = {}
        #: fixpoint launches captured per graph (one in the WHILE body, one
        #: for the last chunk); a replay runs n of them
        self.launches = 0
        if dev.type == "cuda":
            for gc_last in (False, True):
                self._capture(gc_last)

    def _body(self, state: Dict[str, torch.Tensor], gc_last: bool,
              inputs: Optional[Dict[str, torch.Tensor]] = None) -> None:
        ck.resolve_server_loop(self.bucket, state, self.inputs if inputs is None else inputs,
                               self.n_chunks, gc_last, out=self.out)

    def _merge_warm_inputs(self) -> Dict[str, torch.Tensor]:
        """The static inputs with one committed point write in every chunk,
        so that a step on a full run stack takes the merge branch."""
        b = {k: v.clone() for k, v in self.inputs.items()}
        b["t_ok"][:, 0] = True
        b["t_too_old"][:, 0] = False
        b["wp_valid"][:, 0] = True
        b["wp_txn"][:, 0] = 0
        return b

    def _capture(self, gc_last: bool) -> None:
        """Capture one variant, after an eager run of every chunk on a
        scratch copy of the table (the one-time work that must not happen
        under capture; under the tiered structure both sides of the merge
        branch, which the IF bodies capture whatever the predicate). A
        capture whose fixpoint launches, WHILE nodes or IF nodes differ from
        the program's raises; nothing falls back to a host loop."""
        eng = self.engine
        stream = eng.capture_stream
        tiered = ck.is_tiered(self.bucket)
        stream.wait_stream(torch.cuda.current_stream(eng.device))
        with torch.cuda.stream(stream):
            self.n_chunks.fill_(self.Q)
            scratch = {k: v.clone() for k, v in eng.state.items()}
            self._body(scratch, gc_last)
            if tiered:
                scratch["nruns"].fill_(self.bucket.run_slots)
                self._body(scratch, gc_last, self._merge_warm_inputs())
        torch.cuda.current_stream(eng.device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        before = fixpoint_cuda.FIXPOINT.launches
        if_before, while_before = graph_if.GRAPH_IF.nodes, graph_if.GRAPH_IF.while_nodes
        with graph_if.bodies(eng.body_levels), \
                torch.cuda.graph(graph, pool=eng.graph_pool, stream=stream,
                                 capture_error_mode="relaxed"):
            self._body(eng.state, gc_last)
        launches = fixpoint_cuda.FIXPOINT.launches - before
        whiles = graph_if.GRAPH_IF.while_nodes - while_before
        ifs = graph_if.GRAPH_IF.nodes - if_before
        if launches != 2 or whiles != 1 or ifs != (2 if tiered else 0):
            raise RuntimeError(
                f"the server loop captured {launches} fixpoint launches, {whiles} WHILE nodes "
                f"and {ifs} IF nodes; expected 2, 1 and {2 if tiered else 0}")
        self.launches = launches
        self.graphs[gc_last] = graph
        count_capture(eng.perf)

    def launch(self, slot: _LoopSlot, n: int, gc_last: bool,
               timing=None) -> Optional["torch.cuda.Event"]:
        """Run the program on the first n chunks of `slot`, all
        stream-ordered on the card: copies of the slot's rows in (only the
        hot fields when no row < n holds or held range rows), the chunk
        count, the replay, copies of the results to the slot's pinned
        buffers, and an event, which is returned; `timing` (start, end)
        events are recorded before the first copy and after the last. On
        the CPU it all runs at once and None is returned."""
        if timing is not None:
            timing[0].record()
        cold = any(slot.cold[i] or i in self.dirty for i in range(n))
        for name in (self.inputs if cold else HOT_FIELDS):
            # fdbtpu-lint: allow[recompile] a partial fill outside the graph: the WHILE node reads n_chunks rows by its device counter, the graph's shapes stay the bucket's
            self.inputs[name][:n].copy_(slot.inputs[name][:n], non_blocking=True)
        if cold:
            self.dirty = {i for i in self.dirty if i >= n} | {i for i in range(n) if slot.cold[i]}
        self.n_chunks.copy_(slot.n_host, non_blocking=True)
        if self.graphs:
            self.graphs[gc_last].replay()
            fixpoint_cuda.FIXPOINT.graph_launches += n
        else:
            self._body(self.engine.state, gc_last)
        outs = {**self.out, **self.out.get("heat", {})}
        for k, dst in slot.results.items():
            src = outs[k]
            if src.dim() == 0:
                dst.copy_(src, non_blocking=True)
            else:
                dst[:n].copy_(src[:n], non_blocking=True)
        if timing is not None:
            timing[1].record()
        if not self.graphs:
            return None
        done = torch.cuda.Event()
        done.record()
        return done


class DeviceLoopEngine(TorchConflictEngine):
    """The loop engine: TorchConflictEngine with step dispatch replaced by
    the device-resident server loop. Drop-in for it everywhere — resolve(),
    the columnar pack / dispatch split the ResolverPipeline drives, the
    ladder and warmup() (one program per bucket), the split-step long-key
    path (which drains the loop first) — with the same verdicts.
    `queue_slots` is Q, the chunks one dispatch takes; `queue_depth` the
    slots per bucket."""

    name = "device_loop"
    dispatch_mode = "loop"

    def __init__(self, cfg: KernelConfig = KernelConfig(), initial_version: Version = 0,
                 device=None, ladder: Optional[Sequence[int]] = None, arena: bool = True,
                 history_search: Optional[str] = None, heat_buckets: Optional[int] = None,
                 device_time_sample_rate: Optional[float] = None,
                 queue_slots: int = 4, queue_depth: int = 2, drain_deadline_s: float = 5.0,
                 history_structure: Optional[str] = None):
        #: chunks per queue slot (Q): one program per bucket serves any
        #: fill 1..Q, so Q bounds chunks per dispatch, not the programs
        self.queue_slots = max(1, int(queue_slots))
        #: FIFO of dispatched, undrained tickets: the result ring
        self._ring: deque = deque()
        self.drain_deadline_s = drain_deadline_s
        #: every drain files under exactly one of the three kinds; the host
        #: ms on each side of the loop (enqueue: slot fill and launch;
        #: decode: bitmaps and heat from the slot's host buffers)
        self.loop_stats = {"enqueued_chunks": 0, "units": 0,
                           "drained_nonblocking": 0, "forced_waits": 0,
                           "blocking_syncs": 0, "wait_ms": 0.0,
                           "enqueue_ms": 0.0, "decode_ms": 0.0}
        super().__init__(cfg, initial_version=initial_version, device=device, ladder=ladder,
                         scan_sizes=(), arena=arena, history_search=history_search,
                         heat_buckets=heat_buckets,
                         device_time_sample_rate=device_time_sample_rate,
                         history_structure=history_structure)
        self._pool = LoopSlotPool(queue_depth, self.queue_slots,
                                  pin=self.device.type == "cuda")
        # the loop's queue/ring gauges: `loop.<label>.*` series beside the
        # EnginePerf counters the base class registered
        telemetry.hub().register_loop(self, name=self.name)

    # -- telemetry ------------------------------------------------------------
    def ring_depth(self) -> int:
        """Dispatched-but-undrained tickets in the result ring."""
        return len(self._ring)

    def slots_in_flight(self) -> int:
        """Queue slots whose program may still read or write their host
        buffers."""
        return sum(1 for slots in self._pool._slots.values() for s in slots
                   if s.ticket is not None and not s.ticket.done)

    def loop_stats_snapshot(self) -> Dict[str, float]:
        """The sync accounting plus the live ring / slot gauges."""
        snap = {k: (round(v, 4) if isinstance(v, float) else v)
                for k, v in self.loop_stats.items()}
        snap["ring_depth"] = self.ring_depth()
        snap["slots_in_flight"] = self.slots_in_flight()
        return snap

    # -- programs ------------------------------------------------------------
    def _program(self, bucket: KernelConfig, n_chunks: int):
        # every chunk count maps to the ONE loop program per bucket (the
        # fill level is a device scalar): warmup() builds len(buckets)
        key = (bucket.max_txns, -1)
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = self._build_and_record(bucket, self.queue_slots)
        return prog

    def _make_program(self, bucket: KernelConfig, n_chunks: int) -> _LoopProgram:
        return _LoopProgram(self, bucket, n_chunks)

    def warmup(self, buckets: Optional[Sequence[KernelConfig]] = None,
               scan_sizes: Optional[Sequence[int]] = None) -> "DeviceLoopEngine":
        """Build each bucket's program and its queue slots (pinned on the
        card), and fill the pack arena."""
        super().warmup(buckets=buckets, scan_sizes=())
        for b in (buckets if buckets is not None else self.buckets):
            self._pool.prepare(b)
        return self

    def _split_run(self, n: int) -> List[int]:
        """Same-bucket runs split into queue-slot fills of at most Q chunks."""
        out = [self.queue_slots] * (n // self.queue_slots)
        if n % self.queue_slots:
            out.append(n % self.queue_slots)
        return out

    # -- enqueue / result ring -----------------------------------------------
    def _dispatch_unit(self, bucket: KernelConfig, per_chunks: List[List[Dict[str, np.ndarray]]],
                       packs=None, sample=None):
        C = len(per_chunks)
        if C > self.queue_slots:
            raise ValueError(f"{C} chunks exceed the {self.queue_slots}-chunk queue slot")
        gcs = [int(per[0]["gc"]) for per in per_chunks]
        if any(gcs[:-1]):
            raise ValueError("only the last chunk of a dispatch unit may carry a GC horizon")
        prog = self._program(bucket, C)
        slot = self._acquire_slot(bucket)
        t_enq = time.perf_counter()
        slot.fill([per[0] for per in per_chunks], packs)
        timing = None
        if sample is not None and self.device.type == "cuda":
            timing = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        event = prog.launch(slot, C, gcs[-1] > 0, timing)
        self.loop_stats["enqueue_ms"] += (time.perf_counter() - t_enq) * 1e3
        ticket = _LoopTicket(slot, event, bucket.max_txns, C, heat_base=self.base,
                             heat_version=self._heat_version, sample=sample, timing=timing)
        slot.ticket = ticket
        self._ring.append(ticket)
        self.loop_stats["units"] += 1
        self.loop_stats["enqueued_chunks"] += C
        # steady-state non-blocking poll: finish whatever already landed
        self.poll()

        def force() -> Tuple[np.ndarray, bool]:
            self._drain_through(ticket)
            return ticket.status, ticket.overflow

        return force

    def _acquire_slot(self, bucket: KernelConfig) -> _LoopSlot:
        slot = self._pool.acquire(bucket)
        if slot.ticket is not None and not slot.ticket.done:
            # the double buffer wrapped onto a slot still in flight: drain
            # through its ticket before overwriting its buffers
            self._drain_through(slot.ticket)
        return slot

    def poll(self) -> int:
        """Finish the READY prefix of the result ring, the non-blocking
        steady-state path. Returns the number of tickets finished."""
        n = 0
        while self._ring and self._ring[0].ready():
            self._finish(self._ring.popleft())
            self.loop_stats["drained_nonblocking"] += 1
            n += 1
        return n

    def drain_loop(self) -> None:
        """Block until every in-flight slot drained: the barrier before host
        code reads or resets the table (clear, split-step path, snapshots)."""
        if self._ring:
            self._drain_through(self._ring[-1])

    def _drain_through(self, ticket: _LoopTicket) -> None:
        while not ticket.done:
            head = self._ring[0]
            if not head.ready():
                # the host needs a result that has not landed: poll-wait for
                # it (no device sync call); only the deadline fallback is a
                # blocking sync
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
    # .numpy() reads below copy a slot's COMPLETED pinned buffers, they never
    # park in the device
    def _finish(self, ticket: _LoopTicket) -> None:
        """Decode a landed ticket from its slot's host buffers: statuses,
        overflow, merge count and heat."""
        t_dec = time.perf_counter()
        res, n = ticket.slot.results, ticket.n_chunks
        ticket.status = decode_status_bits(res["commit_bits"][:n].numpy(),
                                           res["too_old_bits"][:n].numpy(), ticket.n_txns)
        ticket.overflow = bool(res["overflow"].numpy())
        if "merged" in res:
            self.perf.merges += int(res["merged"][:n].numpy().sum())
        if self.heat is not None:
            self._merge_heat({k: res[k][:n].numpy() for k in ck.heat_shapes(self.cfg)},
                             version=ticket.heat_version, base=ticket.heat_base, layout="c")
        self.loop_stats["decode_ms"] += (time.perf_counter() - t_dec) * 1e3
        if ticket.sample is not None:
            # the ticket's results were ready when this drain decoded them,
            # so its timing events are done too: reading them adds no sync
            ms = (ticket.timing[0].elapsed_time(ticket.timing[1])
                  if ticket.timing is not None else None)
            self._record_device_sample(ticket.n_txns, ticket.n_chunks, ticket.sample, ms=ms)
            ticket.sample = ticket.timing = None
        ticket.done = True
        if ticket.slot.ticket is ticket:
            ticket.slot.ticket = None

    # -- host access to the table ----------------------------------------------
    def _reset_device_state(self, version_rel: int) -> None:
        self.drain_loop()
        super()._reset_device_state(version_rel)

    def _device_states_for_snapshot(self):
        self.drain_loop()
        return super()._device_states_for_snapshot()

    def _run_detect(self, per_shard):
        self.drain_loop()
        return super()._run_detect(per_shard)
