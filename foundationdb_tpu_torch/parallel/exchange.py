"""Shards in groups across devices: the cross-device half of the port's
sharded resolver.

An N-shard engine places its shards in ordered GROUPS (sharding.placement):
each group holds the tables of a contiguous run of shards, stacked on the
leading axis of one state on one device, as the one-device engines stack
them. Several groups may share a device. Each group runs its shards'
phases 1-2 (ck.detect_step_stacked) and, once the verdicts are known, its
shards' apply, GC and heat on its own device. Only the commit fixpoint's
inputs and its [T] result cross between groups:

  (a) each group scans its shards on its device and stream, then records
      an event;
  (b) the LEADER, group 0's device, waits on every group's event, copies
      each group's fixpoint inputs into a preallocated [N, ...] stack (the
      history hits, the packed edge words and gid slots, and the row txn
      / valid arrays the stacked entry reads) and runs ONE launch of the
      CUDA kernel's stacked entry over all N shards (on the CPU its plain
      version, conflict_kernel.commit_fixpoint_stacked), then records an
      event;
  (c) each group's stream waits on that event, copies `committed` [T] in
      and runs its apply, GC and heat.

JAX's shard_map psums a [T] plane every fixpoint round; the port gathers
each shard's fixpoint inputs once a batch, so one launch covers every
round and the host loops nothing. Counts add across disjoint key shards in
either form, so the verdicts, tables and heat are JAX's bit for bit
(tests/test_torch_groups.py).

Ordering across groups uses only stream-on-event waits: a dispatch makes
no host sync. The copies are issued between graph replays; no captured
graph spans devices. Each group's programs are captured on its own
device, with a graph pool and streams of its own (`GroupDevice`); the
leader's fixpoint graph is captured with group 0's.

The functions here are the eager forms (the make_* programs of
sharding.py and the long-key split steps); `GroupedProgram` is the
engines' program over static buffers, captured on the card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import types
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..ops import conflict_kernel as ck
from ..ops import fixpoint_cuda, graph_if
from ..ops.conflict_kernel import KernelConfig
from ..ops.host_engine import _KEY_MASK, count_capture, input_shapes, load_chunk

Tensor = torch.Tensor

#: the edge planes the stacked fixpoint reads (the heat witness planes of
#: local_phases stay with their group)
EDGE_FIELDS = ("ovw", "ovrp", "gid_rp", "gid_wp")
#: the batch rows the stacked fixpoint reads
ROW_FIELDS = ("rp_txn", "rp_valid", "r_txn", "r_valid", "wp_txn", "wp_valid", "w_txn", "w_valid")


@dataclasses.dataclass(frozen=True)
class Group:
    """Shards [lo, hi) of an engine, stacked on one device."""

    device: torch.device
    lo: int
    hi: int

    @property
    def n(self) -> int:
        return self.hi - self.lo


def join(parts: Sequence[Dict[str, Tensor]], device) -> Dict[str, Tensor]:
    """Per-group [n_g, ...] trees as one [N, ...] tree on `device`."""
    return {k: torch.cat([p[k].to(device) for p in parts]) for k in parts[0]}


def fixpoint_inputs(hists: Sequence[Tensor], edges: Sequence[Dict[str, Tensor]],
                    batches: Sequence[Dict[str, Tensor]], leader: torch.device):
    """Step (b)'s gather, eagerly: every group's fixpoint inputs stacked
    [N, ...] on the leader (hist, the EDGE_FIELDS, the ROW_FIELDS)."""
    hist = torch.cat([h.to(leader) for h in hists])
    return (hist, join([{k: e[k] for k in EDGE_FIELDS} for e in edges], leader),
            join([{k: b[k] for k in ROW_FIELDS} for b in batches], leader))


def leader_fixpoint(cfg: KernelConfig, t_ok: Tensor, hist: Tensor, edges: Dict[str, Tensor],
                    rows: Dict[str, Tensor]) -> Tensor:
    """committed [T] over all N shards: one launch of the stacked entry on
    the card, its plain version on the CPU."""
    return fixpoint_cuda.commit_fixpoint_stacked(cfg, t_ok, hist, edges, rows)


def apply_group(cfg: KernelConfig, state: Dict[str, Tensor], batch: Dict[str, Tensor],
                committed: Tensor, edges: Dict[str, Tensor], wpos: Dict[str, Tensor],
                gc_branch: bool):
    """Step (c) for one group: ck.exchange_step_stacked after its fixpoint,
    under the global `committed` [T]. Returns (new_state, {"status" [T],
    "overflow" [n_g] per shard, "n" [n_g], "merged" [n_g] (tiered), "heat"
    [n_g, ...] (heat on)})."""
    new_state, overflow, reclaimed, merged = ck._apply_stacked(cfg, state, batch, committed,
                                                               wpos, gc_branch)
    out = {"status": ck.status_of(batch["t_too_old"][0], committed), "overflow": overflow,
           "n": new_state["n"]}
    if merged is not None:
        out["merged"] = merged
    if cfg.heat_buckets > 0:
        out["heat"] = ck.heat_of_stacked(cfg, new_state, batch, committed, edges, reclaimed)
    return new_state, out


def exchange(cfg: KernelConfig, groups: Sequence[Group], states, batches, scans,
             gc_branch: bool, t_ok: Optional[Tensor] = None):
    """Steps (b) and (c), eagerly: the leader's fixpoint over every group's
    scan outputs (`scans`: per group (hist, edges, wpos)), then each
    group's apply. `t_ok` [T] (default: the batch's) lives on the leader.
    Returns (new states per group, out on the leader: "status" [T],
    "overflow" 0-d (any shard's), "n" [N], "merged" [N] (tiered), "heat"
    [N, ...] (heat on))."""
    leader = groups[0].device
    hist, edges, rows = fixpoint_inputs([s[0] for s in scans], [s[1] for s in scans], batches,
                                        leader)
    if t_ok is None:
        t_ok = batches[0]["t_ok"][0].to(leader)
    committed = leader_fixpoint(cfg, t_ok, hist, edges, rows)
    news, outs = [], []
    for g, st, b, (_, e, w) in zip(groups, states, batches, scans):
        ns, o = apply_group(cfg, st, b, committed.to(g.device), e, w, gc_branch)
        news.append(ns)
        outs.append(o)
    out = {"status": outs[0]["status"],
           "overflow": torch.cat([o["overflow"].to(leader) for o in outs]).any(),
           "n": torch.cat([o["n"].to(leader) for o in outs])}
    if "merged" in outs[0]:
        out["merged"] = torch.cat([o["merged"].to(leader) for o in outs])
    if "heat" in outs[0]:
        out["heat"] = join([o["heat"] for o in outs], leader)
    return news, out


def step(cfg: KernelConfig, groups: Sequence[Group], states, batches, gc_branch: bool):
    """One batch over every group: each group's scan, then exchange()."""
    scans = [ck.detect_step_stacked(cfg, st, b) for st, b in zip(states, batches)]
    return exchange(cfg, groups, states, batches, scans, gc_branch)


def scan_step(cfg: KernelConfig, groups: Sequence[Group], states, batches, gc_last: bool):
    """C chunks (each group's batch leaves [n_g, C, ...]) as C rounds of
    (scan, leader fixpoint, apply), threading each group's tables. Returns
    (new states, out: "status" [C, T], "overflow" [C], "merged" [N, C]
    (tiered), "heat" [N, C, ...] (heat on)), on the leader."""
    C = batches[0]["t_ok"].shape[1]
    outs = []
    for c in range(C):
        states, out = step(cfg, groups, states,
                           [{k: v[:, c] for k, v in b.items()} for b in batches],
                           gc_last and c == C - 1)
        outs.append(out)
    res = {"status": torch.stack([o["status"] for o in outs]),
           "overflow": torch.stack([o["overflow"] for o in outs])}
    if "merged" in outs[0]:
        res["merged"] = torch.stack([o["merged"] for o in outs], dim=1)
    if "heat" in outs[0]:
        res["heat"] = {k: torch.stack([o["heat"][k] for o in outs], dim=1)
                       for k in outs[0]["heat"]}
    return states, res


# ---------------------------------------------------------------------------
# the engines' program: static buffers, captured on the card
# ---------------------------------------------------------------------------

class GroupDevice:
    """What one group captures and replays with: its device, its table
    (`state`, views of the engine's static buffers) and, on the card, its
    graph pool, capture stream, conditional-node body levels and the
    stream its work runs on (None for group 0, which runs on the leader's
    current stream)."""

    def __init__(self, group: Group, state: Dict[str, Tensor], pool=None, capture_stream=None,
                 body_levels=None, stream=None):
        self.group, self.device, self.state = group, group.device, state
        self.pool, self.capture_stream = pool, capture_stream
        self.body_levels, self.stream = body_levels, stream

    @classmethod
    def new(cls, group: Group, state: Dict[str, Tensor]) -> "GroupDevice":
        """A group with CUDA resources of its own on its device."""
        with torch.cuda.device(group.device):
            return cls(group, state, torch.cuda.graph_pool_handle(),
                       torch.cuda.Stream(group.device),
                       [(torch.cuda.Stream(group.device), torch.cuda.graph_pool_handle())
                        for _ in range(2)],
                       torch.cuda.Stream(group.device))


def _device(gd: GroupDevice):
    """Group `gd`'s device as the current one (nothing on the CPU)."""
    return torch.cuda.device(gd.device) if gd.device.type == "cuda" else _NULL


def _on(gd: GroupDevice):
    """The context group `gd`'s work is issued in: its device and stream
    (group 0: the leader's current stream)."""
    if gd.device.type != "cuda":
        return _NULL
    if gd.stream is None:
        return torch.cuda.device(gd.device)
    return torch.cuda.stream(gd.stream)


_NULL = contextlib.nullcontext()


def _capture(gd: GroupDevice, perf, warm, body, bodies: bool = False) -> "torch.cuda.CUDAGraph":
    """Capture body() on group `gd`'s device, capture stream and pool,
    after warm() ran eagerly there (what must not run under capture: the
    fixpoint's occupancy query, a kernel's first load)."""
    with torch.cuda.device(gd.device):
        stream = gd.capture_stream
        stream.wait_stream(torch.cuda.current_stream(gd.device))
        with torch.cuda.stream(stream):
            warm()
        torch.cuda.current_stream(gd.device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        levels = gd.body_levels[:1] if bodies else []
        with graph_if.bodies(levels), \
                torch.cuda.graph(graph, pool=gd.pool, stream=stream,
                                 capture_error_mode="relaxed"):
            body()
    count_capture(perf)
    return graph


class _Part:
    """One group's share of a (bucket, C) program: its static inputs [C,
    n_g, ...], the scan's output buffers, its copy of `committed`, its
    outputs (overflow [C], merged [n_g, C], heat [n_g, C, ...]; group 0
    also status [C, T]), one scan graph per chunk and one apply graph per
    chunk (the last chunk's with and without a GC horizon)."""

    def __init__(self, prog: "GroupedProgram", gi: int, gd: GroupDevice):
        bucket, C, dev = prog.bucket, prog.C, gd.device
        self.prog, self.gi, self.gd, self.g = prog, gi, gd, gd.group
        S = self.g.n
        self.inputs = {name: torch.zeros((C, S) + shape, dtype=dtype, device=dev)
                       for name, (shape, dtype) in input_shapes(bucket).items()}
        self.cold_dirty = [False] * C
        self.committed = torch.zeros((bucket.max_txns,), dtype=torch.bool, device=dev)
        self.status = (torch.zeros((C, bucket.max_txns), dtype=torch.int32, device=dev)
                       if gi == 0 else None)
        self.overflow = torch.zeros((C,), dtype=torch.bool, device=dev)
        self.merged = (torch.zeros((S, C), dtype=torch.bool, device=dev)
                       if ck.is_tiered(bucket) else None)
        self.heat = {k: torch.zeros(shape, dtype=dtype, device=dev)
                     for k, (shape, dtype) in ck.heat_shapes(bucket, (S, C)).items()}
        #: (hist, edges, wpos) static buffers, made by the first scan
        self.out = None
        self.scan_graphs: Dict[int, "torch.cuda.CUDAGraph"] = {}
        self.apply_graphs: Dict[Tuple[int, bool], "torch.cuda.CUDAGraph"] = {}

    def batch(self, c: int) -> Dict[str, Tensor]:
        """Chunk c's stacked batch over the static inputs, keys widened."""
        return {name: (v[c].to(torch.int64) & _KEY_MASK) if name in ck.KEY_FIELDS else v[c]
                for name, v in self.inputs.items()}

    def load(self, c: int, per, pack) -> None:
        """The group's shards of chunk c into its static inputs, on its
        stream: a slice of the pack set's [N, ...] tensors, or of the
        per-shard batch dicts."""
        if pack is not None:
            pack = types.SimpleNamespace(tensors={k: v[self.g.lo:self.g.hi]
                                                  for k, v in pack.tensors.items()})
        elif isinstance(per, (list, tuple)):
            per = list(per[self.g.lo:self.g.hi])
        load_chunk(self.inputs, self.cold_dirty, c, self.prog.bucket, self.g.n, per, pack)

    # -- bodies ----------------------------------------------------------------
    def _scan_body(self, c: int) -> None:
        hist, edges, wpos = ck.detect_step_stacked(self.prog.bucket, self.gd.state, self.batch(c))
        if self.out is None:
            self.out = (torch.empty_like(hist), {k: torch.empty_like(v) for k, v in edges.items()},
                        {k: torch.empty_like(v) for k, v in wpos.items()})
        self.out[0].copy_(hist)
        for k, v in edges.items():
            self.out[1][k].copy_(v)
        for k, v in wpos.items():
            self.out[2][k].copy_(v)

    def _apply_body(self, c: int, gc_branch: bool, state, batch=None, committed=None) -> None:
        _, edges, wpos = self.out
        new_state, out = apply_group(self.prog.bucket, state,
                                     self.batch(c) if batch is None else batch,
                                     self.committed if committed is None else committed,
                                     edges, wpos, gc_branch)
        for k, v in state.items():
            v.copy_(new_state[k])
        if self.status is not None:
            self.status[c].copy_(out["status"])
        self.overflow[c].copy_(out["overflow"].any())
        if self.merged is not None:
            self.merged[:, c].copy_(out["merged"])
        for k, v in self.heat.items():
            v[:, c].copy_(out["heat"][k])

    # -- capture -----------------------------------------------------------------
    def capture(self, perf) -> None:
        C, bucket = self.prog.C, self.prog.bucket
        for c in range(C):
            self.scan_graphs[c] = _capture(self.gd, perf, lambda c=c: self._scan_body(c),
                                           lambda c=c: self._scan_body(c))
            for gc_branch in ((False, True) if c == C - 1 else (False,)):
                self.apply_graphs[(c, gc_branch)] = self._capture_apply(perf, c, gc_branch)

    def _capture_apply(self, perf, c: int, gc_branch: bool):
        """The apply graph of chunk c. Its eager warm run goes on a scratch
        copy of the table; under the tiered structure it runs both sides of
        the merge branch (once as the table stands, once on a full run
        stack with a committed point write), since the IF node's body is
        captured whatever its predicate."""
        bucket = self.prog.bucket
        tiered = self.merged is not None

        def warm():
            scratch = {k: v.clone() for k, v in self.gd.state.items()}
            self._apply_body(c, gc_branch, scratch)
            if tiered:
                scratch["nruns"].fill_(bucket.run_slots)
                b = {k: v.clone() for k, v in self.batch(c).items()}
                b["wp_valid"][0, 0] = True
                b["wp_txn"][0, 0] = 0
                b["t_too_old"][:, 0] = False
                cm = torch.zeros_like(self.committed)
                cm[0] = True
                self._apply_body(c, gc_branch, scratch, batch=b, committed=cm)

        if_before = graph_if.GRAPH_IF.nodes
        graph = _capture(self.gd, perf, warm, lambda: self._apply_body(c, gc_branch, self.gd.state),
                         bodies=True)
        if_nodes = graph_if.GRAPH_IF.nodes - if_before
        if if_nodes != (1 if tiered else 0):
            raise RuntimeError(f"captured {if_nodes} merge IF nodes in a group's apply")
        return graph

    # -- run ---------------------------------------------------------------------
    def scan(self, c: int) -> None:
        if self.scan_graphs:
            self.scan_graphs[c].replay()
        else:
            self._scan_body(c)

    def apply(self, c: int, gc_branch: bool) -> None:
        if self.apply_graphs:
            self.apply_graphs[(c, gc_branch)].replay()
        else:
            self._apply_body(c, gc_branch, self.gd.state)


class GroupedProgram:
    """One (bucket, C) program of an engine whose shards sit in several
    groups: C rounds of (every group's scan, the leader's gather and
    stacked fixpoint, every group's apply), then every group's outputs
    gathered onto the leader: `status` [C, T], `overflow` [C] (any shard's),
    `merged` [N, C] (tiered) and `heat` leaves [N, C, ...], the layouts the
    one-group _Program writes (heat "sc"), so the engines' dispatch reads
    either alike. On the card each group's parts are captured graphs on its
    device (`_Part`), the fixpoint is one captured launch of the stacked
    entry on the leader, and the copies and event waits between them are
    issued between replays (`run`); on the CPU the same order runs
    eagerly."""

    def __init__(self, engine, bucket: KernelConfig, C: int):
        self.engine, self.bucket, self.C = engine, bucket, C
        self.parts = [_Part(self, gi, gd) for gi, gd in enumerate(engine.group_devices)]
        self.N = sum(p.g.n for p in self.parts)
        lead = self.parts[0]
        dev = self.leader = lead.gd.device
        T = bucket.max_txns
        self.cuda = dev.type == "cuda"
        # group 0 applies with the leader's committed buffer itself
        self.committed = lead.committed
        self.t_ok = torch.zeros((T,), dtype=torch.bool, device=dev)
        self.status = lead.status
        self.overflow = torch.zeros((C,), dtype=torch.bool, device=dev)
        self.overflow_parts = torch.zeros((len(self.parts), C), dtype=torch.bool, device=dev)
        self.merged = (torch.zeros((self.N, C), dtype=torch.bool, device=dev)
                       if ck.is_tiered(bucket) else None)
        self.heat = {k: torch.zeros(shape, dtype=dtype, device=dev)
                     for k, (shape, dtype) in ck.heat_shapes(bucket, (self.N, C)).items()}
        # the gather's stack: made from one eager scan's shapes
        for p in self.parts:
            with _device(p.gd):
                p._scan_body(0)
        self.rows = {k: torch.zeros((self.N,) + tuple(lead.inputs[k].shape[2:]),
                                    dtype=lead.inputs[k].dtype, device=dev) for k in ROW_FIELDS}
        self.hist = torch.zeros((self.N,) + tuple(lead.out[0].shape[1:]), dtype=torch.int32,
                                device=dev)
        self.edges = {k: torch.zeros((self.N,) + tuple(lead.out[1][k].shape[1:]),
                                     dtype=lead.out[1][k].dtype, device=dev)
                      for k in EDGE_FIELDS}
        #: the leader's last (scan-done, fixpoint-done) events of a run on
        #: the card: the mesh engine's measured-exchange probes
        self.probes: Tuple = (None, None)
        self.fix_graph = None
        if self.cuda:
            self._capture()

    # -- capture ---------------------------------------------------------------
    def _fix_body(self) -> None:
        self.committed.copy_(leader_fixpoint(self.bucket, self.t_ok, self.hist, self.edges,
                                             self.rows))

    def _capture(self) -> None:
        perf = self.engine.perf
        for p in self.parts:
            p.capture(perf)
        counter = fixpoint_cuda.FIXPOINT_STACKED
        before = counter.launches
        self.fix_graph = _capture(self.parts[0].gd, perf, self._fix_body, self._fix_body)
        # the warm run launched once, the capture once
        if counter.launches - before != 2:
            raise RuntimeError(f"the leader's fixpoint warm run and capture made "
                               f"{counter.launches - before} stacked fixpoint launches, not 2")

    def gather_nbytes(self) -> int:
        """Bytes step (b) copies to the leader per chunk: every shard's
        history hits, EDGE_FIELDS and ROW_FIELDS, and t_ok."""
        return (self.t_ok.nbytes + self.hist.nbytes + sum(v.nbytes for v in self.edges.values())
                + sum(v.nbytes for v in self.rows.values()))

    # -- dispatch ----------------------------------------------------------------
    def load(self, c: int, per, pack) -> None:
        """Chunk c into every group's static inputs, each on its stream.
        Before chunk 0 each group's stream waits on its device's current
        stream (where the engine's own writes to the tables run)."""
        for p in self.parts:
            if c == 0 and p.gd.stream is not None:
                p.gd.stream.wait_stream(torch.cuda.current_stream(p.gd.device))
            with _on(p.gd):
                p.load(c, per, pack)

    def _gather(self, c: int, p: _Part) -> None:
        g = p.g
        self.hist[g.lo:g.hi].copy_(p.out[0], non_blocking=True)
        for k in EDGE_FIELDS:
            self.edges[k][g.lo:g.hi].copy_(p.out[1][k], non_blocking=True)
        for k in ROW_FIELDS:
            self.rows[k][g.lo:g.hi].copy_(p.inputs[k][c], non_blocking=True)
        if p.gi == 0:
            self.t_ok.copy_(p.inputs["t_ok"][c][0], non_blocking=True)

    def _collect(self, p: _Part) -> None:
        g = p.g
        self.overflow_parts[p.gi].copy_(p.overflow, non_blocking=True)
        if self.merged is not None:
            self.merged[g.lo:g.hi].copy_(p.merged, non_blocking=True)
        for k, v in self.heat.items():
            v[g.lo:g.hi].copy_(p.heat[k], non_blocking=True)

    def _to_leader(self, p: _Part, ls):
        """The context of a copy from group p to the leader: the copy runs
        behind the leader's wait on p's event (`ls`: the leader's stream)."""
        stack = contextlib.ExitStack()
        if self.cuda and p.gd.stream is not None:
            stack.enter_context(torch.cuda.stream(p.gd.stream))
            stack.enter_context(torch.cuda.stream(ls))
        return stack

    def run(self, gc_last: bool) -> None:
        """The program over the loaded inputs (see the class docstring).
        On the card: each group's work on its stream, each crossing a
        stream-on-event wait; the leader's stream ends behind every group's
        last event, and each group's device's current stream behind the
        group's, so work issued later on either is ordered after the unit."""
        parts, C, cuda = self.parts, self.C, self.cuda
        ls = torch.cuda.current_stream(self.leader) if cuda else None
        scan_ev = fix_ev = None
        for c in range(C):
            for p in parts:
                with _on(p.gd):
                    p.scan(c)
            if cuda:
                for p in parts[1:]:
                    ev = torch.cuda.Event()
                    ev.record(p.gd.stream)
                    ls.wait_event(ev)
                scan_ev = torch.cuda.Event()
                scan_ev.record(ls)
            for p in parts:
                with self._to_leader(p, ls):
                    self._gather(c, p)
            if self.fix_graph is not None:
                self.fix_graph.replay()
                fixpoint_cuda.FIXPOINT_STACKED.graph_launches += 1
            else:
                self._fix_body()
            if cuda:
                fix_ev = torch.cuda.Event()
                fix_ev.record(ls)
            gc_branch = gc_last and c == C - 1
            for p in parts[1:]:
                with _on(p.gd):
                    if cuda:
                        p.gd.stream.wait_event(fix_ev)
                    p.committed.copy_(self.committed, non_blocking=True)
                    p.apply(c, gc_branch)
            with _on(parts[0].gd):
                parts[0].apply(c, gc_branch)
        if cuda:
            for p in parts[1:]:
                ev = torch.cuda.Event()
                ev.record(p.gd.stream)
                ls.wait_event(ev)
        for p in parts:
            with self._to_leader(p, ls):
                self._collect(p)
        with _on(parts[0].gd):
            self.overflow.copy_(self.overflow_parts.any(0))
        if cuda:
            for p in parts[1:]:
                torch.cuda.current_stream(p.gd.device).wait_stream(p.gd.stream)
        self.probes = (scan_ev, fix_ev)
