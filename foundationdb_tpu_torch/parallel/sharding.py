"""Multi-shard conflict detection over an explicit device list.

Port of ``foundationdb_tpu/parallel/sharding.py``. The keyspace is split
by split keys into N spans, one table per span (the analog of the proxy's
`keyResolvers` range map); the host routes and clips every read and write
conflict range to the shards it meets (the router every engine shares,
ops/host_engine.py); each shard runs phases 1-2 on its own table; only
[T] txn-space vectors combine across shards: the history hits, then each
fixpoint round's blocked counts (counts add up across disjoint key
shards, so every shard would run the same rounds); each shard applies its
own clipped committed writes.

The JAX package maps the N shards onto N devices of one process under
shard_map and combines with psum. The port keeps the single controller:
one engine object serves resolve(), and its shards are entries of an
explicit `devices` list, which may repeat. `placement` cuts the list into
ordered GROUPS, each a contiguous run of shards on one device (by default
the runs of consecutive entries that name one device; `groups=` may also
put several groups on one device). Within a group the tables are stacked
on the leading axis of one state, and where every shard is in one group
(the CPU, or one card) the psum is the stacked fixpoint's sum over that
axis: on the card, one launch of the CUDA kernel's stacked entry
(ops/fixpoint_cuda.py) per step. Across groups only the fixpoint's inputs
and its [T] result move: the leader, group 0's device, gathers every
group's inputs and launches the stacked entry once over all N shards
(exchange.py).

The make_* functions are the step programs the engines capture; their
arrays carry the shard axis first, as the JAX shard_map programs' do, and
a value JAX replicates across shards (statuses, committed masks) is an
expanded view of one tensor. Over several groups (`groups=`, or a devices
list that names several devices) the state, batch and scan arguments are
lists with one [n_g, ...] tree per group, and the outputs that combine
shards lie on the leader.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.keyshard import KeyShardMap
from ..core.types import Version
from ..ops import conflict_kernel as ck
from ..ops.conflict_kernel import KernelConfig
from ..ops import host_engine
from ..ops.host_engine import _CardEngine
from . import exchange as xch
from .exchange import Group, GroupDevice, GroupedProgram

__all__ = ["Group", "KeyShardMap", "ShardedConflictEngine", "make_sharded_step",
           "make_sharded_scan_step", "make_mesh_scan_step", "make_mesh_exchange_step",
           "make_sharded_split_steps", "placement"]


def _norm(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def placement(devices: Sequence, groups: Optional[Sequence[int]] = None) -> List[Group]:
    """The ordered groups of an engine's shards: each a device and the
    contiguous run of shard indices [lo, hi) whose tables it stacks.
    `groups` gives each shard's group index (0, 1, ... in shard order,
    each group's shards contiguous and on one device; several groups may
    share a device); by default consecutive shards that name one device
    form one group, so shards that all name one device are one group.
    Raises ValueError on an empty list and on groups that break those
    rules."""
    devs = [_norm(d) for d in devices]
    if not devs:
        raise ValueError("a sharded engine needs at least one device")
    if groups is None:
        ids = [0]
        for a, b in zip(devs, devs[1:]):
            ids.append(ids[-1] + (a != b))
    else:
        ids = [int(g) for g in groups]
        if len(ids) != len(devs):
            raise ValueError(f"{len(devs)} shards need {len(devs)} group indices, got {len(ids)}")
        if ids[0] != 0 or any(b not in (a, a + 1) for a, b in zip(ids, ids[1:])):
            raise ValueError(f"groups {ids} are not contiguous runs numbered 0, 1, ... in "
                             "shard order")
    out: List[Group] = []
    for s, (d, g) in enumerate(zip(devs, ids)):
        if g == len(out):
            out.append(Group(d, s, s + 1))
        elif d != out[g].device:
            raise ValueError(f"group {g} names two devices, {out[g].device} and {d}")
        else:
            out[g] = Group(d, out[g].lo, s + 1)
    return out


def _replicate(x: torch.Tensor, S: int) -> torch.Tensor:
    return x.expand((S,) + tuple(x.shape))


def _replicated(out: Dict, S: int) -> Dict:
    """A grouped output with its status and overflow replicated over the
    S shards, as the one-group programs give them."""
    out["status"] = _replicate(out["status"], S)
    out["overflow"] = _replicate(out["overflow"], S)
    return out


def make_sharded_step(cfg: KernelConfig, devices: Sequence,
                      groups: Optional[Sequence[int]] = None):
    """The fused step over N shards in one group: step(state, batch,
    gc_branch) with state and batch leaves [N, ...] (t_ok / t_too_old /
    now / gc replicated) -> (state', out). out["status"] [N, T] and
    out["overflow"] [N] are replicated rows (verdicts are a pure function
    of the summed planes); out["heat"] leaves [N, ...] stay per shard.
    Over several groups, state and batch are per-group lists (state' too)
    and out lies on the leader (exchange.step)."""
    gs = placement(devices, groups)
    if len(gs) > 1:
        def grouped(states, batches, gc_branch: bool):
            news, out = xch.step(cfg, gs, states, batches, gc_branch)
            return news, _replicated(out, gs[-1].hi)

        return grouped

    def step(state, batch, gc_branch: bool):
        S = batch["t_ok"].shape[0]
        new_state, out = ck.resolve_step_stacked(cfg, state, batch, gc_branch)
        out["status"] = _replicate(out["status"], S)
        out["overflow"] = _replicate(out["overflow"], S)
        return new_state, out

    return step


def make_sharded_scan_step(cfg: KernelConfig, devices: Sequence, n_chunks: int,
                           groups: Optional[Sequence[int]] = None):
    """make_sharded_step over C = n_chunks chunks as one program, threading
    each shard's table through the chunks: batch leaves [N, C, ...] (shard
    axis outermost, as JAX's P("shard") specs have it); out["status"]
    [N, C, T], out["overflow"] [N, C], out["merged"] [N, C] (tiered) and
    heat leaves [N, C, ...]. Over several groups, per-group lists as
    make_sharded_step's: C rounds of (scan, leader fixpoint, apply)."""
    gs = placement(devices, groups)
    if len(gs) > 1:
        def grouped(states, batches, gc_last: bool):
            if batches[0]["t_ok"].shape[1] != n_chunks:
                raise ValueError(f"a {n_chunks}-chunk scan got "
                                 f"{batches[0]['t_ok'].shape[1]} chunks")
            news, out = xch.scan_step(cfg, gs, states, batches, gc_last)
            return news, _replicated(out, gs[-1].hi)

        return grouped

    def step(state, batches, gc_last: bool):
        S = batches["t_ok"].shape[0]
        if batches["t_ok"].shape[1] != n_chunks:
            raise ValueError(f"a {n_chunks}-chunk scan got {batches['t_ok'].shape[1]} chunks")
        state, out = ck.resolve_step_stacked_scan(
            cfg, state, {k: v.transpose(0, 1) for k, v in batches.items()}, gc_last)
        res = {"status": _replicate(out["status"], S),
               "overflow": _replicate(out["overflow"], S)}
        if "merged" in out:
            res["merged"] = out["merged"].transpose(0, 1)
        if "heat" in out:
            res["heat"] = {k: v.transpose(0, 1) for k, v in out["heat"].items()}
        return state, res

    return step


def make_mesh_scan_step(cfg: KernelConfig, devices: Sequence,
                        groups: Optional[Sequence[int]] = None):
    """Phase-1 half of the mesh engine's split dispatch unit: the
    shard-local scans only (history probes, overlap edges, write
    positions), nothing that combines shards. scan(state, batch) ->
    (hist [N, T], edges, wpos), leaves [N, ...]. Over several groups,
    scan(states, batches) -> per-group lists (hists, edges, wposes), each
    on its group's device."""
    if len(placement(devices, groups)) > 1:
        def grouped(states, batches):
            scans = [ck.detect_step_stacked(cfg, st, b) for st, b in zip(states, batches)]
            return tuple(list(x) for x in zip(*scans))

        return grouped

    def scan(state, batch):
        return ck.detect_step_stacked(cfg, state, batch)

    return scan


def make_mesh_exchange_step(cfg: KernelConfig, devices: Sequence,
                            groups: Optional[Sequence[int]] = None):
    """Exchange + commit half of the split unit: everything that combines
    shards (the sum of the history-hit planes, each fixpoint round's sum of
    blocked counts: the stacked fixpoint), then the shard-local apply of
    the committed writes. exchange(state, batch, hist, edges, wpos,
    gc_branch) -> (state', out) with make_sharded_step's output layout.
    Over several groups the arguments are make_mesh_scan_step's per-group
    lists: the leader gathers them and launches the stacked entry once."""
    gs = placement(devices, groups)
    if len(gs) > 1:
        def grouped(states, batches, hists, edges, wposes, gc_branch: bool):
            news, out = xch.exchange(cfg, gs, states, batches,
                                          list(zip(hists, edges, wposes)), gc_branch)
            return news, _replicated(out, gs[-1].hi)

        return grouped

    def exchange(state, batch, hist, edges, wpos, gc_branch: bool):
        S = batch["t_ok"].shape[0]
        new_state, out = ck.exchange_step_stacked(cfg, state, batch, hist, edges, wpos,
                                                  gc_branch)
        out["status"] = _replicate(out["status"], S)
        out["overflow"] = _replicate(out["overflow"], S)
        return new_state, out

    return exchange


def make_sharded_split_steps(cfg: KernelConfig, devices: Sequence,
                             groups: Optional[Sequence[int]] = None):
    """Detect / fix / apply as separate programs, for the host long-key
    tier, whose outer fixpoint needs global verdicts before any tier
    applies writes. fix(t_ok [N, T] replicated, hist, edges, batch) ->
    committed [N, T] replicated; apply(state, batch, committed [N, T],
    wpos, gc_branch) -> (state', overflow [N] replicated). Over several
    groups, state, batch, hist, edges and wpos are per-group lists and
    t_ok, committed and overflow lie on the leader."""
    gs = placement(devices, groups)
    if len(gs) > 1:
        return _grouped_split_steps(cfg, gs)

    def detect(state, batch):
        return ck.detect_step_stacked(cfg, state, batch)

    def fix(t_ok, hist, edges, batch):
        return _replicate(ck.fix_step_stacked(cfg, t_ok[0], hist, edges, batch),
                          t_ok.shape[0])

    def apply(state, batch, committed, wpos, gc_branch: bool):
        new_state, overflow = ck.apply_step_stacked(cfg, state, batch, committed[0], wpos,
                                                    gc_branch)
        return new_state, _replicate(overflow, committed.shape[0])

    return detect, fix, apply


def _grouped_split_steps(cfg: KernelConfig, gs: List[Group]):
    N, leader = gs[-1].hi, gs[0].device

    def detect(states, batches):
        scans = [ck.detect_step_stacked(cfg, st, b) for st, b in zip(states, batches)]
        return tuple(list(x) for x in zip(*scans))

    def fix(t_ok, hists, edges, batches):
        hist, e, rows = xch.fixpoint_inputs(hists, edges, batches, leader)
        return _replicate(xch.leader_fixpoint(cfg, t_ok[0], hist, e, rows), N)

    def apply(states, batches, committed, wposes, gc_branch: bool):
        news, overflow = [], []
        for g, st, b, w in zip(gs, states, batches, wposes):
            ns, ov, _, _ = ck._apply_stacked(cfg, st, b, committed[0].to(g.device), w, gc_branch)
            news.append(ns)
            overflow.append(ov.to(leader))
        return news, _replicate(torch.cat(overflow).any(), N)

    return detect, fix, apply


def visible_device_count(device: torch.device) -> int:
    """Devices of the device's kind this process sees: the CUDA device
    count, 1 for the CPU (the progcache key's device-count half)."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def resolve_devices(n: int, device=None, devices: Optional[Sequence] = None) -> List[torch.device]:
    """The device list of an N-shard engine: `devices` as given (each
    entry a device; N must match), else N entries of `device`. With
    neither, the cards: on a host with k >= 2 cards N <= k shards go one to
    a card, on cards 0..N-1 (JAX's devs[:n]), and N > k shards in
    contiguous blocks, shard s on card s*k//N; with one card every shard
    on it (none raises)."""
    if devices is None:
        k = torch.cuda.device_count() if device is None and torch.cuda.is_available() else 0
        if k >= 2:
            devices = [torch.device("cuda", s if n <= k else s * k // n) for s in range(n)]
        else:
            devices = [host_engine._default_device(device)] * n
    devices = [torch.device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"{n} shards need {n} devices, got {len(devices)}")
    return devices


class ShardedConflictEngine(_CardEngine):
    """Multi-shard ConflictSet engine: same resolve() contract as
    OracleConflictEngine and TorchConflictEngine, its N shards placed in
    groups (`placement`; `groups=` as there). With one group (every shard
    on one device) the N tables stack on that device: each (bucket, C)
    program is make_sharded_scan_step's (make_sharded_step's for C = 1,
    the scan's one-chunk case), captured as CUDA graphs on the card, and
    the long-key split path runs the stacked detect / fix / apply steps.
    With several groups each group's tables stack on its device, `state`
    holds every group's static buffers under "<field>@<group>", each
    (bucket, C) program is an exchange.GroupedProgram and the split path
    runs make_sharded_split_steps' grouped steps. Heat merges under layout
    "sc"."""

    name = "sharded"
    heat_layout = "sc"

    def __init__(self, cfg: KernelConfig = KernelConfig(), shards: Optional[KeyShardMap] = None,
                 devices: Optional[Sequence] = None, initial_version: Version = 0,
                 ladder=None, scan_sizes=(2, 4, 8), arena: bool = True,
                 history_search=None, heat_buckets=None, device_time_sample_rate=None,
                 history_structure=None, device=None, groups: Optional[Sequence[int]] = None):
        n = (shards.n_shards if shards is not None
             else len(devices) if devices is not None else 1)
        self.devices = resolve_devices(n, device, devices)
        self.groups = placement(self.devices, groups)
        self.stack = n
        grouped = len(self.groups) > 1
        super().__init__(cfg, shards or KeyShardMap.uniform(n),
                         initial_version=initial_version,
                         device=self.groups[0].device if grouped else self.devices[0],
                         ladder=ladder, scan_sizes=scan_sizes, arena=arena,
                         history_search=history_search, heat_buckets=heat_buckets,
                         device_time_sample_rate=device_time_sample_rate,
                         history_structure=history_structure)
        self._scan_steps: Dict[Tuple[KernelConfig, int], object] = {}
        #: per group: its device, table views and (on the card) capture
        #: resources; group 0 captures with the engine's own
        self.group_devices: List[GroupDevice] = []
        if grouped:
            for gi, g in enumerate(self.groups):
                st = self.group_state(gi)
                if self.device.type != "cuda":
                    gd = GroupDevice(g, st)
                elif gi == 0:
                    gd = GroupDevice(g, st, self.graph_pool, self.capture_stream,
                                     self.body_levels)
                else:
                    gd = GroupDevice.new(g, st)
                self.group_devices.append(gd)
            self._split_steps = make_sharded_split_steps(self.cfg, self.devices,
                                                         [self._group_of(s) for s in range(n)])

    # -- groups -----------------------------------------------------------------
    @property
    def grouped(self) -> bool:
        """Whether the shards sit in more than one group."""
        return len(self.groups) > 1

    def _group_of(self, s: int) -> int:
        return next(gi for gi, g in enumerate(self.groups) if g.lo <= s < g.hi)

    def group_state(self, gi: int) -> Dict[str, torch.Tensor]:
        """Group gi's stacked table: views of the engine's static buffers."""
        if not self.grouped:
            return self.state
        tag = f"@{gi}"
        return {k[:-len(tag)]: v for k, v in self.state.items() if k.endswith(tag)}

    def _initial_state(self, version_rel: int) -> Dict[str, torch.Tensor]:
        if not self.grouped:
            return super()._initial_state(version_rel)
        out = {}
        for gi, g in enumerate(self.groups):
            st = ck._stack([ck.initial_state(self.cfg, version_rel=version_rel,
                                             first_key=self.shards.begins[s], device=g.device)
                            for s in range(g.lo, g.hi)])
            out.update({f"{k}@{gi}": v for k, v in st.items()})
        return out

    def _device_states_for_snapshot(self):
        if not self.grouped:
            return super()._device_states_for_snapshot()
        return [ck._shard(self.group_state(gi), s - g.lo)
                for gi, g in enumerate(self.groups) for s in range(g.lo, g.hi)]

    def _progcache_fingerprint(self) -> str:
        # the programs bake the shard layout: never share entries across
        # shard counts, visible-device sets or group layouts
        fp = f"mesh:{self.n_shards}/{visible_device_count(self.device)}"
        if self.grouped:
            fp += ":" + ",".join(f"{g.device}[{g.lo}:{g.hi}]" for g in self.groups)
        return fp

    def _make_program(self, bucket: KernelConfig, n_chunks: int):
        if self.grouped:
            return GroupedProgram(self, bucket, n_chunks)
        return super()._make_program(bucket, n_chunks)

    def _on_leader(self):
        """The leader as the current device while a grouped unit is issued
        on the card: the unit's events and copies out go on its stream."""
        if self.grouped and self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _dispatch_unit(self, bucket: KernelConfig, per_chunks, packs=None, sample=None):
        with self._on_leader():
            return super()._dispatch_unit(bucket, per_chunks, packs, sample=sample)

    # -- the split-step path (host long-key tier), over several groups -----------
    def _group_batches(self, per_shard) -> List[Dict]:
        return [ck._stack([ck.batch_from_numpy(self.cfg, a, g.device)
                           for a in per_shard[g.lo:g.hi]]) for g in self.groups]

    def _run_detect(self, per_shard):
        if not self.grouped:
            return super()._run_detect(per_shard)
        batches = self._group_batches(per_shard)
        states = [self.group_state(gi) for gi in range(len(self.groups))]
        hists, edges, wposes = self._split_steps[0](states, batches)
        return {"batch": batches, "hist": hists, "edges": edges, "wpos": wposes}

    # fdbtpu-lint: drain-point — the split-step path: the host tier's next
    # fixpoint round needs this round's verdicts (_CardEngine._run_fix)
    def _run_fix(self, ctx, per_shard, t_ok: np.ndarray) -> np.ndarray:
        if not self.grouped:
            return super()._run_fix(ctx, per_shard, t_ok)
        t = torch.from_numpy(np.ascontiguousarray(t_ok)).to(self.device)
        committed_dev = self._split_steps[1](t.expand(self.n_shards, -1), ctx["hist"],
                                             ctx["edges"], ctx["batch"])
        return committed_dev[0].cpu().numpy()

    # fdbtpu-lint: drain-point — the split-step path returns its verdicts
    # and overflow to the caller at once (see _run_fix)
    def _run_apply(self, ctx, per_shard, committed: np.ndarray) -> Tuple[np.ndarray, bool]:
        if not self.grouped:
            return super()._run_apply(ctx, per_shard, committed)
        cm = torch.from_numpy(np.ascontiguousarray(committed)).to(self.device)
        gc_branch = int(per_shard[0]["gc"]) > 0
        batches = ctx["batch"]
        merged = 0
        overflow_dev = []
        for gi, (g, b, w) in enumerate(zip(self.groups, batches, ctx["wpos"])):
            st = self.group_state(gi)
            new_state, ov, _, merged_dev = ck._apply_stacked(self.cfg, st, b, cm.to(g.device), w,
                                                             gc_branch)
            for k, v in st.items():
                v.copy_(new_state[k])
            if merged_dev is not None:
                merged += int(merged_dev.sum())
            overflow_dev.append(ov.to(self.device))
        self.perf.merges += merged
        status_dev = ck.status_of(batches[0]["t_too_old"][0], cm)
        return status_dev.cpu().numpy(), bool(torch.cat(overflow_dev).any())

    def _heat_axes(self, C: int) -> Tuple[int, ...]:
        return (self.stack, C)

    def _scan(self, bucket: KernelConfig, state, batches, gc_last: bool):
        """The program body over [C, S, ...] static inputs: the sharded scan
        step on their [S, C, ...] view; statuses back to [C, T]."""
        key = (bucket, batches["t_ok"].shape[0])
        step = self._scan_steps.get(key)
        if step is None:
            step = self._scan_steps[key] = make_sharded_scan_step(bucket, self.devices, key[1])
        state, out = step(state, {k: v.transpose(0, 1) for k, v in batches.items()}, gc_last)
        res = {"status": out["status"][0], "overflow": out["overflow"][0]}
        if "merged" in out:
            res["merged"] = out["merged"].transpose(0, 1)
        if "heat" in out:
            res["heat"] = out["heat"]
        return state, res
