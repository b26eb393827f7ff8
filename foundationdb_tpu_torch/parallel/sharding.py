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
explicit `devices` list, which may repeat. Where every entry names the
same device (the CPU, or the one card of the card machine), the N tables
are stacked on the leading axis of one state on that device and the psum
is the stacked fixpoint's sum over the leading axis: on the card, one
launch of the CUDA kernel's stacked entry (ops/fixpoint_cuda.py) per
step. Shards on distinct CUDA devices raise DistinctDevicesError
(`mesh_device`): that path waits for a machine with more cards, and a
multi-process backend would break the engine's single-object contract.

The make_* functions are the step programs the engines capture; their
arrays carry the shard axis first, as the JAX shard_map programs' do, and
a value JAX replicates across shards (statuses, committed masks) is an
expanded view of one tensor.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core.keyshard import KeyShardMap
from ..core.types import Version
from ..ops import conflict_kernel as ck
from ..ops.conflict_kernel import KernelConfig
from ..ops import host_engine
from ..ops.host_engine import _CardEngine

__all__ = ["DistinctDevicesError", "KeyShardMap", "ShardedConflictEngine", "make_sharded_step",
           "make_sharded_scan_step", "make_mesh_scan_step", "make_mesh_exchange_step",
           "make_sharded_split_steps", "mesh_device"]


class DistinctDevicesError(ValueError):
    """Shards placed on distinct devices: the port runs every shard of an
    engine on one device (see the module docstring)."""


def _norm(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def mesh_device(devices: Sequence) -> torch.device:
    """The one device an engine's shards share. Raises ValueError on an
    empty list and DistinctDevicesError when the entries name more than
    one device."""
    devs = [_norm(d) for d in devices]
    if not devs:
        raise ValueError("a sharded engine needs at least one device")
    if len(set(devs)) > 1:
        raise DistinctDevicesError(
            f"shards on distinct devices {sorted({str(d) for d in devs})}: the port runs "
            "every shard of an engine on one device (repeat it in the devices list)")
    return devs[0]


def _replicate(x: torch.Tensor, S: int) -> torch.Tensor:
    return x.expand((S,) + tuple(x.shape))


def make_sharded_step(cfg: KernelConfig, devices: Sequence):
    """The fused step over N shards on one device: step(state, batch,
    gc_branch) with state and batch leaves [N, ...] (t_ok / t_too_old /
    now / gc replicated) -> (state', out). out["status"] [N, T] and
    out["overflow"] [N] are replicated rows (verdicts are a pure function
    of the summed planes); out["heat"] leaves [N, ...] stay per shard."""
    mesh_device(devices)

    def step(state, batch, gc_branch: bool):
        S = batch["t_ok"].shape[0]
        new_state, out = ck.resolve_step_stacked(cfg, state, batch, gc_branch)
        out["status"] = _replicate(out["status"], S)
        out["overflow"] = _replicate(out["overflow"], S)
        return new_state, out

    return step


def make_sharded_scan_step(cfg: KernelConfig, devices: Sequence, n_chunks: int):
    """make_sharded_step over C = n_chunks chunks as one program, threading
    each shard's table through the chunks: batch leaves [N, C, ...] (shard
    axis outermost, as JAX's P("shard") specs have it); out["status"]
    [N, C, T], out["overflow"] [N, C], out["merged"] [N, C] (tiered) and
    heat leaves [N, C, ...]."""
    mesh_device(devices)

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


def make_mesh_scan_step(cfg: KernelConfig, devices: Sequence):
    """Phase-1 half of the mesh engine's split dispatch unit: the
    shard-local scans only (history probes, overlap edges, write
    positions), nothing that combines shards. scan(state, batch) ->
    (hist [N, T], edges, wpos), leaves [N, ...]."""
    mesh_device(devices)

    def scan(state, batch):
        return ck.detect_step_stacked(cfg, state, batch)

    return scan


def make_mesh_exchange_step(cfg: KernelConfig, devices: Sequence):
    """Exchange + commit half of the split unit: everything that combines
    shards (the sum of the history-hit planes, each fixpoint round's sum of
    blocked counts: the stacked fixpoint), then the shard-local apply of
    the committed writes. exchange(state, batch, hist, edges, wpos,
    gc_branch) -> (state', out) with make_sharded_step's output layout."""
    mesh_device(devices)

    def exchange(state, batch, hist, edges, wpos, gc_branch: bool):
        S = batch["t_ok"].shape[0]
        new_state, out = ck.exchange_step_stacked(cfg, state, batch, hist, edges, wpos,
                                                  gc_branch)
        out["status"] = _replicate(out["status"], S)
        out["overflow"] = _replicate(out["overflow"], S)
        return new_state, out

    return exchange


def make_sharded_split_steps(cfg: KernelConfig, devices: Sequence):
    """Detect / fix / apply as separate programs, for the host long-key
    tier, whose outer fixpoint needs global verdicts before any tier
    applies writes. fix(t_ok [N, T] replicated, hist, edges, batch) ->
    committed [N, T] replicated; apply(state, batch, committed [N, T],
    wpos, gc_branch) -> (state', overflow [N] replicated)."""
    mesh_device(devices)

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


def visible_device_count(device: torch.device) -> int:
    """Devices of the device's kind this process sees: the CUDA device
    count, 1 for the CPU (the progcache key's device-count half)."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def resolve_devices(n: int, device=None, devices: Optional[Sequence] = None) -> List[torch.device]:
    """The device list of an N-shard engine: `devices` as given (each
    entry a device; N must match), else N entries of `device` (None: the
    card, raising where there is none)."""
    if devices is None:
        devices = [host_engine._default_device(device)] * n
    devices = [torch.device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"{n} shards need {n} devices, got {len(devices)}")
    mesh_device(devices)
    return devices


class ShardedConflictEngine(_CardEngine):
    """Multi-shard ConflictSet engine: same resolve() contract as
    OracleConflictEngine and TorchConflictEngine, its N shards' tables
    stacked on one device (see the module docstring). Each (bucket, C)
    program is make_sharded_scan_step's (make_sharded_step's for C = 1,
    the scan's one-chunk case), captured as CUDA graphs on the card; heat
    merges under layout "sc". The long-key split path runs the stacked
    detect / fix / apply steps."""

    name = "sharded"
    heat_layout = "sc"

    def __init__(self, cfg: KernelConfig = KernelConfig(), shards: Optional[KeyShardMap] = None,
                 devices: Optional[Sequence] = None, initial_version: Version = 0,
                 ladder=None, scan_sizes=(2, 4, 8), arena: bool = True,
                 history_search=None, heat_buckets=None, device_time_sample_rate=None,
                 history_structure=None, device=None):
        n = (shards.n_shards if shards is not None
             else len(devices) if devices is not None else 1)
        self.devices = resolve_devices(n, device, devices)
        self.stack = n
        super().__init__(cfg, shards or KeyShardMap.uniform(n),
                         initial_version=initial_version, device=self.devices[0],
                         ladder=ladder, scan_sizes=scan_sizes, arena=arena,
                         history_search=history_search, heat_buckets=heat_buckets,
                         device_time_sample_rate=device_time_sample_rate,
                         history_structure=history_structure)
        self._scan_steps: Dict[Tuple[KernelConfig, int], object] = {}

    def _progcache_fingerprint(self) -> str:
        # the programs bake the shard layout: never share entries across
        # shard counts or visible-device sets
        return f"mesh:{self.n_shards}/{visible_device_count(self.device)}"

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
