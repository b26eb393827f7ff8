"""History-search floor micro-driver (docs/perf.md "History search modes").

Port of ``foundationdb_tpu/tools/floor_bench.py``.

Sweeps device ms/batch vs boundary-table occupancy `n` at a FIXED batch
shape, for both history-query strategies of `ops/conflict_kernel.py`:
`fused_sort` re-sorts the capacity-H table together with the batch every
step, so its per-batch device time may carry a floor set by H regardless
of batch size; `bsearch` sorts only the batch rows and binary-searches
the already-sorted table, so its time tracks the batch. bench.py's
`history_floor` section runs it at the production capacity; the bench
smoke (tools/bench_smoke.py) runs the same code at toy sizes on the CPU
with a zero-recapture assertion for both modes after warmup.

Methodology: the boundary table is synthesized directly at each target
occupancy (sorted distinct packed keys at version 0) and the driven
batches carry valid point READS only — the step's shapes are fixed, so
row validity does not change device cost, and a write-free gc=0 batch
leaves the table untouched: every timed step runs at exactly the target
`n`. Where JAX timed one compiled lax.scan of `scan_steps` steps, the
port captures the same `scan_steps` steps into ONE CUDA graph over static
buffers (`ScanProgram`: an eager warm run on a scratch copy first, then
the capture), replays it once warm and times the next replay with CUDA
events. On the CPU the same loop runs eagerly and every device-ms field
is None: a CPU run measures no device time. Every result names its
device (`card`: the card's name and power limit, or "cpu").

    python -m foundationdb_tpu_torch.tools.floor_bench [--device cpu]
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..ops import conflict_kernel as ck
from ..ops import fixpoint_cuda, graph_if, keypack
from ..ops import host_engine as he
from .sharded_bench import card_line

#: CPU-sized default sweep shape: batch far under capacity so both the
#: auto rule and the floor gap are visible in seconds, not minutes
SMOKE_CFG = ck.KernelConfig(key_words=4, capacity=4096, max_txns=128,
                            max_point_reads=256, max_point_writes=256,
                            max_reads=32, max_writes=32)


def bench_device(device=None) -> torch.device:
    """The device a bench runs on: the card unless `device` names another,
    raising where the card is asked for and there is none."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("this bench runs on the card and CUDA is not available; "
                           "pass device='cpu' (--device cpu) to run it on the CPU")
    return dev


class ScanProgram:
    """`steps` applications of `step(carry, i) -> (carry', y)` as ONE
    program over the static carry buffers `carry` (a dict of tensors,
    updated in place by every run), writing each step's 0-d output y into
    `ys` [steps]: the port of a jitted ``lax.scan(step, carry,
    arange(steps))``. On the card it is one captured CUDA graph: an eager
    run on a scratch copy of the carry comes first, on the capture stream
    (what must not happen under capture: the fixpoint's cluster occupancy
    query, library handles, a kernel's first load; under the tiered
    structure it also takes both sides of the merge branch), then the
    capture (relaxed, with one body level for conditional nodes). `step`
    must not read a device value on the host. On the CPU the loop runs
    eagerly at every run()."""

    def __init__(self, step: Callable, carry: Dict[str, torch.Tensor], steps: int):
        self.step, self.steps, self.carry = step, steps, carry
        self.device = next(iter(carry.values())).device
        self.ys: Optional[torch.Tensor] = None
        self.graph = None
        #: fixpoint kernels one replay launches (counted at capture)
        self.launches = 0
        if self.device.type == "cuda":
            self._capture()

    def _body(self, carry: Dict[str, torch.Tensor]) -> None:
        c = dict(carry)
        ys = []
        for i in range(self.steps):
            c, y = self.step(c, i)
            ys.append(y)
        for k, v in carry.items():
            if c[k] is not v:
                v.copy_(c[k])
        ys = torch.stack(ys)
        if self.ys is None:
            self.ys = torch.empty_like(ys)
        self.ys.copy_(ys)

    def _capture(self) -> None:
        dev = self.device
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self._body({k: v.clone() for k, v in self.carry.items()})
        torch.cuda.current_stream(dev).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        before = fixpoint_cuda.FIXPOINT.launches
        levels = [(torch.cuda.Stream(dev), torch.cuda.graph_pool_handle())]
        with graph_if.bodies(levels), \
                torch.cuda.graph(graph, stream=stream, capture_error_mode="relaxed"):
            self._body(self.carry)
        self.launches = fixpoint_cuda.FIXPOINT.launches - before
        self.graph = graph
        he.count_capture()

    def run(self) -> Optional[float]:
        """One run of the whole program: on the card a replay, timed with
        CUDA events (device ms of the replay); on the CPU the eager loop,
        which returns None."""
        if self.graph is None:
            self._body(self.carry)
            return None
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        self.graph.replay()
        end.record()
        end.synchronize()
        fixpoint_cuda.FIXPOINT.graph_launches += self.launches
        return start.elapsed_time(end)


def _table_state(cfg: ck.KernelConfig, n: int, device="cpu") -> Dict[str, torch.Tensor]:
    """A boundary table holding exactly n sorted, distinct keys (version
    0) — zero-padded decimal keys are byte-ordered, and keypack preserves
    byte order, so the packed rows are already table-sorted."""
    hkeys = np.zeros((cfg.capacity, cfg.lanes), np.uint32)
    if n:
        hkeys[:n] = keypack.pack_keys(
            [b"fl/%08d" % i for i in range(n)], cfg.key_words)
    hvers = np.full((cfg.capacity,), int(ck.NEG_VERSION), np.int32)
    hvers[:n] = 0
    return {"hkeys": torch.from_numpy(hkeys.astype(np.int64)).to(device),
            "hvers": torch.from_numpy(hvers).to(device),
            "n": torch.tensor(n, dtype=torch.int32, device=device)}


def _read_batch(cfg: ck.KernelConfig, rng: np.random.Generator,
                n: int) -> Dict[str, np.ndarray]:
    """One full batch of valid point reads over the table's own keys
    (snapshots above every stored version: nothing aborts, nothing is
    written, the table stays at occupancy n across every scanned step)."""
    K = cfg.lanes
    Rp, Wp, T = cfg.rp, cfg.wp, cfg.max_txns
    Rr, Wr = cfg.max_reads, cfg.max_writes
    rpb = np.zeros((Rp, K), np.uint32)
    rpb[:] = keypack.pack_keys(
        [b"fl/%08d" % i for i in rng.integers(0, max(1, n), size=Rp)],
        cfg.key_words)
    return {
        "rpb": rpb,
        "rp_snap": np.full((Rp,), 100, np.int32),
        "rp_txn": np.sort(rng.integers(0, T, size=Rp)).astype(np.int32),
        "rp_valid": np.ones((Rp,), bool),
        "rb": np.zeros((Rr, K), np.uint32),
        "re": np.zeros((Rr, K), np.uint32),
        "r_snap": np.zeros((Rr,), np.int32),
        "r_txn": np.zeros((Rr,), np.int32),
        "r_valid": np.zeros((Rr,), bool),
        "wpb": np.zeros((Wp, K), np.uint32),
        "wp_txn": np.zeros((Wp,), np.int32),
        "wp_valid": np.zeros((Wp,), bool),
        "wb": np.zeros((Wr, K), np.uint32),
        "we": np.zeros((Wr, K), np.uint32),
        "w_txn": np.zeros((Wr,), np.int32),
        "w_valid": np.zeros((Wr,), bool),
        "t_ok": np.ones((T,), bool),
        "t_too_old": np.zeros((T,), bool),
        "now": np.asarray(200, np.int32),
        "gc": np.asarray(0, np.int32),
    }


def _write_batch(cfg: ck.KernelConfig, rng: np.random.Generator,
                 n: int) -> Dict[str, np.ndarray]:
    """One full batch of valid point WRITES over the table's own keys —
    the apply-cost probe (docs/perf.md "Incremental history
    maintenance"). Re-writing existing keys keeps the boundary set
    stationary after the first apply folds in the point-write end rows,
    so a warm scan reaches steady occupancy and the timed scan measures
    maintenance cost at a fixed table size."""
    b = _read_batch(cfg, rng, n)
    Rp, Wp, T = cfg.rp, cfg.wp, cfg.max_txns
    b["rp_valid"] = np.zeros((Rp,), bool)
    b["wpb"] = keypack.pack_keys(
        [b"fl/%08d" % i for i in rng.integers(0, max(1, n), size=Wp)],
        cfg.key_words).astype(np.uint32)
    b["wp_txn"] = np.sort(rng.integers(0, T, size=Wp)).astype(np.int32)
    b["wp_valid"] = np.ones((Wp,), bool)
    return b


def _per_step(ms: Optional[float], steps: int) -> Optional[float]:
    return None if ms is None else ms / steps


def _ratio(a: Optional[float], b: Optional[float]) -> Optional[float]:
    return round(a / b, 3) if a is not None and b else None


def _round(x: Optional[float], nd: int = 4) -> Optional[float]:
    return None if x is None else round(x, nd)


def run_apply_sweep(
    cfg: Optional[ck.KernelConfig] = None,
    *,
    occupancy_fracs: Sequence[float] = (0.25, 0.5, 0.75),
    scan_steps: int = 48,
    history_runs: int = 8,
    seed: int = 2028,
    device=None,
    host_reps: int = 0,
) -> Dict:
    """The `history_floor.apply` section (docs/perf.md "Incremental
    history maintenance"): device ms per WRITE batch vs table occupancy,
    monolithic vs tiered. The monolithic `apply_writes_and_gc` re-merges
    the capacity-H table with every batch, so its apply time carries an
    H-shaped floor; the tiered structure appends the batch as one sorted
    run and compacts every `history_runs` batches, so its amortized cost
    tracks the batch. The MAINTENANCE phase (`apply_writes_and_gc`) is
    timed in isolation. The table is first brought to its steady boundary
    set (one fold admits the point-write end rows), the write positions are
    recomputed against that steady table, and the timed program then
    replays the identical apply at stationary occupancy — checked by
    comparing warm-end and timed-end row counts. On the CPU nothing is
    timed unless `host_reps` > 0: then every program's eager run is timed
    `host_reps` times by the host's clock, in turns across the programs,
    and its fastest run kept (host ms, not a device figure: the CPU
    history smoke's scaling bar reads them)."""
    cfg = cfg or SMOKE_CFG
    dev = bench_device(device)
    rng = np.random.default_rng(seed)
    runs = []
    for structure in ("monolithic", "tiered"):
        scfg = dataclasses.replace(cfg, history_structure=structure,
                                   history_runs=history_runs)
        for frac in occupancy_fracs:
            n = max(1, int(frac * cfg.capacity))
            batch = ck.batch_from_numpy(cfg, _write_batch(cfg, rng, n), dev)
            committed = torch.ones((cfg.max_txns,), dtype=torch.bool, device=dev)
            state = dict(ck.initial_state(scfg, device=dev))
            state.update(_table_state(cfg, n, dev))
            # steady boundary set: fold the batch once, then recompute
            # the write positions against the folded table so the program
            # replays a position-correct apply at fixed occupancy
            wpos = ck.local_phases(scfg, state, batch)[2]
            state = ck.apply_writes_and_gc(scfg, state, batch, committed, wpos, False)[0]
            wpos = ck.local_phases(scfg, state, batch)[2]

            def step(st, _i, _cfg=scfg, _b=batch, _c=committed, _w=wpos):
                st2, _overflow, _reclaimed = ck.apply_writes_and_gc(
                    _cfg, st, _b, _c, _w, False)
                return st2, st2["n"]

            runs.append((structure, frac, n, ScanProgram(step, state, scan_steps)))

    steady_n = {}
    for structure, frac, n, prog in runs:
        prog.run()
        steady_n[(structure, frac)] = int(prog.ys[-1])

    counter = _CompileCounter()
    compiles = {"monolithic": 0, "tiered": 0}
    ms: Dict[tuple, Optional[float]] = {}
    for structure, frac, n, prog in runs:
        before = counter.seen()
        ms[(structure, frac)] = _per_step(prog.run(), scan_steps)
        final_n = int(prog.ys[-1])
        if final_n != steady_n[(structure, frac)]:
            raise RuntimeError(f"{structure} occupancy not stationary: "
                               f"{final_n} != {steady_n[(structure, frac)]}")
        compiles[structure] += counter.seen() - before
    counter.close()
    for _rep in range(host_reps if dev.type == "cpu" else 0):
        for structure, frac, n, prog in runs:
            t0 = time.perf_counter()
            prog.run()
            host_ms = _per_step((time.perf_counter() - t0) * 1e3, scan_steps)
            best = ms[(structure, frac)]
            ms[(structure, frac)] = host_ms if best is None else min(best, host_ms)

    points = []
    for frac in occupancy_fracs:
        mono = ms[("monolithic", frac)]
        tier = ms[("tiered", frac)]
        points.append({
            "occupancy_frac": frac,
            "n": max(1, int(frac * cfg.capacity)),
            "monolithic_ms": _round(mono),
            "tiered_ms": _round(tier),
            "tiered_speedup": _ratio(mono, tier),
        })
    return {
        "card": card_line(dev),
        "device": str(dev),
        "batch_txns": cfg.max_txns,
        "capacity": cfg.capacity,
        "write_rows": cfg.wp,
        "history_runs": history_runs,
        "scan_steps": scan_steps,
        "points": points,
        "steady_state_compiles": compiles,
    }


class _CompileCounter:
    """The port of the JAX counter, which listened to jax monitoring's
    compile events: here it counts the CUDA graphs captured in this
    process (host_engine.CAPTURES: every engine's captures and the
    ScanPrograms') from its construction until close(). A timed run that
    still captures is measuring the capture. It is never None: on the CPU
    nothing is captured and it counts 0."""

    def __init__(self) -> None:
        self._start = he.CAPTURES.n
        self._end: Optional[int] = None

    def seen(self) -> int:
        return (he.CAPTURES.n if self._end is None else self._end) - self._start

    def close(self) -> int:
        if self._end is None:
            self._end = he.CAPTURES.n
        return self.seen()


def run_floor_sweep(
    cfg: Optional[ck.KernelConfig] = None,
    *,
    occupancy_fracs: Sequence[float] = (0.25, 0.5, 0.75),
    scan_steps: int = 128,
    seed: int = 2026,
    device=None,
) -> Dict:
    """The `history_floor` section: device ms/batch at each occupancy for
    both modes, plus the post-warmup steady-state capture count per mode
    (must be 0 — a timed run that still captures is measuring the
    capture) and the cross-mode verdict parity at every occupancy (one
    eager step of each mode's batch on its table: equal statuses)."""
    cfg = cfg or SMOKE_CFG
    dev = bench_device(device)
    rng = np.random.default_rng(seed)
    runs = []   # (mode, frac, n, program)
    statuses: Dict[tuple, np.ndarray] = {}
    for mode in ("fused_sort", "bsearch"):
        mcfg = dataclasses.replace(cfg, history_search=mode)
        for frac in occupancy_fracs:
            n = max(1, int(frac * cfg.capacity))
            batch = ck.batch_from_numpy(cfg, _read_batch(cfg, rng, n), dev)

            def step(st, _i, _cfg=mcfg, _batch=batch):
                st, out = ck.resolve_step(_cfg, st, _batch, False)
                return st, out["n"]

            table = _table_state(cfg, n, dev)
            statuses[(mode, frac)] = ck.resolve_step(
                mcfg, table, batch, False)[1]["status"].cpu().numpy()
            runs.append((mode, frac, n, ScanProgram(step, table, scan_steps)))

    # warm every program first (its first replay), THEN time under the
    # capture counter: any capture in the timed phase is a rebuild the
    # warmup was supposed to make impossible
    for _mode, _frac, _n, prog in runs:
        prog.run()

    counter = _CompileCounter()
    compiles = {"fused_sort": 0, "bsearch": 0}
    ms: Dict[tuple, Optional[float]] = {}
    for mode, frac, n, prog in runs:
        before = counter.seen()
        ms[(mode, frac)] = _per_step(prog.run(), scan_steps)
        final_n = int(prog.ys[-1])
        if final_n != n:
            raise RuntimeError(f"occupancy drifted: {final_n} != {n}")
        compiles[mode] += counter.seen() - before
    counter.close()

    points = []
    for frac in occupancy_fracs:
        fused = ms[("fused_sort", frac)]
        bs = ms[("bsearch", frac)]
        points.append({
            "occupancy_frac": frac,
            "n": max(1, int(frac * cfg.capacity)),
            "fused_sort_ms": _round(fused),
            "bsearch_ms": _round(bs),
            "bsearch_speedup": _ratio(fused, bs),
            "verdicts_equal": bool(np.array_equal(statuses[("fused_sort", frac)],
                                                  statuses[("bsearch", frac)])),
        })
    return {
        "card": card_line(dev),
        "device": str(dev),
        "batch_txns": cfg.max_txns,
        "capacity": cfg.capacity,
        "auto_pick": ck.pick_history_search(cfg),
        "scan_steps": scan_steps,
        "points": points,
        #: post-warmup captures per mode (0 on the CPU, which captures
        #: nothing)
        "steady_state_compiles": compiles,
    }


def run_loop_floor(
    cfg: Optional[ck.KernelConfig] = None,
    *,
    n_batches: int = 24,
    warm_batches: int = 4,
    depth: int = 2,
    pool: int = 512,
    seed: int = 2027,
    device=None,
) -> Dict:
    """The `loop_floor` section (docs/perf.md "Device-resident loop"):
    per-batch HOST wall time of the step-dispatch engine vs the
    device-resident loop engine at a FIXED batch shape, both driven
    through the wall-clock ResolverPipeline at `depth` over the IDENTICAL
    transaction stream. Step dispatch pays a per-batch launch + blocking
    force; the loop enqueues onto its device queue and drains abort
    bitmaps non-blockingly. Verdict parity across the two engines is
    asserted into the result (the bench canary), alongside the loop's sync
    accounting (blocking_syncs MUST be 0). Host times, taken on any
    device; the result names it."""
    from ..ops.device_loop import DeviceLoopEngine
    from ..ops.host_engine import TorchConflictEngine
    from ..pipeline.resolver_pipeline import ResolverPipeline
    from .ladder_bench import make_point_txns

    cfg = cfg or SMOKE_CFG
    dev = bench_device(device)
    rng = np.random.default_rng(seed)
    stream = []
    version = 1_000
    for _ in range(warm_batches + n_batches):
        txns = make_point_txns(cfg.max_txns, pool, rng, version)
        version += max(64, cfg.max_txns)
        stream.append((txns, version, max(0, version - 100_000)))

    def drive(engine):
        engine.warmup()
        pipe = ResolverPipeline(engine, depth=depth)
        verdicts = []
        for s in stream[:warm_batches]:
            verdicts.append([int(x) for x in pipe.submit(*s).result()])
        t0 = time.perf_counter()
        handles = [pipe.submit(*s) for s in stream[warm_batches:]]
        verdicts.extend([int(x) for x in h.result()] for h in handles)
        wall_ms = (time.perf_counter() - t0) * 1e3
        return wall_ms / n_batches, verdicts

    step_ms, step_verdicts = drive(TorchConflictEngine(cfg, device=dev))
    loop = DeviceLoopEngine(cfg, device=dev)
    loop_ms, loop_verdicts = drive(loop)
    return {
        "card": card_line(dev),
        "device": str(dev),
        "batch_txns": cfg.max_txns,
        "depth": depth,
        "n_batches": n_batches,
        "step_host_ms_per_batch": round(step_ms, 4),
        "loop_host_ms_per_batch": round(loop_ms, 4),
        "loop_speedup": round(step_ms / loop_ms, 3) if loop_ms > 0 else None,
        #: measured host shares of one loop batch — bench.py injects these
        #: as the sim service's queue_enqueue_ms / result_drain_ms so the
        #: loop-mode latency attribution carries real figures
        "loop_enqueue_ms_per_batch": round(
            loop.loop_stats["enqueue_ms"] / max(1, loop.loop_stats["units"]), 4),
        "loop_decode_ms_per_batch": round(
            loop.loop_stats["decode_ms"] / max(1, loop.loop_stats["units"]), 4),
        #: the bench canary: loop and step verdict streams bit-identical
        "parity_ok": step_verdicts == loop_verdicts,
        "loop_stats": dict(loop.loop_stats),
    }


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run_floor_sweep(scan_steps=48, device=args.device)
    print(json.dumps({"metric": "history_floor", **out}))
    comp = out["steady_state_compiles"]
    if any(comp.values()) or not all(p["verdicts_equal"] for p in out["points"]):
        return 1
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
