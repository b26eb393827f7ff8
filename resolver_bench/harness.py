"""One run of one cell: set-up, the measured window, the check, the result.

The window drives the wall-clock serving path of one resolver: batches go
to `ResolverPipeline.submit(txns, now, new_oldest)` in version order over
the engine the configuration names (`engine_kind`, "torch" when left out,
with `shards` even key ranges; its KernelConfig from `engine`), built on
the cell's `chips` cards, at the port's knob defaults. All-point batches
of keys the device holds take the columnar path (columnar_pack on the
pipeline's pack thread, columnar_dispatch, force); the rest the engine's
general router. The traffic mix (traffic/<name>.json) sets the loop:
closed, the next batch submitted as soon as `submit` returns, as commit
proxies that always have a batch ready at saturation; or open, batch i
due `i / (offered_txn_per_s / txns a batch)` seconds into the window and
submitted then or, when the resolver is behind, as soon as it can be. A
batch's latency runs from when it was due to the return of the call in
which its verdicts came back.

Set-up builds the traffic from the seed (traffic.py), warms the engine's
programs at the shapes this traffic uses and no others, and resolves
`prefill_horizons` write lives of batches through the same entry, closed
loop (the prefill), so the table is at steady state when the window
opens. The window never reuses a batch: when it runs out of the batches
built, the run fails; so does a run in which the engine built a program
inside the window.

Once the window has closed and the cards' memory peak is read, the
engine is freed and reference.py resolves every batch the run resolved,
prefill included; `correct` holds when every verdict is equal.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from . import bound, reference
from .traffic import Traffic, sizes

BENCH_DIR = Path(__file__).resolve().parent
#: top-level module names that must not be loaded in the process that
#: prints a result: JAX and the JAX package the port was made from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "foundationdb_tpu")


class RunFailed(Exception):
    """The run cannot give a result (it prints none and exits non-zero)."""


@dataclass
class Spec:
    """One cell as BENCHMARK.json names it, with its files read."""

    cell: dict
    config: dict
    mix: dict
    metrics: List[dict]        # end-to-end entries, then per-layer ones, of this cell


def load_spec(root: Path, workload: str) -> Spec:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise RunFailed(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    mix = json.loads((BENCH_DIR / "traffic" / f"{cell['traffic']}.json").read_text())
    metrics = []
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            if workload in m.get("workloads", [workload]):
                metrics.append(dict(m, group=group))
    return Spec(cell, config, mix, metrics)


@dataclass
class Run:
    """What a metric reader (metrics/<name>.py, `read(run)`) reads."""

    setup_s: float
    warmup_s: float                    # the engine's build and warm-up
    prefill_s: float                   # the prefill, closed loop
    window_s: float
    txns_done: int                     # verdicts in hand inside the window
    batch_ms: np.ndarray               # latency of each batch due in the window
    spans_ms: Dict[str, List[float]] = field(default_factory=dict)   # traced runs
    dispatch_ms: List[float] = field(default_factory=list)           # traced runs
    device: Optional[object] = None    # devtrace.DeviceTrace of a traced run on the card
    fixpoint_bound_ms: List[float] = field(default_factory=list)     # each window batch


@dataclass
class _Batch:
    b: int
    pending: object
    t_due: float
    t_back: float = 0.0                # return of the submit/result call that brought it


def _drive(pipe, traffic: Traffic, b0: int, n: Optional[int], t_end: Optional[float],
           batches_per_s: Optional[float] = None,
           submits: Optional[List[Tuple[float, float]]] = None) -> List[_Batch]:
    """From batch b0: n batches, or those due before t_end; then force the
    rest. Closed loop when `batches_per_s` is None, else batch b0 + i is
    due i / batches_per_s after the start. Each batch's t_back is when the
    call that forced it returned."""
    out: List[_Batch] = []
    open_: deque = deque()
    b = b0
    t_start = time.perf_counter()
    while True:
        t = time.perf_counter()
        due = t if batches_per_s is None else t_start + (b - b0) / batches_per_s
        if (n is not None and b - b0 >= n) or (t_end is not None and due >= t_end):
            break
        if b >= traffic.n_batches:
            raise RunFailed(f"the window outran the {traffic.n_batches} batches built; "
                            f"raise the traffic mix's built_txn_per_s")
        while t < due:              # open loop, ahead of time: answer what is in flight
            if open_:
                batch = open_.popleft()
                try:
                    batch.pending.result()
                except Exception:   # an errored batch: counted as failed below
                    pass
                batch.t_back = time.perf_counter()
            else:
                time.sleep(min(due - t, 2e-4))
            t = time.perf_counter()
        pb = pipe.submit(traffic.txns[b], traffic.now(b), traffic.new_oldest(b))
        t_ret = time.perf_counter()
        if submits is not None:
            submits.append((t, t_ret))
        while open_ and open_[0].pending.is_done:
            open_.popleft().t_back = t_ret
        batch = _Batch(b, pb, due)
        open_.append(batch)
        out.append(batch)
        b += 1
    for batch in open_:
        try:
            batch.pending.result()
        except Exception:       # an errored batch: counted as failed below
            pass
        batch.t_back = time.perf_counter()
    return out


def _verdicts(batch: _Batch) -> Optional[np.ndarray]:
    try:
        return np.array(batch.pending.result(), dtype=np.int8)
    except Exception as e:      # noqa: BLE001 — the failure is reported, not hidden
        print(f"batch {batch.b} failed: {e!r}", file=sys.stderr)
        return None


def _load_reader(name: str) -> Callable:
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"resolver_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is, as a
    whole, one of FORBIDDEN_MODULES."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def _read_trace(run: Run, device_dict: dict, spans: List[dict],
                dispatches: List[Tuple[float, float]], submits: List[Tuple[float, float]],
                prof, t0: float, t_stop: float, ns_offset: int) -> Optional[dict]:
    """Fill a traced run's spans, dispatch clocks and device trace into
    `run` and `device_dict`; return the breakdown (None without a card)."""
    for s in spans:
        if t0 <= s["Begin"] <= t_stop:
            run.spans_ms.setdefault(s["Name"], []).append((s["End"] - s["Begin"]) * 1e3)
    run.dispatch_ms = [(b - a) * 1e3 for a, b in dispatches]
    if prof is None:
        return None
    from .devtrace import DeviceTrace

    def ns(intervals):
        return sorted((int(a * 1e9) + ns_offset, int(b * 1e9) + ns_offset) for a, b in intervals)

    dev = DeviceTrace(prof.profiler.kineto_results.events(),
                      int(t0 * 1e9) + ns_offset, int(t_stop * 1e9) + ns_offset,
                      device_dict["count"])
    run.device = dev
    device_dict["busy_s"] = dev.busy_s()
    device_dict["window_s"] = dev.window_s
    host = {"pack": ns((s["Begin"], s["End"]) for s in spans if s["Name"] == "engine.host_pack"),
            "dispatch": ns(dispatches),
            "force": ns((s["Begin"], s["End"]) for s in spans if s["Name"] == "engine.force"),
            "submit": ns(submits)}
    return {"device_ops": dev.top_ops(), "idle_gaps": dev.idle_by_host(host)}


#: engine kinds that place their shards on several cards
MULTI_CARD_KINDS = ("sharded", "mesh")


def _build_engine(cfg_json: dict, traffic: Traffic, chips: int, device: str):
    """The configuration's engine: `engine_kind` over `shards` even ranges
    of the traffic's key ids, on `chips` cards (shard s on card
    s * chips // shards)."""
    from foundationdb_tpu_torch.core.keyshard import KeyShardMap
    from foundationdb_tpu_torch.ops.conflict_kernel import KernelConfig
    from foundationdb_tpu_torch.ops.host_engine import make_engine

    kind = cfg_json.get("engine_kind", "torch")
    n = int(cfg_json.get("shards", 1))
    kw = {}
    if kind != "torch":
        nk = int(cfg_json["keys"])
        kw["shards"] = KeyShardMap([traffic.key_bytes_of(s * nk // n) for s in range(1, n)])
    if chips > 1:
        if kind not in MULTI_CARD_KINDS:
            raise RunFailed(f"engine {kind!r} runs on one card; the cell asks for {chips}")
        kw["devices"] = [f"{device}:{s * chips // n}" if device == "cuda" else device
                         for s in range(n)]
    else:
        kw["device"] = device
    return make_engine(kind, KernelConfig(**cfg_json["engine"]), **kw)


def run_cell(spec: Spec, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", fault: Optional[Callable] = None) -> dict:
    """Set up, measure, check; returns the result dict. `fault(engine)`,
    given by the tests only, breaks the engine before the prefill."""
    import torch

    from foundationdb_tpu_torch.core import trace as port_trace
    from foundationdb_tpu_torch.pipeline.resolver_pipeline import ResolverPipeline

    cfg_json, mix = spec.config, spec.mix
    if mix["loop"] not in ("closed", "open"):
        raise RunFailed(f"traffic loop {mix['loop']!r}: not 'closed' or 'open'")
    on_card = device == "cuda"
    chips = int(spec.cell["chips"])
    # -- set-up -------------------------------------------------------------
    sizes_ = sizes(cfg_json)
    prefill = sizes_.horizon_batches * int(mix["prefill_horizons"])
    window_batches = math.ceil(mix["built_txn_per_s"] * seconds / sizes_.txns_per_batch)
    traffic = Traffic(cfg_json, seed, prefill + window_batches)
    rows = [traffic.valid_rows(b) for b in range(traffic.n_batches)]

    t = time.perf_counter()
    engine = _build_engine(cfg_json, traffic, chips, device)
    top = engine.buckets[-1]
    if (traffic.T <= top.max_txns and all(r[2:] == (0, 0) for r in rows)
            and traffic.key_bytes <= 4 * engine.cfg.key_words and getattr(engine, "n_shards", 1) == 1
            and max(r[0] for r in rows) <= top.rp and max(r[1] for r in rows) <= top.wp):
        # one chunk a batch on the columnar path: this traffic's buckets
        used = {b.max_txns: b for b in (engine.bucket_for(traffic.T, r, w) for r, w, _, _ in rows)}
        engine.warmup(buckets=list(used.values()), scan_sizes=())
    else:
        engine.warmup()
    if fault is not None:
        fault(engine)
    warmup_s = time.perf_counter() - t

    executor = ThreadPoolExecutor(int(mix["pack_threads"]))
    try:
        pipe = ResolverPipeline(engine, depth=int(mix["pipeline_depth"]), executor=executor)
        t = time.perf_counter()
        done = _drive(pipe, traffic, 0, prefill, None)
        if on_card:
            torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        gc.collect()
        gc.freeze()     # the traffic's objects sit outside every collection
        # -- the window -----------------------------------------------------
        submits: List[Tuple[float, float]] = []
        dispatches: List[Tuple[float, float]] = []
        prof = None
        if trace:
            port_trace.g_spans.clear()
            port_trace.set_span_collection(True)
            orig_dispatch = engine.columnar_dispatch

            def timed_dispatch(plan):
                t_d = time.perf_counter()
                force = orig_dispatch(plan)
                dispatches.append((t_d, time.perf_counter()))
                return force

            engine.columnar_dispatch = timed_dispatch
            if on_card:
                from torch.profiler import ProfilerActivity, profile

                prof = profile(activities=[ProfilerActivity.CUDA])
                prof.__enter__()
        compiles = engine.perf.compiles
        offered = mix.get("offered_txn_per_s")
        ns_offset = time.time_ns() - time.perf_counter_ns()
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        window = _drive(pipe, traffic, prefill, None, t0 + seconds,
                        None if offered is None else offered / traffic.T,
                        submits if trace else None)
        if on_card:
            torch.cuda.synchronize()
        t_stop = time.perf_counter()
        if engine.perf.compiles != compiles:
            raise RunFailed(f"{engine.perf.compiles - compiles} program(s) built inside the "
                            f"window: the warm-up missed a shape this traffic uses")
        spans = []
        if trace:
            if prof is not None:
                prof.__exit__(None, None, None)
            port_trace.set_span_collection(False)
            del engine.columnar_dispatch
            spans = list(port_trace.g_spans.spans)
            port_trace.g_spans.clear()
        memory_peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips)) \
            if on_card else 0
        kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    finally:
        executor.shutdown(wait=True)
    # -- results ----------------------------------------------------------------
    t_end = t0 + seconds
    got = [_verdicts(x) for x in done + window]
    failed_batches = [x for x, v in zip(done + window, got) if v is None]
    n_done = sum(traffic.T for x in window if x.t_back <= t_end)
    batch_ms = np.array([(x.t_back - x.t_due) * 1e3 for x in window])
    shape = bound.Shape(cfg_json["engine"])
    run = Run(setup_s=setup_s, warmup_s=warmup_s, prefill_s=prefill_s, window_s=seconds,
              txns_done=n_done, batch_ms=batch_ms,
              fixpoint_bound_ms=[bound.batch_bound_ms(shape, *rows[x.b]) for x in window])
    device_dict = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": chips if on_card else 0, "memory_peak_bytes": int(memory_peak)}
    breakdown = None
    if trace:
        breakdown = _read_trace(run, device_dict, spans, dispatches, submits, prof, t0, t_stop,
                                ns_offset)
    # free the program's state before the reference runs
    for x in done + window:
        x.pending = None
    del pipe, engine, prof
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    # -- the check ----------------------------------------------------------------
    t = time.perf_counter()
    want = reference.resolve(traffic, len(got))
    ref_s = time.perf_counter() - t
    mismatched = reference.mismatches([np.zeros(0, np.int8) if v is None else v for v in got],
                                      want.verdicts)
    window_v = [v for v in got[len(done):] if v is not None]
    aborts = (sum(int(np.count_nonzero(v != reference.COMMITTED)) for v in window_v)
              / max(1, sum(len(v) for v in window_v)))
    info = {"seed": seed, "cell": spec.cell["name"], "txns_per_batch": traffic.T,
            "version_step": traffic.step, "prefill_batches": prefill,
            "window_batches": len(window), "batches_built": traffic.n_batches,
            "batch_p50_ms": float(np.median(batch_ms)) if len(batch_ms) else None,
            "batch_p99_ms": float(np.percentile(batch_ms, 99)) if len(batch_ms) else None,
            "abort_share": aborts, "rows_max": want.rows_max, "rows_last": want.rows_last,
            "capacity": int(cfg_json["engine"]["capacity"]), "warmup_s": warmup_s,
            "prefill_s": prefill_s, "window_stop_s": t_stop - t0, "reference_s": ref_s}
    print(json.dumps({"info": info}), flush=True)
    metrics = {}
    for m in spec.metrics:
        if (m["group"] == "per_layer") != trace:
            continue
        value = _load_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {"mismatched_verdicts": {"value": mismatched, "limit": 0},
              "failed_batches": {"value": len(failed_batches), "limit": 0}}
    result = {"correct": mismatched == 0 and not failed_batches,
              "attempted": len(window) * traffic.T,
              "failed": sum(traffic.T for x in failed_batches if x.b >= prefill),
              "metrics": metrics, "device": device_dict}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
