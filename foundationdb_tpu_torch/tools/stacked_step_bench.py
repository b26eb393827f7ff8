"""The sub-sharded engine's one-chunk program by S against one table's.

    python foundationdb_tpu_torch/tools/stacked_step_bench.py \\
        [--tree DIR] [--sizes 2,4,8] [--out FILE]

At chip_smoke.py's bench config, as its sharded phase builds the engines
(the top bucket alone, no scans, heat 64, device-time sampling off): one
TorchConflictEngine and a SubshardedConflictEngine for each S in
`--sizes` over chip_smoke's pool_splits(S). For each engine: the capture
ms of its one-chunk program (the perf ledger's build record: the warm run
and both captures), the kernels, by name too, and device ms of one replay
of it (a torch.profiler trace of 2 replays; a trace can lose kernel
events, so the most kernels of 3 traces), and its txn/s on chip_smoke's
columnar traffic (pack, dispatch and force; verdicts equal the single
table's on every batch), the engines timed in turns (one table, S
ascending, then back).
Also one table's 8-chunk program (the graph-step phase's): kernels a
replay with and without the GC branch, on chip_smoke's packed batches.

The package is the one under `--tree` (default: this checkout); the
traffic and batches are this checkout's chip_smoke.py's, so one command
measures an older checkout on the same inputs. Compare two
trees only on one card, in turns (A, B, B, A).

Prints the card's name and power limit, then one JSON line. Needs a CUDA
card: without one it prints the reason and exits 2.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SEED = 2026


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_bench", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traced(run, fixpoint_kernel: str) -> dict:
    """The most kernels of 3 torch.profiler traces of 2 calls of run(),
    with that trace's device ms, fixpoint kernels (named
    `fixpoint_kernel`) and kernels by name, a call."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    best = None
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            for _ in range(2):
                run()
            torch.cuda.synchronize()
        names = collections.Counter(e.name for e in prof.events()
                                    if e.device_type == DeviceType.CUDA)
        busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                      if e.device_type == DeviceType.CUDA)
        pw = {"kernels": sum(names.values()) / 2, "device_ms": busy_us / 2 / 1e3,
              "fixpoint_kernels": sum(v for k, v in names.items() if fixpoint_kernel in k) / 2,
              "by_name": {k: v / 2 for k, v in sorted(names.items())}}
        if best is None or pw["kernels"] > best["kernels"]:
            best = pw
    return best


def graph_step_kernels(smoke, ck, he, cfg, dev) -> dict:
    """Kernels a replay of one table's GRAPH_C-chunk program, with and
    without the GC branch, on the graph-step phase's packed batches."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    pool = smoke.key_pool(cfg, rng)
    rows = [ck.batch_from_numpy(cfg, smoke.synth_packed(cfg, rng, pool), dev)
            for _ in range(smoke.GRAPH_C)]
    eng = he.TorchConflictEngine(cfg, device=dev, scan_sizes=(smoke.GRAPH_C,),
                                 device_time_sample_rate=0.0)
    prog = eng._program(cfg, smoke.GRAPH_C)
    T = cfg.max_txns
    for c, b in enumerate(rows):
        b["now"] = torch.full((), 3 * T, dtype=torch.int32, device=dev)
        b["gc"] = torch.full((), T if c == smoke.GRAPH_C - 1 else 0, dtype=torch.int32,
                             device=dev)
        b["rp_snap"] = torch.full_like(b["rp_snap"], 2 * T)
        b["r_snap"] = torch.full_like(b["r_snap"], 2 * T)
    for k in prog.inputs:
        prog.inputs[k].copy_(torch.stack([ck._u32_to_i32(b[k]) if k in ck.KEY_FIELDS else b[k]
                                          for b in rows]))
    # the replays' table may fill and overflow: a monolithic program's
    # kernels do not depend on the data
    return {("gc" if gc_last else "no_gc"):
            traced(lambda: prog.run(gc_last), smoke.FIXPOINT_KERNEL)["kernels"]
            for gc_last in (False, True)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(ROOT), help="checkout whose package is measured")
    ap.add_argument("--sizes", default="2,4,8")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("stacked_step_bench needs a CUDA card; none is visible", flush=True)
        return 2
    from foundationdb_tpu_torch.core.keyshard import KeyShardMap
    from foundationdb_tpu_torch.ops import conflict_kernel as ck
    from foundationdb_tpu_torch.ops import host_engine as he

    smoke = _load_smoke()
    dev = torch.device("cuda")
    card = smoke.card_line()
    print(card, flush=True)
    cfg = smoke.bench_cfg(ck)
    sizes = [int(x) for x in args.sizes.split(",") if x]
    batches = smoke.columnar_traffic(np.random.default_rng(SEED), smoke.COLUMNAR_SIZES,
                                     smoke.READ_ONLY)
    res = {"card": card, "tree": str(Path(args.tree).resolve()),
           "torch": torch.__version__, "cuda": torch.version.cuda, "engines": {}}
    t0 = time.perf_counter()
    kw = dict(ladder=(), scan_sizes=(), device_time_sample_rate=0.0)
    engines = {"single": he.TorchConflictEngine(cfg, **kw)}
    for S in sizes:
        engines[f"S{S}"] = he.SubshardedConflictEngine(cfg, KeyShardMap(smoke.pool_splits(S)),
                                                       **kw)
    serial = None
    for name, eng in engines.items():
        eng.warmup()
        torch.cuda.synchronize()
        capture_ms = [r["duration_ms"] for r in eng.perf_ledger.records
                      if r["n_chunks"] == 1 and r["bucket"] == cfg.max_txns]
        got = [[int(v) for v in eng.columnar_dispatch(eng.columnar_pack(txns, now, oldest))()]
               for txns, now, oldest in batches]
        if serial is None:
            serial = got
        smoke.check(got == serial, f"{name}: verdicts differ from the single table's")
        prog = eng._programs[(cfg.max_txns, 1)]
        kernel = smoke.FIXPOINT_KERNEL if name == "single" else smoke.STACKED_KERNEL
        res["engines"][name] = dict(traced(lambda: prog.run(False), kernel),
                                    capture_ms=capture_ms, txn_per_s=[])
        print(f"{name} [{card}]: one-chunk program {res['engines'][name]['kernels']:.0f} "
              f"kernels, {res['engines'][name]['device_ms']:.4f} ms a replay; captured in "
              f"{capture_ms} ms", flush=True)
    order = list(engines)
    for name in order + order[::-1]:
        res["engines"][name]["txn_per_s"].append(
            smoke.columnar_timing(engines[name], batches, serial)["txn_per_s"])
    best = {k: max(v["txn_per_s"]) for k, v in res["engines"].items()}
    res["txn_per_s_ratio"] = {k: v / best["single"] for k, v in best.items() if k != "single"}
    res["kernels_ratio"] = {k: v["kernels"] / res["engines"]["single"]["kernels"]
                            for k, v in res["engines"].items() if k != "single"}
    del engines
    res["graph_step_kernels"] = graph_step_kernels(smoke, ck, he, cfg, dev)
    res["seconds"] = time.perf_counter() - t0
    print(f"ratios to one table [{card}]: kernels {res['kernels_ratio']}, txn/s "
          f"{res['txn_per_s_ratio']}; one table's {smoke.GRAPH_C}-chunk program "
          f"{res['graph_step_kernels']} kernels a replay ({res['seconds']:.1f} s)", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
