"""Keyspace-heat smoke: the heat layer's contract, in seconds.

Port of ``foundationdb_tpu/tools/heat_smoke.py``. It runs on the card
unless given `--device cpu`:

    python -m foundationdb_tpu_torch.tools.heat_smoke [--device cpu]

Four checks, each loud on failure (docs/observability.md "Keyspace heat &
occupancy"):

  1. HOT BUCKETS MATCH INJECTED HOT KEYS — a stream where a known set of
     keys carries ~half the write load must surface ranges COVERING those
     keys at the top of `hot_ranges` (the aggregator found the heat we
     planted, not just some heat).
  2. SPLIT POINTS PARTITION MEASURED LOAD — the suggested equal-load
     split points over a permuted Zipf(0.9) stream must balance the
     measured write+conflict load within tolerance across the proposed
     shards.
  3. PROMETHEUS EXPOSITION PARSES — the hub text (now carrying `heat.*`
     and `engine.*.verdicts.*` series) passes the strict line parser:
     HELP/TYPE headers precede every family's samples and every sample
     line matches the exposition grammar.
  4. DISABLED PATH ALLOCATES NOTHING — with `heat_buckets=0` the engine
     builds no aggregator, the step's outputs carry no heat (the port's
     resolve_step / local_phases run on real inputs: no `heat` key, no
     `heat_*` edge; on the card, no captured program of the warmed engine
     holds a heat buffer), heat_snapshot() is None and the hub syncs no
     heat series.

Prints one JSON line naming its device; any failed check exits non-zero.
"""
from __future__ import annotations

import json
import re
import sys
import time

import numpy as np
import torch

from ..core import telemetry
from ..core.knobs import SERVER_KNOBS
from ..core.types import CommitTransaction, KeyRange
from ..ops import conflict_kernel as ck
from ..ops.host_engine import TorchConflictEngine

CFG = ck.KernelConfig(key_words=4, capacity=4096, max_txns=128,
                      max_point_reads=512, max_point_writes=512,
                      max_reads=32, max_writes=32)
POOL = 1024                      # fits the table (2 boundary rows per key)
HOT_KEYS = (137, 525, 901)       # the planted hot set
HOT_FRAC = 0.5                   # share of write rows landing on it
SPLIT_TOLERANCE = 0.25           # max per-shard deviation from 1/shards


def _key(i: int) -> bytes:
    return b"heat/%08d" % i


def _populate(eng) -> int:
    """Write every pool key once so the table — and therefore the device
    bucket grid — is stationary before measurement starts."""
    version = 1_000
    i = 0
    while i < POOL:
        txns = []
        for _t in range(CFG.max_txns):
            tr = CommitTransaction(read_snapshot=max(0, version - 50))
            for _w in range(2):
                tr.write_conflict_ranges.append(
                    KeyRange(_key(i % POOL), _key(i % POOL) + b"\x00"))
                i += 1
            txns.append(tr)
        version += 256
        eng.resolve(txns, version, max(0, version - 100_000))
    return version


def _hot_stream_batches(n_batches: int, start_version: int, seed: int = 11):
    rng = np.random.default_rng(seed)
    version = start_version
    for _ in range(n_batches):
        txns = []
        for _t in range(CFG.max_txns):
            tr = CommitTransaction(read_snapshot=max(0, version - 50))
            for _i in range(2):
                k = _key(int(rng.integers(0, POOL)))
                tr.read_conflict_ranges.append(KeyRange(k, k + b"\x00"))
            for _i in range(2):
                if rng.random() < HOT_FRAC:
                    k = _key(int(rng.choice(HOT_KEYS)))
                else:
                    k = _key(int(rng.integers(0, POOL)))
                tr.write_conflict_ranges.append(KeyRange(k, k + b"\x00"))
            txns.append(tr)
        version += 256
        yield txns, version, max(0, version - 100_000)


def check_hot_buckets(device="cuda") -> TorchConflictEngine:
    """Returns the driven engine — the caller MUST hold it until after
    check_prometheus: the telemetry hub keeps only weakrefs, and a
    collected engine would leave the exposition with no heat series."""
    eng = TorchConflictEngine(CFG, heat_buckets=64, device=device)
    eng.warmup()
    v0 = _populate(eng)
    eng.heat.reset_weights()     # measure on the stationary grid only
    for txns, v, oldest in _hot_stream_batches(10, v0):
        eng.resolve(txns, v, oldest)
    agg = eng.heat
    hot = agg.hot_ranges(top_n=8)
    assert hot, "no hot ranges aggregated"

    def covers(r, key: bytes) -> bool:
        def debytes(s):
            return bytes(s, "latin-1") if not s.startswith("0x") \
                else bytes.fromhex(s[2:])
        begin = debytes(r["begin"])
        end = debytes(r["end"]) if r["end"] is not None else None
        return begin <= key and (end is None or key < end)

    # the bucket grid shifts as the table grows, so one planted key's
    # load may spread over a couple of adjacent entries — the check is
    # rank-based: every planted key must be covered by a TOP-10 range,
    # and the covering ranges together must dominate the uniform
    # background (64 background buckets ≈ 1.5% each)
    top = hot[:10]
    covering = set()
    for i in HOT_KEYS:
        key = _key(i)
        hits = [j for j, r in enumerate(top) if covers(r, key)]
        assert hits, (
            f"planted hot key {key!r} not covered by any top-10 range: "
            f"{[r['begin'] for r in top]}")
        covering.update(hits)
    share = sum(top[j]["share"] for j in covering)
    assert share > 0.2, (
        f"covering ranges carry only {share:.3f} of load for a planted "
        f"{HOT_FRAC:.0%} hot set")
    print(f"  hot buckets: {len(covering)} top-10 ranges cover all "
          f"{len(HOT_KEYS)} planted keys with {share * 100:.1f}% of load")
    return eng   # keep alive: the hub holds weakrefs (check_prometheus)


def check_split_points(device="cuda") -> dict:
    """Returns the split keys and their measured balance."""
    from .heat_bench import drive_zipf_stream

    eng = TorchConflictEngine(CFG, heat_buckets=64, device=device)
    eng.warmup()
    drive_zipf_stream(eng, s=0.9, pool=2048, n_batches=12, seed=7)
    agg = eng.heat
    shards = 8
    splits = agg.split_points(shards)
    assert len(splits) == shards - 1, f"want {shards - 1} splits, got {len(splits)}"
    balance = agg.split_balance(shards, splits)
    mean = 1.0 / shards
    max_dev = max(abs(f - mean) for f in balance) / mean
    assert max_dev <= SPLIT_TOLERANCE, (
        f"split imbalance {max_dev:.3f} > {SPLIT_TOLERANCE} "
        f"(balance {balance})")
    print(f"  split points: {shards} shards, max deviation "
          f"{max_dev * 100:.1f}% of mean (tolerance "
          f"{SPLIT_TOLERANCE * 100:.0f}%)")
    return {"splits": list(splits), "balance": list(balance), "max_dev": max_dev}


#: one exposition sample line (the strict-parser grammar)
_SAMPLE_RE = re.compile(
    r'^fdbtpu_[a-zA-Z_][a-zA-Z0-9_]*'
    r'(\{series="(\\.|[^"\\\n])*"\})? -?\d+(\.\d+)?$')


def strict_parse_prometheus(text: str) -> int:
    """The regression parser: every sample matches the grammar and
    appears after its family's # HELP/# TYPE headers. Returns the sample
    count; raises AssertionError on any malformed line."""
    seen = set()
    samples = 0
    for ln in text.strip().split("\n"):
        if ln.startswith("# HELP ") or ln.startswith("# TYPE "):
            fam = ln.split()[2]
            if ln.startswith("# TYPE "):
                assert ln.split()[3] == "gauge", ln
                assert fam in seen, f"TYPE before HELP: {ln!r}"
            seen.add(fam)
            continue
        assert _SAMPLE_RE.match(ln), f"unparseable exposition line: {ln!r}"
        assert ln.split("{")[0].split()[0] in seen, \
            f"sample before its # HELP/# TYPE header: {ln!r}"
        samples += 1
    return samples


def check_prometheus() -> None:
    text = telemetry.hub().prometheus_text()
    n = strict_parse_prometheus(text)
    assert "# TYPE fdbtpu_heat gauge" in text, "no heat family exposed"
    assert any("verdicts" in ln for ln in text.splitlines()), \
        "no engine verdict split exposed"
    print(f"  prometheus: {n} samples parse strictly, heat family present")


def disabled_outputs(eng) -> dict:
    """The key sets of the heat-off engine's step outputs, from the port's
    resolve_step and local_phases run on a zero table and an empty batch
    of the engine's own config (torch has no eval_shape: the step itself
    runs): {"resolve": resolve_step's output keys, "edges": local_phases'
    edge keys}."""
    dev = eng.device
    state = {k: torch.zeros(shape, dtype=dtype, device=dev)
             for k, (shape, dtype) in ck.state_shapes(eng.cfg).items()}
    batch = {k: torch.zeros(shape, dtype=dtype, device=dev)
             for k, (shape, dtype) in ck.batch_shapes(eng.cfg).items()}
    _state, out = ck.resolve_step(eng.cfg, state, batch, False)
    _hist, edges, _wpos = ck.local_phases(eng.cfg, state, batch)
    return {"resolve": sorted(out), "edges": sorted(edges)}


def check_disabled_path(device="cuda") -> dict:
    telemetry.reset()
    eng = TorchConflictEngine(CFG, heat_buckets=0, device=device)
    assert eng.heat is None, "heat_buckets=0 still built an aggregator"
    assert eng.heat_snapshot() is None
    # the step allocates nothing: its outputs carry no heat
    keys = disabled_outputs(eng)
    assert "heat" not in keys["resolve"], \
        f"heat-off program still emits heat: {keys['resolve']}"
    # and the edges dict is the pre-heat one (no witness-context entries
    # ride along when off)
    assert not any(k.startswith("heat_") for k in keys["edges"]), keys["edges"]
    # the captured programs: on the card every one of the warmed engine's
    # programs is its graphs, and none may hold a heat buffer
    programs = 0
    if eng.device.type == "cuda":
        eng.warmup()
        heat_bufs = {key: sorted(p.heat) for key, p in eng._programs.items() if p.heat}
        programs = len(eng._programs)
        assert programs and all(p.graphs for p in eng._programs.values()), \
            "the heat-off engine captured no programs"
        assert not heat_bufs, f"heat-off captured programs hold heat buffers: {heat_bufs}"
    # nothing reaches the hub either
    telemetry.hub().sync()
    assert not any(name.startswith("heat.")
                   for name in telemetry.hub().tdmetrics.metrics), \
        "heat series synced with the layer disabled"
    print("  disabled path: no aggregator, no heat outputs, no hub series"
          + (f", {programs} captured programs without heat" if programs else ""))
    return {**keys, "captured_programs": programs}


def run(device: str = "cuda") -> dict:
    """Every check; the result line main prints."""
    from .floor_bench import bench_device

    dev = bench_device(device)
    t0 = time.perf_counter()
    failures = []
    out = {"metric": "heat_smoke", "device": str(dev)}
    assert int(SERVER_KNOBS.resolver_heat_buckets) >= 0
    print(f"heat-smoke [{dev}] (docs/observability.md):")
    live = None
    for name, fn in (("hot_buckets", lambda: check_hot_buckets(dev)),
                     ("split_points", lambda: check_split_points(dev)),
                     ("prometheus", check_prometheus),
                     ("disabled_path", lambda: check_disabled_path(dev))):
        try:
            r = fn()
        except AssertionError as e:
            failures.append(f"{name}: {e}")
            continue
        if name == "hot_buckets":
            live = r   # held: the telemetry hub weakrefs it
            out[name] = r.heat.hot_ranges(top_n=8)
        elif r is not None:
            out[name] = r
    del live
    out["split_points"] = ({**out["split_points"],
                            "splits": [k.hex() for k in out["split_points"]["splits"]]}
                           if "split_points" in out else None)
    out.update(ok=not failures, failures=failures,
               seconds=round(time.perf_counter() - t0, 3))
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.device)
    print(json.dumps(out, default=str))
    return 1 if out["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
