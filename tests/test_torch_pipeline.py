"""The port's ResolverPipeline on the CPU against the JAX package's.

The same batch stream goes through the port's pipeline over
TorchConflictEngine and through foundationdb_tpu.pipeline.ResolverPipeline
over JaxConflictEngine with the same ladder and scan sizes, at depth 1, 2
and 3, the columnar pack inline or on an executor thread: the verdicts
equal each other, serial resolve() of the port, and the JAX package's
oracle. Forcing a late batch first still forces in version order; an
engine without the pack/dispatch split (either package's oracle) resolves
serially through either pipeline; batches the general router must take
keep their place. Modelled on tests/test_resolver_pipeline.py.
"""
import dataclasses
import random
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from foundationdb_tpu.core import types as jtypes
from foundationdb_tpu.ops.conflict_kernel import KernelConfig
from foundationdb_tpu.ops.host_engine import JaxConflictEngine
from foundationdb_tpu.ops.oracle import OracleConflictEngine as JaxOracle
from foundationdb_tpu.pipeline import ResolverPipeline as JaxPipeline
from foundationdb_tpu_torch.core import types as ttypes
from foundationdb_tpu_torch.ops import conflict_kernel as tck
from foundationdb_tpu_torch.ops.host_engine import TorchConflictEngine
from foundationdb_tpu_torch.ops.oracle import OracleConflictEngine
from foundationdb_tpu_torch.pipeline import ResolverPipeline

torch.set_num_threads(1)

CFG = KernelConfig(key_words=2, capacity=2048, max_txns=128, max_reads=32,
                   max_writes=32, max_point_reads=256, max_point_writes=256)
LADDER = (32, 64)
SCANS = (2, 4)
#: the JAX engines' compiled programs, built once for the module: a program
#: takes the table as an argument, so engines of one config can share them
_JAX_PROGRAMS = {}


def port_cfg(cfg):
    fields = dataclasses.asdict(cfg)
    fields.pop("fixpoint")
    return tck.KernelConfig(**fields)


def engine():
    return TorchConflictEngine(port_cfg(CFG), device="cpu", ladder=LADDER, scan_sizes=SCANS)


def jax_engine():
    eng = JaxConflictEngine(CFG, ladder=list(LADDER), scan_sizes=SCANS, heat_buckets=0)
    eng._programs = _JAX_PROGRAMS
    return eng


def make_batches(seed, types, n_batches=14, range_every=5):
    """Point-only batches of 1-400 txns (every bucket, multi-chunk), GC
    trailing by 4 batches, some snapshots too old; every `range_every`-th
    batch also carries a range read, which the general router takes. The
    transactions are `types`' CommitTransaction (either package's): one
    seed gives the same stream in both."""
    rng = random.Random(seed)
    v, out = 1000, []
    for b in range(n_batches):
        v += 1000
        txns = []
        for _ in range(rng.choice([rng.randrange(1, 40), rng.randrange(40, 400)])):
            lag = rng.randrange(4500, 6000) if rng.random() < 0.1 else rng.randrange(1, 1500)
            t = types.CommitTransaction(read_snapshot=max(0, v - lag))
            for _ in range(rng.randrange(0, 3)):
                k = b"p/%04d" % rng.randrange(250)
                t.read_conflict_ranges.append(types.KeyRange(k, k + b"\x00"))
            for _ in range(rng.randrange(0, 3)):
                k = b"p/%04d" % rng.randrange(250)
                t.write_conflict_ranges.append(types.KeyRange(k, k + b"\x00"))
            txns.append(t)
        if range_every and b % range_every == range_every - 1:
            txns[0].read_conflict_ranges.append(types.KeyRange(b"p/0010", b"p/0100"))
        out.append((txns, v, max(0, v - 4000)))
    return out


def serial_verdicts(batches, eng):
    return [[int(x) for x in eng.resolve(txns, v, old)] for txns, v, old in batches]


def pipelined(pipeline_cls, eng, batches, depth, executor=None, youngest_first=False):
    """Verdicts of every batch submitted to a pipeline, forced in order, or
    the youngest first; the pipeline checked empty after."""
    pipe = pipeline_cls(eng, depth=depth, executor=executor)
    handles = [pipe.submit(txns, v, old) for txns, v, old in batches]
    got = [None] * len(handles)
    order = list(range(len(handles)))
    if youngest_first:
        order = order[-1:] + order[:-1]
    for i in order:
        got[i] = [int(x) for x in handles[i].result()]
    assert pipe.in_flight == 0
    return got


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("use_executor", [False, True])
def test_pipeline_parity(depth, use_executor):
    seed = 601 + depth
    batches = make_batches(seed, ttypes)
    jbatches = make_batches(seed, jtypes)
    want = serial_verdicts(jbatches, JaxOracle())
    assert serial_verdicts(batches, engine()) == want
    assert serial_verdicts(batches, OracleConflictEngine()) == want
    assert all(any(v in w for w in want) for v in (0, 1, 2))    # every verdict occurs
    ex = ThreadPoolExecutor(1) if use_executor else None
    try:
        eng, jeng = engine(), jax_engine()
        got = pipelined(ResolverPipeline, eng, batches, depth, ex)
        jgot = pipelined(JaxPipeline, jeng, jbatches, depth, ex)
    finally:
        if ex is not None:
            ex.shutdown()
    assert jgot == want
    assert got == want
    assert sum(eng.perf.scan_dispatches.values()) > 0
    assert eng.perf.scan_dispatches == dict(jeng.perf.scan_dispatches)
    assert eng.perf.bucket_hits == dict(jeng.perf.bucket_hits)


@pytest.mark.parametrize("depth", [2, 3])
def test_pipeline_interleaved_forcing(depth):
    """result() of a late batch first still forces in version order, in
    both packages' pipelines."""
    batches = make_batches(77, ttypes, range_every=0)
    jbatches = make_batches(77, jtypes, range_every=0)
    want = serial_verdicts(jbatches, JaxOracle())
    assert serial_verdicts(batches, engine()) == want
    assert pipelined(JaxPipeline, jax_engine(), jbatches, depth, youngest_first=True) == want
    assert pipelined(ResolverPipeline, engine(), batches, depth, youngest_first=True) == want


def test_pipeline_opaque_engine_fallback():
    """An engine without the pack/dispatch split resolves synchronously and
    gives identical verdicts through either package's pipeline."""
    batches = make_batches(31, ttypes)
    jbatches = make_batches(31, jtypes)
    want = serial_verdicts(jbatches, JaxOracle())
    assert pipelined(JaxPipeline, JaxOracle(), jbatches, 3) == want
    assert pipelined(ResolverPipeline, OracleConflictEngine(), batches, 3) == want


def test_pipeline_drain_and_unsupported_options():
    batches = make_batches(5, ttypes, n_batches=4)
    pipe = ResolverPipeline(engine(), depth=3)
    handles = [pipe.submit(txns, v, old) for txns, v, old in batches]
    assert pipe.in_flight > 0
    pipe.drain()
    assert pipe.in_flight == 0 and all(h.is_done for h in handles)
    with pytest.raises(ValueError):
        ResolverPipeline(engine(), depth=0)
    with pytest.raises(NotImplementedError):
        ResolverPipeline(engine(), batcher=object())
    with pytest.raises(NotImplementedError):
        ResolverPipeline(engine(), conflict_sched=object())
