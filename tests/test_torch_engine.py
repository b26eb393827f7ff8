"""TorchConflictEngine (on the CPU) against OracleConflictEngine and the JAX
package's JaxConflictEngine on randomized transaction streams: short keys,
long keys through the split-step host tier, too-old transactions, and
batches larger than max_txns (chunking). The same CommitTransaction objects
go to every engine; verdicts compare as ints.
"""
import dataclasses
import random

import numpy as np
import pytest
import torch

from foundationdb_tpu.core.types import CommitTransaction, KeyRange
from foundationdb_tpu.ops.conflict_kernel import KernelConfig
from foundationdb_tpu.ops.host_engine import JaxConflictEngine
from foundationdb_tpu.ops.oracle import OracleConflictEngine
from foundationdb_tpu_torch.core import error as terror
from foundationdb_tpu_torch.core.types import TransactionCommitResult
from foundationdb_tpu_torch.ops import conflict_kernel as tck
from foundationdb_tpu_torch.ops import fixpoint_cuda as fc
from foundationdb_tpu_torch.ops import oracle as toracle
from foundationdb_tpu_torch.ops.host_engine import TorchConflictEngine, make_engine

torch.set_num_threads(1)

SMALL = KernelConfig(key_words=2, capacity=512, max_reads=128, max_writes=128, max_txns=32)
LONG = KernelConfig(key_words=4, capacity=2048, max_txns=32, max_reads=64,
                    max_writes=64, max_point_reads=128, max_point_writes=128)
TINY = KernelConfig(key_words=2, capacity=256, max_reads=8, max_writes=8, max_txns=4)
WINDOW = 16   # 4 * LONG.key_words


def port_cfg(cfg):
    fields = dataclasses.asdict(cfg)
    fields.pop("fixpoint")
    return tck.KernelConfig(**fields)


def ints(verdicts):
    return [int(v) for v in verdicts]


# -- tests/test_kernel_parity.py:23-47 (random.Random in place of
# -- DeterministicRandom) ------------------------------------------------------
def random_key(rng, alphabet=b"ab\x00\xff", maxlen=6):
    n = rng.randrange(0, maxlen + 1)
    return bytes(rng.choice(alphabet) for _ in range(n))


def random_range(rng, allow_empty=False):
    a, b = random_key(rng), random_key(rng)
    if a > b:
        a, b = b, a
    if a == b and not allow_empty:
        b = a + b"\x00"
    return KeyRange(a, b)


def random_txn(rng, version_floor, version_now, allow_empty_reads):
    t = CommitTransaction()
    t.read_snapshot = rng.randrange(max(0, version_floor - 40), version_now)
    for _ in range(rng.randrange(0, 4)):
        t.read_conflict_ranges.append(random_range(rng, allow_empty=allow_empty_reads))
    for _ in range(rng.randrange(0, 4)):
        t.write_conflict_ranges.append(random_range(rng, allow_empty=True))
    return t


def short_stream(seed, batches=30, txns_per_batch=12, allow_empty_reads=True):
    rng = random.Random(seed)
    now, oldest = 10, 0
    for _ in range(batches):
        now += rng.randrange(1, 30)
        if rng.random() < 0.3:
            oldest = max(oldest, now - rng.randrange(20, 120))
        txns = [random_txn(rng, oldest, now, allow_empty_reads)
                for _ in range(rng.randrange(1, txns_per_batch + 1))]
        yield txns, now, oldest


# -- tests/test_long_keys.py:25-65 -------------------------------------------
def make_key(rng, style):
    if style == "short":
        return b"s/%08d" % rng.randrange(200)
    if style == "long":
        return b"L/%08d/" % rng.randrange(40) + b"x" * rng.randrange(8, 1000)
    n = rng.choice([WINDOW - 1, WINDOW, WINDOW + 1])
    return (b"b/%06d" % rng.randrange(60))[:n].ljust(n, b"q")


def long_stream(seed, n_batches=14, long_frac=0.4):
    rng = random.Random(seed)
    v = 1000
    for _ in range(n_batches):
        txns = []
        for _ in range(rng.randrange(1, 10)):
            t = CommitTransaction(read_snapshot=max(0, v - rng.randrange(1, 4000)))

            def style():
                return "long" if rng.random() < long_frac else rng.choice(["short", "edge"])

            for _ in range(rng.randrange(0, 4)):
                k = make_key(rng, style())
                if rng.random() < 0.3:
                    a, b = sorted([k, make_key(rng, style())])
                    t.read_conflict_ranges.append(KeyRange(a, b + b"\x00"))
                else:
                    t.read_conflict_ranges.append(KeyRange(k, k + b"\x00"))
            for _ in range(rng.randrange(1, 4)):
                k = make_key(rng, style())
                if rng.random() < 0.25:
                    a, b = sorted([k, make_key(rng, style())])
                    t.write_conflict_ranges.append(KeyRange(a, b + b"\x00"))
                else:
                    t.write_conflict_ranges.append(KeyRange(k, k + b"\x00"))
            txns.append(t)
        v += rng.randrange(100, 2500)
        yield txns, v, max(0, v - 10_000)


def three_way(cfg, stream, jax_engine=True):
    """Run a stream through the port (CPU), the oracle and (optionally) the
    JAX engine; every batch's verdicts must agree. Returns the verdict
    counts seen, so a test can require a real mix."""
    port = TorchConflictEngine(port_cfg(cfg), device="cpu")
    ora = OracleConflictEngine()
    jeng = JaxConflictEngine(cfg, heat_buckets=0) if jax_engine else None
    seen = set()
    for b, (txns, now, oldest) in enumerate(stream):
        want = ints(ora.resolve(txns, now, oldest))
        got = ints(port.resolve(txns, now, oldest))
        assert got == want, (b, got, want)
        if jeng is not None:
            assert ints(jeng.resolve(txns, now, oldest)) == got, b
        seen.update(got)
    assert fc.FIXPOINT.launches == 0
    return seen, port


@pytest.mark.parametrize("mode", ["fused_sort", "bsearch"])
def test_short_keys_vs_oracle_and_jax(mode):
    seen, _ = three_way(dataclasses.replace(SMALL, history_search=mode), short_stream(7))
    assert seen == {0, 1, 2}      # conflicts, too-old and commits all occur


@pytest.mark.parametrize("seed", [1, 2])
def test_long_keys_split_step_vs_oracle_and_jax(seed):
    _, port = three_way(LONG, long_stream(seed))
    assert port._tier_has_writes and len(port.tier_map) > 1


def test_long_keys_heavy_vs_oracle():
    three_way(LONG, long_stream(99, n_batches=10, long_frac=0.95), jax_engine=False)


def test_chunking_past_max_txns():
    """Batches of 11 txns on a 4-txn shape: the greedy chunker splits them
    on txn boundaries without changing a verdict."""
    rng = random.Random(21)

    def stream():
        now = 50
        for _ in range(12):
            now += 9
            yield [random_txn(rng, 0, now, False) for _ in range(11)], now, 0

    three_way(TINY, stream())


def test_carry_state_from_jax_engine():
    """Run the JAX engine for a while, carry its table, version base and GC
    horizon into the port mid-stream, and continue both: identical verdicts."""
    batches = list(short_stream(31, batches=24))
    jeng = JaxConflictEngine(SMALL, heat_buckets=0)
    for txns, now, oldest in batches[:12]:
        jeng.resolve(txns, now, oldest)
    port = make_engine("torch", port_cfg(SMALL), device="cpu")
    port.load_state({k: np.asarray(v) for k, v in jeng.state.items()},
                    jeng.base, jeng.oldest_version, jeng.tier_map)
    assert port.base == jeng.base and port.base > 0
    for b, (txns, now, oldest) in enumerate(batches[12:]):
        assert ints(port.resolve(txns, now, oldest)) == ints(jeng.resolve(txns, now, oldest)), b


def test_clear_and_verdict_type():
    port = TorchConflictEngine(port_cfg(SMALL), device="cpu")
    ora = toracle.OracleConflictEngine()
    t = CommitTransaction()
    t.write_conflict_ranges.append(KeyRange(b"a", b"b"))
    for e in (port, ora):
        e.resolve([t], 10, 0)
        e.clear(20)
    r = CommitTransaction(read_snapshot=15)
    r.read_conflict_ranges = [KeyRange(b"zzz", b"zzz\x00")]
    got = port.resolve([r], 30, 0)
    assert got == ora.resolve([r], 30, 0) == [TransactionCommitResult.CONFLICT]
    assert isinstance(got[0], TransactionCommitResult)


def test_capacity_errors_carry_the_reference_codes():
    tiny = port_cfg(dataclasses.replace(TINY, capacity=8))
    port = TorchConflictEngine(tiny, device="cpu")
    big = CommitTransaction()
    big.write_conflict_ranges = [KeyRange(b"k%d" % i, b"k%d\x00" % i) for i in range(9)]
    with pytest.raises(terror.FDBError) as e:
        port.resolve([big], 10, 0)
    assert e.value.code == 2000          # client_invalid_operation: one txn > caps
    port = TorchConflictEngine(tiny, device="cpu")
    txns = []
    for i in range(4):
        t = CommitTransaction()
        t.write_conflict_ranges = [KeyRange(b"%d%d" % (i, j), b"%d%d\x00" % (i, j))
                                   for j in range(2)]
        txns.append(t)
    with pytest.raises(terror.FDBError) as e:
        port.resolve(txns, 10, 0)
    assert e.value.code == 2101          # conflict_capacity_exceeded
    with pytest.raises(ValueError):
        make_engine("jax", port_cfg(SMALL), device="cpu")
