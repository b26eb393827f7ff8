"""The port's conflict-wire codec (foundationdb_tpu_torch/core/wire.py)
against the JAX package's: byte-equal blocks and classifications on seeded
random ranges (points, real ranges, empty reads, keys past any window),
conflict_unwire round trips, and the per-transaction block cache.
"""
import random

import pytest

from foundationdb_tpu.core import wire as jwire
from foundationdb_tpu.core.types import CommitTransaction as JaxTxn
from foundationdb_tpu.core.types import KeyRange as JaxRange
from foundationdb_tpu_torch.core import wire
from foundationdb_tpu_torch.core.types import CommitTransaction, KeyRange


def random_ranges(rng, n, cls=KeyRange):
    """n ranges of every wire kind: points, real ranges, empty reads."""
    out = []
    for _ in range(n):
        k = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 40)))
        kind = rng.randrange(3)
        if kind == 0:
            out.append(cls(k, k + b"\x00"))
        elif kind == 1:
            out.append(cls(k, k + bytes([rng.randrange(1, 256)]) * rng.randrange(1, 3)))
        else:
            out.append(cls(k, k[:rng.randrange(0, len(k) + 1)]))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_blocks_byte_equal_to_jax(seed):
    rng = random.Random(seed)
    for _ in range(40):
        reads = random_ranges(rng, rng.randrange(0, 6))
        writes = random_ranges(rng, rng.randrange(0, 6))
        got = wire.conflict_wire_ex(reads, writes)
        want = jwire.conflict_wire_ex(reads, writes)
        assert got == want
        assert wire.conflict_wire(reads, writes) == jwire.conflict_wire(reads, writes)


@pytest.mark.parametrize("seed", range(3))
def test_unwire_round_trips(seed):
    rng = random.Random(100 + seed)
    for _ in range(40):
        reads = random_ranges(rng, rng.randrange(0, 6))
        writes = random_ranges(rng, rng.randrange(0, 6))
        block = wire.conflict_wire(reads, writes)
        rr, wr = wire.conflict_unwire(block)
        # an empty range [b, e) with e < b travels as [b, b): the same set
        assert rr == [(r.begin, r.end if r.end > r.begin else r.begin) for r in reads]
        assert wr == [(w.begin, w.end if w.end > w.begin else w.begin) for w in writes]
        assert wire.conflict_unwire(block) == jwire.conflict_unwire(block)


def test_classification():
    pt = KeyRange(b"a", b"a\x00")
    assert wire.conflict_wire_ex([pt], [pt])[1:] == (True, 1)
    assert wire.conflict_wire_ex([KeyRange(b"a", b"b")], [])[1:] == (False, 1)
    assert wire.conflict_wire_ex([KeyRange(b"abc", b"abc")], [])[1:] == (False, 3)
    assert wire.conflict_wire_ex([], [KeyRange(b"x" * 30, b"x" * 30 + b"\x00")])[1:] == (True, 30)


def test_transaction_block_cache_invalidation():
    """The block is cached against the range tuples: appending a range or
    replacing one in place encodes anew; the port's transaction gives the
    JAX transaction's block."""
    t = CommitTransaction()
    t.write_conflict_ranges.append(KeyRange(b"a", b"a\x00"))
    b1 = t.conflict_wire_block()
    assert t.conflict_wire_block() is b1
    t.write_conflict_ranges.append(KeyRange(b"b", b"b\x00"))
    b2 = t.conflict_wire_block()
    assert b1 != b2
    rr, wr = wire.conflict_unwire(b2)
    assert rr == [] and wr == [(b"a", b"a\x00"), (b"b", b"b\x00")]
    t.write_conflict_ranges[0] = KeyRange(b"c", b"d")
    info = t.conflict_wire_info()
    assert info[1] is False and wire.conflict_unwire(info[0])[1][0] == (b"c", b"d")
    j = JaxTxn(read_snapshot=5)
    j.set(b"c", b"1")
    j.write_conflict_ranges[0] = JaxRange(b"c", b"d")
    j.write_conflict_ranges.append(JaxRange(b"b", b"b\x00"))
    assert j.conflict_wire_info() == info
