"""The binding surface: the port's tuple layer, Subspace and @transactional
against the JAX package's.

The cases of tests/test_bindings.py, written once over a package's modules
and run on both: the same tuples pack to the same bytes and unpack to the
same values; 500 tuples drawn from numpy's default_rng(2026) over every
type the encoder takes (None, bytes, str, ints with big ints of both
signs, floats with the infinities and -0.0, bools, UUIDs, nested tuples)
pack byte-equal across the packages and sort the same; Subspace keys and
ranges are equal; and @transactional runs the same transactions in equal
simulations (values, virtual time, scheduler steps, rng state, disks,
trace events).

Every compared value is bytes, an int, a string, a float or a tuple of
them: tolerance 0 (exact equality).
"""
import random
import uuid

import numpy as np
import pytest

from torch_sim_world import BOTH, JAX, PORT, both, clean_world, world_state


@pytest.fixture(autouse=True)
def world():
    clean_world()
    yield
    clean_world()


ROUNDTRIP = [
    (),
    (None,),
    (b"bytes", "string", 0, 1, -1, 255, -255, 2**40, -(2**40)),
    (3.14, -2.5, 0.0, float("inf")),
    (True, False),
    (uuid.UUID(int=0x1234567890ABCDEF1234567890ABCDEF),),
    (b"with\x00nul", "uniécode"),
    ((1, (b"nested", None)), "after"),
    (None, (None, None), b""),
]


@pytest.mark.parametrize("t", ROUNDTRIP, ids=range(len(ROUNDTRIP)))
def test_tuple_roundtrip_bytes_equal(t):
    packed = [P.fdb_tuple.pack(t) for P in BOTH]
    assert packed[0] == packed[1]
    for P in BOTH:
        assert P.fdb_tuple.unpack(packed[0]) == t


def test_tuple_big_ints_bytes_and_order_equal():
    vals = sorted([0, 1, -1, 2**63, -(2**63), 2**64, -(2**64), 2**200 + 17, -(2**200),
                   2**2000, -(2**2000) + 5])
    packed = {P.name: [P.fdb_tuple.pack((v,)) for v in vals] for P in BOTH}
    assert packed[PORT.name] == packed[JAX.name]
    assert packed[PORT.name] == sorted(packed[PORT.name])
    for P in BOTH:
        assert [P.fdb_tuple.unpack(p) for p in packed[P.name]] == [(v,) for v in vals]
        with pytest.raises(ValueError):
            P.fdb_tuple.pack((1 << (8 * 256),))
        with pytest.raises(ValueError):
            P.fdb_tuple.pack((-(1 << (8 * 256)),))


def random_element(rng, depth=0):
    kind = int(rng.integers(0, 10 if depth < 2 else 9))
    if kind == 0:
        return None
    if kind == 1:
        # half of them dense in NULs and 0xFF, the bytes the escape handles
        alphabet = [0, 0xFF, 1, 0x41] if rng.random() < 0.5 else list(range(256))
        return bytes(rng.choice(alphabet, size=int(rng.integers(0, 8))).tolist())
    if kind == 2:
        return "".join(chr(int(c)) for c in rng.integers(1, 0xD7FF, size=int(rng.integers(0, 6))))
    if kind == 3:
        return int(rng.integers(-(2**63), 2**63 - 1, dtype=np.int64))
    if kind == 4:
        big = int.from_bytes(rng.bytes(int(rng.integers(9, 40))), "big") | (1 << 64)
        return big if rng.random() < 0.5 else -big
    if kind == 5:
        return bool(rng.integers(0, 2))
    if kind == 6:
        return float(rng.choice([float("inf"), float("-inf"), -0.0, 0.0,
                                 float(rng.normal(0.0, 1e6)), float(rng.uniform(-1.0, 1.0))]))
    if kind == 7:
        return uuid.UUID(bytes=rng.bytes(16))
    if kind == 8:
        return int(rng.integers(-300, 300))
    return tuple(random_element(rng, depth + 1) for _ in range(int(rng.integers(0, 4))))


def random_tuples(n=500, seed=2026):
    rng = np.random.default_rng(seed)
    return [tuple(random_element(rng) for _ in range(int(rng.integers(0, 5)))) for _ in range(n)]


def test_500_random_tuples_bytes_equal_and_sort_the_same():
    tuples = random_tuples()
    packed = {P.name: [P.fdb_tuple.pack(t) for t in tuples] for P in BOTH}
    assert packed[PORT.name] == packed[JAX.name]
    for P in BOTH:
        # NaN-free by construction, so every value round-trips to itself
        assert [P.fdb_tuple.unpack(p) for p in packed[P.name]] == tuples
    order = {name: sorted(range(len(tuples)), key=lambda i: ps[i]) for name, ps in packed.items()}
    assert order[PORT.name] == order[JAX.name]
    ranges = {P.name: [P.fdb_tuple.range_of(t) for t in tuples] for P in BOTH}
    assert ranges[PORT.name] == ranges[JAX.name]


def test_tuple_order_preservation_same_in_both():
    """Packed byte order equals typed order for same-type comparisons, in
    both packages, over tests/test_bindings.py's seeded pairs."""
    rng = random.Random(5)
    for _ in range(300):
        kind = rng.randrange(3)
        if kind == 0:
            a = (rng.randrange(-(2**32), 2**32), rng.randrange(0, 100))
            b = (rng.randrange(-(2**32), 2**32), rng.randrange(0, 100))
        elif kind == 1:
            a = (bytes(rng.randrange(0, 256) for _ in range(rng.randrange(0, 5))),)
            b = (bytes(rng.randrange(0, 256) for _ in range(rng.randrange(0, 5))),)
        else:
            a = (rng.uniform(-1e9, 1e9),)
            b = (rng.uniform(-1e9, 1e9),)
        pa, pb = PORT.fdb_tuple.pack(a), PORT.fdb_tuple.pack(b)
        assert (pa, pb) == (JAX.fdb_tuple.pack(a), JAX.fdb_tuple.pack(b))
        assert (a < b) == (pa < pb) and (a == b) == (pa == pb), (a, b)


def test_prefix_extension_sorts_inside_range_in_both():
    rng = random.Random(7)
    for _ in range(100):
        base = (rng.randrange(0, 1000), "cat")
        ext = base + (rng.randrange(0, 1000),)
        lo, hi = PORT.fdb_tuple.range_of(base)
        assert (lo, hi) == JAX.fdb_tuple.range_of(base)
        assert lo <= PORT.fdb_tuple.pack(ext) < hi


def subspace_case(P):
    s = P.bindings.Subspace(("app", 7))
    key = s.pack(("user", 42))
    assert s.contains(key) and s.unpack(key) == ("user", 42)
    nested = s["user"]
    assert nested.pack((42,)) == key
    lo, hi = s.range(("user",))
    assert lo <= key < hi
    assert not P.bindings.Subspace(("other",)).contains(key)
    raw = P.bindings.Subspace(("x",), raw_prefix=b"\x15pre")
    return (s.key(), key, nested.key(), (lo, hi), raw.key(), raw.pack((None, 1.5)),
            s.subspace(("a", b"b")).key())


def test_subspace_equal():
    port, jax_ = both(subspace_case)
    assert port == jax_


def transactional_case(P):
    c = P.cluster.build_cluster(seed=81, cfg=P.cluster.ClusterConfig(n_resolvers=1, n_storage=2))
    db = c.new_client()
    users = P.bindings.Subspace(("users",))
    transactional = P.bindings.transactional

    @transactional
    async def add_user(tr, uid, name):
        tr.set(users.pack((uid,)), name.encode())

    @transactional
    async def rename_all(tr, suffix):
        lo, hi = users.range()
        rows = await tr.get_range(lo, hi)
        for k, v in rows:
            tr.set(k, v + suffix.encode())
        return len(rows)

    @transactional
    async def read(tr):
        return await tr.get(users.pack((2,)))

    async def work():
        await add_user(db, 1, "ada")
        await add_user(db, 2, "grace")
        n = await rename_all(db, "!")
        # composes into an existing transaction too
        return n, await read(db.create_transaction())

    got = c.sim.run_until(c.sim.sched.spawn(work(), name="w"), until=60.0)
    assert got == (2, b"grace!")
    return got, world_state(P, c.sim)


def test_transactional_decorator_equal():
    port, jax_ = both(transactional_case)
    assert port == jax_
