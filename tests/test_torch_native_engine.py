"""The port's C++ native conflict engine (foundationdb_tpu_torch/ops/
native_engine.py over csrc/conflict_engine.cpp, built with c++ into
_build/) against the JAX package's NativeConflictEngine and the oracle:
tests/test_native_engine.py's streams, generated once per package from
the same seed (the same rng draws give the same transactions), must give
equal verdicts in every batch."""
import pytest

from torch_sim_world import BOTH, JAX, PORT, both, clean_world


@pytest.fixture(autouse=True)
def _clean():
    clean_world()
    yield
    clean_world()


def random_key(rng, alphabet=b"ab\x00\xff", maxlen=6) -> bytes:
    """tests/test_kernel_parity.py's random_key (the rng of either package)."""
    n = rng.random_int(0, maxlen + 1)
    return bytes(rng.random_choice(alphabet) for _ in range(n))


def random_range(P, rng, allow_empty):
    """tests/test_kernel_parity.py's random_range over package P."""
    a, b = random_key(rng), random_key(rng)
    if a > b:
        a, b = b, a
    if a == b and not allow_empty:
        b = a + b"\x00"
    return P.types.KeyRange(a, b)


def random_txn(P, rng, version_floor, version_now, allow_empty_reads):
    t = P.types.CommitTransaction()
    t.read_snapshot = rng.random_int(max(0, version_floor - 40), version_now)
    for _ in range(rng.random_int(0, 4)):
        t.read_conflict_ranges.append(random_range(P, rng, allow_empty_reads))
    for _ in range(rng.random_int(0, 4)):
        t.write_conflict_ranges.append(random_range(P, rng, True))
    return t


def stream_case(P, seed):
    rng = P.rng.DeterministicRandom(seed)
    native = P.native_engine.NativeConflictEngine()
    oracle = P.oracle.OracleConflictEngine()
    now, oldest, out = 10, 0, []
    for _b in range(60):
        now += rng.random_int(1, 30)
        if rng.random01() < 0.3:
            oldest = max(oldest, now - rng.random_int(20, 120))
        txns = [random_txn(P, rng, oldest, now, True) for _ in range(rng.random_int(1, 14))]
        got = [int(v) for v in native.resolve(txns, now, oldest)]
        assert got == [int(v) for v in oracle.resolve(txns, now, oldest)]
        out.append(got)
    return out, native.boundary_count


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_native_stream_equals_jax_and_oracle(seed):
    port, jax = both(stream_case, seed)
    assert port == jax


def clear_gc_case(P):
    native = P.native_engine.NativeConflictEngine()
    oracle = P.oracle.OracleConflictEngine()
    rng = P.rng.DeterministicRandom(9)
    now, out = 100, []

    def step(txns, now, oldest):
        got = [int(v) for v in native.resolve(txns, now, oldest)]
        assert got == [int(v) for v in oracle.resolve(txns, now, oldest)]
        out.append(got)

    for _ in range(10):
        step([random_txn(P, rng, 0, now, True) for _ in range(6)], now, 0)
        now += 50
    step([random_txn(P, rng, now - 10, now, True) for _ in range(6)], now, now - 10)
    native.clear(now)
    oracle.clear(now)
    step([random_txn(P, rng, now, now + 5, True) for _ in range(6)], now + 5, 0)
    return out


def test_native_clear_and_gc_equals_jax():
    port, jax = both(clear_gc_case)
    assert port == jax


def cluster_case(P):
    c = P.cluster.build_cluster(seed=41, cfg=P.cluster.ClusterConfig(
        n_resolvers=2, n_storage=2, engine_factory=P.native_engine.NativeConflictEngine))
    sim = c.sim
    db = c.new_client()

    async def work():
        for i in range(12):
            async def bump(tr):
                v = await tr.get(b"n")
                tr.set(b"n", str(int(v or b"0") + 1).encode())
            await db.run(bump)

        async def r(tr):
            return await tr.get(b"n")
        return await db.run(r)

    return sim.run_until(sim.sched.spawn(work(), name="w"), until=120.0), sim.sched.time


def test_native_in_cluster_equals_jax():
    port, jax = both(cluster_case)
    assert port == jax and port[0] == b"12"


def test_native_resolve_wire_bytes_in_verdicts_out():
    rng = PORT.rng.DeterministicRandom(3)
    txns = [random_txn(PORT, rng, 0, 50, True) for _ in range(12)]
    a, b = PORT.native_engine.NativeConflictEngine(), PORT.native_engine.NativeConflictEngine()
    got = a.resolve_wire([t.conflict_wire_block() for t in txns],
                         [t.read_snapshot for t in txns], 50, 0)
    assert got == b.resolve(txns, 50, 0)
    with pytest.raises(ValueError, match="malformed"):
        a.resolve_wire([b"\x01\x02"], [0], 60, 0)


def test_native_library_built_by_the_port(monkeypatch):
    """The library is the port's own build of csrc/conflict_engine.cpp in
    _build/; with no C++ compiler on PATH a build raises (no fallback)."""
    from foundationdb_tpu_torch.native import build

    path = build.library_path("conflict_engine")
    PORT.native_engine.lib()
    assert path.is_file() and path.parent == build.BUILD_DIR
    assert build.sources()["conflict_engine"].read_bytes() == \
        (build.PKG_DIR.parent / "foundationdb_tpu" / "native" / "conflict_engine.cpp").read_bytes()
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        build.cxx_compiler()
