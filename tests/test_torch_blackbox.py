"""The port's named-record wire codec and black-box journal against the
JAX package's.

  * wire: every record the port registers (transactions, ranges,
    mutations, the trace context, the journal's BB* records, the
    coordinators' Generation and the coordinated state's DBCoreState and
    LogGenerationInfo) dumps to the same bytes as the JAX package's record
    of the same name with the same field values, and loads back equal, in
    both directions; the enum, nested containers and every scalar tag
    likewise; so does the DynamicClusterConfig adapter, and a fresh
    process decodes a coordinated state from the JAX package's bytes
    through the lazy registrars;
  * the journal: the same record_* calls give byte-identical segment
    files and equal summaries; segment rotation and retention, a reopened
    journal, and partial-tail recovery (a truncated or torn last frame)
    read back the same events in both packages (tests/test_blackbox.py's
    segment cases);
  * the disabled path allocates nothing.

Bytes are compared exactly: tolerance 0.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from torch_sim_world import BOTH, JAX, PORT, clean_world


@pytest.fixture(autouse=True)
def world():
    clean_world()
    yield
    clean_world()


def txn(P, i):
    t = P.types.CommitTransaction(read_snapshot=100 + i)
    t.read_conflict_ranges.append(P.types.KeyRange(b"r%d" % i, b"r%d\x00" % i))
    t.read_conflict_ranges.append(P.types.KeyRange(b"a", b"m"))
    t.set(b"k%d" % i, b"v" * i)
    t.clear(P.types.KeyRange(b"c", b"d"))
    t.atomic_op(b"n", b"\x01\x00", P.types.MutationType.ADD_VALUE)
    t.lock_aware = bool(i % 2)
    return t


def value_for(P, annotation: str, i: int):
    """A non-default value of a field's annotated type."""
    a = annotation
    if a.startswith("Optional["):
        return value_for(P, a[len("Optional["):-1], i)
    if a in ("int", "Version"):
        return -3 + 1000 * i
    if a == "float":
        return 0.125 * (i + 1)
    if a == "str":
        return f"s{i}é"
    if a == "bool":
        return True
    if a in ("bytes", "Key"):
        return b"\x00\xffb%d" % i
    if a in ("Tuple", "tuple"):
        return (i, b"t", ("nested", None), frozenset({1, 2}))
    if a == "Tuple[int, int]":
        return (i, -7 * i)
    if a == "Dict":
        return {"k": i, 3: [1.5, {b"x"}]}
    if a == "Any":
        return [i, "any", {"d": (None, False)}]
    if a == "List[int]":
        return [0, 2, 1, i]
    if a == "List[KeyRange]":
        return [P.types.KeyRange(b"a%d" % i, b"b")]
    if a == "List[Mutation]":
        return [P.types.Mutation(P.types.MutationType.SET_VALUE, b"k", b"v%d" % i)]
    if a == "List[CommitTransaction]":
        return [txn(P, i), txn(P, i + 1)]
    if a == "MutationType":
        return P.types.MutationType.BYTE_MAX
    raise AssertionError(f"no sample for {a}")


def sample(P, cls, i=1):
    fields = dataclasses.fields(cls)
    return cls(**{f.name: value_for(P, f.type, i + k) for k, f in enumerate(fields)})


def port_records():
    return sorted(PORT.wire._RECORDS)


@pytest.mark.parametrize("name", port_records())
def test_record_bytes_equal_jax(name):
    tcls, jcls = PORT.wire._RECORDS[name], JAX.wire._RECORDS[name]
    assert [f.name for f in dataclasses.fields(tcls)] == \
        [f.name for f in dataclasses.fields(jcls)]
    for i in (0, 1, 5):
        t, j = sample(PORT, tcls, i), sample(JAX, jcls, i)
        raw = PORT.wire.dumps(t)
        assert raw == JAX.wire.dumps(j)
        assert PORT.wire.loads(raw) == t
        assert JAX.wire.loads(raw) == j
    # the required fields alone, every other at its default
    assert PORT.wire.dumps(tcls(**{f.name: value_for(PORT, f.type, 0)
                                   for f in dataclasses.fields(tcls)
                                   if f.default is dataclasses.MISSING
                                   and f.default_factory is dataclasses.MISSING})) == \
        JAX.wire.dumps(jcls(**{f.name: value_for(JAX, f.type, 0)
                                for f in dataclasses.fields(jcls)
                                if f.default is dataclasses.MISSING
                                and f.default_factory is dataclasses.MISSING}))


def test_dynamic_cluster_config_adapter_bytes_equal_jax():
    """Every field but the process-local engine factory, under JAX's name."""
    for kw in ({}, dict(n_coordinators=5, n_workers=10, n_tlogs=3, satellite_logs=1, n_dcs=2,
                        inter_dc_latency=0.003, storage_replication=2, log_replication_factor=2,
                        rebalance_min_rows=60, rebalance_interval=2.0,
                        resolver_pipeline={"depth": 2}, resilient_resolver=False)):
        t = PORT.cluster.DynamicClusterConfig(**kw, engine_factory=object)
        j = JAX.cluster.DynamicClusterConfig(**kw)
        raw = PORT.wire.dumps(t)
        assert raw == JAX.wire.dumps(j)
        assert PORT.wire.loads(raw) == PORT.cluster.DynamicClusterConfig(**kw)
        assert JAX.wire.loads(raw) == j
    assert {"Generation", "DBCoreState", "LogGenerationInfo"} <= set(PORT.wire._RECORDS)


def coordinated_state(P):
    """A realistic coordinated state: two log generations, the storage
    tags, resolver splits, an exclusion and a configuration."""
    ls = P.log_system.LogSystemConfig
    return P.coordinated_state.DBCoreState(
        recovery_count=4,
        generations=(P.coordinated_state.LogGenerationInfo(
                         ls(gen_id=(3, 11), tlogs=(("1.0.0.2:1", ".3.11.0"),)), 90210),
                     P.coordinated_state.LogGenerationInfo(
                         ls(gen_id=(4, 12), tlogs=(("1.0.0.3:1", ".4.12.0"),
                                                   ("1.0.0.4:1", ".4.12.1")),
                            replication_factor=2), None)),
        storage_tags=((0, b"", b"\x80", ("1.0.0.5:1",)),),
        resolver_splits=(b"\x80",), excluded=("1.0.0.9:1",), conf=((b"logs", b"3"),))


def test_coordinated_state_decodes_in_a_fresh_process():
    """The coordinators' disks hold DBCoreState records: the port decodes
    the JAX package's bytes in a process that never imported the defining
    modules (core/wire.py's lazy registrars), and writes the same bytes."""
    raw = JAX.wire.dumps(coordinated_state(JAX))
    assert PORT.wire.dumps(coordinated_state(PORT)) == raw
    root = Path(__file__).resolve().parent.parent
    code = ("import sys\n"
            "from foundationdb_tpu_torch.core import wire\n"
            "st = wire.loads(bytes.fromhex(sys.argv[1]))\n"
            "print(type(st).__module__, wire.dumps(st).hex())\n")
    out = subprocess.run([sys.executable, "-c", code, raw.hex()], cwd=root, capture_output=True,
                         text=True, timeout=120, check=True,
                         env=dict(os.environ, PYTHONPATH=str(root)))
    module, back = out.stdout.split()
    assert module == "foundationdb_tpu_torch.server.coordinated_state"
    assert bytes.fromhex(back) == raw


def test_the_port_registers_what_the_journal_needs():
    names = set(PORT.wire._RECORDS)
    assert {"CommitTransaction", "KeyRange", "Mutation", "TraceContext"} <= names
    # the same registry as JAX's: the resolver's messages cross the
    # simulated network as objects, never as wire records
    assert names <= set(JAX.wire._RECORDS)
    assert not names & {"ResolveTransactionBatchRequest", "ResolveTransactionBatchReply"}
    assert set(PORT.blackbox.BLACKBOX_EVENT_REGISTRY) == set(JAX.blackbox.BLACKBOX_EVENT_REGISTRY)
    for kind, cls in PORT.blackbox.BLACKBOX_EVENT_REGISTRY.items():
        assert cls.__name__ == JAX.blackbox.BLACKBOX_EVENT_REGISTRY[kind].__name__
        assert cls.__name__ in names
    assert set(PORT.wire._ENUMS) == {"MutationType"}
    assert list(PORT.types.MutationType) == [PORT.types.MutationType(int(m))
                                             for m in JAX.types.MutationType]


SCALARS = [None, True, False, 0, -1, 2**63, -(2**70), 1.5, -0.0, b"", b"\x00\xff", "", "☃",
           [], (), {}, set(), frozenset(), [1, (2, [3, {4: b"5"}])], {"a": {1, 2}, (1, 2): None},
           frozenset({b"x", 3, "y"})]


@pytest.mark.parametrize("i", range(len(SCALARS)))
def test_plain_values_bytes_equal_jax(i):
    v = SCALARS[i]
    raw = PORT.wire.dumps(v)
    assert raw == JAX.wire.dumps(v)
    assert PORT.wire.loads(raw) == v


def test_codec_errors_match():
    for P in BOTH:
        with pytest.raises(TypeError, match="wire cannot encode object"):
            P.wire.dumps(object())
        with pytest.raises(ValueError, match="bad magic"):
            P.wire.loads(b"\x00\x01")
        with pytest.raises(ValueError, match="unsupported wire format"):
            P.wire.loads(bytes([P.wire.MAGIC, 9, 0]))
        with pytest.raises(ValueError, match="unknown wire record type 'Nope'"):
            P.wire.loads(bytes([P.wire.MAGIC, 1, 10, 8]) + b"Nope" + bytes([0]))


def test_lazy_registrars_are_the_ports_own():
    """A decode-first process resolves records through the lazy registrars:
    every one is a module of the port, named relative to it."""
    import importlib

    for mod in PORT.wire._LAZY_REGISTRARS:
        assert mod.startswith("..")
        assert importlib.import_module(mod, PORT.wire.__package__).__name__.startswith(
            "foundationdb_tpu_torch.")


# ---------------------------------------------------------------------------
# the journal
# ---------------------------------------------------------------------------

def record_everything(P):
    """One call of every producer sink, with package P's values."""
    bb = P.blackbox
    bb.record_batch([txn(P, 1), txn(P, 2)], 500, 100, [2, 0], epoch=3, shard=1,
                    engine="oracle", served_by="device", witness=({"k": b"a"},), proc="1.0.0.1:1")
    bb.record_span({"Name": "resolver.force", "Trace": 500, "Begin": 0.5, "End": 0.75,
                    "Proc": "p", "txns": 2})
    bb.record_health("resilient.r0", "healthy", "suspect")
    bb.record_flight("failover", 500, [{"v": 1}, {"v": 2}])
    bb.record_alert("burn", "sli.commit", "firing", 2, "fast")
    bb.record_incident({"id": 4, "t0": 1.0, "t1": None, "alerts": [{"name": "burn"}],
                        "windows": [{"kind": "partition"}], "explained": True,
                        "explanation": "partition", "summary": "s"})
    op = SimpleNamespace(id=9, kind="split", begin="a", end=None, blackout_ms=1.23456,
                         donor_sids=[0, 1], recipient_sid=2, error=None)
    bb.record_reshard(op, "flip", epoch=2, flip_version=700, splits=[b"m"])
    bb.record_admission("tenant", 10, 2, rate=3.5, weights={"t": 1.0})
    bb.record_heat({"conflicts": 3, "occupancy_frac": 0.5, "concentration": 1.5,
                    "top_range": "a..b", "top_share": 0.25})
    plan = SimpleNamespace(decided={"dispatch": 5, "preabort": 1}, preabort_ranges=[("a", "b")],
                           lane_ranges=[])
    bb.record_sched(plan, 800, lanes=1, pending=2, epoch=1)
    bb.record_window({"kind": "partition", "t0": 1.0, "t1": 2.0, "who": "c0"})
    bb.record_scenario("flash_sale", 7, "step", {"concentration": 2.0, "witnesses": 3})
    bb.record_snapshot(900, 100, 4, 2048, 1.5, path="snap")
    bb.record_recovery({"mode": "complete", "recovered_version": 900, "replayed_batches": 2})
    bb.record_event("health", bb.BBHealth(label="x", prev="a", state="b"), commit_version=5)


def test_journal_bytes_equal_jax(tmp_path):
    out = []
    for P in BOTH:
        d = tmp_path / P.name
        j = P.blackbox.install(P.blackbox.BlackboxJournal(str(d), now_fn=lambda: 1.2345678,
                                                          proc="proc0"))
        assert P.blackbox.enabled() and P.blackbox.active() is j
        record_everything(P)
        summary = j.summary()
        P.blackbox.uninstall()
        assert not P.blackbox.enabled()
        summary.pop("dir")
        events = P.blackbox.read_journal(str(d))
        assert [e.kind for e in events] == [e.kind for e in j.events()]
        out.append((sorted(p.name for p in d.iterdir()),
                    [p.read_bytes() for p in sorted(d.iterdir())], summary,
                    [(e.seq, e.kind, e.commit_version) for e in events]))
        assert events[0].payload.txns[0] == txn(P, 1)
    assert out[0] == out[1]
    assert len(out[0][3]) == 15


def segment_cases(P, tmp_path):
    """tests/test_blackbox.py's segment mechanics, returning what they read."""
    bb, out = P.blackbox, []
    # partial tail: a truncated, then a torn last frame
    d = tmp_path / f"{P.name}-pt"
    bb.install(bb.BlackboxJournal(str(d), now_fn=lambda: 1.0))
    for i in range(10):
        bb.record_health(f"r.{i}", "healthy", "suspect")
    bb.uninstall()
    (path,) = bb._segment_paths(str(d))
    whole = open(path, "rb").read()
    out.append(whole)
    out.append(len(bb.read_segment(path)))
    with open(path, "wb") as f:
        f.write(whole[:-7])
    out.append([e.seq for e in bb.read_segment(path)])
    with open(path, "wb") as f:
        f.write(whole[:-3] + bytes([whole[-3] ^ 0xFF]) + whole[-2:])
    out.append([e.seq for e in bb.read_segment(path)])
    j2 = bb.BlackboxJournal(str(d), now_fn=lambda: 2.0)
    j2.record("health", bb.BBHealth(label="r.x", prev="a", state="b"))
    j2.close()
    evs = bb.read_journal(str(d))
    out.append([(e.seq, e.payload.label) for e in evs])
    # fresh truncates, a plain reopen continues
    d = tmp_path / f"{P.name}-reuse"
    for label, fresh in (("run1", False), ("run2", False), ("run3", True)):
        j = bb.BlackboxJournal(str(d), now_fn=lambda: 1.0, fresh=fresh)
        j.record("health", bb.BBHealth(label=label, prev="a", state="b"))
        j.close()
        out.append([(e.seq, e.payload.label) for e in bb.read_journal(str(d))])
    # rotation and retention
    d = tmp_path / f"{P.name}-rot"
    bb.install(bb.BlackboxJournal(str(d), segment_bytes=600, max_segments=3, now_fn=lambda: 0.0))
    for i in range(60):
        bb.record_health(f"resilient.{i:03d}", "healthy", "failed")
    bb.uninstall()
    paths = bb._segment_paths(str(d))
    out.append([p.rsplit("/", 1)[-1] for p in paths])
    out.append([open(p, "rb").read() for p in paths])
    seqs = [e.seq for e in bb.read_journal(str(d))]
    assert len(paths) <= 3 and seqs[0] > 0
    assert seqs == list(range(seqs[0], seqs[0] + len(seqs)))
    out.append(seqs)
    # nothing in the directory but foreign files: an empty read
    d = tmp_path / f"{P.name}-empty"
    d.mkdir()
    (d / "bbox-000001.seg").write_bytes(b"junk")
    out.append(bb.read_journal(str(d)))
    return out


def test_segment_mechanics_equal_jax(tmp_path):
    got, want = segment_cases(PORT, tmp_path), segment_cases(JAX, tmp_path)
    assert got == want
    assert got[1] == 10 and got[2] == list(range(9)) and got[3] == list(range(9))
    assert got[4][-1] == (9, "r.x")


def test_disabled_journal_allocates_nothing():
    bb = PORT.blackbox
    before = bb.blackbox_allocations[0]
    assert not bb.enabled()
    record_everything(PORT)
    assert bb.blackbox_allocations[0] == before


def test_journal_from_knobs(tmp_path, monkeypatch):
    from foundationdb_tpu_torch.core.knobs import SERVER_KNOBS as knobs

    bb = PORT.blackbox
    for sel, want in (("", None), ("off", None), ("on", "blackbox"), (str(tmp_path), str(tmp_path))):
        monkeypatch.setattr(knobs, "resolver_blackbox", sel)
        assert bb.knob_directory() == want
    j = bb.journal_from_knobs(proc="p")
    assert j.directory == str(tmp_path) and j.proc == "p"
    j.close()
