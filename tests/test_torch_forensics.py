"""The port's commit forensics (foundationdb_tpu_torch/tools/forensics.py)
against the JAX package's, over journals the port writes: a resolver role
run in the port's simulator (tests/torch_sim_world.py) and
tests/test_forensics.py's hand-scripted journal. Each package reads the
same directory with its own blackbox reader; explain, render_explain,
diff_replay, strict_parse and summarize must give equal results, and the
port's must pass the reference test's assertions."""
import json

import pytest

from torch_sim_world import BOTH, JAX, PORT, clean_world, drive_resolver_role


@pytest.fixture(autouse=True)
def _clean():
    clean_world()
    yield
    clean_world()


def _jsonable(x):
    return json.loads(json.dumps(x, default=repr))


def _txn(P, reads=(), writes=(), snapshot=0):
    t = P.types.CommitTransaction(read_snapshot=snapshot)
    for k in reads:
        t.read_conflict_ranges.append(P.types.KeyRange(k, k + b"\x00"))
    for k in writes:
        t.write_conflict_ranges.append(P.types.KeyRange(k, k + b"\x00"))
    return t


def scripted_journal(P, d):
    """tests/test_forensics.py's journal, written by package P."""
    bb = P.blackbox
    t = [0.0]
    bb.install(bb.BlackboxJournal(str(d), now_fn=lambda: t[0], proc="test"))
    try:
        bb.record_admission("admission", 90, 10, rate=120.0, weights={"hot": 1.5})
        bb.record_heat({"conflicts": 3, "occupancy_frac": 0.25, "concentration": 0.4,
                        "top_range": "hot", "top_share": 0.6})
        t[0] = 1.0
        bb.record_batch([_txn(P, writes=[b"hot"], snapshot=90),
                         _txn(P, writes=[b"cold"], snapshot=90)],
                        100, 0, [2, 2], epoch=0, engine="oracle")
        t[0] = 1.4
        op = type("Op", (), dict(id=1, kind="split", begin="", end=None, donor_sids=[0],
                                 recipient_sid=1, blackout_ms=3.0, error=None))()
        bb.record_reshard(op, "flip", epoch=1, flip_version=150, splits=["m"])
        t[0] = 2.0
        bb.record_batch([_txn(P, reads=[b"hot"], writes=[b"hot"], snapshot=50),
                         _txn(P, writes=[b"x"], snapshot=199),
                         _txn(P, reads=[b"x"], writes=[b"x"], snapshot=199)],
                        200, 10, [0, 2, 0], epoch=1, shard=1, engine="oracle")
        bb.record_span({"Name": "chaos.queue_wait", "Trace": 200, "Begin": 1.9,
                        "End": 1.95, "Proc": "server"})
        bb.record_span({"Name": "chaos.resolve", "Trace": 200, "Begin": 1.95,
                        "End": 1.99, "Proc": "server"})
        bb.record_span({"Name": "server.commit", "Trace": "r1.9", "Begin": 1.88, "End": 2.0,
                        "Proc": "server", "version": 200, "tenant": "hot"})
        bb.record_span({"Name": "client.commit", "Trace": "r1.9", "Begin": 1.85,
                        "End": 2.02, "Proc": "client-hot"})
        bb.record_health("resilient.1", "healthy", "suspect")
        bb.record_incident({"id": 1, "t0": 1.8, "t1": 2.4, "alerts": [{"name": "slo_p99_burn"}],
                            "windows": [{"kind": "partition"}], "explained": True,
                            "explanation": "overlaps injected partition",
                            "summary": "slo_p99_burn firing"})
        bb.record_window({"kind": "partition", "t0": 1.7, "t1": 2.3, "victim": "client-hot"})
    finally:
        bb.uninstall()


def query(P, d, versions, window):
    """Every query side of package P over the journal directory d."""
    events = P.blackbox.read_journal(str(d))
    fx = P.forensics
    out = {"strict_parse": fx.strict_parse(str(d)), "summary": fx.summarize("run", events),
           "diff_replay": fx.diff_replay(events, *window), "explain": {}, "render": {}}
    for v in versions:
        info = fx.explain(events, v)
        out["explain"][v] = info
        out["render"][v] = fx.render_explain(info)
    return _jsonable(out)


@pytest.fixture(scope="module")
def role_journal(tmp_path_factory):
    """A journal written by the port's resolver role (depth 2, buggify on,
    a range read every 5th batch), and its batch versions."""
    clean_world()
    d = tmp_path_factory.mktemp("role_bb")
    replies, _roles, _sim = drive_resolver_role(PORT, 2, journal_dir=d, range_every=5)
    clean_world()
    return d, sorted(replies)


def test_role_journal_queries_equal_jax(role_journal):
    d, versions = role_journal
    picks = versions[::3]
    port = query(PORT, d, picks, (versions[0], versions[-1]))
    jax = query(JAX, d, picks, (versions[0], versions[-1]))
    assert port == jax
    assert port["diff_replay"]["mismatches"] == 0
    assert port["diff_replay"]["window_batches"] >= len(versions)
    assert port["strict_parse"]["batch"] >= len(versions)


def test_role_journal_conflicts_name_a_witness(role_journal):
    d, versions = role_journal
    events = PORT.blackbox.read_journal(str(d))
    conflicts = [c for v in versions for c in PORT.forensics.explain(events, v)["conflicts"]]
    assert conflicts, "the role run aborted nothing"
    assert all(c["witness"] is not None for c in conflicts
               if c.get("verdict", "conflict") == "conflict")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_scripted_journal_queries_equal_jax(tmp_path, writer):
    P = PORT if writer == "port" else JAX
    scripted_journal(P, tmp_path / "bb")
    port = query(PORT, tmp_path / "bb", [100, 200], (100, 200))
    assert port == query(JAX, tmp_path / "bb", [100, 200], (100, 200))
    info = port["explain"]["200"]
    assert set(info["sources"]) >= {"batch", "admission", "routing", "spans", "witness",
                                    "health", "incidents", "faults", "heat"}
    assert info["verdicts"] == {"committed": 1, "conflicts": 2, "too_old": 0}
    assert info["routing"]["epoch"] == 1 and info["routing"]["flip_version"] == 150
    by_txn = {c["txn"]: c for c in info["conflicts"]}
    assert by_txn[0]["witness"]["witness_version"] == 100
    assert by_txn[2]["witness"]["intra_batch"] and by_txn[2]["witness"]["key"] == "x"
    text = "\n".join(port["render"]["200"])
    assert "first witness write @ v100" in text and "same batch, earlier in order" in text
    assert port["diff_replay"]["mismatches"] == 0 and port["diff_replay"]["epochs"] == [0, 1]


def test_journal_bytes_equal_across_writers(tmp_path):
    from torch_sim_world import journal_bytes

    for P in BOTH:
        scripted_journal(P, tmp_path / P.name)
    assert journal_bytes(tmp_path / PORT.name) == journal_bytes(tmp_path / JAX.name)


def test_corrupted_verdict_and_unknown_version_as_jax(tmp_path):
    scripted_journal(PORT, tmp_path / "bb")
    out = []
    for P in BOTH:
        events = P.blackbox.read_journal(str(tmp_path / "bb"))
        for e in events:
            if e.kind == "batch" and e.payload.version == 200:
                e.payload.verdicts = (2, 2, 0)
        r = P.forensics.diff_replay(events, 100, 200)
        with pytest.raises(P.forensics.ForensicsError) as ei:
            P.forensics.explain(events, 12345)
        out.append((_jsonable(r), str(ei.value)))
    assert out[0] == out[1]
    r, msg = out[0]
    assert r["mismatches"] == 1 and r["mismatch_detail"][0]["version"] == 200
    assert "v100..v200" in msg


@pytest.mark.parametrize("spec", ["v100..v2000", "100..2000", "100"])
def test_parse_window_as_jax(spec):
    got = []
    for P in BOTH:
        try:
            got.append(P.forensics.parse_window(spec))
        except P.forensics.ForensicsError as e:
            got.append(("error", str(e)))
    assert got[0] == got[1]
