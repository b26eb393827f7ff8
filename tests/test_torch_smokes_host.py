"""The port's host-side smokes against the JAX package's: the strict
exposition parser (both copies), the watchdog's synthetic replay, the
scheduler's contended stream, and the whole watch / sched / telemetry
smokes on the CPU. Every device smoke raises without a card unless asked
for the CPU.
"""
import pytest
import torch

from foundationdb_tpu.tools import heat_smoke as jheat
from foundationdb_tpu.tools import sched_smoke as jsched
from foundationdb_tpu.tools import watch_smoke as jwatch
from foundationdb_tpu_torch.tools import heat_smoke as theat
from foundationdb_tpu_torch.tools import sched_smoke as tsched
from foundationdb_tpu_torch.tools import telemetry_smoke as ttele
from foundationdb_tpu_torch.tools import watch_smoke as twatch

from torch_sim_world import clean_world

torch.set_num_threads(1)

HEAD = "# HELP fdbtpu_x x\n# TYPE fdbtpu_x gauge\n"

EXPOSITIONS = {
    "one_sample": HEAD + 'fdbtpu_x{series="a.b"} 3',
    "bare_sample": HEAD + "fdbtpu_x 1.5",
    "negative": HEAD + 'fdbtpu_x{series="a"} -2',
    "escaped_label": HEAD + 'fdbtpu_x{series="a\\"b"} 1',
    "two_families": HEAD + "fdbtpu_x 1\n# HELP fdbtpu_y y\n# TYPE fdbtpu_y gauge\nfdbtpu_y 2",
    "type_before_help": "# TYPE fdbtpu_x gauge\n# HELP fdbtpu_x x\nfdbtpu_x 1",
    "counter_type": "# HELP fdbtpu_x x\n# TYPE fdbtpu_x counter\nfdbtpu_x 1",
    "sample_before_header": "fdbtpu_x 1\n" + HEAD,
    "foreign_prefix": HEAD + "other_x 1",
    "exponent_value": HEAD + "fdbtpu_x 1e3",
    "unknown_label": HEAD + 'fdbtpu_x{name="a"} 1',
    "unterminated_label": HEAD + 'fdbtpu_x{series="a} 1',
    "trailing_space": HEAD + "fdbtpu_x 1 ",
    "other_family_sample": HEAD + "fdbtpu_y 1",
}


def verdict(parse, text):
    try:
        return ("ok", parse(text))
    except AssertionError:
        return ("malformed", None)


@pytest.mark.parametrize("name", sorted(EXPOSITIONS))
def test_strict_parser_verdicts_equal_both_reference_copies(name):
    text = EXPOSITIONS[name]
    want = verdict(jheat.strict_parse_prometheus, text)
    assert verdict(jwatch.strict_parse_prometheus, text) == want
    assert verdict(theat.strict_parse_prometheus, text) == want
    assert verdict(twatch.strict_parse_prometheus, text) == want


@pytest.mark.parametrize("seed", [7, 2026])
def test_watch_synthetic_replay_equals_reference(seed):
    clean_world()
    _h, twd, twin = twatch.synthetic_replay(seed)
    _h, jwd, jwin = jwatch.synthetic_replay(seed)
    assert twin == jwin
    assert twd.timeline() == jwd.timeline() and len(twd.timeline()) > 0
    assert twd.alerts_snapshot() == jwd.alerts_snapshot()
    assert ([i.as_dict() for i in twd.incidents] == [i.as_dict() for i in jwd.incidents])
    clean_world()


def journal_rows(journal):
    return [(v, [(t.read_snapshot, [(r.begin, r.end) for r in t.read_conflict_ranges],
                  [(r.begin, r.end) for r in t.write_conflict_ranges]) for t in txns],
             oldest, verdicts) for v, txns, oldest, verdicts in journal]


@pytest.mark.parametrize("sched_on", [False, True], ids=["off", "on"])
def test_sched_contended_stream_equals_reference(sched_on):
    clean_world()
    tc, tx, tp, tj, ts = tsched._run_arm(sched_on)
    jc, jx, jp, jj, js = jsched._run_arm(sched_on)
    assert (tc, tx, tp) == (jc, jx, jp)
    assert journal_rows(tj) == journal_rows(jj)
    assert ts.counters == js.counters
    clean_world()


@pytest.mark.parametrize("smoke", [twatch, tsched, ttele], ids=["watch", "sched", "telemetry"])
def test_host_smoke_runs_green_on_cpu(smoke):
    clean_world()
    try:
        out = smoke.run("host")
    finally:
        clean_world()
    assert out["ok"], out["failures"]
    assert out["device"] == "host" and out["failures"] == []


def test_host_smokes_main_exits_zero_with_device_cpu(capsys):
    clean_world()
    try:
        assert twatch.main(["--device", "cpu"]) == 0
        assert tsched.main(["--device", "cpu"]) == 0
    finally:
        clean_world()
    assert '"ok": true' in capsys.readouterr().out


@pytest.mark.parametrize("name", ["heat", "history", "perf", "reshard", "mesh", "crash"])
def test_device_smoke_raises_without_a_card(name, monkeypatch):
    """Asked for the card (the default) where there is none, a device
    smoke raises bench_device's error before it does any work."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"foundationdb_tpu_torch.tools.{name}_smoke")
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        mod.run()
    with pytest.raises(RuntimeError, match="--device cpu"):
        mod.main([])
