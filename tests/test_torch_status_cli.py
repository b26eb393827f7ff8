"""The port's operator tools (foundationdb_tpu_torch/tools/cli.py and
fdbbackup.py) against the JAX package's.

Every case of tests/test_status_cli.py runs on both packages with oracle
resolvers: the printed text and the world the simulation leaves behind
(torch_sim_world.world_state) must be equal. The same commands then run
over CPU torch resolvers in the port, held to JAX's oracle-resolver text.
The cluster-less file views (heat, alerts, incidents, chaos-status,
atlas, shards, trace, explain, blackbox, recovery) render the same files
to byte-equal text in both packages, and `cli lint` runs the port's own
fdbtpu-lint (tests/test_torch_lint.py holds it against the reference's)."""
import contextlib
import io
import json

import pytest
import torch

from test_forensics import journal  # noqa: F401  (the hand-scripted journal fixture)
from test_torch_trace_export import WINDOWS, trace_set
from torch_sim_world import BOTH, JAX, PORT, both, clean_world, sims_built, world_state


@pytest.fixture(autouse=True)
def _clean():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    clean_world()
    yield
    clean_world()
    torch.set_num_threads(threads)


def _factory(P, resolvers):
    """The resolvers of a case's cluster: the oracle (both packages'
    default), or the port's torch engine on the CPU."""
    if resolvers == "torch":
        assert P is PORT
        return P.specs.make_engine_factory(device="cpu")
    return P.oracle.OracleConflictEngine


def _cluster(P, seed, resolvers="oracle", **kw):
    cfg = P.cluster.DynamicClusterConfig(engine_factory=_factory(P, resolvers), **kw)
    return P.cluster.build_dynamic_cluster(seed=seed, cfg=cfg)


def _drive(c, coro, until=60.0):
    return c.sim.run_until(c.sim.sched.spawn(coro, name="w"), until=until)


# -- tests/test_status_cli.py's cases, as case(P) ------------------------------

def status_document(P, resolvers="oracle"):
    c = _cluster(P, 71, resolvers)
    db = c.new_client()

    async def work():
        async def w(tr):
            tr.set(b"x", b"1")
        await db.run(w)
        await P.loop.delay(1.0)
        return await db.get_status()

    doc = _drive(c, work())
    cl = doc["cluster"]
    assert cl["recovery_state"] == "fully_recovered" and cl["generation"] >= 1
    assert len(cl["proxies"]) == 1 and cl["version"] > 0
    assert len(doc["storage"]) == 2 and len(cl["workers"]) == 5
    assert len(doc["data"]["shards"]) == 2
    # the resolver telemetry fragment is the engine's own: compared apart
    doc["qos"].pop("resolver_telemetry", None)
    return json.loads(json.dumps(doc, default=str)), world_state(P, c.sim)


def cli_shards_and_move(P, resolvers="oracle"):
    c = _cluster(P, 171, resolvers, n_workers=8)
    out = io.StringIO()
    cli = P.cli.Cli(c, out=out)
    c.sim.run(until=8.0)
    cli.run_command("set mk mv")
    cli.run_command("shards")
    texts = [out.getvalue()]
    assert "tag 0 @" in texts[0] and "tag 1 @" in texts[0]
    storage_addrs = {p.address for p in c.worker_procs
                     if any(t.startswith("storage.getValue") for t in p.handlers)}
    spare = next(p.address for p in c.worker_procs
                 if p.alive and p.address not in storage_addrs)
    for line in (f"move '' {spare}", "get mk"):
        out.seek(0)
        out.truncate(0)
        cli.run_command(line)
        texts.append(out.getvalue())
    assert "new team" in texts[1] and "'mv'" in texts[2]
    return texts, world_state(P, c.sim)


def status_after_kill(P, resolvers="oracle"):
    c = _cluster(P, 72, resolvers)
    db = c.new_client()

    async def setup():
        async def w(tr):
            tr.set(b"x", b"1")
        await db.run(w)
        return await db.get_status()

    doc1 = _drive(c, setup())
    gen1 = doc1["cluster"]["generation"]
    victim_addr = doc1["cluster"]["roles"]["tlogs"][0]
    victim = next(p for p in c.worker_procs if p.address == victim_addr)
    c.sim.kill_process(victim, P.simulator.KillType.REBOOT)
    c.sim.run(until=c.sim.sched.time + 15.0)
    doc2 = _drive(c, db.get_status())
    assert doc2["cluster"]["recovery_state"] == "fully_recovered"
    assert doc2["cluster"]["generation"] > gen1
    return (gen1, doc2["cluster"]["generation"], doc2["cluster"]["recovery_history"],
            world_state(P, c.sim))


CLI_LINES = ["set hello world", "get hello", "getrange a z", "clear hello", "get hello",
             "set 0x00ff 0xdead", "get 0x00ff", "status", "bogus command"]


def cli_commands(P, resolvers="oracle"):
    c = _cluster(P, 73, resolvers)
    out = io.StringIO()
    cli = P.cli.Cli(c, out=out)
    c.sim.run(until=3.0)
    for line in CLI_LINES:
        assert cli.run_command(line)
    assert not cli.run_command("exit")
    text = out.getvalue()
    for want in ("'world'", "<not found>", "0xdead", "recovery state     - fully_recovered",
                 "unknown command", "1 row(s)"):
        assert want in text
    return text, world_state(P, c.sim)


def resolver_telemetry(P, resolvers="oracle"):
    c = _cluster(P, 77, resolvers)
    db = c.new_client()

    async def work():
        for i in range(4):
            async def w(tr, i=i):
                tr.set(b"tel%02d" % i, b"v")
            await db.run(w)
        await P.loop.delay(1.0)
        return await db.get_status()

    doc = _drive(c, work())
    tel = doc["qos"]["resolver_telemetry"]
    assert tel
    for frag in tel.values():
        assert frag.get("flight_recorder_entries", 0) > 0
    out = io.StringIO()
    cli = P.cli.Cli(c, out=out)
    texts = []
    for line in ("telemetry", "telemetry json", "perf", "heat"):
        out.seek(0)
        out.truncate(0)
        assert cli.run_command(line)
        texts.append(out.getvalue())
    assert "resolver " in texts[0] and "recent dispatch records" in texts[0]
    assert "resolver_telemetry" in texts[1]
    return texts, world_state(P, c.sim)


def counters_in_status(P, resolvers="oracle"):
    c = _cluster(P, 74, resolvers)
    db = c.new_client()

    async def work():
        for i in range(5):
            async def w(tr, i=i):
                tr.set(b"k%d" % i, b"v")
                await tr.get(b"k0")
            await db.run(w)
        await P.loop.delay(1.0)
        return await db.get_status()

    doc = _drive(c, work())
    (proxy_stats,) = doc["proxy_stats"].values()
    assert proxy_stats["txn_committed"] >= 5 and proxy_stats["txn_start_out"] >= 5
    mutations = sum(s.get("counters", {}).get("mutations", 0) for s in doc["storage"])
    assert mutations >= 5
    return proxy_stats, mutations, world_state(P, c.sim)


def fdbbackup_run(P, personality, resolvers="oracle"):
    argv = [personality, "--seed", "5"]
    if P is PORT:
        argv += (["--engine", "torch", "--device", "cpu"] if resolvers == "torch"
                 else ["--engine", "oracle"])
    buf = io.StringIO()
    with sims_built(P) as sims, contextlib.redirect_stdout(buf):
        rc = P.fdbbackup.main(argv)
    assert rc == 0, buf.getvalue()
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert out.get("verified") is True, out
    return out, [world_state(P, s) for s in sims]


CASES = [status_document, cli_shards_and_move, status_after_kill, cli_commands,
         resolver_telemetry, counters_in_status]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
def test_status_cli_case_equal_to_jax(case):
    port, jax = both(case)
    assert port == jax


@pytest.mark.parametrize("personality", ["restore", "dr"])
def test_fdbbackup_personality_equal_to_jax(personality):
    port, jax = both(fdbbackup_run, personality)
    assert port == jax


@pytest.mark.parametrize("case", [cli_commands, cli_shards_and_move, status_document],
                         ids=lambda f: f.__name__)
def test_status_cli_over_torch_resolvers_equal_to_jax_oracle(case):
    """CPU torch resolvers in the port, the oracle in JAX: the same text and
    the same world (a torch engine draws nothing from the simulation)."""
    clean_world()
    port = case(PORT, "torch")
    clean_world()
    jax = case(JAX)
    assert port == jax


def test_telemetry_perf_heat_over_torch_resolvers():
    """The engine views over CPU torch resolvers show the torch engine's
    ledger rows, perf counters and heat, and the ledger's flops and bytes
    as None."""
    clean_world()
    texts, _ = resolver_telemetry(PORT, "torch")
    tel, tel_json, perf, heat = texts
    assert "compiles=" in tel or "compiles" in tel
    assert "compiles - warmup" in perf and "flops None, bytes None" in perf
    assert "hot ranges" in heat and "split points" in heat


@pytest.mark.parametrize("personality", ["restore", "dr"])
def test_fdbbackup_over_torch_resolvers_equal_to_jax_oracle(personality):
    clean_world()
    port = fdbbackup_run(PORT, personality, "torch")
    clean_world()
    jax = fdbbackup_run(JAX, personality)
    assert port[0] == jax[0]


def test_cli_default_engine_is_the_card():
    """With no --engine the port's tools recruit card resolvers, and with
    no card they raise; nothing falls back to the oracle."""
    for mod in (PORT.cli, PORT.fdbbackup):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main(["status"] if mod is PORT.cli else ["backup"])
    assert PORT.fdbbackup.engine_factory("oracle") is PORT.oracle.OracleConflictEngine


def test_cli_lint_raises_not_implemented():
    """`cli lint` raised NotImplementedError while the port had no linter;
    it no longer does: in both packages it returns the lint's exit code."""
    for P in (PORT, JAX):
        cli = P.cli.Cli.__new__(P.cli.Cli)
        cli.out = io.StringIO()
        try:
            rc = cli.do_lint(["--rules", "span-registry"])
        except NotImplementedError as e:  # pragma: no cover - the failure
            pytest.fail(f"{P.__name__}: cli lint raised {e!r}")
        assert rc == 0


def test_cli_lint_runs_the_ports_lint():
    """`cli lint` runs the port's fdbtpu-lint over the port's tree and
    returns the lint's exit code, as the JAX package's `cli lint` does over
    its own tree: a clean JSON report in both, and `main(["lint", ...])`
    returns 0 with the text report."""
    for P in (PORT, JAX):
        cli = P.cli.Cli.__new__(P.cli.Cli)
        cli.out = io.StringIO()
        assert cli.do_lint(["--json", "--rules", "span-registry,blackbox-registry"]) == 0
        report = json.loads(cli.out.getvalue())
        assert report["new"] == [] and report["stale_baseline"] == []
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert PORT.cli.main(["lint", "--rules", "host-sync"]) == 0
    assert "no new findings" in out.getvalue()


# -- the cluster-less file views ----------------------------------------------

def _render(P, method, args):
    out = io.StringIO()
    cli = P.cli.Cli.__new__(P.cli.Cli)
    cli.out = out
    getattr(cli, method)(args)
    return out.getvalue()


def _write(tmp_path, name, doc):
    p = tmp_path / name
    p.write_text(doc if isinstance(doc, str) else json.dumps(doc))
    return str(p)


@pytest.fixture
def view_files(tmp_path, journal):  # noqa: F811
    """One file per view, built once and rendered by both packages."""
    import numpy as np

    from foundationdb_tpu_torch.ops.conflict_kernel import KernelConfig
    from foundationdb_tpu_torch.ops.host_engine import TorchConflictEngine
    from foundationdb_tpu_torch.tools.ladder_bench import make_point_txns

    eng = TorchConflictEngine(KernelConfig(key_words=4, capacity=1024, max_reads=64,
                                           max_writes=64, max_txns=64),
                              heat_buckets=16, device="cpu")
    rng = np.random.default_rng(9)
    v = 1_000
    for _ in range(3):
        v += 300
        eng.resolve(make_point_txns(24, 64, rng, v), v, 0)
    files = {}
    files["heat"] = _write(tmp_path, "heat_report.json", {"campaigns": [
        {"cfg_seed": 5, "engine_mode": "torch", "heat": eng.heat_snapshot()}]})
    files["heat_bench"] = _write(tmp_path, "heat_bench.json", {"parsed": {"conflict_heat": {
        "sweep": [{"s": 0.9, "heat": eng.heat_snapshot()}]}}})
    inc = {"id": 1, "t0": 1.0, "t1": 2.0, "explained": True,
           "explanation": "overlaps injected partition",
           "summary": "slo_p99_burn firing · overlaps partition window · dominant=server_resolve",
           "alerts": [{"name": "slo_p99_burn", "kind": "burn", "series": "commit",
                       "value": 9.0, "detail": "x"}],
           "windows": [{"kind": "partition", "t0": 0.9, "t1": 2.1}],
           "health": [{"t": 1.1, "label": "r1", "state": "probation"}],
           "root_cause": {"dominant_segment": "server_resolve", "dominant_ms": 9.0,
                          "client_ms": 12.0, "rid": "r.1"}}
    alerts = [{"name": "slo_p99_burn", "series": "commit", "state": "firing", "value": 9.0,
               "detail": "burn", "fired_count": 1}]
    files["watch"] = _write(tmp_path, "watch.json", {"campaigns": [
        {"cfg_seed": 5, "engine_mode": "oracle", "incidents": [inc], "alerts": alerts}]})
    files["chaos"] = _write(tmp_path, "chaos.json", {"campaigns": [{
        "cfg_seed": 11, "engine_mode": "oracle", "p99_outside_ms": 12.5,
        "parity_checked": 100, "parity_mismatches": 0,
        "chaos_counts": {"partition": 2, "reset": 5},
        "engine_stats": {"failovers": 1, "swap_backs": 1}}]})
    files["atlas_old"] = _write(tmp_path, "atlas_old.json", {"campaigns": [
        {"cfg_seed": 11, "engine_mode": "jax", "p99_outside_ms": 12.5,
         "parity_checked": 230, "parity_mismatches": 0},
        {"cfg_seed": 12, "engine_mode": "device_loop"}]})
    files["atlas"] = _write(tmp_path, "atlas.json", {"parsed": {"scenario_atlas": {
        "seed": 4026, "engine_mode": "oracle", "seconds": 3.5, "all_green": 1,
        "scenarios": {"flash_sale": {"slo_pass": 1}},
        "scorecard": [{"scenario": "flash_sale", "slo_pass": 1, "p99_ms": 9.1,
                       "budget_ms": 240.0, "abort_frac": 0.08, "max_abort_frac": 0.35,
                       "throttle_frac": 0.1, "max_throttle_frac": 0.5,
                       "sustained_tps": 66.0, "committed": 210, "reshards_executed": 1}]}}})
    files["garbage"] = _write(tmp_path, "garbage.json", "{nope")
    files["shards"] = _write(tmp_path, "shards.json", {"campaigns": [{
        "cfg_seed": 11, "engine_mode": "jax",
        "reshard": {"executed": 2, "stalled": 0, "in_flight": None,
                    "blackout_ms_max": 5.49, "blackout_budget_ms": 250.0,
                    "blackout_over_budget": 0, "epoch": 2,
                    "shard_map": {"epoch": 2, "flip_version": 900, "n_shards": 3,
                                  "splits": ["k/030", "k/060"],
                                  "history": [{"epoch": 0, "flip_version": 0, "splits": []},
                                              {"epoch": 1, "flip_version": 500,
                                               "splits": ["k/030"]},
                                              {"epoch": 2, "flip_version": 900,
                                               "splits": ["k/030", "k/060"]}]},
                    "ops": [{"id": 1, "kind": "split", "begin": "k/030", "end": None,
                             "state": "done", "blackout_ms": 5.49, "precopied": 15,
                             "delta": 1, "prewarmed": True}]}}]})
    files["old"] = _write(tmp_path, "old.json", {"campaigns": [{
        "cfg_seed": 3, "engine_mode": "jax", "p99_outside_ms": 1.25, "parity_checked": 10,
        "parity_mismatches": 0, "chaos_counts": {"partition": 2},
        "engine_stats": {"failovers": 1, "swap_backs": 1}}]})
    files["forensics"] = _write(tmp_path, "forensics.json", {"campaigns": [{
        "cfg_seed": 5, "engine_mode": "oracle",
        "slo_root_cause": {"rid": "r1.9", "version": 200, "client_ms": 170.0,
                           "dominant_segment": "server_resolve"},
        "blackbox": {"dir": str(journal), "events": 12}}]})
    files["journal"] = str(journal)
    doc = PORT.trace_export.chrome_trace(trace_set(20), WINDOWS)
    files["trace"] = _write(tmp_path, "trace.json", json.dumps(doc, default=str))
    # a journal with snapshot and recovery events (recovery_bench's replay
    # arm journals its stream, snapshots it and recovers twice)
    rdir = tmp_path / "recjournal"
    assert PORT.recovery_bench.run_replay_compare(str(rdir), n_batches=40,
                                                  snap_after=30)["parity_ok"]
    files["recovery_journal"] = str(rdir)
    files["missing"] = str(tmp_path / "nope.json")
    return files


VIEWS = [
    ("do_heat", ["heat"]), ("do_heat", ["heat_bench"]), ("do_heat", ["old"]),
    ("do_heat", ["missing"]), ("do_alerts", ["watch"]), ("do_incidents", ["watch"]),
    ("do_alerts", ["old"]), ("do_incidents", ["old"]), ("do_chaos_status", ["chaos"]),
    ("do_chaos_status", ["old"]), ("do_atlas", ["atlas_old"]), ("do_atlas", ["atlas"]),
    ("do_atlas", ["garbage"]), ("do_shards", ["shards"]), ("do_shards", ["old"]),
    ("do_shards", ["missing"]), ("do_trace", ["trace"]),
    ("do_explain", ["=200", "forensics"]), ("do_explain", ["=--slo", "forensics"]),
    ("do_explain", ["=v200", "journal"]), ("do_explain", ["=100", "old"]),
    ("do_explain", []), ("do_blackbox", ["forensics"]), ("do_blackbox", ["journal"]),
    ("do_blackbox", ["=replay", "=--window", "=v100..v200", "forensics"]),
    ("do_blackbox", ["=replay", "forensics"]), ("do_blackbox", ["old"]),
    ("do_recovery", ["recovery_journal"]), ("do_recovery", ["journal"]),
]


def test_file_views_byte_equal_to_jax(view_files):
    for method, spec in VIEWS:
        args = [a[1:] if a.startswith("=") else view_files[a] for a in spec]
        texts = []
        for P in BOTH:
            clean_world()
            texts.append(_render(P, method, args))
        assert texts[0] == texts[1], (method, spec)
        assert texts[0].strip(), (method, spec)


def test_one_shot_file_views_through_main_equal_to_jax(view_files, capsys):
    """The pre-argparse and cluster-less branches of main() print the same
    text in both packages."""
    for argv in (["chaos-status", view_files["chaos"]], ["heat", view_files["heat"]],
                 ["shards", view_files["shards"]], ["atlas", view_files["atlas"]],
                 ["trace", view_files["trace"]], ["alerts", view_files["watch"]],
                 ["explain", "200", view_files["forensics"]],
                 ["blackbox", view_files["journal"]],
                 ["recovery", view_files["recovery_journal"]]):
        texts = []
        for P in BOTH:
            clean_world()
            assert P.cli.main(list(argv)) == 0
            texts.append(capsys.readouterr().out)
        assert texts[0] == texts[1], argv
