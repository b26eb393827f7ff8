"""The port's fdbtpu-lint (foundationdb_tpu_torch/tools/lint/) against the
reference's (foundationdb_tpu/tools/lint/).

1. The four package-neutral rules (determinism, span-registry,
   blackbox-registry, knob-drift) give the same findings in both packages
   on the same planted fixture, one fixture tree per package layout: the
   fire and quiet cases of tests/test_lint.py. Findings compare by rule,
   path and message with the package prefix removed, and line.
2. The framework gives the same results in both packages: suppressions
   with and without a reason, on the line above, for another rule; the
   baseline round trip and stale detection; restricted runs; exit codes.
3. The torch rules (host-sync, recompile, donation) fire on planted
   fixtures and stay quiet in drain points, annotated functions, capture
   functions and the owners of the static buffers.
4. The port's own tree: no unbaselined finding, no stale baseline entry,
   a baseline that only shrinks or holds, a reason on every suppression;
   each of its sanctioned syncs is visible to host-sync once its
   drain-point annotation is taken out; `cli lint` propagates the lint's
   exit code.

Pure AST on both sides: nothing here builds an engine.
"""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import foundationdb_tpu.tools.lint as JLINT
import foundationdb_tpu_torch.tools.lint as TLINT
from foundationdb_tpu.tools.cli import main as jax_cli_main
from foundationdb_tpu_torch.tools.cli import main as port_cli_main
from foundationdb_tpu_torch.tools.lint import core as tcore

REPO = Path(__file__).resolve().parent.parent
PORT_PKG = "foundationdb_tpu_torch"
JAX_PKG = "foundationdb_tpu"
#: (lint package, package directory, cli main) per side
SIDES = {"jax": (JLINT, JAX_PKG, jax_cli_main),
         "port": (TLINT, PORT_PKG, port_cli_main)}
NEUTRAL = ("determinism", "span-registry", "blackbox-registry", "knob-drift")
TORCH_RULES = ("host-sync", "recompile", "donation")

#: the shrink-or-hold pin of the port's baseline
#: (foundationdb_tpu_torch/tools/lint/baseline.json): this PR leaves it
#: empty, as the reference's is.
PORT_BASELINE_CEILING = 0
#: live suppressions in the port's tree: the reference's two wall-mode
#: clock defaults, and the device loop's partial fill (one line, two
#: slices)
PORT_SUPPRESSION_CEILING = 4


def _write(root: Path, rel: str, text: str) -> Path:
    p = root / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(text)
    return p


def _plant(root: Path, pkg: str, files) -> None:
    """Write a fixture tree; `{pkg}` in a path names the package dir."""
    for rel, text in files.items():
        _write(root, rel.format(pkg=pkg), text)


def _strip(s: str) -> str:
    return s.replace(PORT_PKG + "/", "").replace(JAX_PKG + "/", "")


def _norm(findings):
    return sorted((f.rule, _strip(f.path), f.line, _strip(f.message))
                  for f in findings)


def _port_lint(root: Path, **kw):
    return tcore.run_lint(root, TLINT.CHECKERS, **kw)


# -- 1. package-neutral rules: same findings on the same fixture --------------

KNOBS_FIXTURE = (
    "class K:\n"
    "    def init(self, *a, **k):\n"
    "        pass\n"
    "k = K()\n"
    "k.init('resolver_wired', 2.5)\n"
    "k.init('resolver_unreferenced', 1)\n"
    "k.init('resolver_undocumented', 3)\n"
)
SEGMENTS_FIXTURE = "ATTRIBUTION_SEGMENTS = (\n    'queue_wait',\n    'force',\n)\n"
BLACKBOX_FIXTURE = (
    "BLACKBOX_EVENT_REGISTRY = {\n"
    "    'batch': BBBatch,\n"
    "    'health': BBHealth,\n"
    "}\n"
    "def helper(j):\n"
    "    j.record('batch', None)\n"
    "    j.record('mystery', None)\n"
)

#: name -> (rule, fixture files, expected finding count)
NEUTRAL_CASES = {
    "determinism_wall_clock_and_random": ("determinism", {
        "{pkg}/sim/bad.py": ("import time\nimport random\ndef stamp(ev):\n"
                             "    ev.detail(t=time.time(), r=random.randrange(4))\n"),
    }, 2),
    "determinism_import_aliases": ("determinism", {
        "{pkg}/core/bad.py": ("import time as _t\nfrom time import monotonic as mono\n"
                              "CLOCK = _t.monotonic\nCLOCK2 = mono\n"),
    }, 2),
    "determinism_quiet_perf_counter_and_rng": ("determinism", {
        "{pkg}/sim/good.py": ("import time\nfrom ..core.rng import DeterministicRandom\n"
                              "def measure(rng: DeterministicRandom):\n"
                              "    t0 = time.perf_counter()\n"
                              "    return rng.random01(), time.perf_counter() - t0\n"),
    }, 0),
    "determinism_set_iteration_feeding_sink": ("determinism", {
        "{pkg}/server/bad.py": ("def emit(keys, span_event):\n    for k in set(keys):\n"
                                "        span_event('resolver.retry', k)\n"),
        "{pkg}/server/good.py": ("def emit(keys, span_event):\n"
                                 "    for k in sorted(set(keys)):\n"
                                 "        span_event('resolver.retry', k)\n"
                                 "def no_sink(keys):\n    return [k for k in set(keys)]\n"),
    }, 1),
    "determinism_policy_exempts_real_and_tools": ("determinism", {
        "{pkg}/real/ok.py": "import time\nDEADLINE = time.time() + 60\n",
        "{pkg}/tools/ok.py": "import time\nDEADLINE = time.time() + 60\n",
        "{pkg}/sim/bad.py": "import time\nDEADLINE = time.time() + 60\n",
    }, 1),
    "determinism_rng_module_exempt": ("determinism", {
        "{pkg}/core/rng.py": "import random\nR = random.Random(1)\n",
        "{pkg}/pipeline/bad.py": "import random\nR = random.Random(1)\n",
    }, 1),
    "span_registry_unregistered_segment": ("span-registry", {
        "{pkg}/pipeline/latency_harness.py": SEGMENTS_FIXTURE,
        "{pkg}/server/bad.py": ("def f(span_event, v, loop):\n"
                                "    span_event('resolver.mystery_phase', v, 0, 1)\n"
                                "    span_event('resolver.queue_wait' if loop else\n"
                                "               'resolver.other_phase', v, 0, 1)\n"
                                "    span_event('proxy.not_checked', v, 0, 1)\n"),
    }, 2),
    "span_registry_quiet_registered": ("span-registry", {
        "{pkg}/pipeline/latency_harness.py": SEGMENTS_FIXTURE,
        "{pkg}/server/good.py": ("def f(span_event, v):\n"
                                 "    span_event('resolver.queue_wait', v, 0, 1)\n"
                                 "    span_event('engine.force', v, 0, 1)\n"),
    }, 0),
    "span_registry_device_track_unregistered": ("span-registry", {
        "{pkg}/pipeline/latency_harness.py": SEGMENTS_FIXTURE,
        "{pkg}/ops/engine.py": ("def f(span_event, v):\n"
                                "    span_event('engine.device_time', v, 0, 1, track='device')\n"),
    }, 1),
    "span_registry_extra_registry": ("span-registry", {
        "{pkg}/pipeline/latency_harness.py": SEGMENTS_FIXTURE,
        "{pkg}/server/reshard.py": ("RESHARD_SEGMENTS = ('warm', 'cutover')\n"
                                    "def f(span_event, v):\n"
                                    "    span_event('reshard.warm', v, 0, 1)\n"
                                    "    span_event('reshard.mystery', v, 0, 1)\n"),
    }, 1),
    "blackbox_registry_unregistered_kind": ("blackbox-registry", {
        "{pkg}/core/blackbox.py": BLACKBOX_FIXTURE,
        "{pkg}/server/bad.py": ("def f(record_event, ok):\n"
                                "    record_event('batch', None)\n"
                                "    record_event('unregistered_kind', None)\n"
                                "    record_event('health' if ok else 'other_kind', None)\n"
                                "    obj.record('not_policed_here', None)\n"),
    }, 3),
    "blackbox_registry_quiet_registered": ("blackbox-registry", {
        "{pkg}/core/blackbox.py": BLACKBOX_FIXTURE.replace("    j.record('mystery', None)\n", ""),
        "{pkg}/real/good.py": ("def f(record_event):\n    record_event('batch', None)\n"
                               "    record_event('health', None)\n"),
    }, 0),
    "knob_drift_three_way": ("knob-drift", {
        "{pkg}/core/knobs.py": KNOBS_FIXTURE,
        "{pkg}/server/uses.py": ("from ..core.knobs import SERVER_KNOBS\n"
                                 "a = SERVER_KNOBS.resolver_wired\n"
                                 "b = SERVER_KNOBS.resolver_undocumented\n"
                                 "c = SERVER_KNOBS.resolver_ghost\n"),
        "docs/x.md": ("| knob | default | meaning |\n|---|---|---|\n"
                      "| `resolver_wired` | 9.9 | documented default DRIFTED |\n"
                      "| `resolver_unreferenced` | 1 | fine row |\n"
                      "| `resolver_deleted` | 1 | row for a knob that is gone |\n"),
    }, 5),
    "knob_drift_alias_and_string_references": ("knob-drift", {
        "{pkg}/core/knobs.py": ("class K:\n    def init(self, *a):\n        pass\nk = K()\n"
                                "k.init('resolver_via_alias', 1)\n"
                                "k.init('resolver_via_string', 2)\n"),
        "{pkg}/fault/uses.py": ("from ..core.knobs import SERVER_KNOBS\nk = SERVER_KNOBS\n"
                                "x = k.resolver_via_alias\ny = 'resolver_via_string'\n"),
        "docs/x.md": ("| knob | default | meaning |\n|---|---|---|\n"
                      "| `resolver_via_alias` | 1 | row |\n"
                      "| `resolver_via_string` | 2 | row |\n"),
    }, 0),
    "knob_drift_ignores_non_knob_tables": ("knob-drift", {
        "{pkg}/core/knobs.py": ("class K:\n    def init(self, *a):\n        pass\nk = K()\n"
                                "k.init('resolver_real_knob', 1)\n"),
        "{pkg}/server/uses.py": ("from ..core.knobs import SERVER_KNOBS\n"
                                 "a = SERVER_KNOBS.resolver_real_knob\n"),
        "docs/x.md": ("| alert | meaning |\n|---|---|\n"
                      "| `resolver_stalled` | an alert name, not a knob |\n"
                      "| `resolver_real_knob` | runbook row, still not knob docs |\n\n"
                      "| knob | default | meaning |\n|---|---|---|\n"
                      "| `resolver_real_knob` | 1 | the actual doc row |\n"),
    }, 0),
}


@pytest.mark.parametrize("case", sorted(NEUTRAL_CASES))
def test_neutral_rule_same_findings_in_both_packages(tmp_path, case):
    rule, files, expected = NEUTRAL_CASES[case]
    got = {}
    for side, (L, pkg, _cli) in SIDES.items():
        root = tmp_path / side
        _plant(root, pkg, files)
        res = L.run_lint(root, L.CHECKERS, rules=(rule,))
        assert res.stale_baseline == []
        got[side] = _norm(res.new)
    assert got["port"] == got["jax"]
    assert len(got["port"]) == expected, got["port"]
    assert {f[0] for f in got["port"]} <= {rule}


def test_neutral_rules_are_the_reference_rules():
    port = {c.rule: c for c in TLINT.CHECKERS}
    jax_ = {c.rule: c for c in JLINT.CHECKERS}
    assert set(port) == set(jax_)
    for rule in NEUTRAL:
        assert port[rule].repo_level == jax_[rule].repo_level
        assert port[rule].fronts == jax_[rule].fronts
    for ch in TLINT.CHECKERS:
        assert ch.rule and ch.fronts and ch.description, ch


# -- 2. the framework: same results in both packages --------------------------

def _summary(res):
    return {"new": _norm(res.new), "baselined": _norm(res.baselined),
            "suppressed": sorted((f.rule, _strip(f.path), f.line, s.reason)
                                 for f, s in res.suppressed),
            "stale": len(res.stale_baseline), "ok": res.ok}


def _both(tmp_path, scenario):
    out = {}
    for side, (L, pkg, cli) in SIDES.items():
        root = tmp_path / side
        root.mkdir()
        out[side] = scenario(L, pkg, root, cli)
    assert out["port"] == out["jax"], out
    return out["port"]


def test_suppression_with_reason_is_honoured_in_both(tmp_path):
    def scenario(L, pkg, root, _cli):
        _write(root, f"{pkg}/sim/mod.py",
               "import time\nCLOCK = time.monotonic  # fdbtpu-lint: allow[determinism] "
               "wall-mode default, sim installs its own\n")
        return _summary(L.run_lint(root, L.CHECKERS))
    got = _both(tmp_path, scenario)
    assert got["new"] == [] and len(got["suppressed"]) == 1
    assert "wall-mode default" in got["suppressed"][0][3]


def test_suppression_on_line_above_in_both(tmp_path):
    def scenario(L, pkg, root, _cli):
        _write(root, f"{pkg}/sim/mod.py",
               "import time\n# fdbtpu-lint: allow[determinism] standalone comment form\n"
               "CLOCK = time.monotonic\n")
        return _summary(L.run_lint(root, L.CHECKERS))
    got = _both(tmp_path, scenario)
    assert got["new"] == [] and len(got["suppressed"]) == 1


def test_suppression_without_reason_is_rejected_in_both(tmp_path):
    def scenario(L, pkg, root, _cli):
        _write(root, f"{pkg}/sim/mod.py",
               "import time\nCLOCK = time.monotonic  # fdbtpu-lint: allow[determinism]\n")
        return _summary(L.run_lint(root, L.CHECKERS))
    got = _both(tmp_path, scenario)
    assert sorted({f[0] for f in got["new"]}) == ["determinism", "suppression"]


def test_suppression_for_other_rule_does_not_apply_in_both(tmp_path):
    def scenario(L, pkg, root, _cli):
        _write(root, f"{pkg}/sim/mod.py",
               "import time\nCLOCK = time.monotonic  # fdbtpu-lint: allow[host-sync] wrong rule\n")
        return _summary(L.run_lint(root, L.CHECKERS))
    got = _both(tmp_path, scenario)
    assert [f[0] for f in got["new"]] == ["determinism"]


def test_baseline_round_trip_and_stale_detection_in_both(tmp_path):
    def scenario(L, pkg, root, _cli):
        bad = _write(root, f"{pkg}/sim/mod.py", "import time\nT = time.time()\n")
        steps = []
        res = L.run_lint(root, L.CHECKERS)
        steps.append(_summary(res))
        base_path = root / "baseline.json"
        L.write_baseline(base_path, res.new)
        steps.append(_summary(L.run_lint(root, L.CHECKERS, baseline=L.load_baseline(base_path))))
        bad.write_text("import time\n\n\nT = time.time()\n")      # line-number free
        steps.append(_summary(L.run_lint(root, L.CHECKERS, baseline=L.load_baseline(base_path))))
        bad.write_text("import time\n")                           # fixed: stale
        steps.append(_summary(L.run_lint(root, L.CHECKERS, baseline=L.load_baseline(base_path))))
        data = json.loads(base_path.read_text())
        # the fingerprint hashes the repo-relative path, so it differs
        # between the trees; its form does not
        return steps, data["version"], [(b["rule"], _strip(b["path"]), len(b["fingerprint"]))
                                        for b in data["findings"]]
    steps, version, entries = _both(tmp_path, scenario)
    assert version == 1 and len(entries) == 1
    assert len(steps[0]["new"]) == 1
    assert steps[1]["new"] == [] and len(steps[1]["baselined"]) == 1 and steps[1]["ok"]
    assert steps[2]["new"] == [] and len(steps[2]["baselined"]) == 1
    assert steps[3]["stale"] == 1 and not steps[3]["ok"]


def test_restricted_runs_do_not_report_stale_baseline_in_both(tmp_path):
    def scenario(L, pkg, root, _cli):
        bad = _write(root, f"{pkg}/sim/mod.py", "import time\nT = time.time()\n")
        base_path = root / "baseline.json"
        L.write_baseline(base_path, L.run_lint(root, L.CHECKERS).new)
        base = L.load_baseline(base_path)
        by_rule = L.run_lint(root, L.CHECKERS, baseline=base, rules=("knob-drift",))
        other = _write(root, f"{pkg}/sim/other.py", "x = 1\n")
        by_path = L.run_lint(root, L.CHECKERS, baseline=base, files=[other])
        bad.write_text("import time\n")
        full = L.run_lint(root, L.CHECKERS, baseline=base)
        return _summary(by_rule), _summary(by_path), _summary(full), list(by_rule.rules)
    by_rule, by_path, full, rules = _both(tmp_path, scenario)
    assert by_rule["stale"] == 0 and by_rule["ok"]
    assert by_path["stale"] == 0 and by_path["ok"]
    assert full["stale"] == 1 and not full["ok"]
    assert rules == ["knob-drift", "suppression"]


def test_cli_main_exit_codes_in_both(tmp_path, capsys):
    def scenario(L, pkg, root, _cli):
        _write(root, f"{pkg}/sim/bad.py", "import time\nT = time.time()\n")
        args = ["--root", str(root), "--no-baseline"]
        rcs = [L.main(L.CHECKERS, argv=args)]
        rcs.append("time.time" in capsys.readouterr().out)
        rcs.append(L.main(L.CHECKERS, argv=args + ["/nonexistent.py"]))
        rcs.append("no such file" in capsys.readouterr().err)
        outside = root.parent / f"{root.name}_outside.py"
        outside.write_text("x = 1\n")
        rcs.append(L.main(L.CHECKERS, argv=args + [str(outside)]))
        rcs.append("outside the lint root" in capsys.readouterr().err)
        rcs.append(L.main(L.CHECKERS, argv=args + ["--rules", "typo-rule"]))
        rcs.append("unknown rule" in capsys.readouterr().err)
        good = _write(root, f"{pkg}/sim/good.py", "x = 1\n")
        rcs.append(L.main(L.CHECKERS, argv=args + [str(good)]))
        capsys.readouterr()
        return rcs
    assert _both(tmp_path, scenario) == [1, True, 2, True, 2, True, 2, True, 0]


def test_cli_lint_subcommand_propagates_exit_code_in_both(tmp_path, capsys):
    def scenario(L, pkg, root, cli):
        bad = _write(root, f"{pkg}/sim/bad.py", "import time\nT = time.time()\n")
        rcs = [cli(["lint", "--root", str(root), "--no-baseline"])]
        bad.write_text("x = 1\n")
        rcs.append(cli(["lint", "--root", str(root), "--no-baseline"]))
        capsys.readouterr()
        return rcs
    assert _both(tmp_path, scenario) == [1, 0]


def test_report_layout_equal_in_both(tmp_path, capsys):
    def scenario(L, pkg, root, _cli):
        _write(root, f"{pkg}/sim/bad.py", "import time\nT = time.time()\n")
        _write(root, f"{pkg}/sim/mod.py",
               "import time\n# fdbtpu-lint: allow[determinism] a reason\nC = time.monotonic\n")
        L.main(L.CHECKERS, argv=["--root", str(root), "--no-baseline"])
        return _strip(capsys.readouterr().out)
    text = _both(tmp_path, scenario)
    assert "fdbtpu-lint: 2 files, 7 rules" in text and "new findings:" in text


def test_policy_override_plugs_in_both(tmp_path):
    def scenario(L, pkg, root, _cli):
        _write(root, f"{pkg}/layers/odd.py", "import time\nT = time.time()\n")
        before = _summary(L.run_lint(root, L.CHECKERS))
        policy = dict(L.DEFAULT_POLICY)
        policy["determinism"] = L.RulePolicy(
            packages=(f"{pkg}/layers",), options=L.DEFAULT_POLICY["determinism"].options)
        return before, _summary(L.run_lint(root, L.CHECKERS, policy=policy))
    before, after = _both(tmp_path, scenario)
    assert before["new"] == [] and [f[0] for f in after["new"]] == ["determinism"]


# -- 3. the torch rules -------------------------------------------------------

#: host-sync: one flagged form per case, each in a dispatch-path function
HOST_SYNC_FIRES = {
    "item": "def dispatch(self, out):\n    return out.item()\n",
    "cpu_of_dev": "def dispatch(self, out_dev):\n    return out_dev.cpu()\n",
    "numpy_of_dev": "def dispatch(self, t):\n    return t.status_dev[:4].numpy()\n",
    "tolist_of_device": "def dispatch(self, gc_device):\n    return gc_device.tolist()\n",
    "cuda_synchronize": "import torch\ndef dispatch(self):\n    torch.cuda.synchronize()\n",
    "event_synchronize": "def dispatch(self, done):\n    done.synchronize()\n",
    "stream_synchronize": ("import torch\ndef dispatch(self):\n"
                           "    torch.cuda.current_stream().synchronize()\n"),
    "float_of_dev": "def dispatch(self, x_dev):\n    return float(x_dev)\n",
    "bool_of_dev": "def dispatch(self, t):\n    return bool(t.overflow_dev)\n",
    "int_of_dev": "def dispatch(self, n_dev):\n    return int(n_dev[0])\n",
    "int_of_dev_reduction": "def dispatch(self, merged_dev):\n    return int(merged_dev.sum())\n",
    "bool_of_dev_any": "def dispatch(self, t):\n    return bool(t.overflow_dev.any())\n",
    "cpu_then_numpy_of_dev": "def dispatch(self, st_dev):\n    return st_dev.cpu().numpy()\n",
}


@pytest.mark.parametrize("form", sorted(HOST_SYNC_FIRES))
def test_host_sync_fires(tmp_path, form):
    _write(tmp_path, f"{PORT_PKG}/ops/bad.py", HOST_SYNC_FIRES[form])
    got = [f for f in _port_lint(tmp_path).new if f.rule == "host-sync"]
    assert len(got) == 1, got
    assert "outside a drain point" in got[0].message


@pytest.mark.parametrize("pkg_dir", ["ops", "pipeline", "parallel"])
def test_host_sync_polices_the_dispatch_packages(tmp_path, pkg_dir):
    _write(tmp_path, f"{PORT_PKG}/{pkg_dir}/bad.py", HOST_SYNC_FIRES["item"])
    _write(tmp_path, f"{PORT_PKG}/server/ok.py", HOST_SYNC_FIRES["item"])
    got = [f for f in _port_lint(tmp_path).new if f.rule == "host-sync"]
    assert [f.path for f in got] == [f"{PORT_PKG}/{pkg_dir}/bad.py"]


HOST_SYNC_QUIET = {
    "force_by_name": "def force(self, out_dev):\n    return out_dev.cpu().numpy()\n",
    "drain_loop_by_name": "def drain_loop(self, done):\n    done.synchronize()\n",
    "drain_point_annotation": ("# fdbtpu-lint: drain-point results ready() gated before decode\n"
                               "def _finish(self, out_dev):\n    return int(out_dev.item())\n"),
    "nested_in_drain": ("def outer(self, out_dev):\n    def force():\n"
                        "        return out_dev.tolist()\n    return force\n"),
    "pinned_host_buffer": ("def dispatch(self, res):\n"
                           "    return res['status_host'].numpy(), self.out_pinned.numpy()\n"),
    "host_list": "def host_pack(self, rows):\n    return float(rows[0]), int(len(rows))\n",
}


@pytest.mark.parametrize("form", sorted(HOST_SYNC_QUIET))
def test_host_sync_quiet(tmp_path, form):
    _write(tmp_path, f"{PORT_PKG}/ops/good.py", HOST_SYNC_QUIET[form])
    assert [f for f in _port_lint(tmp_path).new if f.rule == "host-sync"] == []


RECOMPILE_FIRES = {
    "graph_outside_capture": ("import torch\ndef dispatch(self, g):\n"
                              "    with torch.cuda.graph(g):\n        self.step()\n"),
    "graph_alias_outside_capture": ("from torch.cuda import graph\ndef run(self, g):\n"
                                    "    with graph(g):\n        self.step()\n"),
    "capture_begin_outside_capture": "def run(self, g):\n    g.capture_begin()\n",
    "slice_into_static_input": ("def load(self, name, src, n):\n"
                                "    self.inputs[name][:n].copy_(src)\n"),
    "len_into_static_input": ("import torch\ndef load(self, name, rows):\n"
                              "    self.inputs[name][0].copy_(torch.zeros(len(rows)))\n"),
    "slice_of_source": ("def load(self, name, src, n):\n"
                        "    self.inputs[name][0].copy_(src[:n])\n"),
    "program_handle_slice": "def run(prog, rows, n):\n    return prog(rows[:n])\n",
}


@pytest.mark.parametrize("form", sorted(RECOMPILE_FIRES))
def test_recompile_fires(tmp_path, form):
    _write(tmp_path, f"{PORT_PKG}/ops/bad.py", RECOMPILE_FIRES[form])
    got = [f for f in _port_lint(tmp_path).new if f.rule == "recompile"]
    assert len(got) == 1, got


RECOMPILE_QUIET = {
    "graph_in_capture": ("import torch\nclass P:\n    def _capture(self, g):\n"
                         "        with torch.cuda.graph(g):\n            self.step()\n"),
    "graph_in_warmup": ("import torch\ndef warmup(self, g):\n"
                        "    def inner():\n        g.capture_begin()\n    inner()\n"),
    "chunk_index_copy": ("def load(self, name, c, t):\n"
                         "    self.inputs[name][c].copy_(t, non_blocking=True)\n"),
    "constant_slice_copy": ("def load(self, name, t):\n"
                            "    self.inputs[name][:4].copy_(t[0:4])\n"),
    "slice_into_non_static": ("def load(self, out, src, n):\n"
                              "    out[:n].copy_(src[:n])\n"),
    "suppressed_partial_fill": ("def load(self, name, src, n):\n"
                                "    # fdbtpu-lint: allow[recompile] a partial fill outside "
                                "the graph\n"
                                "    self.inputs[name][:n].copy_(src[:n])\n"),
}


@pytest.mark.parametrize("form", sorted(RECOMPILE_QUIET))
def test_recompile_quiet(tmp_path, form):
    _write(tmp_path, f"{PORT_PKG}/ops/good.py", RECOMPILE_QUIET[form])
    assert [f for f in _port_lint(tmp_path).new if f.rule == "recompile"] == []


DONATION_FIRES = {
    "rebind_state": "def reset(self, v):\n    self.state = self._initial_state(v)\n",
    "rebind_state_entry": "def reset(self, t):\n    self.state['hkeys'] = t\n",
    "rebind_in_tuple_target": "def step(eng, prog):\n    eng.state, out = prog(eng.state)\n",
    "host_read_before_drain": ("def step(self, batch):\n"
                               "    force = self._dispatch_unit(batch)\n"
                               "    n = self.state['n'].item()\n"
                               "    force()\n    return n\n"),
    "host_read_after_replay": ("import numpy as np\ndef step(self, g):\n    g.replay()\n"
                               "    return np.asarray(self.state['hvers'])\n"),
}


@pytest.mark.parametrize("form", sorted(DONATION_FIRES))
def test_donation_fires(tmp_path, form):
    _write(tmp_path, f"{PORT_PKG}/ops/bad.py", DONATION_FIRES[form])
    got = [f for f in _port_lint(tmp_path).new if f.rule == "donation"]
    assert len(got) == 1, got
    assert "static buffer `state`" in got[0].message


DONATION_QUIET = {
    "owner_allocates": ("class E:\n    def __init__(self, v):\n"
                        "        self.state = self._initial_state(v)\n"),
    "refill_in_place": ("def _set_state(self, new):\n    for k, v in self.state.items():\n"
                        "        v.copy_(new[k])\n"),
    "local_name_rebind": "def body(self, state):\n    state = dict(state)\n    return state\n",
    "torch_op_after_dispatch": ("def step(self, batch):\n"
                                "    force = self._dispatch_unit(batch)\n"
                                "    scratch = self.state['n'].clone()\n"
                                "    return force(), scratch\n"),
    "host_read_after_drain": ("def step(self, batch):\n"
                              "    force = self._dispatch_unit(batch)\n"
                              "    status = force()\n"
                              "    return self.state['n'].item(), status\n"),
}


@pytest.mark.parametrize("form", sorted(DONATION_QUIET))
def test_donation_quiet(tmp_path, form):
    _write(tmp_path, f"{PORT_PKG}/ops/good.py", DONATION_QUIET[form])
    assert [f for f in _port_lint(tmp_path).new if f.rule == "donation"] == []


# -- 4. the port's own tree ---------------------------------------------------

def _port_tree():
    return _port_lint(REPO, baseline=tcore.load_baseline(REPO / tcore.BASELINE_REL))


def test_port_tree_clean():
    """No unbaselined finding and no stale baseline entry over the port's
    tree, against the port's own baseline."""
    res = _port_tree()
    assert res.new == [], "\n".join(f"{f.path}:{f.line}: [{f.rule}] {f.message}"
                                    for f in res.new)
    assert res.stale_baseline == [], res.stale_baseline
    assert res.files > 100
    assert set(res.rules) == set(NEUTRAL + TORCH_RULES + ("suppression",))


def test_port_suppressions_all_carry_reasons():
    res = _port_tree()
    for f, s in res.suppressed:
        assert s.reason and f.path.startswith(PORT_PKG + "/"), (f.path, f.line)
    assert len(res.suppressed) <= PORT_SUPPRESSION_CEILING, [
        (f.path, f.line, s.reason) for f, s in res.suppressed]


def test_port_baseline_shrink_or_hold():
    data = json.loads((REPO / tcore.BASELINE_REL).read_text())
    assert data.get("version") == 1
    assert len(data.get("findings", [])) <= PORT_BASELINE_CEILING
    assert [b for b in data["findings"] if b.get("rule") == "knob-drift"] == []


def test_port_lint_never_reads_the_reference_baseline(tmp_path):
    """The default baseline is the port's own file; the root
    lint_baseline.json, which tests/test_lint.py pins, stays out of it."""
    assert tcore.BASELINE_REL == f"{PORT_PKG}/tools/lint/baseline.json"
    _write(tmp_path, f"{PORT_PKG}/sim/bad.py", "import time\nT = time.time()\n")
    _write(tmp_path, "lint_baseline.json", json.dumps({"version": 1, "findings": [
        f.as_dict() for f in _port_lint(tmp_path).new]}))
    with open(os.devnull, "w") as sink:
        assert tcore.main(TLINT.CHECKERS, argv=["--root", str(tmp_path)], out=sink) == 1


def test_port_drain_points_sit_where_the_reference_has_them():
    for rel, fn in (("ops/device_loop.py", "_finish"), ("parallel/mesh_engine.py", "_finish")):
        ctx = tcore.FileCtx(REPO, REPO / PORT_PKG / rel)
        (node,) = [f for f in ctx.functions if f.name == fn]
        assert ctx.is_drain_function(node, ()), rel


#: the port's sanctioned syncs outside the reference's two drain points:
#: each function reads a `*_dev` value or waits on an event by contract
PORT_DRAIN_POINTS = (
    ("ops/host_engine.py", "_run_fix"),
    ("ops/host_engine.py", "_run_apply"),
    ("ops/host_engine.py", "read"),
    ("ops/conflict_kernel.py", "_iterate"),
    ("ops/conflict_kernel.py", "run_if"),
    ("ops/conflict_kernel.py", "run_while"),
    ("ops/conflict_kernel.py", "state_to_numpy"),
    ("ops/conflict_kernel.py", "history_run_snapshot"),
)


@pytest.mark.parametrize("rel,fn", PORT_DRAIN_POINTS,
                         ids=[f"{r}:{f}" for r, f in PORT_DRAIN_POINTS])
def test_port_syncs_are_visible_to_host_sync(tmp_path, rel, fn):
    """The port's own device reads are named so that host-sync sees them:
    with the drain-point annotations taken out of a copy of the file, the
    rule fires inside the function; in the tree, the annotation covers it."""
    ctx = tcore.FileCtx(REPO, REPO / PORT_PKG / rel)
    (node,) = [f for f in ctx.functions
               if f.name == fn and ctx.is_drain_function(f, ())]
    src = (REPO / PORT_PKG / rel).read_text()
    _write(tmp_path, f"{PORT_PKG}/{rel}",
           src.replace("fdbtpu-lint: drain-point", "was a drain point"))
    got = [f for f in _port_lint(tmp_path).new if f.rule == "host-sync"]
    assert [f for f in got if node.lineno <= f.line <= node.end_lineno], got


def test_discovery_skips_build_dir_and_the_linter(tmp_path):
    _write(tmp_path, f"{PORT_PKG}/ops/a.py", "x = 1\n")
    _write(tmp_path, f"{PORT_PKG}/_build/gen.py", "x = 1\n")
    _write(tmp_path, f"{PORT_PKG}/ops/__pycache__/a.py", "x = 1\n")
    got = [p.relative_to(tmp_path).as_posix() for p in tcore.discover_files(tmp_path)]
    assert got == [f"{PORT_PKG}/ops/a.py"]
    files = [p.relative_to(REPO).as_posix() for p in tcore.discover_files(REPO)]
    assert not [p for p in files if "/tools/lint/" in p or "/_build/" in p]


def test_knob_drift_reads_the_ports_own_consumers(tmp_path):
    """extra_refs is the port's tests (a glob) and chip_smoke.py: a knob
    named only in a JAX test is unreferenced in the port."""
    _write(tmp_path, f"{PORT_PKG}/core/knobs.py",
           "k.init('resolver_in_port_test', 1)\nk.init('resolver_in_smoke', 1)\n"
           "k.init('resolver_in_jax_test', 1)\n")
    _write(tmp_path, "docs/x.md", "| knob | default |\n|---|---|\n"
           "| `resolver_in_port_test` | 1 |\n| `resolver_in_smoke` | 1 |\n"
           "| `resolver_in_jax_test` | 1 |\n")
    _write(tmp_path, "tests/test_torch_x.py", "K = 'resolver_in_port_test'\n")
    _write(tmp_path, "tests/test_x.py", "K = 'resolver_in_jax_test'\n")
    _write(tmp_path, "chip_smoke.py", "K = 'resolver_in_smoke'\n")
    msgs = [f.message for f in _port_lint(tmp_path, rules=("knob-drift",)).new]
    assert len(msgs) == 1 and "`resolver_in_jax_test` is defined but never referenced" in msgs[0]


def test_json_report_names_every_rule(capsys):
    assert tcore.main(TLINT.CHECKERS, argv=["--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out["rules"]) == set(NEUTRAL + TORCH_RULES + ("suppression",))
    assert out["new"] == [] and out["stale_baseline"] == []
    assert all(set(c) == {"new", "baselined", "suppressed"} for c in out["counts"].values())


def test_cli_lint_module_run_exits_zero_on_the_tree():
    """`python -m foundationdb_tpu_torch.tools.cli lint` in its own process
    (no jax, no torch needed): the lint's exit code, 0 on the tree."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-m", f"{PORT_PKG}.tools.cli", "lint", "--rules",
                          "donation,recompile,host-sync"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "no new findings" in out.stdout


def test_linter_sources_import_no_torch_jax_or_reference():
    for path in sorted((REPO / PORT_PKG / "tools" / "lint").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("torch", "jax", "jaxlib", JAX_PKG), (path, n)
