"""Forensics smoke: the black-box journal's end-to-end contract in seconds.

Port of ``foundationdb_tpu/tools/forensics_smoke.py``. One process, oracle
engines: it touches no device, and `--device` is taken only so that every
smoke shares one command line:

    python -m foundationdb_tpu_torch.tools.forensics_smoke [--device cpu]

Runs a short wall-clock chaos campaign with the black-box journal ON
(elastic resolver group + the reshard controller, a drifting hot tenant,
a network partition and the watchdog attached), then drives the whole
forensics surface against the persisted journal:

  1. `cli explain --slo` path: the worst retained ack's version explains
     end-to-end and joins >= 5 signal sources (admission, routing epoch,
     span segments, verdict+witness, incident/fault overlap, heat);
  2. differential replay of a window spanning the run (including any
     epoch flip) is verdict-bit-identical to the clean serial oracle;
  3. every frame strict-parses against BLACKBOX_EVENT_REGISTRY;
  4. the `cli explain` / `cli blackbox` one-shot commands render over
     the report file (the operator path, not just the library).

Everything it writes goes under a fresh temporary directory, or under
`workdir` where the caller passes one. Prints one JSON line; any failed
check exits non-zero.
"""
from __future__ import annotations

import io
import json
import os
import sys
import tempfile


def check_forensics(workdir=None) -> dict:
    """Checks 1-4; raises AssertionError on a miss. Returns the figures."""
    from ..core import blackbox
    from ..real.nemesis import NemesisConfig, TenantSpec, run_campaign
    from . import forensics
    from .cli import Cli

    tmp = workdir or tempfile.mkdtemp(prefix="fdb_tpu_forensics_")
    bb_dir = os.path.join(tmp, "bb")
    n_keys = 256
    duration = 4.0
    cfg = NemesisConfig(
        seed=23, engine_mode="oracle", duration_s=duration,
        tenants=[
            TenantSpec("drift", target_tps=55, s=1.2, n_keys=n_keys,
                       drift_keys_per_s=n_keys * 0.6 / duration),
            TenantSpec("bg", target_tps=30, s=0.0, n_keys=512),
        ],
        elastic=True, reshard=True, reshard_spares=1,
        partitions=1, partition_s=0.4, device_faults=False,
        kill_child=False, watchdog=True, blackbox_dir=bb_dir)
    print("forensics-smoke: campaign (oracle, elastic+reshard, "
          "blackbox on) ...", flush=True)
    rep = run_campaign(cfg)
    report_path = os.path.join(tmp, "report.json")
    with open(report_path, "w") as f:
        json.dump({"campaigns": [rep.as_dict()]}, f, default=str)
    bb = rep.blackbox
    assert bb and bb.get("events", 0) > 0, f"no journal recorded: {bb}"
    assert bb.get("dropped_errors", 0) == 0, bb
    print(f"  journal: {bb['events']} events, {bb['segments']} segment(s), "
          f"kinds {sorted(bb['kinds'])}", flush=True)

    # 3. strict schema parse of every frame
    counts = forensics.strict_parse(bb_dir)
    assert counts.get("batch", 0) > 0, counts
    assert counts.get("span", 0) > 0, counts
    assert counts.get("fault_window", 0) > 0, counts
    assert counts.get("admission", 0) > 0, counts
    print(f"  strict parse: {sum(counts.values())} events OK "
          f"({counts})", flush=True)

    events = blackbox.read_journal(bb_dir)
    ix = forensics.JournalIndex(events)
    v_lo, v_hi = ix.version_range()

    # 1. explain the worst retained ack (the --slo path) and assert the
    # join breadth the acceptance criterion names
    rc = rep.slo_root_cause or {}
    version = rc.get("version")
    if version is None:
        version = ix.batches[-1].payload.version
    info = forensics.explain(events, int(version))
    lines = forensics.render_explain(info)
    for line in lines:
        print("  " + line)
    need = {"admission", "spans"}
    assert need <= set(info["sources"]), info["sources"]
    assert len(info["sources"]) >= 5, \
        f"explain joined only {info['sources']}"
    # routing must be real on an elastic journal once a flip happened
    flips = [e for e in ix.by_kind.get("reshard", ())
             if e.payload.phase == "flip"]
    if flips:
        post_flip_v = max(e.payload.flip_version for e in flips)
        post = next((b for b in ix.batches
                     if b.payload.version >= post_flip_v), None)
        if post is not None:
            info2 = forensics.explain(events, post.payload.version)
            assert "routing" in info2["sources"], info2["sources"]
            assert info2["routing"]["epoch"] >= 1, info2["routing"]

    # 2. differential replay of the whole persisted window — bit-parity
    # with the clean serial oracle, across any epoch flips
    r = forensics.diff_replay(events, v_lo, v_hi)
    assert r["mismatches"] == 0, r
    assert r["coverage_ok"], r
    if flips:
        assert len(r["epochs"]) >= 2 or r["epochs"] != [0], r
    print(f"  replay: {r['window_batches']} batches v{v_lo}..v{v_hi} "
          f"verdict-identical (epochs {r['epochs']})", flush=True)

    # 4. the operator path: one-shot cli commands over the report file
    out = io.StringIO()
    cli = Cli.__new__(Cli)
    cli.out = out
    cli.do_blackbox([report_path])
    cli.do_blackbox(["replay", "--window", f"v{v_lo}..v{v_hi}",
                     report_path])
    cli.do_explain(["--slo", report_path])
    rendered = out.getvalue()
    assert "VERDICT-IDENTICAL" in rendered, rendered
    assert "explain v" in rendered, rendered
    assert "joined" in rendered, rendered
    # an OLD report (no blackbox field) must degrade gracefully
    old_path = os.path.join(tmp, "old.json")
    rep_d = rep.as_dict()
    rep_d.pop("blackbox")
    with open(old_path, "w") as f:
        json.dump({"campaigns": [rep_d]}, f, default=str)
    out2 = io.StringIO()
    cli.out = out2
    cli.do_explain([str(int(version)), old_path])
    assert "carries no black-box journal" in out2.getvalue(), \
        out2.getvalue()
    print("FORENSICS SMOKE OK", flush=True)
    return {"events": bb["events"], "segments": bb["segments"],
            "strict_parse": counts, "explained_version": int(version),
            "sources": sorted(info["sources"]), "flips": len(flips),
            "replay": {"batches": r["window_batches"], "mismatches": r["mismatches"],
                       "epochs": r["epochs"]}}


def run(device: str = "host", workdir=None) -> dict:
    """Every check; the result line main prints. `device` is only named
    in the line: the oracle resolves on the host."""
    import time

    t0 = time.perf_counter()
    failures, out = [], None
    try:
        out = check_forensics(workdir)
    except AssertionError as e:
        failures.append(str(e))
    return {"metric": "forensics_smoke", "device": str(device), "ok": not failures,
            "failures": failures, "forensics": out,
            "seconds": round(time.perf_counter() - t0, 3)}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="taken for a uniform command line; the oracle "
                         "resolves on the host")
    ap.add_argument("--workdir", default=None,
                    help="where the journal and reports go (default: a "
                         "fresh temporary directory)")
    args = ap.parse_args(argv)
    out = run("host", args.workdir)
    print(json.dumps(out, default=str))
    return 1 if out["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
