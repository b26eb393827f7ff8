"""fdbmonitor: the process supervisor for real clusters.

Port of ``foundationdb_tpu/real/monitor.py``.

Re-design of fdbmonitor/fdbmonitor.cpp (:267 Command struct, fd watching,
conf hot-reload): a plain (non-scheduler) daemon that reads an ini-style
conf, spawns one real.node process per [node.PORT] section, restarts dead
children with exponential backoff (reset after a stable-uptime window),
re-reads the conf on mtime change (added sections spawn, removed sections
stop, changed sections restart), and tears everything down on SIGTERM.

    python -m foundationdb_tpu_torch.real.monitor --conf cluster.conf

conf format:

    [general]
    coordinators = 127.0.0.1:4500,127.0.0.1:4501,127.0.0.1:4502
    datadir = /var/lib/fdb_tpu
    workers = 4
    engine = auto

    [node.4500]
    cc_priority = 0

    [node.4501]
    cc_priority = 1
"""
from __future__ import annotations

import argparse
import configparser
import os
import signal
import subprocess
import sys
import time
from typing import Dict, Optional

INITIAL_BACKOFF = 1.0
MAX_BACKOFF = 60.0
#: uptime after which a child's backoff resets (fdbmonitor's
#: restart_backoff reset window)
STABLE_SECONDS = 10.0


class Child:
    def __init__(self, section: str, argv: list):
        self.section = section
        self.argv = argv
        self.proc: Optional[subprocess.Popen] = None
        self.backoff = INITIAL_BACKOFF
        self.started_at = 0.0
        self.restart_at = 0.0   # 0 = running or start now
        #: consecutive sub-stable-uptime exits (the crash-loop counter,
        #: surfaced in every restart status line; resets once the child
        #: stays up past STABLE_SECONDS)
        self.crash_count = 0
        #: lifetime restarts (monitoring/tests; never reset)
        self.restarts = 0

    def spawn(self, log_dir: str) -> None:
        log = open(os.path.join(log_dir, f"{self.section}.log"), "ab")
        try:
            self.proc = subprocess.Popen(
                self.argv, stdout=log, stderr=subprocess.STDOUT)
        finally:
            log.close()   # the child holds its own dup; keeping ours open
            #               would leak one fd per restart of a crash-looper
        self.started_at = time.monotonic()
        self.restart_at = 0.0
        print(f"fdbmonitor: started {self.section} (pid {self.proc.pid})"
              + (f" [crash loop x{self.crash_count}]" if self.crash_count
                 else ""),
              flush=True)

    def note_stable(self, now: float) -> None:
        """Uptime past the stable window resets backoff AND the crash-loop
        counter — a recovered child is no longer crash-looping."""
        if now - self.started_at > STABLE_SECONDS:
            self.backoff = INITIAL_BACKOFF
            self.crash_count = 0

    def note_exit(self, now: float) -> int:
        """Record an exit: schedule the restart after the CURRENT backoff,
        then widen it for the next one. A fast-crashing child therefore
        never respawns hot — every consecutive exit at least doubles the
        wait, and the status line carries the crash-loop count."""
        rc = self.proc.returncode if self.proc is not None else None
        self.proc = None
        self.crash_count += 1
        self.restart_at = now + self.backoff
        print(f"fdbmonitor: {self.section} exited rc={rc}; "
              f"crash loop x{self.crash_count}; "
              f"restart in {self.backoff:.1f}s", flush=True)
        self.backoff = min(self.backoff * 2, MAX_BACKOFF)
        return rc if rc is not None else -1

    def due(self, now: float) -> bool:
        """True when a scheduled restart's backoff has elapsed."""
        return bool(self.restart_at) and now >= self.restart_at

    def stop(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self.proc.kill()
        self.proc = None


def poll_children(children, log_dir: str, now: Optional[float] = None) -> bool:
    """One supervision pass (extracted from main's loop so the restart
    policy is unit-testable and reusable by the wall-clock nemesis,
    real/nemesis.py): reap exits into backoff-scheduled restarts, respawn
    the due, reset backoff on stable uptime. Returns whether any child is
    alive or pending restart."""
    from ..core import telemetry

    if now is None:
        now = time.monotonic()
    any_alive = False
    for c in children.values() if isinstance(children, dict) else children:
        if c.proc is not None and c.proc.poll() is None:
            any_alive = True
            c.note_stable(now)
            continue
        if c.proc is not None:
            rc = c.note_exit(now)
            # supervised-process churn lands in the chaos timeline
            # (telemetry hub event ring -> campaign reports and the
            # Chrome trace's nemesis track), so a child death is
            # correlatable with the SLO windows around it
            telemetry.hub().chaos_event("child_exit", section=c.section,
                                        rc=rc, crash_count=c.crash_count)
        if c.due(now):
            c.restarts += 1
            c.spawn(log_dir)
            telemetry.hub().chaos_event("child_respawn", section=c.section,
                                        crash_count=c.crash_count,
                                        restarts=c.restarts)
            any_alive = True
        # NB: a child merely WAITING OUT its backoff does not count as
        # alive — preserving --once's original "every child has exited"
        # exit condition
    return any_alive


def parse_conf(path: str):
    cp = configparser.ConfigParser()
    cp.read(path)
    if "general" not in cp:
        raise ValueError(f"{path}: missing [general] section")
    g = cp["general"]
    coordinators = g.get("coordinators")
    datadir = g.get("datadir")
    workers = g.getint("workers")
    if not coordinators or not datadir or workers is None:
        raise ValueError(
            f"{path}: [general] must set coordinators, datadir, workers")
    # the node's default: the card (real/node.py); native / oracle are
    # the CPU engines a conf names
    engine = g.get("engine", "auto")
    nodes: Dict[str, list] = {}
    for section in cp.sections():
        if not section.startswith("node."):
            continue
        port = section[len("node."):]
        s = cp[section]
        argv = [
            sys.executable, "-m", "foundationdb_tpu_torch.real.node",
            "--port", port,
            "--coordinators", coordinators,
            "--datadir", os.path.join(datadir, port),
            "--workers", str(workers),
            "--engine", s.get("engine", engine),
        ]
        if s.get("cc_priority") is not None:
            argv += ["--cc-priority", s.get("cc_priority")]
        nodes[section] = argv
    return datadir, nodes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="process supervisor (fdbmonitor)")
    ap.add_argument("--conf", required=True)
    ap.add_argument("--once", action="store_true",
                    help="exit when every child has exited (testing)")
    args = ap.parse_args(argv)

    datadir, node_argvs = parse_conf(args.conf)
    os.makedirs(datadir, exist_ok=True)
    log_dir = os.path.join(datadir, "logs")
    os.makedirs(log_dir, exist_ok=True)
    children: Dict[str, Child] = {}
    conf_mtime = os.path.getmtime(args.conf)
    stopping = {"flag": False}

    def on_term(_sig, _frm):
        stopping["flag"] = True

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)

    for section, node_argv in node_argvs.items():
        c = Child(section, node_argv)
        c.spawn(log_dir)
        children[section] = c

    while not stopping["flag"]:
        time.sleep(0.5)
        now = time.monotonic()
        # conf hot-reload (fdbmonitor's kqueue/inotify, reduced to mtime)
        try:
            mt = os.path.getmtime(args.conf)
        except OSError:
            mt = conf_mtime
        if mt != conf_mtime:
            conf_mtime = mt
            try:
                _dd, new_argvs = parse_conf(args.conf)
            except (ValueError, configparser.Error) as e:
                # a half-written or malformed conf must never take the
                # supervisor down; keep running on the previous config
                print(f"fdbmonitor: conf reload failed ({e}); keeping old",
                      flush=True)
                continue
            for section in list(children):
                if section not in new_argvs:
                    print(f"fdbmonitor: section {section} removed; stopping",
                          flush=True)
                    children.pop(section).stop()
                elif children[section].argv != new_argvs[section]:
                    print(f"fdbmonitor: section {section} changed; restarting",
                          flush=True)
                    children[section].stop()
                    children[section].argv = new_argvs[section]
                    children[section].backoff = INITIAL_BACKOFF
                    children[section].crash_count = 0
                    children[section].spawn(log_dir)
            for section, node_argv in new_argvs.items():
                if section not in children:
                    c = Child(section, node_argv)
                    c.spawn(log_dir)
                    children[section] = c
        # child liveness + crash-loop-counted backoff restarts
        any_alive = poll_children(children, log_dir, now)
        if args.once and not any_alive:
            break

    for c in children.values():
        c.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
