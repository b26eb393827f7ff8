"""fdbbackup: the backup/restore/DR driver tool.

Port of ``foundationdb_tpu/tools/fdbbackup.py``. Every cluster the tool
builds (the source, and the restore or DR destination) recruits card
resolvers by default: TorchConflictEngine at the specs' KernelConfig
(testing/specs.make_engine_factory). `--engine` and `--device` choose as
real/node.py does; `--engine oracle` gives the JAX tool's oracle
resolvers, and `--device cpu` runs the torch engines on the CPU.

Re-design of fdbbackup/backup.actor.cpp (one binary, personalities chosen
by invocation: EXE_BACKUP / EXE_RESTORE / EXE_DR_AGENT, :75) against this
framework's agents. Like tools/cli.py, the tool is the only wall-clock
actor: it builds (or is handed) a simulated cluster, drives the agents'
transactions through the real client, and prints machine-readable status.

    python -m foundationdb_tpu_torch.tools.fdbbackup backup  [--seed N] [--engine E] [--device D]
    python -m foundationdb_tpu_torch.tools.fdbbackup restore [--seed N]
    python -m foundationdb_tpu_torch.tools.fdbbackup dr      [--seed N]

`backup`  starts a live backup under write load, snapshots, finishes, and
          prints the restorability window.
`restore` additionally restores into a second cluster and verifies
          equality at the backup's end version.
`dr`      runs continuous replication into a second cluster, then a
          lockDatabase switchover, and verifies nothing acknowledged was
          lost.
"""
from __future__ import annotations

import argparse
import json
import sys

from ..backup import BackupAgent, BlobContainer, DRAgent
from ..server.cluster import DynamicCluster, DynamicClusterConfig, build_dynamic_cluster

#: the resolver engines a tool's cluster can recruit (real/node.py's kinds)
ENGINE_KINDS = ("auto", "torch", "device_loop", "native", "oracle")


def engine_factory(kind: str = "torch", device=None):
    """The conflict-engine factory of a tool's cluster: "torch" (the
    default), "device_loop" or "auto" build the port's engine at the specs'
    KernelConfig on `device` (None or "cuda": the card, raising here where
    there is none); "native" the C++ engine (raising without a C++
    compiler); "oracle" the reference oracle."""
    if kind == "oracle":
        from ..ops.oracle import OracleConflictEngine

        return OracleConflictEngine
    if kind == "native":
        from ..ops.native_engine import NativeConflictEngine, lib

        lib()   # build now: no C++ compiler fails here, not mid-simulation
        return NativeConflictEngine
    if kind in ("torch", "device_loop", "auto"):
        import torch

        from ..ops.host_engine import default_engine_mode
        from ..testing.specs import make_engine_factory

        if (device is None or torch.device(device).type == "cuda") \
                and not torch.cuda.is_available():
            raise RuntimeError(
                f"engine {kind!r} runs on the card and CUDA is not available; "
                "pass --device cpu to run it on the CPU")
        mode = default_engine_mode() if kind == "auto" else kind
        return make_engine_factory(device=device, mode=mode)
    raise ValueError(f"unknown engine kind {kind!r}; expected one of {ENGINE_KINDS}")


def _fill(db, n=30, prefix=b"bk"):
    async def go():
        for i in range(0, n, 10):
            async def w(tr, base=i):
                for j in range(base, min(base + 10, n)):
                    tr.set(prefix + b"/%04d" % j, b"v%d" % j)
            await db.run(w)
        return True
    return go()


async def _read_all(db):
    async def r(tr):
        return await tr.get_range(b"", b"\xff", limit=100_000, snapshot=True)
    return await db.run(r)


def cmd_backup(sim, cluster, do_restore: bool) -> dict:
    factory = cluster.cfg.engine_factory
    db = cluster.new_client()
    out: dict = {}

    async def scenario():
        assert await _fill(db)
        container = BlobContainer(sim.new_process("fdbbackup-blob"))
        agent = BackupAgent(sim, db, container.proc.address)
        await agent.start_backup()
        out["start_version"] = agent.start_version
        # live writes AFTER the backup started ride the mutation log
        assert await _fill(db, prefix=b"live")
        await agent.snapshot(chunks=4, workers=2)
        await agent.finish_backup()
        out["snapshot_version"] = agent.snapshot_version
        out["end_version"] = agent.end_version
        out["restorable"] = agent.end_version is not None
        if do_restore:
            # capture the source AT end_version NOW, while the MVCC window
            # still covers it (the restore itself outlives the window)
            tr = db.create_transaction()
            tr.read_version = agent.end_version
            src_rows = await tr.get_range(b"", b"\xff", limit=100_000,
                                          snapshot=True)
            dst = DynamicCluster(sim, DynamicClusterConfig(
                n_workers=5, n_tlogs=2, n_resolvers=1, n_storage=2,
                engine_factory=factory))
            db2 = dst.new_client()
            await agent.restore(db2)
            dst_rows = await _read_all(db2)
            out["restored_rows"] = len(dst_rows)
            out["verified"] = (src_rows == dst_rows)
        return True

    assert sim.run_until(sim.sched.spawn(scenario(), name="fdbbackup"),
                         until=900.0)
    return out


def cmd_dr(sim, cluster) -> dict:
    factory = cluster.cfg.engine_factory
    db = cluster.new_client()
    out: dict = {}

    async def scenario():
        assert await _fill(db)
        dst = DynamicCluster(sim, DynamicClusterConfig(
            n_workers=5, n_tlogs=2, n_resolvers=1, n_storage=2,
            engine_factory=factory))
        db2 = dst.new_client()
        agent = DRAgent(sim, db, db2)
        await agent.start(chunks=4)
        assert await _fill(db, prefix=b"live")
        tr = db.create_transaction()
        v = await tr.get_read_version()
        await agent.wait_for(v, timeout=120.0)
        out["lag_target_version"] = v
        fence = await agent.switchover()
        out["fence_version"] = fence
        src_rows = await _read_all(db)
        dst_rows = dict(await _read_all(db2))
        out["verified"] = all(dst_rows.get(k) == val for k, val in src_rows)
        return True

    assert sim.run_until(sim.sched.spawn(scenario(), name="fdbdr"),
                         until=900.0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="backup/restore/DR driver")
    ap.add_argument("personality", choices=["backup", "restore", "dr"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", default="torch", choices=ENGINE_KINDS,
                    help="the clusters' resolver engines (oracle: the JAX tool's)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the card engines (cpu to run them on the CPU)")
    args = ap.parse_args(argv)
    cluster = build_dynamic_cluster(seed=args.seed, cfg=DynamicClusterConfig(
        engine_factory=engine_factory(args.engine, args.device)))
    sim = cluster.sim
    if args.personality in ("backup", "restore"):
        out = cmd_backup(sim, cluster, do_restore=args.personality == "restore")
    else:
        out = cmd_dr(sim, cluster)
    print(json.dumps(out, default=str))
    ok = out.get("verified", out.get("restorable", False))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
