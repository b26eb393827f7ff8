"""One real cluster node: `python -m foundationdb_tpu_torch.real.node ...`.

Port of ``foundationdb_tpu/real/node.py``.

The fdbd() analog (fdbserver/fdbserver.actor.cpp:1607, worker.actor.cpp:997):
one OS process composing, over the real transport,

  * a coordination server (when this node is in the coordinator list) —
    durable generation + leader registers on the node's data dir;
  * a worker — registers with the elected cluster controller, stands for
    CC leadership itself, and constructs recruited roles (master, proxy,
    resolver, tlog, storage) on Initialize* RPCs;

all running the UNCHANGED role code on the wall-clock cooperative
scheduler (real/runtime.py). The conflict engine is the card's by
default (`--engine auto`, on `--device cuda`); `native` (the C++ engine,
built at first use) and `oracle` are the CPU engines a caller names. A
card engine with no card, or `native` with no C++ compiler, raises: no
kind falls back to another.
"""
from __future__ import annotations

import argparse
import asyncio
import os
import sys


#: the engine kinds a node takes (`--engine`)
ENGINE_KINDS = ("auto", "torch", "device_loop", "native", "oracle")


def kernel_config(device=None):
    """The card engines' KernelConfig: KernelConfig() (capacity 65536,
    T=4096) on the card; on the CPU the campaigns' miniature shape
    (real/nemesis.py _small_kernel_cfg: capacity 1024, T=64). A CPU engine
    at the default shape takes longer per batch than the proxies' idle
    tick (server/proxy.py IDLE_COMMIT_INTERVAL), and its node falls
    behind for good."""
    import torch

    from ..ops.conflict_kernel import KernelConfig

    if device is not None and torch.device(device).type == "cpu":
        return KernelConfig(key_words=4, capacity=1024, max_reads=256,
                            max_writes=256, max_txns=64)
    return KernelConfig()


def make_engine_factory(kind: str, device=None):
    """Conflict-engine family for a wall-clock node. "auto" consults the
    engine-mode router (ops/host_engine.py): the `resolver_device_loop`
    knob promotes the single-card engine to the device-resident loop
    (docs/perf.md "Device-resident loop"); unset, it stays step dispatch
    ("torch"). The card engines run at `kernel_config(device)` on
    `device` (None: the card, raising where there is none). "native"
    builds the C++ engine now and raises without a C++ compiler."""
    if kind in ("torch", "device_loop", "auto"):
        import torch

        from ..ops.host_engine import default_engine_mode, make_engine

        if (device is None or torch.device(device).type == "cuda") \
                and not torch.cuda.is_available():
            raise RuntimeError(
                f"engine {kind!r} runs on the card and CUDA is not available; "
                "pass --device cpu to run it on the CPU")
        mode = default_engine_mode() if kind == "auto" else kind
        cfg = kernel_config(device)
        return lambda: make_engine(mode, cfg, device=device)
    if kind == "native":
        from ..ops.native_engine import NativeConflictEngine, lib

        lib()   # build now: a node without a C++ compiler fails at boot
        return NativeConflictEngine
    if kind == "oracle":
        from ..ops.oracle import OracleConflictEngine

        return OracleConflictEngine
    raise ValueError(f"unknown engine kind {kind!r}; expected one of {ENGINE_KINDS}")


async def amain(args) -> None:
    from ..server.cluster import DynamicClusterConfig
    from ..server.coordination import CoordinationServer
    from ..server.worker import Worker
    from ..sim.loop import TaskPriority, set_scheduler
    from .runtime import (
        NodeProcess,
        RealNetClient,
        RealScheduler,
        RealWorld,
        make_dispatcher,
    )

    # the engine family first: a node whose engine cannot be built
    # (no card, no C++ compiler) exits before it opens its port
    engine_factory = make_engine_factory(args.engine, args.device)
    sched = RealScheduler(seed=(os.getpid() << 16) ^ args.port)
    set_scheduler(sched)
    proc = NodeProcess(args.host, args.port, machine_id=f"m{args.port}", dc_id="dc0")
    proc.dispatcher = make_dispatcher(sched)
    await proc.start()
    net = RealNetClient(sched, name=proc.address)
    world = RealWorld(sched, net, args.datadir)

    coords = args.coordinators.split(",")
    cfg = DynamicClusterConfig(
        n_coordinators=len(coords),
        n_workers=args.workers,
        n_tlogs=args.tlogs,
        n_resolvers=args.resolvers,
        n_proxies=args.proxies,
        n_storage=args.storage,
        engine_factory=engine_factory,
    )

    async def boot():
        if proc.address in coords:
            await CoordinationServer.create(proc, world.disk_for(proc.address))
        Worker(world, proc, coords, cfg.engine_factory,
               cc_priority=args.cc_priority, cluster_cfg=cfg)

    sched.spawn(boot(), TaskPriority.CLUSTER_CONTROLLER, name="fdbd-boot")
    print(f"node up on {proc.address}", flush=True)
    await sched.run_async()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one real cluster node (fdbd)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--coordinators", required=True,
                    help="comma-separated host:port list (the cluster file)")
    ap.add_argument("--datadir", required=True)
    ap.add_argument("--cc-priority", type=int, default=None,
                    help="stand for cluster controllership at this priority")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--tlogs", type=int, default=2)
    ap.add_argument("--resolvers", type=int, default=2)
    ap.add_argument("--proxies", type=int, default=1)
    ap.add_argument("--storage", type=int, default=2)
    ap.add_argument("--engine", default="auto", choices=ENGINE_KINDS)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the card engines (cpu to run them "
                         "on the CPU)")
    ap.add_argument("--tls-cert", default=None)
    ap.add_argument("--tls-key", default=None)
    ap.add_argument("--tls-ca", default=None)
    ap.add_argument("--tls-verify", default="",
                    help='subject DSL, e.g. "Check.Valid=1,O=MyOrg"')
    args = ap.parse_args(argv)
    if args.tls_cert or args.tls_key or args.tls_ca or args.tls_verify:
        if not (args.tls_cert and args.tls_key and args.tls_ca):
            # --tls-verify alone must not silently run plaintext while
            # the operator believes subject checks are enforced
            ap.error("--tls-cert, --tls-key and --tls-ca must be "
                     "given together (required for any TLS option)")
        from .tls import TLSConfig, set_tls
        set_tls(TLSConfig(cert_path=args.tls_cert, key_path=args.tls_key,
                          ca_path=args.tls_ca,
                          verify_rules=args.tls_verify))
    if args.device == "cpu" and args.engine in ("torch", "device_loop", "auto"):
        import torch

        # a node shares the host's cores with its peers
        torch.set_num_threads(1)
    try:
        asyncio.run(amain(args))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
