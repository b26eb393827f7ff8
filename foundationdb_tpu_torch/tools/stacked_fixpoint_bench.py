"""Device time of the fixpoint kernel's stacked entry by sub-shard count.

    python foundationdb_tpu_torch/tools/stacked_fixpoint_bench.py \\
        [--tree DIR] [--cluster-ctas auto,16,8] [--sizes 1,2,4,8,16]
        [--chains 1,8,16] [--out FILE]

For S in `--sizes`, at the default KernelConfig ("engine") and at the
bench shape ("bench"), it runs chip_smoke.py's sharded_kernel_phase: S
sub-shard tables on the card fed the columnar traffic, the stacked entry
held bit for bit against its plain version on four batches, then timed on
the last one (CUDA events around 20 launches queued behind a spin kernel,
median of 5 samples) beside its bound. The inputs come from a seed per
(shape, S), so every run sees the same batches.

The kernel timed is that of the package under `--tree` (default: this
checkout), while the inputs and the timing are this checkout's
chip_smoke.py: the same command times an older checkout's kernel on the
same inputs. Compare two trees only on one card, one run after the
other in turns (A, B, B, A). A tree whose stacked entry launches one cluster of
fixed size (no ``choose_plan_stacked``) is timed once per shape and S,
and its plan reported as that one cluster. `--cluster-ctas` lists the
cluster sizes to time the redesigned entry at ("auto": the size the
wrapper chooses); the line also holds how many clusters of 1 to 16 CTAs
the card holds at once. Each batch is also timed with no txn ok (the
phase's ``setup_ms``: the launch's setup and compaction and one round
that commits nothing), so that the rest of its time, over its other
rounds, is the cost of a round on real traffic.

Where the time of a launch goes: `--chains` times, at the bench shape, a
chain of 2 txns and one of CHAIN_TXNS (chip_smoke's: txn i reads the key
txn i-1 writes, so the fixpoint settles one link a round) in the last of
S sub-shards, the others empty. The long chain's time over its rounds is
the cost of a round; the short one's, less two rounds, the cost of the
launch's setup and compaction.

Prints the card's name and power limit, then one JSON line. Needs a CUDA
card: without one it prints the reason and exits 2.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SEED = 2026


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_bench", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def chain_probe(smoke, ck, fc, cfg, dev, S: int) -> dict:
    """A chain of 2 txns and one of CHAIN_TXNS in the last of S sub-shards
    (the others empty, on empty tables), each timed as sharded_kernel_phase
    times the entry; both bit-equal to the plain version."""
    import torch

    out = {}
    for name, n in (("short", 2), ("long", smoke.CHAIN_TXNS)):
        chain = smoke.chain_packed(ck, cfg, n)
        empty = smoke.chain_packed(ck, cfg, 0)
        empty["t_ok"], empty["t_too_old"] = chain["t_ok"], chain["t_too_old"]
        batch = ck._stack([ck.batch_from_numpy(cfg, b, dev) for b in [empty] * (S - 1) + [chain]])
        state = ck._stack([ck.initial_state(cfg, device=dev) for _ in range(S)])
        hist, edges, _ = ck.detect_step_stacked(cfg, state, batch)
        t_ok = batch["t_ok"][0]
        got = fc.commit_fixpoint_stacked_kernel(cfg, t_ok, hist, edges, batch)
        rounds = int(fc.FIXPOINT_STACKED.last_rounds.item())
        want = fc.commit_fixpoint_stacked_plain(cfg, t_ok, hist, edges, batch)
        torch.cuda.synchronize()
        smoke.check(torch.equal(got, want), f"the stacked entry and its plain version disagree "
                    f"on a {n}-txn chain at S={S}")
        out[f"{name}_ms"] = smoke.device_ms(
            lambda: fc.commit_fixpoint_stacked_kernel(cfg, t_ok, hist, edges, batch), 20)
        out[f"{name}_rounds"] = rounds
    plan = fc.FIXPOINT_STACKED.last_plan
    out["rounds"] = out.pop("long_rounds")
    per_round = (out["long_ms"] - out["short_ms"]) / (out["rounds"] - out["short_rounds"])
    out["round_us"] = per_round * 1e3
    out["setup_us"] = (out["short_ms"] - out["short_rounds"] * per_round) * 1e3
    out.update(clusters=plan["clusters"], cluster_ctas=plan["cluster"],
               sub_shards_per_cluster=plan["sub_shards_per_cluster"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(ROOT), help="checkout whose package is timed")
    ap.add_argument("--cluster-ctas", default="auto,16,8")
    ap.add_argument("--sizes", default="1,2,4,8,16")
    ap.add_argument("--chains", default="1,8,16")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("stacked_fixpoint_bench needs a CUDA card; none is visible", flush=True)
        return 2
    from foundationdb_tpu_torch.ops import conflict_kernel as ck
    from foundationdb_tpu_torch.ops import fixpoint_cuda as fc

    smoke = _load_smoke()
    dev = torch.device("cuda")
    card = smoke.card_line()
    print(card, flush=True)
    stacked = fc.FIXPOINT_STACKED
    redesigned = hasattr(fc, "choose_plan_stacked")
    sizes = [int(x) for x in args.sizes.split(",")]
    variants = args.cluster_ctas.split(",") if redesigned else [None]
    sizes_chosen = getattr(fc, "STACKED_CLUSTER_SIZES", None)

    def force_size(nc):
        # "auto" (or an older tree): the wrapper's own choice
        if sizes_chosen is not None:
            fc.STACKED_CLUSTER_SIZES = sizes_chosen if nc in (None, "auto") else (int(nc),)

    if not redesigned:
        # the one-cluster entry keeps no plan of its launch: fill in its one
        # cluster of CLUSTER_CTAS over every sub-shard
        entry = fc.commit_fixpoint_stacked_kernel

        def with_plan(cfg, t_ok, hist, edges, batch):
            out = entry(cfg, t_ok, hist, edges, batch)
            plan = fc.launch_plan_stacked(cfg, hist.shape[0])
            stacked.last_plan = dict(plan, clusters=1, sub_shards_per_cluster=hist.shape[0],
                                     gx_bytes=0)
            return out

        fc.commit_fixpoint_stacked_kernel = with_plan
    res = {"card": card, "tree": str(Path(args.tree).resolve()), "redesigned": redesigned,
           "torch": torch.__version__, "cuda": torch.version.cuda, "runs": {}}
    engine = ck.KernelConfig()
    bench = ck.KernelConfig(key_words=4, capacity=24576, max_point_reads=8192,
                            max_point_writes=8192, max_reads=256, max_writes=256, max_txns=4096)
    if redesigned:
        res["active_clusters"] = {
            str(nc): stacked.active_clusters(nc, fc.launch_plan_stacked(engine, 1, 1, nc)
                                             ["smem_bytes"], dev)
            for nc in range(1, 17)}
        print(f"co-resident clusters of the stacked entry by size: {res['active_clusters']}",
              flush=True)
    t0 = time.perf_counter()
    for label, cfg in (("engine", engine), ("bench", bench)):
        for S in sizes:
            if not fc.supported(cfg, S):
                res["runs"][f"{label}_S{S}"] = "not supported"
                continue
            for nc in variants:
                force_size(nc)
                stacked.reset_counts()
                rng = np.random.default_rng(SEED + 97 * S + (label == "bench"))
                kp = smoke.sharded_kernel_phase(ck, fc, cfg, dev, rng, S, n_batches=4)
                key = f"{label}_S{S}" + ("" if nc is None else f"_c{nc}")
                res["runs"][key] = {k: kp[k] for k in (
                    "kernel_ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "rounds_timed",
                    "rounds_median", "clusters", "cluster_ctas", "sub_shards_per_cluster",
                    "wtx_in_smem", "smem_bytes", "scratch_bytes") if k in kp}
                if "setup_ms" in kp:
                    # the timed batch's rounds past the one of the probe
                    res["runs"][key]["round_ms"] = (kp["kernel_ms"] - kp["setup_ms"]) / max(
                        1, kp["rounds_timed"] - 1)
                res["runs"][key]["launches"] = stacked.launches
                print(f"{key} [{card}]: kernel_ms={kp['kernel_ms']:.5f} call_ms="
                      f"{kp['call_ms']:.5f} bound_ms={kp['bound_ms']:.6f} rounds="
                      f"{kp['rounds_timed']} K={kp['clusters']} x {kp['cluster_ctas']} CTAs"
                      + (f"; setup and one empty round {kp['setup_ms']:.5f} ms, a round "
                         f"{res['runs'][key]['round_ms']:.5f} ms" if "setup_ms" in kp else ""),
                      flush=True)
    for S in [int(x) for x in args.chains.split(",") if x]:
        for nc in variants:
            force_size(nc)
            key = f"chain_S{S}" + ("" if nc is None else f"_c{nc}")
            res["runs"][key] = chain_probe(smoke, ck, fc, bench, dev, S)
            r = res["runs"][key]
            print(f"{key} [{card}]: {r['rounds']} rounds {r['long_ms']:.5f} ms, "
                  f"{r['short_rounds']} rounds {r['short_ms']:.5f} ms: "
                  f"{r['round_us']:.3f} us a round, setup {r['setup_us']:.3f} us; "
                  f"K={r['clusters']} x {r['cluster_ctas']} CTAs", flush=True)
    res["seconds"] = time.perf_counter() - t0
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
