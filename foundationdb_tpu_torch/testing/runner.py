"""Spec-runner CLI with seed replay.

Port of ``foundationdb_tpu/testing/runner.py``.

The analog of `fdbserver -r simulation -f tests/fast/CycleTest.txt -s SEED`:
run one named spec (or all) under a seed; failures replay exactly by
re-running with the same seed. `--repeat N` runs N consecutive seeds, the
miniature of the reference's thousands-of-seeds correctness runs.
"""
from __future__ import annotations

import argparse
import sys

from .specs import SPECS
from .workload import run_spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="simulation spec runner")
    ap.add_argument("--spec", help="spec name (see --list)")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--repeat", type=int, default=1, help="run seeds seed..seed+N-1")
    ap.add_argument("--all", action="store_true", help="run every spec")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    if args.list:
        for name in sorted(SPECS):
            print(name)
        return 0

    names = sorted(SPECS) if args.all else ([args.spec] if args.spec else [])
    if not names:
        ap.error("--spec NAME, --all, or --list required")

    failures = 0
    for name in names:
        make = SPECS.get(name)
        if make is None:
            print(f"unknown spec: {name}", file=sys.stderr)
            return 2
        for seed in range(args.seed, args.seed + args.repeat):
            res = run_spec(make(), seed)
            status = "OK " if res.ok else "FAIL"
            print(
                f"{status} {name} seed={seed} vtime={res.virtual_time:.2f}s "
                + " ".join(f"{k}={v:g}" for k, v in sorted(res.metrics.items()))
            )
            if not res.ok:
                failures += 1
                print(f"  replay: python -m foundationdb_tpu_torch.testing.runner --spec {name} --seed {seed}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
