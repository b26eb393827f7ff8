"""The control of the check: the reference without its batch test, put in
the program's place, judged by the check a run makes.

    python3 resolver_bench/control.py --workload <cell> --seeds 1,2,3 --batches N

For each seed it builds the cell's traffic as a run does (the prefill,
then N window batches: a run's `window_batches`), resolves it with
reference.py and with the control (`intra_batch=False`), and prints one
JSON line a seed with the verdicts that differ: the reading that the
check's limit of 0 has to stay below. Runs on the CPU; imports nothing of
the program. The benchmark's own runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--batches", type=int, required=True,
                    help="window batches after the prefill (a run's window_batches)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from resolver_bench import harness, reference
    from resolver_bench.traffic import Traffic, sizes

    spec = harness.load_spec(ROOT, args.workload)
    prefill = sizes(spec.config).horizon_batches * int(spec.mix["prefill_horizons"])
    n = prefill + args.batches
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        traffic = Traffic(spec.config, seed, n)
        want = reference.resolve(traffic, n)
        got = reference.resolve(traffic, n, intra_batch=False)
        print(json.dumps({"workload": args.workload, "seed": seed, "batches": n,
                          "control_mismatched_verdicts": reference.mismatches(got.verdicts,
                                                                             want.verdicts),
                          "rows_max": want.rows_max,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
