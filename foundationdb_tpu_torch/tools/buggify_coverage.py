"""BUGGIFY coverage report: which fault-injection sites never fire.

Port of ``foundationdb_tpu/tools/buggify_coverage.py``: the battery runs
the port's specs (testing/specs.py, testing/workload.py) and the static
scan reads the port's package, foundationdb_tpu_torch/.

The flow/coveragetool role for our buggify sites (core/buggify.py): the
reference's correctness strategy only works if injection sites actually
FIRE across seeds — a site that never activates under a grinder battery
is dead weight, and a shrinking fired count flags accidentally disabled
injection. core/buggify.py accumulates `fired` across simulations for
exactly this harvest; this tool is its consumer: run a spec battery
across N seeds, then report every statically-declared site that never
activated or never fired.

    python -m foundationdb_tpu_torch.tools.buggify_coverage --seeds 6
    python -m foundationdb_tpu_torch.tools.buggify_coverage \
        --specs DeviceNemesis,CycleTestAttrition --seeds 10 --min-frac 0.5

Exit status is non-zero when the fired fraction of sim-reachable sites
falls below --min-frac (0 = report only). `make chaos` runs this after
the nemesis campaign.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional, Tuple

REPO = Path(__file__).resolve().parent.parent.parent

#: the default battery: the recovery/attrition/durability grinders plus the
#: device-nemesis spec, whose engine-boundary sites only exist under a
#: supervised resolver
DEFAULT_SPECS = [
    "DeviceNemesis",
    "DurableCycleAttrition",
    "DataDistributionAttrition",
    "CycleTestRestart",
    "MultiProxyAttrition",
    "CycleLogSubsets",
    "BackupCorrectness",
    "DiskAttrition",
]


def static_sites(pkg_root: Path = None) -> List[Tuple[str, int]]:
    """(file, line) of every buggify.buggify() call site in the tree."""
    pkg = pkg_root or (REPO / "foundationdb_tpu_torch")
    me = str(Path(__file__).resolve())
    out = []
    for path in sorted(pkg.rglob("*.py")):
        if str(path.resolve()) == me:
            continue   # this file only MENTIONS the call, in prose
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if "buggify.buggify()" in line and "def " not in line:
                out.append((str(path), i))
    return out


def sim_reachable(sites: List[Tuple[str, int]]) -> List[Tuple[str, int]]:
    """Real-transport sites can only fire in real mode; everything else is
    reachable from the simulation battery."""
    return [(f, l) for f, l in sites if "/real/" not in f]


def real_sites(sites: Optional[List[Tuple[str, int]]] = None) -> List[Tuple[str, int]]:
    """Injection sites in the wall-clock layer (real/): frame read/write
    tears, cluster join flaps, slow service. They fire under a buggified
    real-mode run, not the sim battery — the report lists them separately
    so the real layer's injection inventory is visible (and a zero count
    flags the layer losing its fault hooks; tests/test_buggify_coverage.py
    pins it non-zero)."""
    return [(f, l) for f, l in (sites if sites is not None else static_sites())
            if "/real/" in f]


def run_battery(spec_names: List[str], seeds: List[int], out=sys.stdout):
    """Run the battery, returning (activated, fired) site sets unioned
    across every run."""
    from ..core import buggify
    from ..testing.specs import SPECS
    from ..testing.workload import run_spec

    buggify.fired.clear()
    activated = set()
    failures = 0
    for name in spec_names:
        make = SPECS.get(name)
        if make is None:
            raise SystemExit(f"unknown spec: {name}")
        for seed in seeds:
            res = run_spec(make(), seed)
            # per-run activation unioned here; `fired` accumulates itself
            activated.update(s for s, (act, _p) in buggify._sites.items() if act)
            status = "OK " if res.ok else "FAIL"
            print(f"  {status} {name} seed={seed} vtime={res.virtual_time:.1f}s",
                  file=out)
            if not res.ok:
                failures += 1
    fired = {(f, l) for (f, l) in buggify.fired}
    return activated, fired, failures


def report(activated, fired, out=sys.stdout) -> float:
    total = static_sites()
    reachable = sim_reachable(total)
    hit = [s for s in reachable if s in fired]
    never_activated = sorted(set(reachable) - activated)
    never_fired = sorted(set(reachable) - fired)
    frac = len(hit) / max(len(reachable), 1)

    def rel(f: str) -> str:
        try:
            return str(Path(f).relative_to(REPO))
        except ValueError:
            return f

    real = real_sites(total)
    print(f"\nbuggify sites: {len(total)} static, {len(reachable)} "
          f"sim-reachable, {len(real)} real-layer", file=out)
    if real:
        print("real-layer sites (fire under buggified wall-clock runs, "
              "not this battery):", file=out)
        for f, l in real:
            print(f"  {rel(f)}:{l}", file=out)
    print(f"activated at least once: "
          f"{len([s for s in reachable if s in activated])}/{len(reachable)}",
          file=out)
    print(f"fired at least once:     {len(hit)}/{len(reachable)} "
          f"({frac:.0%})", file=out)
    if never_activated:
        print("\nnever ACTIVATED (site coin never came up across all seeds):",
              file=out)
        for f, l in never_activated:
            print(f"  {rel(f)}:{l}", file=out)
    dead = [s for s in never_fired if s in activated]
    if dead:
        print("\nactivated but never FIRED (dead or unreached injection "
              "branches — candidates for removal or new specs):", file=out)
        for f, l in dead:
            print(f"  {rel(f)}:{l}", file=out)
    return frac


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="run the spec battery and report buggify site coverage")
    ap.add_argument("--seeds", type=int, default=4,
                    help="seeds per spec (base..base+N-1)")
    ap.add_argument("--base-seed", type=int, default=11)
    ap.add_argument("--specs", default=",".join(DEFAULT_SPECS),
                    help="comma-separated spec names")
    ap.add_argument("--min-frac", type=float, default=0.0,
                    help="fail (exit 1) when fired fraction is below this")
    args = ap.parse_args(argv)

    names = [s for s in args.specs.split(",") if s]
    seeds = list(range(args.base_seed, args.base_seed + args.seeds))
    print(f"battery: {len(names)} specs x {len(seeds)} seeds")
    activated, fired, failures = run_battery(names, seeds)
    frac = report(activated, fired)
    if failures:
        print(f"\n{failures} spec run(s) FAILED", file=sys.stderr)
        return 2
    if args.min_frac and frac < args.min_frac:
        print(f"\nfired fraction {frac:.0%} below --min-frac "
              f"{args.min_frac:.0%}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
