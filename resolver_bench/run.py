"""Benchmark one cell of the PyTorch/CUDA resolver on the card.

    python3 resolver_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA card. The cell,
its configuration, traffic mix and metrics come from BENCHMARK.json and
the files it names (harness.py says what a run does). With --trace 0 the
last line of standard output is one JSON object holding the cell's
end-to-end metrics; with --trace 1 its per-layer metrics, read from the
program's spans, the harness's clocks and a torch.profiler trace of the
window. Every number the check compares is printed beside its limit in
the last lines of standard error and under "checks", last, in that
object. A machine without a card, a checkout without the program, or a
process that has loaded JAX or the JAX package exits non-zero with no
result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: every compiler cache a run may fill, at fixed paths in the checkout (the
#: port builds its own kernels into foundationdb_tpu_torch/_build/)
CACHE_DIR = ROOT / "resolver_bench" / "_cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE_DIR / sub)
    sys.path.insert(0, str(ROOT))
    from resolver_bench import harness

    try:
        spec = harness.load_spec(ROOT, args.workload)
        import torch

        chips = int(spec.cell["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"resolver_bench: the cell needs {chips} CUDA card(s); this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        result = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace), T_START)
    except harness.RunFailed as e:
        print(f"resolver_bench: {e}", file=sys.stderr)
        return 4
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"resolver_bench: the process loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
