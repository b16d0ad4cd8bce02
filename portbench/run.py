"""Run one cell of the benchmark of ``l3ster_tpu_torch`` once, on this machine's card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the program.  Prints one JSON object as the last line of standard
output (``--trace 0``: the cell's end-to-end metrics; ``--trace 1``: its
per-layer metrics, the device's busy and window seconds and a breakdown),
with the numbers that decide ``correct`` under ``checks``, last; the same
numbers, each beside its limit, are the last lines of standard error.
Exits non-zero, and prints no result, without a CUDA device (or with fewer
than the cell asks for), without the program, or when JAX or the JAX
package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.harness import forbidden_modules, load_cell, run_cell

    chips = load_cell(ROOT, args.workload)["cell"]["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()  # also what the probes and the reference loaded
    if bad:
        print(f"portbench: forbidden modules loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
