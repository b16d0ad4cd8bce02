"""Readings for the limits of ``correct``: the program on many seeds, then the control.

    python3 portbench/readings.py --workload <cell> --seconds <s> --seeds <n> ... [--control-seeds <n> ...]

Sets the cell up once, then for each seed runs one measured window as a
run does and has the reference judge every answer of it; then switches on
the control (the program's own TF32 matmul path, the nearest precision
below the configuration's float32 with TF32 off) and does the same for
each control seed.  Prints one JSON line per window: the largest ``err``
and ``res``, the solves that did not converge, solves and mean iterations.
The benchmark's own runs never run this.  Needs a CUDA device.
"""

import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def readings(run, ref, seeds, seconds: float, control: str | None):
    from portbench.harness import judge_answers, set_tf32

    set_tf32(run.torch, control == "tf32")
    labels = run.case.answer_labels()
    for seed in seeds:
        window_s, done, sample, _ = run.window(seed, seconds, trace=False)
        limits = {"err": float("inf"), "res": float("inf"), "res_c": float("inf")}
        checks, _ = judge_answers(ref, labels, done, sample, limits)
        its = [r.num_iters for _, r in done]
        yield {"seed": seed, "control": control, "solves": len(done), "solve_s": window_s / len(done),
               "mean_iters": sum(its) / len(its), **{k: c["value"] for k, c in checks.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench: readings need a CUDA device", file=sys.stderr)
        return 2
    from portbench.harness import Run

    run = Run(ROOT, args.workload, "cuda", T_START)
    ref = run.reference()
    for seeds, control in ((args.seeds, None), (args.control_seeds, "tf32")):
        for line in readings(run, ref, seeds, args.seconds, control):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
