"""Wall time of the host-bound lattice applies of one checkout, for A/B pairs on one card.

Run from the root of a checkout: the package and its ``chip_smoke.py`` are
imported from the current directory, so the same script times any commit
whose ``chip_smoke.py`` has ``_build_system`` and ``_var_diffusion_3d``::

    cd <checkout> && python3 <this repo>/tools/apply_timing.py [--rounds N]

It builds the bench system (p = 6, 6^3 hexes, constant coefficients) and the
var bench system (k = 1 + x*y) in float32 on the card, as ``chip_smoke.py``
does, then times their operator applies in N alternating rounds (default 5):
each round the median over 20 CUDA-event pairs around 10 back-to-back
applies.  Back-to-back applies let the card run ahead of the host, so on
these host-bound applies the number is the host's time per apply.  Each
round also takes the host's own time per call (``perf_counter`` around 5
calls queued behind a sleep kernel, so the host never waits on the card),
of each apply and of the z-sweep wrapper alone at the bench shapes
(constant A with diagonal geometry, the bench's; variable A with full
geometry, the var bench's).  Prints one JSON line: the package's path, the
card's name and power limit, and each timing's per-round ms with their
median.  Running two checkouts in turn in one call (A B B A ...) compares
them on one card and one host.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

import numpy as np


def _ms(fn, reps: int = 20, batch: int = 10, warm: int = 3) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def _host_ms(fn, reps: int = 20, batch: int = 5) -> float:
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(100_000_000)  # ~50 ms of card time: the host never waits on it
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / batch)
        torch.cuda.synchronize()
    return statistics.median(times)


def main() -> int:
    rounds = int(sys.argv[sys.argv.index("--rounds") + 1]) if "--rounds" in sys.argv else 5
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("apply_timing: needs a CUDA card")
    import chip_smoke as cs
    import l3ster_tpu_torch as lp

    applies = {}
    for name, kernel in (("bench", cs._diffusion_3d), ("var_bench", cs._var_diffusion_3d)):
        _, system = cs._build_system(lp, 6, 7, torch.float32, "cuda", kernel)
        fn, consts = system.operator_parts(layout="lattice")
        x = torch.as_tensor(np.random.default_rng(2).normal(size=(system.n_dofs, 1)), dtype=torch.float32)
        xl = system.to_lattice_layout(x.cuda())
        applies[name] = lambda fn=fn, consts=consts, xl=xl: fn(xl, *consts)
    from l3ster_tpu_torch.ops.zsweep import fused_z_sweep

    inp = cs._bench_kernel_inputs(lp, seed=0)
    b, bdy, bdx, geom, tabs, _ = cs._bench_args(inp, torch.float32, "diag")
    zsweeps = {"zsweep_const": lambda: fused_z_sweep(inp["A"], b, bdy, bdx, geom, tabs)}
    vb, vbdy, vbdx, vgeom, vtabs, A_nz = cs._bench_args(inp, torch.float32, "full")
    zsweeps["zsweep_var"] = lambda: fused_z_sweep(None, vb, vbdy, vbdx, vgeom, vtabs, var=(inp["nz"], A_nz, 7))
    times = {k: [] for k in [*applies, *(f"{a}_host" for a in applies), *(f"{z}_host" for z in zsweeps)]}
    for _ in range(rounds):
        for name, apply in applies.items():
            times[name].append(_ms(apply))
            times[f"{name}_host"].append(_host_ms(apply))
        for name, call in zsweeps.items():
            times[f"{name}_host"].append(_host_ms(call))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    out = {"package": os.path.dirname(lp.__file__), "nvidia_smi": smi}
    for name, t in times.items():
        out[f"{name}_ms"] = t
        out[f"{name}_median_ms"] = statistics.median(t)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
