"""The ``multi_device`` phases of ``chip_smoke.py`` alone, on every card of the machine.

Run from the root of a checkout (the package and its ``chip_smoke.py`` are
imported from the current directory)::

    python3 tools/multi_device.py [--small]

On a machine with D >= 2 cards the shards are placed on the first min(D, 4)
(the cylinder's 4 shards) or 2 (the box's 2 z slabs) cards, on one card on
two placement groups of it (``chip_smoke.py:_multi_devices``).  Builds the
z-sweep (B1) and per-QP (B2) kernels, then runs ``phase_multi_device_box`` on
the bench system (p = 6 on 6^3 hexes, f32) and, after the single cylinder's
CG + Jacobi and ``phase_distributed`` (the one-group distributed system),
``phase_multi_device_distributed`` on the default cylinder (p = 4, f32).
``--small`` takes the bench at p = 2 on 3^3 hexes and the small cylinder at
p = 2 (a quick check of a new card setup).  Prints the card's name and power
limit, the phases' JSON lines and the elapsed seconds; exits non-zero on a
failed check.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true", help="small bench and cylinder")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    import l3ster_tpu_torch as lp
    from l3ster_tpu_torch.ops import _cuda

    if not torch.cuda.is_available():
        raise SystemExit("multi_device: no CUDA device")
    print(cs._smi(), flush=True)
    t0 = time.time()
    _cuda.build("qp_algebra", "zsweep")
    order, n_1d = (2, 4) if args.small else (6, 7)
    mesh, system = cs._build_system(lp, order, n_1d, torch.float32, "cuda")
    cs.phase_multi_device_box(lp, dict(system=system, mesh=mesh))
    del system
    torch.cuda.empty_cache()
    mesh = cs._cylinder_mesh(lp, 2 if args.small else cs.CYL_ORDER, small=args.small)
    single = cs._build_cylinder(lp, mesh, "AUTO", torch.float32, "cuda")
    opts = lp.IterSolverOpts(tol=cs.CYL_CG_TOL, max_iters=cs.CYL_CG_MAX_ITERS)
    r = single.solve(lp.CG(opts, precond=lp.Jacobi()))
    state = dict(system=single, mesh=mesh)
    _, dist_state = cs.phase_distributed(lp, state, r.num_iters)
    cs.phase_multi_device_distributed(lp, state, dist_state)
    print(f"multi_device: {time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
