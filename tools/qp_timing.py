"""Device time of the per-QP kernel (B2) at the shapes its paths run, for A/B pairs on one card.

Run from the root of a checkout: the package and its ``chip_smoke.py`` are
imported from the current directory, so the same script times any commit
whose ``chip_smoke.py`` has ``_cuda_ms``, ``_diffusion_2d`` and
``_diffusion_3d``::

    cd <checkout> && python3 <this repo>/tools/qp_timing.py [--rounds N]

The shapes, in float32: the p = 4 cylinder's dense (E, c, d1, Q) = (17,456,
4, 4, 512) with the bench kernel's A; the periodic cell's dense (32,768, 1,
3, 64) with the BDF3 advection A; the lattice (d1*c, EQ) rows of the 2D cell
(9, 2,359,296) and of the bench under ``L3STER_TPU_FUSED_Z=0`` (16, 373,248).
Each round takes, per shape, the kernel's time (CUDA events around 10
back-to-back calls queued behind a sleep kernel, median of 20, as
``chip_smoke.py`` times kernels) and a torch copy of as many bytes as the
kernel must move; the rounds' medians are printed with the byte bound
(3.35 TB/s) and the f32 result's error against the f64 plain version.
Prints one JSON line: the package's path, the card's name and power limit,
and the numbers per shape.  Run it in two checkouts in one session on the
card to compare two commits.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import numpy as np

PEAK_BYTES = 3.35e12


def _shapes(lp, cs):
    from l3ster_tpu_torch.algsys.system import _constant_kernel_operators

    def const_A(kern, dim, n_eq, c):
        return _constant_kernel_operators(lp.wrap_domain_equation_kernel(kern, lp.KernelParams(dim, n_eq, c)), 0.0)

    q1_6, q1_4 = (lp.AssemblyOptions().quadrature_order(p) // 2 + 1 for p in (6, 4))
    advection = np.array([[[11.0 / 6.0]], [[0.025]], [[0.0]]])  # BDF3 leading coefficient, u * dt, v * dt
    return {  # name: (A, layout, dim, c, E, Q)
        "cylinder": (const_A(cs._diffusion_3d, 3, 7, 4), "dense", 3, 4, 17456, q1_4**3),
        "periodic": (advection, "dense", 2, 1, 256 * 128, q1_4**2),
        "lattice_2d": (const_A(cs._diffusion_2d, 2, 4, 3), "lattice", 2, 3, 1, 128**2 * q1_6**2),
        "lattice_bench": (const_A(cs._diffusion_3d, 3, 7, 4), "lattice", 3, 4, 1, 6**3 * q1_6**3),
    }


def _inputs(layout, dim, c, E, Q, seed):
    rng = np.random.default_rng(seed)
    EQ = E * Q
    G = rng.normal(size=(E, c, dim + 1, Q) if layout == "dense" else ((dim + 1) * c, EQ))
    ji = rng.normal(size=(dim, dim, EQ)) * 0.1 + np.eye(dim)[:, :, None]
    return G, ji, rng.uniform(0.5, 1.0, EQ)


def _time(lp, cs, rounds: int) -> dict:
    import torch

    from l3ster_tpu_torch.ops import qp

    res = {}
    for name, (A, layout, dim, c, E, Q) in _shapes(lp, cs).items():
        G, ji, w = _inputs(layout, dim, c, E, Q, seed=len(name))
        if layout == "lattice":
            ji = ji.reshape(dim * dim, -1)
        kern = qp.qp_algebra_const if layout == "dense" else qp.qp_algebra_const_lattice
        plain = qp.qp_algebra_const_plain if layout == "dense" else qp.qp_algebra_const_lattice_plain
        d64 = [torch.as_tensor(x, device="cuda") for x in (G, ji, w)]
        ref = plain(A, *d64)
        d32 = [x.float() for x in d64]
        err = float((kern(A, *d32).double() - ref).abs().max() / ref.abs().max())
        del d64, ref
        nbytes = 4 * (2 * G.size + ji.size + w.size)
        src = torch.empty(nbytes // 8, device="cuda")  # read and written: nbytes in all
        dst = torch.empty_like(src)
        ms, copy_ms = [], []
        for _ in range(rounds):
            ms.append(cs._cuda_ms(lambda: kern(A, *d32), queued=True))
            copy_ms.append(cs._cuda_ms(lambda: dst.copy_(src), queued=True))
        del src, dst, d32
        torch.cuda.empty_cache()
        bound = nbytes / PEAK_BYTES * 1e3
        res[name] = dict(
            shape=list(G.shape), ms=statistics.median(ms), ms_rounds=ms, copy_same_bytes_ms=statistics.median(copy_ms),
            bound_ms=bound, share_of_bound=bound / statistics.median(ms), f32_rel_err=err,
        )
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("qp_timing: needs a CUDA device")
    import chip_smoke as cs
    import l3ster_tpu_torch as lp

    print(json.dumps(dict(package=os.path.dirname(lp.__file__), card=cs._smi(), shapes=_time(lp, cs, args.rounds))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
