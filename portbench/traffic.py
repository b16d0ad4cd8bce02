"""The one traffic generator: reads a mix file and draws requests from a seed.

A mix (``traffic/<mix>.json``) states the loop (closed, one client, back to
back), the solver and preconditioner by the program's public names with
their arguments, the warm-up solve's iteration cap, and how each request's
data are drawn: ``{"uniform": [lo, hi]}`` per named value.  The same seed
gives the same requests, in the same order.
"""

from __future__ import annotations

import numpy as np


def requests(mix: dict, seed: int):
    """Endless requests {name: value} drawn from ``seed``."""
    rng = np.random.default_rng(int(seed))
    spec = mix["data"]
    while True:
        req = {}
        for name, law in spec.items():
            (kind, args), = law.items()
            if kind != "uniform":
                raise ValueError(f"unknown law {kind!r} for {name!r}")
            req[name] = float(rng.uniform(*args))
        yield req


def solver(lp, mix: dict):
    """(solver object, preconditioner object) named by the mix."""
    s, p = mix["solver"], mix["precond"]
    precond = getattr(lp, p["name"])(**p.get("args", {}))
    opts = lp.IterSolverOpts(tol=s["tol"], max_iters=int(s["max_iters"]))
    return getattr(lp, s["name"])(opts, precond=precond), precond
