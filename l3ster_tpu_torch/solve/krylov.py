"""Krylov solvers (PyTorch port of ``l3ster_tpu.solve.krylov``): CG and restarted GMRES.

Plain Python loops over device tensors.  CG never waits for the device
inside an iteration: whether to continue is kept on the device as a flag
that freezes the iterate once every column has converged, and the host reads
that flag every ``CHECK_EVERY`` iterations.  The iterate, the iteration
count and the residual are exactly those of the reference's
``lax.while_loop`` (at most ``CHECK_EVERY - 1`` frozen iterations run past
convergence and change nothing).  GMRES reads its small Hessenberg column
back to the host once per Arnoldi step (the Givens rotations, the early-exit
test and the back substitution run there, in the working dtype), as the
reference's loop condition reads it on its device.  ``verbosity >= 2``
prints every iteration's residual, which waits for the device each time.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field

import torch

from .interface import IterSolveResult, IterSolverOpts
from .precond import Identity

__all__ = ["CHECK_EVERY", "cg_solve", "gmres_solve", "CG", "Gmres"]

CHECK_EVERY = 10  # iterations between host reads of the convergence flag


def _lattice_solve_layout(system, precond) -> str:
    """"lattice" when both the operator and the preconditioner can run on
    channel-major vectors (see ``MatrixFreeSystem.lattice_layout_key``): the
    Krylov loop then skips the operator's per-apply entry/exit transposes,
    converting layouts once per solve."""
    lk = getattr(system, "lattice_layout_key", None)
    if lk is None or not getattr(precond, "supports_lattice_layout", False):
        return "dof"
    return "lattice" if lk() is not None else "dof"


def _precond_parts(precond, system, layout: str = "dof"):
    """(apply(r, *consts), consts) for a preconditioner; a preconditioner with
    only ``setup(system)`` runs in the dof layout.

    Results are cached on the system keyed by (preconditioner, assembly
    epoch, layout): repeated solves between reassemblies reuse the setup,
    and ``end_assembly`` (which bumps the epoch) invalidates it.  An integer
    ``lag = k`` attribute reuses the setup for up to k reassemblies (epochs
    are bucketed by k + 1); ``lag = "auto"`` keeps it until the solver sees
    the iteration count degrade past ``refresh_ratio`` times the count of
    the first solve after the setup (:func:`_note_precond_iters`)."""
    epoch = getattr(system, "_assembly_epoch", None)
    lag = getattr(precond, "lag", 0) or 0
    if lag == "auto" and epoch is not None:
        st = _auto_refresh_state(system, precond)
        if st["stale"] or st["epoch"] is None:
            st["epoch"], st["stale"], st["baseline"] = epoch, False, None
        epoch = st["epoch"]
    elif lag and epoch is not None:
        epoch = epoch - (epoch % (int(lag) + 1))
    key = None
    if epoch is not None:
        try:
            key = (precond, epoch, layout)
            hash(key)
        except TypeError:
            key = None
    if key is not None:
        cache = getattr(system, "_precond_parts_cache", None)
        if cache is None:
            cache = system._precond_parts_cache = {}
        else:
            # drop stale setups of earlier (bucketed) epochs, per entry, so a
            # lagged preconditioner's live bucket survives others' refreshes
            for k in [k for k in cache if k[0] == precond and k[1] != epoch]:
                del cache[k]
            if len(cache) > 16:  # bound abandoned preconditioners' entries
                cache.clear()
        hit = cache.get(key)
        if hit is not None:
            return hit
    setup_parts = getattr(precond, "setup_parts", None)
    if setup_parts is not None:
        parts = setup_parts(system, layout=layout) if layout != "dof" else setup_parts(system)
    elif layout != "dof":
        raise ValueError(f"{type(precond).__name__} does not support layout={layout!r}")
    else:
        M = precond.setup(system)
        parts = (lambda r, *pc: M(r)), ()
    if key is not None:
        cache[key] = parts
    return parts


def _auto_refresh_state(system, precond) -> dict:
    """The ``lag="auto"`` refresh state of one preconditioner object on a
    system, keyed by ``id`` with the object pinned in the value (two equal
    preconditioner configurations keep separate states)."""
    states = getattr(system, "_precond_auto", None)
    if states is None:
        states = system._precond_auto = {}
    st = states.get(id(precond))
    if st is None:
        st = states[id(precond)] = {"epoch": None, "stale": True, "baseline": None, "_pin": precond}
    return st


def _note_precond_iters(system, precond, iters: int) -> None:
    """Feed a solve's iteration count back to a ``lag="auto"`` preconditioner:
    the first solve after a setup sets the baseline, and a solve taking more
    than ``refresh_ratio`` times the baseline marks the setup stale (it is
    redone at the next setup).  No-op for other preconditioners."""
    if getattr(precond, "lag", 0) != "auto" or iters <= 0:
        return
    st = _auto_refresh_state(system, precond)
    if st["baseline"] is None:
        st["baseline"] = max(int(iters), 1)
    elif iters > float(getattr(precond, "refresh_ratio", 1.35)) * st["baseline"]:
        st["stale"] = True


def _chunk_iters(o: IterSolverOpts) -> int:
    """The iteration bound of one run of the loop under ``IterSolverOpts.chunk``."""
    if not o.chunk:
        return o.max_iters
    if o.residual_scaling == "initial":
        raise ValueError(
            "chunked solves are incompatible with residual_scaling='initial' "
            "(each restart would re-normalize to its own initial residual)"
        )
    return min(int(o.chunk), o.max_iters)


def _run_chunked(solve, o: IterSolverOpts, x0):
    """Drive ``solve(x0) -> (x, iters, res)`` to convergence with warm
    restarts of at most ``chunk`` iterations (``IterSolverOpts.chunk``).
    Returns (x, total iterations, res)."""
    x, it, res = solve(x0)
    total = it
    if not o.chunk:
        return x, total, res
    while total < o.max_iters and res > o.tol and it > 0:
        x, it, res = solve(x)
        total += it
    return x, total, res


def _col_dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-column inner products of (..., n_rhs) multivectors -> (n_rhs,):
    the sum runs over every leading axis, so a distributed system's stacked
    (n_shards, n_loc, n_rhs) vectors (ghost and dump slots held at zero)
    reduce like (n, n_rhs) ones.  It takes each shard's partial sum first and
    then sums the partials over the shards (the reference's local sum and
    ``psum``), so shards placed on several devices
    (``parallel/sharded.py:ShardedStack``) sum in the same order as on one."""
    ab = a * b
    return ab.reshape(ab.shape[0], -1, ab.shape[-1]).sum(dim=1).sum(dim=0)


def _residual_scale(b, r0, residual_scaling: str):
    """Residual normalization (``solve/SolverInterface.hpp:26-37``):
    "rhs" (norm of b, the default), "initial" (norm of r0), or "none"."""
    if residual_scaling == "rhs":
        s = _col_dots(b, b).sqrt()
    elif residual_scaling == "initial":
        s = _col_dots(r0, r0).sqrt()
    elif residual_scaling == "none":
        return torch.ones(b.shape[-1], dtype=b.dtype, device=b.device)
    else:
        raise ValueError(f"unknown residual_scaling {residual_scaling!r}")
    return torch.where(s > 0, s, torch.ones_like(s))


def _safe_div(a, d):
    ok = d != 0
    return torch.where(ok, a / torch.where(ok, d, torch.ones_like(d)), torch.zeros_like(a))


def cg_solve(operator, b, x0=None, precond=None, tol=1e-10, max_iters=1000, residual_scaling="rhs",
             verbosity=0):
    """Preconditioned conjugate gradients on an SPD operator; multivector RHS.

    Each right-hand-side column iterates with its own step lengths; the loop
    runs while the largest relative residual exceeds ``tol``.  Returns
    (x, n_iters, achieved relative residual) with host int and float.
    ``verbosity >= 2`` prints each iteration's relative residual.
    """
    b = b[:, None] if b.ndim == 1 else b
    x = torch.zeros_like(b) if x0 is None else x0
    M = precond if precond is not None else (lambda r: r)
    r = b - operator(x)
    bnorm = _residual_scale(b, r, residual_scaling)
    z = M(r)
    p = z
    rz = _col_dots(r, z)
    active = ((_col_dots(r, r).sqrt() / bnorm).max() > tol) & (max_iters > 0)
    it = torch.zeros((), dtype=torch.int64, device=b.device)
    done = 0
    while done < max_iters:
        for k in range(min(CHECK_EVERY, max_iters - done)):
            Ap = operator(p)
            alpha = _safe_div(rz, _col_dots(p, Ap)) * active
            x = x + alpha * p
            r = r - alpha * Ap
            z = M(r)
            rz_new = _col_dots(r, z)
            p = torch.where(active, z + _safe_div(rz_new, rz) * p, p)
            rz = torch.where(active, rz_new, rz)
            it = it + active
            res = (_col_dots(r, r).sqrt() / bnorm).max()
            active = active & (res > tol)
            if verbosity >= 2 and bool(it > done + k):  # an iteration that ran
                print(f"CG it {int(it)}: rel res {float(res):.3e}")
        done += min(CHECK_EVERY, max_iters - done)
        if not bool(active):
            break
    res = (_col_dots(r, r).sqrt() / bnorm).max()
    return x, int(it), float(res)


_TINY = 1e-30  # GMRES's breakdown threshold


def _gmres_div(a, d):
    """a / d where |d| > 1e-30, else 0 (GMRES's safe division)."""
    ok = d.abs() > _TINY
    return torch.where(ok, a / torch.where(ok, d, torch.ones_like(d)), torch.zeros_like(a))


def _back_substitute(R: torch.Tensor, g: torch.Tensor, m: int) -> torch.Tensor:
    """Solve R y = g for upper-triangular R (m, m, n_rhs), g (m, n_rhs); a
    zero diagonal entry (happy breakdown, or rows past the cycle's last
    step) gives y = 0 in that row instead of NaN."""
    y = torch.zeros_like(g)
    for j in range(m - 1, -1, -1):
        y[j] = _gmres_div(g[j] - (R[j] * y).sum(dim=0), R[j, j])
    return y


def gmres_solve(operator, b, x0=None, precond=None, tol=1e-10, max_iters=1000, restart=50,
                residual_scaling="rhs", verbosity=0):
    """Restarted GMRES(m): Arnoldi with modified Gram-Schmidt and Givens rotations.

    Analog of the Belos GMRES (``solve/BelosSolvers.hpp:124-127``): each
    right-hand-side column runs its own Hessenberg system; left
    preconditioned; an Arnoldi cycle stops early once every column's Givens
    residual estimate predicts convergence, and convergence is decided on the
    true (unpreconditioned) relative residual after each cycle.  The Krylov
    vectors stay on the device; each step's Hessenberg column is read back
    and rotated on the host in the working dtype.  Returns (x, honest
    inner-iteration count, achieved relative residual) with host int and
    float.  ``verbosity >= 2`` prints the residual after each cycle.
    """
    b2 = b[:, None] if b.ndim == 1 else b
    x = torch.zeros_like(b2) if x0 is None else (x0[:, None] if x0.ndim == 1 else x0)
    M = precond if precond is not None else (lambda r: r)
    m = int(max(1, min(restart, max_iters)))
    n_rhs, dt = b2.shape[-1], b2.dtype
    host = dict(dtype=dt, device="cpu")

    r = b2 - operator(x)
    bnorm = _residual_scale(b2, r, residual_scaling)
    bnorm_h = bnorm.cpu()
    res = ((_col_dots(r, r).sqrt() / bnorm).max()).cpu()
    it = 0
    while it < max_iters and bool(res > tol):
        z = M(b2 - operator(x))
        beta = _col_dots(z, z).sqrt()
        V = [z * _gmres_div(torch.ones_like(beta), beta)]
        R = torch.zeros((m + 1, m, n_rhs), **host)
        cs, sn = torch.zeros((m, n_rhs), **host), torch.zeros((m, n_rhs), **host)
        g = torch.zeros((m + 1, n_rhs), **host)
        g[0] = beta.cpu()
        # the preconditioned estimate |g[j]| at the cycle's start stands for the
        # known true residual; 0.25 absorbs the drift of their ratio in a cycle
        est0 = (g[0] / bnorm_h).max()
        inner_tol = 0.25 * tol * _gmres_div(est0, torch.clamp(res, min=_TINY))
        j = 0
        while j < m and (j == 0 or bool((g[j].abs() / bnorm_h).max() > inner_tol)):
            w = M(operator(V[j]))
            hs = []
            for i in range(j + 1):
                hi = _col_dots(V[i], w)
                hs.append(hi)
                w = w - V[i] * hi
            hj1 = _col_dots(w, w).sqrt()
            V.append(w * _gmres_div(torch.ones_like(hj1), hj1))
            h = torch.zeros((m + 1, n_rhs), **host)
            h[: j + 2] = torch.stack(hs + [hj1]).cpu()
            for i in range(j):
                h[i], h[i + 1] = cs[i] * h[i] + sn[i] * h[i + 1], -sn[i] * h[i] + cs[i] * h[i + 1]
            denom = (h[j] ** 2 + h[j + 1] ** 2).sqrt()
            cs[j] = torch.where(denom > _TINY, _gmres_div(h[j], denom), torch.ones_like(denom))
            sn[j] = _gmres_div(h[j + 1], denom)
            h[j], h[j + 1] = denom, 0.0
            g[j + 1], g[j] = -sn[j] * g[j], cs[j] * g[j]
            R[:, j] = h
            j += 1
        y = _back_substitute(R[:m], g[:m], m).to(b2.device)
        upd = V[0] * y[0]
        for i in range(1, j):
            upd = upd + V[i] * y[i]
        x = x + upd
        r = b2 - operator(x)
        res = ((_col_dots(r, r).sqrt() / bnorm).max()).cpu()
        it += j
        if verbosity >= 2:
            print(f"GMRES it {it}: rel res {float(res):.3e}")
    return (x[:, 0] if b.ndim == 1 else x), it, float(res)


def _finish_iter_solve(system, precond, name: str, o: IterSolverOpts, it: int, res: float):
    """Shared solve epilogue: auto-lag feedback, LOUD cap-hit signal and the
    result record.

    A solve that stops at ``max_iters`` without meeting ``tol`` always raises
    a ``RuntimeWarning`` and is recorded on the system for ``describe()``."""
    _note_precond_iters(system, precond, it)
    converged = res <= o.tol
    capped = (not converged) and it >= o.max_iters
    result = IterSolveResult(tol=res, num_iters=it, converged=converged, capped=capped)
    system._last_solve_result = result
    if capped:
        warnings.warn(
            f"{name}: NOT CONVERGED — hit max_iters={o.max_iters} at relative "
            f"residual {res:.3e} (tol {o.tol:.1e})",
            RuntimeWarning,
            stacklevel=3,
        )
    if o.verbosity >= 1:
        state = "" if converged else ("  [CAPPED]" if capped else "  [not converged]")
        print(f"{name}: {it} iterations, relative residual {res:.3e}{state}")
    return result


@dataclass
class CG:
    """User-facing CG solver (``solve/BelosSolvers.hpp:116``).

    Solves in the lattice layout when the operator and the preconditioner
    support it, converting the vectors once per solve; the preconditioner's
    setup is cached per assembly epoch (:func:`_precond_parts`).  Under
    ``opts.chunk`` the loop restarts every ``chunk`` iterations
    (:func:`_run_chunked`)."""

    opts: IterSolverOpts = field(default_factory=IterSolverOpts)
    precond: object = field(default_factory=Identity)

    def solve(self, system) -> IterSolveResult:
        o = self.opts
        layout = _lattice_solve_layout(system, self.precond)
        lattice = layout == "lattice"
        fn, consts = system.operator_parts(layout=layout)
        M_fn, M_consts = _precond_parts(self.precond, system, layout)
        b, x0 = system.effective_rhs(), system.solution_vector()
        if lattice:
            b, x0 = system.to_lattice_layout(b), system.to_lattice_layout(x0)
        inner = _chunk_iters(o)
        x, it, res = _run_chunked(
            lambda x_start: cg_solve(
                lambda v: fn(v, *consts), b, x0=x_start, precond=lambda r: M_fn(r, *M_consts),
                tol=o.tol, max_iters=inner, residual_scaling=o.residual_scaling, verbosity=o.verbosity,
            ),
            o, x0,
        )
        if lattice:
            x = system.from_lattice_layout(x)
        system.set_solution_vector(x)
        return _finish_iter_solve(system, self.precond, "CG", o, it, res)


@dataclass
class Gmres:
    """User-facing restarted GMRES solver (``solve/BelosSolvers.hpp:124``);
    ``opts.restart`` is the cycle length.  Layouts, the preconditioner's
    setup cache and ``opts.chunk`` as in :class:`CG`."""

    opts: IterSolverOpts = field(default_factory=IterSolverOpts)
    precond: object = field(default_factory=Identity)

    def solve(self, system) -> IterSolveResult:
        o = self.opts
        layout = _lattice_solve_layout(system, self.precond)
        lattice = layout == "lattice"
        fn, consts = system.operator_parts(layout=layout)
        M_fn, M_consts = _precond_parts(self.precond, system, layout)
        b, x0 = system.effective_rhs(), system.solution_vector()
        if lattice:
            b, x0 = system.to_lattice_layout(b), system.to_lattice_layout(x0)
        inner = _chunk_iters(o)
        x, it, res = _run_chunked(
            lambda x_start: gmres_solve(
                lambda v: fn(v, *consts), b, x0=x_start, precond=lambda r: M_fn(r, *M_consts),
                tol=o.tol, max_iters=inner, restart=o.restart, residual_scaling=o.residual_scaling,
                verbosity=o.verbosity,
            ),
            o, x0,
        )
        if lattice:
            x = system.from_lattice_layout(x)
        system.set_solution_vector(x)
        return _finish_iter_solve(system, self.precond, "GMRES", o, it, res)
