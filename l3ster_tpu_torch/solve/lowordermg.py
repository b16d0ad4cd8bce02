"""Low-order-rediscretized geometric multigrid preconditioner (PyTorch port of
``l3ster_tpu.solve.lowordermg``).

Preconditions the order-p LSFEM normal equations with the same least-squares
kernels rediscretized at p = 1 on the GLL node lattice (FEM-SEM spectral
equivalence) and solves the low-order system approximately with a
geometric V-cycle:

- level 0 is the fine system itself (``fine_level0``, the default for a
  matrix-free system) or an order-1 system on all GLL nodes; every coarser
  level is an order-1 matrix-free system on every second lattice node,
  assembled by replaying the fine system's operator contributions by
  domain and boundary id, so its operator takes the port's lattice kinds
  (and the z-sweep kernel) on a 3D box;
- transfers are per-axis linear-interpolation bands applied as three small
  contractions;
- smoothing is Jacobi-scaled Chebyshev, with lambda_max from a power
  iteration at setup;
- the coarsest level is the dense inverse of an assembled order-1 system,
  inverted on the host in float64 and held on the device.

Every level is built on the fine system's device and in its dtype.  Works
for systems whose volume discretization lives on a structured lattice with
lex node numbering (``generate_mesh(make_cube_mesh/make_square_mesh(...))``)
and whose boundary ids follow the generator defaults.

On a :class:`~l3ster_tpu_torch.parallel.box.BoxSystem` the V-cycle is
window-decomposed: level 0 smooths with the box operator itself, the
restriction contracts each shard's window with window-sliced interpolation
bands (ghost and padding rows zero) and sums over the shards, and every
level below runs on the whole coarse vector, as on one device (on shards
placed on several devices, the first group's device).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["LowOrderMG"]


def _axis_coords(mesh):
    """Per-axis sorted coordinates of a lattice mesh + lex-order check."""
    nc = np.asarray(mesh.node_coords)
    dim = mesh.dim
    axes = []
    for a in range(dim):
        axes.append(np.unique(np.round(nc[:, a], 12)))
    if int(np.prod([len(a) for a in axes])) != mesh.n_nodes:
        return None
    # verify lex (x fastest) numbering
    grids = np.meshgrid(*reversed(axes), indexing="ij")  # (z, y, x) order
    rec = np.stack([g.reshape(-1) for g in reversed(grids)], axis=1)
    if not np.allclose(rec, nc[:, :dim], atol=1e-10):
        return None
    return axes


def _perm_to_lat(v, n_rows: int, n_unk: int):
    """dof-major (node*n_unk+u) rows -> channel-major (u*n_rows+node); numpy or torch."""
    v2 = v[:, None] if v.ndim == 1 else v
    out = v2.reshape(n_rows, n_unk, v2.shape[1]).swapaxes(0, 1).reshape(v2.shape)
    return out[:, 0] if v.ndim == 1 else out


def _perm_from_lat(v, n_rows: int, n_unk: int):
    v2 = v[:, None] if v.ndim == 1 else v
    out = v2.reshape(n_unk, n_rows, v2.shape[1]).swapaxes(0, 1).reshape(v2.shape)
    return out[:, 0] if v.ndim == 1 else out


def _coarsen(idx: np.ndarray) -> np.ndarray:
    """Every-2nd-node coarsening keeping both endpoints."""
    n = len(idx)
    keep = list(range(0, n, 2))
    if keep[-1] != n - 1:
        keep.append(n - 1)
    return idx[np.asarray(keep)]


def _interp_1d(fine: np.ndarray, coarse: np.ndarray) -> np.ndarray:
    """P (n_fine, n_coarse): piecewise-linear interpolation weights."""
    nf, ncr = len(fine), len(coarse)
    P = np.zeros((nf, ncr))
    seg = np.clip(np.searchsorted(coarse, fine, side="right") - 1, 0, ncr - 2)
    x0, x1 = coarse[seg], coarse[seg + 1]
    t = np.where(x1 > x0, (fine - x0) / np.where(x1 > x0, x1 - x0, 1.0), 0.0)
    P[np.arange(nf), seg] = 1.0 - t
    P[np.arange(nf), seg + 1] = t
    return P


def _cheb(fn_l, r, z0, dinv, lam_max, ocs, degree, eig_ratio, z0_zero=False):
    """Chebyshev iteration on D^-1 A of the given degree, starting from z0
    (standard smoothing recurrence).  ``z0_zero`` skips the first operator
    apply (the defect of a zero iterate is r)."""
    if degree <= 0:
        return z0
    lmax = lam_max
    lmin = lmax / eig_ratio
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    z = z0
    resid = dinv[..., None] * (r if z0_zero else r - fn_l(z, *ocs))
    p = resid / theta
    z = z + p
    rho = delta / theta
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * theta / delta - rho)
        resid = dinv[..., None] * (r - fn_l(z, *ocs))
        p = rho_new * (2.0 / delta * resid + rho * p)
        z = z + p
        rho = rho_new
    return z


def _p1_system(system, axes, strategy):
    """An order-1 system on the lattice ``axes`` with the fine system's
    problem, boundary conditions, dtype and device, its operator assembled
    by replaying the fine system's operator contributions by id."""
    import l3ster_tpu_torch as lt

    from ..common.problem import AlgebraicSystemParams

    dim = system.mesh.dim
    if dim == 3:
        base = lt.make_cube_mesh(axes[0], axes[1], axes[2])
    elif dim == 2:
        base = lt.make_square_mesh(axes[0], axes[1])
    else:
        raise ValueError("LowOrderMG supports 2D/3D lattice meshes")
    mesh1 = lt.generate_mesh(base, order=1)
    params = AlgebraicSystemParams(eval_strategy=strategy, n_rhs=1)
    s1 = lt.make_algebraic_system(
        mesh1, system.problem, system.bc_def, params, dtype=system.dtype, device=system.device
    )
    ids = [c.boundary_id if c.boundary_id is not None else c.domain_id for c in system._contribs]
    missing = sorted({rid for rid in ids if rid not in s1.mesh.domains})
    if missing:
        raise ValueError(
            f"LowOrderMG: fine-system domain ids {missing} not present "
            "on the generated low-order mesh (custom boundary ids are unsupported)"
        )
    s1.begin_assembly()
    for c, rid in zip(system._contribs, ids):
        if c.mode == "rhs":
            continue
        s1.assemble_problem(c.kernel, [rid], dof_inds=c.dof_inds, time=c.time, mode="operator")
    s1.end_assembly()
    return s1


def _build_p1_system(system, axes):
    """A matrix-free order-1 level (``lowordermg.py:114-155``); no assembly
    options, so its contributions take AUTO."""
    from ..common.enums import OperatorEvaluationStrategy

    return _p1_system(system, axes, OperatorEvaluationStrategy.MATRIX_FREE)


def _assembled_dense_inv(system, axes) -> np.ndarray:
    """Coarsest level: the float64 dense inverse, on the host, of the
    Dirichlet-eliminated assembled order-1 matrix."""
    from ..common.enums import OperatorEvaluationStrategy

    s1 = _p1_system(system, axes, OperatorEvaluationStrategy.GLOBAL_ASSEMBLY)
    return np.linalg.inv(s1.eliminated_dense())


def _power_start(level: int, n: int, dtype, device) -> torch.Tensor:
    """The power iteration's start vector (n, 1): drawn in float64 on the CPU
    from a generator seeded with the level index, then cast and moved, so the
    CPU and the card start alike."""
    g = torch.Generator().manual_seed(level)
    return torch.randn((n, 1), generator=g, dtype=torch.float64).to(dtype=dtype, device=device)


def _lambda_max(fn, ocs, dinv, v) -> float:
    """lambda_max of D^-1 A by 15 power-iteration steps from v (setup time)."""
    for _ in range(15):
        w = dinv[..., None] * fn(v, *ocs)
        v = w / torch.linalg.norm(w)
    w = dinv[..., None] * fn(v, *ocs)
    return float((v * w).sum() / (v * v).sum())


@dataclass(frozen=True)
class LowOrderMG:
    """p->1 rediscretization + geometric V-cycle preconditioner.

    ``n_levels`` counts lattice levels including the fine GLL lattice
    (level 0 is order-1 elements on ALL GLL nodes, or the fine operator
    itself under ``fine_level0``); the coarsest level is a dense inverse.
    ``smooth_degree`` is the Chebyshev smoothing degree per pre/post sweep;
    ``pre_degree`` the pre-smoothing degree (None: ``smooth_degree``; 0
    skips pre-smoothing and the defect apply, a nonsymmetric V(0, k)
    cycle); ``cycles`` stacks V-cycles per application; ``lag`` reuses the
    hierarchy across up to ``lag`` reassemblies.
    """

    n_levels: int = 3
    smooth_degree: int = 2
    pre_degree: int | None = None
    cycles: int = 1
    fine_level0: bool | None = None  # None -> auto (True for matrix-free systems)
    lag: int = 0
    coarse_max_dofs: int = 4000
    eig_ratio: float = 8.0
    # channel-major vectors supported end to end: level operators run
    # ``operator_parts(layout="lattice")`` where available (else per-apply
    # permutations), transfers work on the channel-leading tensor view, and
    # the coarse dense inverse is permuted at setup
    supports_lattice_layout = True

    def setup(self, system):
        apply, pc = self.setup_parts(system)
        return lambda r: apply(r, *pc)

    def _hierarchy(self, axes, n_unk: int) -> list:
        """The lattice levels' axis index subsets, coarsened until the
        coarsest fits the dense inverse."""
        level_axes = [axes]
        while len(level_axes) < self.n_levels:
            cand = [_coarsen(a) for a in level_axes[-1]]
            ndofs = int(np.prod([len(a) for a in cand])) * n_unk
            level_axes.append(cand)
            if ndofs <= self.coarse_max_dofs:
                break
        # coarsen further until the dense inverse is affordable
        while int(np.prod([len(a) for a in level_axes[-1]])) * n_unk > self.coarse_max_dofs:
            if all(len(a) <= 2 for a in level_axes[-1]):
                break
            level_axes.append([_coarsen(a) for a in level_axes[-1]])
        return level_axes

    def setup_parts(self, system, layout: str = "dof"):
        from ..algsys.system import MatrixFreeSystem
        from ..parallel.box import BoxSystem

        if isinstance(system, BoxSystem):
            if layout != "dof":
                raise ValueError("box LowOrderMG runs on the stacked window layout")
            return self._setup_parts_box(system)
        if hasattr(system, "n_loc1"):  # DistributedSystem
            raise ValueError(
                "LowOrderMG needs a structured lattice; on multiple chips use "
                "box_parallelize(system, ...) (window-decomposed LowOrderMG, "
                "the intended pairing for structured meshes) or "
                "PMultigrid (distributed-native, any mesh)"
            )
        lat = layout == "lattice"
        axes = _axis_coords(system.mesh)
        if axes is None:
            raise ValueError(
                "LowOrderMG requires a structured lattice mesh with lex node numbering"
            )
        dtype, device = system.dtype, system.device
        dim = system.mesh.dim
        n_unk = system.n_dofs // system.mesh.n_nodes
        if n_unk * system.mesh.n_nodes != system.n_dofs:
            raise ValueError("LowOrderMG requires uniform dofs per node")
        level_axes = self._hierarchy(axes, n_unk)

        levels = []
        consts: list = []
        fine0 = self.fine_level0
        if fine0 is None:
            # the fine operator is cheaper than p1-on-GLL on the matrix-free
            # path; assembled systems keep the rediscretized level 0
            fine0 = isinstance(system, MatrixFreeSystem)
        for li, ax in enumerate(level_axes[:-1]):
            s_l = system if (li == 0 and fine0) else _build_p1_system(system, ax)
            n_rows_l = s_l.n_dofs // n_unk
            if lat:
                try:
                    fn, oc = s_l.operator_parts(layout="lattice")
                except ValueError:
                    # level operator without the lattice layout: permute per apply
                    fn_dof, oc = s_l.operator_parts()

                    def fn(x, *ocs, _f=fn_dof, _n=n_rows_l):
                        return _perm_to_lat(_f(_perm_from_lat(x, _n, n_unk), *ocs), _n, n_unk)

            else:
                fn, oc = s_l.operator_parts()
            d_l = s_l.diagonal()
            dinv = torch.where(d_l.abs() > 1e-14, 1.0 / d_l, torch.ones_like(d_l))
            if lat:
                dinv = _perm_to_lat(dinv, n_rows_l, n_unk)
            lam = _lambda_max(fn, oc, dinv, _power_start(li, s_l.n_dofs, dtype, device)) * 1.05
            free_l = s_l.free_mask
            if lat:
                free_l = _perm_to_lat(free_l, n_rows_l, n_unk)
            levels.append(dict(fn=fn, off=len(consts), n_oc=len(oc), lam_max=lam, n_dofs=s_l.n_dofs))
            consts.extend(oc)
            levels[-1]["dinv_pos"] = len(consts)
            consts.append(dinv)
            consts.append(free_l)
            # transfer to the next level: per-axis linear interpolation bands
            Ps = [
                torch.as_tensor(_interp_1d(fa, ca), dtype=dtype, device=device)
                for fa, ca in zip(ax, level_axes[li + 1])
            ]
            levels[-1]["P_pos"] = len(consts)
            consts.extend(Ps)

        Binv = _assembled_dense_inv(system, level_axes[-1])
        if lat:
            # permute the dense inverse into channel-major indexing once
            n_rows_c = Binv.shape[0] // n_unk
            dof_of_lat = (np.arange(n_rows_c)[None, :] * n_unk + np.arange(n_unk)[:, None]).ravel()
            Binv = Binv[np.ix_(dof_of_lat, dof_of_lat)]
        coarse_pos = len(consts)
        consts.append(torch.as_tensor(Binv, dtype=dtype, device=device))
        smooth_degree = self.smooth_degree
        pre_degree = self.pre_degree if self.pre_degree is not None else self.smooth_degree
        cycles = self.cycles
        eig_ratio = self.eig_ratio
        n_levels = len(levels)

        def cheb(fn_l, r, z0, dinv, lam_max, ocs, degree, z0_zero=False):
            return _cheb(fn_l, r, z0, dinv, lam_max, ocs, degree, eig_ratio, z0_zero)

        def restrict(x, Ps):
            # x (n_f, m) -> coarse via P^T per axis, channel-leading tensors
            shp_f = tuple(P.shape[0] for P in reversed(Ps))  # (z, y, x)
            m = x.shape[1]
            if lat:
                # channel-major rows: the tensor view is free; m rides as a
                # trailing axis through the per-axis band contractions
                t = x.reshape((n_unk,) + shp_f + (m,))
                if len(Ps) == 3:
                    t = torch.einsum("czyxm,xX->czyXm", t, Ps[0])
                    t = torch.einsum("czyXm,yY->czYXm", t, Ps[1])
                    t = torch.einsum("czYXm,zZ->cZYXm", t, Ps[2])
                else:
                    t = torch.einsum("cyxm,xX->cyXm", t, Ps[0])
                    t = torch.einsum("cyXm,yY->cYXm", t, Ps[1])
                return t.reshape(-1, m)
            t = torch.movedim(x.reshape(shp_f + (n_unk * m,)), -1, 0)  # (c*m, z, y, x)
            if len(Ps) == 3:
                t = torch.einsum("czyx,xX->czyX", t, Ps[0])
                t = torch.einsum("czyX,yY->czYX", t, Ps[1])
                t = torch.einsum("czYX,zZ->cZYX", t, Ps[2])
            else:
                t = torch.einsum("cyx,xX->cyX", t, Ps[0])
                t = torch.einsum("cyX,yY->cYX", t, Ps[1])
            return torch.movedim(t, 0, -1).reshape(-1, m)

        def prolong(x, Ps):
            shp_c = tuple(P.shape[1] for P in reversed(Ps))
            m = x.shape[1]
            if lat:
                t = x.reshape((n_unk,) + shp_c + (m,))
                if len(Ps) == 3:
                    t = torch.einsum("cZYXm,zZ->czYXm", t, Ps[2])
                    t = torch.einsum("czYXm,yY->czyXm", t, Ps[1])
                    t = torch.einsum("czyXm,xX->czyxm", t, Ps[0])
                else:
                    t = torch.einsum("cYXm,yY->cyXm", t, Ps[1])
                    t = torch.einsum("cyXm,xX->cyxm", t, Ps[0])
                return t.reshape(-1, m)
            t = torch.movedim(x.reshape(shp_c + (n_unk * m,)), -1, 0)
            if len(Ps) == 3:
                t = torch.einsum("cZYX,zZ->czYX", t, Ps[2])
                t = torch.einsum("czYX,yY->czyX", t, Ps[1])
                t = torch.einsum("czyX,xX->czyx", t, Ps[0])
            else:
                t = torch.einsum("cYX,yY->cyX", t, Ps[1])
                t = torch.einsum("cyX,xX->cyx", t, Ps[0])
            return torch.movedim(t, 0, -1).reshape(-1, m)

        def apply(r, *cs):
            if n_levels == 0:  # degenerate: exact dense low-order inverse
                return cs[coarse_pos] @ r

            def vcycle(r_l, li):
                lv = levels[li]
                ocs = cs[lv["off"] : lv["off"] + lv["n_oc"]]
                dinv = cs[lv["dinv_pos"]]
                free_l = cs[lv["dinv_pos"] + 1]
                Ps = cs[lv["P_pos"] : lv["P_pos"] + dim]
                if pre_degree > 0:
                    z = cheb(
                        lv["fn"], r_l, torch.zeros_like(r_l), dinv, lv["lam_max"],
                        ocs, pre_degree, z0_zero=True,
                    )
                    rc = r_l - lv["fn"](z, *ocs)
                else:
                    z = torch.zeros_like(r_l)
                    rc = r_l
                rc = restrict(rc * free_l[:, None], Ps)
                if li + 1 < n_levels:
                    nxt = levels[li + 1]
                    rc = rc * cs[nxt["dinv_pos"] + 1][:, None]
                    zc = vcycle(rc, li + 1)
                else:
                    zc = cs[coarse_pos] @ rc
                z = z + prolong(zc, Ps) * free_l[:, None]
                return cheb(lv["fn"], r_l, z, dinv, lv["lam_max"], ocs, smooth_degree)

            z = vcycle(r, 0)
            for _ in range(cycles - 1):
                lv0 = levels[0]
                z = z + vcycle(r - lv0["fn"](z, *cs[lv0["off"] : lv0["off"] + lv0["n_oc"]]), 0)
            return z

        return apply, tuple(consts)

    def _setup_parts_box(self, box):
        """The V-cycle on a window-decomposed :class:`~l3ster_tpu_torch.parallel.box.BoxSystem`
        (``lowordermg.py:453-621``): level 0 smooths with the box operator
        (``fine_level0``), the restriction contracts each shard's node window
        with its slice of the per-axis interpolation bands and sums the
        partial coarse vectors over the shards, and the levels below the
        first coarsening run on the whole coarse vector as on one device.
        Ghost and padding rows are zero in the band slices, so the
        restriction counts every fine row once and the prolongation leaves
        the ghost planes at zero."""
        inner = box.inner
        axes = _axis_coords(inner.mesh)
        if axes is None:
            raise ValueError("LowOrderMG requires a structured lattice mesh with lex node numbering")
        if inner.mesh.dim != 3:
            raise ValueError("box LowOrderMG is 3D-only (box decomposition is)")
        dtype, device = box.dtype, box.device
        n_unk = inner.n_dofs // inner.mesh.n_nodes
        level_axes = self._hierarchy(axes, n_unk)
        if len(level_axes) < 2:
            raise ValueError("box LowOrderMG needs at least one coarsening level")
        c_ax = level_axes[1]

        fn_box, oc = box.operator_parts()
        d = box.diagonal()  # unit on ghost and padding slots
        dinv = torch.where(d.abs() > 1e-14, 1.0 / d, torch.ones_like(d))
        own = box._own_st
        v = _power_start(0, own.numel(), dtype, device).reshape(own.shape + (1,)) * own[..., None]
        lam0 = _lambda_max(fn_box, oc, dinv, v) * 1.05

        # window slices of the per-axis interpolation bands
        P, (Pz, Py) = box.n_shards, box.grid
        nz_loc, ny_loc, nx = box._n1_loc[2], box._n1_loc[1], box._n1_loc[0]
        Pxb, Pyb, Pzb = (_interp_1d(f, c) for f, c in zip(axes, c_ax))
        nX, nY, nZ = Pxb.shape[1], Pyb.shape[1], Pzb.shape[1]
        Pz_sl, Py_sl = np.zeros((P, nz_loc, nZ)), np.zeros((P, ny_loc, nY))
        for pz in range(Pz):
            for py in range(Py):
                p = pz * Py + py
                nzr = box._nez_real[pz] * box._order + 1 if box._nez_real[pz] else 0
                nyr = box._ney_real[py] * box._order + 1 if box._ney_real[py] else 0
                Pz_sl[p, :nzr] = Pzb[box._z0[pz] : box._z0[pz] + nzr]
                Py_sl[p, :nyr] = Pyb[box._y0[py] : box._y0[py] + nyr]
                if pz > 0:
                    Pz_sl[p, 0] = 0.0  # ghost plane: the z predecessor owns it
                if py > 0:
                    Py_sl[p, 0] = 0.0  # ghost row: the y predecessor owns it
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731

        coarse_dense = int(np.prod([len(a) for a in c_ax])) * n_unk <= self.coarse_max_dofs
        c_app = None
        if coarse_dense:
            coarse_consts = (t(_assembled_dense_inv(inner, c_ax)),)
        else:
            s1 = _build_p1_system(inner, c_ax)
            sub = LowOrderMG(
                n_levels=max(1, self.n_levels - 1), smooth_degree=self.smooth_degree,
                pre_degree=self.pre_degree, cycles=1, fine_level0=True,
                coarse_max_dofs=self.coarse_max_dofs, eig_ratio=self.eig_ratio,
            )
            c_app, sub_consts = sub.setup_parts(s1)
            coarse_consts = (s1.free_mask,) + tuple(sub_consts)

        n_oc = len(oc)
        pre_degree = self.pre_degree if self.pre_degree is not None else self.smooth_degree
        smooth_degree, cycles, eig_ratio = self.smooth_degree, self.cycles, self.eig_ratio

        def apply(r, *cs):
            ocs = cs[:n_oc]
            dinv_, free_, Pz_s, Py_s, Px_ = cs[n_oc : n_oc + 5]
            ccs = cs[n_oc + 5 :]
            m = r.shape[-1]

            def vcycle0(r0):
                if pre_degree > 0:
                    z = _cheb(fn_box, r0, torch.zeros_like(r0), dinv_, lam0, ocs, pre_degree, eig_ratio, z0_zero=True)
                    rcf = r0 - fn_box(z, *ocs)
                else:
                    z = torch.zeros_like(r0)
                    rcf = r0
                # restriction: each shard's window against its band slices, then
                # the sum over the shards (the reference's all-reduce)
                tt = (rcf * free_[..., None]).reshape(P, nz_loc, ny_loc, nx, n_unk, m)
                tt = torch.einsum("pzyxcm,pzZ->pZyxcm", tt, Pz_s)
                tt = torch.einsum("pZyxcm,pyY->pZYxcm", tt, Py_s)
                tt = torch.einsum("pZYxcm,xX->pZYXcm", tt, Px_)
                rc = tt.sum(dim=0).reshape(-1, m)
                zc = ccs[0] @ rc if coarse_dense else c_app(rc * ccs[0][:, None], *ccs[1:])
                # prolongation: the coarse correction onto each shard's window
                tz = zc.reshape(nZ, nY, nX, n_unk, m)
                tz = torch.einsum("ZYXcm,pzZ->pzYXcm", tz, Pz_s)
                tz = torch.einsum("pzYXcm,pyY->pzyXcm", tz, Py_s)
                tz = torch.einsum("pzyXcm,xX->pzyxcm", tz, Px_)
                z = z + tz.reshape(r0.shape) * free_[..., None]
                return _cheb(fn_box, r0, z, dinv_, lam0, ocs, smooth_degree, eig_ratio)

            z = vcycle0(r)
            for _ in range(cycles - 1):
                z = z + vcycle0(r - fn_box(z, *ocs))
            return z

        return apply, tuple(oc) + (dinv, box._free_st, box._place(t(Pz_sl)), box._place(t(Py_sl)), t(Pxb)) + coarse_consts
