"""Structured box decomposition (PyTorch port of ``l3ster_tpu.parallel.box``).

For structured lattice meshes the element grid splits into contiguous
windows along the outermost (z) axis and optionally the y axis (a
``(Pz, Py)`` pencil grid).  Each shard holds its node window as a dense
tensor (shared interface planes duplicated, the receiving copy a ghost kept
at zero in solver vectors) and runs the full single-system lattice apply on
it: ``local_apply_lattice`` with the fused z-sweep (B1, one launch per shard
and apply), and the boundary faces of the full lattice sides the window
touches.  The halo exchange moves whole planes: imports run z then y, so the
y transfer carries the z-ghost corner just filled, and exports run y then z,
so corner partials accumulate through the same order.

``devices`` places the shards as the reference's mesh over
``devices[:n_shards]`` does (:mod:`.sharded`): one placement group per
entry, each a contiguous block of shards stacked on a leading axis on its
device, the first entry the wrapped system's device (``devices=None``: one
group there).  Each shard's window data live on its group's device, and its
apply launches there.  The reference's neighbour ``ppermute`` of a plane is a
gather of that plane from the neighbour's slice of the stacked tensor within
a group, and a copy of the plane between groups
(:class:`~.sharded.RowExchange`).  Uneven windows pad the trailing shards
with zero-weighted planes (unit Jacobians, so the geometry stays finite); an
empty window is fine.

``box_parallelize(system, n_shards, grid=(Pz, Py))`` wraps an assembled
:class:`~l3ster_tpu_torch.algsys.system.MatrixFreeSystem`: the assembly data
(rhs, diagonal, Dirichlet values) are reused as they are, and the operator
runs window-decomposed.  The wrapper speaks the solver protocol
(``operator_parts``/``effective_rhs``/``diagonal``/``solution_vector``), so
every Krylov solver and operator preconditioner works on it, and
``LowOrderMG`` has a box variant.
"""

from __future__ import annotations

import numpy as np
import torch

from ..algsys.system import _last_solve_suffix
from .sharded import PlacedShards, RowExchange, _full_device, describe_placement, shard_groups

__all__ = ["BoxSystem", "box_parallelize"]


class BoxSystem(PlacedShards):
    """Window-decomposed operator around a single MatrixFreeSystem (see the
    module doc); ``grid=(Pz, Py)`` (default ``(n_shards, 1)``: z slabs)."""

    def __init__(self, system, n_shards: int | None = None, devices=None, grid=None):
        if devices is not None and _full_device(devices[0]) != _full_device(system.device):
            raise ValueError(
                f"the first entry of devices ({devices[0]}) must be the wrapped system's device "
                f"({system.device}), which holds the coarse levels and the assembly data"
            )
        self.inner = system
        self.n_shards = int(n_shards or (len(devices) if devices is not None else 1))
        self._groups = shard_groups(self.n_shards, devices, system.device)
        self.grid = (self.n_shards, 1) if grid is None else (int(grid[0]), int(grid[1]))
        if self.grid[0] * self.grid[1] != self.n_shards:
            raise ValueError(f"grid {self.grid} does not cover {self.n_shards} shards")
        self.dtype, self.device, self.n_rhs = system.dtype, system.device, system.n_rhs
        self._last_solve_result = None
        self._setup()

    # -- setup -----------------------------------------------------------------

    def _setup(self) -> None:
        sysm = self.inner
        _, ops = sysm._operators()
        vols, faces = [], []
        for c, d in ops:
            if d[0] in ("lattice_sf_const", "lattice_sf_const_diag"):
                vols.append((c, d))
            elif d[0] == "face_banded" or (d[0] == "direct" and d[-1][0] == "face"):
                faces.append((c, d[3] if d[0] == "face_banded" else d[-1][1]))
            elif d[0] != "zero":
                raise ValueError(
                    "box decomposition requires constant-coefficient lattice volume kernels and "
                    f"full-lattice-side boundary kernels; contribution kind {d[0]!r} is not supported"
                )
        if not vols:
            raise ValueError("no lattice domain contribution found")
        n1, ne = vols[0][1][2][0], vols[0][1][2][1]
        if len(n1) != 3:
            raise ValueError("box decomposition is 3D-only")
        for c2, d2 in vols[1:]:
            if tuple(d2[2][0]) != tuple(n1) or tuple(d2[2][1]) != tuple(ne):
                raise ValueError("all lattice volume contributions must share one lattice")
        c0 = vols[0][0]
        p_ord = c0.tables.order
        self._order = p_ord
        self._q_order = c0.options.quadrature_order(p_ord)
        q1 = self._q_order // 2 + 1
        self._n_unk = len(c0.dof_inds)
        self._variant = sysm._variant
        P, (Pz, Py) = self.n_shards, self.grid
        ne_pz, ne_py = -(-ne[2] // Pz), -(-ne[1] // Py)
        self._nez_real = [max(0, min(ne_pz, ne[2] - pz * ne_pz)) for pz in range(Pz)]
        self._ney_real = [max(0, min(ne_py, ne[1] - py * ne_py)) for py in range(Py)]
        self._ne_loc = (ne[0], ne_py, ne_pz)
        self._n1_loc = (n1[0], ne_py * p_ord + 1, ne_pz * p_ord + 1)
        self._n1, self._ne = tuple(n1), tuple(ne)
        self._z0 = np.array([pz * ne_pz * p_ord for pz in range(Pz)])
        self._y0 = np.array([py * ne_py * p_ord for py in range(Py)])
        Sz, Sy, Sx = ne[2] * q1, ne[1] * q1, ne[0] * q1
        Sz_loc, Sy_loc = ne_pz * q1, ne_py * q1
        shards = [(pz * Py + py, pz, py) for pz in range(Pz) for py in range(Py)]

        def qp_window(a, lead, fill):
            """An interleaved-QP array (lead..., Sz*Sy*Sx) cut into the shards'
            windows (P, lead..., Sz_loc*Sy_loc*Sx), ``fill`` on padding QPs."""
            a = np.asarray(a).reshape(lead + (Sz, Sy, Sx))
            out = np.full((P,) + lead + (Sz_loc, Sy_loc, Sx), fill, a.dtype)
            for p, pz, py in shards:
                zr, yr = self._nez_real[pz] * q1, self._ney_real[py] * q1
                out[p][..., :zr, :yr, :] = a[..., pz * Sz_loc : pz * Sz_loc + zr, py * Sy_loc : py * Sy_loc + yr, :]
            return out.reshape((P,) + lead + (Sz_loc * Sy_loc * Sx,))

        # per-shard data: a list over the shards, each on its group's device
        dev_of = [g.device for g in self._groups for _ in range(g.n)]
        t = lambda a: [torch.as_tensor(a[p], dtype=self.dtype, device=dev_of[p]) for p in range(P)]  # noqa: E731
        self._vol = []
        for _, d in vols:
            if d[0] == "lattice_sf_const":
                Ji = qp_window(d[3].cpu().numpy(), (3, 3), 0.0).reshape(P, 3, 3, -1)
                w = qp_window(d[4].cpu().numpy(), (), 0.0)
                pad = w == 0.0  # padding QPs: unit Jacobian keeps the sweep finite
                for i in range(3):
                    Ji[:, i, i][pad] = 1.0
                self._vol.append(dict(kind="full", A=d[1], ji=t(Ji), w=t(w)))
                continue
            jx, jy, jz, wyx, wz = (v.cpu().numpy() for v in d[3:8])
            jz_st, wz_st = np.ones((Pz, Sz_loc, 1)), np.zeros((Pz, Sz_loc, 1))
            for pz in range(Pz):
                zr = self._nez_real[pz] * q1
                jz_st[pz, :zr] = jz[pz * Sz_loc : pz * Sz_loc + zr]
                wz_st[pz, :zr] = wz[pz * Sz_loc : pz * Sz_loc + zr]
            yx = [a.reshape(Sy, Sx) for a in (jx, jy, wyx)]
            jx_st, jy_st, wy_st = np.ones((Py, Sy_loc, Sx)), np.ones((Py, Sy_loc, Sx)), np.zeros((Py, Sy_loc, Sx))
            for py in range(Py):
                yr = self._ney_real[py] * q1
                seg = slice(py * Sy_loc, py * Sy_loc + yr)
                jx_st[py, :yr], jy_st[py, :yr], wy_st[py, :yr] = (a[seg] for a in yx)
            # flat shard index p = pz * Py + py
            self._vol.append(dict(
                kind="diag", A=d[1],
                jz=t(np.repeat(jz_st, Py, axis=0)), wz=t(np.repeat(wz_st, Py, axis=0)),
                jx=t(np.tile(jx_st.reshape(Py, 1, -1), (Pz, 1, 1))),
                jy=t(np.tile(jy_st.reshape(Py, 1, -1), (Pz, 1, 1))),
                wyx=t(np.tile(wy_st.reshape(Py, 1, -1), (Pz, 1, 1))),
            ))

        # boundary faces: each shard takes the sub-rectangle of the face's
        # canonical elements inside its (ey, ez) windows; a shard off the face
        # takes none
        from ..ops.lattice_sumfact import lattice_qp_perm, pack_face_banded

        self._faces = []
        for c, fp in faces:
            _, A, B, w, _ = sysm._direct_data(c, face=fp)
            A, B, w = (a.cpu().numpy() for a in (A, B, w))
            finv = fp["plan2d"][3]
            if finv is not None:  # block order -> canonical face order
                A, B, w = A[finv], B[finv], w[finv]
            axis, hi = fp["axis"], fp["hi"]
            rem = [a for a in range(3) if a != axis]
            ne2 = fp["plan2d"][1]
            n12_loc = tuple(self._n1_loc[a] for a in rem)
            ne2_loc = tuple(self._ne_loc[a] for a in rem)
            E_loc = int(np.prod(ne2_loc))
            A_st = np.zeros((P, E_loc) + A.shape[1:])
            B_st = np.zeros((P, E_loc) + B.shape[1:])
            w_st = np.zeros((P, E_loc) + w.shape[1:])
            plane, on = np.zeros(P, dtype=np.int64), np.zeros(P, dtype=bool)
            for p, pz, py in shards:
                win = {0: (0, ne[0]), 1: (py * ne_py, py * ne_py + self._ney_real[py]),
                       2: (pz * ne_pz, pz * ne_pz + self._nez_real[pz])}
                real = {2: self._nez_real[pz], 1: self._ney_real[py]}
                if axis == 0:
                    touches = True
                    plane[p] = n1[0] - 1 if hi else 0
                else:
                    first = (pz if axis == 2 else py) == 0
                    touches = bool(real[axis]) and (win[axis][1] == ne[axis] if hi else first)
                    plane[p] = real[axis] * p_ord if hi else 0
                if not (touches and self._nez_real[pz] and self._ney_real[py]):
                    continue
                (lo0, hi0), (lo1, hi1) = win[rem[0]], win[rem[1]]
                i0, i1 = np.arange(lo0, hi0), np.arange(lo1, hi1)
                src = (i0[None, :] + ne2[0] * i1[:, None]).reshape(-1)
                dst = ((i0 - lo0)[None, :] + ne2_loc[0] * (i1 - lo1)[:, None]).reshape(-1)
                A_st[p, dst], B_st[p, dst], w_st[p, dst] = A[src], B[src], w[src]
                on[p] = True
            fp_loc = dict(axis=axis, hi=hi, n1=self._n1_loc, plan2d=(n12_loc, ne2_loc, None, None))
            entry = dict(fp=fp_loc, plane=plane.tolist(), on=on.tolist(), order=c.tables.order)
            qof = c.options.quadrature_order(c.tables.order)
            packs = [pack_face_banded(A_st[p], w_st[p], fp_loc, c.tables.order, qof) for p in range(P)]
            if all(pk is not None for pk in packs):
                # value-only side: one banded 2D sweep over each shard's face plane
                entry.update(A_l=t([pk[0] for pk in packs]), w_l=t([pk[1] for pk in packs]), qof=qof)
            else:
                entry.update(A=t(A_st), B=t(B_st), w=t(w_st))
            self._faces.append(entry)

        # the map from each shard's window nodes to the global lattice rows:
        # -1 on ghost planes (the first z plane of pz > 0, the first y row of
        # py > 0) and padding planes, so every global row is owned once
        nz_loc, ny_loc, nx = self._n1_loc[2], self._n1_loc[1], n1[0]
        src = np.full((P, nz_loc, ny_loc, nx), -1, dtype=np.int64)
        for p, pz, py in shards:
            if not (self._nez_real[pz] and self._ney_real[py]):
                continue
            zlo, ylo = int(pz > 0), int(py > 0)
            nzr, nyr = self._nez_real[pz] * p_ord + 1, self._ney_real[py] * p_ord + 1
            z = self._z0[pz] + np.arange(zlo, nzr)
            y = self._y0[py] + np.arange(ylo, nyr)
            src[p, zlo:nzr, ylo:nyr] = (z[:, None, None] * n1[1] + y[None, :, None]) * n1[0] + np.arange(nx)
        self._src = torch.as_tensor(src.reshape(P, -1), device=self.device)
        self._own_st = self._place((self._src >= 0).to(self.dtype).repeat_interleave(self._n_unk, dim=1))
        free = sysm.free_mask[:, None]
        self._free_st = self._to_slabs(free)[..., 0]
        self._dir_st = self._to_slabs(1.0 - free)[..., 0]
        # neighbour shards: the z neighbours differ by Py in the flat shard
        # index, the y neighbours by 1 within a row; each plane move carries
        # the rows of shards that have the neighbour
        ps = np.arange(P)
        pz_of, py_of = ps // Py, ps % Py
        row = ps - py_of
        has = dict(z_prev=pz_of > 0, z_next=pz_of < Pz - 1, y_prev=py_of > 0, y_next=py_of < Py - 1)
        src_of = dict(z_prev=(ps - Py) % P, z_next=(ps + Py) % P, y_prev=row + (py_of - 1) % Py,
                      y_next=row + (py_of + 1) % Py)
        # the import takes from the predecessors, the export from the successors
        self._move = {k: RowExchange(self._groups, src_of[k], has[k]) for k in ("z_prev", "y_prev")}
        self._move.update({k: RowExchange(self._groups, src_of[k], has[k]) for k in ("z_next", "y_next")})
        self._has = {
            k: [torch.as_tensor(v[g.lo : g.hi], device=g.device)[:, None, None, None] for g in self._groups]
            for k, v in has.items()
        }


    # -- layouts -----------------------------------------------------------------

    def _to_slabs(self, xg: torch.Tensor):
        """(n_dofs, r) global -> (P, L, r) stacked windows in this system's
        placement, zero on ghost and padding planes."""
        c, r = self._n_unk, xg.shape[-1]
        rows = xg.reshape(-1, c, r)
        src = self._src.to(xg.device)
        out = rows[src.clamp(min=0)] * (src >= 0)[..., None, None].to(xg.dtype)
        return self._place(out.reshape(self.n_shards, -1, r))

    def _from_slabs(self, x_st) -> torch.Tensor:
        """(P, L, r) stacked -> (n_dofs, r) global on the wrapped system's
        device, from the owned planes."""
        x_st = self._full(x_st).to(self.device)
        c, r = self._n_unk, x_st.shape[-1]
        out = x_st.new_zeros((self.inner.n_dofs // c, c, r))
        m = self._src >= 0
        out[self._src[m]] = x_st.reshape(self.n_shards, -1, c, r)[m]
        return out.reshape(-1, r)

    # -- the window-decomposed operator -------------------------------------------

    def _import_halo(self, x5: list) -> list:
        """Owner -> ghost planes, in place on the groups' x5 (n, nz, ny,
        nx*c, r): the z ghost plane from the z predecessor's last real plane,
        then the y ghost row (which carries the corner just filled) from the y
        predecessor's last row."""
        Pz, Py = self.grid
        if Pz > 1:
            got = self._move["z_prev"]([x[:, -1] for x in x5])
            for x, h, g in zip(x5, self._has["z_prev"], got):
                x[:, 0] = torch.where(h, g, x[:, 0])
        if Py > 1:
            got = self._move["y_prev"]([x[:, :, -1] for x in x5])
            for x, h, g in zip(x5, self._has["y_prev"], got):
                x[:, :, 0] = torch.where(h, g, x[:, :, 0])
        return x5

    def _export_halo(self, y5: list) -> list:
        """Ghost -> owner accumulation, in place on the groups' y5: y first
        (the corner partials ride into the y neighbour's z ghost), then z;
        ghost planes end at zero."""
        Pz, Py = self.grid
        for ax, prev, nxt in ((Py > 1 and 2, "y_prev", "y_next"), (Pz > 1 and 1, "z_prev", "z_next")):
            if not ax:
                continue
            sel = (slice(None),) * ax
            sends = [torch.where(h, y[sel + (0,)], torch.zeros_like(y[sel + (0,)])) for y, h in zip(y5, self._has[prev])]
            for y, hp, hn, send, got in zip(y5, self._has[prev], self._has[nxt], sends, self._move[nxt](sends)):
                y[sel + (-1,)] += torch.where(hn, got, torch.zeros_like(got))
                y[sel + (0,)] = torch.where(hp, torch.zeros_like(send), y[sel + (0,)])
        return y5

    def _shard_apply(self, p: int, t: torch.Tensor) -> torch.Tensor:
        """The unconstrained lattice apply of shard p's window, on its
        channel-leading tensor t (c, nz, ny, nx)."""
        from ..algsys.local import local_apply_direct
        from ..ops.lattice import face_gather_tensor, face_scatter_tensor_add
        from ..ops.lattice_sumfact import face_apply_banded, local_apply_lattice

        order, q_order, n1l, nel = self._order, self._q_order, self._n1_loc, self._ne_loc
        yt = None
        for v in self._vol:
            if v["kind"] == "full":
                yv = local_apply_lattice(v["A"], v["ji"][p], v["w"][p], order, q_order, n1l, nel, t,
                                         tensor_io=True, variant=self._variant)
            else:
                geom = ("diag", v["jx"][p], v["jy"][p], v["jz"][p], v["wyx"][p], v["wz"][p])
                yv = local_apply_lattice(v["A"], None, None, order, q_order, n1l, nel, t, geom=geom,
                                         tensor_io=True, variant=self._variant)
            yt = yv if yt is None else yt + yv
        for f in self._faces:
            if not f["on"][p]:
                continue
            fp = dict(f["fp"], plane=f["plane"][p])
            if "A_l" in f:
                pos = 1 + (2 - fp["axis"])
                yp = face_apply_banded(f["A_l"][p], f["w_l"][p], fp, f["order"], f["qof"], t.select(pos, fp["plane"]))
                yt.select(pos, fp["plane"]).add_(yp)
            else:
                yf = local_apply_direct(f["A"][p], f["B"][p], f["w"][p], face_gather_tensor(t, fp, f["order"]))
                face_scatter_tensor_add(yf, fp, f["order"], yt)
        return yt

    def _apply(self, x):
        """The constrained operator on stacked windows (P, L, r): per group,
        one apply per shard on the group's device."""
        r = x.shape[-1]
        nz, ny, nx = self._n1_loc[2], self._n1_loc[1], self._n1_loc[0]
        c = self._n_unk
        free = self._free_st[:, :, None]
        x5 = self._import_halo([xp.reshape(-1, nz, ny, nx * c, r) for xp in self._split(x * free)])
        y5 = [torch.empty_like(xp) for xp in x5]
        for g, xp, yp in zip(self._groups, x5, y5):
            for p in range(g.lo, g.hi):
                for rr in range(r):
                    t = xp[p - g.lo, :, :, :, rr].reshape(-1, c).T.reshape(c, nz, ny, nx)
                    yp[p - g.lo, :, :, :, rr] = self._shard_apply(p, t).reshape(c, -1).T.reshape(nz, ny, nx * c)
        y = self._join([yp.reshape(yp.shape[0], -1, r) for yp in self._export_halo(y5)])
        return y * free + x * self._dir_st[:, :, None]

    def operator_parts(self, layout: str = "dof"):
        if layout != "dof":
            raise ValueError("a BoxSystem runs on its stacked window layout")
        return (lambda x: self._apply(x)), ()

    def operator(self):
        fn, consts = self.operator_parts()
        return lambda x: fn(x, *consts)

    # -- solver protocol -----------------------------------------------------------

    def effective_rhs(self) -> torch.Tensor:
        return self._to_slabs(self.inner.effective_rhs())

    def diagonal(self) -> torch.Tensor:
        """The wrapped system's diagonal on the windows; unit on ghost and
        padding slots, so Jacobi and Chebyshev stay finite."""
        d = self._to_slabs(self.inner.diagonal()[:, None])[..., 0]
        return d * self._own_st + (1.0 - self._own_st)

    def solution_vector(self) -> torch.Tensor:
        return self._to_slabs(self.inner.solution_vector())

    def set_solution_vector(self, x: torch.Tensor) -> None:
        self.inner.set_solution_vector(self._from_slabs(x.reshape(self.n_shards, -1, self.n_rhs)))

    def solve(self, solver):
        return solver.solve(self)

    def update_solution(self, dof_inds, solution_manager, slot_inds, rhs_index: int = 0) -> None:
        self.inner.update_solution(dof_inds, solution_manager, slot_inds, rhs_index)

    @property
    def n_dofs(self) -> int:
        return self.inner.n_dofs

    @property
    def _assembly_epoch(self):
        # preconditioner setups are cached on the wrapped system's epochs
        return self.inner._assembly_epoch

    def describe(self, per_shard: bool = False) -> str:
        """One-line summary, with the shards' devices; ``per_shard=True``
        appends the per-shard window table (real elements and window dofs)
        with its min/max/total footer."""
        Pz, Py = self.grid
        head = (
            f"BoxSystem: {self.inner.n_dofs} dofs as a {Pz}x{Py} pencil grid of "
            f"{self._ne_loc[2]}x{self._ne_loc[1]} element windows (lattice apply per shard, "
            f"{len(self._faces)} boundary faces, {2 * ((Pz > 1) + (Py > 1))} plane exchanges per apply), "
            f"{describe_placement(self._groups)}"
        ) + _last_solve_suffix(self)
        if not per_shard:
            return head
        p_ord, n_unk, ne_x = self._order, self._n_unk, self._ne_loc[0]
        rows = []
        for pz in range(Pz):
            for py in range(Py):
                ez, ey = self._nez_real[pz], self._ney_real[py]
                elems = ne_x * ey * ez
                ndofs = (ne_x * p_ord + 1) * (ey * p_ord + 1) * (ez * p_ord + 1) * n_unk if elems else 0
                rows.append([pz * Py + py, f"({pz},{py})", elems, ndofs])
        cols = ["shard", "window", "elems", "win dofs"]
        w = [max(len(h), 8) for h in cols]
        lines = [head, "  ".join(h.rjust(wi) for h, wi in zip(cols, w))]
        lines += ["  ".join(str(v).rjust(wi) for v, wi in zip(r, w)) for r in rows]
        for name, f in (("min", min), ("max", max), ("total", sum)):
            vals = [str(f(r[i] for r in rows)).rjust(w[i]) for i in (2, 3)]
            lines.append("  ".join([name.rjust(w[0]), "".rjust(w[1])] + vals))
        return "\n".join(lines)


def box_parallelize(system, n_shards: int | None = None, devices=None, grid=None) -> BoxSystem:
    """Wrap an assembled MatrixFreeSystem in the window-decomposed operator.
    Requirements: a 3D lattice mesh (generated cubes), constant-coefficient
    lattice volume kernels, boundary kernels on full lattice sides; element
    counts along each decomposed axis may be uneven (empty trailing windows
    included).  ``grid=(Pz, Py)`` selects a pencil grid (default z slabs)."""
    return BoxSystem(system, n_shards, devices, grid=grid)
