"""Distributed system over element shards (PyTorch port of ``l3ster_tpu.parallel.distributed``).

The reference's MPI domain decomposition (``comm/DistributeMesh.hpp``,
``comm/ImportExport.hpp``, ``util/SegmentedOwnership.hpp``): elements are
partitioned into ``n_shards`` parts, every shard holds a local dof vector
laid out as ``[owned | ghost | dump]`` (padded to a common size ``n_loc1``),
and the solver-facing vectors are one stacked tensor ``(n_shards, n_loc1,
n_rhs)``, exactly the reference's global view of its sharded arrays.

``devices`` places the shards as the reference's mesh over
``devices[:n_shards]`` does (:mod:`.sharded`): one placement group per
entry, each a contiguous block of shards stacked on its device (a repeated
entry is still its own group; ``devices=None``: one group on the system's
device).  Within a group the reference's per-shard ``shard_map`` bodies
become a batch over the leading axis: the element contributions of the
group's shards run as one local apply over their elements, gathering from
and scattering into the group's flattened stack.  The halo exchange keeps
the reference's pattern: owner-to-holder lists grouped by ring offset
``o = (holder - owner) mod n_shards``, each offset one send buffer per
shard; the reference's ``ppermute`` over the mesh axis moves those buffers
over the shard axis (a gather within a group, copies between groups,
:class:`~.sharded.RowExchange`), followed by the scatter into the
receivers' ghost slots (import) or the accumulation into the owners' slots
(export).  The reference's ``psum`` is a sum over the shard axis, which the
Krylov dots (``solve/krylov.py:_col_dots``) already take; on several
groups the solver vectors are :class:`~.sharded.ShardedStack` s, whose sums
add the groups' partial sums on the first group's device.  Assembly (the
local rhs, diagonal and matrices) runs on that first device over every
shard, and its results are cut into the groups.

Solver-facing vectors keep ghosts and the dump slot at exactly zero (every
export is followed by the owned mask), so the plain dots are correct.

``GLOBAL_ASSEMBLY`` keeps one CSR partial matrix per shard over its local
slots (each shard's own element contributions, ghost rows included; the
Tpetra FECrsMatrix semantics): here the shards' matrices form one
block-diagonal CSR over the stacked slots of each group, and the apply is
import, one SpMV per group, export.  ``ELEMENT_BOUNDARY`` condensation
works on it, with each element's Schur complement formed where the element
lives.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..algsys.local import (
    _basis_stack,
    element_geometry,
    local_diagonal,
    local_diagonal_sumfact,
    local_rhs,
    local_rhs_sumfact,
)
from ..algsys.system import (
    _ASM_DTYPE,
    _CondensationAgg,
    _Contribution,
    _SystemBase,
    _cond_selectors,
    _last_solve_suffix,
    _schur_solve,
)
from ..common.enums import CondensationPolicy, OperatorEvaluationStrategy
from ..common.problem import AlgebraicSystemParams
from ..mesh.traits import boundary_node_indices, internal_node_indices
from ..utils.profiling import profile_region
from .partition import partition_mesh_elements
from .sharded import PlacedShards, RowExchange, describe_placement, resolve_home_device, shard_groups

__all__ = ["DistributedSystem", "make_distributed_system"]


@dataclass
class _ShardBucket:
    """One contribution with its elements' dofs in the stacked slot space:
    ``sidx`` (E, n_nodes * n_unk) holds ``shard * n_loc1 + slot`` of each
    element dof (condensed-out dofs on the dump slot); ``part`` (E,) each
    element's shard."""

    c: _Contribution
    sidx: np.ndarray
    part: np.ndarray


def _split_op(d: tuple, esel: torch.Tensor, n_qp: int, device) -> tuple:
    """A bucket's op data restricted to the elements ``esel`` and moved to
    ``device``: ``direct`` data leads with the element axis, the dense and
    sum-factorized kinds carry element-major QPs (E * Q) on their last axis."""
    if d[0] == "direct":
        return ("direct",) + tuple(a[esel.to(a.device)].to(device) for a in d[1:])
    q = (esel[:, None] * n_qp + torch.arange(n_qp, device=esel.device)).reshape(-1)
    pick = lambda a: a[..., q.to(a.device)].contiguous().to(device)  # noqa: E731
    A = pick(d[1]) if d[0] in ("dense", "sumfact") else d[1]
    return (d[0], A, pick(d[2]), pick(d[3])) + tuple(a.to(device) for a in d[4:])


class DistributedSystem(PlacedShards, _SystemBase):
    """Element-sharded system in the stacked ``(n_shards, n_loc1, n_rhs)``
    layout (see the module doc); matrix-free or, under GLOBAL_ASSEMBLY,
    per-shard CSR partial matrices."""

    def __init__(
        self,
        mesh,
        problem,
        bc_def=None,
        params: AlgebraicSystemParams = AlgebraicSystemParams(),
        n_shards: int | None = None,
        devices=None,
        dtype=torch.float32,
        part_fractions=None,
        partition_method: str = "rcb",
        partition_grid: tuple[int, int] | None = None,
        device=None,
    ):
        super().__init__(mesh, problem, bc_def, params, dtype, resolve_home_device(device, devices))
        self.n_shards = int(n_shards or (len(devices) if devices is not None else 1))
        self._groups = shard_groups(self.n_shards, devices, self.device)
        if partition_grid is not None and partition_method == "rcb":
            partition_method = "rcb2d"
        self.partition_grid = partition_grid
        with profile_region("distributed/partition"):
            self._parts = partition_mesh_elements(
                mesh, self.n_shards, problem, part_fractions, method=partition_method, grid=partition_grid,
            )
        with profile_region("distributed/ownership"):
            self._setup_ownership()
        self._sbuckets: list[_ShardBucket] = []
        self._diag = None
        self._ops = None
        self._gops = None
        self._asm = None
        self._csr = None
        self._gathered = None
        self._cond_aggs: dict[int, _CondensationAgg] = {}
        self.rhs = self._stacked_zeros()
        self.x = self._stacked_zeros()

    # -- placement (see .sharded) ----------------------------------------------

    def _stacked_zeros(self):
        return self._join([
            torch.zeros((g.n, self.n_loc1, self.n_rhs), dtype=self.dtype, device=g.device) for g in self._groups
        ])

    def _group_map(self, fn, *vecs):
        """``fn(group index, *the group's parts of vecs)`` per group, joined:
        the per-group step of a preconditioner (a local solve, a block apply)."""
        parts = [self._split(v) for v in vecs]
        return self._join([fn(gi, *(p[gi] for p in parts)) for gi in range(len(self._groups))])

    # -- ownership and the halo pattern (SegmentedOwnership analog) ----------

    def _setup_ownership(self) -> None:
        P = self.n_shards
        nd = self.dofmap.node_dof
        # dof set per shard = active dofs of its elements' nodes, deduplicated
        # through a combined (shard, dof) key; the smallest shard owns a dof
        keys = []
        for _, blk in self.mesh.blocks():
            part = self._parts[id(blk)]
            flat = nd[blk.nodes].reshape(blk.n_elements, -1)
            p_rep = np.repeat(part.astype(np.int64), flat.shape[1])
            d = flat.ravel().astype(np.int64)
            keep = d >= 0
            keys.append(np.unique(p_rep[keep] * self.n_dofs + d[keep]))
        key = np.unique(np.concatenate(keys)) if keys else np.empty(0, np.int64)
        shard_of, dof_of = key // self.n_dofs, key % self.n_dofs
        owner = np.full(self.n_dofs, P, dtype=np.int64)
        np.minimum.at(owner, dof_of, shard_of)
        if (owner >= P).any():
            raise RuntimeError("some dofs belong to no shard")
        self._owner = owner
        seg = np.searchsorted(shard_of, np.arange(P + 1))
        is_owned = owner[dof_of] == shard_of
        self._owned = [dof_of[seg[p] : seg[p + 1]][is_owned[seg[p] : seg[p + 1]]] for p in range(P)]
        self._ghost = [dof_of[seg[p] : seg[p + 1]][~is_owned[seg[p] : seg[p + 1]]] for p in range(P)]
        n_loc = max(len(o) + len(g) for o, g in zip(self._owned, self._ghost))
        self.n_loc1 = n_loc + 1  # + the dump slot
        self._dump = n_loc

        owned_mask = np.zeros((P, self.n_loc1))
        free_local = np.zeros((P, self.n_loc1))
        dir_local = np.zeros((P, self.n_loc1))
        for p in range(P):
            n_own = len(self._owned[p])
            fl = self._free_np[np.concatenate([self._owned[p], self._ghost[p]])].astype(np.float64)
            owned_mask[p, :n_own] = 1.0
            free_local[p, : len(fl)] = fl
            dir_local[p, :n_own] = 1.0 - fl[:n_own]
        self._owned_mask = self._place(self._tensor(owned_mask))
        self._free_local = self._place(self._tensor(free_local))
        self._dir_local = self._place(self._tensor(dir_local))

        # (owner j, holder q) exchange lists grouped by ring offset (q - j) mod P,
        # one send buffer per shard and offset (``comm/DistributeMesh.hpp:207-227``)
        by_offset: dict[int, list] = {}
        ms = 1
        for q in range(P):
            gh = self._ghost[q]
            ow = owner[gh]
            for j in np.unique(ow):
                lst = gh[ow == j]
                by_offset.setdefault(int(q - j) % P, []).append((int(j), q, lst))
                ms = max(ms, len(lst))
        self._max_send = ms
        comm = []
        for o in sorted(by_offset):
            pairs = by_offset[o]
            ms_o = max(len(lst) for _, _, lst in pairs)
            SI = np.full((P, ms_o), self._dump, dtype=np.int64)  # owner-side owned slots
            RI = np.full((P, ms_o), self._dump, dtype=np.int64)  # holder-side ghost slots
            SM = np.zeros((P, ms_o))
            for j, q, lst in pairs:
                SI[j, : len(lst)] = self._g2l_map(j, lst)
                RI[q, : len(lst)] = self._g2l_map(q, lst)
                SM[j, : len(lst)] = 1.0
            comm.append((o, self._tensor(SI, torch.int64), self._tensor(RI, torch.int64), self._tensor(SM)))
        self._comm = comm
        self._n_neighbors = len(comm)
        # per offset and group: the owner-side slots (also flat in the group's
        # (n * n_loc1) view, for the export), the holder-side slots, the send
        # mask, and the moves of the buffers over the shard axis (import: the
        # holder q takes the owner q - o's buffer; export: the owner j takes
        # the holder j + o's), only rows that carry something crossing groups
        ps = np.arange(P)
        self._shard_rows = [torch.arange(g.n, device=g.device)[:, None] for g in self._groups]
        self._xchg = []
        for o, SI, RI, SM in comm:
            recv_any = (RI != self._dump).any(dim=1).cpu().numpy()
            send_any = (SM > 0).any(dim=1).cpu().numpy()
            cut = lambda a, g: a[g.lo : g.hi].to(g.device)  # noqa: E731
            self._xchg.append(dict(
                SI=[cut(SI, g) for g in self._groups], RI=[cut(RI, g) for g in self._groups],
                SM=[cut(SM, g)[:, :, None] for g in self._groups],
                SI_flat=[(rows * self.n_loc1 + cut(SI, g)).reshape(-1) for rows, g in zip(self._shard_rows, self._groups)],
                imp=RowExchange(self._groups, (ps - o) % P, recv_any),
                exp=RowExchange(self._groups, (ps + o) % P, send_any),
            ))

        # the owner-side (shard, slot) of each Dirichlet dof
        ds = owner[self.dirichlet_dofs]
        dl = np.empty(len(ds), dtype=np.int64)
        for p in np.unique(ds):
            m = ds == p
            dl[m] = self._g2l_map(int(p), self.dirichlet_dofs[m])
        self._dir_shard, self._dir_slot = ds, dl
        # (shard, slot, global dof) of every owned dof
        self._owner_plan = (
            np.repeat(np.arange(P), [len(o) for o in self._owned]),
            np.concatenate([np.arange(len(o)) for o in self._owned]),
            np.concatenate(self._owned),
        )

    def _g2l_map(self, p: int, gd: np.ndarray) -> np.ndarray:
        """Global dofs -> shard ``p``'s local slots ([owned | ghost] are sorted
        segments); -1 (condensed-out) dofs map to the dump slot."""
        own, gh = self._owned[p], self._ghost[p]
        gd = np.asarray(gd)
        neg = gd < 0
        g = np.where(neg, 0, gd)
        pos_o = np.searchsorted(own, g)
        pos_o_c = np.minimum(pos_o, max(len(own) - 1, 0))
        is_o = (pos_o < len(own)) & (own[pos_o_c] == g) if len(own) else np.zeros_like(g, bool)
        pos_g = np.searchsorted(gh, g)
        pos_g_c = np.minimum(pos_g, max(len(gh) - 1, 0))
        is_g = (pos_g < len(gh)) & (gh[pos_g_c] == g) if len(gh) else np.zeros_like(g, bool)
        if not (is_o | is_g | neg).all():
            raise RuntimeError("element dof not present in its shard's local dof set")
        out = np.where(is_o, pos_o_c, len(own) + pos_g_c)
        out[neg] = self._dump
        return out

    def _shard_group(self) -> np.ndarray:
        """(n_shards,) the group of each shard."""
        return np.concatenate([np.full(g.n, gi) for gi, g in enumerate(self._groups)])

    def _stacked(self, part: np.ndarray, gd: np.ndarray) -> np.ndarray:
        """Global dofs (E, k) of elements on shards ``part`` (E,) -> stacked
        slots ``shard * n_loc1 + slot``."""
        out = np.empty(gd.shape, dtype=np.int64)
        for p in np.unique(part):
            m = part == p
            out[m] = p * self.n_loc1 + self._g2l_map(int(p), gd[m])
        return out

    # -- halo exchange ----------------------------------------------------------

    def _import_parts(self, xs: list) -> list:
        """Owner -> ghost propagation (``Import`` analog), in place on the
        groups' stacked parts (n, L, r), which are returned: per ring offset
        o, shard j's owned halo rows land in the ghost slots of shard j + o."""
        for xc in self._xchg:
            sends = [x[rows, SI] for x, rows, SI in zip(xs, self._shard_rows, xc["SI"])]
            for x, rows, RI, buf in zip(xs, self._shard_rows, xc["RI"], xc["imp"](sends)):
                x[rows, RI] = buf
        return xs

    def _export_parts(self, ys: list) -> list:
        """Ghost -> owner accumulation (``Export`` + ``AtomicSumInto`` analog),
        in place on the groups' stacked parts, which are returned: per ring
        offset, the holders' ghost rows, moved back to their owners,
        ``index_add_``-ed into the owners' slots of each group's flat
        (n * L, r) view."""
        for xc in self._xchg:
            holds = [y[rows, RI] for y, rows, RI in zip(ys, self._shard_rows, xc["RI"])]
            for y, SM, SI_flat, buf in zip(ys, xc["SM"], xc["SI_flat"], xc["exp"](holds)):
                y.view(-1, y.shape[-1]).index_add_(0, SI_flat, (buf * SM).reshape(-1, y.shape[-1]))
        return ys

    def _import(self, x):
        """:meth:`_import_parts` on a stacked vector (in place on its parts), returned."""
        return self._join(self._import_parts(self._split(x)))

    def _export(self, y):
        """:meth:`_export_parts` on a stacked vector (in place on its parts), returned."""
        return self._join(self._export_parts(self._split(y)))

    # -- assembly ---------------------------------------------------------------

    @property
    def _assembled_mode(self) -> bool:
        return self.params.eval_strategy == OperatorEvaluationStrategy.GLOBAL_ASSEMBLY

    def _begin_impl(self) -> None:
        self._sbuckets = []
        self._diag = None
        self._ops = None
        self._gops = None
        self._asm = None
        self._csr = None
        self._gathered = None
        self._cond_aggs = {}
        self.rhs = self._stacked_zeros()

    def _condensed(self, c: _Contribution) -> bool:
        blk = c.block
        return (
            self.params.cond_policy == CondensationPolicy.ELEMENT_BOUNDARY
            and blk.dim == self.mesh.dim
            and len(internal_node_indices(blk.element_type, blk.order)) > 0
        )

    def _add_contribution(self, c: _Contribution) -> None:
        part = self._parts[id(c.block)]
        if c.elem_sel is not None:
            part = part[c.elem_sel]
        E = c.elem_dofs.shape[0]
        self._sbuckets.append(_ShardBucket(c, self._stacked(part, c.elem_dofs.reshape(E, -1)), np.asarray(part)))
        if self._condensed(c):
            self._get_cond_agg(c)

    def _get_cond_agg(self, c: _Contribution) -> _CondensationAgg:
        """The block's condensation aggregate (``AssembledSystem._get_cond_agg``),
        with the stacked slots of every element's boundary space."""
        blk = c.block
        agg = self._cond_aggs.get(id(blk))
        if agg is None:
            act = np.nonzero(self.problem.active_mask(c.domain_id))[0]
            b_nodes = boundary_node_indices(blk.element_type, blk.order)
            i_nodes = internal_node_indices(blk.element_type, blk.order)
            E = blk.n_elements
            nb, ni = len(b_nodes) * len(act), len(i_nodes) * len(act)
            agg = _CondensationAgg(
                block=blk, act=act, b_nodes=b_nodes, i_nodes=i_nodes,
                b_dofs=self.dofmap.node_dof[blk.nodes[:, b_nodes]][:, :, act].reshape(E, nb),
                Kbi=torch.zeros((E, nb, ni), dtype=_ASM_DTYPE, device=self.device),
                Kii=torch.zeros((E, ni, ni), dtype=_ASM_DTYPE, device=self.device),
                Fi=torch.zeros((E, ni, self.n_rhs), dtype=_ASM_DTYPE, device=self.device),
            )
            agg.b_sidx = self._stacked(self._parts[id(blk)], agg.b_dofs)
            self._cond_aggs[id(blk)] = agg
        return agg

    def _end_impl(self) -> None:
        if self._assembled_mode:
            self._end_assembled()
        else:
            self._end_matrix_free()

    def _end_matrix_free(self) -> None:
        """The rhs and operator diagonal of every bucket over all its elements
        (each element where its shard holds it), then exported to the owners."""
        N = self.n_shards * self.n_loc1
        rhs = self._zeros((N, self.n_rhs))
        diag = self._zeros((N,))
        for b in self._sbuckets:
            c = b.c
            use_sf = self._use_sumfact(c)
            E = c.verts.shape[0]
            chunk = int(max(1, (1 << 25) // max(c.tables.n_qp * 128, 1)))
            q_order = c.options.quadrature_order(c.tables.order)
            for s in range(0, E, chunk):
                sel = slice(s, s + chunk)
                geom = element_geometry(
                    c.tables, self._tensor(c.verts[sel]), with_phys_ders=not use_sf or c.field_access is not None
                )
                A, f = self._eval_operators(c, geom, sel)
                B = None if use_sf else _basis_stack(c.tables, geom)
                idx = torch.as_tensor(b.sidx[sel].reshape(-1), device=self.device)
                if c.mode != "operator":
                    if use_sf:
                        F = local_rhs_sumfact(A, geom, c.tables.order, q_order, c.tables.dim, f)
                    else:
                        F = local_rhs(A, B, geom.weights, f)
                    rhs.index_add_(0, idx, F.reshape(-1, self.n_rhs))
                if c.mode != "rhs":
                    if use_sf:
                        d = local_diagonal_sumfact(A, geom, c.tables.order, q_order, c.tables.dim)
                    else:
                        d = local_diagonal(A, B, geom.weights)
                    diag.index_add_(0, idx, d.reshape(-1))
        self._finish_rhs_diag(rhs, diag)

    def _finish_rhs_diag(self, rhs: torch.Tensor, diag: torch.Tensor) -> None:
        """The stacked rhs and diagonal (built on the home device over every
        shard) placed, exported and masked."""
        P, L = self.n_shards, self.n_loc1
        owned = self._owned_mask
        self.rhs = self._export(self._place(rhs.reshape(P, L, self.n_rhs))) * owned[:, :, None]
        d = self._export(self._place(diag.reshape(P, L, 1)))[:, :, 0] * owned
        # unit diagonal on non-owned slots and Dirichlet dofs, for Jacobi
        keep = self._free_local * owned
        self._diag = d * keep + (1.0 - keep)

    # -- assembled mode ---------------------------------------------------------

    def _bucket_scatter_dofs(self, b: _ShardBucket):
        """(stacked rows of the bucket's K scatter (E, L), local selection or
        None): on a condensed block only the element-boundary part."""
        if not self._condensed(b.c):
            return b.sidx, None
        agg = self._cond_aggs[id(b.c.block)]
        n_nodes = b.c.elem_dofs.shape[1]
        sel = _cond_selectors(agg.act, agg.b_nodes, agg.i_nodes, n_nodes, b.c.dof_inds)
        return b.sidx[:, sel[0]], sel

    def _setup_assembled(self) -> None:
        """The shards' CSR partial matrices as one block-diagonal pattern over
        the stacked slots: every pair of an element's slots (on condensed
        blocks, of its boundary space), the host analog of the reference's
        per-shard keys (``distributed.py:_setup_assembled``)."""
        import scipy.sparse as sp

        N = self.n_shards * self.n_loc1
        pattern = sp.csr_matrix((N, N), dtype=np.int8)
        sets = [self._bucket_scatter_dofs(b)[0] for b in self._sbuckets if b.c.mode != "rhs"]
        sets += [agg.b_sidx for agg in self._cond_aggs.values()]
        for dofs in sets:
            E, L = dofs.shape
            B = sp.csr_matrix((np.ones(E * L, np.int8), dofs.reshape(-1), np.arange(0, E * L + 1, L)), shape=(E, N))
            pattern = pattern + (B.T @ B).tocsr()
        pattern.sort_indices()
        indptr = pattern.indptr.astype(np.int64)
        rows = np.repeat(np.arange(N, dtype=np.int64), np.diff(indptr))
        cols = pattern.indices.astype(np.int64)
        self._asm = dict(
            indptr=indptr, rows=rows, cols=cols, keys=rows * N + cols, N=N,
            diag_pos=np.nonzero(rows == cols)[0],
        )

    def _asm_positions(self, dofs: np.ndarray) -> torch.Tensor:
        """Positions in the stacked CSR data of every (row, col) pair of an
        element's slots (E, L, L)."""
        a = self._asm
        k = dofs[:, :, None] * a["N"] + dofs[:, None, :]
        return torch.as_tensor(np.searchsorted(a["keys"], k.reshape(-1)), device=self.device)

    def _end_assembled(self) -> None:
        """Local matrices of every operator bucket scattered into the stacked
        CSR (float64, ``_ASM_DTYPE``), each condensed block's Schur complements
        added, the diagonal taken from the matrix; rhs and diagonal exported."""
        self._setup_assembled()
        N, dev = self._asm["N"], self.device
        data = torch.zeros(len(self._asm["keys"]), dtype=_ASM_DTYPE, device=dev)
        rhs = torch.zeros((N, self.n_rhs), dtype=_ASM_DTYPE, device=dev)
        for b in self._sbuckets:
            c = b.c
            rows_s, sel = self._bucket_scatter_dofs(b)
            pos = None if c.mode == "rhs" else self._asm_positions(rows_s)
            E, L = rows_s.shape
            chunk = self._chunk(c)
            agg = self._cond_aggs.get(id(c.block)) if sel is not None else None
            if agg is not None:
                b_sel, tb, i_sel, ti = (torch.as_tensor(a, device=dev) for a in sel)
                elems = np.asarray(c.elem_sel if c.elem_sel is not None else np.arange(E), dtype=np.int64)
            for s in range(0, E, chunk):
                sl = slice(s, s + chunk)
                K, F = self._local_kf(c, sl)
                if agg is not None:
                    er = torch.as_tensor(elems[sl], device=dev)
                    if K is not None and len(i_sel):
                        Kb = K[:, b_sel]
                        agg.Kbi.index_put_((er[:, None, None], tb[None, :, None], ti[None, None, :]),
                                           Kb[:, :, i_sel], accumulate=True)
                        agg.Kii.index_put_((er[:, None, None], ti[None, :, None], ti[None, None, :]),
                                           K[:, i_sel][:, :, i_sel], accumulate=True)
                    if F is not None and len(i_sel):
                        agg.Fi.index_put_((er[:, None], ti[None, :]), F[:, i_sel], accumulate=True)
                    if K is not None:
                        K = K[:, b_sel][:, :, b_sel]
                    if F is not None:
                        F = F[:, b_sel]
                if K is not None:
                    data.index_add_(0, pos[s * L * L : (s + K.shape[0]) * L * L], K.reshape(-1))
                if F is not None:
                    idx = torch.as_tensor(rows_s[sl].reshape(-1), device=dev)
                    rhs.index_add_(0, idx, F.reshape(-1, self.n_rhs))
        for agg in self._cond_aggs.values():
            Y, Z = _schur_solve(agg.Kii, agg.Kbi.transpose(1, 2), agg.Fi)
            data.index_add_(0, self._asm_positions(agg.b_sidx), torch.bmm(agg.Kbi, Y).reshape(-1), alpha=-1)
            b_idx = torch.as_tensor(agg.b_sidx.reshape(-1), device=dev)
            rhs.index_add_(0, b_idx, torch.bmm(agg.Kbi, Z).reshape(-1, self.n_rhs), alpha=-1)
            agg.Y, agg.Z = Y.to(self.dtype), Z.to(self.dtype)
        self.data = data.to(self.dtype)
        a = self._asm
        # one CSR per group: the stacked pattern is block-diagonal by shard
        L, self._csr = self.n_loc1, []
        for g in self._groups:
            r0, r1 = g.lo * L, g.hi * L
            p0, p1 = int(a["indptr"][r0]), int(a["indptr"][r1])
            self._csr.append(torch.sparse_csr_tensor(
                torch.as_tensor(a["indptr"][r0 : r1 + 1] - p0, device=g.device),
                torch.as_tensor(a["cols"][p0:p1] - r0, device=g.device), self.data[p0:p1].to(g.device),
                size=(r1 - r0, r1 - r0), check_invariants=False,
            ))
        diag = torch.zeros(N, dtype=self.dtype, device=dev)
        dp = a["diag_pos"]
        diag.index_add_(0, torch.as_tensor(a["rows"][dp], device=dev), self.data[torch.as_tensor(dp, device=dev)])
        self._finish_rhs_diag(rhs.to(self.dtype), diag)

    # -- the operator -------------------------------------------------------------

    def _bucket_op_data(self, b: _ShardBucket):
        """(op data, stacked gather index (E, L) on the device) of one bucket
        (the reference's ``_bucket_op_data``): kinds ``dense_const``/``dense``
        (AUTO at p >= 2 and DENSE_MXU: the port's AUTO takes the dense apply
        on every device), ``sumfact_const``/``sumfact`` (SUM_FACT), else
        ``direct``, structurally restricted as on one device (a value-only
        boundary kernel keeps its face nodes, and only their dofs are
        gathered)."""
        c = b.c
        idx = torch.as_tensor(b.sidx, device=self.device)
        if c.tables.side is None:
            use_dense = self._use_dense(c)
            if use_dense or self._use_sumfact(c):
                A_const = self._const_operators(c)
                Ball = None
                if use_dense:
                    from ..ops.dense_eval import dense_basis_matrix

                    Ball = self._tensor(dense_basis_matrix(c.tables))
                if A_const is None:
                    A_t, Ji_t, w_t = self._packed_operators(c)
                    d = ("dense", A_t, Ji_t, w_t, Ball) if use_dense else ("sumfact", A_t, Ji_t, w_t)
                    return d, idx
                Ji_t, w_t = self._geometry_packed(c)
                Ji_t, w_t = Ji_t.to(self.dtype).contiguous(), w_t.to(self.dtype)
                d = ("dense_const", A_const, Ji_t, w_t, Ball) if use_dense else ("sumfact_const", A_const, Ji_t, w_t)
                return d, idx
        A, B, w, ns = self._direct_parts(c)
        if ns is not None:  # the dropped basis columns' dofs leave the gather
            E, n_unk = c.elem_dofs.shape[0], c.elem_dofs.shape[2]
            idx = idx.reshape(E, -1, n_unk)[:, torch.as_tensor(ns, device=self.device)].reshape(E, -1)
        return ("direct", A, B, w), idx

    def _operators(self):
        """[(contribution, op data, gather index)] of the current assembly over
        every shard, on the home device, built on first use."""
        if self._ops is None:
            if self._open or self._diag is None:
                raise RuntimeError("the operator is available after end_assembly")
            self._ops = [(b.c,) + self._bucket_op_data(b) for b in self._sbuckets if b.c.mode != "rhs"]
        return self._ops

    def _group_operators(self) -> list:
        """Per group, [(contribution, op data, gather index)] over the group's
        elements on its device, the gather index in the group's stacked slots
        (each bucket's elements split by the group of their shard)."""
        if self._gops is None:
            ops = self._operators()
            if len(self._groups) == 1:
                self._gops = [ops]
                return self._gops
            buckets = [b for b in self._sbuckets if b.c.mode != "rhs"]
            group_of = self._shard_group()[np.concatenate([b.part for b in buckets])] if buckets else None
            self._gops, off = [[] for _ in self._groups], 0
            for b, (c, d, idx) in zip(buckets, ops):
                E = len(b.part)
                gsel = group_of[off : off + E]
                off += E
                for gi, g in enumerate(self._groups):
                    esel = np.nonzero(gsel == gi)[0]
                    if not len(esel):
                        continue
                    et = torch.as_tensor(esel, device=idx.device)
                    self._gops[gi].append((
                        c, _split_op(d, et, c.tables.n_qp, g.device), (idx[et] - g.lo * self.n_loc1).to(g.device),
                    ))
        return self._gops

    def _raw_apply(self, x, state):
        """The unconstrained operator on stacked vectors: import, per group
        the element (or CSR) apply over its shards at once, export, owned mask."""
        xs = self._import_parts([p.clone() for p in self._split(x)])
        ys = []
        for xp, st in zip(xs, state):
            n, L, r = xp.shape
            xg = xp.reshape(n * L, r)
            if self._assembled_mode:
                y = st @ xg
            else:
                cols = [torch.zeros(n * L, dtype=xp.dtype, device=xp.device) for _ in range(r)]
                for c, d, idx in st:
                    n_unk = c.elem_dofs.shape[2]
                    for rr in range(r):
                        x_loc = xg[idx, rr].reshape(idx.shape[0], -1, n_unk)
                        cols[rr].index_add_(0, idx.reshape(-1), self._local_apply(c, d, x_loc).reshape(-1))
                y = torch.stack(cols, dim=1)
            ys.append(y.reshape(n, L, r))
        owned = self._split(self._owned_mask)
        return self._join([y * m[:, :, None] for y, m in zip(self._export_parts(ys), owned)])

    def _state(self):
        """Per group, the operator's data: its CSR, or its element buckets."""
        if self._assembled_mode:
            if self._csr is None:
                raise RuntimeError("the assembled distributed operator is available after end_assembly")
            return self._csr
        return self._group_operators()

    def raw_operator(self):
        """The constrained distributed operator is built in operator()."""
        raise NotImplementedError("DistributedSystem uses operator() directly")

    def raw_parts(self, layout: str = "dof"):
        """(fn, (state,)): the unconstrained operator as fn(x, state), state
        being this assembly's operator data (kept by a lagged preconditioner)."""
        if layout != "dof":
            raise ValueError("a DistributedSystem runs on the stacked dof layout only")
        return self._raw_apply, (self._state(),)

    def operator_parts(self, layout: str = "dof"):
        """(fn, consts): the constrained SPD operator on stacked vectors,
        ``y = owned * (free * A(free * x)) + dir * x``."""
        fn, consts = self.raw_parts(layout)
        free, fixed = self._free_local[:, :, None], self._dir_local[:, :, None]

        def apply(x, *cs):
            return fn(x * free, *cs) * free + x * fixed

        return apply, consts

    # -- assembled-matrix export (Schwarz preconditioners, direct solvers) ------

    def _slot_globals(self) -> np.ndarray:
        """(n_shards * n_loc1,) global dof of every stacked slot, -1 on unused
        slots and the dump."""
        G = np.full((self.n_shards, self.n_loc1), -1, dtype=np.int64)
        for p in range(self.n_shards):
            lg = np.concatenate([self._owned[p], self._ghost[p]])
            G[p, : len(lg)] = lg
        return G.reshape(-1)

    def gathered_csr(self):
        """Host GLOBAL Dirichlet-eliminated CSR summed from the shards' partial
        matrices (GLOBAL_ASSEMBLY only): ``(data, indices, indptr, n_dofs)``,
        host numpy, float64.  Feeds the additive-Schwarz preconditioners and
        the direct solvers (``solve/Amesos2Solvers.hpp:13-49``)."""
        if self._csr is None:
            raise RuntimeError("gathered_csr requires GLOBAL_ASSEMBLY and a completed end_assembly")
        if self._gathered is not None:
            return self._gathered
        import scipy.sparse as sp

        G = self._slot_globals()
        a = self._asm
        r, c = G[a["rows"]], G[a["cols"]]
        keep = (r >= 0) & (c >= 0)
        vals = self.data.detach().cpu().numpy().astype(np.float64)[keep]
        A = sp.coo_matrix((vals, (r[keep], c[keep])), shape=(self.n_dofs, self.n_dofs)).tocsr()
        A.sum_duplicates()
        A.sort_indices()
        # Dirichlet elimination in place (no scipy arithmetic, which prunes
        # exact zeros and can leave an asymmetric pattern): zero rows and
        # columns, unit diagonal
        free = self._free_np
        r_all = np.repeat(np.arange(self.n_dofs), np.diff(A.indptr))
        A.data[~(free[r_all] & free[A.indices])] = 0.0
        diag_sel = r_all == A.indices
        A.data[diag_sel] = np.where(free[r_all[diag_sel]], A.data[diag_sel], 1.0)
        self._gathered = (A.data, A.indices, A.indptr, self.n_dofs)
        return self._gathered

    def shard_blocks(self, overlap: int = 0):
        """Per-shard sub-blocks of the gathered matrix for additive Schwarz:
        rows and columns of the shard's owned dofs (``overlap=0``) or owned
        and ghost dofs (``overlap=1``).  A list of ``(scipy csr, n_real)`` in
        local slot numbering."""
        import scipy.sparse as sp

        data, indices, indptr, n = self.gathered_csr()
        A = sp.csr_matrix((data, indices, indptr), shape=(n, n))
        out = []
        for p in range(self.n_shards):
            ids = self._owned[p] if overlap == 0 else np.concatenate([self._owned[p], self._ghost[p]])
            sub = A[ids][:, ids].tocsr()
            sub.sort_indices()
            out.append((sub, len(ids)))
        return out

    # -- solver-facing overrides -------------------------------------------------

    def dirichlet_extension(self):
        g = self._zeros((self.n_shards, self.n_loc1, self.n_rhs))
        if len(self.dirichlet_dofs):
            g[torch.as_tensor(self._dir_shard, device=self.device),
              torch.as_tensor(self._dir_slot, device=self.device)] = self.dirichlet_values
        return self._place(g)

    def effective_rhs(self) -> torch.Tensor:
        if self._effective_rhs is None:
            g = self.dirichlet_extension()
            y = self._raw_apply(g, self._state())
            self._effective_rhs = self._free_local[:, :, None] * (self.rhs - y) + g
        return self._effective_rhs

    def effective_rhs_global(self) -> np.ndarray:
        """Host (n_dofs, n_rhs) float64 gather of the effective rhs (direct solvers)."""
        return self._to_global(self.effective_rhs()).cpu().numpy().astype(np.float64)

    def diagonal(self) -> torch.Tensor:
        if self._diag is None:
            raise RuntimeError("diagonal available after end_assembly")
        return self._diag

    def set_solution_vector(self, x) -> None:
        self.x = self._place(x.reshape(self.n_shards, self.n_loc1, self.n_rhs))

    def _owner_index(self, device):
        return tuple(torch.as_tensor(a, device=device) for a in self._owner_plan)

    def _to_stacked(self, xg: torch.Tensor):
        """A global (n_dofs, r) tensor on the stacked slots (P, n_loc1, r) in
        this system's placement: owned slots only, ghosts and the dump at zero."""
        so, lo, go = self._owner_index(xg.device)
        xs = xg.new_zeros((self.n_shards, self.n_loc1, xg.shape[-1]))
        xs[so, lo] = xg[go]
        return self._place(xs)

    def _to_global(self, xs) -> torch.Tensor:
        """The owned slots of a stacked tensor as a global (n_dofs, r) tensor
        (on the home device)."""
        xs = self._full(xs)
        so, lo, go = self._owner_index(xs.device)
        xg = xs.new_zeros((self.n_dofs, xs.shape[-1]))
        xg[go] = xs[so, lo]
        return xg

    def _x_global(self) -> torch.Tensor:
        return self._to_global(self.x)

    def _solution_global(self) -> np.ndarray:
        """The solution as a host (n_dofs, n_rhs) float64 array."""
        return self._x_global().cpu().numpy().astype(np.float64)

    def _set_solution_global(self, xg) -> None:
        """Set the stacked solution from a global (n_dofs, n_rhs) array or tensor."""
        xg = torch.as_tensor(xg, dtype=self.dtype, device=self.device).reshape(self.n_dofs, self.n_rhs)
        self.x = self._to_stacked(xg)

    def _update_plan(self, dof_inds: tuple):
        """Cached (shard, slot, has) of the owner of every (node, dof) pair."""
        plans = self.__dict__.setdefault("_upd_plans", {})
        plan = plans.get(dof_inds)
        if plan is None:
            nd = self.dofmap.node_dof[:, list(dof_inds)]
            has = nd >= 0
            g = np.where(has, nd, 0)
            s = self._owner[g]
            sl = np.empty_like(g)
            for p in np.unique(s):
                m = s == p
                sl[m] = self._g2l_map(int(p), g[m])
            plan = plans[dof_inds] = tuple(torch.as_tensor(a, device=self.device) for a in (s, sl, has))
        return plan

    def update_solution(self, dof_inds, solution_manager, slot_inds, rhs_index: int = 0) -> None:
        """Solution components into SolutionManager slots, read from their
        owners' slots; condensed blocks' interiors recovered from each
        element's Schur factors (``StaticCondensationManager::recoverSolution``)."""
        dof_inds = tuple(int(d) for d in dof_inds)
        slot_inds = [int(s) for s in slot_inds]
        if len(dof_inds) != len(slot_inds):
            raise ValueError("dof_inds and slot_inds must have equal length")
        s, sl, has = self._update_plan(dof_inds)
        x = self._full(self.x)
        vals = torch.where(has, x[s, sl, rhs_index], torch.zeros((), dtype=self.dtype, device=self.device))
        new = solution_manager.values.clone()
        new[:, slot_inds] = vals.to(dtype=new.dtype, device=new.device)
        if self._cond_aggs:
            xg = self._x_global()[:, rhs_index]
            for agg in self._cond_aggs.values():
                if agg.Y is None:
                    continue
                ub = xg[torch.as_tensor(agg.b_dofs, device=self.device)]
                ui = agg.Z[..., rhs_index] - torch.bmm(agg.Y, ub[:, :, None])[..., 0]
                ui = ui.reshape(ub.shape[0], len(agg.i_nodes), len(agg.act))
                idx = torch.as_tensor(agg.block.nodes[:, agg.i_nodes].reshape(-1), device=new.device)
                for di, si in zip(dof_inds, slot_inds):
                    hit = np.nonzero(agg.act == di)[0]
                    if len(hit):
                        new[idx, si] = ui[:, :, int(hit[0])].reshape(-1).to(dtype=new.dtype, device=new.device)
        solution_manager.values = new

    def describe(self, per_shard: bool = False) -> str:
        """One-line summary, with the shards' devices; ``per_shard=True``
        appends the per-shard table (elements, owned/ghost dofs, halo
        send/receive widths, local nnz when assembled) with its
        min/max/total footer."""
        counts = [len(o) for o in self._owned]
        head = (
            f"DistributedSystem: {self.n_dofs} dofs over {self.n_shards} shards "
            f"(owned per shard: min {min(counts)}, max {max(counts)}), "
            f"{len(self.dirichlet_dofs)} Dirichlet dofs, halo width {self._max_send}, "
            f"{self._n_neighbors} neighbor offsets, dtype={self.dtype}, {describe_placement(self._groups)}"
        ) + _last_solve_suffix(self)
        if not per_shard:
            return head
        P = self.n_shards
        elems = np.zeros(P, dtype=np.int64)
        for _, blk in self.mesh.blocks():
            part = self._parts.get(id(blk))
            if part is not None:
                elems += np.bincount(part, minlength=P)
        send, recv = np.zeros(P, dtype=np.int64), np.zeros(P, dtype=np.int64)
        for _, _, RI, SM in self._comm:
            send += SM.sum(dim=1).to(torch.int64).cpu().numpy()
            recv += (RI != self._dump).sum(dim=1).cpu().numpy()
        cols = ["shard", "elems", "owned", "ghost", "send", "recv"]
        table = [list(range(P)), elems.tolist(), counts, [len(g) for g in self._ghost], send.tolist(), recv.tolist()]
        if self._asm is not None:
            rows_s = self._asm["rows"] // self.n_loc1
            cols.append("nnz")
            table.append(np.bincount(rows_s, minlength=P).tolist())
        w = [max(len(h), 8) for h in cols]
        lines = [head, "  ".join(h.rjust(wi) for h, wi in zip(cols, w))]
        for p in range(P):
            lines.append("  ".join(str(col[p]).rjust(wi) for col, wi in zip(table, w)))
        for name, f in (("min", min), ("max", max), ("total", sum)):
            lines.append("  ".join([name.rjust(w[0])] + [str(f(col)).rjust(wi) for col, wi in zip(table[1:], w[1:])]))
        return "\n".join(lines)


def make_distributed_system(
    mesh,
    problem,
    bc_def=None,
    params: AlgebraicSystemParams = AlgebraicSystemParams(eval_strategy=OperatorEvaluationStrategy.MATRIX_FREE),
    n_shards: int | None = None,
    devices=None,
    dtype=torch.float32,
    part_fractions=None,
    partition_method: str = "rcb",
    partition_grid: tuple[int, int] | None = None,
    device=None,
) -> DistributedSystem:
    """Factory for the sharded system (``distributeMesh`` +
    ``makeAlgebraicSystem`` analog), on the CUDA device unless ``device``
    says otherwise.  MATRIX_FREE keeps everything element-local;
    GLOBAL_ASSEMBLY builds per-shard CSR partial matrices sharing the same
    halo pattern.  ``part_fractions`` weights the shards;
    ``partition_grid=(Pa, Pb)`` ranks them on a 2D grid (RCB per axis, halo
    offsets {±1, ±Pb}).  ELEMENT_BOUNDARY condensation needs
    GLOBAL_ASSEMBLY: matrix-free evaluation rejects it, as
    ``MakeAlgebraicSystem.hpp:18-31`` does."""
    if (
        params.cond_policy != CondensationPolicy.NONE
        and params.eval_strategy != OperatorEvaluationStrategy.GLOBAL_ASSEMBLY
    ):
        raise ValueError("matrix-free evaluation cannot be combined with static condensation")
    return DistributedSystem(
        mesh, problem, bc_def, params, n_shards, devices, dtype, part_fractions,
        partition_method, partition_grid, device,
    )
