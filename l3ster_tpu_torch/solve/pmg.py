"""Unstructured two-level p-multigrid preconditioner (PyTorch port of
``l3ster_tpu.solve.pmg``).

A strong preconditioner for matrix-free systems on any mesh, where the
lattice :class:`~l3ster_tpu_torch.solve.lowordermg.LowOrderMG` does not
apply (e.g. the Karman cylinder-in-channel mesh).  Its V-cycle:

- **fine level**: Jacobi-scaled Chebyshev smoothing with the system's own
  operator;
- **coarse level**: the same least-squares kernels rediscretized at Q1 on
  the corner-vertex mesh (:func:`~l3ster_tpu_torch.mesh.convert_order
  .extract_q1_mesh`), assembled in float64 on the system's device at each
  refresh by replaying the fine system's operator contributions (fields
  restricted to the corner nodes), eliminated, and inverted on the host in
  float64; the coarse solve is one (n_c, n_c) @ (n_c, m) product with the
  inverse held in the system dtype;
- **transfers**: geometry-free Q1 interpolation in reference coordinates
  (each fine node takes a fixed 2^dim-corner weight row), applied as
  node-row ``index_add_`` (restriction) and gather (prolongation).

A refresh (coarse inverse, smoother scaling, lambda_max) captures the
operator of its assembly: under ``lag`` the V-cycle keeps smoothing with
that operator until the next refresh, as the reference's does.  For
transient stepping set ``lag=k`` (refresh every k+1 reassemblies) or
``lag="auto"`` (refresh when the solver sees the iteration count degrade,
``solve/krylov.py:_note_precond_iters``).

On a :class:`~l3ster_tpu_torch.parallel.distributed.DistributedSystem` the
V-cycle runs on the stacked ``(n_shards, n_loc1, m)`` vectors: smoothing
with the system's operator (its halo exchange inside), a restriction whose
Q1 weights are zeroed outside each shard's owned slots and summed over the
shards (the reference's ``psum``), the coarse ``Binv @ r`` on the whole
coarse vector (the reference replicates it on every shard), and a gather for
the prolongation; the result is masked to the owned slots.  On shards placed
on several devices the stencils are placed with them and the coarse level
lives on the first group's device (``parallel/sharded.py``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .lowordermg import _cheb, _lambda_max, _power_start

__all__ = ["PMultigrid"]


def _q1_weights(ref: np.ndarray) -> np.ndarray:
    """(n_nodes, 2^dim) multilinear corner weights at reference coords
    (corners in vertex/lexicographic order: bit a of corner k = axis a)."""
    n, dim = ref.shape
    K = 1 << dim
    w = np.ones((n, K))
    for a in range(dim):
        bits = (np.arange(K) >> a) & 1
        w1 = np.stack([(1.0 - ref[:, a]) / 2.0, (1.0 + ref[:, a]) / 2.0], axis=1)
        w *= w1[:, bits]
    return w


def _build_transfers(mesh, remap: np.ndarray):
    """Per-fine-node prolongation stencil: (nbr, wts) with nbr (n_f, 2^dim)
    coarse node ids and wts the Q1 corner weights, taken from the first
    volume element containing each node (conforming Q1 interpolation is
    single-valued on shared faces, so the choice of owner is immaterial)."""
    from ..mesh.traits import corner_lattice_indices, reference_node_coords

    dim = mesh.dim
    K = 1 << dim
    nbr = np.zeros((mesh.n_nodes, K), dtype=np.int64)
    wts = np.zeros((mesh.n_nodes, K))
    seen = np.zeros(mesh.n_nodes, dtype=bool)
    for did, blk in mesh.blocks():
        if blk.dim != dim or did in mesh.boundary_ids:
            continue
        w = _q1_weights(reference_node_coords(blk.element_type, blk.order))  # (n_nodes_el, K)
        cids = remap[blk.nodes[:, corner_lattice_indices(blk.element_type, blk.order)]]
        uniq, first = np.unique(blk.nodes.reshape(-1), return_index=True)
        fresh = ~seen[uniq]
        uniq, first = uniq[fresh], first[fresh]
        e, n = np.divmod(first, blk.nodes.shape[1])
        nbr[uniq] = cids[e]
        wts[uniq] = w[n]
        seen[uniq] = True
    if not seen.all():
        raise ValueError(
            "PMultigrid: some mesh nodes appear in no volume element "
            f"({int((~seen).sum())} uncovered)"
        )
    return nbr, wts


def _restricted_field_access(fa, fine_ids: np.ndarray):
    """The field access restricted to the coarse (corner) nodes."""
    from ..post.solution import FieldAccess

    return FieldAccess(values=fa.values[torch.as_tensor(fine_ids, device=fa.values.device)], slots=fa.slots)


def _make_coarse_system(system, mesh1, max_dofs: int):
    """The assembled Q1 system in float64 on the fine system's device."""
    from ..algsys.system import make_algebraic_system
    from ..common.enums import OperatorEvaluationStrategy
    from ..common.problem import AlgebraicSystemParams

    params = AlgebraicSystemParams(eval_strategy=OperatorEvaluationStrategy.GLOBAL_ASSEMBLY, n_rhs=1)
    s1 = make_algebraic_system(
        mesh1, system.problem, system.bc_def, params, dtype=torch.float64, device=system.device
    )
    if s1.n_dofs > max_dofs:
        raise ValueError(
            f"PMultigrid coarse level has {s1.n_dofs} dofs > coarse_max_dofs="
            f"{max_dofs}; the dense inverse would need "
            f"{s1.n_dofs * s1.n_dofs * 4 / 2**20:.0f} MB — raise coarse_max_dofs "
            "or use a finer-grained preconditioner"
        )
    return s1


def _coarse_dense_inv(system, s1, fine_ids: np.ndarray, seconds: dict | None = None) -> np.ndarray:
    """(Re-)assemble the fine system's operator kernels at Q1 on the
    extracted mesh (``s1``, reused across refreshes), eliminate, and invert
    on the host in float64.  ``seconds`` receives the times of the coarse
    assembly and of the inverse."""
    t0 = time.perf_counter()
    s1.begin_assembly()
    for c in system._contribs:
        if c.mode == "rhs":
            continue
        fa = c.field_access[0] if c.field_access is not None else None
        if fa is not None:
            fa = _restricted_field_access(fa, fine_ids)
        rid = c.boundary_id if c.boundary_id is not None else c.domain_id
        s1.assemble_problem(c.kernel, [rid], field_access=fa, dof_inds=c.dof_inds, time=c.time, mode="operator")
    s1.end_assembly()
    dense = s1.eliminated_dense()
    t1 = time.perf_counter()
    inv = torch.linalg.inv(torch.from_numpy(dense)).numpy()
    if seconds is not None:
        seconds["coarse_assembly"] = t1 - t0
        seconds["inverse"] = time.perf_counter() - t1
    return inv


@dataclass(frozen=True)
class PMultigrid:
    """Unstructured p->1 two-level V-cycle preconditioner (see module doc).

    ``smooth_degree`` is the Chebyshev post-smoothing degree; ``pre_degree``
    the pre-smoothing degree (None -> symmetric V(k,k)).  ``pre_degree=0``
    makes M nonsymmetric across a genuinely coarse correction, which CG does
    not tolerate: keep V(k,k) under CG.  ``lag=k`` keeps a refresh (coarse
    inverse, smoother scaling, lambda_max and the operator itself) across
    up to k reassemblies; ``lag="auto"`` keeps it until the iteration count
    degrades past ``refresh_ratio`` times the first solve's after the
    refresh.  Freeze only across solves of the same operator family (a
    coarse level frozen from a steady Picard operator mispreconditions the
    transient one): warm up with Jacobi, or use one instance per operator.
    """

    smooth_degree: int = 2
    pre_degree: int | None = None
    cycles: int = 1
    lag: int | str = 0
    refresh_ratio: float = 1.35
    coarse_max_dofs: int = 12000
    eig_ratio: float = 8.0

    def setup(self, system):
        apply, pc = self.setup_parts(system)
        return lambda r: apply(r, *pc)

    def setup_parts(self, system, layout: str = "dof"):
        """(apply(r, *consts), consts) of one refresh: consts are the
        system's operator consts at this assembly, D^-1, the free mask,
        lambda_max, the transfer stencil and the coarse inverse.  The
        mesh-side pieces (Q1 mesh, transfers, coarse system) are built once
        per system and cached on it; ``last_refresh`` in that cache holds the
        refresh's times in seconds and ``refreshes`` counts them."""
        from ..algsys.system import _SystemBase

        if layout != "dof":
            raise ValueError("PMultigrid runs on dof-major vectors (unstructured meshes)")
        if not isinstance(system, _SystemBase):
            raise ValueError(
                "PMultigrid needs a system holding its mesh (matrix-free, assembled or "
                "distributed); a box-decomposed system takes LowOrderMG"
            )
        distributed = hasattr(system, "n_loc1")
        fn, oc = system.operator_parts()
        cache = getattr(system, "_pmg_static_cache", None)
        if cache is None:
            cache = system._pmg_static_cache = {}
        st = cache.get(self)
        if st is None:
            st = cache[self] = self._build_static(system)
            if distributed:
                st.update(self._build_static_distributed(system, st))
        seconds: dict = {}
        Binv_np = _coarse_dense_inv(system, st["s1"], st["fine_ids"], seconds)
        t0 = time.perf_counter()
        d = system.diagonal()
        dinv = torch.where(d.abs() > 1e-14, 1.0 / d, torch.ones_like(d))
        v0 = _power_start(0, d.numel(), system.dtype, system.device).reshape(d.shape + (1,))
        lam_max = _lambda_max(fn, oc, dinv, v0) * 1.05
        t1 = time.perf_counter()
        # the coarse inverse ships in the system dtype: a rounder one (the
        # reference tried bf16) stalls CG on the ill-conditioned coarse operator
        Binv = torch.as_tensor(Binv_np, dtype=system.dtype, device=system.device)
        if system.device.type == "cuda":
            torch.cuda.synchronize(system.device)
        seconds["power_iteration"] = t1 - t0
        seconds["upload"] = time.perf_counter() - t1
        st["last_refresh"] = seconds
        st["refreshes"] += 1
        if distributed:
            consts = (*oc, dinv, system._free_local, system._owned_mask, lam_max, st["cnb"], st["cwt"], Binv)
            return self._make_apply_distributed(fn, len(oc), st), consts
        return self._make_apply(fn, len(oc), st), (*oc, dinv, system.free_mask, lam_max, st["nbr"], Binv)

    def _build_static(self, system) -> dict:
        from ..mesh.convert_order import extract_q1_mesh

        mesh = system.mesh
        n_nodes = mesh.n_nodes
        n_unk = system.n_dofs // n_nodes
        if n_unk * n_nodes != system.n_dofs:
            raise ValueError("PMultigrid requires uniform dofs per node")
        mesh1, fine_ids = extract_q1_mesh(mesh)
        remap = np.full(n_nodes, -1, dtype=np.int64)
        remap[fine_ids] = np.arange(len(fine_ids), dtype=np.int64)
        nbr_np, wts_np = _build_transfers(mesh, remap)
        s1 = _make_coarse_system(system, mesh1, self.coarse_max_dofs)
        if s1.n_dofs != len(fine_ids) * n_unk:
            raise ValueError("PMultigrid requires uniform dofs per node on the coarse mesh")
        return dict(
            s1=s1, fine_ids=fine_ids, n_nodes=n_nodes, n_unk=n_unk, n_cnodes=len(fine_ids),
            nbr=torch.as_tensor(nbr_np, device=system.device),
            wts=torch.as_tensor(wts_np, dtype=system.dtype, device=system.device),
            refreshes=0, last_refresh=None,
        )

    @staticmethod
    def _build_static_distributed(system, st: dict) -> dict:
        """Per-shard transfer stencils over the stacked slots: coarse dof ids
        (node-major: coarse node * n_unk + unknown) and Q1 weights, the
        weights zero outside each shard's owned slots, so the summed
        restriction counts every fine dof once."""
        n_unk = st["n_unk"]
        nbr_np, wts_np = st["nbr"].cpu().numpy(), st["wts"].cpu().numpy()
        P, L, K = system.n_shards, system.n_loc1, nbr_np.shape[1]
        cnb = np.zeros((P, L, K), dtype=np.int64)
        cwt = np.zeros((P, L, K))
        for p in range(P):
            own = system._owned[p]
            node, unk = own // n_unk, own % n_unk
            cnb[p, : len(own)] = nbr_np[node] * n_unk + unk[:, None]
            cwt[p, : len(own)] = wts_np[node]
        return dict(
            cnb=system._place(torch.as_tensor(cnb, device=system.device)),
            cwt=system._place(torch.as_tensor(cwt, dtype=system.dtype, device=system.device)),
        )

    def _make_apply_distributed(self, fn, n_oc: int, st: dict):
        """The V-cycle on stacked vectors as apply(r, *consts) over the consts
        of a refresh (see the module doc)."""
        n_cdofs = st["n_cnodes"] * st["n_unk"]
        pre_degree = self.pre_degree if self.pre_degree is not None else self.smooth_degree
        smooth_degree, cycles, eig_ratio = self.smooth_degree, self.cycles, self.eig_ratio

        def apply(r, *cs):
            ocs = cs[:n_oc]
            dinv, free, owned, lam_max, cnb, cwt, Binv = cs[n_oc:]

            def restrict(rf):
                m = rf.shape[-1]
                rc = torch.zeros((n_cdofs, m), dtype=rf.dtype, device=rf.device)
                return rc.index_add_(0, cnb.reshape(-1), (cwt[..., None] * rf[:, :, None, :]).reshape(-1, m))

            def prolong(zc):
                return (cwt[..., None] * zc[cnb]).sum(dim=2)

            def vcycle(r_l):
                if pre_degree > 0:
                    z = _cheb(fn, r_l, torch.zeros_like(r_l), dinv, lam_max, ocs, pre_degree, eig_ratio, z0_zero=True)
                    rc = r_l - fn(z, *ocs)
                else:
                    z = torch.zeros_like(r_l)
                    rc = r_l
                zc = Binv @ restrict(rc * free[..., None])
                z = z + prolong(zc) * free[..., None]
                return _cheb(fn, r_l, z, dinv, lam_max, ocs, smooth_degree, eig_ratio)

            z = vcycle(r)
            for _ in range(cycles - 1):
                z = z + vcycle(r - fn(z, *ocs))
            # ghost and dump slots return zero: the Krylov dots sum every slot
            return z * owned[..., None]

        return apply

    def _make_apply(self, fn, n_oc: int, st: dict):
        """The V-cycle as apply(r, *consts) over the consts of a refresh."""
        n_nodes, n_unk, n_cnodes, wts = st["n_nodes"], st["n_unk"], st["n_cnodes"], st["wts"]
        pre_degree = self.pre_degree if self.pre_degree is not None else self.smooth_degree
        smooth_degree, cycles, eig_ratio = self.smooth_degree, self.cycles, self.eig_ratio

        def restrict(rf, nbr):
            # rf (n_fdofs, m) node-major -> coarse via the transposed stencil
            m = rf.shape[1]
            contrib = wts[:, :, None, None] * rf.reshape(n_nodes, 1, n_unk, m)  # (n_f, K, u, m)
            out = torch.zeros((n_cnodes, n_unk, m), dtype=rf.dtype, device=rf.device)
            out.index_add_(0, nbr.reshape(-1), contrib.reshape(-1, n_unk, m))
            return out.reshape(n_cnodes * n_unk, m)

        def prolong(zc, nbr):
            m = zc.shape[1]
            g = zc.reshape(n_cnodes, n_unk, m)[nbr]  # (n_f, K, u, m) node-row gathers
            return (wts[:, :, None, None] * g).sum(dim=1).reshape(n_nodes * n_unk, m)

        def apply(r, *cs):
            ocs = cs[:n_oc]
            dinv, free, lam_max, nbr, Binv = cs[n_oc:]

            def vcycle(r_l):
                if pre_degree > 0:
                    z = _cheb(fn, r_l, torch.zeros_like(r_l), dinv, lam_max, ocs, pre_degree, eig_ratio, z0_zero=True)
                    rc = r_l - fn(z, *ocs)
                else:
                    z = torch.zeros_like(r_l)
                    rc = r_l
                zc = Binv @ restrict(rc * free[:, None], nbr)
                z = z + prolong(zc, nbr) * free[:, None]
                return _cheb(fn, r_l, z, dinv, lam_max, ocs, smooth_degree, eig_ratio)

            z = vcycle(r)
            for _ in range(cycles - 1):
                z = z + vcycle(r - fn(z, *ocs))
            return z

        return apply
