"""Operator-based and assembled preconditioners (PyTorch port of ``l3ster_tpu.solve.precond``).

Analogs of ``solve/NativePreconditioners.hpp`` (Richardson, Jacobi with
thresholded diagonal inversion and Ifpack2-style relaxation sweeps) and the
Ifpack2-backed ones (``solve/Ifpack2Preconditioners.hpp:85-192``):
Chebyshev needs only the diagonal and operator applies; BlockJacobi, SGS,
ILU0 and ILUT need the assembled (Dirichlet-eliminated) CSR of an
:class:`~l3ster_tpu_torch.algsys.system.AssembledSystem`.  Their triangular
solves are level-scheduled on the device (:mod:`.tri`); ILU0 factors on the
host in C++ (:mod:`.hostops`), ILUT with SciPy's ``spilu``.

Every preconditioner speaks the reference's protocol: ``setup(system)``
returns ``M(r)`` on dof-layout vectors, and ``setup_parts(system[, layout])``
returns ``(apply(r, *consts), consts)`` (``"lattice"`` layout where
``supports_lattice_layout``).

On a :class:`~l3ster_tpu_torch.parallel.distributed.DistributedSystem`
(stacked ``(n_shards, n_loc1, n_rhs)`` vectors) Jacobi and Chebyshev run
unchanged; SGS, ILU0 and ILUT become additive Schwarz with per-shard local
solves on each shard's block of the gathered CSR (``overlap`` 0: owned
dofs, no exchange; 1: owned and ghost dofs, import -> local solve -> export
-> owned mask, symmetric and CG-safe), as Ifpack2 runs under MPI; and
BlockJacobi inverts the same node blocks as on one device, each on the
shard owning the node.  Their per-shard data are built per placement group
of the system, on the group's device, and applied group by group
(``DistributedSystem._group_map``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import tri

__all__ = ["Identity", "Richardson", "Jacobi", "Chebyshev", "BlockJacobi", "SGS", "ILU0", "ILUT"]


def _identity_apply(r, *pc):
    return r


def _jacobi_apply(r, inv):
    return inv[..., None] * r


def _assembled_csr(system, who: str):
    """(data on the device, indices, indptr, n) of the Dirichlet-eliminated CSR."""
    csr = getattr(system, "eliminated_csr", None)
    if csr is None:
        raise ValueError(f"{who} needs the assembled CSR: use OperatorEvaluationStrategy.GLOBAL_ASSEMBLY")
    return csr()


def _host_f64(data: torch.Tensor) -> np.ndarray:
    return data.detach().cpu().numpy().astype(np.float64)


def _is_distributed(system) -> bool:
    return getattr(system, "shard_blocks", None) is not None


def _schwarz_csrs(system, who: str, overlap: int = 1):
    """Per-shard local CSRs over the common [owned | ghost | dump] slot space
    (n = n_loc1): each shard's block of the gathered matrix, unit diagonal on
    its unused and dump slots.  ``overlap=1`` spans [owned | ghost]: one layer
    of overlap, applied as import -> local solve -> export -> owned mask,
    which is symmetric; ``overlap=0`` spans the owned dofs only."""
    try:
        blocks = system.shard_blocks(overlap=overlap)
    except RuntimeError as e:
        raise ValueError(
            f"{who} on a DistributedSystem needs OperatorEvaluationStrategy.GLOBAL_ASSEMBLY "
            "(per-shard local matrices are cut from the gathered CSR)"
        ) from e
    n = system.n_loc1
    out = []
    for sub, n_real in blocks:
        nnz, n_pad = sub.indptr[-1], n - n_real
        out.append((
            np.concatenate([sub.data, np.ones(n_pad)]),
            np.concatenate([sub.indices.astype(np.int64), np.arange(n_real, n, dtype=np.int64)]),
            np.concatenate([sub.indptr.astype(np.int64), nnz + 1 + np.arange(n_pad, dtype=np.int64)]),
        ))
    return out, n


def _per_group(system, csrs, build):
    """The per-shard local solve of additive Schwarz over the shards' local
    CSRs, built per placement group: ``build(the group's CSRs, device) ->
    (fn, consts)`` with ``fn(r_group, *consts)``.  Returns ``(local,
    (consts per group,))`` with ``local(r, consts_per_group)``."""
    fns, css = [], []
    for g in system._groups:
        fn, cs = build(csrs[g.lo : g.hi], g.device)
        fns.append(fn)
        css.append(tuple(cs))

    def local(r, css):
        return system._group_map(lambda gi, rg: fns[gi](rg, *css[gi]), r)

    local.n_levels = max(getattr(f, "n_levels", 0) for f in fns)
    return local, (css,)


def _stacked_spmv(csrs, n: int, dtype, device):
    """The shards' local CSR matvec on stacked (P, n, n_rhs) vectors, as one
    block-diagonal product: (spmv(x, A), (A,))."""
    P = len(csrs)
    data = np.concatenate([d for d, _, _ in csrs])
    cols = np.concatenate([i + p * n for p, (_, i, _) in enumerate(csrs)])
    offs = np.cumsum([0] + [int(pp[-1]) for _, _, pp in csrs])
    indptr = np.concatenate([[0]] + [pp[1:] + offs[p] for p, (_, _, pp) in enumerate(csrs)])
    A = torch.sparse_csr_tensor(
        torch.as_tensor(indptr, device=device), torch.as_tensor(cols, device=device),
        torch.as_tensor(data, dtype=dtype, device=device), size=(P * n, P * n), check_invariants=False,
    )

    def spmv(x, A):
        return (A @ x.reshape(P * n, -1)).reshape(x.shape)

    return spmv, (A,)


def _schwarz_wrap(system, local_apply, consts, overlap: int):
    """The distributed apply around a per-shard local solve: with overlap,
    import (owner -> ghost), the local solves, export (ghost -> owner sum)
    and the owned mask; without, the local solves alone."""
    if overlap == 0:
        return local_apply, consts

    def apply(r, *cs):
        z = local_apply(system._import(r.clone()), *cs)
        return system._export(z) * system._owned_mask[:, :, None]

    apply.n_levels = getattr(local_apply, "n_levels", 0)
    return apply, consts


def chebyshev_start(n: int, dtype, device) -> torch.Tensor:
    """Chebyshev's power-iteration start vector (n, 1): drawn in float64 on the
    CPU from a generator seeded with 0, then cast and moved, so the CPU and
    the card start alike (the reference draws it from ``jax.random``)."""
    g = torch.Generator().manual_seed(0)
    return torch.randn((n, 1), generator=g, dtype=torch.float64).to(dtype=dtype, device=device)


@dataclass(frozen=True)
class Identity:
    """No preconditioning."""

    supports_lattice_layout = True

    def setup(self, system):
        return lambda r: r

    def setup_parts(self, system, layout="dof"):
        return _identity_apply, ()


@dataclass(frozen=True)
class Richardson:
    """M^-1 = factor * I (``NativePreconditioners.hpp`` Richardson)."""

    factor: float = 1.0
    supports_lattice_layout = True

    def setup(self, system):
        f = self.factor
        return lambda r: f * r

    def setup_parts(self, system, layout="dof"):
        f = self.factor
        return (lambda r, *pc: f * r), ()


@dataclass(frozen=True)
class Jacobi:
    """Inverted thresholded diagonal (``NativePreconditioners.hpp`` NativeJacobi).

    ``sweeps``/``damping`` mirror the Ifpack2 relaxation options
    (``Ifpack2Preconditioners.hpp:68-96``): k damped Jacobi iterations on
    M z = r (each extra sweep costs one operator apply); ``lag`` reuses the
    setup across up to ``lag`` reassemblies."""

    threshold: float = 1e-14
    sweeps: int = 1
    lag: int = 0
    damping: float = 1.0
    supports_lattice_layout = True

    def setup(self, system):
        apply, pc = self.setup_parts(system)
        return lambda r: apply(r, *pc)

    def setup_parts(self, system, layout="dof"):
        """(apply(r, inv, *operator consts), consts) on (n_dofs, n_rhs)
        vectors of the given layout."""
        d = system.diagonal()
        inv = torch.where(d.abs() > self.threshold, self.damping / d, torch.full_like(d, self.damping))
        if layout == "lattice":
            inv = system.to_lattice_layout(inv)
        if self.sweeps <= 1:
            return _jacobi_apply, (inv,)
        fn, oconsts = system.operator_parts(layout=layout)
        n_sweeps = self.sweeps

        def apply(r, inv, *oc):
            z = inv[..., None] * r
            for _ in range(n_sweeps - 1):
                z = z + inv[..., None] * (r - fn(z, *oc))
            return z

        return apply, (inv, *oconsts)


@dataclass(frozen=True)
class Chebyshev:
    """Chebyshev polynomial preconditioner on the Jacobi-scaled operator.

    lambda_max of D^-1 A is estimated by power iteration at setup (from
    :func:`chebyshev_start`); lambda_min = lambda_max / eig_ratio (Ifpack2's
    convention)."""

    degree: int = 4
    eig_ratio: float = 30.0
    power_iters: int = 20
    boost: float = 1.05

    def setup(self, system):
        apply, pc = self.setup_parts(system)
        return lambda r: apply(r, *pc)

    def setup_parts(self, system):
        fn, oconsts = system.operator_parts()
        d = system.diagonal()
        dinv_c = torch.where(d.abs() > 1e-14, 1.0 / d, torch.ones_like(d))

        def scaled_op(x):
            return dinv_c[..., None] * fn(x, *oconsts)

        v = chebyshev_start(d.numel(), d.dtype, d.device).reshape(d.shape + (1,))
        for _ in range(self.power_iters):
            w = scaled_op(v)
            v = w / torch.linalg.norm(w)
        lam_max = (v * scaled_op(v)).sum() / (v * v).sum() * self.boost
        lam_min = lam_max / self.eig_ratio
        theta_c = 0.5 * (lam_max + lam_min)
        delta_c = 0.5 * (lam_max - lam_min)
        degree = self.degree

        def apply(r, dinv, theta, delta, *oc):
            # Chebyshev iteration on (D^-1 A) z = D^-1 r from z0 = 0
            rs = dinv[..., None] * r
            z = rs / theta
            zp = torch.zeros_like(z)
            rho = delta / theta
            for _ in range(degree - 1):
                rho_new = 1.0 / (2.0 * theta / delta - rho)
                resid = rs - dinv[..., None] * fn(z, *oc)
                z_new = z + rho_new * ((2.0 / delta) * resid + rho * (z - zp))
                zp, z, rho = z, z_new, rho_new
            return z

        return apply, (dinv_c, theta_c, delta_c) + tuple(oconsts)


def _blockjacobi_apply(r, Binv, blk):
    """y = blockdiag(Binv) r over the blocks ``blk`` (M, K), padded with n."""
    n, n_rhs = r.shape
    rp = torch.cat([r, torch.zeros((1, n_rhs), dtype=r.dtype, device=r.device)])
    yb = torch.bmm(Binv, rp[blk])  # (M, K, n_rhs)
    y = torch.zeros((n + 1, n_rhs), dtype=r.dtype, device=r.device)
    y[blk.reshape(-1)] = yb.reshape(-1, n_rhs)
    return y[:n]


@dataclass(frozen=True)
class BlockJacobi:
    """Per-node dense block inverses (assembled path).

    Each node's coupled unknowns form a small dense block, inverted once at
    setup (batched Cholesky: the LSFEM normal matrix is SPD) and applied as
    one batched matmul.  Blocking follows the DofMap's node grouping when the
    system has one, else consecutive ``block_size`` chunks.  On a
    distributed system the blocks come from the gathered CSR and each is
    applied on the stacked slots of the shard owning its dofs (a node's
    dofs share one owner), so no exchange is needed."""

    block_size: int = 0  # 0 = derive from the system's DofMap

    def setup(self, system):
        apply, pc = self.setup_parts(system)
        return lambda r: apply(r, *pc)

    def _blocks(self, system, n: int) -> np.ndarray:
        """(M, K) dof ids of each block, padded with n."""
        dofmap = getattr(system, "dofmap", None)
        if self.block_size <= 0 and dofmap is not None:
            nd = np.asarray(dofmap.node_dof)
            K = nd.shape[1]
            blocks, seen = [], np.zeros(n, dtype=bool)
            for row in nd:
                d = row[row >= 0]
                d = d[~seen[d]]
                if not len(d):
                    continue
                seen[d] = True
                blocks.append(np.concatenate([d, np.full(K - len(d), n, dtype=np.int64)]))
            for d in np.nonzero(~seen)[0]:  # dofs outside any node row (defensive)
                blocks.append(np.concatenate([[d], np.full(K - 1, n, dtype=np.int64)]))
            return np.asarray(blocks, dtype=np.int64)
        K = max(1, self.block_size)
        b = np.full((-(-n // K), K), n, dtype=np.int64)
        b.reshape(-1)[:n] = np.arange(n, dtype=np.int64)
        return b

    def setup_parts(self, system):
        if _is_distributed(system):
            # the gathered matrix's blocks, each applied on the stacked slots of
            # the shard owning its dofs (a node's dofs share one owner), per
            # placement group (pad: one past the group's last slot)
            data, indices, indptr, n = system.gathered_csr()
            blocks = self._blocks(system, n)
            Binv = self._inverses(
                torch.as_tensor(data, dtype=system.dtype, device=system.device), indices, indptr, n, blocks
            )
            L, real = system.n_loc1, blocks < n
            owner = system._owner[np.minimum(blocks, n - 1)]  # (M, K): each dof's shard
            group = system._shard_group()[owner]
            if (real & (group != group[:, :1])).any():
                raise ValueError("BlockJacobi: a block spans two placement groups")
            Binvs, stacks = [], []
            for gi, g in enumerate(system._groups):
                mine = np.nonzero(group[:, 0] == gi)[0]
                bl, ow = blocks[mine], owner[mine]
                stacked = np.full(bl.shape, g.n * L, dtype=np.int64)
                for p in range(g.lo, g.hi):
                    m = (bl < n) & (ow == p)
                    stacked[m] = (p - g.lo) * L + system._g2l_map(p, bl[m])
                Binvs.append(Binv[torch.as_tensor(mine, device=Binv.device)].to(g.device))
                stacks.append(torch.as_tensor(stacked, device=g.device))

            def apply(r, Binvs, stacks):
                return system._group_map(lambda gi, rg: _blockjacobi_stacked_apply(rg, Binvs[gi], stacks[gi]), r)

            return apply, (Binvs, stacks)
        data, indices, indptr, n = _assembled_csr(system, "BlockJacobi")
        blocks = self._blocks(system, n)  # (M, K), pad = n
        return _blockjacobi_apply, (self._inverses(data, indices, indptr, n, blocks), torch.as_tensor(blocks, device=data.device))

    @staticmethod
    def _inverses(data: torch.Tensor, indices, indptr, n: int, blocks: np.ndarray) -> torch.Tensor:
        """(M, K, K) inverses of the CSR's node blocks ``blocks`` (M, K), padded with n."""
        M, K = blocks.shape
        # CSR keys are sorted (rows increasing, columns sorted per row); the
        # n + 1 base keeps the pad's keys distinct.  Only the block entries'
        # positions are found on the host; their values are gathered on the device.
        indptr = np.asarray(indptr, dtype=np.int64)
        keys = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr)) * (n + 1) + np.asarray(indices, np.int64)
        want = (blocks[:, :, None] * (n + 1) + blocks[:, None, :]).reshape(-1)
        pos = np.searchsorted(keys, want)
        posc = np.minimum(pos, len(keys) - 1)
        hit = (pos < len(keys)) & (keys[posc] == want)
        pad = blocks == n
        hit &= ~(pad[:, :, None] | pad[:, None, :]).reshape(-1)
        dev, dtype = data.device, data.dtype
        vals = torch.where(
            torch.as_tensor(hit, device=dev), data[torch.as_tensor(posc, device=dev)], torch.zeros((), dtype=dtype, device=dev)
        ).reshape(M, K, K)
        # identity rows/cols on padded slots keep the blocks invertible
        vals = vals + torch.diag_embed(torch.as_tensor(pad, dtype=dtype, device=dev))
        L, info = torch.linalg.cholesky_ex(vals)
        if bool((info != 0).any()):
            raise RuntimeError(f"BlockJacobi: {int((info != 0).sum())} node block(s) not positive definite in {dtype}")
        return torch.cholesky_solve(torch.eye(K, dtype=dtype, device=dev).expand(M, K, K), L)


def _blockjacobi_stacked_apply(r, Binv, blk):
    """:func:`_blockjacobi_apply` on stacked (P, L, n_rhs) vectors."""
    return _blockjacobi_apply(r.reshape(-1, r.shape[-1]), Binv, blk).reshape(r.shape)


def _tri_pair(fac, indices, indptr, n, dtype, device, unit_lower: bool):
    """(fwd, cf, bwd, cb): the lower solve (unit diagonal if ``unit_lower``)
    and the upper solve with its diagonal, of one CSR value array."""
    fwd, cf = tri.build_tri_solve(fac, indices, indptr, n, True, unit_lower, dtype, device)
    bwd, cb = tri.build_tri_solve(fac, indices, indptr, n, False, False, dtype, device)
    return fwd, cf, bwd, cb


@dataclass(frozen=True)
class SGS:
    """Symmetric Gauss-Seidel: M = (D+L) D^-1 (D+U) on the assembled CSR
    (``solve/Ifpack2Preconditioners.hpp:97``), its triangular solves
    level-scheduled on the device (:mod:`.tri`); ``sweeps`` adds
    Ifpack2-style relaxation iterations (one operator apply per extra
    sweep); ``lag`` reuses the setup across up to ``lag`` reassemblies."""

    sweeps: int = 1
    overlap: int = 1
    lag: int = 0

    def setup(self, system):
        apply, pc = self.setup_parts(system)
        return lambda r: apply(r, *pc)

    def _setup_parts_distributed(self, system):
        """Per-shard local SGS (additive Schwarz).  ``sweeps`` relaxes each
        shard's local matrix inside the Schwarz solve (Ifpack2's
        processor-block relaxation), which keeps the local M SPD."""
        dtype = system.dtype
        csrs, n = _schwarz_csrs(system, "SGS", self.overlap)
        n_sweeps = self.sweeps

        def build(csrs, device):
            fwd, cf = tri.build_tri_solve_stacked(csrs, n, True, False, dtype, device)
            bwd, cb = tri.build_tri_solve_stacked(csrs, n, False, False, dtype, device)
            dstk = np.ones((len(csrs), n))
            for p, (dd, ii, pp) in enumerate(csrs):
                rows = np.repeat(np.arange(n), np.diff(pp))
                sel = rows == ii
                dstk[p, rows[sel]] = dd[sel]
            nf, n_tri = len(cf), len(cf) + len(cb)

            def M_loc(r, cs):
                return bwd(fwd(r, *cs[1 : 1 + nf]) * cs[0][..., None], *cs[1 + nf : 1 + n_tri])

            tri_consts = (torch.as_tensor(dstk, dtype=dtype, device=device), *cf, *cb)
            if n_sweeps <= 1:

                def local(r, *cs):
                    return M_loc(r, cs)

                local.n_levels = fwd.n_levels + bwd.n_levels
                return local, tri_consts
            spmv, scs = _stacked_spmv(csrs, n, dtype, device)

            def local(r, *cs):
                tri_cs, sp_cs = cs[: 1 + n_tri], cs[1 + n_tri :]
                z = M_loc(r, tri_cs)
                for _ in range(n_sweeps - 1):
                    z = z + M_loc(r - spmv(z, *sp_cs), tri_cs)
                return z

            local.n_levels = fwd.n_levels + bwd.n_levels
            return local, (*tri_consts, *scs)

        return _schwarz_wrap(system, *_per_group(system, csrs, build), self.overlap)

    def setup_parts(self, system):
        if _is_distributed(system):
            return self._setup_parts_distributed(system)
        data, indices, indptr, n = _assembled_csr(system, "SGS")
        d = system.diagonal()
        fwd, cf, bwd, cb = _tri_pair(_host_f64(data), indices, indptr, n, d.dtype, d.device, False)
        nf, n_tri = len(cf), len(cf) + len(cb)

        def M(r, dvec, cs):
            return bwd(fwd(r, *cs[:nf]) * dvec[:, None], *cs[nf:n_tri])

        if self.sweeps <= 1:

            def apply(r, dvec, *cs):
                return M(r, dvec, cs)

            apply.n_levels, apply.launches = fwd.n_levels + bwd.n_levels, fwd.launches + bwd.launches + 1
            return apply, (d, *cf, *cb)
        fn, oconsts = system.operator_parts()
        n_sweeps = self.sweeps

        def apply(r, dvec, *cs):
            z = M(r, dvec, cs)
            for _ in range(n_sweeps - 1):
                z = z + M(r - fn(z, *cs[n_tri:]), dvec, cs)
            return z

        apply.n_levels = fwd.n_levels + bwd.n_levels
        return apply, (d, *cf, *cb, *oconsts)


@dataclass(frozen=True)
class ILU0:
    """Zero-fill incomplete LU (``Ifpack2Preconditioners.hpp:148`` RILUK(0)):
    factored on the host (C++, :mod:`.hostops`) on the eliminated CSR's own
    sparsity; the two triangular solves run level-scheduled on the device;
    ``lag`` reuses the factors across up to ``lag`` reassemblies."""

    overlap: int = 1
    lag: int = 0

    def setup(self, system):
        apply, pc = self.setup_parts(system)
        return lambda r: apply(r, *pc)

    def setup_parts(self, system):
        if _is_distributed(system):
            # additive Schwarz with per-shard ILU(0) local solves
            dtype = system.dtype
            csrs, n = _schwarz_csrs(system, "ILU0", self.overlap)

            def build(csrs, device):
                facs = [(tri.ilu0_factor(dd, ii, pp, n), ii, pp) for dd, ii, pp in csrs]
                fwd, cf = tri.build_tri_solve_stacked(facs, n, True, True, dtype, device)
                bwd, cb = tri.build_tri_solve_stacked(facs, n, False, False, dtype, device)
                nf = len(cf)

                def local(r, *cs):
                    return bwd(fwd(r, *cs[:nf]), *cs[nf:])

                local.n_levels = fwd.n_levels + bwd.n_levels
                return local, (*cf, *cb)

            return _schwarz_wrap(system, *_per_group(system, csrs, build), self.overlap)
        data, indices, indptr, n = _assembled_csr(system, "ILU0")
        fac = tri.ilu0_factor(_host_f64(data), indices, indptr, n)
        fwd, cf, bwd, cb = _tri_pair(fac, indices, indptr, n, data.dtype, data.device, True)
        nf = len(cf)

        def apply(r, *cs):
            return bwd(fwd(r, *cs[:nf]), *cs[nf:])

        apply.n_levels, apply.launches = fwd.n_levels + bwd.n_levels, fwd.launches + bwd.launches
        return apply, (*cf, *cb)


@dataclass(frozen=True)
class ILUT:
    """Threshold incomplete LU (``Ifpack2Preconditioners.hpp:174``): SciPy's
    SuperLU incomplete factorization (``spilu``, drop tolerance and fill cap)
    on the host; the permuted triangular solves run level-scheduled on the
    device like :class:`ILU0`.  Nonsymmetric: use it under GMRES."""

    drop_tol: float = 1e-4
    fill_factor: float = 10.0
    overlap: int = 1
    lag: int = 0

    def setup(self, system):
        apply, pc = self.setup_parts(system)
        return lambda r: apply(r, *pc)

    def _setup_parts_distributed(self, system):
        """Per-shard local ILUT (SciPy ``spilu`` on each Schwarz block)."""
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        dtype = system.dtype
        csrs, n = _schwarz_csrs(system, "ILUT", self.overlap)
        drop_tol, fill_factor = self.drop_tol, self.fill_factor

        def build(csrs, device):
            Ls, Us, prs, pcs = [], [], [], []
            for dd, ii, pp in csrs:
                ilu = spla.spilu(sp.csr_matrix((dd, ii, pp), shape=(n, n)).tocsc(),
                                 drop_tol=drop_tol, fill_factor=fill_factor)
                L, U = ilu.L.tocsr(), ilu.U.tocsr()
                Ls.append((L.data, L.indices, L.indptr))
                Us.append((U.data, U.indices, U.indptr))
                prs.append(np.asarray(ilu.perm_r, dtype=np.int64))
                pcs.append(np.asarray(ilu.perm_c, dtype=np.int64))
            fwd, cf = tri.build_tri_solve_stacked(Ls, n, True, True, dtype, device)
            bwd, cb = tri.build_tri_solve_stacked(Us, n, False, False, dtype, device)
            nf = len(cf)
            rows = torch.arange(len(csrs), device=device)[:, None]

            def local(r, pr, pc_, *cs):
                t = torch.zeros_like(r)
                t[rows, pr] = r
                return bwd(fwd(t, *cs[:nf]), *cs[nf:])[rows, pc_]

            local.n_levels = fwd.n_levels + bwd.n_levels
            pr, pc_ = (torch.as_tensor(np.stack(a), device=device) for a in (prs, pcs))
            return local, (pr, pc_, *cf, *cb)

        return _schwarz_wrap(system, *_per_group(system, csrs, build), self.overlap)

    def setup_parts(self, system):
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        if _is_distributed(system):
            return self._setup_parts_distributed(system)
        data, indices, indptr, n = _assembled_csr(system, "ILUT")
        A = sp.csr_matrix((_host_f64(data), np.asarray(indices), np.asarray(indptr)), shape=(n, n)).tocsc()
        ilu = spla.spilu(A, drop_tol=self.drop_tol, fill_factor=self.fill_factor)
        L, U = ilu.L.tocsr(), ilu.U.tocsr()
        dt, dev = data.dtype, data.device
        # Pr A Pc = L U  =>  M^-1 b = Pc U^-1 L^-1 Pr b
        fwd, cf = tri.build_tri_solve(L.data, L.indices, L.indptr, n, True, True, dt, dev)
        bwd, cb = tri.build_tri_solve(U.data, U.indices, U.indptr, n, False, False, dt, dev)
        nf = len(cf)

        def apply(r, pr, pc_, *cs):
            # SuperLU's convention: t[perm_r] = b; y = U^-1 L^-1 t; x = y[perm_c]
            t = torch.zeros_like(r)
            t[pr] = r
            return bwd(fwd(t, *cs[:nf]), *cs[nf:])[pc_]

        apply.n_levels, apply.launches = fwd.n_levels + bwd.n_levels, fwd.launches + bwd.launches + 3
        pr = torch.as_tensor(np.asarray(ilu.perm_r, dtype=np.int64), device=dev)
        pc_ = torch.as_tensor(np.asarray(ilu.perm_c, dtype=np.int64), device=dev)
        return apply, (pr, pc_, *cf, *cb)
