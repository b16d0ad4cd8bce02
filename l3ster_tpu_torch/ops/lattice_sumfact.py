"""Global banded sum-factorization on structured node lattices (PyTorch port
of ``l3ster_tpu.ops.lattice_sumfact``).

When the mesh block is a structured lattice (``ops/lattice.py``), the
nodes->QP interpolation of ALL elements along one axis is a single
block-banded matrix

    Ng (ne*q1, n1),   Ng[e*q1 + q, e*p + i] = N1[q, i]

applied to the GLOBAL lattice tensor.  QP space comes out in interleaved
order (ez qz, ey qy, ex qx); the per-QP geometry tensors are pre-permuted to
match.  The pipelines of the reference (:func:`lattice_variant`):

* ``"v2"`` (3D default): x and y stages as plain ``torch.einsum``
  contractions, then the fused z-sweep (``ops/zsweep.py``: the CUDA kernel
  on the card, its plain version on the CPU) on (c, n1z, RQ) tensors, with
  constant or variable A;
* ``"v1"`` (``L3STER_TPU_ZSWEEP=v1``): the y stages write (n1z, c, RQ)
  tensors for the v1 z-sweep (``ops/zsweep_v1.py``), full geometry and
  constant A only;
* ``"xy"`` (``L3STER_TPU_XY_PALLAS=1``): every x/y stage is the stage kernel
  (``ops/stages.py``), with the z-sweep's lanes in (Q, R) order; constant A;
* ``"chain"`` (always in 2D; in 3D under ``L3STER_TPU_FUSED_Z=0``): the
  non-fused chain: every sweep as plain contractions (:func:`lattice_interp`,
  :func:`lattice_transpose`) around the per-QP algebra on whole QP-space
  tensors, plain torch;
* ``"chain_qp"`` (the chain under ``L3STER_TPU_LATTICE_PALLAS_QP=1``): the
  chain with a constant A's per-QP algebra as the per-QP kernel
  (``ops/qp.py``) on the (d1*c, EQ) row stack; a variable A keeps the plain
  chain.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

from . import zsweep_v1
from .qp import qp_algebra_const_lattice
from .stages import device_table, kstacked_matmul
from .zsweep import fused_z_sweep, zsweep_tables

__all__ = [
    "banded_tables",
    "lattice_qp_perm",
    "lattice_variant",
    "lattice_interp",
    "lattice_transpose",
    "local_apply_lattice",
    "pack_face_banded",
    "face_apply_banded",
]

_CHAINS = ("chain", "chain_qp")


def lattice_variant(dim: int) -> str:
    """The lattice pipeline the environment selects for a ``dim``-D lattice,
    under the reference's switches and defaults.  In 2D, or in 3D when
    ``L3STER_TPU_FUSED_Z`` is 0 or false, the non-fused chain: "chain_qp"
    when ``L3STER_TPU_LATTICE_PALLAS_QP`` is 1 or true, else "chain".
    Otherwise "xy" when ``L3STER_TPU_XY_PALLAS`` is 1 or true, else "v1" when
    ``L3STER_TPU_ZSWEEP`` is v1, else "v2".  The x/y pipeline and v1 take
    constant A only; a variable A runs "v2" in their place."""
    if dim != 3 or os.environ.get("L3STER_TPU_FUSED_Z", "1") in ("0", "false"):
        return "chain_qp" if os.environ.get("L3STER_TPU_LATTICE_PALLAS_QP", "0") in ("1", "true") else "chain"
    if os.environ.get("L3STER_TPU_XY_PALLAS", "0") in ("1", "true"):
        return "xy"
    if os.environ.get("L3STER_TPU_ZSWEEP", "v2") == "v1":
        return "v1"
    return "v2"


@lru_cache(maxsize=None)
def banded_tables(order: int, q_order: int, ne: int) -> tuple[np.ndarray, np.ndarray]:
    """(Ng, Dg) block-banded global 1D tables, each (ne*q1, ne*order + 1)."""
    from .sumfact import sumfact_tables_1d

    N1, D1, _ = sumfact_tables_1d(order, q_order)
    q1, n = N1.shape
    Ng = np.zeros((ne * q1, ne * order + 1))
    Dg = np.zeros_like(Ng)
    for e in range(ne):
        Ng[e * q1 : (e + 1) * q1, e * order : e * order + n] = N1
        Dg[e * q1 : (e + 1) * q1, e * order : e * order + n] = D1
    return Ng, Dg


def lattice_qp_perm(ne: tuple, q1: int, eidx_inv=None) -> np.ndarray:
    """perm (E*Q,): interleaved QP linear index -> block E-major index.

    Use as ``arr_interleaved = arr_emajor[..., perm]``.  E-major index is
    ``e * Q + (qx + q1*qy [+ q1^2*qz])`` with canonical element order
    ``e = ex + nex*(ey [+ ney*ez])``; ``eidx_inv`` maps canonical element
    index -> block element index for non-canonical block orders.
    """
    dim = len(ne)
    Q = q1**dim
    if dim == 2:
        ex, qx = np.meshgrid(np.arange(ne[0]), np.arange(q1), indexing="ij")
        Qxn = (ex * q1 + qx).reshape(-1)
        ey, qy = np.meshgrid(np.arange(ne[1]), np.arange(q1), indexing="ij")
        Ryn = (ey * q1 + qy).reshape(-1)
        Ry = Ryn[:, None]
        Qx = Qxn[None, :]
        e = (Qx // q1) + ne[0] * (Ry // q1)
        q = (Qx % q1) + q1 * (Ry % q1)
    else:
        r = np.arange(ne[0] * q1)
        s = np.arange(ne[1] * q1)
        t = np.arange(ne[2] * q1)
        Qx = r[None, None, :]
        Ry = s[None, :, None]
        Sz = t[:, None, None]
        e = (Qx // q1) + ne[0] * ((Ry // q1) + ne[1] * (Sz // q1))
        q = (Qx % q1) + q1 * ((Ry % q1) + q1 * (Sz % q1))
    if eidx_inv is not None:
        e = np.asarray(eidx_inv)[e]
    return (e * Q + q).reshape(-1).astype(np.int64)


@lru_cache(maxsize=None)
def _tabs(order: int, q_order: int, ne: tuple, dtype, device):
    """Per axis (NgT (n1, Qa), DgT) on the device, cached: the tables depend
    only on (order, q_order, ne), so each apply reuses one device copy."""
    out = []
    for ne_a in ne:
        Ng, Dg = banded_tables(order, q_order, ne_a)
        out.append(
            (
                torch.as_tensor(Ng.T, dtype=dtype, device=device),
                torch.as_tensor(Dg.T, dtype=dtype, device=device),
            )
        )
    return tuple(out)


@lru_cache(maxsize=None)
def _ztabs(order: int, q_order: int, ne_z: int, dtype, device):
    Ng, Dg = banded_tables(order, q_order, ne_z)
    return zsweep_tables(Ng.T, Dg.T, dtype, device)


def lattice_interp(t: torch.Tensor, tabs):
    """Global lattice tensor (c, n1_d, ..., n1_x) -> vals and per-axis
    reference derivatives, each (c, Q_d, ..., Q_x) in interleaved QP order;
    ``tabs`` holds (NgT, DgT) per axis, x first."""
    if len(tabs) == 2:
        (NxT, DxT), (NyT, DyT) = tabs
        ax = torch.einsum("cyx,xQ->cyQ", t, NxT)
        adx = torch.einsum("cyx,xQ->cyQ", t, DxT)
        v = torch.einsum("cyQ,yR->cRQ", ax, NyT)
        dy = torch.einsum("cyQ,yR->cRQ", ax, DyT)
        dx = torch.einsum("cyQ,yR->cRQ", adx, NyT)
        return v, (dx, dy)
    (NxT, DxT), (NyT, DyT), (NzT, DzT) = tabs
    ax = torch.einsum("czyx,xQ->czyQ", t, NxT)
    adx = torch.einsum("czyx,xQ->czyQ", t, DxT)
    b = torch.einsum("czyQ,yR->czRQ", ax, NyT)
    bdy = torch.einsum("czyQ,yR->czRQ", ax, DyT)
    bdx = torch.einsum("czyQ,yR->czRQ", adx, NyT)
    v = torch.einsum("czRQ,zS->cSRQ", b, NzT)
    dz = torch.einsum("czRQ,zS->cSRQ", b, DzT)
    dy = torch.einsum("czRQ,zS->cSRQ", bdy, NzT)
    dx = torch.einsum("czRQ,zS->cSRQ", bdx, NzT)
    return v, (dx, dy, dz)


def lattice_transpose(t0: torch.Tensor, td, tabs) -> torch.Tensor:
    """Exact transpose of :func:`lattice_interp`: the interleaved QP tensors
    (t0 the values part, td the per-axis derivative parts) ->
    (c, n1_d, ..., n1_x)."""
    if len(tabs) == 2:
        (NxT, DxT), (NyT, DyT) = tabs
        a = torch.einsum("cRQ,yR->cyQ", t0, NyT) + torch.einsum("cRQ,yR->cyQ", td[1], DyT)
        adx = torch.einsum("cRQ,yR->cyQ", td[0], NyT)
        return torch.einsum("cyQ,xQ->cyx", a, NxT) + torch.einsum("cyQ,xQ->cyx", adx, DxT)
    (NxT, DxT), (NyT, DyT), (NzT, DzT) = tabs
    b = torch.einsum("cSRQ,zS->czRQ", t0, NzT) + torch.einsum("cSRQ,zS->czRQ", td[2], DzT)
    bdy = torch.einsum("cSRQ,zS->czRQ", td[1], NzT)
    bdx = torch.einsum("cSRQ,zS->czRQ", td[0], NzT)
    a = torch.einsum("czRQ,yR->czyQ", b, NyT) + torch.einsum("czRQ,yR->czyQ", bdy, DyT)
    adx = torch.einsum("czRQ,yR->czyQ", bdx, NyT)
    return torch.einsum("czyQ,xQ->czyx", a, NxT) + torch.einsum("czyQ,xQ->czyx", adx, DxT)


def _apply_chain(A_const, Ji_l, w_l, var, t, tabs, qsh: tuple, qp_kernel: bool):
    """The non-fused chain (the reference's branch for 2D and for 3D without
    the fused z-sweep): interpolate to the QPs, run the per-QP algebra on the
    whole interleaved QP space, transpose back.  With ``qp_kernel`` a
    constant A's algebra runs as the per-QP kernel on the row stack
    [v; d_x; d_y(; d_z)] of shape (d1*c, EQ), rows d*c+u."""
    from ..algsys.local import _qp_algebra_const, _qp_algebra_nz

    dim, c, EQ = len(tabs), t.shape[0], w_l.shape[0]
    v, ders = lattice_interp(t, tabs)
    if qp_kernel and A_const is not None:
        g = torch.cat([v.reshape(c, EQ)] + [d.reshape(c, EQ) for d in ders])
        tt = qp_algebra_const_lattice(A_const, g, Ji_l.reshape(dim * dim, EQ), w_l)
        t0s = tt[:c].reshape((c,) + qsh)
        tds = [tt[(1 + j) * c : (2 + j) * c].reshape((c,) + qsh) for j in range(dim)]
        return lattice_transpose(t0s, tds, tabs)
    vals_l = [v[u].reshape(EQ) for u in range(c)]
    rd = [[d[u].reshape(EQ) for u in range(c)] for d in ders]
    if A_const is not None:
        t0, tr = _qp_algebra_const(np.asarray(A_const), Ji_l, w_l, vals_l, rd, dim, c, t.dtype)
    else:
        nz_idx, A_nz, n_eq = var
        t0, tr = _qp_algebra_nz(nz_idx, A_nz, n_eq, Ji_l, w_l, vals_l, rd, dim, c)
    t0s = torch.stack([ti.reshape(qsh) for ti in t0])
    tds = [torch.stack([tj.reshape(qsh) for tj in tr[j]]) for j in range(dim)]
    return lattice_transpose(t0s, tds, tabs)


def pack_face_banded(A, w, fp: dict, order: int, q_order: int):
    """Pack a value-only boundary contribution for the banded face apply.

    A (E, Q, 1, n_eq, c) and w (E, Q) are numpy tensors in BLOCK element
    order (node-restricted to the side's surface nodes); returns
    (A_l (n_eq, c, EQ), w_l (EQ,)) in interleaved face-QP order matching the
    global banded 2D interpolation of the face lattice plane.  Returns None
    when the contribution is not value-only."""
    A = np.asarray(A)
    w = np.asarray(w)
    if A.ndim != 5 or A.shape[2] != 1:
        return None
    E, Q, _, n_eq, c = A.shape
    q1 = q_order // 2 + 1
    ne2 = fp["plan2d"][1]
    if len(ne2) != 2 or Q != q1 ** len(ne2) or E != int(np.prod(ne2)):
        return None
    finv = fp["plan2d"][3]
    perm = lattice_qp_perm(tuple(ne2), q1, eidx_inv=finv)
    A_l = A.reshape(E * Q, n_eq, c)[perm].transpose(1, 2, 0)
    w_l = w.reshape(E * Q)[perm]
    return A_l, w_l


def face_apply_banded(
    A_l: torch.Tensor,  # (n_eq, c, EQ) interleaved face-QP order
    w_l: torch.Tensor,  # (EQ,)
    fp: dict,
    order: int,
    q_order: int,
    plane: torch.Tensor,  # (c,) + reversed(n12) channel-leading face plane
) -> torch.Tensor:
    """Value-only boundary contribution on a full lattice side as ONE global
    banded 2D sweep over the face plane (c, n1_b, n1_a) -> same shape."""
    ne2 = tuple(fp["plan2d"][1])
    c = plane.shape[0]
    (NaT, _), (NbT, _) = _tabs(order, q_order, ne2, plane.dtype, plane.device)
    a = torch.einsum("cyx,xQ->cyQ", plane, NaT)
    v = torch.einsum("cyQ,yR->cRQ", a, NbT)
    R, Q = v.shape[1], v.shape[2]
    vf = v.reshape(c, R * Q)
    r = torch.einsum("icq,cq->iq", A_l, vf) * w_l[None, :]
    tt = torch.einsum("icq,iq->cq", A_l, r).reshape(c, R, Q)
    b = torch.einsum("cRQ,yR->cyQ", tt, NbT)
    return torch.einsum("cyQ,xQ->cyx", b, NaT)


def _permute_geom_qr(geom_t, R: int, Q: int):
    """The packed geometry's lane plane from R-major (RQ) to Q-major (QR) order.
    The z-sweep's lane axis is opaque, so QR-ordered inputs with QR-ordered
    geometry give the same result, and the y-stage matmuls write QR order."""

    def p2(v):  # (..., R*Q) -> (..., Q*R)
        sh = v.shape[:-1]
        return v.reshape(sh + (R, Q)).transpose(-1, -2).reshape(sh + (Q * R,))

    if geom_t[0] == "diag":
        _, jx, jy, jz, wyx, wz = geom_t
        return ("diag", p2(jx), p2(jy), jz, p2(wyx), wz)
    _, ji, w = geom_t
    return ("full", p2(ji), p2(w))


def _apply_xy(A_const, t, geom_t, order: int, q_order: int, ne: tuple, ztabs):
    """Constant-coefficient 3D volume apply with every x/y stage as the stage
    kernel (``ops/stages.py``) around the fused z-sweep; the reference's
    ``_apply_xy_pallas``.  t is the (c, n1z, n1y, n1x) lattice tensor; returns
    the same layout."""
    c, n1z, n1y, n1x = t.shape
    q1 = q_order // 2 + 1
    R, Q = q1 * ne[1], q1 * ne[0]
    czy, czQ = c * n1z * n1y, c * n1z * Q

    def stage(x, x2, ne_a, kind, N):  # with the table and its band, cached per (axis, kind)
        T, band = device_table(order, q_order, ne_a, kind, t.dtype, t.device)
        return kstacked_matmul(x, x2, T, N, band)

    # x interpolation: one [N|D]-paired stage
    axd = stage(t.reshape(czy, n1x), None, ne[0], "ND", 2 * Q)
    ax = axd[:, :Q].reshape(c, n1z, n1y, Q)
    adx = axd[:, Q:].reshape(c, n1z, n1y, Q)
    # y interpolation on (c, z, Q) rows: the outputs come in QR lane order
    axT = ax.transpose(2, 3).reshape(czQ, n1y)
    adxT = adx.transpose(2, 3).reshape(czQ, n1y)
    bqd = stage(axT, None, ne[1], "ND", 2 * R)
    bdxq = stage(adxT, None, ne[1], "N", R)
    b = bqd[:, :R].reshape(c, n1z, Q * R)
    bdy = bqd[:, R:].reshape(c, n1z, Q * R)
    bdx = bdxq.reshape(c, n1z, Q * R)
    a, ady, adxz = fused_z_sweep(A_const, b, bdy, bdx, _permute_geom_qr(geom_t, R, Q), ztabs)
    # y transpose: rows are already (c, z, Q); the K-concat pair for a
    a2q = stage(a.reshape(czQ, R), ady.reshape(czQ, R), ne[1], "NDT", n1y)
    adx2q = stage(adxz.reshape(czQ, R), None, ne[1], "NT", n1y)
    # x transpose on (c, z, y) rows
    a2 = a2q.reshape(c, n1z, Q, n1y).transpose(2, 3).reshape(czy, Q)
    adx2 = adx2q.reshape(c, n1z, Q, n1y).transpose(2, 3).reshape(czy, Q)
    y = stage(a2, adx2, ne[0], "NDT", n1x)
    return y.reshape(c, n1z, n1y, n1x)


def local_apply_lattice(
    A_const,  # (4, n_eq, c) numpy constant coefficients, or None with var
    Ji_l: torch.Tensor | None,  # (3, 3, EQ) interleaved order (None with geom)
    w_l: torch.Tensor | None,  # (EQ,) interleaved order (None with geom)
    order: int,
    q_order: int,
    n1: tuple,
    ne: tuple,
    x: torch.Tensor,  # (n_rows, c) global lattice node rows
    geom: tuple | None = None,  # ("diag", jx, jy, jz, wyx, wz) factorized geometry
    tensor_io: bool = False,  # x IS the channel-leading tensor; return same
    var: tuple | None = None,  # (nz_idx, A_nz (K, EQ), n_eq) variable coefficients
    variant: str = "v2",  # "v2", "v1", "xy", "chain" or "chain_qp": see the module docstring
) -> torch.Tensor:
    """Local apply on the global lattice; (n_rows, c).

    In 3D by the pipeline ``variant`` names: x/y interpolation, the fused
    z-sweep (``ops/zsweep.py``), then the y/x transposes, or the non-fused
    chain; a variable A (``var``) takes "v2" in place of "v1" and "xy".  2D
    always runs the chain (``variant`` "chain_qp" or else "chain").  With
    ``tensor_io`` the caller owns the (c, n1_d, ..., n1_x) layout: x is the
    channel-leading lattice tensor and the result is returned in the same
    layout."""
    dim = len(n1)
    if dim not in (2, 3) or (A_const is None) == (var is None):
        raise ValueError("the lattice apply takes a 2D or 3D kernel with either a constant A or var")
    c = x.shape[0] if tensor_io else x.shape[-1]
    q1 = q_order // 2 + 1
    tabs = _tabs(order, q_order, tuple(ne), x.dtype, x.device)
    t = x if tensor_io else x.T.reshape((c,) + tuple(reversed(n1)))
    qsh = tuple(q1 * n for n in reversed(ne))
    if dim == 2 or variant in _CHAINS:
        if geom is not None:
            raise ValueError("the non-fused lattice chain has no factorized-geometry path")
        y = _apply_chain(A_const, Ji_l, w_l, var, t, tabs, qsh, variant == "chain_qp")
        return y if tensor_io else y.reshape(c, -1).T.reshape(x.shape)
    (NxT, DxT), (NyT, DyT), _ = tabs
    ztabs = _ztabs(order, q_order, ne[2], x.dtype, x.device)
    S, R, Q = qsh
    n1z = t.shape[1]
    geom_t = geom if geom is not None else ("full", Ji_l.reshape(9, S, R * Q), w_l.reshape(S, R * Q))
    if var is not None:
        variant = "v2"
    if variant == "xy":
        y = _apply_xy(A_const, t, geom_t, order, q_order, tuple(ne), ztabs)
        return y if tensor_io else y.reshape(c, -1).T.reshape(x.shape)
    ax = torch.einsum("czyx,xQ->czyQ", t, NxT)
    adx0 = torch.einsum("czyx,xQ->czyQ", t, DxT)
    if variant == "v1":
        if geom is not None:
            raise ValueError("v1 z-sweep has no factorized-geometry path")
        b = torch.einsum("czyQ,yR->zcRQ", ax, NyT).reshape(n1z, c, R * Q)
        bdy = torch.einsum("czyQ,yR->zcRQ", ax, DyT).reshape(n1z, c, R * Q)
        bdx = torch.einsum("czyQ,yR->zcRQ", adx0, NyT).reshape(n1z, c, R * Q)
        a, ady, adx = zsweep_v1.fused_z_sweep(
            A_const, b, bdy, bdx, geom_t[1], geom_t[2], ztabs.NzT, ztabs.DzT, ztabs
        )
        a = a.reshape(n1z, c, R, Q)
        ady = ady.reshape(n1z, c, R, Q)
        adx = adx.reshape(n1z, c, R, Q)
        a2 = torch.einsum("zcRQ,yR->czyQ", a, NyT) + torch.einsum("zcRQ,yR->czyQ", ady, DyT)
        adx2 = torch.einsum("zcRQ,yR->czyQ", adx, NyT)
    elif variant == "v2":
        b = torch.einsum("czyQ,yR->czRQ", ax, NyT).reshape(c, n1z, R * Q)
        bdy = torch.einsum("czyQ,yR->czRQ", ax, DyT).reshape(c, n1z, R * Q)
        bdx = torch.einsum("czyQ,yR->czRQ", adx0, NyT).reshape(c, n1z, R * Q)
        var_t = None
        if var is not None:
            nz_idx, A_nz, n_eq_v = var
            var_t = (nz_idx, A_nz.reshape(-1, S, R * Q), n_eq_v)
        a, ady, adx = fused_z_sweep(A_const, b, bdy, bdx, geom_t, ztabs, var=var_t)
        a = a.reshape(c, n1z, R, Q)
        ady = ady.reshape(c, n1z, R, Q)
        adx = adx.reshape(c, n1z, R, Q)
        a2 = torch.einsum("czRQ,yR->czyQ", a, NyT) + torch.einsum("czRQ,yR->czyQ", ady, DyT)
        adx2 = torch.einsum("czRQ,yR->czyQ", adx, NyT)
    else:
        raise ValueError(f"unknown lattice pipeline {variant!r}")
    y = torch.einsum("czyQ,xQ->czyx", a2, NxT) + torch.einsum("czyQ,xQ->czyx", adx2, DxT)
    return y if tensor_io else y.reshape(c, -1).T.reshape(x.shape)
