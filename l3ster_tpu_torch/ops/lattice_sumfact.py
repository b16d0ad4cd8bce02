"""Global banded sum-factorization on structured node lattices (PyTorch port
of ``l3ster_tpu.ops.lattice_sumfact``).

When the mesh block is a structured lattice (``ops/lattice.py``), the
nodes->QP interpolation of ALL elements along one axis is a single
block-banded matrix

    Ng (ne*q1, n1),   Ng[e*q1 + q, e*p + i] = N1[q, i]

applied to the GLOBAL lattice tensor.  QP space comes out in interleaved
order (ez qz, ey qy, ex qx); the per-QP geometry tensors are pre-permuted to
match.  In 3D the z stage with the per-QP algebra is the fused z-sweep
(``ops/zsweep.py``): the CUDA kernel on the card, its plain version on the
CPU.  Around it, one of three pipelines of the reference (:func:`lattice_variant`):

* ``"v2"`` (default): x and y stages as plain ``torch.einsum`` contractions,
  the z-sweep on (c, n1z, RQ) tensors, constant or variable A;
* ``"v1"`` (``L3STER_TPU_ZSWEEP=v1``): the y stages write (n1z, c, RQ)
  tensors for the v1 z-sweep (``ops/zsweep_v1.py``), full geometry and
  constant A only;
* ``"xy"`` (``L3STER_TPU_XY_PALLAS=1``): every x/y stage is the stage kernel
  (``ops/stages.py``), with the z-sweep's lanes in (Q, R) order; constant A.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

from . import zsweep_v1
from .stages import device_table, kstacked_matmul
from .zsweep import fused_z_sweep, zsweep_tables

__all__ = [
    "banded_tables",
    "lattice_qp_perm",
    "lattice_variant",
    "local_apply_lattice",
    "pack_face_banded",
    "face_apply_banded",
]


def lattice_variant() -> str:
    """The lattice pipeline the environment selects, under the reference's
    switches and defaults: "xy" when ``L3STER_TPU_XY_PALLAS`` is 1 or true,
    else "v1" when ``L3STER_TPU_ZSWEEP`` is v1, else "v2".  The x/y pipeline
    and v1 take constant A only; a variable A runs "v2" whatever is set."""
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

    def tab(ne_a, kind):
        return device_table(order, q_order, ne_a, kind, t.dtype, t.device)

    # x interpolation: one [N|D]-paired stage
    axd = kstacked_matmul(t.reshape(czy, n1x), None, tab(ne[0], "ND"), 2 * Q)
    ax = axd[:, :Q].reshape(c, n1z, n1y, Q)
    adx = axd[:, Q:].reshape(c, n1z, n1y, Q)
    # y interpolation on (c, z, Q) rows: the outputs come in QR lane order
    axT = ax.transpose(2, 3).reshape(czQ, n1y)
    adxT = adx.transpose(2, 3).reshape(czQ, n1y)
    bqd = kstacked_matmul(axT, None, tab(ne[1], "ND"), 2 * R)
    bdxq = kstacked_matmul(adxT, None, tab(ne[1], "N"), R)
    b = bqd[:, :R].reshape(c, n1z, Q * R)
    bdy = bqd[:, R:].reshape(c, n1z, Q * R)
    bdx = bdxq.reshape(c, n1z, Q * R)
    a, ady, adxz = fused_z_sweep(A_const, b, bdy, bdx, _permute_geom_qr(geom_t, R, Q), ztabs)
    # y transpose: rows are already (c, z, Q); the K-concat pair for a
    a2q = kstacked_matmul(a.reshape(czQ, R), ady.reshape(czQ, R), tab(ne[1], "NDT"), n1y)
    adx2q = kstacked_matmul(adxz.reshape(czQ, R), None, tab(ne[1], "NT"), n1y)
    # x transpose on (c, z, y) rows
    a2 = a2q.reshape(c, n1z, Q, n1y).transpose(2, 3).reshape(czy, Q)
    adx2 = adx2q.reshape(c, n1z, Q, n1y).transpose(2, 3).reshape(czy, Q)
    y = kstacked_matmul(a2, adx2, tab(ne[0], "NDT"), n1x)
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
    variant: str = "v2",  # "v2", "v1" or "xy": see the module docstring
) -> torch.Tensor:
    """3D local apply on the global lattice; (n_rows, c).

    x/y interpolation, the fused z-sweep (``ops/zsweep.py``), then the y/x
    transposes, by the pipeline ``variant`` names; a variable A (``var``)
    always takes "v2".  With ``tensor_io`` the caller owns the
    (c, n1z, n1y, n1x) layout: x is the channel-leading lattice tensor and
    the result is returned in the same layout."""
    dim = len(n1)
    if dim != 3 or (A_const is None) == (var is None):
        raise NotImplementedError(
            "the port's lattice apply covers 3D kernels with either a constant A or var; "
            "2D is on ROADMAP.md (queue A4)"
        )
    c = x.shape[0] if tensor_io else x.shape[-1]
    q1 = q_order // 2 + 1
    (NxT, DxT), (NyT, DyT), _ = _tabs(order, q_order, tuple(ne), x.dtype, x.device)
    ztabs = _ztabs(order, q_order, ne[2], x.dtype, x.device)
    t = x if tensor_io else x.T.reshape((c,) + tuple(reversed(n1)))
    S, R, Q = (q1 * n for n in reversed(ne))
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
