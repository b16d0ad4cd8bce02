"""Structured-lattice element access (PyTorch port of ``l3ster_tpu.ops.lattice``).

When a mesh block is a structured tensor-product lattice (every generated
Cube/Square mesh after ``lattice_renumber``), the matrix-free apply runs as
global banded sweeps on the lattice tensor (``ops/lattice_sumfact.py``) and
a boundary bucket covering one full side of the block becomes one lattice
plane.  The host-side numpy checks here decide whether that holds; the
slicing gathers then read a lattice block's element values without a node
gather: ``Tensor.unfold`` cuts the windows along each axis, and the exact
transposes overlap-add them back.

Window structure along one axis of length n1 = ne*p + 1 (ne elements of
order p sharing endpoints): window e = [e*p, e*p + p].
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "detect_lattice_plan",
    "detect_face_plan",
    "lattice_gather",
    "lattice_scatter_add",
    "face_gather",
    "face_scatter_pad",
    "face_gather_tensor",
    "face_scatter_tensor_add",
]


def detect_lattice_plan(row_idx: np.ndarray, n_rows: int, order: int, dim: int):
    """(n1, ne, eidx, inv_eidx) if row_idx is a full tensor-product lattice.

    row_idx (E, n_nodes) node-row ids with local node = i + n*j [+ n^2*k],
    x fastest.  ``eidx`` maps block element -> canonical (x-fastest) element
    index (None when they coincide); verified exactly against a predicted
    index array, otherwise None.
    """
    E, n_nodes = row_idx.shape
    n = order + 1
    p = order
    if n_nodes != n**dim or E == 0:
        return None
    row_idx = row_idx.astype(np.int64)
    base = row_idx[:, 0]
    if n > 1 and int(row_idx[0, 1]) - int(base[0]) != 1:
        return None
    n1x = int(row_idx[0, n]) - int(base[0])
    if n1x <= 0:
        return None
    if dim == 3:
        sz = int(row_idx[0, n * n]) - int(base[0])
        if sz <= 0 or sz % n1x or n_rows % sz:
            return None
        n1 = (n1x, sz // n1x, n_rows // sz)
    else:
        if n_rows % n1x:
            return None
        n1 = (n1x, n_rows // n1x)
    ne = tuple((a - 1) // p if (a - 1) % p == 0 and a > 1 else -1 for a in n1)
    if any(a < 1 for a in ne) or int(np.prod(ne)) != E:
        return None
    # element grid coordinates from the window origins
    ix = base % n1[0]
    rest = base // n1[0]
    iy = rest % n1[1] if dim == 3 else rest
    iz = rest // n1[1] if dim == 3 else np.zeros_like(base)
    if ((ix % p) != 0).any() or ((iy % p) != 0).any() or ((iz % p) != 0).any():
        return None
    ex, ey, ez = ix // p, iy // p, iz // p
    if (ex >= ne[0]).any() or (ey >= ne[1]).any() or (dim == 3 and (ez >= ne[2]).any()):
        return None
    eidx = ex + ne[0] * (ey + (ne[1] * ez if dim == 3 else 0))  # canonical x-fastest
    if len(np.unique(eidx)) != E:
        return None
    # exact verification: base + in-window offsets must reproduce row_idx
    i_ = np.arange(n)
    if dim == 2:
        offs = (i_[None, :] + n1[0] * i_[:, None]).reshape(-1)  # (n*n,) node lex order
    else:
        offs = (
            i_[None, None, :] + n1[0] * i_[None, :, None] + n1[0] * n1[1] * i_[:, None, None]
        ).reshape(-1)
    if not np.array_equal(base[:, None] + offs[None, :], row_idx):
        return None
    if np.array_equal(eidx, np.arange(E)):
        return n1, ne, None, None
    inv = np.empty(E, dtype=np.int64)
    inv[eidx] = np.arange(E)
    return n1, ne, eidx.astype(np.int32), inv.astype(np.int32)


def detect_face_plan(vol_plan, order: int, dim: int, side: int, elem_sel, ns, n_nodes: int):
    """Slicing plan for a boundary bucket that covers one FULL side of a
    lattice block, restricted to the side's surface nodes.

    With lattice node numbering the side's surface nodes are one lattice
    plane (a (dim-1)-lattice), so the per-element boundary gather/scatter —
    the dominant cost of boundary contributions on TPU (per-row overhead) —
    becomes a static plane slice + (dim-1)D window extraction.

    Returns dict(axis, hi, n1, plan2d) or None when the bucket is not a full
    canonical side (fallback to the gather path).
    """
    n1, ne, eidx, _ = vol_plan
    p = order
    n = p + 1
    axis, hi = side // 2, side % 2
    # ns must be exactly the side's surface nodes, ascending local ids
    lat = np.arange(n_nodes)
    if dim == 3:
        coords = (lat % n, (lat // n) % n, lat // (n * n))
    else:
        coords = (lat % n, lat // n)
    pred = np.nonzero(coords[axis] == (p if hi else 0))[0]
    if ns is None or not np.array_equal(np.asarray(ns), pred):
        return None
    sel = np.asarray(elem_sel, dtype=np.int64)
    can = np.asarray(eidx)[sel] if eidx is not None else sel
    ex = can % ne[0]
    rest = can // ne[0]
    ecoords = (ex, rest % ne[1], rest // ne[1]) if dim == 3 else (ex, rest)
    if not (ecoords[axis] == (ne[axis] - 1 if hi else 0)).all():
        return None
    rem = [a for a in range(dim) if a != axis]
    ne2 = tuple(int(ne[a]) for a in rem)
    n12 = tuple(int(n1[a]) for a in rem)
    E = len(sel)
    if E != int(np.prod(ne2)):
        return None
    fcan = ecoords[rem[0]] + (ne2[0] * ecoords[rem[1]] if dim == 3 else 0)
    if len(np.unique(fcan)) != E:
        return None
    if np.array_equal(fcan, np.arange(E)):
        feidx = finv = None
    else:
        feidx = fcan.astype(np.int32)
        finv = np.empty(E, dtype=np.int64)
        finv[fcan] = np.arange(E)
        finv = finv.astype(np.int32)
    return dict(
        axis=axis,
        hi=bool(hi),
        n1=tuple(int(a) for a in n1),
        plan2d=(n12, ne2, feidx, finv),
    )


def _unwindow0(w: torch.Tensor, ne: int, p: int) -> torch.Tensor:
    """Axis-0 overlap-add, exact transpose of :func:`_window0`: windows share
    endpoints, so the closing node of window e adds onto the opening node of
    window e+1.  w (ne, p+1, ...) -> t (ne*p+1, ...)."""
    out = w.new_zeros((ne * p + 1,) + tuple(w.shape[2:]))
    out[: ne * p].view((ne, p) + tuple(w.shape[2:])).add_(w[:, :p])
    out[p::p].add_(w[:, p])
    return out


def _tensor_of(x: torch.Tensor, n1: tuple) -> torch.Tensor:
    """(n_rows, c) lattice rows as the (n1_d, ..., n1_x, c) tensor view."""
    return x.reshape(tuple(reversed(n1)) + (x.shape[-1],))


def lattice_gather(x: torch.Tensor, plan, order: int) -> torch.Tensor:
    """x (n_rows, c) -> x_loc (E, n_nodes, c) by slicing (no node gather).

    Canonical element order is x-fastest; a non-canonical block element
    order costs one gather of whole element rows (``eidx``)."""
    n1, ne, eidx, _ = plan
    p, n = order, order + 1
    c = x.shape[-1]
    dim = len(n1)
    t = _tensor_of(x, n1)
    # unfold each lattice axis into (elements, ..., window): the windows of
    # the axes land last, in the order unfolded (z, y, x)
    for a in range(dim):
        t = t.unfold(a, n, p)
    # (ne_d, ..., ne_x, c, n_d, ..., n_x) -> (ne_d, ..., ne_x, n_d, ..., n_x, c)
    t = torch.movedim(t, dim, -1)
    out = t.reshape(int(np.prod(ne)), n**dim, c)
    return out if eidx is None else out[torch.as_tensor(eidx, dtype=torch.int64, device=x.device)]


def lattice_scatter_add(y_loc: torch.Tensor, plan, order: int) -> torch.Tensor:
    """Exact transpose of :func:`lattice_gather`: (E, n_nodes, c) -> (n_rows, c)."""
    n1, ne, _, inv_eidx = plan
    p, n = order, order + 1
    c = y_loc.shape[-1]
    dim = len(n1)
    if inv_eidx is not None:
        y_loc = y_loc[torch.as_tensor(inv_eidx, dtype=torch.int64, device=y_loc.device)]
    # (ne_d, ..., ne_x, n_d, ..., n_x, c) -> (ne_d, n_d, ..., ne_x, n_x, c)
    t = y_loc.reshape(tuple(reversed(ne)) + (n,) * dim + (c,))
    t = t.permute([i for a in range(dim) for i in (a, dim + a)] + [2 * dim])
    # overlap-add x first, then y (then z), as the reference does
    for a in reversed(range(dim)):
        t = torch.movedim(t, (2 * a, 2 * a + 1), (0, 1))
        t = torch.movedim(_unwindow0(t, ne[dim - 1 - a], p), 0, 2 * a)
    return t.reshape(-1, c)


def _face_pos(fp: dict) -> tuple[int, int]:
    """(position of the face's axis in the (c, n1_d, ..., n1_x) layout, plane index)."""
    n1, axis = fp["n1"], fp["axis"]
    pos = 1 + (len(n1) - 1 - axis)
    return pos, int(fp.get("plane", n1[axis] - 1 if fp["hi"] else 0))


def face_gather_tensor(t: torch.Tensor, fp: dict, order: int) -> torch.Tensor:
    """Element values of a full-side boundary bucket from the channel-leading
    lattice tensor t (c, n1_d, ..., n1_x): one plane slice, then the
    (dim-1)D window extraction -> (E_face, n_surface_nodes, c).  ``fp["plane"]``
    (when present) names the plane, as the box decomposition's windows do."""
    pos, idx = _face_pos(fp)
    plane = torch.movedim(t.select(pos, idx), 0, -1)
    return lattice_gather(plane.reshape(-1, t.shape[0]), fp["plan2d"], order)


def face_gather(x: torch.Tensor, fp: dict, order: int) -> torch.Tensor:
    """:func:`face_gather_tensor` from (n_rows, c) lattice rows."""
    c = x.shape[-1]
    return face_gather_tensor(x.T.reshape((c,) + tuple(reversed(fp["n1"]))), fp, order)


def _face_plane(y_loc: torch.Tensor, fp: dict, order: int) -> torch.Tensor:
    """The (dim-1)D overlap-add of a face's element values as the
    channel-leading plane (c, ...)."""
    plane = lattice_scatter_add(y_loc, fp["plan2d"], order)
    return torch.movedim(plane.reshape(tuple(reversed(fp["plan2d"][0])) + (y_loc.shape[-1],)), -1, 0)


def face_scatter_tensor_add(y_loc: torch.Tensor, fp: dict, order: int, acc: torch.Tensor) -> torch.Tensor:
    """Exact transpose of :func:`face_gather_tensor`, added in place into the
    channel-leading lattice tensor ``acc`` (c, n1_d, ..., n1_x), which is
    returned: the face touches only its plane."""
    pos, idx = _face_pos(fp)
    acc.select(pos, idx).add_(_face_plane(y_loc, fp, order))
    return acc


def face_scatter_pad(y_loc: torch.Tensor, fp: dict, order: int) -> torch.Tensor:
    """Exact transpose of :func:`face_gather`, padded back to (n_rows, c)."""
    c = y_loc.shape[-1]
    full = y_loc.new_zeros((c,) + tuple(reversed(fp["n1"])))
    return face_scatter_tensor_add(y_loc, fp, order, full).reshape(c, -1).T
