"""Gmsh .msh import.

Analog of ``mesh/ReadMesh.hpp``: reads MSH format 2.2 and 4.1 files — ASCII
and binary (the reference supports ASCII v4 only, ``mesh/ReadMesh.hpp:191``) —
mapping physical groups to domain ids, renumbering node tags contiguously,
re-ordering Gmsh's corner conventions to the lexicographic local ordering,
and flipping negatively-oriented 2D elements (``mesh/ReadMesh.hpp:24-106``).
Supported element types: 1 (2-node line), 3 (4-node quad), 5 (8-node hex);
anything else raises.  Copied from ``l3ster_tpu.mesh.gmsh``; the orientation
fix is the generators' (``mesh/generators.py:_fix_orientation``).
"""

from __future__ import annotations

import numpy as np

from .core import ElementBlock, Mesh
from .generators import _fix_orientation
from .traits import ElementType

__all__ = ["read_gmsh"]

# gmsh type id -> (ElementType, gmsh->lexicographic corner permutation)
_GMSH_TYPES = {
    1: (ElementType.LINE, np.array([0, 1])),
    3: (ElementType.QUAD, np.array([0, 1, 3, 2])),
    5: (ElementType.HEX, np.array([0, 1, 3, 2, 4, 5, 7, 6])),
}


def read_gmsh(path: str, boundary_ids=(), domain_map=None) -> Mesh:
    """Read a .msh file into an order-1 Mesh.

    boundary_ids: which (physical-group) domain ids are boundaries.
    domain_map: optional {physical_tag: domain_id} remapping.
    """
    with open(path, "rb") as f:
        raw = f.read()

    hdr_at = raw.find(b"$MeshFormat")
    if hdr_at < 0:
        raise ValueError("gmsh file: missing $MeshFormat")
    hdr_end = raw.find(b"\n", hdr_at)
    fmt_end = raw.find(b"\n", hdr_end + 1)
    fmt = raw[hdr_end + 1 : fmt_end].split()
    version = float(fmt[0])
    is_binary = int(fmt[1]) != 0
    data_size = int(fmt[2])

    if is_binary:
        cur = _BinCursor(raw, fmt_end + 1)
        probe = int(cur.read("i4", 1)[0])
        if probe != 1:
            cur.swap()
            cur.pos = fmt_end + 1
            if int(cur.read("i4", 1)[0]) != 1:
                raise ValueError("gmsh binary file: bad endianness probe")
        if version >= 4.0:
            nodes, elements = _parse_v4_binary(cur, data_size)
        elif version >= 2.0:
            nodes, elements = _parse_v2_binary(cur)
        else:
            raise ValueError(f"unsupported .msh version {version}")
        return _build_mesh(nodes, elements, boundary_ids, domain_map)

    lines = [ln.strip() for ln in raw.decode(errors="replace").splitlines()]
    sections: dict[str, list[str]] = {}
    i = 0
    while i < len(lines):
        ln = lines[i]
        if ln.startswith("$") and not ln.startswith("$End"):
            name = ln[1:]
            end = f"$End{name}"
            j = i + 1
            body = []
            while j < len(lines) and lines[j] != end:
                body.append(lines[j])
                j += 1
            if j == len(lines):
                raise ValueError(f"gmsh file: unterminated section {ln}")
            sections[name] = body
            i = j + 1
        else:
            i += 1

    if version >= 4.0:
        nodes, elements = _parse_v4(sections)
    elif version >= 2.0:
        nodes, elements = _parse_v2(sections)
    else:
        raise ValueError(f"unsupported .msh version {version}")

    return _build_mesh(nodes, elements, boundary_ids, domain_map)


# nodes per gmsh element type (needed to advance the cursor through binary
# element records even for types this reader does not build)
_GMSH_NNODES = {
    15: 1, 1: 2, 2: 3, 3: 4, 4: 4, 5: 8, 6: 6, 7: 5,
    8: 3, 9: 6, 10: 9, 11: 10, 12: 27, 13: 18, 14: 14, 16: 8, 17: 20,
}


class _BinCursor:
    """Byte cursor over a binary .msh buffer (little-endian by default)."""

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos
        self.bo = "<"

    def swap(self):
        self.bo = ">"

    def seek_section(self, name: str) -> bool:
        """Position just past the ``$name`` marker line; False if absent."""
        i = self.buf.find(b"$" + name.encode() + b"\n", self.pos)
        if i < 0:
            i = self.buf.find(b"$" + name.encode() + b"\r\n", self.pos)
            if i < 0:
                return False
        self.pos = self.buf.find(b"\n", i) + 1
        return True

    def line(self) -> str:
        j = self.buf.find(b"\n", self.pos)
        s = self.buf[self.pos : j].decode()
        self.pos = j + 1
        return s.strip()

    def read(self, fmt: str, n: int) -> np.ndarray:
        dt = np.dtype(self.bo + fmt)
        arr = np.frombuffer(self.buf, dt, count=int(n), offset=self.pos)
        self.pos += dt.itemsize * int(n)
        return arr


def _parse_v2_binary(cur: _BinCursor):
    """MSH 2.2 binary: 28-byte node records, int element records by type group."""
    if not cur.seek_section("Nodes"):
        raise ValueError("gmsh file: missing $Nodes")
    n_nodes = int(cur.line())
    rec = cur.read("i4, (3,)f8", n_nodes)
    tags = rec["f0"].astype(np.int64)
    coords = rec["f1"].astype(np.float64)

    if not cur.seek_section("Elements"):
        raise ValueError("gmsh file: missing $Elements")
    n_elems = int(cur.line())
    elements = []
    done = 0
    while done < n_elems:
        etype, n_follow, n_tags = (int(v) for v in cur.read("i4", 3))
        nn = _GMSH_NNODES.get(etype)
        if nn is None:
            raise ValueError(f"unsupported gmsh element type {etype} in binary file")
        recs = cur.read("i4", n_follow * (1 + n_tags + nn)).reshape(n_follow, -1)
        for r in recs:
            phys = int(r[1]) if n_tags >= 1 else 0
            elements.append((phys, etype, [int(t) for t in r[1 + n_tags :]]))
        done += n_follow
    return (tags, coords), elements


def _parse_v4_binary(cur: _BinCursor, data_size: int):
    """MSH 4.1 binary: size_t block counts/tags, int entity headers."""
    st = f"i{data_size}"  # size_t as declared in the header (normally i8)
    phys_of = {}
    if cur.seek_section("Entities"):
        counts = cur.read(st, 4)
        for dim, n_ent in enumerate(counts):
            for _ in range(int(n_ent)):
                tag = int(cur.read("i4", 1)[0])
                cur.read("f8", 3 if dim == 0 else 6)  # point xyz / bbox
                n_phys = int(cur.read(st, 1)[0])
                ptags = cur.read("i4", n_phys)
                if n_phys > 1:
                    raise ValueError("entities with multiple physical tags are unsupported")
                if n_phys == 1:
                    phys_of[(dim, tag)] = abs(int(ptags[0]))
                if dim > 0:
                    n_bnd = int(cur.read(st, 1)[0])
                    cur.read("i4", n_bnd)

    if not cur.seek_section("Nodes"):
        raise ValueError("gmsh file: missing $Nodes")
    hdr = cur.read(st, 4)
    n_blocks, n_nodes = int(hdr[0]), int(hdr[1])
    tags = np.empty(n_nodes, dtype=np.int64)
    coords = np.empty((n_nodes, 3))
    out = 0
    for _ in range(n_blocks):
        _bdim, _btag, parametric = (int(v) for v in cur.read("i4", 3))
        nb = int(cur.read(st, 1)[0])
        if parametric:
            raise ValueError("parametric nodes are unsupported")
        tags[out : out + nb] = cur.read(st, nb)
        coords[out : out + nb] = cur.read("f8", 3 * nb).reshape(nb, 3)
        out += nb

    if not cur.seek_section("Elements"):
        raise ValueError("gmsh file: missing $Elements")
    hdr = cur.read(st, 4)
    n_blocks = int(hdr[0])
    elements = []
    for _ in range(n_blocks):
        bdim, btag, etype = (int(v) for v in cur.read("i4", 3))
        nb = int(cur.read(st, 1)[0])
        nn = _GMSH_NNODES.get(etype)
        if nn is None:
            raise ValueError(f"unsupported gmsh element type {etype} in binary file")
        recs = cur.read(st, nb * (1 + nn)).reshape(nb, 1 + nn)
        phys = phys_of.get((bdim, btag))
        if phys is not None:
            for r in recs:
                elements.append((phys, etype, [int(t) for t in r[1:]]))
    return (tags, coords), elements


def _parse_v2(sections):
    node_lines = sections["Nodes"]
    n_nodes = int(node_lines[0])
    tags = np.empty(n_nodes, dtype=np.int64)
    coords = np.empty((n_nodes, 3))
    for i in range(n_nodes):
        parts = node_lines[1 + i].split()
        tags[i] = int(parts[0])
        coords[i] = [float(parts[1]), float(parts[2]), float(parts[3])]

    elem_lines = sections["Elements"]
    n_elems = int(elem_lines[0])
    elements = []  # (domain, gmsh_type, node tags)
    for i in range(n_elems):
        parts = elem_lines[1 + i].split()
        etype = int(parts[1])
        n_tags = int(parts[2])
        phys = int(parts[3]) if n_tags >= 1 else 0
        node_tags = [int(t) for t in parts[3 + n_tags :]]
        elements.append((phys, etype, node_tags))
    return (tags, coords), elements


def _parse_v4(sections):
    # entity (dim, tag) -> physical tag
    phys_of = {}
    if "Entities" in sections:
        ent = sections["Entities"]
        counts = [int(x) for x in ent[0].split()]
        row = 1
        for dim, n_ent in enumerate(counts):
            for _ in range(n_ent):
                parts = ent[row].split()
                row += 1
                tag = int(parts[0])
                # points: tag x y z numPhys [phys...]; others: tag bbox(6) numPhys ...
                base = 4 if dim == 0 else 7
                n_phys = int(parts[base])
                if n_phys > 1:
                    raise ValueError("entities with multiple physical tags are unsupported")
                if n_phys == 1:
                    phys_of[(dim, tag)] = abs(int(parts[base + 1]))

    node_lines = sections["Nodes"]
    hdr = node_lines[0].split()
    n_blocks, n_nodes = int(hdr[0]), int(hdr[1])
    tags = np.empty(n_nodes, dtype=np.int64)
    coords = np.empty((n_nodes, 3))
    row, out = 1, 0
    for _ in range(n_blocks):
        bdim, btag, parametric, n_in_block = (int(x) for x in node_lines[row].split())
        if parametric:
            raise ValueError("parametric nodes are unsupported")
        row += 1
        btags = [int(node_lines[row + i]) for i in range(n_in_block)]
        row += n_in_block
        for i in range(n_in_block):
            parts = node_lines[row + i].split()
            tags[out] = btags[i]
            coords[out] = [float(parts[0]), float(parts[1]), float(parts[2])]
            out += 1
        row += n_in_block

    elem_lines = sections["Elements"]
    hdr = elem_lines[0].split()
    n_blocks = int(hdr[0])
    elements = []
    row = 1
    for _ in range(n_blocks):
        bdim, btag, etype, n_in_block = (int(x) for x in elem_lines[row].split())
        row += 1
        phys = phys_of.get((bdim, btag))
        for i in range(n_in_block):
            parts = [int(x) for x in elem_lines[row + i].split()]
            if phys is not None:
                elements.append((phys, etype, parts[1:]))
        row += n_in_block
    return (tags, coords), elements


def _build_mesh(nodes, elements, boundary_ids, domain_map):
    tags, coords = nodes
    order = np.argsort(tags)
    tags, coords = tags[order], coords[order]
    renum = {int(t): i for i, t in enumerate(tags)}

    by_bucket: dict[tuple[int, ElementType], list[list[int]]] = {}
    for phys, etype, node_tags in elements:
        if etype not in _GMSH_TYPES:
            raise ValueError(f"unsupported gmsh element type {etype} (only line/quad/hex)")
        et, perm = _GMSH_TYPES[etype]
        did = domain_map.get(phys, phys) if domain_map else phys
        ours = [renum[node_tags[p]] for p in perm]
        by_bucket.setdefault((did, et), []).append(ours)

    if not by_bucket:
        raise ValueError("gmsh file contains no supported elements in physical groups")

    domains: dict[int, list[ElementBlock]] = {}
    max_dim = 0
    for (did, et), conn in sorted(by_bucket.items(), key=lambda kv: (kv[0][0], int(kv[0][1]))):
        nodes_arr = np.asarray(conn, dtype=np.int64)
        verts = coords[nodes_arr]
        blk = ElementBlock(et, 1, nodes_arr, verts)
        _fix_orientation(blk)
        domains.setdefault(did, []).append(blk)
        from .traits import native_dim

        max_dim = max(max_dim, native_dim(et))

    return Mesh(
        dim=max_dim,
        n_nodes=len(tags),
        node_coords=coords,
        domains=domains,
        boundary_ids=tuple(int(b) for b in boundary_ids),
    )
