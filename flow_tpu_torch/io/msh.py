# Gmsh .msh reader (v2.2 and v4.1, ASCII and binary) with physical groups.
# Port of flow_tpu/io/msh.py, host numpy: externally generated geometries
# run on the port. It reads nodes, the highest-dimensional simplices
# (triangles in 2-D, tets in 3-D), facet elements (lines, facet triangles)
# with their physical tags, and $PhysicalNames, so named boundary regions
# from gmsh go straight into DirichletBC through MeshGroups.where(). Gmsh
# node tags may be sparse; they are compacted to 0-based ids, and the
# Mesh/TetMesh constructors normalise the orientation. The finished mesh
# lands on the card unless the caller passes device="cpu".
from __future__ import annotations

import numpy as np

__all__ = ["read_msh", "MeshGroups"]

_PNT, _LIN, _TRI, _TET = 15, 1, 2, 4  # gmsh element types
_NNODES = {_PNT: 1, _LIN: 2, _TRI: 3, _TET: 4}


class MeshGroups:
    """Physical groups of an imported gmsh mesh.

    Attributes:
      names      {name: (dim, tag)} from $PhysicalNames
      cell_tags  np [n_cells] int — physical tag per cell (0 = untagged),
                 aligned with the returned mesh's cell order
      facets     {(dim, tag): np [k, nv] int} — facet-element node ids per
                 physical group, in the returned mesh's vertex numbering

    `where(key)` builds a coordinate predicate selecting the boundary dofs
    of a facet group (vertices + facet-edge midpoints cover P1/P2 dofs on
    straight facets) — directly usable as DirichletBC(space, value, where).
    """

    def __init__(self, names, cell_tags, facets, points):
        self.names = names
        self.cell_tags = cell_tags
        self.facets = facets
        self._points = points

    def _resolve(self, key):
        if isinstance(key, str):
            if key not in self.names:
                raise KeyError(
                    f"no physical group named {key!r}; have {sorted(self.names)}"
                )
            dim, tag = self.names[key]
            if (dim, tag) in self.facets:
                return ("facet", (dim, tag))
            return ("cell", tag)
        if isinstance(key, tuple):
            return ("facet", key)
        # bare int: facet group first, else cell group
        for (dim, tag) in self.facets:
            if tag == key:
                return ("facet", (dim, tag))
        return ("cell", key)

    def facet_nodes(self, key):
        """Unique vertex ids of a facet physical group."""
        kind, k = self._resolve(key)
        if kind != "facet":
            raise KeyError(f"{key!r} is not a facet group")
        return np.unique(self.facets[k])

    def cell_ids(self, key):
        """Cell indices carrying the given cell physical tag."""
        kind, k = self._resolve(key)
        if kind != "cell":
            raise KeyError(f"{key!r} is not a cell group")
        return np.where(self.cell_tags == k)[0]

    def where(self, key, tol=None):
        """Coordinate predicate f(x:[n,d]) -> bool[n] selecting the group's
        facet dof locations (facet vertices + facet-edge midpoints)."""
        kind, k = self._resolve(key)
        if kind != "facet":
            raise KeyError(f"{key!r} is not a facet group")
        fac = self.facets[k]
        pts = self._points
        cloud = [pts[np.unique(fac)]]
        nv = fac.shape[1]
        for a in range(nv):
            for b in range(a + 1, nv):
                cloud.append(0.5 * (pts[fac[:, a]] + pts[fac[:, b]]))
        cloud = np.concatenate(cloud, axis=0)
        if tol is None:
            span = np.ptp(pts, axis=0).max()
            tol = 1e-8 * max(span, 1.0)
        from scipy.spatial import cKDTree

        tree = cKDTree(cloud)
        d = cloud.shape[1]

        def pred(x):
            x = np.asarray(x, dtype=np.float64)[:, :d]
            dist, _ = tree.query(x, k=1)
            return dist <= tol

        return pred


class _Cur:
    """Byte cursor over a .msh file: ASCII lines + raw binary reads."""

    def __init__(self, data):
        self.d = data
        self.i = 0

    def line(self):
        j = self.d.find(b"\n", self.i)
        if j < 0:
            s, self.i = self.d[self.i:], len(self.d)
        else:
            s, self.i = self.d[self.i:j], j + 1
        return s.rstrip(b"\r").decode("latin-1")

    def eof(self):
        return self.i >= len(self.d)

    def raw(self, n):
        b = self.d[self.i:self.i + n]
        self.i += n
        return b

    def nums(self, dtype, n):
        dt = np.dtype(dtype)
        return np.frombuffer(self.raw(dt.itemsize * int(n)), dtype=dt)

    def skip_newline(self):
        while self.i < len(self.d) and self.d[self.i:self.i + 1] in (b"\n", b"\r"):
            self.i += 1

    def skip_section(self, end):
        j = self.d.find(end.encode(), self.i)
        assert j >= 0, f"unterminated section (missing {end})"
        self.i = j
        self.line()


def read_msh(path, dtype=None, rcm=True, return_groups=False, device=None):
    """Read a gmsh .msh file (v2.2 / v4.1, ASCII / binary) -> Mesh or TetMesh.

    Picks tets if any are present, else triangles. Triangle meshes get a
    bandwidth-reducing RCM renumbering by default (gmsh numbering is
    arbitrary; gather locality follows the dof ordering): pass rcm=False
    to keep the file's order. With return_groups=True, returns (mesh,
    MeshGroups) carrying the physical groups ($PhysicalNames, cell tags,
    facet elements) remapped to the returned mesh's numbering. `dtype` and
    `device` as for the mesh constructors (device None: the card).
    """
    with open(path, "rb") as f:
        cur = _Cur(f.read())

    version, binary = None, False
    nodes_tags, nodes_xyz = [], []
    elems = {t: [] for t in (_LIN, _TRI, _TET)}  # lists of (phys, nodes...)
    names = {}
    entity_phys = {}  # (dim, entityTag) -> physical tag (v4)

    while not cur.eof():
        ln = cur.line().strip()
        if ln == "$MeshFormat":
            parts = cur.line().split()
            version = float(parts[0])
            binary = int(parts[1]) == 1
            if binary:
                one = cur.nums("<i4", 1)[0]
                if one != 1:
                    raise ValueError(
                        "big-endian binary .msh not supported"
                    )
                cur.skip_newline()
            if not (2.0 <= version < 3.0 or 4.0 <= version < 5.0):
                raise ValueError(f"unsupported .msh version {version}")
        elif ln == "$PhysicalNames":
            n = int(cur.line().split()[0])
            for _ in range(n):
                parts = cur.line().split(None, 2)
                names[parts[2].strip().strip('"')] = (
                    int(parts[0]), int(parts[1])
                )
            cur.skip_section("$EndPhysicalNames")
        elif ln == "$Entities" and version >= 4.0:
            _read_entities_v4(cur, binary, entity_phys)
        elif ln == "$Nodes":
            if version >= 4.0:
                _read_nodes_v4(cur, binary, nodes_tags, nodes_xyz)
            else:
                _read_nodes_v2(cur, binary, nodes_tags, nodes_xyz)
        elif ln == "$Elements":
            if version >= 4.0:
                _read_elements_v4(cur, binary, elems, entity_phys)
            else:
                _read_elements_v2(cur, binary, elems)
        # unknown sections fall through line by line

    if version is None:
        raise ValueError(f"{path}: not a gmsh .msh file (no $MeshFormat)")
    if not nodes_tags:
        raise ValueError(f"{path}: no nodes")

    # compact sparse gmsh node tags to dense 0-based ids
    tags = np.asarray(nodes_tags, dtype=np.int64)
    order = np.argsort(tags)
    tags = tags[order]
    pts = np.asarray(nodes_xyz, dtype=np.float64)[order]
    remap_max = tags[-1] + 1
    remap = np.full(remap_max, -1, dtype=np.int64)
    remap[tags] = np.arange(len(tags))

    def conn(etype):
        arr = np.asarray(
            [e[1] for e in elems[etype]], dtype=np.int64
        ).reshape(len(elems[etype]), _NNODES[etype])
        return remap[arr]

    def phys(etype):
        return np.asarray([e[0] for e in elems[etype]], dtype=np.int64)

    if elems[_TET]:
        cells = conn(_TET).astype(np.int32)
        cell_tags = phys(_TET)
        facet_conn = conn(_TRI) if elems[_TRI] else np.zeros((0, 3), np.int64)
        facet_phys = phys(_TRI) if elems[_TRI] else np.zeros(0, np.int64)
        facet_dim = 2
        from ..mesh3d import TetMesh

        mesh = TetMesh(pts, cells, dtype=dtype, device=device)
        mesh_pts = pts
    elif elems[_TRI]:
        cells = conn(_TRI).astype(np.int32)
        cell_tags = phys(_TRI)
        facet_conn = conn(_LIN) if elems[_LIN] else np.zeros((0, 2), np.int64)
        facet_phys = phys(_LIN) if elems[_LIN] else np.zeros(0, np.int64)
        facet_dim = 1
        if np.ptp(pts[:, 2]) > 1e-12 * max(1.0, np.abs(pts).max()):
            raise ValueError("triangle mesh is not planar in z")
        from ..mesh import Mesh, reorder_rcm

        p2 = pts[:, :2]
        if rcm:
            p2, cells, vmap, corder = reorder_rcm(
                p2, cells, return_perm=True
            )
            cell_tags = cell_tags[corder]
            if len(facet_conn):
                facet_conn = vmap[facet_conn]
        mesh = Mesh(p2, cells, dtype=dtype, device=device)
        mesh_pts = p2
    else:
        raise ValueError(f"{path}: no triangles or tets found")

    if not return_groups:
        return mesh
    facets = {}
    for t in np.unique(facet_phys):
        facets[(facet_dim, int(t))] = facet_conn[facet_phys == t]
    groups = MeshGroups(names, cell_tags, facets, mesh_pts)
    return mesh, groups


# ---------------------------------------------------------------------------
# v2.2
# ---------------------------------------------------------------------------
def _read_nodes_v2(cur, binary, nodes_tags, nodes_xyz):
    n = int(cur.line().split()[0])
    if binary:
        # records: int32 tag + 3 float64
        rec = np.frombuffer(
            cur.raw(n * 28),
            dtype=np.dtype([("t", "<i4"), ("x", "<f8", (3,))]),
        )
        nodes_tags.extend(rec["t"].tolist())
        nodes_xyz.extend(rec["x"].tolist())
        cur.skip_newline()
    else:
        for _ in range(n):
            parts = cur.line().split()
            nodes_tags.append(int(parts[0]))
            nodes_xyz.append(
                [float(parts[1]), float(parts[2]), float(parts[3])]
            )
    cur.skip_section("$EndNodes")


def _read_elements_v2(cur, binary, elems):
    n = int(cur.line().split()[0])
    if binary:
        done = 0
        while done < n:
            etype, nel, ntags = cur.nums("<i4", 3)
            nn = _NNODES.get(int(etype))
            if nn is None:
                raise ValueError(
                    f"unsupported binary element type {etype}"
                )
            rec = cur.nums("<i4", nel * (1 + ntags + nn)).reshape(
                nel, 1 + ntags + nn
            )
            if int(etype) in elems:
                for row in rec:
                    p = int(row[1]) if ntags > 0 else 0
                    elems[int(etype)].append((p, row[1 + ntags:].tolist()))
            done += int(nel)
        cur.skip_newline()
    else:
        for _ in range(n):
            parts = [int(x) for x in cur.line().split()]
            etype, ntags = parts[1], parts[2]
            if etype in elems:
                p = parts[3] if ntags > 0 else 0
                elems[etype].append((p, parts[3 + ntags:]))
    cur.skip_section("$EndElements")


# ---------------------------------------------------------------------------
# v4.1
# ---------------------------------------------------------------------------
def _read_entities_v4(cur, binary, entity_phys):
    if binary:
        np_, nc, ns, nv = cur.nums("<u8", 4)
        for _ in range(int(np_)):
            tag = cur.nums("<i4", 1)[0]
            cur.nums("<f8", 3)
            k = cur.nums("<u8", 1)[0]
            ph = cur.nums("<i4", k)
            if k:
                entity_phys[(0, int(tag))] = int(ph[0])
        for dim, cnt in ((1, nc), (2, ns), (3, nv)):
            for _ in range(int(cnt)):
                tag = cur.nums("<i4", 1)[0]
                cur.nums("<f8", 6)
                k = cur.nums("<u8", 1)[0]
                ph = cur.nums("<i4", k)
                if k:
                    entity_phys[(dim, int(tag))] = int(ph[0])
                nb = cur.nums("<u8", 1)[0]
                cur.nums("<i4", nb)
        cur.skip_newline()
    else:
        np_, nc, ns, nv = (int(x) for x in cur.line().split())
        for _ in range(np_):
            parts = cur.line().split()
            k = int(parts[4])
            if k:
                entity_phys[(0, int(parts[0]))] = int(parts[5])
        for dim, cnt in ((1, nc), (2, ns), (3, nv)):
            for _ in range(cnt):
                parts = cur.line().split()
                k = int(parts[7])
                if k:
                    entity_phys[(dim, int(parts[0]))] = int(parts[8])
    cur.skip_section("$EndEntities")


def _read_nodes_v4(cur, binary, nodes_tags, nodes_xyz):
    if binary:
        n_blocks, _, _, _ = cur.nums("<u8", 4)
        for _ in range(int(n_blocks)):
            _dim = cur.nums("<i4", 1)[0]
            _tag = cur.nums("<i4", 1)[0]
            _par = cur.nums("<i4", 1)[0]
            m = int(cur.nums("<u8", 1)[0])
            tags = cur.nums("<u8", m)
            xyz = cur.nums("<f8", 3 * m).reshape(m, 3)
            nodes_tags.extend(int(t) for t in tags)
            nodes_xyz.extend(xyz.tolist())
        cur.skip_newline()
    else:
        n_blocks = int(cur.line().split()[0])
        for _ in range(n_blocks):
            _, _, _, m = (int(x) for x in cur.line().split())
            tags = [int(cur.line()) for _ in range(m)]
            nodes_tags.extend(tags)
            for _ in range(m):
                parts = cur.line().split()
                nodes_xyz.append(
                    [float(parts[0]), float(parts[1]), float(parts[2])]
                )
    cur.skip_section("$EndNodes")


def _read_elements_v4(cur, binary, elems, entity_phys):
    if binary:
        n_blocks, _, _, _ = cur.nums("<u8", 4)
        for _ in range(int(n_blocks)):
            edim = int(cur.nums("<i4", 1)[0])
            etag = int(cur.nums("<i4", 1)[0])
            etype = int(cur.nums("<i4", 1)[0])
            m = int(cur.nums("<u8", 1)[0])
            nn = _NNODES.get(etype)
            if nn is None:
                raise ValueError(
                    f"unsupported binary element type {etype}"
                )
            rec = cur.nums("<u8", m * (1 + nn)).reshape(m, 1 + nn)
            if etype in elems:
                p = entity_phys.get((edim, etag), 0)
                for row in rec:
                    elems[etype].append((p, [int(x) for x in row[1:]]))
        cur.skip_newline()
    else:
        n_blocks = int(cur.line().split()[0])
        for _ in range(n_blocks):
            edim, etag, etype, m = (int(x) for x in cur.line().split())
            p = entity_phys.get((edim, etag), 0)
            for _ in range(m):
                parts = [int(x) for x in cur.line().split()]
                if etype in elems:
                    elems[etype].append((p, parts[1:]))
    cur.skip_section("$EndElements")
