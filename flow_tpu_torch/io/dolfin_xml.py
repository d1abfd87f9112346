# DOLFIN XML mesh read/write. Port of flow_tpu/io/dolfin_xml.py, host
# numpy: the reference's mesh interchange format (its applications cache
# pygmsh meshes as DOLFIN XML and read them back with Mesh('test.xml')), so
# a user coming from it keeps the cached .xml meshes. The same text as the
# JAX package's writer, so either package reads the other's files.
#
# Format (dolfin XML schema, triangle/tetrahedron cells only, the simplex
# families of this framework):
#   <dolfin><mesh celltype="triangle" dim="2">
#     <vertices size="N"><vertex index="i" x=".." y=".." [z=".."]/></vertices>
#     <cells size="M"><triangle index="i" v0=".." v1=".." v2=".."/></cells>
#   </mesh></dolfin>
from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np

__all__ = ["read_dolfin_xml", "write_dolfin_xml"]


def _local(tag):
    # dolfin files may carry a namespace; match on the local tag name
    return tag.rsplit("}", 1)[-1]


def read_dolfin_xml(path, dtype=None, device=None):
    """Read a DOLFIN XML mesh file -> Mesh (triangles) or TetMesh (tets).
    `dtype` and `device` as for the mesh constructors (device None: the
    card)."""
    root = ET.parse(path).getroot()
    mesh_el = None
    for el in root.iter():
        if _local(el.tag) == "mesh":
            mesh_el = el
            break
    if mesh_el is None:
        raise ValueError(f"{path}: no <mesh> element")
    celltype = mesh_el.get("celltype")
    dim = int(mesh_el.get("dim", "2"))
    if celltype not in ("triangle", "tetrahedron"):
        raise ValueError(f"{path}: unsupported celltype {celltype!r}")

    verts_el = cells_el = None
    for el in mesh_el:
        if _local(el.tag) == "vertices":
            verts_el = el
        elif _local(el.tag) == "cells":
            cells_el = el
    if verts_el is None or cells_el is None:
        raise ValueError(f"{path}: missing <vertices> or <cells>")

    coords = ("x", "y", "z")[:dim]
    n = int(verts_el.get("size"))
    points = np.zeros((n, dim), dtype=np.float64)
    for v in verts_el:
        i = int(v.get("index"))
        for d, c in enumerate(coords):
            points[i, d] = float(v.get(c, "0"))

    nv = 3 if celltype == "triangle" else 4
    vkeys = [f"v{k}" for k in range(nv)]
    m = int(cells_el.get("size"))
    cells = np.zeros((m, nv), dtype=np.int64)
    for c in cells_el:
        i = int(c.get("index"))
        for k, key in enumerate(vkeys):
            cells[i, k] = int(c.get(key))

    if celltype == "triangle":
        from ..mesh import Mesh

        return Mesh(points[:, :2], cells, dtype=dtype, device=device)
    from ..mesh3d import TetMesh

    return TetMesh(points, cells, dtype=dtype, device=device)


def write_dolfin_xml(path, mesh):
    """Write a Mesh/TetMesh as DOLFIN XML (readable by dolfin and by
    read_dolfin_xml)."""
    pts = np.asarray(mesh.points_np)
    cells = np.asarray(mesh.cells_np)
    dim = pts.shape[1]
    celltype = "triangle" if cells.shape[1] == 3 else "tetrahedron"
    coords = ("x", "y", "z")[:dim]
    lines = [
        '<?xml version="1.0"?>',
        '<dolfin xmlns:dolfin="http://fenicsproject.org">',
        f'  <mesh celltype="{celltype}" dim="{dim}">',
        f'    <vertices size="{len(pts)}">',
    ]
    for i, p in enumerate(pts):
        attrs = " ".join(f'{c}="{float(p[d])!r}"' for d, c in enumerate(coords))
        lines.append(f'      <vertex index="{i}" {attrs}/>')
    lines.append("    </vertices>")
    lines.append(f'    <cells size="{len(cells)}">')
    for i, c in enumerate(cells):
        attrs = " ".join(f'v{k}="{c[k]}"' for k in range(len(c)))
        lines.append(f'      <{celltype} index="{i}" {attrs}/>')
    lines.append("    </cells>")
    lines.append("  </mesh>")
    lines.append("</dolfin>")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
