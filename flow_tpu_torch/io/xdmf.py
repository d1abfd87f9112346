# XDMF time-series output (XML + HDF5 heavy data), ParaView-compatible.
# Port of flow_tpu/io/xdmf.py, in its file layout: the same h5 dataset
# paths and the same XML text, so ParaView and either package read the
# other's files.
#
# It stands in for dolfin's XDMFFile as the reference's drivers use it:
# named fields written a time step at a time onto a static mesh
# (`rewrite_function_mesh=False`), flushed as it goes (`flush_output=True`:
# the h5 flushed and the XML rewritten after every write).
#
# `write` stores P2 fields at the P1 vertices (the usual visualisation
# downsample). `write_checkpoint`/`read_checkpoint` mirror dolfin's restart
# API: the complete dof vector is stored, and 2-D P2 fields also get a
# visualisation series on the P2 sub-triangulation (each triangle split in
# 4 by its edge-midpoint dofs). Each write copies its field from the device
# to the host once; each read builds its Function on the space's device.
# h5py is imported where a file is opened (the `io` extra).
from __future__ import annotations

import os

import numpy as np
import torch

from ..fem.spaces import Function

__all__ = ["XDMFFile"]

_TOPO = {3: ("Triangle", 3), 4: ("Tetrahedron", 4)}


def _host(v):
    """A dof vector as host numpy (one device-to-host copy for a tensor)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _on_space(a, space):
    """Host values as a tensor in the space's dtype on its device."""
    mesh = space.mesh
    return torch.as_tensor(np.ascontiguousarray(a)).to(device=mesh.device,
                                                       dtype=mesh.dtype)


class XDMFFile:
    def __init__(self, filename, mesh=None):
        self.filename = filename
        self.h5name = os.path.splitext(filename)[0] + ".h5"
        self.mesh = mesh
        self._h5 = None
        self._grids = {}  # grid name -> (n_points, n_cells, topo, nper, geom, dim)
        self._series = {}  # field name -> list of (time, h5 path, kind, grid)
        self.parameters = {"flush_output": True, "rewrite_function_mesh": False}
        self._counter = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _ensure_h5(self):
        if self._h5 is None:
            import h5py

            self._h5 = h5py.File(self.h5name, "w")
        return self._h5

    def _register_grid(self, key, points, cells):
        h5 = self._ensure_h5()
        if key not in self._grids:
            h5.create_dataset(f"{key}/points", data=points)
            h5.create_dataset(f"{key}/cells", data=cells.astype(np.int64))
            topo, nper = _TOPO[cells.shape[1]]
            geom = "XY" if points.shape[1] == 2 else "XYZ"
            self._grids[key] = (
                points.shape[0],
                cells.shape[0],
                topo,
                nper,
                geom,
                points.shape[1],
            )

    def _write_mesh(self, mesh):
        self._register_grid("mesh", mesh.points_np, mesh.cells_np)
        self.mesh = mesh

    @staticmethod
    def _pad3(data):
        # paraview wants 3-vectors
        if data.ndim == 2 and data.shape[1] == 2:
            data = np.concatenate([data, np.zeros((data.shape[0], 1))], axis=1)
        return data

    def write(self, fn: Function, t=0.0):
        mesh = fn.space.mesh
        self._write_mesh(mesh)
        h5 = self._h5
        name = fn.name or f"field{len(self._series)}"
        npts = mesh.n_points
        vec = _host(fn.vector[:npts])
        if fn.space.n_components == 1:
            data = vec
            kind = "Scalar"
        else:
            data = self._pad3(vec)
            kind = "Vector"
        path = f"{name}/{self._counter}"
        h5.create_dataset(path, data=data)
        self._series.setdefault(name, []).append((float(t), path, kind, "mesh"))
        self._counter += 1
        if self.parameters.get("flush_output", True):
            h5.flush()
            self._write_xml()

    # -- full-fidelity restart path (dolfin XDMFFile.write_checkpoint /
    #    read_checkpoint semantics) --------------------------------------
    def write_checkpoint(self, fn: Function, name=None, t=0.0):
        """Store the COMPLETE dof vector (restartable via read_checkpoint).

        2-D P2 fields also get a visualization entry on the P2
        sub-triangulation — full quadratic fidelity, no vertex downsample.
        """
        space = fn.space
        mesh = space.mesh
        name = name or fn.name or f"field{len(self._series)}"
        h5 = self._ensure_h5()
        vec = _host(fn.vector)
        k = len(h5.get(f"checkpoint/{name}", {}))
        ds = h5.create_dataset(f"checkpoint/{name}/{k}", data=vec)
        ds.attrs["t"] = float(t)
        ds.attrs["degree"] = space.degree
        ds.attrs["n_components"] = space.n_components

        kind = "Scalar" if space.n_components == 1 else "Vector"
        if space.degree == 2 and mesh.dim == 2:
            # viz on the P2 refinement: dof points = vertices + edge
            # midpoints; each triangle [v0,v1,v2,m0,m1,m2] (edge k opposite
            # vertex k) splits into (v0,m2,m1),(v1,m0,m2),(v2,m1,m0),(m0,m1,m2)
            cd = space.cell_dofs_np
            sub = np.concatenate(
                [
                    cd[:, [0, 5, 4]],
                    cd[:, [1, 3, 5]],
                    cd[:, [2, 4, 3]],
                    cd[:, [3, 4, 5]],
                ],
                axis=0,
            )
            self._register_grid("mesh_p2", space.dof_points_np, sub)
            data = self._pad3(vec) if kind == "Vector" else vec
            path = f"{name}_viz/{self._counter}"
            h5.create_dataset(path, data=data)
            self._series.setdefault(name, []).append((float(t), path, kind, "mesh_p2"))
            self._counter += 1
        else:
            self._write_mesh(mesh)
            data = vec[: mesh.n_points]
            data = self._pad3(data) if kind == "Vector" else data
            path = f"{name}_viz/{self._counter}"
            h5.create_dataset(path, data=data)
            self._series.setdefault(name, []).append((float(t), path, kind, "mesh"))
            self._counter += 1
        if self.parameters.get("flush_output", True):
            h5.flush()
            self._write_xml()

    def read_checkpoint(self, space, name, counter=-1):
        """Read a write_checkpoint'ed field back into a Function on `space`.

        Returns (Function, t). `counter` indexes the stored time series
        (negative = from the end, as in dolfin).
        """
        import h5py

        if self._h5 is not None:
            self._h5.flush()
        with h5py.File(self.h5name, "r") as h5:
            grp = h5[f"checkpoint/{name}"]
            keys = sorted(grp.keys(), key=int)
            ds = grp[keys[counter]]
            vec = np.asarray(ds)
            t = float(ds.attrs["t"])
            ncomp = int(ds.attrs["n_components"])
        if ncomp != space.n_components or vec.shape[0] != space.n_dofs:
            raise ValueError(
                f"checkpoint '{name}' shape {vec.shape} does not match space "
                f"({space.n_dofs} dofs x {space.n_components})"
            )
        return Function(space, _on_space(vec, space)).rename(name), t

    # -- visualization-series read path (dolfin XDMFFile is read/write;
    #    `write` stores vertex values on the P1 grid, so reading back into a
    #    P1 space is exact) -------------------------------------------------
    def read_mesh(self, dtype=None, device=None):
        """Reconstruct the mesh from the stored grid ('mesh' group). `dtype`
        and `device` as for the mesh constructors (device None: the
        card)."""
        import h5py

        if self._h5 is not None:
            self._h5.flush()
        with h5py.File(self.h5name, "r") as h5:
            pts = np.asarray(h5["mesh/points"])
            cells = np.asarray(h5["mesh/cells"], dtype=np.int32)
        if pts.shape[1] == 2:
            from ..mesh import Mesh

            return Mesh(pts, cells, dtype=dtype, device=device)
        from ..mesh3d import TetMesh

        return TetMesh(pts, cells, dtype=dtype, device=device)

    def read(self, space, name, counter=-1):
        """Read an entry of a `write` visualization series back into a
        Function on `space` (a P1 space on the stored mesh). Returns
        (Function, t). `counter` indexes the time series (negative = from
        the end)."""
        import h5py

        if self._h5 is not None:
            self._h5.flush()
        series = self._read_xml_series() if not self._series else self._series
        if name not in series:
            raise KeyError(f"no series named '{name}' (have {list(series)})")
        t, path, kind, grid = series[name][counter]
        with h5py.File(self.h5name, "r") as h5:
            data = np.asarray(h5[path])
        if kind == "Vector":
            dim = 3 if np.abs(data[:, 2]).max() > 0 else 2
            data = data[:, :dim] if dim == 2 else data
        if data.shape[0] != space.n_dofs:
            raise ValueError(
                f"series '{name}' has {data.shape[0]} vertex values; space "
                f"has {space.n_dofs} dofs (read viz series into a P1 space)"
            )
        return Function(space, _on_space(data, space)).rename(name), t

    def _read_xml_series(self):
        """Recover the series index from the .xdmf XML (for files opened
        fresh for reading rather than written by this instance)."""
        import xml.etree.ElementTree as ET

        series = {}
        root = ET.parse(self.filename).getroot()
        for coll in root.iter("Grid"):
            if coll.get("GridType") != "Collection":
                continue
            name = coll.get("Name")
            for g in coll.findall("Grid"):
                t = float(g.find("Time").get("Value"))
                attr = g.find("Attribute")
                kind = attr.get("AttributeType")
                ref = attr.find("DataItem").text.strip()
                path = ref.split(":", 1)[1].lstrip("/")
                topo = g.find("Topology").find("DataItem").text.strip()
                grid = topo.split(":", 1)[1].lstrip("/").rsplit("/", 1)[0]
                series.setdefault(name, []).append((t, path, kind, grid))
        return series

    def _write_xml(self):
        h5base = os.path.basename(self.h5name)
        lines = [
            '<?xml version="1.0"?>',
            '<Xdmf Version="3.0">',
            "<Domain>",
        ]
        for name, series in self._series.items():
            lines.append(
                f'<Grid Name="{name}" GridType="Collection" '
                'CollectionType="Temporal">'
            )
            for t, path, kind, grid in series:
                npts, ncells, topo, nper, geom, dim = self._grids[grid]
                lines += [
                    '<Grid Name="mesh" GridType="Uniform">',
                    f'<Time Value="{t}"/>',
                    f'<Topology NumberOfElements="{ncells}" '
                    f'TopologyType="{topo}" NodesPerElement="{nper}">',
                    f'<DataItem Dimensions="{ncells} {nper}" '
                    f'NumberType="Int" Format="HDF">{h5base}:/{grid}/cells</DataItem>',
                    "</Topology>",
                    f'<Geometry GeometryType="{geom}">',
                    f'<DataItem Dimensions="{npts} {dim}" '
                    f'Format="HDF">{h5base}:/{grid}/points</DataItem>',
                    "</Geometry>",
                    f'<Attribute Name="{name}" AttributeType="{kind}" '
                    'Center="Node">',
                    f'<DataItem Dimensions="{npts} '
                    f'{3 if kind == "Vector" else 1}" '
                    f'Format="HDF">{h5base}:/{path}</DataItem>',
                    "</Attribute>",
                    "</Grid>",
                ]
            lines.append("</Grid>")
        lines += ["</Domain>", "</Xdmf>"]
        with open(self.filename, "w") as f:
            f.write("\n".join(lines))

    def close(self):
        if self._h5 is not None:
            self._write_xml()
            self._h5.close()
            self._h5 = None
