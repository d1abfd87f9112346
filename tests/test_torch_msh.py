# The gmsh .msh reader of flow_tpu_torch (io/msh.py) against the JAX
# package's on the files tests/test_msh.py writes (v2.2 and v4.1, ASCII and
# binary, a tet, physical groups): equal points, cells and MeshGroups (names,
# cell tags, facet groups, the boundary dofs their predicates select), with
# and without the RCM renumbering.
import numpy as np
import pytest
import torch

from flow_tpu import FunctionSpace as JFunctionSpace
from flow_tpu.io import read_msh as j_read_msh
from flow_tpu_torch import FunctionSpace, read_msh
from flow_tpu_torch.io.msh import MeshGroups
from test_msh import MSH22, MSH22_GROUPS, MSH41, _msh22_binary, _msh41_binary

torch.set_num_threads(1)

TET22 = """\
$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
4
1 0 0 0
2 1 0 0
3 0 1 0
4 0 0 1
$EndNodes
$Elements
1
1 4 2 0 1 1 2 3 4
$EndElements
"""

FILES = {"v2.2": MSH22, "v4.1": MSH41, "tet": TET22, "groups-ascii22": MSH22_GROUPS,
         "groups-bin22": _msh22_binary(), "groups-bin41": _msh41_binary()}


def _write(tmp_path, key):
    p = tmp_path / f"{key}.msh"
    content = FILES[key]
    if isinstance(content, bytes):
        p.write_bytes(content)
    else:
        p.write_text(content)
    return str(p)


@pytest.mark.parametrize("rcm", [True, False], ids=["rcm", "file-order"])
@pytest.mark.parametrize("key", list(FILES))
def test_read_msh_equals_jax(tmp_path, key, rcm):
    path = _write(tmp_path, key)
    jm, jg = j_read_msh(path, rcm=rcm, return_groups=True)
    tm, tg = read_msh(path, rcm=rcm, return_groups=True, dtype=torch.float64, device="cpu")
    assert isinstance(tg, MeshGroups) and tm.dim == jm.dim
    assert tm.device == torch.device("cpu") and tm.dtype == torch.float64
    np.testing.assert_array_equal(tm.points_np, jm.points_np)
    np.testing.assert_array_equal(tm.cells_np, jm.cells_np)
    np.testing.assert_array_equal(tm.cell_volumes(), np.asarray(jm.cell_volumes()))
    assert tg.names == jg.names
    np.testing.assert_array_equal(tg.cell_tags, jg.cell_tags)
    assert sorted(tg.facets) == sorted(jg.facets)
    for k in jg.facets:
        np.testing.assert_array_equal(tg.facets[k], jg.facets[k])
    if tm.dim == 2:
        W, JW = FunctionSpace(tm, 2), JFunctionSpace(jm, 2)
        for name, (dim, _tag) in jg.names.items():
            if dim == 1:
                np.testing.assert_array_equal(tg.facet_nodes(name), jg.facet_nodes(name))
                np.testing.assert_array_equal(W.boundary_dofs(tg.where(name)),
                                              JW.boundary_dofs(jg.where(name)))
            else:
                np.testing.assert_array_equal(tg.cell_ids(name), jg.cell_ids(name))


def test_read_msh_groups_select_the_boundary(tmp_path):
    # tests/test_msh.py's checks of the groups, on the port's reader
    mesh, groups = read_msh(_write(tmp_path, "groups-bin41"), return_groups=True,
                            dtype=torch.float64, device="cpu")
    assert (mesh.n_points, mesh.n_cells) == (5, 4)
    np.testing.assert_allclose(mesh.cell_volumes().sum(), 1.0)
    assert set(groups.cell_tags.tolist()) == {6} and len(groups.cell_ids("fluid")) == 4
    W = FunctionSpace(mesh, 2)
    dofs = W.boundary_dofs(groups.where("bottom"))
    assert len(dofs) == 3
    np.testing.assert_allclose(W.dof_points_np[dofs][:, 1], 0.0, atol=1e-12)
    np.testing.assert_allclose(W.dof_points_np[W.boundary_dofs(groups.where("right"))][:, 0],
                               1.0, atol=1e-12)
    with pytest.raises(KeyError):
        groups.cell_ids("bottom")
    with pytest.raises(KeyError):
        groups.where("inlet")


def test_read_msh_rejects_and_defaults_to_the_card(tmp_path):
    p = tmp_path / "bad.msh"
    p.write_text("solid cube\nendsolid\n")
    with pytest.raises(ValueError, match="not a gmsh"):
        read_msh(str(p), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            read_msh(_write(tmp_path, "v2.2"))
