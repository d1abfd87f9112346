# Mesh and field I/O of flow_tpu_torch (io/xdmf.py, io/dolfin_xml.py,
# mesh.save_mesh/load_mesh) against the JAX package's, float64 on the CPU:
# each file is written by one package and read by the other, in both
# directions, with equal arrays, and the .xdmf text of the two packages is
# identical. Also the utilities (MetricsLogger, Expression, profiling,
# plotting) and materials.air against the JAX package's values.
import json
import os
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import flow_tpu
import flow_tpu.io as jio
import flow_tpu_torch
from flow_tpu import mesh as jmesh
from flow_tpu import mesh3d as jmesh3d
from flow_tpu_torch import io as tio
from flow_tpu_torch import mesh as tmesh
from flow_tpu_torch import mesh3d as tmesh3d

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")
DIRECTIONS = ["jax-to-torch", "torch-to-jax"]


class _Side:
    """One package's constructors and the conversion of a host array into
    its dof vectors."""

    def __init__(self, name):
        self.name = name
        self.pkg = flow_tpu if name == "jax" else flow_tpu_torch
        self.io = jio if name == "jax" else tio
        self.mesh = jmesh if name == "jax" else tmesh
        self.mesh3d = jmesh3d if name == "jax" else tmesh3d
        self.kw = {} if name == "jax" else F64

    def vec(self, a):
        return jnp.asarray(a) if self.name == "jax" else torch.as_tensor(a)

    def fn(self, space, a, name):
        return self.pkg.Function(space, self.vec(a)).rename(name)


def _sides(direction):
    """(writer, reader) for a direction."""
    w, r = direction.split("-to-")
    return _Side(w), _Side(r)


def _host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _write_series(side, path, rng_seed=3):
    """Two P1 scalar and one P2 vector write at t = 0, 0.5 on
    unit_square_mesh(4); returns the host arrays written."""
    mesh = side.mesh.unit_square_mesh(4, **side.kw)
    S = side.pkg.FunctionSpace(mesh, 1)
    V = side.pkg.VectorFunctionSpace(mesh, 2)
    rng = np.random.default_rng(rng_seed)
    T0, T1 = rng.standard_normal(S.n_dofs), rng.standard_normal(S.n_dofs)
    U = rng.standard_normal((V.n_dofs, 2))
    with side.io.XDMFFile(str(path)) as xf:
        xf.write(side.fn(S, T0, "temperature"), 0.0)
        xf.write(side.fn(V, U, "velocity"), 0.0)
        xf.write(side.fn(S, T1, "temperature"), 0.5)
    return T0, T1, U, mesh.n_points


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_xdmf_time_series_cross_read(tmp_path, direction):
    import h5py

    writer, reader = _sides(direction)
    (tmp_path / "w").mkdir()
    (tmp_path / "o").mkdir()
    T0, T1, U, npts = _write_series(writer, tmp_path / "w" / "out.xdmf")
    _write_series(reader, tmp_path / "o" / "out.xdmf")
    # the two packages write the same XML text and the same datasets
    assert ((tmp_path / "w" / "out.xdmf").read_text()
            == (tmp_path / "o" / "out.xdmf").read_text())
    with h5py.File(tmp_path / "w" / "out.h5") as a, h5py.File(tmp_path / "o" / "out.h5") as b:
        names = []
        a.visit(names.append)
        other = []
        b.visit(other.append)
        assert sorted(names) == sorted(other)
        for k in names:
            if isinstance(a[k], h5py.Dataset):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k][...], b[k][...])
        np.testing.assert_array_equal(a["velocity/1"][...][:, :2], U[:npts])
        assert a["velocity/1"].shape == (npts, 3)
    # the reader's package reads the writer's file cold (series from the XML)
    xf = reader.io.XDMFFile(str(tmp_path / "w" / "out.xdmf"))
    m = xf.read_mesh(**reader.kw)
    assert m.n_points == npts
    S = reader.pkg.FunctionSpace(m, 1)
    W = reader.pkg.VectorFunctionSpace(m, 1)
    got, t = xf.read(S, "temperature", counter=-1)
    assert t == 0.5
    np.testing.assert_array_equal(_host(got.vector), T1)
    got, t = xf.read(W, "velocity")
    assert t == 0.0
    np.testing.assert_array_equal(_host(got.vector), U[:npts])
    got, _ = xf.read(S, "temperature", counter=0)
    np.testing.assert_array_equal(_host(got.vector), T0)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_xdmf_p2_checkpoint_cross_read(tmp_path, direction):
    import h5py

    writer, reader = _sides(direction)
    rng = np.random.default_rng(5)
    paths = {}
    for side, sub in ((writer, "w"), (reader, "o")):
        mesh = side.mesh.unit_square_mesh(4, **side.kw)
        V = side.pkg.VectorFunctionSpace(mesh, 2)
        if side is writer:
            vec = rng.standard_normal((V.n_dofs, 2))
        (tmp_path / sub).mkdir()
        paths[sub] = tmp_path / sub / "chk.xdmf"
        with side.io.XDMFFile(str(paths[sub])) as xf:
            xf.write_checkpoint(side.fn(V, vec, "velocity"), t=0.0)
            xf.write_checkpoint(side.fn(V, 2.0 * vec, "velocity"), t=0.25)
    assert paths["w"].read_text() == paths["o"].read_text()
    mesh = reader.mesh.unit_square_mesh(4, **reader.kw)
    V = reader.pkg.VectorFunctionSpace(mesh, 2)
    xf = reader.io.XDMFFile(str(paths["w"]))
    u0, t0 = xf.read_checkpoint(V, "velocity", counter=0)
    u1, t1 = xf.read_checkpoint(V, "velocity", counter=-1)
    assert (t0, t1) == (0.0, 0.25)
    np.testing.assert_array_equal(_host(u0.vector), vec)
    np.testing.assert_array_equal(_host(u1.vector), 2.0 * vec)
    with pytest.raises(ValueError):
        xf.read_checkpoint(reader.pkg.FunctionSpace(mesh, 1), "velocity")
    with h5py.File(paths["w"].with_suffix(".h5")) as h5:
        cells, pts = h5["mesh_p2/cells"][...], h5["mesh_p2/points"][...]
        assert cells.shape == (4 * mesh.n_cells, 3) and pts.shape == (V.n_dofs, 2)
        d = pts[cells]
        e1, e2 = d[:, 1] - d[:, 0], d[:, 2] - d[:, 0]
        area = 0.5 * (e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])
        assert (area > 0).all()
        np.testing.assert_allclose(area.sum(), 1.0, atol=1e-12)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_xdmf_3d_cross_read(tmp_path, direction):
    writer, reader = _sides(direction)
    rng = np.random.default_rng(11)
    paths = {}
    for side, sub in ((writer, "w"), (reader, "o")):
        mesh = side.mesh3d.box_mesh((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), 2, 2, 2, **side.kw)
        S = side.pkg.FunctionSpace(mesh, 1)
        V = side.pkg.VectorFunctionSpace(mesh, 2, n_components=3)
        if side is writer:
            T = rng.standard_normal(S.n_dofs)
            U = rng.standard_normal((V.n_dofs, 3))
        (tmp_path / sub).mkdir()
        paths[sub] = tmp_path / sub / "out3.xdmf"
        with side.io.XDMFFile(str(paths[sub])) as xf:
            xf.write(side.fn(S, T, "T"), 0.0)
            xf.write(side.fn(V, U, "u"), 0.0)
            xf.write_checkpoint(side.fn(V, U, "u"), t=0.0)
    text = paths["w"].read_text()
    assert text == paths["o"].read_text()
    root = ET.fromstring(text)
    assert root.find(".//Topology").get("TopologyType") == "Tetrahedron"
    assert root.find(".//Geometry").get("GeometryType") == "XYZ"
    xf = reader.io.XDMFFile(str(paths["w"]))
    m = xf.read_mesh(**reader.kw)
    assert m.dim == 3 and m.n_points == 27
    np.testing.assert_array_equal(m.points_np, mesh.points_np)
    got, _ = xf.read(reader.pkg.FunctionSpace(m, 1), "T")
    np.testing.assert_array_equal(_host(got.vector), T)
    got, _ = xf.read(reader.pkg.VectorFunctionSpace(m, 1, n_components=3), "u", counter=0)
    np.testing.assert_array_equal(_host(got.vector), U[:27])
    V = reader.pkg.VectorFunctionSpace(mesh, 2, n_components=3)
    got, _ = xf.read_checkpoint(V, "u")
    np.testing.assert_array_equal(_host(got.vector), U)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_xdmf_viz_series_cross_read(tmp_path, direction):
    # projected P1 fields through `write`, read back into P1 spaces on the
    # stored mesh, at every time of the series
    writer, reader = _sides(direction)
    mesh = writer.mesh.unit_square_mesh(5, **writer.kw)
    Q = writer.pkg.FunctionSpace(mesh, 1)
    W = writer.pkg.VectorFunctionSpace(mesh, 1)
    path = str(tmp_path / "series.xdmf")
    want = {}
    with writer.io.XDMFFile(path) as xf:
        for t in (0.0, 0.5, 1.0):
            p = writer.pkg.project(lambda x: (1 + t) * x[..., 0], Q)
            u = writer.pkg.project((lambda x: x[..., 1] + t, 0.0), W)
            xf.write(p.rename("pressure"), t)
            xf.write(u.rename("velocity"), t)
            want[t] = (_host(p.vector), _host(u.vector))
    xf = reader.io.XDMFFile(path)
    m = xf.read_mesh(**reader.kw)
    assert (m.n_points, m.n_cells) == (mesh.n_points, mesh.n_cells)
    Q2, W2 = reader.pkg.FunctionSpace(m, 1), reader.pkg.VectorFunctionSpace(m, 1)
    for k, t in enumerate((0.0, 0.5, 1.0)):
        pr, tp = xf.read(Q2, "pressure", counter=k)
        ur, tu = xf.read(W2, "velocity", counter=k)
        assert tp == tu == t
        np.testing.assert_array_equal(_host(pr.vector), want[t][0])
        np.testing.assert_array_equal(_host(ur.vector), want[t][1])
    np.testing.assert_allclose(_host(pr.vector), 2.0 * m.points_np[:, 0], atol=1e-12)
    with pytest.raises(KeyError):
        xf.read(Q2, "temperature")


def _meshes(side, dim):
    if dim == 2:
        return side.mesh.unit_square_mesh(3, diagonal="crossed", **side.kw)
    return side.mesh3d.box_mesh((0, 0, 0), (1, 2, 3), 2, 2, 2, **side.kw)


@pytest.mark.parametrize("dim", [2, 3], ids=["2d", "3d"])
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_dolfin_xml_cross_read(tmp_path, direction, dim):
    writer, reader = _sides(direction)
    mesh = _meshes(writer, dim)
    writer.io.write_dolfin_xml(tmp_path / "w.xml", mesh)
    reader.io.write_dolfin_xml(tmp_path / "o.xml", _meshes(reader, dim))
    assert (tmp_path / "w.xml").read_text() == (tmp_path / "o.xml").read_text()
    back = reader.io.read_dolfin_xml(tmp_path / "w.xml", **reader.kw)
    assert back.dim == dim
    np.testing.assert_array_equal(back.cells_np, mesh.cells_np)
    np.testing.assert_array_equal(back.points_np, mesh.points_np)


@pytest.mark.parametrize("dim", [2, 3], ids=["2d", "3d"])
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_save_mesh_cross_load(tmp_path, direction, dim):
    writer, reader = _sides(direction)
    mesh = _meshes(writer, dim)
    writer.mesh.save_mesh(tmp_path / "m.npz", mesh)
    back = reader.mesh.load_mesh(tmp_path / "m.npz", **reader.kw)
    assert back.dim == dim
    np.testing.assert_array_equal(back.cells_np, mesh.cells_np)
    np.testing.assert_array_equal(back.points_np, mesh.points_np)
    np.testing.assert_array_equal(back.cell_volumes(), _meshes(reader, dim).cell_volumes())


def test_port_meshes_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal is for machines without one")
    mesh = tmesh.unit_square_mesh(2, **F64)
    tmesh.save_mesh(tmp_path / "m.npz", mesh)
    tio.write_dolfin_xml(tmp_path / "m.xml", mesh)
    for call in (lambda: tmesh.load_mesh(tmp_path / "m.npz"),
                 lambda: tio.read_dolfin_xml(tmp_path / "m.xml")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_cell_volumes_and_public_names_equal_jax():
    rng = np.random.default_rng(2)
    for make in (lambda s: s.mesh.unit_square_mesh(4, diagonal="left/right", **s.kw),
                 lambda s: s.mesh3d.box_mesh((0, 0, 0), (1, 1, 2), 2, 3, 2, **s.kw)):
        jm, tm = make(_Side("jax")), make(_Side("torch"))
        np.testing.assert_array_equal(tm.cell_volumes(), np.asarray(jm.cell_volumes()))
    tmsh = tmesh.unit_square_mesh(3, **F64)
    jV = flow_tpu.VectorFunctionSpace(jmesh.unit_square_mesh(3), 2)
    tV = flow_tpu_torch.VectorFunctionSpace(tmsh, 2)
    assert tV.value_shape == jV.value_shape == (2,)
    assert flow_tpu_torch.FunctionSpace(tmsh, 1).value_shape == ()
    U = rng.standard_normal((tV.n_dofs, 2))
    ju = flow_tpu.Function(jV, jnp.asarray(U))
    tu = flow_tpu_torch.Function(tV, torch.as_tensor(U))
    for jc, tc in zip(ju.split(), tu.split()):
        assert tc.space.n_components == 1 and tc.space.degree == 2
        np.testing.assert_array_equal(tc.vector.numpy(), np.asarray(jc.vector))
    w = flow_tpu_torch.Function(tV).assign(tu)
    assert w.vector is tu.vector
    assert w.assign(2.0 * tu.vector).vector.sum() == 2.0 * tu.vector.sum()
    from flow_tpu_torch.fem import ell

    loc = rng.standard_normal((tmsh.n_cells, 3, 3))
    Q = flow_tpu_torch.FunctionSpace(tmsh, 1)
    x = torch.as_tensor(rng.standard_normal(Q.n_dofs))
    np.testing.assert_array_equal(ell.ell_scaled_ZtMZ(Q, loc).apply(x).numpy(),
                                  ell.ell_from_local(Q, loc).apply(x).numpy())


def test_materials_air_and_water_equal_jax():
    from flow_tpu import materials as jm
    from flow_tpu_torch import materials as tm

    T = np.linspace(250.0, 400.0, 7)
    assert tm.__all__ == ["water", "air"]
    for name in ("water", "air"):
        for prop in ("density", "dynamic_viscosity", "specific_heat_capacity",
                     "thermal_conductivity"):
            np.testing.assert_array_equal(getattr(getattr(tm, name), prop)(T),
                                          getattr(getattr(jm, name), prop)(T))
    assert abs(tm.air.density(293.15) - 1.204) < 0.01
    assert abs(tm.air.dynamic_viscosity(293.15) - 1.81e-5) < 1e-6


def test_metrics_logger_matches_jax(tmp_path):
    from flow_tpu.utils.metrics import MetricsLogger as JLogger
    from flow_tpu_torch.utils import MetricsLogger

    summaries = []
    for cls, name in ((JLogger, "j.jsonl"), (MetricsLogger, "t.jsonl")):
        with cls(str(tmp_path / name)) as m:
            m.log(step=1, dt=0.1, unorm=2.0, wall_dt=0.0, solver="cg")
            m.log(step=2, dt=0.2, unorm=4.0, wall_dt=0.0, solver="cg")
        summaries.append(m.summary())
        lines = [json.loads(line) for line in (tmp_path / name).read_text().splitlines()]
        assert len(lines) == 2 and lines[0]["step"] == 1 and lines[1]["solver"] == "cg"
    assert summaries[0] == summaries[1]
    assert summaries[1]["unorm"]["mean"] == 3.0 and summaries[1]["dt"]["max"] == 0.2
    assert "solver" not in summaries[1]
    m = MetricsLogger()
    m.log(a=1)
    assert m.records[0]["wall_dt"] >= 0.0 and m.summary()["a"]["n"] == 1


def test_expression_settable_params():
    from flow_tpu_torch.utils import Expression

    e = Expression(lambda x, t, a: a * x[..., 0] + t, t=0.0, a=2.0)
    pts = torch.tensor([[1.0, 0.0], [2.0, 0.0]], dtype=torch.float64)
    np.testing.assert_array_equal(e(pts).numpy(), [2.0, 4.0])
    e.t = 1.5
    assert e.t == 1.5
    np.testing.assert_array_equal(e(pts).numpy(), [3.5, 5.5])
    with pytest.raises(AttributeError):
        e.missing
    S = flow_tpu_torch.FunctionSpace(tmesh.unit_square_mesh(3, **F64), 1)
    u = flow_tpu_torch.interpolate(e, S)
    want = 2.0 * S.dof_points_np[:, 0] + 1.5
    np.testing.assert_allclose(u.vector.numpy(), want, rtol=0, atol=1e-15)


def test_profiling_on_the_cpu(tmp_path):
    from flow_tpu_torch.fem import assembly
    from flow_tpu_torch.utils import Timer, cost_report, device_memory_stats, profiling

    mesh = tmesh.unit_square_mesh(6, **F64)
    S = flow_tpu_torch.FunctionSpace(mesh, 2)
    geom = assembly.geometry_on(mesh, torch.float64, "cpu")
    x = torch.ones(S.n_dofs, dtype=torch.float64)
    rep = cost_report(lambda v: assembly.stiffness_apply(S, geom, v), x)
    assert set(rep) == {"flops"} and rep["flops"] >= 0
    a = torch.ones((8, 8), dtype=torch.float64)
    assert cost_report(torch.mm, a, a) == {"flops": 2 * 8 * 8 * 8}
    with Timer("t") as t:
        pass
    assert t.elapsed >= 0.0
    t2 = Timer("s", sync=True).start()
    assert t2.stop() >= 0.0 and t2.stop() == t2.elapsed
    if not torch.cuda.is_available():
        assert device_memory_stats() == {}
    logdir = str(tmp_path / "tr")
    with profiling.trace(logdir) as d:
        assert d == logdir
        assembly.stiffness_apply(S, geom, x)
    files = [f for _, _, fs in os.walk(logdir) for f in fs]
    assert files and all(f.endswith(".json") for f in files), files
    with open(os.path.join(logdir, files[0])) as fh:
        assert json.load(fh)["traceEvents"]


def test_plotting_under_agg(tmp_path, capsys):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from flow_tpu.utils import plotting as jplot
    from flow_tpu_torch.utils import plotting

    mesh = tmesh.unit_square_mesh(4, **F64)
    V = flow_tpu_torch.VectorFunctionSpace(mesh, 2)
    u = flow_tpu_torch.project((lambda x: x[..., 0], lambda x: x[..., 1]), V)
    ax = plotting.plot_field(u, title="u")
    coll = ax.collections[0]
    np.testing.assert_allclose(coll.get_array(), np.linalg.norm(mesh.points_np, axis=1),
                               atol=1e-12)
    assert ax.get_title() == "u"
    ax = plotting.plot_convergence([0.1, 0.05, 0.025], [[1.0, 0.25, 0.0625]],
                                   labels=["u"], expected_orders=[2])
    assert len(ax.get_lines()) == 2
    ax.figure.savefig(tmp_path / "c.png")
    plt.close("all")
    errors = {"u": np.array([[1.0, 0.25], [0.5, 0.125]])}
    orders = plotting.show_timeorder_info([0.1, 0.05], [8, 16], errors)
    text = capsys.readouterr().out
    jorders = jplot.show_timeorder_info([0.1, 0.05], [8, 16], errors)
    assert capsys.readouterr().out == text and "Mesh size 16" in text
    np.testing.assert_array_equal(orders["u"], jorders["u"])
    np.testing.assert_allclose(orders["u"], 2.0)
