"""CPU tests of the benchmark: the reference on hand-checked cases and
against the program at a tiny size, the trace arithmetic, K1's bound, a
cell added as files only, runs with the program broken underneath, the
refusal without a card, and the import rule.

    python -m pytest flowbench -q
"""
import ast
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flowbench import harness, yardstick
from flowbench.reference.check import NAMES, STEP_NAMES, Reference
from flowbench.reference.fem import SimplexP2

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def tiny(name):
    """The cell with its configuration cut to a CPU size."""
    cell, cfg = harness.load_cell(name)
    if cfg["problem"] == "karman":
        cfg.update(lcar=0.1, n_refine=1)
    else:
        cfg.update(n=3)
    cell.update(warmup_steps=3, profile_steps=1)
    return cell, cfg


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the import rule ----------------------------------------------------------------
def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        found = _imports(path) & set(harness.FORBIDDEN)
        assert not found, f"{path} imports {found}"
    for path in (BENCH / "reference").glob("*.py"):
        assert "flow_tpu_torch" not in _imports(path), path


# -- the reference by hand ------------------------------------------------------------
def _unit(n, k, dim=1):
    e = torch.zeros(n, dtype=torch.float64)
    e[k] = 1.0
    return e


@pytest.mark.parametrize("dim", [2, 3])
def test_reference_simplex_by_hand(dim):
    pts = np.vstack([np.zeros(dim), np.eye(dim)])
    fe = SimplexP2(pts, np.arange(dim + 1)[None], "cpu")
    vol = 0.5 if dim == 2 else 1.0 / 6.0
    # P1 stiffness of the reference simplex: vol * grad l_i . grad l_j
    dl = np.vstack([-np.ones(dim), np.eye(dim)])
    K = np.stack([fe.stiffness1(_unit(dim + 1, k)).numpy() for k in range(dim + 1)], 1)
    np.testing.assert_allclose(K, vol * dl @ dl.T, atol=1e-14)
    # the mass matrix integrates 1 to the volume, its diagonal as summed
    ones = torch.ones(fe.n2, dim, dtype=torch.float64)
    np.testing.assert_allclose(fe.mass(ones).sum(0).numpy(), vol, rtol=1e-13)
    assert float(fe.mass_diag().sum()) > 0
    # a quadratic field: div (x0^2, 0..) = 2 x0, grad div = (2, 0..)
    X = fe.dof_points
    u = torch.zeros(fe.n2, dim, dtype=torch.float64)
    u[:, 0] = X[:, 0] ** 2
    gd = fe.grad_div_cell(u, slice(0, 1))
    np.testing.assert_allclose(gd.numpy(), [[2.0] + [0.0] * (dim - 1)], atol=1e-12)
    # the convection term is skew: x . (A x - M x - viscous) = 0 for mu = 0
    g = torch.Generator().manual_seed(0)
    T = torch.randn(fe.n2, dim, generator=g, dtype=torch.float64)
    x = torch.randn(fe.n2, dim, generator=g, dtype=torch.float64)
    skew = fe.momentum(T, x, 0.3, 1.0, 0.0) - fe.mass(x)
    assert abs(float((x * skew).sum())) < 1e-13 * float(skew.abs().sum())
    # every dof of one simplex is on its boundary
    assert bool(fe.on_boundary2.all())


def test_reference_boundary_normals_point_out():
    pts = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    fe = SimplexP2(pts, np.array([[0, 1, 2], [1, 3, 2]]), "cpu")
    b = fe._boundary()
    mid = fe.points.mean(0)
    for k in range(len(fe.bcell)):
        cell = fe.points[fe.cells[fe.bcell[k]]]
        face_mid = (cell.sum(0) - cell[fe.blocal[k]]) / 2
        assert float(((face_mid - mid) * b["n"][k]).sum()) > 0
    assert len(fe.bcell) == 4


# -- the reference against the program ---------------------------------------------
TIGHT = {"newton_rtol": 1e-12, "pressure_rtol": 1e-12, "correction_rtol": 1e-12}


@pytest.mark.parametrize("name", ["karman-10m-bench", "cavity3d-n96-bench"])
def test_reference_agrees_with_the_program_in_float64(name):
    cell, cfg = tiny(name)
    cfg["dtype"] = "float64"
    settings = dict(cell["stepper"], **TIGHT)
    sut = harness.build(dict(cell, stepper=settings), cfg, "cpu")
    st = sut["stepper"]
    ref = Reference(cfg, "cpu")
    assert ref.attach(sut["dof_points"])
    g = torch.Generator().manual_seed(1)
    U = torch.randn(st.V_real.n_dofs, ref.dim, generator=g, dtype=torch.float64)
    U, P = st.to_packed_state(1e-3 * U, torch.zeros(st.Q_real.n_dofs, dtype=torch.float64))
    dt = cell["dt0"]
    for _ in range(4):
        (U, P, dt, _), step = harness.checked_step(st, U, P, dt, lambda: None)
        r = ref.readings(step, settings)
        for k in STEP_NAMES:
            assert r[k] < 1e-9, (k, r)


# -- the trace arithmetic and the yardstick ------------------------------------------
def test_trace_arithmetic():
    device = [("k1", 0.0, 10.0), ("k2", 5.0, 20.0), ("k1", 40.0, 50.0), ("copy", 80.0, 90.0)]
    host = [("cudaLaunchKernel", 0.0, 1.0), ("cudaLaunchKernel", 4.0, 5.0),
            ("cuLaunchKernel", 39.0, 40.0), ("aten::stack", 18.0, 45.0),
            ("aten::index", 21.0, 38.0), ("aten::item", 49.0, 85.0)]
    tr = yardstick.Trace(device, host, wall_s=100e-6)
    assert tr.busy == [[0.0, 20.0], [40.0, 50.0], [80.0, 90.0]]
    assert math.isclose(tr.busy_s, 40e-6)
    assert tr.launches == 3
    assert math.isclose(tr.device_seconds(lambda n: n == "k1"), 20e-6)
    assert tr.device_count(lambda n: n == "k1") == 2
    assert [n for n, _ in tr.top_ops()] == ["k1", "k2", "copy"]
    gaps = dict(tr.idle_gaps())
    # 20-40: aten::index covers 17 of it (inside aten::stack, which covers 20)
    assert math.isclose(gaps["aten::stack"], 20e-6)
    assert math.isclose(gaps["aten::item"], 30e-6)
    assert yardstick.merge([[3, 4], [1, 2], [2, 3]]) == [[1, 4]]


def test_k1_bound_by_grid():
    # 65^3 float32: x read and y written once, 27 coefficients: 0.656 us
    b = yardstick.stencil_bound_s((65, 65, 65))
    assert math.isclose(b, (8 * 65**3 + 4 * 27) / 3.35e12)
    assert math.isclose(b * 1e6, 0.6557, rel_tol=1e-3)
    # the bytes bound it: 54 operations a point at 67 TFLOP/s is less
    assert 54 * 65**3 / 67e12 < b
    ctx = {"trace": yardstick.Trace([("void stencil27_kernel<float>(...)", 0.0, 2.0)] * 2
                                    + [("other", 0.0, 5.0)], [], 1e-5),
           "grid_launches": {(65, 65, 65): 2, (1025, 1025): 7}}
    value = harness.metric_reader("k1_roofline")(ctx)
    assert math.isclose(value, 100 * 2 * b / 4e-6)
    ctx["grid_launches"] = {(65, 65, 65): 3}
    assert harness.metric_reader("k1_roofline")(ctx) is None


# -- the benchmark's files --------------------------------------------------------------
def test_benchmark_json_names_its_files():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert {m["name"] for m in spec["end_to_end"]} == {
        "steps_per_s", "sim_s_per_s", "peak_mem_gib", "setup_s"}
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert (BENCH / "reference" / f"{cfg['problem']}.py").exists()
    for w in spec["workloads"]:
        cell, _ = harness.load_cell(w["name"])
        assert cell["config"] == w["config"] and cell["chips"] == w["chips"]
        assert (BENCH / "sut" / f"{cell['system']}.py").exists()
        assert set(cell["limits"]) == set(NAMES)
        assert len(w["why"]) <= 200
    for m in spec["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()


# -- a cell, a configuration and a metric added as files only ----------------------------
def test_a_cell_added_as_files_only(tmp_path):
    shutil.copytree(BENCH, tmp_path / "flowbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "karman-10m.json").read_text())
    cfg.update(lcar=0.12, n_refine=1)
    (tmp_path / "flowbench" / "configs" / "karman-tiny.json").write_text(json.dumps(cfg))
    cell = json.loads((BENCH / "workloads" / "karman-10m-bench.json").read_text())
    cell.update(config="karman-tiny", warmup_steps=2, profile_steps=1)
    (tmp_path / "flowbench" / "workloads" / "karman-tiny-bench.json").write_text(
        json.dumps(cell))
    (tmp_path / "flowbench" / "metrics" / "window_steps.py").write_text(
        "def read(ctx):\n    return float(ctx['steps'])\n")
    spec["workloads"].append({"name": "karman-tiny-bench", "config": "karman-tiny",
                              "traffic": "bench", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "window_steps", "unit": "steps", "better": "higher",
                              "source": "program_counter", "layer": "time loop",
                              "moves": "steps_per_s", "workloads": ["karman-tiny-bench"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import sys, json; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
            "import torch; torch.set_num_threads(1)\n"
            "from flowbench import harness\n"
            "assert harness.ROOT == __import__('pathlib').Path(sys.argv[1])\n"
            "c, f = harness.load_cell('karman-tiny-bench')\n"
            "print(json.dumps(harness.run_cell('karman-tiny-bench', c, f, 7, 0.3, 1, 'cpu')))\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path), str(ROOT)],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["metrics"]["window_steps"]["value"] == result["attempted"]
    assert "assembly_gdof_s" not in result["metrics"]  # named for the 10M cell only
    assert list(result)[-1] == "checks"


# -- runs with the program broken underneath --------------------------------------------
def _unchanged(cls):
    plain = cls._step_impl

    def step(self, Uf, Pf, dt, *a, **kw):
        _, _, stats = plain(self, Uf, Pf, dt, *a, **kw)
        return Uf, Pf, stats

    return step


def _momentum_skipped(cls):
    plain = cls._mom_krylov

    def mom_krylov(self, *a):
        dx, info = plain(self, *a)
        return torch.zeros_like(dx), info

    return mom_krylov


def _altered(cls):
    plain = cls._correction

    def correction(self, *a):
        U1, info = plain(self, *a)
        return U1 * 1.01, info

    return correction


@pytest.mark.parametrize("name,cls", [
    ("karman-10m-bench", "flow_tpu_torch.navier_stokes.patchfast.PackedPatchStepper"),
    ("cavity3d-n96-bench", "flow_tpu_torch.navier_stokes.boxfast.BoxPackedStepper")])
@pytest.mark.parametrize("fault", [None, "unchanged", "momentum_skipped", "altered"])
def test_a_broken_step_is_not_correct(name, cls, fault, monkeypatch):
    mod, _, attr = cls.rpartition(".")
    klass = getattr(harness.importlib.import_module(mod), attr)
    plant = {"unchanged": ("_step_impl", _unchanged),
             "momentum_skipped": ("_mom_krylov", _momentum_skipped),
             "altered": ("_correction", _altered)}
    if fault:
        method, broken = plant[fault]
        monkeypatch.setattr(klass, method, broken(klass))
    cell, cfg = tiny(name)
    result = harness.run_cell(name, cell, cfg, 2**31 + 99, 0.3, 0, "cpu")
    assert result["correct"] is (fault is None), result["checks"]
    if fault == "momentum_skipped":
        # Ui = x0: the residual is the starting one, read as 1 to float32
        for when in ("first", "last"):
            value = result["checks"][f"{when}_momentum_res"]["value"]
            assert math.isclose(value, 1.0, rel_tol=1e-6), result["checks"]


def test_a_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "karman-10m-bench", "--seed", "3", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
