# flow_tpu_torch as a package: it, chip_smoke.py and scripts/torch_*.py
# import neither jax nor flow_tpu, it switches TF32 off, and chip_smoke.py
# refuses to run without a CUDA device or outside the repository.
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

torch.set_num_threads(1)

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import flow_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(flow_tpu_torch.__path__, "flow_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import torch
print(json.dumps({
    "modules": mods,
    "foreign": sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "flow_tpu")),
    "optional": sorted(m for m in ("h5py", "matplotlib") if m in sys.modules),
    "tf32": [torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32],
}))
"""


def _python(code, cwd):
    return subprocess.run(
        [sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
        timeout=300,
    )


def test_port_imports_no_jax_and_turns_tf32_off():
    proc = _python(_IMPORT_ALL, ROOT)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for mod in ("navier_stokes.boxfast", "navier_stokes.fast", "interop",
                "attic.winmom", "attic.winkernel", "attic.window",
                "solvers.multigrid", "models.karman", "models.cavity3d",
                "native", "mesh", "fem.formlang", "attic.winform", "ops.stencil",
                "ops.structured", "solvers.structured_mg", "fem.patch",
                "fem.patchpack", "navier_stokes.patchfast", "message",
                "utils.config", "utils.timestep", "fem.interpolate",
                "fem.gathersum", "navier_stokes.pressure_correction",
                "navier_stokes.packedapi", "stabilization", "parabolic",
                "solvers.shifted_mg", "heat", "models.boussinesq", "stokes",
                "models.boussinesq3d", "experimental.ab2tr", "fem.packed",
                "navier_stokes.patchctx", "solvers.patch_mg",
                "navier_stokes.diffstep", "parallel", "parallel.comm",
                "parallel.pc_context_shared", "parallel.packed_shard",
                "parallel.domain", "parallel.halo", "parallel.halo_step",
                "parallel.cases", "attic.halo_win", "fem.transfer", "io.xdmf",
                "io.msh", "io.dolfin_xml", "io.checkpoint", "utils.metrics",
                "utils.profiling", "utils.expression", "utils.plotting"):
        assert f"flow_tpu_torch.{mod}" in out["modules"], mod
    assert out["foreign"] == []
    # the io and plot extras load where a file is opened or a plot drawn
    assert out["optional"] == []
    assert out["tf32"] == [False, False]


def test_public_surface_and_unported_names():
    import flow_tpu_torch
    from flow_tpu_torch import stokes
    from flow_tpu_torch.experimental import ab2tr
    from flow_tpu_torch.models import boussinesq3d

    for name in ("message", "project", "interpolate", "errornorm", "norm",
                 "FunctionSpace", "VectorFunctionSpace", "Function",
                 "DirichletBC", "navier_stokes", "heat", "stabilization",
                 "parabolic", "materials", "unit_square_mesh", "refine_uniform",
                 "rectangle_with_hole_mesh"):
        assert hasattr(flow_tpu_torch, name), name
    for name in ("Chorin", "IPCS", "Rotational", "FastStepper", "DiffStepper"):
        assert hasattr(flow_tpu_torch.navier_stokes, name), name
    # every slice of the JAX package now runs: run_karman's writer too
    # (tests/test_torch_fast.py::test_unported_routes_raise holds it)
    import inspect

    from flow_tpu_torch.models.karman import run_karman
    from flow_tpu_torch.solvers import krylov

    assert callable(stokes.solve) and callable(boussinesq3d.compute_boussinesq_3d)
    assert callable(ab2tr.AB2TR) and stokes.DENSE_THRESHOLD == 20000
    assert "NotImplementedError" not in inspect.getsource(run_karman)
    b = torch.ones(3, dtype=torch.float64)
    # GMRES's reduced-precision basis (ROADMAP queue 1 item 5) now runs
    x, info = krylov.gmres(lambda x: x, b, basis_dtype=torch.float32)
    assert bool(info.converged) and torch.allclose(x, b)
    # the new entry points default to the card: without one they raise
    if not torch.cuda.is_available():
        for call in (lambda: boussinesq3d.compute_boussinesq_3d(0.0, n=(2, 2, 2)),
                     lambda: run_karman(1, lcar=0.2)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


def test_readme_sample_runs_on_the_port():
    import flow_tpu_torch
    from flow_tpu_torch import (DirichletBC, FunctionSpace, VectorFunctionSpace,
                                project, unit_square_mesh)

    mesh = unit_square_mesh(8, diagonal="crossed", dtype=torch.float64, device="cpu")
    V, Q = VectorFunctionSpace(mesh, 2), FunctionSpace(mesh, 1)
    u0 = project((0.0, 0.0), V)
    p0 = project(0.0, Q)
    u_bcs = [DirichletBC(V, (0.0, 0.0), "on_boundary")]
    stepper = flow_tpu_torch.navier_stokes.IPCS()
    u1, p1 = stepper.step(1e-2, {0: u0}, p0, u_bcs, [], rho=1.0, mu=1e-3,
                          f={0: (0.0, -9.81), 1: (0.0, -9.81)}, verbose=False)
    assert bool(torch.isfinite(u1.vector).all())
    # the pressure takes up the gravity: rho g over the unit height
    assert 9.0 < float(p1.vector.max() - p1.vector.min()) < 11.0


def test_port_sources_name_no_jax():
    paths = [*(ROOT / "flow_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py",
             *(ROOT / "scripts").glob("torch_*.py")]
    assert len(paths) > 40
    for path in paths:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in ("jax", "flow_tpu"), (
                    f"{path}: {line}"
                )


def test_chip_smoke_refuses_without_cuda_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal is for machines without one")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_parallel_exports_the_jax_names_and_imports_no_jax():
    import ast

    import flow_tpu_torch.parallel as par

    tree = ast.parse((ROOT / "flow_tpu" / "parallel" / "__init__.py").read_text())
    names = [a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
             for a in node.names]
    assert names and all(hasattr(par, n) for n in names), names
    paths = [*(ROOT / "flow_tpu_torch" / "parallel").glob("*.py"),
             ROOT / "flow_tpu_torch" / "attic" / "halo_win.py"]
    assert len(paths) >= 8
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                    else [])
            for m in mods:
                assert m.split(".")[0] not in ("jax", "jaxlib", "flow_tpu"), (path, m)


def _imported_names(path):
    """The names a package __init__ binds by its `from ... import` lines."""
    import ast

    tree = ast.parse(path.read_text())
    return [a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
            for a in node.names]


@pytest.mark.parametrize("package", ["", "io", "utils", "fem"])
def test_exports_the_jax_names(package):
    # every name the JAX package's __init__ binds, but the one config that
    # nothing reads (utils.config.BenchmarkConfig)
    import importlib

    import flow_tpu_torch

    jax_init = ROOT / "flow_tpu" / package / "__init__.py"
    port = importlib.import_module("flow_tpu_torch" + (f".{package}" if package else ""))
    names = [n for n in _imported_names(jax_init) if n != "BenchmarkConfig"]
    assert len(names) >= 4
    missing = [n for n in names if not hasattr(port, n)]
    assert missing == [], missing
    if not package:
        assert flow_tpu_torch.__version__ == "0.1.0"
        for n in ("io", "utils", "native", "mesh3d", "experimental", "read_msh", "TetMesh",
                  "box_mesh", "refine_uniform_tet"):
            assert n in flow_tpu_torch.__all__, n
    # modules where the JAX name is a module are modules in the port too
    for n in names:
        jax_side = (ROOT / "flow_tpu" / package / f"{n}.py").is_file()
        port_side = (ROOT / "flow_tpu_torch" / package / f"{n}.py").is_file()
        assert jax_side <= port_side, n


@pytest.mark.parametrize("module", ["materials", "mesh", "mesh3d", "fem.spaces", "fem.ell",
                                    "fem.transfer", "io.msh", "io.xdmf", "io.dolfin_xml",
                                    "utils.metrics", "utils.profiling", "utils.expression",
                                    "utils.plotting", "utils.timestep"])
def test_module_all_covers_the_jax_all(module):
    import ast
    import importlib

    tree = ast.parse((ROOT / "flow_tpu" / (module.replace(".", "/") + ".py")).read_text())
    jax_all = next(ast.literal_eval(node.value) for node in tree.body
                   if isinstance(node, ast.Assign)
                   and getattr(node.targets[0], "id", None) == "__all__")
    port = importlib.import_module(f"flow_tpu_torch.{module}")
    assert set(jax_all) <= set(port.__all__), set(jax_all) - set(port.__all__)
    assert all(hasattr(port, n) for n in port.__all__)


def test_every_jax_module_has_a_counterpart():
    # a module of the JAX package is ported at its relative path, or its
    # counterpart is named here, or it is a TPU workaround that ROADMAP's
    # "Not ported" list drops
    renamed = {"ops/pallas_stencil.py": "ops/stencil.py"}
    not_ported = {"utils/hoist.py", "utils/hostsetup.py", "utils/winguard.py"}
    for path in sorted((ROOT / "flow_tpu").rglob("*.py")):
        rel = path.relative_to(ROOT / "flow_tpu").as_posix()
        if rel in not_ported:
            assert rel in (ROOT / "ROADMAP.md").read_text(), rel
            continue
        assert (ROOT / "flow_tpu_torch" / renamed.get(rel, rel)).is_file(), rel
