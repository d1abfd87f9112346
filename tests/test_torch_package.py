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
                "fem.patchpack", "navier_stokes.patchfast"):
        assert f"flow_tpu_torch.{mod}" in out["modules"], mod
    assert out["foreign"] == []
    assert out["tf32"] == [False, False]


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
