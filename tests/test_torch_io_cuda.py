# State transfer and field output of flow_tpu_torch on the card against the
# CPU, float64: prolong_vector / restrict_vector of P1 and P2 vectors on the
# card bitwise equal to the CPU's along a two-level refine_uniform
# hierarchy; XDMFFile.write and write_checkpoint of card Functions give the
# CPU's files (the same XML text, equal datasets), read_checkpoint and
# read_mesh land on the card, and run_karman(writer=) hands the writer the
# card run's steps. Skips without a CUDA device, and the XDMF case without
# h5py.
# Imports no JAX, so it runs on the machine with the card:
#   python -m pytest --noconftest -q tests/test_torch_io_cuda.py
import numpy as np
import pytest
import torch

from flow_tpu_torch import (Function, FunctionSpace, VectorFunctionSpace, refine_uniform,
                            unit_square_mesh)
from flow_tpu_torch.fem import transfer
from flow_tpu_torch.io import XDMFFile

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the card runs of the transfer and I/O)")


def _meshes(device):
    meshes = [unit_square_mesh(6, diagonal="crossed", dtype=torch.float64, device=device)]
    for _ in range(2):
        meshes.append(refine_uniform(meshes[-1]))
    return meshes


@pytest.mark.parametrize("degree, vector", [(1, False), (2, False), (2, True)],
                         ids=["P1", "P2", "P2-vector"])
def test_card_transfer_equals_cpu(card, degree, vector):
    make = VectorFunctionSpace if vector else FunctionSpace
    S = {d: [make(m, degree) for m in _meshes(d)] for d in ("cpu", "cuda")}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((S["cpu"][0].n_dofs, 2) if vector else S["cpu"][0].n_dofs)
    xs = {d: torch.as_tensor(x, device=d) for d in S}
    for lvl in range(2):
        for d in S:
            xs[d] = transfer.prolong_vector(xs[d], S[d][lvl], S[d][lvl + 1])
        assert xs["cuda"].is_cuda
        assert torch.equal(xs["cuda"].cpu(), xs["cpu"])
    for lvl in (1, 0):
        for d in S:
            xs[d] = transfer.restrict_vector(xs[d], S[d][lvl + 1], S[d][lvl])
    assert torch.equal(xs["cuda"].cpu(), torch.as_tensor(x))


def test_card_xdmf_equals_cpu(card, tmp_path):
    h5py = pytest.importorskip("h5py", reason="XDMF output needs h5py (the io extra)")

    rng = np.random.default_rng(6)
    U = P = None
    for d in ("cpu", "cuda"):
        mesh = unit_square_mesh(4, dtype=torch.float64, device=d)
        V, Q = VectorFunctionSpace(mesh, 2), FunctionSpace(mesh, 1)
        if U is None:
            U, P = rng.standard_normal((V.n_dofs, 2)), rng.standard_normal(Q.n_dofs)
        (tmp_path / d).mkdir()
        u = Function(V, torch.as_tensor(U, device=d)).rename("velocity")
        p = Function(Q, torch.as_tensor(P, device=d)).rename("pressure")
        with XDMFFile(str(tmp_path / d / "out.xdmf")) as xf:
            xf.write(u, 0.0)
            xf.write(p, 0.0)
            xf.write_checkpoint(u, t=0.5)
            back, t = xf.read_checkpoint(V, "velocity")
        assert t == 0.5 and back.vector.device == u.vector.device
        assert torch.equal(back.vector, u.vector)
    assert ((tmp_path / "cpu" / "out.xdmf").read_text()
            == (tmp_path / "cuda" / "out.xdmf").read_text())
    with h5py.File(tmp_path / "cpu" / "out.h5") as a, h5py.File(tmp_path / "cuda" / "out.h5") as b:
        names = []
        a.visit(names.append)
        for k in names:
            if isinstance(a[k], h5py.Dataset):
                np.testing.assert_array_equal(a[k][...], b[k][...])
    m = XDMFFile(str(tmp_path / "cuda" / "out.xdmf")).read_mesh(dtype=torch.float64)
    assert m.device.type == "cuda" and m.n_points == mesh.n_points


class _Recorder:
    """A writer that keeps each written Function's name, time and host
    values (the machine with the card may lack h5py)."""

    def __init__(self):
        self.rows = []

    def write(self, fn, t=0.0):
        self.rows.append((fn.name, t, fn.vector.detach().cpu().numpy(), fn.vector.device))


def test_run_karman_writer_on_the_card(card):
    from flow_tpu_torch.models.karman import run_karman

    rec = _Recorder()
    out = run_karman(num_steps=2, lcar=0.2, dtype=torch.float64, writer=rec)
    assert out["u"].vector.is_cuda
    assert [(name, t) for name, t, _, _ in rec.rows] == [
        ("velocity", out["t"][0]), ("pressure", out["t"][0]),
        ("velocity", out["t"][1]), ("pressure", out["t"][1])]
    assert all(dev.type == "cuda" for *_, dev in rec.rows)
    np.testing.assert_array_equal(rec.rows[2][2], out["u"].vector.cpu().numpy())
    np.testing.assert_array_equal(rec.rows[3][2], out["p"].vector.cpu().numpy())
