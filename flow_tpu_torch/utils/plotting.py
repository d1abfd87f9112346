# Visualisation helpers. Port of flow_tpu/utils/plotting.py: the
# counterpart of the reference's matplotlib debug plots (log-log
# convergence panels, show_timeorder_info, dolfin's plot(u) field view).
# Fields are copied to the host; matplotlib is imported where a plot is
# drawn (the `plot` extra).
from __future__ import annotations

import numpy as np
import torch

__all__ = ["plot_field", "plot_convergence", "show_timeorder_info"]


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def plot_field(fn, ax=None, title=None, cmap="viridis", shading="gouraud"):
    """Pseudocolor plot of a scalar FE Function (vector fields: magnitude)
    on its triangulation. Returns the matplotlib axis."""
    import matplotlib.pyplot as plt
    import matplotlib.tri as mtri

    space = fn.space
    mesh = space.mesh
    assert getattr(mesh, "dim", 2) == 2, "plot_field is 2-D only"
    tri = mtri.Triangulation(
        mesh.points_np[:, 0], mesh.points_np[:, 1], mesh.cells_np
    )
    v = _host(fn.vector[: mesh.n_points])  # P2: vertex values suffice for display
    if v.ndim == 2:
        v = np.linalg.norm(v, axis=1)
    if ax is None:
        _, ax = plt.subplots()
    tpc = ax.tripcolor(tri, v, cmap=cmap, shading=shading)
    ax.figure.colorbar(tpc, ax=ax)
    ax.set_aspect("equal")
    if title:
        ax.set_title(title)
    return ax


def plot_convergence(hs, errors, labels=None, expected_orders=range(5), ax=None):
    """log-log error-vs-h plot with grey order guide lines (the
    reference's show_errors pattern)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    hs = np.asarray(hs, dtype=float)
    errors = np.atleast_2d(np.asarray(errors, dtype=float))
    labels = labels or [f"series {i}" for i in range(len(errors))]
    e0 = errors[0][0]
    for o in expected_orders:
        ax.loglog(
            [hs[0], hs[-1]], [e0, e0 * (hs[-1] / hs[0]) ** o], color="0.7"
        )
    for e, lab in zip(errors, labels):
        ax.loglog(hs, e, "-o", label=lab)
    ax.set_xlabel("h (or dt)")
    ax.set_ylabel("error")
    ax.legend()
    return ax


def show_timeorder_info(Dt, mesh_sizes, errors):
    """Print the error and observed-order table of a (mesh x dt) sweep, the
    debugging companion of the MMS order tests; returns the orders."""
    Dt = np.asarray(Dt, dtype=float)
    orders = {
        key: np.array(
            [
                np.log(e[:, k] / e[:, k + 1]) / np.log(Dt[k] / Dt[k + 1])
                for k in range(len(Dt) - 1)
            ]
        ).T
        for key, e in ((k, np.asarray(v)) for k, v in errors.items())
    }
    for i, n in enumerate(mesh_sizes):
        print(f"\nMesh size {n}:")
        print(f"dt = {Dt[0]:e}")
        for label, e in errors.items():
            print(f"   err_{label} = {np.asarray(e)[i][0]:e}")
        for j in range(len(Dt) - 1):
            for label, o in orders.items():
                print(f"   ord_{label} = {o[i][j]:e}")
            print(f"dt = {Dt[j + 1]:e}")
            for label, e in errors.items():
                print(f"   err_{label} = {np.asarray(e)[i][j + 1]:e}")
    return orders
