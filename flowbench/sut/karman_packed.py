"""The Karman channel on the packed-patch projection stepper
(flow_tpu_torch.navier_stokes.patchfast.PackedPatchStepper)."""
from __future__ import annotations

import time

import torch


def build(cfg, settings, device):
    from flow_tpu_torch.fem.patch import build_patch_info
    from flow_tpu_torch.models.karman import KarmanProblem
    from flow_tpu_torch.navier_stokes.patchfast import PackedPatchStepper

    g = cfg["geometry"]
    dtype = getattr(torch, cfg["dtype"])
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    prob = KarmanProblem(
        lcar=cfg["lcar"], n_refine=cfg["n_refine"], mu=cfg["mu"], rho=cfg["rho"],
        x0=g["x0"], x1=g["x1"], y0=g["y0"], y1=g["y1"], center=tuple(g["center"]),
        diameter=g["diameter"], u_in=g["u_in"], dtype=dtype, device=device)
    sync()
    t1 = time.perf_counter()
    stepper = PackedPatchStepper(prob.V, prob.Q, prob.u_bcs, prob.p_bcs, prob.rho,
                                 prob.mu, build_patch_info(prob.mesh_hierarchy),
                                 device=device, dtype=dtype, **settings)
    sync()
    t2 = time.perf_counter()
    return {"problem": prob, "stepper": stepper, "dof_points": prob.V.dof_points_np,
            "n_dofs": prob.n_dofs, "setup": {"problem": t1 - t0, "stepper": t2 - t1}}
