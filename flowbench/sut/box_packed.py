"""The lid-driven cube on the box-packed projection stepper
(flow_tpu_torch.navier_stokes.boxfast.BoxPackedStepper)."""
from __future__ import annotations

import time

import torch


def build(cfg, settings, device):
    from flow_tpu_torch.models.cavity3d import Cavity3DProblem
    from flow_tpu_torch.navier_stokes.boxfast import BoxPackedStepper

    dtype = getattr(torch, cfg["dtype"])
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    prob = Cavity3DProblem(n=cfg["n"], rho=cfg["rho"], mu=cfg["mu"],
                           lid_speed=cfg["lid_speed"], dtype=dtype, device=device)
    sync()
    t1 = time.perf_counter()
    stepper = BoxPackedStepper(prob.V, prob.Q, prob.u_bcs, prob.p_bcs, prob.rho,
                               prob.mu, device=device, dtype=dtype, **settings)
    sync()
    t2 = time.perf_counter()
    n_dofs = 3 * prob.V.n_dofs + prob.Q.n_dofs
    return {"problem": prob, "stepper": stepper, "dof_points": prob.V.dof_points_np,
            "n_dofs": n_dofs, "setup": {"problem": t1 - t0, "stepper": t2 - t1}}
