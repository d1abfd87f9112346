# The distributed problems the CPU parity tests and chip_smoke.py run, as
# rank jobs for comm.launch: every rank calls run_cases(cases, device) with
# the same list, each case builds its problem from a small spec, drives one
# distributed stepper through its public entry points and returns plain
# numpy results (the global state, gathered on every rank, and the solver
# counts), so that a caller compares them with a reference without holding
# the ranks. A case with "ranks": k < world runs on the subgroup of ranks
# 0..k-1 (the others return None).
#
# Specs (the JAX tests' problems):
#   {"problem": "karman", "lcar", "n_refine"}     KarmanProblem
#   {"problem": "lid", "n0", "n_refine", "diagonal"}  unit square, lid-driven
#        (no-slip walls only with "noslip"), refined n_refine times (the
#        chain is the multigrid hierarchy)
#   {"problem": "box", "n": (nx, ny, nz), "x1": 4.0}  a box of tets, lid on z=1
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from . import comm

__all__ = ["run_cases", "build_problem"]


def _dtype(name):
    return {"float64": torch.float64, "float32": torch.float32}[name]


def build_problem(spec, dtype=torch.float64):
    """spec -> SimpleNamespace(V, Q, u_bcs, p_bcs, rho, mu, meshes), on the
    CPU (the steppers move their tables to their device)."""
    from types import SimpleNamespace

    from ..fem.bc import DirichletBC
    from ..fem.spaces import FunctionSpace, VectorFunctionSpace
    from ..mesh import refine_uniform, unit_square_mesh

    kind = spec["problem"]
    if kind == "karman":
        from ..models.karman import KarmanProblem

        p = KarmanProblem(lcar=spec["lcar"], n_refine=spec["n_refine"], device="cpu",
                          dtype=dtype)
        return SimpleNamespace(V=p.V, Q=p.Q, u_bcs=p.u_bcs, p_bcs=p.p_bcs, rho=p.rho,
                               mu=p.mu, meshes=list(p.mesh_hierarchy))
    if kind == "lid":
        meshes = [unit_square_mesh(spec["n0"], diagonal=spec.get("diagonal", "left"),
                                   dtype=dtype, device="cpu")]
        for _ in range(spec.get("n_refine", 0)):
            meshes.append(refine_uniform(meshes[-1]))
        V = VectorFunctionSpace(meshes[-1], 2)
        Q = FunctionSpace(meshes[-1], 1)

        def lid(x):
            return np.where(x[:, 1] > 1 - 1e-12, 1.0, 0.0)

        u_bcs = [DirichletBC(V.sub(0), lid), DirichletBC(V.sub(1), 0.0)]
        if spec.get("noslip"):
            u_bcs = [DirichletBC(V, (0.0, 0.0), "on_boundary")]
        return SimpleNamespace(V=V, Q=Q, u_bcs=u_bcs, p_bcs=[], rho=1.0,
                               mu=spec.get("mu", 0.1), meshes=meshes)
    if kind == "box":
        from ..mesh3d import box_mesh

        nx, ny, nz = spec["n"]
        mesh = box_mesh((0, 0, 0), (spec.get("x1", 4.0), 1, 1), nx, ny, nz,
                        dtype=dtype, device="cpu")
        V = VectorFunctionSpace(mesh, 2, n_components=3)
        Q = FunctionSpace(mesh, 1)

        def lid(x):
            return np.where(x[:, 2] > 1 - 1e-12, 1.0, 0.0)

        u_bcs = [DirichletBC(V.sub(0), lid), DirichletBC(V.sub(1), 0.0),
                 DirichletBC(V.sub(2), 0.0)]
        return SimpleNamespace(V=V, Q=Q, u_bcs=u_bcs, p_bcs=[], rho=1.0,
                               mu=spec.get("mu", 0.1), meshes=[mesh])
    raise ValueError(f"unknown problem {kind!r}")


def _np(t):
    return t.detach().cpu().numpy()


def _packed(case, prob, group, device):
    from ..fem.patch import build_patch_info
    from ..interop import load_hierarchy_lmax
    from .packed_shard import ShardedPackedStepper

    info = build_patch_info(prob.meshes)
    sh = ShardedPackedStepper(prob.V, prob.Q, prob.u_bcs, prob.p_bcs, prob.rho,
                              prob.mu, info, group=group, device=device,
                              **case.get("kw", {}))
    if case.get("lmax") is not None:
        load_hierarchy_lmax(sh.hierarchy, case["lmax"])
    base = sh.base
    dt, n_run = case.get("dt", 1e-3), case.get("n_run", 0)
    out = {"seam_stats": sh.seam_stats}
    U0, P0 = prob.V.zeros(), prob.Q.zeros()
    Us, Ps = sh.to_sharded(U0, P0)
    if case.get("step", True):
        U1s, P1s, st = sh.step(Us, Ps, dt)
        U1, P1 = sh.from_sharded(U1s, P1s)
        out["step"] = (_np(U1), _np(P1), _counts(st))
        Uf, Pf = base.zeros()
        U1f, P1f, sb = base.step(Uf, Pf, dt)
        U1b, P1b = base.from_packed_state(U1f, P1f)
        out["base_step"] = (_np(U1b), _np(P1b), _counts(sb))
    if n_run:
        U3s, P3s, dts, tel = sh.run(Us, Ps, dt, n_run)
        U3, P3 = sh.from_sharded(U3s, P3s)
        out["run"] = (_np(U3), _np(P3), float(dts), _tel(tel))
        Uf, Pf = base.zeros()
        res = base.run(Uf, Pf, dt, n_run)
        U3b, P3b = base.from_packed_state(res[0], res[1])
        out["base_run"] = (_np(U3b), _np(P3b), float(res[2]), _tel(res[3]))
    return out


def _counts(st):
    return {k: int(getattr(st, k)) for k in ("linear_iters", "pressure_iters",
                                             "correction_iters")}


def _tel(tel):
    return {k: _np(v) if isinstance(v, torch.Tensor) else v for k, v in tel.items()}


def _projection(case, prob, group, device):
    from ..fem.interpolate import project
    from .domain import ShardedProjection

    sp = ShardedProjection(prob.V, prob.Q, prob.u_bcs, prob.p_bcs, prob.rho, prob.mu,
                           group=group, device=device, **case.get("kw", {}))
    U0 = project(tuple([0.0] * prob.V.n_components), prob.V).vector.to(device)
    if "p0_gy" in case:  # hydrostatic pressure g*y
        P0 = project(lambda x: case["p0_gy"] * x[..., 1], prob.Q).vector.to(device)
    else:
        P0 = torch.zeros(prob.Q.n_dofs, dtype=prob.V.mesh.dtype, device=device)
    Fq = None
    if sp.with_force:
        from ..fem.assembly import geometry, tabulation

        xq = geometry(prob.V.mesh).physical_points(tabulation(prob.V, sp.force_rule).ref_pts)
        F = np.zeros(xq.shape[:2] + (2,))
        F[:, :, 1] = case["p0_gy"]
        Fq = sp.pack_force(F)
    U1, P1, Ui = sp(U0, P0, case.get("dt", 1e-2), Fq=Fq)
    return {"U1": _np(U1), "P1": _np(P1), "Ui": _np(Ui)}


def _halo_poisson(case, prob, group, device):
    from ..fem.spaces import FunctionSpace
    from .halo import HaloPoisson

    S = FunctionSpace(prob.V.mesh, 1)
    b = np.random.default_rng(case.get("seed", 0)).standard_normal(S.n_dofs)
    if case["neumann"]:
        b = b - b.mean()
        bc = None
    else:
        m = np.zeros(S.n_dofs)
        m[S.boundary_dofs()] = 1.0
        bc = torch.as_tensor(m)
        b = (1.0 - m) * b
    hp = HaloPoisson(prob.V.mesh, bc_mask=bc, group=group, device=device)
    x, iters = hp.solve(torch.as_tensor(b, dtype=prob.V.mesh.dtype),
                        rtol=case.get("rtol", 1e-12), maxiter=case.get("maxiter", 5000))
    return {"x": _np(x), "iters": int(iters), "b": b}


def _halo_step(case, prob, group, device):
    from ..interop import load_hierarchy_lmax
    from .halo_step import HaloProjection

    kw = dict(case.get("kw", {}))
    if case.get("mg"):
        kw["mesh_hierarchy"] = prob.meshes
    hp = HaloProjection(prob.V, prob.Q, prob.u_bcs, prob.p_bcs, prob.rho, prob.mu,
                        group=group, device=device, **kw)
    if case.get("lmax") is not None:
        fine, coarse = case["lmax"]
        hp.set_fine_lmax(fine)
        load_hierarchy_lmax(hp._mg["coarse"], coarse)
    dt = case.get("dt", 1e-2)
    Up = hp.Vh.to_partitioned(prob.V.zeros())
    Pp = hp.Qh.to_partitioned(prob.Q.zeros())
    out = {}
    if case.get("n_run"):
        res = hp.run(Up, Pp, dt, case["n_run"])
        out["run"] = (_np(hp.Vh.from_partitioned(res[0])),
                      _np(hp.Qh.from_partitioned(res[1])), float(res[2]), _tel(res[3]))
    steps = []
    for _ in range(case.get("n_steps", 1)):
        Up, Pp = hp.step(Up, Pp, dt)
        steps.append((_np(hp.Vh.from_partitioned(Up)), _np(hp.Qh.from_partitioned(Pp))))
    out["steps"] = steps
    return out


# -- the card phases (chip_smoke.py): the paths at full size, timed -----------
def _hand_kernels():
    """Every hand kernel's launch counter (flow_tpu_torch._build.Kernel)."""
    from .._build import Kernel
    from ..attic import winform, winkernel, winmom
    from ..fem import ell
    from ..ops import stencil

    return {name: k for mod in (stencil, ell, winmom, winkernel, winform)
            for name, k in vars(mod).items() if isinstance(k, Kernel)}


class _Launches:
    """The hand kernels' launches over a block: every count set to 0 on
    entry, read on exit (only those that launched)."""

    def __enter__(self):
        self.kernels = _hand_kernels()
        for k in self.kernels.values():
            k.launches = 0
        return self

    def __exit__(self, *exc):
        self.counts = {n: k.launches for n, k in self.kernels.items() if k.launches}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profile(fn, device):
    """One call of fn under torch.profiler -> {events: device kernel events,
    device_us: their device time, nccl_us: the device time of NCCL's
    kernels}; None off the card."""
    if device.type != "cuda":
        fn()
        return None
    from torch.profiler import ProfilerActivity, profile

    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        _sync(device)
    ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"events": len(ev),
            "device_us": float(sum(e.device_time_total for e in ev)),
            "nccl_us": float(sum(e.device_time_total for e in ev
                                 if "nccl" in e.name.lower()))}


class _Collectives:
    """comm's collective calls over a block, by kind."""

    def __enter__(self):
        for k in comm.CALLS:
            comm.CALLS[k] = 0
        return self

    def __exit__(self, *exc):
        self.counts = dict(comm.CALLS)


def _collective_us(device, group, calls=200):
    """Host µs a call of a 0-d all_reduce_sum, enqueued back to back, then
    one synchronisation: what an inner product's reduction costs."""
    import time

    x = torch.zeros((), device=device)
    comm.all_reduce_sum(x, group)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(calls):
        comm.all_reduce_sum(x, group)
    _sync(device)
    return 1e6 * (time.perf_counter() - t0) / calls


def _peak(device):
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def _packed_main(case, prob, group, device):
    """The sharded packed stepper at a case's size: 1 warm-up step and
    n_steps - 1 timed steps from rest, then one profiled step."""
    import time

    from ..fem.patch import build_patch_info
    from .packed_shard import ShardedPackedStepper

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    sh = ShardedPackedStepper(prob.V, prob.Q, prob.u_bcs, prob.p_bcs, prob.rho, prob.mu,
                              build_patch_info(prob.meshes), group=group, device=device,
                              dtype=prob.V.mesh.dtype, **case.get("kw", {}))
    _sync(device)
    setup = time.perf_counter() - t0
    n = case["n_steps"]
    with _Launches() as launches:
        Us, Ps = sh.to_sharded(prob.V.zeros(), prob.Q.zeros())
        Us, Ps, dt, tel_w = sh.run(Us, Ps, case["dt"], 1)
        _sync(device)
        t0 = time.perf_counter()
        with _Collectives() as coll:
            Us, Ps, dt, tel = sh.run(Us, Ps, dt, n - 1)
            _sync(device)
        elapsed = time.perf_counter() - t0
    peak = _peak(device)
    coll_us = _collective_us(device, group)
    prof = _profile(lambda: sh.step(Us, Ps, dt), device)
    U, P = sh.from_sharded(Us, Ps)
    keys = ("linear_iters", "pressure_iters", "correction_iters", "momentum_converged",
            "pressure_converged", "correction_converged")
    return {"n_dofs": 2 * prob.V.n_dofs + prob.Q.n_dofs, "setup_s": setup,
            "steps_per_s": (n - 1) / elapsed, "peak_bytes": peak, "profile": prof,
            "tel": {k: _np(tel_w[k]).tolist() + _np(tel[k]).tolist() for k in keys},
            "finite": bool(torch.isfinite(U).all() and torch.isfinite(P).all()),
            "umax": float(U.abs().max()), "launches": launches.counts,
            "seam_stats": sh.seam_stats, "local_slots": sh.local.pp.n2,
            "collectives_per_step": {k: v / (n - 1) for k, v in coll.counts.items()},
            "all_reduce_host_us": coll_us}


def _halo_main(case, prob, group, device):
    """HaloProjection at a case's size on each route of case["routes"]
    ((winkernel, convection) pairs; one stepper a winkernel value, its
    convection switched between runs): 1 warm-up step and n_steps - 1
    timed steps from rest, the hand kernels' launches of the run, then
    one profiled step."""
    import time

    from .halo_step import HaloProjection

    out, built = {}, {}
    for win, conv in case["routes"]:
        if win not in built:
            built.clear()
            t0 = time.perf_counter()
            kw = dict(case.get("kw", {}))
            if case.get("mg"):
                kw["mesh_hierarchy"] = prob.meshes
            built[win] = HaloProjection(prob.V, prob.Q, prob.u_bcs, prob.p_bcs, prob.rho,
                                        prob.mu, group=group, device=device,
                                        winkernel=win, **kw)
            _sync(device)
            setup = time.perf_counter() - t0
        hp = built[win]
        hp.lagged = conv == "lagged"
        n = case["n_steps"]
        with _Launches() as launches:
            Up = hp.Vh.to_partitioned(prob.V.zeros())
            Pp = hp.Qh.to_partitioned(prob.Q.zeros())
            Up, Pp, dt, tel_w = hp.run(Up, Pp, case["dt"], 1)
            _sync(device)
            t0 = time.perf_counter()
            with _Collectives() as coll:
                Up, Pp, dt, tel = hp.run(Up, Pp, dt, n - 1)
                _sync(device)
            elapsed = time.perf_counter() - t0
        check = _window_check(hp, Up, dt) if win else None
        prof = _profile(lambda: hp.step(Up, Pp, dt), device)
        U = hp.Vh.from_partitioned(Up)
        out[f"{'window' if win else 'einsum'} {conv}"] = {
            "kernel_check": check,
            "setup_s": setup, "s_per_step": elapsed / (n - 1), "profile": prof,
            "tel": {k: _np(tel_w[k]).tolist() + _np(tel[k]).tolist()
                    for k in ("pressure_iters", "correction_iters")},
            "finite": bool(torch.isfinite(U).all()), "umax": float(U.abs().max()),
            "launches": launches.counts, "peak_bytes": _peak(device),
            "collectives_per_step": {k: v / (n - 1) for k, v in coll.counts.items()}}
    return out


def _window_check(hp, Up, dt):
    """K3 at this rank's halo layout, against its plain version on the same
    inputs (the step's own transport or Newton tables at the state Up):
    (max |kernel - plain|, max |plain|). On the CPU both are the plain
    version."""
    from ..attic.halo_win import halo_state_q, halo_transport_q
    from ..attic.winmom import momentum_windows_plain
    from .halo_step import _fwd

    meta, t, sm, tab = hp._win
    x_ext = _fwd(Up, hp.Vh, hp.group)
    if hp.lagged:
        Tq = halo_transport_q(meta, tab, t["cells"], hp.Vl.cell_dofs, x_ext)
        Uq = Gu = None
    else:
        Tq, Uq, Gu = halo_state_q(meta, tab, t["cells"], hp.Vl.cell_dofs, hp.geom.G, x_ext)
    gen = torch.Generator().manual_seed(0)
    v = torch.randn((meta["DIM"], meta["n_ext"]), generator=gen).to(x_ext.device)
    xp = torch.zeros((meta["DIM"], meta["n_pad"]), dtype=torch.float32,
                     device=x_ext.device)
    xp[:, :meta["n_ext"]] = v[:, t["perm"]]
    s = float(dt) / hp.rho
    scal = torch.tensor([1.0, s * hp.rho, s * hp.mu], dtype=torch.float32,
                        device=x_ext.device)
    args = (t["lidx"], t["valid"], t["detj"], t["g4"], t["cg4"], Tq, sm, scal, meta["S"],
            meta["W"])
    plain = momentum_windows_plain(xp, *args, Uq=Uq, Gu=Gu)
    launch = t.get("launch")
    kernel = plain if launch is None else launch(xp, Tq, scal, Uq, Gu)
    return (float((kernel - plain).abs().max()), float(plain.abs().max()))


def _projection_main(case, prob, group, device):
    """ShardedProjection one step from rest, and HaloPoisson one solve of
    its pressure space's Laplacian (a seeded right-hand side)."""
    import time

    from .domain import ShardedProjection
    from .halo import HaloPoisson

    res = {}
    t0 = time.perf_counter()
    sp = ShardedProjection(prob.V, prob.Q, prob.u_bcs, prob.p_bcs, prob.rho, prob.mu,
                           group=group, device=device, **case.get("kw", {}))
    _sync(device)
    t1 = time.perf_counter()
    U1, P1, _ = sp(prob.V.zeros().to(device), prob.Q.zeros().to(device), case["dt"])
    _sync(device)
    res["projection"] = {"setup_s": t1 - t0, "step_s": time.perf_counter() - t1,
                         "finite": bool(torch.isfinite(U1).all() and torch.isfinite(P1).all()),
                         "umax": float(U1.abs().max())}
    mesh = prob.Q.mesh
    b = np.random.default_rng(0).standard_normal(prob.Q.n_dofs)
    t0 = time.perf_counter()
    hp = HaloPoisson(mesh, bc_mask=None, group=group, device=device)
    _sync(device)
    t1 = time.perf_counter()
    x, iters = hp.solve(torch.as_tensor(b - b.mean(), dtype=mesh.dtype),
                        rtol=case["poisson_rtol"], maxiter=case["poisson_maxiter"])
    _sync(device)
    res["poisson"] = {"setup_s": t1 - t0, "solve_s": time.perf_counter() - t1,
                      "iters": int(iters), "finite": bool(torch.isfinite(x).all())}
    return res


_KINDS = {"packed": _packed, "projection": _projection,
          "halo_poisson": _halo_poisson, "halo_step": _halo_step,
          "packed_main": _packed_main, "halo_main": _halo_main,
          "projection_main": _projection_main}


def parity_cases():
    """Small float64 cases of the four distributed steppers, for the
    card-against-CPU checks: the packed stepper (Kármán lcar=0.2 n_refine=2,
    BiCGStab, tight tolerances, 3 steps), ShardedProjection and
    HaloPoisson on the crossed lid square, HaloProjection's einsum route
    with the multigrid (lid square refined once, BDF2, 3 steps) and its
    window route (lagged and Newton, 2 steps)."""
    tight = dict(newton_tol=1e-12, newton_rtol=0.0, pressure_rtol=1e-11,
                 correction_rtol=1e-11, momentum_solver="bicgstab")
    lid = dict(problem="lid", n0=10, diagonal="crossed")
    win = dict(linear_rtol=1e-12, newton_tol=1e-10)
    return [
        dict(kind="packed", spec=dict(problem="karman", lcar=0.2, n_refine=2), kw=tight,
             dt=1e-3, n_run=3, step=False),
        dict(kind="projection", spec=lid),
        dict(kind="halo_poisson", spec=dict(problem="lid", n0=24, diagonal="crossed"),
             neumann=True),
        dict(kind="halo_step", spec=dict(problem="lid", n0=5, n_refine=1,
                                         diagonal="crossed"),
             mg=True, n_run=3, n_steps=0, dt=1e-3, kw=dict(time_step_method="bdf2")),
        dict(kind="halo_step", spec=lid, n_steps=2, kw=dict(convection="lagged",
                                                            winkernel=True, **win)),
        dict(kind="halo_step", spec=lid, n_steps=2, kw=dict(convection="newton",
                                                            winkernel=True, **win)),
    ]


def compare(card, cpu):
    """Rows (case, counts equal, max |dU|, max |dP - mean|, the largest |U|)
    of two runs of parity_cases()."""
    rows = []
    for i, (a, b) in enumerate(zip(card, cpu)):
        if "run" in a:  # packed, halo_step with a run
            Ua, Pa, dta, ta = a["run"]
            Ub, Pb, dtb, tb = b["run"]
            same = (all(np.array_equal(ta[k], tb[k]) for k in ta if k.endswith("iters"))
                    and abs(dta - dtb) <= 1e-12 * abs(dtb))
        elif "steps" in a:
            (Ua, Pa), (Ub, Pb) = a["steps"][-1], b["steps"][-1]
            same = True
        elif "U1" in a:
            Ua, Pa, Ub, Pb = a["U1"], a["P1"], b["U1"], b["P1"]
            same = True
        else:  # halo_poisson
            Ua, Pa, Ub, Pb = a["x"], a["x"], b["x"], b["x"]
            same = a["iters"] == b["iters"]
        dp = Pa - Pb
        rows.append((i, bool(same), float(np.abs(Ua - Ub).max()),
                     float(np.abs(dp - dp.mean()).max()), float(np.abs(Ub).max())))
    return rows


def run_cases(cases, device="cpu"):
    """Every rank: run each case (a dict: "kind", "spec", "dtype" (default
    float64), "ranks" (default all), and the kind's options) -> the list of
    results (None on ranks outside a case's subgroup)."""
    world = dist.get_world_size()
    rank = dist.get_rank()
    out = []
    for case in cases:
        k = case.get("ranks", world)
        # every rank of the world takes part in making a subgroup
        group = None if k == world else dist.new_group(ranks=list(range(k)))
        if k < world and rank >= k:
            out.append(None)
            continue
        prob = build_problem(case["spec"], _dtype(case.get("dtype", "float64")))
        dev = comm.resolve_device(device, group)
        out.append(_KINDS[case["kind"]](case, prob, group, dev))
    return out


def collectives_probe():
    """The comm collectives on small tensors of this rank (a launcher
    check): sum, max, all_gather, and the ring exchange."""
    t = torch.tensor([1.0, 2.0, 3.0]) * (dist.get_rank() + 1)
    fl, fr = comm.ring_exchange(t[:1], t[:1])
    return {"sum": float(comm.all_reduce_sum(t.sum())),
            "max": float(comm.all_reduce_max(t.max())),
            "gather": comm.all_gather(t).tolist(),
            "from_left": fl.tolist(), "from_right": fr.tolist()}
