# The port's tracing layer (flow_tpu_torch/message.py) on the two
# benchmarked steppers, PackedPatchStepper (KarmanProblem(lcar=0.1,
# n_refine=1)) and BoxPackedStepper (Cavity3DProblem(n=4)), float64 on the
# CPU:
# - with no profiler recording, span opens nothing;
# - under a CPU torch.profiler each step is one flow.step span holding
#   flow.momentum, flow.pressure, flow.correction (flow.forces where a probe
#   is set) and flow.cfl in that order, none of them a user annotation;
# - one flow.vcycle a preconditioner call (pressure_iters + 1 a step) and
#   one flow.sync.<site> a blocking transfer ((iterations + 1) a Krylov
#   solve, one a host number that run moves to the device);
# - the set-up phases in setup_seconds, within the constructor's time;
# - Message's log lines as they were.
import logging
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from flow_tpu_torch import message
from flow_tpu_torch.fem.patch import build_patch_info
from flow_tpu_torch.models.cavity3d import Cavity3DProblem
from flow_tpu_torch.models.karman import KarmanProblem
from flow_tpu_torch.navier_stokes.boxfast import BoxPackedStepper
from flow_tpu_torch.navier_stokes.patchfast import PackedPatchStepper

torch.set_num_threads(1)

SUBSTEPS = ("flow.momentum", "flow.pressure", "flow.correction", "flow.forces",
            "flow.cfl")
SETTINGS = dict(newton_rtol=1e-2, linear_rtol=1e-1, pressure_rtol=1e-4,
                correction_rtol=1e-5)
DT0 = 1e-2


def _build(kind):
    """-> (problem, stepper, problem seconds, stepper seconds)."""
    t0 = time.perf_counter()
    if kind == "packed":
        prob = KarmanProblem(lcar=0.1, n_refine=1, dtype=torch.float64, device="cpu")
        t1 = time.perf_counter()
        st = PackedPatchStepper(prob.V, prob.Q, prob.u_bcs, prob.p_bcs, prob.rho,
                                prob.mu, build_patch_info(prob.mesh_hierarchy),
                                momentum_solver="bicgstab", **SETTINGS)
    else:
        prob = Cavity3DProblem(n=4, dtype=torch.float64, device="cpu")
        t1 = time.perf_counter()
        st = BoxPackedStepper(prob.V, prob.Q, prob.u_bcs, prob.p_bcs, prob.rho,
                              prob.mu, **SETTINGS)
    return prob, st, t1 - t0, time.perf_counter() - t1


def _flow_rows(prof):
    """(name, start, end, event) of the flow.* events, outermost first at a
    start. The profiler's raw events: its event tree takes seconds to build
    for the box stepper's ~10^5 operators a step."""
    rows = [(e.name(), e.start_ns(), e.end_ns(), e)
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("flow.")]
    return sorted(rows, key=lambda r: (r[1], -r[2]))


def _inside(rows, a, b):
    return [r for r in rows if a <= r[1] and r[2] <= b]


def _profiled_run(st, n_steps):
    U, P = st.zeros()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = st.run(U, P, DT0, n_steps)
    return out[3], _flow_rows(prof)


_BUILT = {}


def _built(kind):
    if kind not in _BUILT:
        _BUILT[kind] = _build(kind)
    return _BUILT[kind]


@pytest.fixture(scope="module", params=["packed", "box"])
def built(request):
    return _built(request.param)


@pytest.fixture(scope="module")
def traced(built):
    """Two profiled steps (the packed stepper with a forces probe)."""
    st = built[1]
    probe = isinstance(st, PackedPatchStepper)
    if probe:
        st.forces_probe = lambda U, P: U.sum(0)
    try:
        tel, rows = _profiled_run(st, 2)
    finally:
        if probe:
            st.forces_probe = None
    return tel, rows, probe


def test_span_off_opens_nothing(built, monkeypatch):
    st = built[1]
    opened = []
    monkeypatch.setattr(message, "_RecordFunctionFast",
                        lambda name: opened.append(name))
    assert message.span("flow.x") is message._OFF
    assert message.host_read("cg", bool, torch.tensor(True)) is True
    U, P = st.zeros()
    st.run(U, P, DT0, 1)
    assert opened == []


def test_steps_hold_the_substeps_in_order(traced):
    _, rows, probe = traced
    steps = [r for r in rows if r[0] == "flow.step"]
    assert len(steps) == 2
    want = ["flow.momentum", "flow.pressure", "flow.correction"]
    want += ["flow.forces"] if probe else []
    want += ["flow.cfl"]
    for _, a, b, _ in steps:
        assert [r[0] for r in _inside(rows, a, b) if r[0] in SUBSTEPS] == want
    # every span is a function-scope record on the host, none a user
    # annotation (a record_function range would be one)
    assert not any(r[3].is_user_annotation() for r in rows)
    assert {r[3].device_type() for r in rows} == {torch.autograd.DeviceType.CPU}


def test_vcycles_and_host_reads_follow_the_iteration_counts(traced):
    tel, rows, _ = traced
    steps = [r for r in rows if r[0] == "flow.step"]
    for k, (_, a, b, _) in enumerate(steps):
        inner = _inside(rows, a, b)
        lin, pres, corr = (int(tel[key][k]) for key in
                           ("linear_iters", "pressure_iters", "correction_iters"))
        assert 0 < lin and 0 < pres and 0 < corr
        # one V-cycle a preconditioner call: before the loop and each iteration
        (_, pa, pb, _), = [r for r in inner if r[0] == "flow.pressure"]
        in_pressure = [r[0] for r in _inside(inner, pa, pb)][1:]
        assert in_pressure.count("flow.vcycle") == pres + 1
        assert sum(1 for r in inner if r[0] == "flow.vcycle") == pres + 1
        # one read a stopping test: each iteration's and the last
        sync = {}
        for r in inner:
            if r[0].startswith("flow.sync."):
                sync[r[0]] = sync.get(r[0], 0) + 1
        assert sync == {"flow.sync.bicgstab": lin + 1,
                        "flow.sync.cg": (pres + 1) + (corr + 1)}
        assert in_pressure.count("flow.sync.cg") == pres + 1
    # run's host numbers to the device, before the steps: dt_max, the CFL
    # target, dt0 and t = 0
    scalar = [r for r in rows if r[0] == "flow.sync.scalar"]
    assert len(scalar) == 4 and scalar[-1][2] <= steps[0][1]


def test_picard_reads_are_spans():
    # the packed stepper's Picard loop (the box stepper's is the same code;
    # a profiled box step takes seconds on the CPU)
    st = _built("packed")[1]
    st.picard_maxiter, st.picard_tol = 3, 1e-8
    try:
        tel, rows = _profiled_run(st, 1)
    finally:
        st.picard_maxiter, st.picard_tol = 1, 0.0
    n = int(tel["newton_iters"][0])
    # the stopping test reads before it checks the cap
    assert 0 < n and sum(1 for r in rows if r[0] == "flow.sync.picard") == n + 1


def test_setup_phases(built):
    prob, st, prob_s, st_s = built
    assert {"mesh", "spaces", "bcs"} <= set(prob.setup_seconds)
    assert "hierarchy" in st.setup_seconds
    assert {"PackedPatch", "BoxPack"} & set(st.setup_seconds)
    assert all(v >= 0 for v in prob.setup_seconds.values())
    assert sum(prob.setup_seconds.values()) <= prob_s
    assert sum(st.setup_seconds.values()) <= st_s


def test_setup_phases_are_spans():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        Cavity3DProblem(n=2, dtype=torch.float64, device="cpu")
    names = [r[0] for r in _flow_rows(prof)]
    assert names == ["flow.setup.mesh", "flow.setup.spaces", "flow.setup.bcs"]


def test_message_log_lines_unchanged(caplog, monkeypatch):
    monkeypatch.setattr(message, "_depth", 0)
    with caplog.at_level(logging.INFO, logger="flow_tpu_torch"):
        with message.Message("Computing pressure"):
            message.info("inner %d", 3)
            with message.Message("Computing velocity correction"):
                pass
    lines = [r.getMessage() for r in caplog.records]
    assert lines[:2] == ["Computing pressure", "  inner 3"]
    assert lines[2] == "  Computing velocity correction"
    assert lines[3].startswith("    Computing velocity correction done [")
    assert lines[4].startswith("  Computing pressure done [")
    assert lines[4].endswith(" s]") and len(lines) == 5
    assert message._depth == 0
    # and a Message is a span of its name, not a user annotation
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with message.Message("Computing pressure"):
            torch.ones(2).sum()
    ev = [e for e in prof.events() if e.name == "Computing pressure"]
    assert len(ev) == 1 and not ev[0].is_user_annotation
