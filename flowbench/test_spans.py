"""CPU tests of the span readers (flowbench/spans.py and the per-layer
metrics that read the program's flow.* spans) on hand-built traces with
known intervals, and of the set-up readers.

    python -m pytest flowbench/test_spans.py -q
"""
import math

import pytest

from flowbench import harness, yardstick

SPAN_METRICS = ("momentum_ms_per_step", "momentum_idle_ms_per_step",
                "pressure_idle_ms_per_step", "correction_idle_ms_per_step",
                "host_syncs_per_step", "vcycle_launches")


def _trace():
    """Two 100-us steps. Device busy 0-10, 20-30, 50-100 in the first and
    100-200 in the second. Times in microseconds."""
    device = [("k", 0.0, 10.0), ("k", 20.0, 30.0), ("k", 50.0, 100.0), ("k", 100.0, 200.0)]
    host = [
        ("flow.step", 0.0, 100.0), ("flow.step", 100.0, 200.0),
        ("flow.momentum", 0.0, 40.0), ("flow.pressure", 40.0, 80.0),
        ("flow.correction", 80.0, 95.0), ("flow.cfl", 95.0, 100.0),
        ("flow.momentum", 100.0, 130.0), ("flow.pressure", 130.0, 170.0),
        ("flow.correction", 170.0, 200.0),
        ("flow.vcycle", 45.0, 55.0), ("flow.vcycle", 60.0, 70.0),
        ("flow.vcycle", 140.0, 150.0),
        ("flow.sync.bicgstab", 30.0, 32.0), ("flow.sync.cg", 56.0, 58.0),
        ("flow.sync.cg", 85.0, 86.0),
        ("aten::add", 46.0, 48.0),
        # launches: two in the first V-cycle, one in the second, none in
        # the third, two outside any
        ("cudaLaunchKernel", 1.0, 2.0), ("cudaLaunchKernel", 46.0, 46.5),
        ("cuLaunchKernel", 47.0, 47.5), ("cudaLaunchKernel", 61.0, 61.5),
        ("cudaLaunchKernel", 150.0, 150.5),
    ]
    return yardstick.Trace(device, host, wall_s=200e-6)


def _ctx(tr, steps=2):
    return {"trace": tr, "profile_steps": steps}


def read(name, ctx):
    return harness.metric_reader(name)(ctx)


def test_span_readers_by_hand():
    ctx = _ctx(_trace())
    # momentum: 40 + 30 us over two steps
    assert math.isclose(read("momentum_ms_per_step", ctx), 1e-3 * 70 / 2)
    # idle inside momentum: 0-40 less busy 0-10, 20-30 (20 us); 100-130 busy
    assert math.isclose(read("momentum_idle_ms_per_step", ctx), 1e-3 * 20 / 2)
    # pressure: 40-80 less 50-80 (10 us); 130-170 busy
    assert math.isclose(read("pressure_idle_ms_per_step", ctx), 1e-3 * 10 / 2)
    # correction: all busy
    assert read("correction_idle_ms_per_step", ctx) == 0.0
    assert math.isclose(read("host_syncs_per_step", ctx), 3 / 2)
    # 46, 47 in the first V-cycle, 61 in the second, none in the third
    # (150 is its end); a launch at a span's start counts
    assert math.isclose(read("vcycle_launches", ctx), 3 / 3)
    # the three substeps' idle time is part of the window's
    tr = ctx["trace"]
    idle_ms = 1e3 * (tr.wall_s - tr.busy_s) / 2
    assert sum(read(m, ctx) for m in ("momentum_idle_ms_per_step",
                                      "pressure_idle_ms_per_step",
                                      "correction_idle_ms_per_step")) <= idle_ms


def test_overlapping_spans_count_once():
    tr = yardstick.Trace([("k", 5.0, 15.0)],
                         [("flow.step", 0.0, 30.0), ("flow.momentum", 0.0, 10.0),
                          ("flow.momentum", 8.0, 20.0), ("flow.vcycle", 0.0, 10.0),
                          ("flow.vcycle", 2.0, 4.0), ("cudaLaunchKernel", 3.0, 3.5)],
                         wall_s=30e-6)
    ctx = _ctx(tr, 1)
    assert math.isclose(read("momentum_ms_per_step", ctx), 0.020)
    assert math.isclose(read("momentum_idle_ms_per_step", ctx), 0.010)
    # the nested V-cycle's launch counts once, over two spans
    assert math.isclose(read("vcycle_launches", ctx), 0.5)


def test_no_trace_or_no_spans_reads_none():
    for m in SPAN_METRICS:
        assert read(m, _ctx(None)) is None
    # a program without spans (ATen operators and launches only)
    tr = yardstick.Trace([("k", 0.0, 10.0)],
                         [("aten::add", 0.0, 5.0), ("cudaLaunchKernel", 1.0, 2.0)], 1e-5)
    for m in SPAN_METRICS:
        assert read(m, _ctx(tr, 1)) is None
    # spans but no V-cycle (a stepper without multigrid)
    tr = yardstick.Trace([], [("flow.step", 0.0, 5.0), ("flow.momentum", 0.0, 5.0)], 1e-5)
    assert read("vcycle_launches", _ctx(tr, 1)) is None
    assert read("host_syncs_per_step", _ctx(tr, 1)) == 0.0
    assert read("pressure_idle_ms_per_step", _ctx(tr, 1)) == 0.0


class _Obj:
    pass


@pytest.mark.parametrize("timed", [True, False])
def test_setup_readers(timed):
    prob, st = _Obj(), _Obj()
    if timed:
        prob.setup_seconds = {"mesh": 12.5, "spaces": 1.0, "bcs": 0.5}
        st.setup_seconds = {"BoxPack": 3.0, "hierarchy": 4.25}
    ctx = {"sut": {"problem": prob}, "stepper": st, "trace": None}
    assert read("setup_mesh_s", ctx) == (12.5 if timed else None)
    assert read("setup_hierarchy_s", ctx) == (4.25 if timed else None)
