"""The program's spans in a profiled window: the flow.* ranges that
flow_tpu_torch.message.span records among the host rows of a
yardstick.Trace (flow.step, flow.momentum, flow.pressure, flow.correction,
flow.cfl, flow.forces, flow.vcycle, flow.sync.<site>), measured against the
device's busy intervals and the launch calls. Times in microseconds, as the
trace has them. A trace without a flow.step span comes from a program
without spans: every reader here then returns None."""
from __future__ import annotations

import bisect

from flowbench import yardstick


def intervals(tr, name):
    """[start, end) of the host rows named `name`."""
    return [[a, b] for n, a, b in tr.host if n == name]


def instrumented(tr):
    return tr is not None and any(n == "flow.step" for n, _, _ in tr.host)


def overlap_us(xs, ys):
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def span_ms_per_step(ctx, name):
    """Milliseconds a profiled step in the union of the `name` spans."""
    tr = ctx["trace"]
    if not instrumented(tr):
        return None
    spans = yardstick.merge(intervals(tr, name))
    return 1e-3 * sum(b - a for a, b in spans) / ctx["profile_steps"]


def idle_ms_per_step(ctx, name):
    """Milliseconds a profiled step in the union of the `name` spans while
    no operation ran on the device."""
    tr = ctx["trace"]
    if not instrumented(tr):
        return None
    spans = yardstick.merge(intervals(tr, name))
    idle = sum(b - a for a, b in spans) - overlap_us(spans, tr.busy)
    return 1e-3 * idle / ctx["profile_steps"]


def syncs_per_step(ctx):
    """flow.sync.* spans (blocking device-to-host reads) a profiled step."""
    tr = ctx["trace"]
    if not instrumented(tr):
        return None
    n = sum(1 for name, _, _ in tr.host if name.startswith("flow.sync."))
    return n / ctx["profile_steps"]


def launches_per_span(ctx, name):
    """Launch calls that start inside a `name` span, over the spans."""
    tr = ctx["trace"]
    spans = intervals(tr, name) if instrumented(tr) else []
    if not spans:
        return None
    starts = sorted(a for n, a, _ in tr.host if n in yardstick.LAUNCH_CALLS)
    inside = sum(bisect.bisect_left(starts, b) - bisect.bisect_left(starts, a)
                 for a, b in yardstick.merge(spans))
    return inside / len(spans)
