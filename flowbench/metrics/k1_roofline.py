"""K1's share of its roofline, percent: the least time of its launches in
the profiled steps (each by its grid, from the program's GRID_LAUNCHES
counter; bytes and operations counted by the yardstick) over the device
time of the kernel events named stencil27_kernel. None where K1 did not
run, or where the counter and the trace disagree on its launches."""
from flowbench import yardstick


def read(ctx):
    tr, grids = ctx["trace"], ctx.get("grid_launches") or {}
    grids = {g: n for g, n in grids.items() if len(g) == 3 and n > 0}
    if tr is None or not grids:
        return None
    is_k1 = lambda name: "stencil27_kernel" in name  # noqa: E731
    if tr.device_count(is_k1) != sum(grids.values()):
        return None
    device_s = tr.device_seconds(is_k1)
    bound = sum(n * yardstick.stencil_bound_s(g) for g, n in grids.items())
    return 100.0 * bound / device_s
