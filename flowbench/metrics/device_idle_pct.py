"""Percent of the profiled steps' host-clock time in which no operation ran
on the device: 100 (1 - union of device intervals / wall time)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.wall_s)
