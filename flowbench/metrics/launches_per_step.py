"""Kernel-launch API calls a step in the profiled steps (the trace's
runtime launch events over the steps profiled)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.launches == 0:
        return None
    return tr.launches / ctx["profile_steps"]
