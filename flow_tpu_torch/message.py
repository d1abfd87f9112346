# Indented logging scopes with wall time, and named spans on the profiler's
# clock: the framework's tracing layer. Port of flow_tpu/message.py, plus
# the spans of the time loop.
#
# A span is a FUNCTION-scope record (torch's _RecordFunctionFast), the kind
# every ATen operator opens: it lands among the operators in the host rows of
# a torch.profiler trace and adds no row on the device's timeline (a
# record_function range, USER_SCOPE, adds a gpu_user_annotation there). With
# no profiler recording, a span costs one read of the profiler's flag.
from __future__ import annotations

import contextlib
import functools
import logging
import time

import torch
from torch.autograd import profiler as _profiler

__all__ = ["Message", "begin", "end", "host_read", "info", "set_log_level",
           "span", "spanned"]

logger = logging.getLogger("flow_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(_h)
logger.setLevel(logging.WARNING)

_depth = 0

# None where the torch build lacks it: spans then stay off (a USER_SCOPE
# record_function in its place would add device rows to every trace)
_RecordFunctionFast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
_OFF = contextlib.nullcontext()


def span(name):
    """`with span("flow.pressure"):` a named range in torch.profiler traces
    while a profiler records, a no-op otherwise."""
    if _profiler._is_profiler_enabled and _RecordFunctionFast is not None:
        return _RecordFunctionFast(name)
    return _OFF


def spanned(name):
    """Decorator: every call of the function inside span(name)."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def host_read(site, read, *args, **kwargs):
    """read(*args, **kwargs) inside a flow.sync.<site> span: a transfer that
    the host waits for on a card, so that traces count them by site. Mostly
    a device value read to the host (`host_read("cg", bool, rnorm > tol)`);
    also a host number copied to the device."""
    with span("flow.sync." + site):
        return read(*args, **kwargs)


def set_log_level(level):
    logger.setLevel(level)


def info(msg, *args):
    logger.info("  " * _depth + (msg % args if args else str(msg)))


def begin(msg):
    global _depth
    info(msg)
    _depth += 1


def end():
    global _depth
    _depth = max(0, _depth - 1)


class Message:
    """`with Message('Computing pressure'):` an indented, timed log scope
    that is also a span of the same name in torch.profiler traces."""

    def __init__(self, string):
        self.string = string
        self._trace = None
        self._t0 = None

    def __enter__(self):
        begin(self.string)
        self._t0 = time.perf_counter()
        self._trace = span(self.string)
        self._trace.__enter__()
        return self

    def __exit__(self, tpe, value, traceback):
        self._trace.__exit__(tpe, value, traceback)
        dt = time.perf_counter() - self._t0
        info("%s done [%.3f s]", self.string, dt)
        end()
        return False
