# Indented logging scopes with wall time: the framework's tracing layer.
# Port of flow_tpu/message.py. A Message scope is also a
# torch.profiler.record_function range, so the heat and Navier-Stokes
# substeps show up by name in the card's profiles.
from __future__ import annotations

import logging
import time

import torch

__all__ = ["Message", "begin", "end", "info", "set_log_level"]

logger = logging.getLogger("flow_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(_h)
logger.setLevel(logging.WARNING)

_depth = 0


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
    that is also a named range in torch.profiler traces."""

    def __init__(self, string):
        self.string = string
        self._trace = None
        self._t0 = None

    def __enter__(self):
        begin(self.string)
        self._t0 = time.perf_counter()
        self._trace = torch.profiler.record_function(self.string)
        self._trace.__enter__()
        return self

    def __exit__(self, tpe, value, traceback):
        self._trace.__exit__(tpe, value, traceback)
        dt = time.perf_counter() - self._t0
        info("%s done [%.3f s]", self.string, dt)
        end()
        return False
