# Performance tracing and introspection. Port of flow_tpu/utils/profiling.py
# onto PyTorch:
#   * `trace(logdir)`: torch.profiler around a block (with the CUDA activity
#     where a card is present), written as a Chrome trace that Perfetto and
#     TensorBoard's profiler plugin read,
#   * `cost_report(fn, *args)`: the floating-point operations of one call
#     (torch.utils.flop_counter) and, on the card, its peak allocation,
#   * `device_memory_stats()`: the caching allocator's statistics a card,
#   * `Timer`: a host wall-clock timer with dolfin.Timer's semantics,
#     optionally synchronising the card before each clock read,
#   * `setup_phase(seconds, key)`: a set-up phase timed into seconds[key]
#     by a synchronising Timer, inside a flow.setup.<key> span.
from __future__ import annotations

import os
import tempfile
import time
from contextlib import contextmanager

import torch

from ..message import span

__all__ = ["trace", "cost_report", "device_memory_stats", "Timer", "setup_phase"]


@contextmanager
def trace(logdir=None):
    """Profile the block with torch.profiler and write its trace into
    `logdir` (default: flow_tpu_torch_trace in the temporary directory) as
    <worker>.<time>.pt.trace.json, readable by Perfetto and TensorBoard.
    Records the CUDA activity too where a card is present.

    with profiling.trace("traces"):
        stepper.run(U, P, dt, n_steps=10)
    """
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "flow_tpu_torch_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir),
    ):
        yield logdir
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()


def _cuda_tensors(values):
    for v in values:
        if isinstance(v, torch.Tensor) and v.is_cuda:
            yield v
        elif isinstance(v, (list, tuple)):
            yield from _cuda_tensors(v)
        elif isinstance(v, dict):
            yield from _cuda_tensors(v.values())


def cost_report(fn, *args, **kwargs):
    """Run `fn(*args, **kwargs)` once and return its costs as a dict:

      "flops"                 floating-point operations counted by
                              torch.utils.flop_counter.FlopCounterMode (its
                              table: matrix products, convolutions,
                              attention; elementwise work counts 0)
      "peak_allocated_bytes"  on a CUDA argument only: the call's peak
                              device allocation above what was allocated
                              before it

    flops / wall time gives the achieved rate against the card's peak.
    """
    from torch.utils.flop_counter import FlopCounterMode

    cuda = next(_cuda_tensors((args, kwargs)), None)
    if cuda is not None:
        torch.cuda.synchronize(cuda.device)
        base = torch.cuda.memory_allocated(cuda.device)
        torch.cuda.reset_peak_memory_stats(cuda.device)
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    out = {"flops": int(counter.get_total_flops())}
    if cuda is not None:
        torch.cuda.synchronize(cuda.device)
        out["peak_allocated_bytes"] = int(
            torch.cuda.max_memory_allocated(cuda.device) - base)
    return out


def device_memory_stats():
    """{"cuda:<i>": torch.cuda.memory_stats(i)} for each visible card
    (bytes and counts of the caching allocator); {} where there is none."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": dict(torch.cuda.memory_stats(i))
            for i in range(torch.cuda.device_count())}


class Timer:
    """Host wall-clock timer.

    t = Timer("assembly"); ...; dt = t.stop()
    or:  with Timer("solve", sync=True) as t: ...
    Accumulates across start/stop pairs (dolfin.Timer semantics). With
    sync=True each clock read first waits for the card's queued work
    (torch.cuda.synchronize), so the time covers the device work enqueued
    in between.
    """

    def __init__(self, name="timer", sync=False):
        self.name = name
        self.sync = sync
        self.elapsed = 0.0
        self._t0 = self._now()

    def _now(self):
        if self.sync and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return time.perf_counter()

    def start(self):
        self._t0 = self._now()
        return self

    def stop(self):
        if self._t0 is not None:
            self.elapsed += self._now() - self._t0
            self._t0 = None
        return self.elapsed

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


@contextmanager
def setup_phase(seconds, key):
    """`with setup_phase(self.setup_seconds, "mesh"):` times the block with
    Timer(sync=True) into seconds[key], inside a flow.setup.<key> span."""
    timer = Timer(key, sync=True)
    with span("flow.setup." + key), timer:
        yield
    seconds[key] = timer.elapsed
