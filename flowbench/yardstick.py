"""The benchmark's fixed arithmetic: the card's published peaks, the least
time of a kernel's work, and the reduction of a profiler trace to device
busy time, idle gaps, launches and device time by kernel name. Frozen here
so that a change to the program cannot move the yardstick."""
from __future__ import annotations

import bisect
import collections

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and the float32 rate outside
# the tensor cores (dense)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")


def bound_s(nbytes, ops):
    """Least time for the work on the card: the larger of its bytes over the
    bandwidth and its operations over the float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def stencil_bound_s(shape, dim=3, itemsize=4):
    """A 3^dim stencil's bound on a grid: x read and y written once, the
    3^dim coefficients read once, 2 3^dim operations a point."""
    n = 1
    for s in shape:
        n *= int(s)
    return bound_s(2 * itemsize * n + itemsize * 3**dim, 2 * 3**dim * n)


def merge(intervals):
    """Union of [start, end) intervals -> sorted disjoint list."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


class Trace:
    """A profiled window reduced to plain numbers. `device` and `host` are
    lists of (name, start_us, end_us): the device's operations (kernels,
    copies, sets) and the host's operators and runtime calls; wall_s is the
    window's host-clock length."""

    def __init__(self, device, host, wall_s):
        self.device, self.host, self.wall_s = device, host, wall_s
        self.busy = merge([[a, b] for _, a, b in device])
        self.busy_s = sum(b - a for a, b in self.busy) * 1e-6
        self.launches = sum(1 for n, _, _ in host if n in LAUNCH_CALLS)

    @classmethod
    def from_profiler(cls, prof, wall_s):
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        device, host = [], []
        for e in prof.events():
            row = (e.name, float(e.time_range.start), float(e.time_range.end))
            (device if e.device_type == cuda else host).append(row)
        return cls(device, host, wall_s)

    def device_seconds(self, pred):
        """Device seconds of the operations whose name satisfies pred."""
        return sum(b - a for n, a, b in self.device if pred(n)) * 1e-6

    def device_count(self, pred):
        return sum(1 for n, _, _ in self.device if pred(n))

    def top_ops(self, k=10):
        acc = collections.Counter()
        for n, a, b in self.device:
            acc[n] += (b - a) * 1e-6
        return [[n, s] for n, s in acc.most_common(k)]

    def idle_gaps(self, k=10):
        """Idle time between device operations, summed by the innermost
        host operation that spans most of each gap."""
        if not self.busy:
            return []
        gaps = [(self.busy[i][1], self.busy[i + 1][0]) for i in range(len(self.busy) - 1)]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:2000]
        host = sorted(self.host, key=lambda r: r[1])
        starts = [r[1] for r in host]
        acc = collections.Counter()
        for a, b in gaps:
            best, best_key = "(no host operation)", None
            # host operations that began up to 5 ms before the gap
            lo = bisect.bisect_left(starts, a - 5000.0)
            for n, s, e in host[lo: bisect.bisect_right(starts, b)]:
                ov = min(b, e) - max(a, s)
                if ov <= 0:
                    continue
                key = (ov, -(e - s))
                if best_key is None or key > best_key:
                    best, best_key = n, key
            acc[best] += (b - a) * 1e-6
        return [[n, s] for n, s in acc.most_common(k)]
