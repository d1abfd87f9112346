# Per-step metrics collection. Port of flow_tpu/utils/metrics.py: drivers
# append one dict a step (norms, solver iterations, dt, wall time); the
# logger writes them as JSON lines as it goes and summarises them.
from __future__ import annotations

import json
import time

__all__ = ["MetricsLogger"]


class MetricsLogger:
    def __init__(self, path=None):
        self.path = path
        self.records = []
        self._fh = open(path, "a") if path else None
        self._t_last = time.perf_counter()

    def log(self, **fields):
        """Record one dict; wall_dt (host seconds since the last record)
        is added unless given."""
        now = time.perf_counter()
        fields.setdefault("wall_dt", now - self._t_last)
        self._t_last = now
        self.records.append(fields)
        if self._fh:
            self._fh.write(json.dumps(fields) + "\n")
            self._fh.flush()

    def summary(self):
        """min/mean/max/n of each numeric field."""
        out = {}
        keys = set().union(*(r.keys() for r in self.records)) if self.records else set()
        for k in keys:
            vals = [r[k] for r in self.records if isinstance(r.get(k), (int, float))]
            if vals:
                out[k] = {
                    "min": min(vals),
                    "mean": sum(vals) / len(vals),
                    "max": max(vals),
                    "n": len(vals),
                }
        return out

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
