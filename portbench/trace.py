"""Reading a traced run: the profiler's chrome trace -> the device's
timeline inside the harness's ``portbench.window`` span, its busy time,
the time of kernels by name, and the idle gaps by what the host was
doing."""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
#: the harness's own spans around its calls into the program
SPANS = ("portbench.process", "portbench.to_host")


class Trace:
    def __init__(self, path: str):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        events = [e for e in events if e.get("ph") == "X" and "dur" in e]
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("cat", "").lower() == "user_annotation"]
        if not win:
            raise RuntimeError(f"the trace has no {WINDOW} span")
        self.w0 = float(win[0]["ts"])
        self.w1 = self.w0 + float(win[0]["dur"])

        def inside(e):
            return (float(e["ts"]) < self.w1
                    and float(e["ts"]) + float(e["dur"]) > self.w0)

        self.device = sorted(
            ((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
              e["cat"].lower()) for e in events
             if e.get("cat", "").lower() in DEVICE_CATS and inside(e)))
        self.spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                             e["name"]) for e in events
                            if e.get("name") in SPANS and inside(e))
        self.host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                            e["name"]) for e in events
                           if e.get("cat", "").lower() in HOST_CATS
                           and inside(e))

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) * 1e-6

    def busy_intervals(self):
        """The union of the device's kernels and copies in the window, as
        merged (start, end) microseconds."""
        out = []
        for s, e, _, _ in self.device:
            s, e = max(s, self.w0), min(e, self.w1)
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def kernels(self, patterns=None):
        """The kernel events (start, end, name) whose name holds one of
        ``patterns`` (all kernels without)."""
        return [d for d in self.device if d[3] == "kernel"
                and (patterns is None or any(p in d[2] for p in patterns))]

    def kernel_seconds(self, patterns) -> float:
        return sum(d[1] - d[0] for d in self.kernels(patterns)) * 1e-6

    def device_ops(self, top: int = 10):
        """[[name, seconds], ...]: the device operations with the most time
        in the window, summed by name."""
        tot = defaultdict(float)
        for s, e, name, _ in self.device:
            tot[name] += (min(e, self.w1) - max(s, self.w0)) * 1e-6
        return [[n, v] for n, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10):
        """[[what the host was doing, seconds], ...]: the device's idle time
        in the window, each gap named by the harness span and the innermost
        host operation at its middle, summed by name."""
        busy = self.busy_intervals()
        edges = [self.w0] + [x for iv in busy for x in iv] + [self.w1]
        tot = defaultdict(float)
        for s, e in zip(edges[0::2], edges[1::2]):
            if e > s:
                tot[self._doing((s + e) / 2)] += (e - s) * 1e-6
        return [[n, v] for n, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def _doing(self, t: float) -> str:
        span = _covering(self.spans, t) or "portbench loop"
        op = _covering(self.host, t)
        return f"{span}: {op}" if op else span


def _covering(items, t: float, lookback: int = 64):
    """The name of the latest-starting (start, end, name) item that covers
    ``t``: the innermost of nested host events."""
    i = bisect.bisect_right(items, (t, float("inf"), "")) - 1
    for j in range(i, max(i - lookback, -1), -1):
        if items[j][1] > t:
            return items[j][2]
    return None
