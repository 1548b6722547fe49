"""The device's busy time over a stretch of the window, from torch.profiler.

``Stretch.begin()`` synchronises the card, starts the profiler (CPU and
CUDA activities) and opens a marker on the host; ``end()`` synchronises,
closes the marker and stops. The stretch is the marker's interval; the
busy time is the union of every device operation's interval (kernels,
copies, sets) inside it. The marker's start on the profiler's clock and
``trace.clock()`` at the same instant align the host's spans with the
device's timeline, so that each idle gap is named by the spans that were
open on the host while the card waited.
"""

from __future__ import annotations

import collections

import torch

MARK = "portbench.stretch"


class Stretch:
    def __init__(self, clock):
        self.clock = clock
        self.prof = None
        self.t0 = self.t1 = None

    def begin(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self._mark = record_function(MARK)
        self._mark.__enter__()
        self.t0 = self.clock()

    def end(self) -> None:
        torch.cuda.synchronize()
        self.t1 = self.clock()
        self._mark.__exit__(None, None, None)
        self.prof.stop()

    @property
    def open(self) -> bool:
        return self.prof is not None and self.t1 is None

    def read(self, spans=()) -> dict:
        """{"busy_s", "window_s", "device_ops", "idle_gaps"}; ``spans`` are
        ``trace`` events ((name, t0, t1, thread) on ``clock``)."""
        from torch.autograd import DeviceType
        mark, ops = None, []
        for e in self.prof.events():
            if e.name == MARK:
                if e.device_type != DeviceType.CUDA and mark is None:
                    mark = (e.time_range.start, e.time_range.end)
            elif e.device_type == DeviceType.CUDA:
                ops.append((e.time_range.start, e.time_range.end, e.name))
        if mark is None:
            raise RuntimeError("the profiler recorded no stretch marker")
        a, b = mark
        window_s = (b - a) * 1e-6
        per_name: dict = collections.defaultdict(float)
        busy, cur = 0.0, None
        gaps, last = [], a
        for s, e, name in sorted(ops):
            s, e = max(s, a), min(e, b)
            if e <= s:
                continue
            per_name[name] += (e - s) * 1e-6
            if cur is None or s > cur[1]:
                if cur is not None:
                    busy += cur[1] - cur[0]
                if s > last:
                    gaps.append((last, s))
                cur = [s, e]
            else:
                cur[1] = max(cur[1], e)
            last = max(last, e)
        if cur is not None:
            busy += cur[1] - cur[0]
        if b > last:
            gaps.append((last, b))
        shift = self.t0 - a * 1e-6          # profiler us -> clock seconds
        gaps.sort(key=lambda g: g[0] - g[1])
        idle = [[_name_gap(g, shift, spans), (g[1] - g[0]) * 1e-6]
                for g in gaps[:10]]
        top = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy * 1e-6, "window_s": window_s,
                "device_ops": [[n[:160], s] for n, s in top],
                "idle_gaps": idle}


def _name_gap(gap, shift: float, spans) -> str:
    """The innermost span open on each host thread at the gap's middle."""
    mid = (gap[0] + gap[1]) * 0.5e-6 + shift
    inner: dict = {}
    for name, t0, t1, thread in spans:
        if t0 <= mid <= t1:
            best = inner.get(thread)
            if best is None or t0 >= best[1]:
                inner[thread] = (name, t0)
    names = sorted({n for n, _ in inner.values()})
    return " + ".join(names) if names else "no span open"
