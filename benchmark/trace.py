"""Reading a ``torch.profiler`` Chrome trace: device busy time, the
device operations that took most time, and the longest idle gaps.

Device intervals are the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events; host intervals its ``cpu_op`` events, on every
thread.
"""

from __future__ import annotations

import collections
import json
import re
import typing
from dataclasses import dataclass
from pathlib import Path

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


@dataclass
class Trace:
    device: typing.List[typing.Tuple[float, float, str]]  # seconds
    host: typing.List[typing.Tuple[float, float, str]]
    start: float
    end: float

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy(self) -> typing.List[typing.Tuple[float, float]]:
        """The union of the device intervals, in order."""
        merged: typing.List[typing.List[float]] = []
        for s, e, _ in sorted(self.device):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def kernel_seconds(self, pattern: str) -> typing.Dict[str, float]:
        """Device seconds by name, for names matching ``pattern``."""
        rx = re.compile(pattern)
        out: typing.Dict[str, float] = collections.defaultdict(float)
        for s, e, name in self.device:
            if rx.search(name):
                out[name] += e - s
        return dict(out)

    def top_ops(self) -> typing.List[typing.List[typing.Any]]:
        total: typing.Dict[str, float] = collections.defaultdict(float)
        for s, e, name in self.device:
            total[name] += e - s
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
        return [[name[:200], secs] for name, secs in ranked]

    def idle_gaps(self) -> typing.List[typing.List[typing.Any]]:
        """The longest gaps with no device operation, each named by the
        innermost host operation running at its middle."""
        edges = [self.start] + [x for iv in self.busy() for x in iv] + [
            self.end]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges) - 1, 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:TOP]
        out = []
        for length, start in gaps:
            mid = start + length / 2
            around = [(e - s, name) for s, e, name in self.host
                      if s <= mid <= e]
            name = min(around)[1] if around else "no host operation"
            out.append([name[:200], length])
        return out


def load(path: typing.Union[str, Path],
         window_s: typing.Optional[float] = None) -> Trace:
    """The trace at ``path``.  Its window is the span of its events, or,
    with ``window_s`` (the host's measure of the profiled seconds), that
    long from its first event, with every interval cut to it: events the
    profiler records after the window, while it stops, are left out."""
    with open(path, encoding="utf-8") as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    device, host = [], []
    lo, hi = float("inf"), float("-inf")
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"]) * 1e-6
        e = s + float(ev["dur"]) * 1e-6
        cat = ev.get("cat", "")
        if cat in DEVICE_CATEGORIES:
            device.append((s, e, ev.get("name", "")))
        elif cat == "cpu_op":
            host.append((s, e, ev.get("name", "")))
        else:
            continue
        lo, hi = min(lo, s), max(hi, e)
    if not device and not host:
        lo = hi = 0.0
    if window_s is not None:
        hi = lo + window_s
        device = [(s, min(e, hi), n) for s, e, n in device if s < hi]
        host = [(s, min(e, hi), n) for s, e, n in host if s < hi]
    return Trace(device, host, lo, hi)
