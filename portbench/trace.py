"""The device trace of a `--trace 1` run: torch.profiler over the measured
window, reduced to what the per-layer metrics and the breakdown read.

The reduction reads the profiler's raw events (kineto_results.events()),
not its FunctionEvent tree, so a window of some hundred thousand events is
reduced in seconds. A device event is a kernel, a memcpy or a memset (the
harness's own spans, which the profiler also draws on the device's
timeline, are left out); the card is busy where any runs. An idle gap between two device events is
named by what the host was doing in its middle: the innermost host event
that covers that instant, or, where that is only the harness's span around
a call of the program, `before_<the next host event>`.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

import torch

CALL_SPAN = "portbench.call"
SINK_SPAN = "portbench.sink_write"
TOP = 10


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float                      # union of device events
    kernel_s: float                    # sum of kernel durations
    dtoh_s: float                      # sum of device-to-host copies
    device_ops: list = field(default_factory=list)   # [[name, s]]
    idle_gaps: list = field(default_factory=list)    # [[name, s]]


def _kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "dtoh" if "DtoH" in name else "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def _annotation(event) -> bool:
    """A host span (record_function) that the profiler also draws on the
    device's timeline: not device work."""
    flag = getattr(event, "is_user_annotation", None)
    return bool(flag and flag()) or event.name().startswith("portbench.")


class Tracer:
    """torch.profiler over [start(), stop()) on the CPU and, on a card, the
    device. summary() reduces what it recorded."""

    def __init__(self, device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self.window_s = 0.0

    def start(self) -> None:
        self._prof.start()

    def stop(self, window_s: float) -> None:
        self._prof.stop()
        self.window_s = window_s

    def summary(self) -> TraceSummary:
        events = self._prof.profiler.kineto_results.events()
        device, host = [], []
        for ev in events:
            start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                if _annotation(ev):
                    continue
                device.append((start, end, ev.name(), _kind(ev.name())))
            elif end > start:
                host.append((start, end, ev.name()))
        return reduce_events(device, host, self.window_s)


def reduce_events(device: list, host: list, window_s: float) -> TraceSummary:
    """device: [(start_ns, end_ns, name, kind)]; host: [(start_ns, end_ns,
    name)] -> TraceSummary."""
    device = sorted(device)
    host = sorted(host)
    by_name = defaultdict(float)
    kernel_s = dtoh_s = 0.0
    for start, end, name, kind in device:
        s = (end - start) / 1e9
        by_name[name] += s
        if kind == "kernel":
            kernel_s += s
        elif kind == "dtoh":
            dtoh_s += s
    busy_ns, gaps = 0, []
    cur_start = cur_end = None
    for start, end, *_ in device:
        if cur_end is None:
            cur_start, cur_end = start, end
        elif start > cur_end:
            busy_ns += cur_end - cur_start
            gaps.append((cur_end, start))
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy_ns += cur_end - cur_start
    gap_by_name = defaultdict(float)
    starts = [h[0] for h in host]
    for a, b in gaps:
        gap_by_name[_host_at(host, starts, (a + b) // 2)] += (b - a) / 1e9
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:TOP]]
    return TraceSummary(window_s=window_s, busy_s=busy_ns / 1e9,
                        kernel_s=kernel_s, dtoh_s=dtoh_s,
                        device_ops=top(by_name),
                        idle_gaps=top(gap_by_name))


def _host_at(host: list, starts: list, t: int, scan: int = 4000) -> str:
    """The innermost host event covering instant t (the latest-starting
    one), or before_<next host event> where none but the call span does."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 1 - scan, -1), -1):
        start, end, name = host[j]
        if end >= t and name != CALL_SPAN:
            return name
    return "before_" + host[i][2] if i < len(host) else "after_last_host_event"
