"""Reduction of a torch.profiler trace of the step to spans, kernels, busy
time and idle gaps.

``span_times`` is a frozen copy of mettagrid_tpu_torch's
profiling/phase_timing.span_times (as of this benchmark's first version): a
kernel counts to the ``step.*`` span whose device window it starts in.
"""

from __future__ import annotations

import bisect

import torch

SPAN_PREFIX = "step."


def span_times(prof, n: int) -> tuple[dict, dict]:
    """The ``step.*`` spans of a torch.profiler run over n steps. Returns
    ({span: {"host_ms", "device_ms"}} per step, where device_ms is the
    device time of the kernels that start inside the span's device window,
    and {kernel name: [device ms per step, launches]})."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    spans: dict = {}
    windows = []  # (start_us, end_us, name) of each step.* span on the device timeline
    kernels = []  # (start_us, duration_us, name) of each device event
    for evt in prof.events():
        tr = evt.time_range
        if evt.name.startswith(SPAN_PREFIX):
            span = spans.setdefault(evt.name, {"host_ms": 0.0, "device_ms": 0.0})
            if evt.device_type == cpu:
                span["host_ms"] += tr.elapsed_us() / 1e3 / n
            elif evt.device_type == cuda:
                windows.append((tr.start, tr.end, evt.name))
        elif evt.device_type == cuda:
            kernels.append((tr.start, tr.elapsed_us(), evt.name))
    windows.sort()
    starts = [w[0] for w in windows]
    by_name: dict = {}
    for start, dur, name in kernels:
        i = bisect.bisect_right(starts, start) - 1
        if i >= 0 and start < windows[i][1]:
            spans[windows[i][2]]["device_ms"] += dur / 1e3 / n
        k = by_name.setdefault(name, [0.0, 0])
        k[0] += dur / 1e3 / n
        k[1] += 1
    return spans, by_name


def intervals(prof) -> tuple[list, list]:
    """(device intervals, host step.* spans), each a sorted list of
    (start_us, end_us[, name]): every device event but the spans' own device
    windows, and the spans on the host's timeline."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    device, host = [], []
    for evt in prof.events():
        tr = evt.time_range
        if evt.name.startswith(SPAN_PREFIX):
            if evt.device_type == cpu:
                host.append((tr.start, tr.end, evt.name))
        elif evt.device_type == cuda:
            device.append((tr.start, tr.end))
    return sorted(device), sorted(host)


def busy_and_gaps(device: list, host: list) -> tuple[float, dict]:
    """Seconds in which some device operation ran (the union of the
    intervals), and the idle seconds between them by the ``step.*`` span the
    host was in at each gap's middle ("outside step spans" where none)."""
    busy_us = 0.0
    gaps: dict = {}
    cur_start = cur_end = None
    host_starts = [h[0] for h in host]

    def gap(a: float, b: float) -> None:
        mid = (a + b) / 2
        i = bisect.bisect_right(host_starts, mid) - 1  # the step's spans follow one another
        name = host[i][2] if i >= 0 and host[i][1] > mid else "outside step spans"
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6

    for start, end in device:
        if cur_end is None:
            cur_start, cur_end = start, end
        elif start > cur_end:
            busy_us += cur_end - cur_start
            gap(cur_end, start)
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy_us += cur_end - cur_start
    return busy_us / 1e6, gaps
