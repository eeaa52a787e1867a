"""Per-phase step timing, the StepTimingStats analogue (reference:
mettagrid_tpu/profiling/phase_timing.py).

The reference cannot time phases inside one fused XLA program, so it stubs
each phase, re-jits the step and takes the difference; its docstring names
the per-phase wall clocks of serial phases as the same measure. The port's
step runs its phases in series and opens a ``torch.profiler`` span for each
(``step.actions``, ``step.obs``, ``step.rewards``, ... in engine/step.py),
so the phases are timed in place from those spans: the same function, not
the same formulation.
"""

from __future__ import annotations

import bisect
import time
from typing import Dict

import torch

PHASES = ("actions", "obs", "rewards")


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
        if evt.name.startswith("step."):
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


def measure_step_phases(
    program,
    init,
    state,
    actions,
    vibe_actions=None,
    k: int = 8,
    phases=PHASES,
) -> Dict[str, float]:
    """Per-phase seconds of the step on the device of ``state``.

    Returns {"step": total, "<phase>": cost, ..., "other": remainder}. The
    step is make_step(program, init, auto_reset=True) on that device, run k
    times from ``state`` with the same actions under torch.profiler after
    one warm-up step, its observation buffer carried. Every key reads one
    clock: on a CUDA device, "step" is the device time of all the step's
    kernels and copies and a phase the device time of the kernels its span
    launched (the profiler leaves these as they are, where it inflates the
    host clock); on the CPU, "step" is the host clock per step and a phase
    its span's host time. "other" is the step less the phases. The host
    clock per step on the card is what run_performance measures.
    """
    from mettagrid_tpu_torch.engine.step import make_step

    device = state.step_count.device
    cuda = device.type == "cuda"
    if vibe_actions is None:
        vibe_actions = torch.zeros_like(actions)
    step = make_step(program, init, auto_reset=True, device=device)
    st, out = step(state, actions, vibe_actions)
    if cuda:
        torch.cuda.synchronize(device)

    activities = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(k):
            st, out = step(st, actions, vibe_actions, None, out.observations)
        if cuda:
            torch.cuda.synchronize(device)
        host = (time.perf_counter() - t0) / k
    spans, kernels = span_times(prof, k)
    result: Dict[str, float] = {"step": sum(ms for ms, _ in kernels.values()) / 1e3 if cuda else host}
    for phase in phases:
        span = spans.get(f"step.{phase}", {"host_ms": 0.0, "device_ms": 0.0})
        result[phase] = (span["device_ms"] if cuda else span["host_ms"]) / 1e3
    result["other"] = max(result["step"] - sum(result[p] for p in phases), 0.0)
    return result
