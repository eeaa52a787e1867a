"""Where a bench variant's step time goes on the card.

    python -m mettagrid_tpu_torch.tools.profile_step [--variant V] [--out PATH]

V is one of tools/bench_run.py's variants: flagship (the default), combat,
general, arena_lp, arena_values, general_lp, arena_128, territory,
flagship_v3, arena_mood, arena_mood_v3, tithe_rrng, full_combat, network,
assembly_lines, bsp_arena.
Steps the variant (4096 envs x 24 agents, a pool of 64 maps, auto-reset,
observations carried) on the CUDA device, with the variant's observation
tail and, for tithe_rrng, the reference-RNG step. After the warm-up it times
--steps steps (32 by default) by the host clock without the profiler, then
traces as many more with torch.profiler and reports, per step: the host time
of each step phase (the ``step.*`` spans of engine/step.py) and the device
time of the kernels that start inside it, the device's busy time and idle
share (one minus kernel time over the untraced step time), the kernel
launches, the kernels that take the most device time, the
observation route (obs_fn.route), the action phase and its waves per step
(mean and largest over the untraced steps) and the peak device memory from
the start of the run. ``untraced`` holds the untraced steps' totals of
profiling/trace.py per step (``phase_timing.per_step``: each span's host ms
and self ms, the ``sync.<site>`` reads, ``host_syncs`` and ``actions.waves``,
the host's issue ms, and the set-up spans); ``idle_gaps_by_span`` the traced
window's idle device time per step by the innermost program span the host
was in (``phase_timing.idle_by_span``): a ``sync.<site>`` read, a ``step.*``
phase, the rest of the ``step`` call, or outside it. Prints one JSON object
and writes it to --out.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

from mettagrid_tpu_torch.profiling import trace as recorder
from mettagrid_tpu_torch.profiling.phase_timing import device_intervals, idle_by_span, per_step, span_times
from mettagrid_tpu_torch.tools.bench_run import AGENTS, ENVS, POOL, VARIANTS, BenchRun

STEPS = 32


def trace(bench, state, out, n: int, spans: bool = True):
    """n more steps of ``bench`` under torch.profiler. Returns (state, out,
    per-step figures): the traced host ms, the device's busy ms, the kernel
    launches, each ``step.*`` span's host ms and the device ms of the
    kernels that start inside it, the kernels that take the most device
    time, and the idle device ms per step by the innermost program span the
    host was in (phase_timing.idle_by_span). spans=False traces the device
    alone (no span figures): far fewer events to collect where a step issues
    many thousand launches."""
    acts = [torch.profiler.ProfilerActivity.CUDA] + ([torch.profiler.ProfilerActivity.CPU] if spans else [])
    recorder.drain()
    with torch.profiler.profile(activities=acts) as prof:
        state, out, secs = bench.timed(state, out, n)
    _, idle = idle_by_span(device_intervals(prof), recorder.drain())
    span_ms, by_name = span_times(prof, n)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    return state, out, {
        "step_ms_traced": secs / n * 1e3,
        "device_busy_ms_per_step": sum(k[0] for k in by_name.values()),
        "kernel_launches_per_step": sum(k[1] for k in by_name.values()) / n,
        "spans": span_ms,
        "top_kernels": [{"name": name[:120], "device_ms": ms, "per_step": cnt / n} for name, (ms, cnt) in top],
        "idle_gaps_by_span": {k: v * 1e3 / n for k, v in sorted(idle.items(), key=lambda kv: -kv[1])},
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", choices=VARIANTS, default="flagship")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")

    n = args.steps
    torch.cuda.reset_peak_memory_stats()
    bench = BenchRun(args.variant, seed=7)
    state, out = bench.warmed_up()
    setup = recorder.reset()
    state, out, secs = bench.timed(state, out, n)
    plain_ms = secs / n * 1e3
    untraced = {**per_step(recorder.snapshot()), "setup_s": per_step(setup)["setup_s"]}

    waves = bench.waves[-n:]
    state, out, traced = trace(bench, state, out, n)
    busy_ms = traced["device_busy_ms_per_step"]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    report = {
        "card": card,
        "variant": args.variant,
        "envs": ENVS,
        "agents": AGENTS,
        "pool": POOL,
        "obs_route": bench.step.obs_fn.route,
        "action_phase": bench.step.action_phase_kind,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "steps": n,
        "waves_per_step_mean": sum(waves) / n,
        "waves_per_step_max": max(waves),
        "step_ms_host_clock": plain_ms,
        "env_steps_per_s": ENVS / (plain_ms / 1e3),
        "device_idle_share": max(0.0, 1.0 - busy_ms / plain_ms),
        **traced,
        "device_idle_share_traced": max(0.0, 1.0 - busy_ms / traced["step_ms_traced"]),
        "untraced": untraced,
    }
    text = json.dumps(report)
    print(text)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1) + "\n")
    return report


if __name__ == "__main__":
    main()
