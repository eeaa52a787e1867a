"""Kernels B1-B5, B6a and B6b under every launch plan, on a bench
variant's live state.

    python -m mettagrid_tpu_torch.tools.tail_sweep [--variant V ...] [--out PATH]

For each variant (flagship and combat take B1, general takes B2, arena_128
B3, arena_lp and arena_values B4, general_lp B5, flagship_v3 B6a and
arena_mood_v3 B6b; the default is all nine) steps the main path (4096 envs x 24 agents, a pool of
64 maps) for 16 steps, then launches its tail kernel under each plan of
warps per block (4, 8, 12, 16) and stages that fits one block's shared
memory and holds the shapes (engine/kernels/tail_plan.py): 1 or 2 for B1
and B2; 1 for B4 and B6a; 0 (device mode: the image read from device
memory), 1 or 2 for B5; 0 for B3 and B6b. It holds each launch's
words and counts equal to the plain version, and times it by CUDA events
(the mean of 100 launches after one warm-up, queued behind a spin kernel so
that the time is the card's, not the host's rate). Prints one JSON line per
plan, marks the plan the wrapper picks, and writes the list to --out. Needs
a CUDA device.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from mettagrid_tpu_torch.engine.kernels import (
    obs_tail_dyn_v2,
    obs_tail_dyn_v3,
    obs_tail_dynobj_v2,
    obs_tail_static_v1,
    obs_tail_static_v2,
    obs_tail_static_v3,
    obs_tail_v1,
    tail_plan,
)
from mettagrid_tpu_torch.tools.bench_run import BenchRun

WARPS = (4, 8, 12, 16)
# route -> module
KERNELS = {"B1": obs_tail_static_v2, "B2": obs_tail_dynobj_v2, "B3": obs_tail_dyn_v2, "B4": obs_tail_static_v1,
           "B5": obs_tail_v1, "B6a": obs_tail_static_v3, "B6b": obs_tail_dyn_v3}
VARIANTS = ("flagship", "combat", "general", "arena_128", "arena_lp", "arena_values", "general_lp", "flagship_v3",
            "arena_mood_v3")


def _time_ms(fn, reps: int = 100) -> float:
    """Mean ms per launch by CUDA events, the launches queued behind a spin
    kernel (longer spins until the host has issued them all), so that the
    card runs them back to back."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cycles = 20_000_000  # about 10 ms at the H100's clock
    for _ in range(5):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        held = not start.query()
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise RuntimeError("the host did not issue the launches within the longest spin")


def sweep(variant: str) -> list:
    bench = BenchRun(variant, seed=7)
    state, _ = bench.run(*bench.reset(0), 16)
    fn = bench.step.obs_fn
    kind = fn.route
    if kind not in KERNELS:
        raise SystemExit(f"{variant} takes {kind}, not one of {sorted(KERNELS)}")
    mod = KERNELS[kind]
    plain = getattr(mod, f"{mod.__name__.rsplit('.', 1)[1]}_ref")
    args = fn.tail_inputs(state)
    call = dict(out_w=fn.out_w, **({} if fn.wide is None else {"wide": fn.wide}))
    sh, A = fn.tail_shapes, bench.program.num_agents
    HP = 2 * sh["HP2"] if kind in ("B6a", "B6b") else sh["HP"]  # the paired halves' rows
    N = args["rext"].shape[1] if kind == "B2" else 0
    ref_words, ref_att = plain(**args, **call)
    fn.tail(**args, **call)
    chosen = fn.tail.last_launch
    rounds = tail_plan.rounds_for(sh["G"], sh["K"], sh["S"], kind)
    rows = []
    for warps in WARPS:
        for stages in tail_plan.STAGE_COUNTS[kind]:
            smem = tail_plan.smem_bytes(kind, stages, warps, HP, sh["WPC"], fn.out_w, A, sh["G"], sh["S"], N, rounds)
            plan = tail_plan.TailPlan(rounds, stages, warps, smem)
            if smem > tail_plan.MAX_SMEM or tail_plan.refusal(kind, plan, HP, sh["WPC"], sh["G"], sh["S"], fn.out_w):
                continue
            words, att, record = mod.launch_plans([plan], **args, **call)
            torch.cuda.synchronize()
            assert torch.equal(words, ref_words) and torch.equal(att, ref_att), f"{variant}: {plan} differs"
            ms = _time_ms(lambda: mod.launch_plans([plan], **args, **call))
            kept = (warps, stages) == (chosen["warps"], chosen["stages"])
            row = dict(variant=variant, kernel=kind, ms=ms, chosen=kept, **record)
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", nargs="+", default=list(VARIANTS))
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tail_sweep needs a CUDA device")
    rows = [row for v in args.variant for row in sweep(v)]
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
    return rows


if __name__ == "__main__":
    main()
