"""Kernel B7 (window_slices) on the live state of the non-fused cells, timed.

    PYTHONPATH=<checkout> python3 <checkout>/mettagrid_tpu_torch/tools/b7_sweep.py [--variant V ...] [--grids] [--out PATH]

For each variant (territory and full_combat by default; tools/bench_run.py
at full width: 4096 envs x 24 agents, pool 64), steps the bench 12 steps
from its reset, takes B7's inputs from the observation function
(``window_inputs``), holds the wrapper's windows equal to the plain version
``window_slices_ref`` word for word, and times the wrapper by CUDA events:
the mean of 50 launches queued behind a spin kernel, so that the card runs
them back to back. Where the module plans its launches (``window_plans``,
``launch_plan``) it also times every plan alone, and where every window
lies inside the image it times one ``torch.gather`` of the image over a
precomputed index, which computes the same windows (the index build is
not timed). With --grids it also times the wrapper's plan launched at 8,
16 and 32 warps per block and 1 to 4 blocks per SM (as many as the card
allows), each held equal to the plain version: the launch shapes the plan
chose among. It uses only the wrapper's call beside those, so run by path
with another checkout first on PYTHONPATH it times that checkout's B7 on
the same states. Prints one JSON line per variant and writes the list to
--out. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from mettagrid_tpu_torch.engine.kernels import tail_plan
from mettagrid_tpu_torch.engine.kernels import window_slices as b7
from mettagrid_tpu_torch.tools.bench_run import BenchRun

SEEDS = {"territory": 114, "full_combat": 125}


def queued_ms(fn, reps: int = 50) -> float:
    """Mean milliseconds per call on the card, the calls queued behind a spin
    kernel (longer spins until the host has issued them all before it ends)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cycles = 20_000_000
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
    raise RuntimeError("the host did not issue the calls within the longest spin")


def gather_index(img, row0, lane0, geom, Ch: int):
    """The int64 index [E, A*K*Ch] into img.view(E, -1) of every window
    word, or None where some window word lies outside the image."""
    E, HP, WPC = img.shape
    c = torch.arange(Ch, device=img.device)
    r = row0[..., None, None].long() + geom[:, 0, None].long()  # [E, A, K, 1]
    lane = lane0[..., None, None].long() + (geom[:, 1, None].long() * Ch + c)  # [E, A, K, Ch]
    if not bool(((r >= 0) & (r < HP)).all() and ((lane >= 0) & (lane < WPC)).all()):
        return None
    return (r * WPC + lane).reshape(E, -1)


def grid_sweep(args, plan) -> list:
    """``plan`` launched through the library at 8, 16 and 32 warps per block
    and 1-4 blocks per SM, where the card allows as many: one record each."""
    img, row0, lane0, geom, Ch = args["img"], args["row0"], args["lane0"], args["geom"], args["Ch"]
    E, HP, WPC = img.shape
    A, K = row0.shape[1], geom.shape[0]
    lib = b7._library()
    sms = torch.cuda.get_device_properties(img.device).multi_processor_count
    stream = torch.cuda.current_stream(img.device).cuda_stream
    ref = b7.window_slices_ref(**args)
    rows = []
    for warps in (8, 16, 32):
        allowed = tail_plan.occupancy(lib, "window_slices", plan._replace(warps=warps), img.device)[0]
        for per_sm in range(1, min(4, allowed) + 1):
            out = torch.empty_like(ref)
            grid = min(E, sms * per_sm)

            def call():
                err = lib.window_slices_launch(img.data_ptr(), row0.data_ptr(), lane0.data_ptr(), geom.data_ptr(),
                                               out.data_ptr(), E, HP, WPC, A, K, Ch, plan.vec, plan.store, warps,
                                               grid, plan.smem_bytes, stream)
                if err:
                    raise RuntimeError(f"window_slices: launch failed with cudaError_t {err}")

            call()
            torch.cuda.synchronize()
            assert torch.equal(out, ref), f"B7 at {warps} warps x {per_sm} blocks per SM differs"
            rows.append(dict(warps=warps, blocks_per_sm=per_sm, grid=grid, ms=queued_ms(call)))
    return rows


def sweep(variant: str, grids: bool = False) -> dict:
    bench = BenchRun(variant, seed=SEEDS.get(variant, 0))
    state, out = bench.run(*bench.reset(0), 12)
    args = bench.step.obs_fn.window_inputs(state)
    del state, out
    got, ref = b7.window_slices(**args), b7.window_slices_ref(**args)
    torch.cuda.synchronize()
    assert torch.equal(got, ref), f"B7 differs from its plain version on {variant}"
    del got, ref
    img = args["img"]
    E, HP, WPC = img.shape
    A, K, Ch = args["row0"].shape[1], args["geom"].shape[0], args["Ch"]
    row = dict(kernel="B7", variant=variant, E=E, A=A, K=K, Ch=Ch, image=[HP, WPC],
               ms=queued_ms(lambda: b7.window_slices(**args)), plan=getattr(b7.window_slices, "last_launch", None),
               device=torch.cuda.get_device_name(0))
    if hasattr(b7, "window_plans"):
        plans = []
        for plan in b7.window_plans(WPC, A, K, Ch, aligned=img.data_ptr() % 16 == 0):
            got, record = b7.launch_plan(plan, **args)
            assert torch.equal(got, b7.window_slices_ref(**args)), f"B7 under {plan} differs on {variant}"
            del got
            plans.append(dict(record, ms=queued_ms(lambda: b7.launch_plan(plan, **args))))
        row["plans"] = plans
        if grids:
            row["grids"] = grid_sweep(args, b7.window_plan(WPC, A, K, Ch, aligned=img.data_ptr() % 16 == 0))
    idx = gather_index(**args)
    if idx is None:
        row["gather_ms"] = None
    else:
        flat = img.view(E, -1)
        assert torch.equal(torch.gather(flat, 1, idx).view(-1), b7.window_slices_ref(**args).view(-1))
        row["gather_ms"] = queued_ms(lambda: torch.gather(flat, 1, idx))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", nargs="*", default=["territory", "full_combat"])
    ap.add_argument("--grids", action="store_true", help="time the wrapper's plan at other warps and blocks per SM")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("b7_sweep: needs a CUDA device")
    rows = []
    for variant in a.variant:
        row = sweep(variant, a.grids)
        print(json.dumps(row), flush=True)
        rows.append(row)
        torch.cuda.empty_cache()
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
