"""Count the synchronising CUDA calls of the program's step in one cell,
beside the program's own count of its host reads.

    python3 -m gridbench.sync_check --workload <cell> --seed <n> [--steps 64]

Builds the cell's system as a run does (port.System), resets it and steps
the traffic's warm-up steps, then steps ``--steps`` more with
``torch.cuda.set_sync_debug_mode("warn")`` on around each step call alone
(the traffic's draws outside it) and counts the warnings torch gives: each
is one call that waited for the device. Prints one JSON object: those calls
per step, the program's ``host_syncs`` per step over the same steps
(mettagrid_tpu_torch's profiling/trace.py; null where the program has no
such recorder), and where the calls were made (file:line, with counts). Not
a metric of the benchmark: a check that no host read escapes the program's
counter.
"""

from __future__ import annotations

import argparse
import json
import sys
import warnings
from collections import Counter

import torch

from gridbench import run, traffic
from gridbench.metrics import host_totals
from gridbench.port import System


def _syncs(t: dict) -> dict:
    return {k: v["count"] for k, v in t.items() if k == "host_syncs" or k.startswith("host_syncs.")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, default=64)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sync_check: needs a CUDA device", file=sys.stderr)
        return 2
    r = run.resolve(run.load_benchmark(), args.workload)
    spec, params = r["spec"], r["traffic"]
    dev = torch.device("cuda")
    sut = System(r["config"]["name"], spec, params["max_steps"] or spec["max_steps"], dev)
    gen = traffic.Traffic(params, args.seed, spec["envs"], spec["num_agents"], spec["actions"], spec["pool"], dev)
    state, out = sut.reset(args.seed)
    for _ in range(params["warmup_steps"]):
        acts, vibes, perm, maps = gen.draw()
        state, out = sut.step(state, acts, vibes, perm, out.observations, maps)
    torch.cuda.synchronize(dev)
    before = _syncs(host_totals.totals())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(args.steps):
            acts, vibes, perm, maps = gen.draw()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                state, out = sut.step(state, acts, vibes, perm, out.observations, maps)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(dev)
    after = _syncs(host_totals.totals())
    calls = [w for w in caught if str(w.message).startswith("called a synchronizing CUDA operation")]
    counted = {k: (v - before.get(k, 0)) / args.steps for k, v in after.items()}
    result = {
        "workload": args.workload,
        "seed": args.seed,
        "steps": args.steps,
        "card": run._card(),
        "synchronising_calls_per_step": len(calls) / args.steps,
        "host_syncs_per_step": counted.get("host_syncs") if after else None,
        "host_syncs_by_site_per_step": {k: v for k, v in counted.items() if k != "host_syncs"},
        "calls_by_place": dict(Counter(f"{w.filename}:{w.lineno}" for w in calls).most_common()),
        "messages": sorted({str(w.message).splitlines()[0][:200] for w in calls}),
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
