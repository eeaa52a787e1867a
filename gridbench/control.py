"""The control of ``correct``: a run whose program is handed the agents in
slot order while the reference keeps the traffic's order. It breaks the
configuration's guarantee that agents act in the drawn order, which a faster
but unordered move phase would tempt, and has to come out not correct.

    python3 -m gridbench.control --workload <cell> --seeds 21,22,23 --seconds 3 [--out FILE]

One process, one run per seed at the cell's own size, on the card. Prints
each run's numbers compared; exits 0 when every run came out not correct.
The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch


def identity_order(actions, vibes, perm, reset_maps):
    """The agents in slot order, whatever the traffic drew."""
    order = torch.arange(perm.shape[1], dtype=perm.dtype, device=perm.device).expand_as(perm).contiguous()
    return actions, vibes, order, reset_maps


def main(argv=None) -> int:
    from gridbench import run

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gridbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    caught = True
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run.run_cell(args.workload, seed, args.seconds, False, feed=identity_order)
        line = {"workload": args.workload, "seed": seed, "control": "identity_order", "correct": res["correct"],
                "failed": res["failed"], "checks": {k: c["value"] for k, c in res["checks"].items()},
                "steps_checked": res["run"]["steps_checked"]}
        print(json.dumps(line), flush=True)
        if args.out:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            with args.out.open("a") as f:
                f.write(json.dumps(line) + "\n")
        caught &= not res["correct"]
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
