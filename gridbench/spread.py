"""Run cells several times, one process a run, and report each metric's spread.

    python3 -m gridbench.spread --workload <cell> --seeds 11,12,13 --seconds 10 [--trace 0|1] [--out FILE]

Each run is ``python3 -m gridbench.run`` as the benchmark's command runs it.
``--workload`` may be given more than once; each cell's runs come one after
another. Prints, and with ``--out`` appends as JSON lines, every run's result
(or its exit code and the end of its standard error), then per cell and
metric the median and the spread: the distance between the first and third
quartiles (statistics.quantiles, n=4) as a share of the median.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values: list) -> float:
    """Interquartile distance over the median (0 for fewer than 2 values)."""
    if len(values) < 2:
        return 0.0
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def run_once(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, "-m", "gridbench.run", "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    record = {"workload": workload, "seed": seed, "trace": trace, "rc": proc.returncode,
              "wall_s": time.perf_counter() - t0, "stderr_tail": proc.stderr[-1500:]}
    lines = proc.stdout.strip().splitlines()
    if proc.returncode == 0 and lines:
        record["result"] = json.loads(lines[-1])
    return record


def summary(records: list) -> dict:
    """{cell: {metric: {"median", "spread", "n"}}} over the runs with a result."""
    out: dict = {}
    for rec in records:
        res = rec.get("result")
        if not res:
            continue
        for name, m in res["metrics"].items():
            out.setdefault(rec["workload"], {}).setdefault(name, []).append(m["value"])
    return {cell: {name: {"median": statistics.median(v), "spread": spread(v), "n": len(v)}
                   for name, v in metrics.items()} for cell, metrics in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds, one run each")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    records = []
    for workload in args.workload:
        for seed in seeds:
            rec = run_once(workload, seed, args.seconds, args.trace)
            records.append(rec)
            res = rec.get("result") or {}
            line = {"workload": workload, "seed": seed, "rc": rec["rc"], "wall_s": round(rec["wall_s"], 1),
                    "correct": res.get("correct"), "metrics": {k: m["value"] for k, m in res.get("metrics", {}).items()},
                    "checks": {k: c["value"] for k, c in res.get("checks", {}).items()}}
            print(json.dumps(line), flush=True)
            if rec["rc"] != 0:
                print(rec["stderr_tail"], file=sys.stderr, flush=True)
            if args.out:
                args.out.parent.mkdir(parents=True, exist_ok=True)
                with args.out.open("a") as f:
                    f.write(json.dumps(rec) + "\n")
    print(json.dumps({"summary": summary(records)}), flush=True)
    return 0 if all(r.get("result", {}).get("correct") for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
