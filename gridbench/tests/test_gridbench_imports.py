"""No module the benchmark's command loads is jax, jaxlib, flax, optax or the
JAX package (top-level names compared whole: the program's own name,
mettagrid_tpu_torch, begins with the JAX package's), and the plain reference
loads nothing of the program."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

LOAD_ALL = r"""
import json, sys
from pathlib import Path
from gridbench import run, traffic
from gridbench.port import System, config_module
import torch
bench = run.load_benchmark()
for cell in bench["workloads"]:
    r = run.resolve(bench, cell["name"])
    config_module(r["config"]["name"]).port_config(r["spec"], r["spec"]["max_steps"])
    run.reference_module(r["spec"]["game"])
    run.reference_pool({**r["spec"], "pool": 1})
    for m in r["per_layer"]:
        run.reader(m["name"])
spec = {**run.resolve(bench, "arena.random_long")["spec"], "envs": 2, "pool": 1}
System("arena", spec, spec["max_steps"], torch.device("cpu"))
print(json.dumps(run.forbidden_modules()))
"""

REFERENCE_ONLY = r"""
import json, sys
import gridbench.reference.arena
import gridbench.reference.maps.mapgen_random
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules} & {"mettagrid_tpu_torch", "mettagrid_tpu", "jax", "torch"})))
"""


def _run(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_benchmark_loads_no_jax():
    assert _run(LOAD_ALL) == []


def test_reference_loads_nothing_of_the_program():
    assert _run(REFERENCE_ONLY) == []
