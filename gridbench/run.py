"""Run one cell of the benchmark once, on one NVIDIA H100.

    python3 -m gridbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (an entry of BENCHMARK.json's
``workloads``) names its configuration and traffic; everything else is found
by those names (see gridbench/__init__.py). A run:

1. set-up: builds the program from the configuration (host compile, timed as
   ``setup.map_pool_s``), resets the envs with the seed and steps the
   traffic's warm-up steps, so every kernel is built and loaded;
2. the window: steps the envs closed-loop for ``--seconds`` seconds, each
   step's inputs drawn on the device from the seed (traffic.py), a CUDA event
   recorded after each step; with ``--trace 1`` then the traffic's
   ``trace_steps`` more steps under torch.profiler;
3. the check: the pool's maps against the reference's own draw of them
   (reference/maps/<kind>.py), and the results of envs sampled from the seed
   against the plain reference (reference/<game>.py) stepped on those maps
   with the same inputs from the reset on, after the peak memory is read and
   the program's state freed.

The last line of standard output is one JSON object: ``correct``,
``attempted`` (env-steps run in the window), ``failed`` (sampled envs whose
results disagree), ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number compared beside its limit,
which also close standard error. Without a CUDA device, or with fewer than
the cell asks for, it prints no result and exits 2; if jax, jaxlib, flax,
optax or the JAX package is loaded once the window has closed, exits 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mettagrid_tpu")
# Caches of compilers the program may use, at fixed paths in the checkout
# (its nvcc kernels go to build/mettagrid_tpu_torch/ by themselves).
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gridbench import check, traffic  # noqa: E402
from gridbench.metrics import spans  # noqa: E402


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _load_by_path(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def resolve(bench: dict, workload: str) -> dict:
    """The cell's entry, its configuration file's contents, its traffic and
    the metrics it reports, each found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def applies(metric):
        return "workloads" not in metric or workload in metric["workloads"]

    return {
        "cell": cell,
        "config": config,
        "spec": json.loads((ROOT / config["file"]).read_text()),
        "traffic": traffic.load(cell["traffic"]),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def reader(name: str):
    """``metrics/<name>.py``'s read(ctx)."""
    return _load_by_path(HERE / "metrics" / f"{name}.py", f"gridbench_metric_{name}").read


def reference_module(game: str):
    return _load_by_path(HERE / "reference" / f"{game}.py", f"gridbench_reference_{game}")


def reference_pool(spec: dict) -> list:
    """The pool's maps, map i drawn from seed ``pool_seed + i`` by
    ``reference/maps/<kind>.py``, independently of the program."""
    kind = spec["map"]["kind"]
    draw = _load_by_path(HERE / "reference" / "maps" / f"{kind}.py", f"gridbench_reference_map_{kind}").draw
    return [draw(spec["map"], spec["pool_seed"] + i) for i in range(spec["pool"])]


class Clock:
    """Marks after each step: CUDA events on the card (read once the window
    has closed), the host clock elsewhere (tests on the CPU only)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            evt = torch.cuda.Event(enable_timing=True)
            evt.record()
            self.marks.append(evt)
        else:
            self.marks.append(time.perf_counter())

    def gaps_ms(self) -> list:
        """The gap before each mark but the first, in ms."""
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def p95(values: list) -> float:
    """The 95th percentile, as statistics.quantiles gives it (exclusive
    method), of every value."""
    return statistics.quantiles(values, n=100)[94]


def per_second(gaps_ms: list) -> list:
    """The mean gap of the steps completed in each second of the window."""
    gaps = np.asarray(gaps_ms)
    second = (np.cumsum(gaps) // 1000).astype(int)
    return [float(gaps[second == k].mean()) for k in np.unique(second)]


def window_metrics(envs: int, steps: int, seconds: float, gaps_ms: list) -> dict:
    """env_steps_per_s over all the window's steps and time; step_ms_p95 over
    every step's gap."""
    return {"env_steps_per_s": envs * steps / seconds, "step_ms_p95": p95(gaps_ms)}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave nothing"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda", spec_overrides=None,
             traffic_overrides=None, feed=None, wrap_step=None, bench=None) -> dict:
    """One run of ``workload``; returns the result object.

    The keyword arguments after ``trace`` serve the benchmark's tests and its
    control, never a measured run: ``device`` "cpu", smaller sizes
    (``spec_overrides``, ``traffic_overrides``), ``feed(actions, vibes,
    perm, reset_maps)`` -> the inputs handed to the program in place of the
    traffic's (the reference keeps the traffic's), and ``wrap_step(step)``
    -> a step put in the program's place."""
    from gridbench.port import System

    dev = torch.device(device)
    r = resolve(bench or load_benchmark(), workload)
    spec = {**r["spec"], **(spec_overrides or {})}
    params = {**r["traffic"], **(traffic_overrides or {})}
    max_steps = params["max_steps"] or spec["max_steps"]
    E, A, P = spec["envs"], spec["num_agents"], spec["pool"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    sut = System(r["config"]["name"], spec, max_steps, dev)
    step = wrap_step(sut.step) if wrap_step else sut.step
    gen = traffic.Traffic(params, seed, E, A, spec["actions"], P, dev)

    def one_step(state, out):
        inputs = gen.draw()
        if feed:
            inputs = feed(*inputs)
        acts, vibes, perm, maps = inputs
        return step(state, acts, vibes, perm, out.observations, maps)

    state, out = sut.reset(seed)
    state_bytes = sum(t.numel() * t.element_size() for t in state)
    for _ in range(params["warmup_steps"]):
        state, out = one_step(state, out)
    steps = params["warmup_steps"]

    # The envs checked, and a sample of the answers due in the window: the
    # outputs of its steps 1, 2, 4, 8, ..., copied to the host without a
    # wait (into pinned memory on the card), read once the window has closed.
    rows_np = np.sort(np.random.default_rng(seed).choice(E, size=min(spec["check_envs"], E), replace=False))
    rows = torch.from_numpy(rows_np).to(dev)
    captured = {}

    # --- the window ---
    _sync(dev)
    clock = Clock(dev)
    t0 = time.perf_counter()
    setup_s = t0 - T_START
    clock.mark()
    n = 0
    while True:
        state, out = one_step(state, out)
        clock.mark()
        n += 1
        if n & (n - 1) == 0:
            captured[steps + n] = {k: v.to("cpu", non_blocking=True) for k, v in sut.outputs(out, rows).items()}
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(dev)
    window_s = time.perf_counter() - t0
    steps += n
    gaps = clock.gaps_ms()

    # --- the traced steps ---
    traced = None
    if trace:
        k = params["trace_steps"]
        activities = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            t1 = time.perf_counter()
            for _ in range(k):
                state, out = one_step(state, out)
            _sync(dev)
            traced_s = time.perf_counter() - t1
        steps += k
        span_ms, kernels = spans.span_times(prof, k)
        device_iv, host_iv = spans.intervals(prof)
        busy_s, idle_gaps = spans.busy_and_gaps(device_iv, host_iv)
        del prof
        traced = {"steps": k, "spans": span_ms, "kernels": kernels, "busy_s": busy_s, "window_s": traced_s,
                  "idle_gaps": idle_gaps}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    tokens_emitted = int(out.tokens_attempted.clamp(max=spec["obs"]["num_tokens"]).sum())

    # --- the check, with the program's state freed ---
    got = sut.results(state, out, rows)
    got.update({f"{k}@{s}": v.numpy() for s, outs in captured.items() for k, v in outs.items()})
    del state, out, captured
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t2 = time.perf_counter()
    inputs = traffic.Traffic(params, seed, E, A, spec["actions"], P, dev).replay(steps, rows)
    pool = reference_pool(spec)
    ref = reference_module(spec["game"]).Arena(spec, pool, rows_np % P, max_steps)
    want = {"pool_maps": np.stack(pool)}
    got["pool_maps"] = np.stack(sut.grids)
    for i in range(steps):
        ref.step(**{k: v[i] for k, v in inputs.items()})
        if f"observations@{i + 1}" in got:
            want.update({f"{k}@{i + 1}": v for k, v in ref.outputs().items()})
    want.update(ref.results())
    numbers = check.compare(want, got)
    reference_s = time.perf_counter() - t2
    correct = all(v <= check.LIMIT for v in numbers.values())

    ctx = {
        "map_pool_s": sut.map_pool_s,
        "trace": traced,
        "untraced_ms_per_step": window_s * 1e3 / n,
        "tokens_emitted": tokens_emitted,
        "shapes": {"envs": E, "agents": A, "objects": sut.objects, "pool": P, "resources": len(spec["resources"]),
                   "tags": len({"agent", *spec["objects"]}), "static_background": spec["background"] == "static"},
    }
    if trace:
        metrics = {}
        for m in r["per_layer"]:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {**window_metrics(E, n, window_s, gaps), "peak_mem_gib": peak / 2**30, "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]} for m in r["end_to_end"]}
    result = {
        "correct": correct,
        "attempted": E * n,
        "failed": check.wrong_envs(want, got),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
            "count": 1,
            "memory_peak_bytes": peak,
        },
        "run": {"steps_in_window": n, "window_s": window_s, "setup_s": setup_s, "map_pool_s": sut.map_pool_s,
                "state_bytes": state_bytes, "objects": sut.objects, "reference_s": reference_s,
                "checked_envs": [int(e) for e in rows_np], "steps_checked": steps,
                "gap_ms_by_second": per_second(gaps)},
    }
    if trace:
        result["device"]["busy_s"] = traced["busy_s"]
        result["device"]["window_s"] = traced["window_s"]
        top = sorted(traced["kernels"].items(), key=lambda kv: -kv[1][0])[:10]
        result["breakdown"] = {
            "device_ops": [[name[:160], ms * traced["steps"] / 1e3] for name, (ms, _) in top],
            "idle_gaps": sorted(([k, v] for k, v in traced["idle_gaps"].items()), key=lambda kv: -kv[1])[:10],
        }
    result["checks"] = {k: {"value": v, "limit": check.LIMIT} for k, v in numbers.items()}
    return result


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (the part before the first dot),
    compared whole, is jax, jaxlib, flax, optax or the JAX package."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_benchmark()
    chips = resolve(bench, args.workload)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gridbench: the cell needs {chips} CUDA device(s), found {found}; no result", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), bench=bench)
    loaded = forbidden_modules()
    if loaded:
        print(f"gridbench: the process loaded {loaded}; no result", file=sys.stderr)
        return 3
    print(f"gridbench: card {_card()}; setup {result['run']['setup_s']:.3f} s, "
          f"window {result['run']['window_s']:.3f} s, reference {result['run']['reference_s']:.3f} s",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
