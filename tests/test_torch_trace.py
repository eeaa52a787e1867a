"""The recorder of profiling/trace.py inside the port's step, on the CPU.

A small arena (8 envs of 8 agents on crowded 9x9 maps, so the pure-move
waves run past their two unrolled waves) is stepped with random moves. The
tests hold the counts to the wave loop's own rule, the log to the
profiler's clock, the totals and the log to the profiler switch, the
set-up spans to one build, and the step-path modules of engine/ to reading
device values only through ``trace.host_read``. A small territory program
(the bench variant at 4 envs) holds the counters ``aoe.pairs``,
``territory.points`` and ``obs.stage1_slots`` to the shapes they count and to adding no host read. The arithmetic of
profiling/phase_timing.py that tools/profile_step.py reports (``per_step``,
``innermost_segments``, ``idle_by_span``) is checked on hand-made logs.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from mettagrid_tpu_torch import builder as tbuilder
from mettagrid_tpu_torch import engine as tengine
from mettagrid_tpu_torch.engine.actions_fast import PURE_UNROLL_WAVES
from mettagrid_tpu_torch.maps.random_map import RandomMapBuilder
from mettagrid_tpu_torch.profiling import trace
from mettagrid_tpu_torch.profiling.phase_timing import idle_by_span, innermost_segments, per_step

A = 8
E = 8
PURE_SITE = "actions.pure_waves"
ENGINE = Path(__file__).resolve().parents[1] / "mettagrid_tpu_torch" / "engine"
# Modules of engine/ that run only while the program is compiled, never in a step.
HOST_COMPILE = {"__init__.py", "program.py", "init.py", "ir.py", "obs_caps.py", "mutfields.py", "rng_dep.py",
                "interop.py"}


def _build():
    cfg = tbuilder.make_arena(
        A, combat=False,
        map_builder=RandomMapBuilder.Config(agents=A, width=9, height=9, border_width=1, objects={"wall": 4}),
    )
    cfg.game.max_steps = 50
    program = tengine.compile_program(cfg)
    b = cfg.game.map_builder.create()
    maps = []
    for s in (1, 2):
        b.config.seed = s
        maps.append(b.build_for_num_agents(A))
    init = tengine.build_env_init(program, maps)
    reset = tengine.make_reset(program, init, E, device="cpu")
    step = tengine.make_step(program, init, auto_reset=True, device="cpu")
    return program, reset, step


@pytest.fixture(scope="module")
def built():
    trace.reset()
    trace.drain()
    program, reset, step = _build()
    setup = trace.snapshot()
    state, out = reset(0)
    setup_after_reset = trace.snapshot()
    rng = np.random.default_rng(0)
    n_actions = len(program.action_names)

    def draw():
        return torch.from_numpy(rng.integers(0, n_actions, (E, A), dtype=np.int32))

    state, out = step(state, draw(), torch.zeros((E, A), dtype=torch.int32))
    return dict(program=program, reset=reset, step=step, state=state, out=out, draw=draw, setup=setup,
                setup_after_reset=setup_after_reset, after_first=trace.snapshot())


def _steps(b, n):
    for _ in range(n):
        b["state"], b["out"] = b["step"](b["state"], b["draw"](), torch.zeros((E, A), dtype=torch.int32),
                                         None, b["out"].observations)


def _count(totals, name):
    return totals.get(name, {}).get("count", 0)


def test_setup_spans_once_per_build(built):
    assert _count(built["setup"], "setup.make_reset") == 1
    assert _count(built["setup"], "setup.make_step") == 1
    assert "setup.reset" not in built["setup"]
    assert _count(built["setup_after_reset"], "setup.reset") == 1
    after = built["after_first"]
    assert _count(after, "setup.first_step") == 1 and after["setup.first_step"]["ns"] > 0
    # The first step is set-up: no per-step figure counts it.
    assert not {k for k in after if not k.startswith("setup.")}
    built["reset"](1)  # a later reset is no set-up
    assert _count(trace.snapshot(), "setup.reset") == 1


def test_counts_follow_the_wave_loop(built):
    assert PURE_UNROLL_WAVES == 2
    moved_steps = past_unrolled = 0
    for _ in range(8):
        before = trace.snapshot()
        r0, c0 = built["state"].obj_r[:, :A].clone(), built["state"].obj_c[:, :A].clone()
        _steps(built, 1)
        after = trace.snapshot()
        d = {k: _count(after, k) - _count(before, k) for k in after}
        moved = bool(((built["state"].obj_r[:, :A] != r0) | (built["state"].obj_c[:, :A] != c0)).any())
        waves = d.get("actions.waves", 0)
        assert d["step.calls"] == 1 and d["step"] == 1 and d["step.actions"] == 1
        if moved:
            moved_steps += 1
            assert waves >= 1
        past_unrolled += waves > PURE_UNROLL_WAVES
        # The loop runs its two unrolled waves unread, then reads once after every wave from the second on.
        assert d.get(f"host_syncs.{PURE_SITE}", 0) == max(waves - 1, 0)
        assert d.get(f"sync.{PURE_SITE}", 0) == d.get(f"host_syncs.{PURE_SITE}", 0)
        # With a pool of two maps the auto-reset merge builds fresh states
        # every step, from tables uploaded once: it reads nothing on the host.
        assert not {k for k in d if k.startswith("host_syncs.auto_reset.")}
        sites = sum(v for k, v in d.items() if k.startswith("host_syncs."))
        assert d.get("host_syncs", 0) == sites
    assert moved_steps > 0
    assert past_unrolled > 0, "no step ran past the unrolled waves"
    totals = trace.snapshot()
    # The reads' waits are children of the action phase, which is a child of the step call.
    assert totals["step.actions"]["child_ns"] >= totals[f"sync.{PURE_SITE}"]["ns"]
    assert totals["step"]["child_ns"] >= totals["step.actions"]["ns"]


def test_the_profiler_switches_totals_to_log(built):
    trace.drain()
    before = trace.snapshot()
    _steps(built, 2)
    grown = trace.snapshot()
    assert trace.drain() == []
    assert grown["step.calls"]["count"] == before.get("step.calls", {}).get("count", 0) + 2
    assert grown["step"]["ns"] > before.get("step", {}).get("ns", 0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _steps(built, 3)
    assert trace.snapshot() == grown
    log = trace.drain()
    names = [r[0] for r in log]
    assert names.count("step") == 3 and names.count("step.actions") == 3 and names.count("step.obs") == 3
    assert any(n == f"sync.{PURE_SITE}" for n in names)
    assert all(r[2] <= r[3] for r in log)
    assert trace.drain() == []


def test_the_log_lies_on_the_profilers_clock(built):
    trace.drain()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _steps(built, 3)
    log = trace.drain()
    ranges = {}
    for evt in prof.profiler.kineto_results.events():
        if evt.name().startswith("step."):
            ranges.setdefault(evt.name(), []).append((evt.start_ns(), evt.end_ns()))
    syncs = [r for r in log if r[0].startswith("sync.")]
    assert syncs
    for name, parent, start, end in syncs:
        assert parent and parent.startswith("step."), (name, parent)
        assert any(s <= start and end <= e for s, e in ranges[parent]), (name, parent, start, end)
    # The phases' own log entries lie inside their profiler ranges too.
    for name, _, start, end in log:
        if name.startswith("step."):
            assert any(s <= start and end <= e for s, e in ranges[name]), name


REDUCTIONS = {"any", "all", "max", "min", "sum", "item", "amax", "amin", "count_nonzero", "prod", "mean"}
# Roots of values that live on the host: numpy, and the compiled program's tables.
HOST_ROOTS = {"np", "numpy", "program"}


def _root(node):
    while True:
        if isinstance(node, (ast.Attribute, ast.Subscript)):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, ast.Compare):
            node = node.left
        elif isinstance(node, ast.BinOp):
            node = node.left
        else:
            return node.id if isinstance(node, ast.Name) else None


def _device_reduction(node) -> bool:
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.func.attr in REDUCTIONS
            and _root(node.func.value) not in HOST_ROOTS)


def host_reads(source: str) -> list:
    """Line numbers where ``source`` reads a device value on the host other
    than through ``trace.host_read``: ``.item()``, ``.tolist()``,
    ``bool``/``int``/``float`` of a reduction (or bool of an element), and a
    reduction tested as a truth value."""
    found = []
    for node in ast.walk(ast.parse(source)):
        bad = False
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.func.attr in ("item", "tolist"):
            bad = True
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.func.id in ("bool", "int", "float"):
            arg = node.args[0] if node.args else None
            bad = _device_reduction(arg) or (node.func.id == "bool" and isinstance(arg, ast.Subscript))
        elif isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            bad = _device_reduction(node.test)
        elif isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            bad = _device_reduction(node.operand)
        elif isinstance(node, ast.BoolOp):
            bad = any(_device_reduction(v) for v in node.values)
        if bad:
            found.append(node.lineno)
    return found


def test_the_scan_finds_a_host_read():
    bad = ["bool(x.any())", "int(t.sum(dim=1).max())", "y = x.item()", "y = x.tolist()", "if x.any():\n    pass",
           "while not done.all():\n    pass", "z = a or m.any()", "bool(t[0])"]
    for src in bad:
        assert host_reads(src), src
    fine = ["trace.host_read(x.any(), 's')", "bool(np.any(k == 1))", "if np.asarray(program.t).any():\n    pass",
            "int(np.max(c))", "bool(program.territories)"]
    for src in fine:
        assert not host_reads(src), src


def test_step_path_reads_only_through_host_read():
    paths = [p for p in sorted(ENGINE.glob("*.py")) + sorted(ENGINE.glob("kernels/*.py")) if p.name not in HOST_COMPILE]
    assert any(p.name == "actions_fast.py" for p in paths)
    found = {p.relative_to(ENGINE).as_posix(): host_reads(p.read_text()) for p in paths}
    assert not {k: v for k, v in found.items() if v}
    sites = sum(p.read_text().count("trace.host_read(") for p in paths)
    assert sites >= 13


def test_per_step_arithmetic():
    totals = {
        "setup.make_step": {"count": 1, "ns": 2_000_000_000, "child_ns": 0},
        "step.calls": {"count": 4, "ns": 0, "child_ns": 0},
        "step": {"count": 4, "ns": 40_000_000, "child_ns": 30_000_000},
        "step.actions": {"count": 4, "ns": 20_000_000, "child_ns": 8_000_000},
        "sync.actions.pure_waves": {"count": 8, "ns": 8_000_000, "child_ns": 0},
        "host_syncs": {"count": 8, "ns": 0, "child_ns": 0},
        "actions.waves": {"count": 12, "ns": 0, "child_ns": 0},
    }
    r = per_step(totals)
    assert r["steps"] == 4 and r["setup_s"] == {"setup.make_step": 2.0}
    assert r["spans"]["step.actions"] == {"host_ms": 5.0, "self_ms": 3.0, "calls": 1.0}
    assert r["counts"] == {"host_syncs": 2.0, "actions.waves": 3.0}
    assert r["sync_wait_ms"] == 2.0 and r["issue_ms"] == 8.0
    assert per_step({}) == {"steps": 0, "setup_s": {}}


def test_idle_gaps_go_to_the_innermost_span():
    log = [("step", None, 0, 100), ("step.actions", "step", 10, 60), ("sync.actions.pure_waves", "step.actions", 30, 40),
           ("step.obs", "step", 70, 90)]
    assert innermost_segments(log) == [(0, 10, "step"), (10, 30, "step.actions"), (30, 40, "sync.actions.pure_waves"),
                                       (40, 60, "step.actions"), (60, 70, "step"), (70, 90, "step.obs"),
                                       (90, 100, "step")]
    device = [(0, 5), (3, 12), (35, 50), (95, 130), (140, 150)]  # ns; the first two overlap
    busy, gaps = idle_by_span(device, log)
    assert busy == pytest.approx(72e-9)
    assert gaps == {"step.actions": pytest.approx(28e-9), "sync.actions.pure_waves": pytest.approx(5e-9),
                    "step": pytest.approx(15e-9), "step.obs": pytest.approx(20e-9),
                    "outside program spans": pytest.approx(10e-9)}


TE = 4  # envs of the territory program
COUNTERS = ("aoe.pairs", "territory.points")


@pytest.fixture(scope="module")
def territory_built():
    from mettagrid_tpu_torch.tools import bench_run

    cfg = bench_run.make_territory_cfg(A)
    program, init = bench_run.build_pool(cfg, 2)
    reset = tengine.make_reset(program, init, TE, device="cpu")
    step = tengine.make_step(program, init, auto_reset=True, device="cpu")
    state, out = reset(0)
    rng = np.random.default_rng(1)
    n_actions = len(program.action_names)

    def draw():
        return torch.from_numpy(rng.integers(0, n_actions, (TE, A), dtype=np.int32))

    zeros = torch.zeros((TE, A), dtype=torch.int32)
    state, out = step(state, draw(), zeros)  # the first call is set-up
    b = dict(program=program, init=init, step=step, state=state, out=out, draw=draw, zeros=zeros)

    def one():
        before = trace.snapshot()
        b["state"], b["out"] = b["step"](b["state"], b["draw"](), b["zeros"], None, b["out"].observations)
        after = trace.snapshot()
        return {k: _count(after, k) - _count(before, k) for k in after}

    b["one"] = one
    return b


def test_territory_counters_count_the_stated_shapes(territory_built):
    b = territory_built
    p, state = b["program"], b["state"]
    d = b["one"]()
    E, N = state.obj_type.shape
    junctions = [i for i, name in enumerate(p.type_names) if name.startswith("junction_")]
    emitters = int((torch.isin(state.obj_type, torch.tensor(junctions)) & state.obj_alive).sum(1).max())
    assert len(p.aoe_specs) == 2 and emitters == 4
    # Each spec over its type's slots, two junctions in every pool map.
    assert d["aoe.pairs"] == len(p.aoe_specs) * E * 2 * A
    # The agents' cells in the territory phase, each times the emitters: the AOE mask's cells are scored
    # once per pool map (no agent emits territory), outside the step.
    assert d["territory.points"] == E * A * emitters
    # Over the static background stage 1 encodes the agents alone.
    assert d["obs.stage1_slots"] == E * A


@pytest.mark.parametrize("path", ["bounded", "dense"])
def test_aoe_pairs_count_the_evaluated_sources(territory_built, monkeypatch, path):
    """``aoe.pairs`` counts the (source slot, agent) pairs the AOE phase
    evaluates: Σ_k E·J_k·A where the pool bounds each spec's sources (J_k the
    most slots of its type in a pool map), E·N·A for each spec over every slot
    where a type may be written. The bounded phase reads nothing back; the
    dense one reads the number of sources with presence deltas."""
    from mettagrid_tpu_torch.engine import aoe

    b = territory_built
    p, init, state = b["program"], b["init"], b["state"]
    E, N = state.obj_type.shape
    if path == "dense":
        written = aoe.maybe_written_pool_fields(p)
        monkeypatch.setattr(aoe, "maybe_written_pool_fields", lambda program: written | {"obj_type"})
    phase = trace.program_step(aoe.make_aoe_phase(p, init))
    phase(state)  # the first call is set-up
    before = trace.snapshot()
    phase(state)
    after = trace.reset()  # leaves no name of this phase's reads in the totals of later tests
    d = {k: _count(after, k) - _count(before, k) for k in after}
    reads = {k: v for k, v in d.items() if v and (k.startswith("sync.") or k.startswith("host_syncs"))}
    if path == "bounded":
        J = [int((init.obj_type == s.type_id).sum(axis=1).max()) for s in p.aoe_specs]
        assert J == [2, 2]
        assert d["aoe.pairs"] == sum(E * j * A for j in J)
        assert reads == {}
    else:
        assert d["aoe.pairs"] == len(p.aoe_specs) * E * N * A
        assert reads == {"sync.aoe.presence_sources": 1, "host_syncs": 1, "host_syncs.aoe.presence_sources": 1}


def test_territory_counters_are_absent_on_the_arena(built):
    before = trace.snapshot()
    _steps(built, 2)
    after = trace.snapshot()
    assert _count(after, "step.calls") - _count(before, "step.calls") == 2
    assert all(_count(after, c) == _count(before, c) for c in COUNTERS)


def test_territory_counters_add_no_host_read(territory_built, monkeypatch):
    b = territory_built
    counted = b["one"]()
    assert all(counted[c] > 0 for c in COUNTERS)
    real = trace.count
    monkeypatch.setattr(trace, "count", lambda name, n=1: None if name in COUNTERS else real(name, n))
    silent = b["one"]()
    assert not set(COUNTERS) & {k for k, v in silent.items() if v}

    def phase_reads(d):  # the action phase's wave reads follow the drawn moves
        return {k: v for k, v in d.items() if k.startswith("host_syncs.") and not k.startswith("host_syncs.actions.")}

    # The phase's emitter read, with the counters or without, and nothing more.
    assert phase_reads(counted) == phase_reads(silent) == {"host_syncs.territory.emitters": 1}
    for d in (counted, silent):
        assert d["host_syncs"] == sum(v for k, v in d.items() if k.startswith("host_syncs."))
