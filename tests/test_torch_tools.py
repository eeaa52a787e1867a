"""The port's measuring tools and small host modules on the CPU: twins of
tests/test_profiling.py, tests/test_phase_timing.py, the util cases of
tests/test_small_utils.py and tests/test_test_support.py.

The host modules (the stopwatch, the monitors, the tracer, util/ and
test_support/) are also held to their JAX twins, which import no JAX, on the
same inputs: seeded numpy data, one clock stepped by hand for both timers,
and the same Simulation driven in both packages.
"""

import json
import time
import types

import numpy as np
import pytest
import torch

import mettagrid_tpu.config.game_config as jgc
import mettagrid_tpu.config.handler_config as jhc
import mettagrid_tpu.profiling.monitor as jmonitor
import mettagrid_tpu.profiling.stopwatch as jstopwatch
import mettagrid_tpu.test_support as jts
import mettagrid_tpu.util as jutil
import mettagrid_tpu.util.tracer as jtracer
import mettagrid_tpu_torch.config.game_config as tgc
import mettagrid_tpu_torch.config.handler_config as thc
import mettagrid_tpu_torch.profiling.monitor as tmonitor
import mettagrid_tpu_torch.profiling.stopwatch as tstopwatch
import mettagrid_tpu_torch.test_support as tts
import mettagrid_tpu_torch.util as tutil
import mettagrid_tpu_torch.util.tracer as ttracer
from mettagrid_tpu.simulator import Simulation as JSimulation
from mettagrid_tpu_torch.builder import make_arena
from mettagrid_tpu_torch.engine import build_env_init, compile_program, make_reset, make_step
from mettagrid_tpu_torch.maps.random_map import RandomMapBuilder
from mettagrid_tpu_torch.perf.harness import PerfResult, run_performance
from mettagrid_tpu_torch.profiling import MemoryMonitor, Stopwatch, SystemMonitor
from mettagrid_tpu_torch.profiling.phase_timing import measure_step_phases
from mettagrid_tpu_torch.simulator import Simulation
from mettagrid_tpu_torch.test_support import ObservationHelper, move, noop, use
from mettagrid_tpu_torch.util import (
    calculate_diversity_bonus,
    checkpoint_metadata,
    load_symbol,
    parse_uri,
    resolve_latest_checkpoint,
    unroll_nested_dict,
)
from mettagrid_tpu_torch.util.tracer import NullTracer, Tracer

PHASE_KEYS = {"step", "actions", "obs", "rewards", "other"}


def test_stopwatch_basic():
    sw = Stopwatch()
    with sw.time("phase_a"):
        time.sleep(0.01)
    assert sw.elapsed("phase_a") >= 0.01
    assert sw.summary()["phase_a"]["count"] == 1


def test_stopwatch_checkpoints_and_decorator():
    sw = Stopwatch()

    @sw("work")
    def work():
        time.sleep(0.005)

    work()
    work()
    assert sw.summary()["work"]["count"] == 2

    sw.start("cp")
    time.sleep(0.002)
    lap = sw.checkpoint("first", name="cp")
    assert lap >= 0.002


def test_tracer_writes_chrome_trace(tmp_path):
    tr = Tracer()
    with tr.span("episode", idx=1):
        with tr.span("step"):
            pass
    tr.instant("marker")
    p = tmp_path / "trace.json"
    tr.save(str(p))
    data = json.loads(p.read_text())
    names = [e["name"] for e in data["traceEvents"]]
    assert "episode" in names and "step" in names and "marker" in names


def test_null_tracer_noop(tmp_path):
    tr = NullTracer()
    with tr.span("x"):
        pass
    tr.save(str(tmp_path / "t.json"))
    assert not (tmp_path / "t.json").exists()


def test_monitors():
    mm = MemoryMonitor()
    assert mm.sample() > 0
    sm = SystemMonitor()
    snap = sm.poll()
    assert "time" in snap


def _arena(agents: int, width: int, seed: int):
    cfg = make_arena(
        agents, combat=False,
        map_builder=RandomMapBuilder.Config(agents=agents, width=width, height=width, border_width=1),
    )
    program = compile_program(cfg)
    builder = cfg.game.map_builder.create()
    builder.config.seed = seed
    return program, build_env_init(program, [builder.build_for_num_agents(agents)])


def test_measure_step_phases_smoke():
    program, init = _arena(4, 10, 1)
    E = 8
    state, _ = make_reset(program, init, E, device="cpu")(0)
    rng = np.random.default_rng(0)
    actions = torch.as_tensor(rng.integers(0, len(program.action_names), (E, 4)), dtype=torch.int32)

    timing = measure_step_phases(program, init, state, actions, k=2)
    assert set(timing) == PHASE_KEYS
    assert timing["step"] > 0
    assert all(v >= 0 for v in timing.values())
    # Timed in place, each phase is a part of the step it ran in.
    assert all(0 < timing[k] <= timing["step"] for k in ("actions", "obs", "rewards"))
    parts = sum(timing[k] for k in ("actions", "obs", "rewards"))
    assert np.isclose(timing["other"], max(timing["step"] - parts, 0.0))


def test_harness_phase_timing_integration(tmp_path):
    """run_performance(phase_timing=...) records the per-phase dict in
    result.extra; the result saves, loads and compares."""
    program, init = _arena(2, 8, 2)
    E = 4
    reset = make_reset(program, init, E, device="cpu")
    step = make_step(program, init, device="cpu")
    res = run_performance(
        step,
        reset,
        num_envs=E,
        num_agents=2,
        n_actions=len(program.action_names),
        iters_per_round=3,
        rounds=2,
        warmup_iters=2,
        max_cv=None,
        phase_timing=(program, init),
    )
    assert set(res.extra["phase_timing_s"]) == PHASE_KEYS
    assert len(res.round_sps) == 2 and res.env_steps_per_s > 0
    assert res.agent_steps_per_s == res.env_steps_per_s * 2
    path = tmp_path / "perf.json"
    res.save(str(path))
    assert PerfResult.load(str(path)).compare(res) == {"env_sps_ratio": 1.0, "agent_sps_ratio": 1.0}


def test_harness_cv_gate():
    program, init = _arena(2, 8, 2)
    reset = make_reset(program, init, 4, device="cpu")
    step = make_step(program, init, device="cpu")
    with pytest.raises(RuntimeError, match="unstable benchmark"):
        run_performance(step, reset, num_envs=4, num_agents=2, n_actions=len(program.action_names),
                        iters_per_round=2, rounds=3, warmup_iters=1, max_cv=-1.0)


def _nested(rng, depth: int) -> dict:
    """A seeded nested dict of numbers, strings and arrays."""
    out = {}
    for i in range(int(rng.integers(1, 5))):
        kind = int(rng.integers(0, 4)) if depth < 3 else int(rng.integers(0, 3))
        key = f"k{i}_{int(rng.integers(0, 100))}"
        out[key] = (float(rng.normal()), f"s{int(rng.integers(0, 9))}", rng.integers(0, 9, 3), None)[kind] \
            if kind < 3 else _nested(rng, depth + 1)
    return out


def test_unroll_nested_dict():
    d = {"a": 1, "b": {"c": 2, "d": {"e": 3}}}
    assert dict(unroll_nested_dict(d)) == {"a": 1, "b/c": 2, "b/d/e": 3}
    assert list(unroll_nested_dict(d)) == list(jutil.unroll_nested_dict(d))


@pytest.mark.parametrize("seed", range(4))
def test_unroll_nested_dict_matches_jax(seed):
    d = _nested(np.random.default_rng(seed), 0)
    port, ref = list(unroll_nested_dict(d)), list(jutil.unroll_nested_dict(d))
    assert [k for k, _ in port] == [k for k, _ in ref]
    for (_, a), (_, b) in zip(port, ref):
        assert a is b


def test_diversity_bonus_shapes_and_range():
    rewards = np.array([1.0, 1.1, 5.0, 5.2])
    groups = np.array([0, 0, 1, 1])
    factors = calculate_diversity_bonus(rewards, groups, 0.5, 0.5)
    assert factors.shape == (4,)
    assert (factors >= 1.0).all()
    # Agents near their group mean and far from the other group score high.
    assert factors[0] > 1.5
    np.testing.assert_array_equal(factors, jutil.calculate_diversity_bonus(rewards, groups, 0.5, 0.5))


def test_diversity_bonus_single_group():
    factors = calculate_diversity_bonus(np.array([1.0, 2.0]), np.array([0, 0]), 1.0, 1.0)
    assert factors.shape == (2,)
    np.testing.assert_array_equal(factors, jutil.calculate_diversity_bonus(np.array([1.0, 2.0]), np.array([0, 0]),
                                                                           1.0, 1.0))


@pytest.mark.parametrize("seed, agents, groups", [(0, 24, 1), (1, 24, 2), (2, 24, 4), (3, 7, 3), (4, 64, 8)])
def test_diversity_bonus_matches_jax(seed, agents, groups):
    rng = np.random.default_rng(seed)
    rewards = rng.normal(rng.normal(0, 3, groups)[rng.integers(0, groups, agents)], 1.0)
    group_ids = rng.permutation(np.arange(agents) % groups) * 3 + 1  # every group present, ids not 0..G-1
    sim, div = rng.uniform(0, 2, 2)
    np.testing.assert_array_equal(calculate_diversity_bonus(rewards, group_ids, sim, div),
                                  jutil.calculate_diversity_bonus(rewards, group_ids, sim, div))


URIS = [
    "s3://bucket/path/run:v3.zip",
    "s3://bucket/run%3Av12.pt",
    "s3://bucket/plain/key.bin",
    "https://example.com/ckpt/run:v2.zip",
    "http://example.com/a/b/other",
    "file:///tmp/ckpts/myrun:v7.pkl",
    "/tmp/ckpts/myrun:v7.pkl",
    "relative/dir/name:v0.pkl",
    "relative/dir/no_epoch.pkl",
    "run:vX.pkl",
]


def _parsed(p) -> tuple:
    return type(p).__name__, p.model_dump(), p.checkpoint_info, getattr(p, "local_path", None)


def test_parse_uri_schemes(tmp_path):
    p = parse_uri("s3://bucket/path/run:v3.zip")
    assert p.scheme == "s3" and p.bucket == "bucket"
    assert p.checkpoint_info == ("run", 3)

    f = parse_uri(str(tmp_path / "myrun:v7.pkl"))
    assert f.scheme == "file"
    assert f.checkpoint_info == ("myrun", 7)

    h = parse_uri("https://example.com/ckpt/run:v2.zip")
    assert h.scheme == "http" and h.checkpoint_info == ("run", 2)


@pytest.mark.parametrize("uri", URIS)
def test_parse_uri_and_metadata_match_jax(uri):
    assert _parsed(parse_uri(uri)) == _parsed(jutil.parse_uri(uri))
    port, ref = checkpoint_metadata(uri), jutil.checkpoint_metadata(uri)
    assert (port is None) == (ref is None)
    if ref is not None:
        assert port.model_dump() == ref.model_dump()


def test_checkpoint_metadata_and_latest(tmp_path):
    meta = checkpoint_metadata("s3://b/k/run:v9.zip")
    assert meta is not None and meta.epoch == 9 and meta.run_name == "run"

    (tmp_path / "run:v1.pkl").touch()
    (tmp_path / "run:v5.pkl").touch()
    (tmp_path / "other.txt").touch()
    latest = resolve_latest_checkpoint(str(tmp_path))
    assert latest is not None and ("run:v5" in latest or "run%3Av5" in latest)
    assert latest == jutil.resolve_latest_checkpoint(str(tmp_path))


@pytest.mark.parametrize("seed", range(3))
def test_resolve_latest_checkpoint_matches_jax(tmp_path, seed):
    rng = np.random.default_rng(seed)
    for epoch in rng.choice(50, int(rng.integers(0, 6)), replace=False):
        (tmp_path / f"run{int(rng.integers(0, 2))}:v{int(epoch)}.pkl").touch()
    (tmp_path / "notes.txt").touch()
    assert resolve_latest_checkpoint(str(tmp_path)) == jutil.resolve_latest_checkpoint(str(tmp_path))
    assert resolve_latest_checkpoint(str(tmp_path / "missing")) == \
        jutil.resolve_latest_checkpoint(str(tmp_path / "missing"))


def test_load_symbol():
    cls = load_symbol("mettagrid_tpu_torch.maps.ascii.AsciiMapBuilder.Config")
    from mettagrid_tpu_torch.maps.ascii import AsciiMapBuilderConfig

    assert cls is AsciiMapBuilderConfig
    assert load_symbol("no.such.module.X", strict=False) is None


@pytest.mark.parametrize("name", ["json.dumps", "numpy.linalg.norm", "collections.OrderedDict.fromkeys",
                                  "no.such.module.X", "json.no_such_name"])
def test_load_symbol_matches_jax(name):
    assert load_symbol(name, strict=False) == jutil.load_symbol(name, strict=False)
    errors = []
    for fn in (load_symbol, jutil.load_symbol):
        try:
            fn(name)
            errors.append(None)
        except Exception as exc:  # the two must raise alike
            errors.append(type(exc))
    assert errors[0] == errors[1]


class _Clock:
    """A perf_counter that steps by a fixed, uneven amount per read."""

    def __init__(self):
        self.t, self.k = 100.0, 0

    def perf_counter(self):
        self.k += 1
        self.t += 0.001 * (1 + self.k % 3)
        return self.t


def _drive_stopwatch(mod, monkeypatch):
    monkeypatch.setattr(mod, "time", _Clock())
    sw = mod.Stopwatch()
    with sw.time("a"):
        with sw.time("b"):
            pass

    @sw("work")
    def work():
        pass

    work()
    work()
    sw.start("cp")
    laps = [sw.checkpoint("first", name="cp"), sw.checkpoint("second", name="cp")]
    sw.stop("cp")
    return sw.summary(), laps, sw.elapsed("a")


def test_stopwatch_matches_jax(monkeypatch):
    assert _drive_stopwatch(tstopwatch, monkeypatch) == _drive_stopwatch(jstopwatch, monkeypatch)


def _drive_tracer(mod, monkeypatch):
    monkeypatch.setattr(mod, "time", _Clock())
    tr = mod.Tracer()
    with tr.span("episode", idx=1):
        with tr.span("step", n=2):
            pass
        tr.instant("marker", why="x")
    return tr._events


def test_tracer_matches_jax(monkeypatch):
    assert _drive_tracer(ttracer, monkeypatch) == _drive_tracer(jtracer, monkeypatch)


def test_monitors_match_jax():
    for name in ("MemoryMonitor", "SystemMonitor"):
        port, ref = getattr(tmonitor, name)(), getattr(jmonitor, name)()
        if name == "MemoryMonitor":
            port.sample(), ref.sample()
            assert set(port.stats()) == set(ref.stats())
        else:
            assert set(port.poll()) == set(ref.poll())


# The map of tests/test_test_support.py, and a wider one whose open row
# lets the helpers' moves succeed.
MINE_MAP = [
    ["wall", "wall", "wall", "wall"],
    ["wall", "agent.agent", "mine", "wall"],
    ["wall", "wall", "wall", "wall"],
]
WIDE_MINE_MAP = [
    ["wall", "wall", "wall", "wall", "wall"],
    ["wall", "agent.agent", "mine", "empty", "wall"],
    ["wall", "empty", "empty", "empty", "wall"],
    ["wall", "wall", "wall", "wall", "wall"],
]


def _mine_cfg(gc, hc, builder, map_data=MINE_MAP):
    mine = gc.GridObjectConfig(
        name="mine",
        map_name="mine",
        on_use_handler=hc.Handler(
            name="harvest",
            mutations=[hc.ResourceDeltaMutation(target=hc.EntityTarget.ACTOR, deltas={"ore_red": 1})],
        ),
    )
    return gc.MettaGridConfig(
        game=gc.GameConfig(
            num_agents=1,
            max_steps=50,
            objects={"wall": gc.WallConfig(), "mine": mine},
            map_builder=builder.Config(map_data=map_data),
        )
    )


def sim_with_mine(map_data=MINE_MAP):
    return Simulation(_mine_cfg(tgc, thc, tts.ObjectNameMapBuilder, map_data), device="cpu")


@pytest.mark.parametrize("map_data", [MINE_MAP, WIDE_MINE_MAP])
def test_object_name_map_builder_matches_jax(map_data):
    port = _mine_cfg(tgc, thc, tts.ObjectNameMapBuilder, map_data).game.map_builder.create().build()
    ref = _mine_cfg(jgc, jhc, jts.ObjectNameMapBuilder, map_data).game.map_builder.create().build()
    assert port.grid.dtype == ref.grid.dtype
    np.testing.assert_array_equal(port.grid, ref.grid)


def test_object_name_map_builder_and_action_helpers():
    sim = sim_with_mine()
    assert noop(sim)["success"]
    r = move(sim, "north")
    assert not r["success"] and not r["moved"]
    r = use(sim, "east")
    assert r["success"] and not r["moved"]
    assert r["inventory_change"] == {"ore_red": 1}


# (helper, direction) calls made on both Simulations, in this order.
SCRIPT = [("noop", None), ("move", "north"), ("use", "east"), ("move", "south"), ("move", "east"),
          ("use", "north"), ("move", "west"), ("use", "north"), ("move", "east"), ("move", "east"), ("noop", None)]


def _obs_queries(helper_cls, obs, features) -> list:
    """Every query ObservationHelper answers, on one observation."""
    h = helper_cls(obs, features=features)
    out = [h.tokens(), h.global_tokens(), h.find_tokens()]
    for f in features:
        out.append(h.find_tokens(feature_name=f.name))
        out.append(h.find_tokens(feature_id=f.id, location=(6, 6)))
        out.append(h.value_at(f.name))
        out.append(h.value_at(f.name, location=(6, 7)))
    for r in range(13):
        for c in range(13):
            out.append(h.find_tokens(location=(r, c)))
    return out


def test_action_helpers_and_observation_helper_match_jax():
    """The helpers on the same Simulation in both packages: the same
    reports step by step, and the same answers from ObservationHelper on
    the observations, which are equal."""
    port = sim_with_mine(WIDE_MINE_MAP)
    ref = JSimulation(_mine_cfg(jgc, jhc, jts.ObjectNameMapBuilder, WIDE_MINE_MAP))
    assert [(f.name, f.id) for f in port.features] == [(f.name, f.id) for f in ref.features]
    helpers = {"noop": (noop, jts.noop), "move": (move, jts.move), "use": (use, jts.use)}
    for i, (name, direction) in enumerate(SCRIPT):
        args = () if direction is None else (direction,)
        got = helpers[name][0](port, *args)
        want = helpers[name][1](ref, *args)
        assert got == want, f"call {i}: {name}{args}"
        obs = port.last_outputs.observations[0, 0].numpy()
        np.testing.assert_array_equal(obs, np.asarray(ref.last_outputs.observations[0, 0]), err_msg=f"call {i}")
        assert _obs_queries(ObservationHelper, obs, port.features) == \
            _obs_queries(jts.ObservationHelper, obs, ref.features), f"call {i}"


@pytest.mark.parametrize("seed", range(3))
def test_observation_helper_matches_jax_on_random_tokens(seed):
    """Seeded token arrays with empty slots, global tokens and every
    location byte, under one feature table."""
    rng = np.random.default_rng(seed)
    features = [types.SimpleNamespace(name=f"feature_{i}", id=int(i)) for i in rng.permutation(12)]
    obs = rng.integers(0, 256, (64, 3)).astype(np.uint8)
    obs[rng.random(64) < 0.2, 0] = 0xFF
    obs[rng.random(64) < 0.1, 0] = 0xFE
    obs[:, 0] = np.where(obs[:, 0] < 0xFE, (obs[:, 0] % 13) * 16 + (obs[:, 0] // 16) % 13, obs[:, 0])
    obs[:, 1] %= 12
    assert _obs_queries(ObservationHelper, obs, features) == _obs_queries(jts.ObservationHelper, obs, features)


def test_observation_helper():
    sim = sim_with_mine()
    obs = sim.last_outputs.observations[0, 0].numpy()
    helper = ObservationHelper(obs, features=sim.features)
    assert helper.global_tokens()
    tags = helper.find_tokens(feature_name="tag")
    assert tags
    # agent sits at window center (6, 6) for the 13x13 window
    assert helper.find_tokens(location=(6, 6))
