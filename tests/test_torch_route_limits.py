"""The observation route against the launch limits of the persistent tails.

Every config that the fused gates admit must have a kernel that can launch
it on the card: the route (``obs.gate_route``) is a function of the shapes
alone and asks each kernel's launch plan (``tail_plan.holds``) whether it
can hold them. Checked here on the CPU, where the plans are computed but no
kernel runs:

* the general bench config with token values in base 10 (9 token slots per
  cell, 1092 candidates, 35 rounds of 32) routes to B5, whose plan holds 35
  rounds, 23 of them in shared memory; its observations, and every state
  field but rng, equal the JAX engine's step for step (tolerance: exact);
* a grid of images at the shared-memory edge (one image and the candidate
  tables fit a block, the persistent plan's agent tables and row buffers
  may not): whatever route the gate picks has a plan; a real 72x160 arena
  with 128 agents, whose 88x640 image no B1 plan holds, routes to B3, and
  off the v2 gate to B5, since no B4 plan holds it either;
* more than 32 global lanes (value observations in base 10) route to B4
  (static background: its globals past 32 take rounds of their own) or to
  the non-fused path (mutable background), never to B5; both routes'
  observations equal the JAX engine's step for step.
"""

import pytest

import mettagrid_tpu.builder as jbuilder
from mettagrid_tpu.config import game_value as jgv
from mettagrid_tpu.maps.random_map import RandomMapBuilder as JRandomMapBuilder
from mettagrid_tpu_torch import builder as tbuilder
from mettagrid_tpu_torch import engine as tengine
from mettagrid_tpu_torch.builder import make_arena
from mettagrid_tpu_torch.config import game_value as tgv
from mettagrid_tpu_torch.engine import obs as tobs
from mettagrid_tpu_torch.engine.kernels import tail_plan as tp
from mettagrid_tpu_torch.engine.program import manhattan_window_offsets
from mettagrid_tpu_torch.engine.step import step_obs_fn
from mettagrid_tpu_torch.maps.random_map import RandomMapBuilder
from mettagrid_tpu_torch.tools import bench_run
from tests.test_torch_general import A, _build, _cfgs, _lockstep
from tests.test_torch_tail_plan import _one_image_and_tables

PERSISTENT = ("B1", "B2", "B3", "B4", "B5", "B6a", "B6b")



def _value_obs(cfg, game_value):
    """Every resource's amount as a value observation in base 10: three
    digits each, 30 global lanes beside the always-valid globals."""
    cfg.game.obs.global_obs.obs = {f"v_{r}": game_value.InventoryValue(item=r) for r in cfg.game.resource_names}
    cfg.game.obs.token_value_base = 10


def _obs_fn(cfg):
    program, init = bench_run.build_pool(cfg, 1)
    return program, step_obs_fn(program, init, "cpu")


def _plans(fn, A):
    """The launch plans of fn's route at its tail shapes."""
    sh = dict(fn.tail_shapes)
    HP2 = sh.pop("HP2", None)
    if fn.route in ("B6a", "B6b"):
        sh["HP"] = 2 * HP2
    return tp.candidate_plans(fn.route, A=A, out_w=fn.out_w, **sh)


def test_token_base_10_routes_to_a_plan():
    """1092 candidates: B5, planned at 35 rounds, its image staged."""
    cfg = bench_run.make_cfg("general")
    cfg.game.obs.token_value_base = 10
    program, fn = _obs_fn(cfg)
    sh = fn.tail_shapes
    assert fn.route == "B5" and sh["G"] + sh["K"] * sh["S"] == 1092
    plans = _plans(fn, program.num_agents)
    assert {p.rounds for p in plans} == {35} and all(p.stages for p in plans)


def _edge_shapes(OH):
    """Shapes at the shared-memory edge for an OH x OH window: image rows
    of 128 to 768 words, the tallest image (a multiple of 8 rows) whose one
    env and candidate tables fit a block, 1 or 3 slots, 24 to 128 agents."""
    K = len(manhattan_window_offsets(OH, OH))
    for WPC in (128, 256, 384, 512, 640, 768):
        for S in (1, 3):
            HP = (tp.MAX_SMEM // 4 - 3 * K * S) // WPC // 8 * 8
            for A in (24, 64, 96, 128):
                for out_w in (128, 256, 512):
                    yield A, 3, K, S, HP, WPC, out_w


@pytest.mark.parametrize("OH", [5, 9, 11, 15])
def test_edge_shapes_route_to_a_kernel_with_a_plan(OH):
    """At every edge shape, for each background, gate and v3 request, the
    route's kernel has a launch plan; the grid holds shapes that one image
    and the tables fit but no B1 plan does, and those route to B3, and
    shapes that no B4 plan holds, which route to B5 off the v2 gate."""
    refused_before = refused_b4 = 0
    for A, G, K, S, HP, WPC, out_w in _edge_shapes(OH):
        for v2_ok, static, v3 in ((True, True, False), (True, False, False), (False, True, False),
                                  (False, False, False), (True, True, True), (True, False, True)):
            HP2 = (HP // 2 - 8) // 8 * 8 if v3 else 0
            route = tobs.gate_route(v2_ok, static, True, v3, A, G, K, S, HP, WPC, HP2, out_w)
            rows = 2 * HP2 if route in ("B6a", "B6b") else HP
            assert route in PERSISTENT, (route, HP, WPC, A, out_w)
            assert tp.candidate_plans(route, rows, WPC, A, G, K, S, out_w), (route, HP, WPC, A, out_w)
        assert _one_image_and_tables(HP, WPC, K, S) <= tp.MAX_SMEM
        if not tp.holds("B1", HP, WPC, A, G, K, S, out_w):
            refused_before += 1
            assert tobs.gate_route(True, True, True, False, A, G, K, S, HP, WPC, 0, out_w) == "B3"
        if not tp.holds("B4", HP, WPC, A, G, K, S, out_w):
            refused_b4 += 1
            assert tobs.gate_route(False, True, True, False, A, G, K, S, HP, WPC, 0, out_w) == "B5"
    assert refused_before > 0 and refused_b4 > 0


@pytest.mark.parametrize("A,HP,WPC,OH,S,out_w", [
    (128, 88, 640, 11, 3, 256),
    (96, 88, 640, 11, 3, 512),
    (64, 448, 128, 5, 1, 128),
])
def test_named_edge_shapes_route_to_b3(A, HP, WPC, OH, S, out_w):
    """The edge shapes a B1 plan cannot hold, though one image and the
    candidate tables fit: routed to B3, which holds them; off the v2 gate no
    B4 plan holds them either, and they route to B5."""
    K = OH * OH
    assert _one_image_and_tables(HP, WPC, K, S) <= tp.MAX_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        tp.candidate_plans("B1", HP, WPC, A, 3, K, S, out_w)
    assert tobs.gate_route(True, True, True, False, A, 3, K, S, HP, WPC, 0, out_w) == "B3"
    assert [p.stages for p in tp.candidate_plans("B3", HP, WPC, A, 3, K, S, out_w)] == [0]
    with pytest.raises(ValueError, match="shared memory"):
        tp.candidate_plans("B4", HP, WPC, A, 3, K, S, out_w)
    assert tobs.gate_route(False, True, True, False, A, 3, K, S, HP, WPC, 0, out_w) == "B5"
    assert tp.candidate_plans("B5", HP, WPC, A, 3, K, S, out_w)


def test_real_edge_config_routes_to_b3():
    """A 72x160 arena with 128 agents: an 88x640 image, which one block
    holds with the candidate tables but no B1 plan holds with 128 agents'
    tables and one warp's rows. The obs function routes it to B3."""
    A = 128
    cfg = make_arena(A, combat=False, map_builder=RandomMapBuilder.Config(
        agents=A, width=160, height=72, border_width=1, objects={"wall": 20}))
    program, fn = _obs_fn(cfg)
    sh = fn.tail_shapes
    assert (sh["HP"], sh["WPC"]) == (88, 640)
    assert _one_image_and_tables(sh["HP"], sh["WPC"], sh["K"], sh["S"]) <= tp.MAX_SMEM
    assert not tp.holds("B1", sh["HP"], sh["WPC"], A, sh["G"], sh["K"], sh["S"], fn.out_w)
    assert fn.route == "B3"
    assert _plans(fn, A)


@pytest.mark.parametrize("variant,route", [("general", "nonfused"), ("flagship", "B4")])
def test_many_global_lanes_route_where_served(variant, route):
    """53 global lanes: B5 holds at most 32 (every global in the first
    round), so the mutable background takes the non-fused path; the static
    one takes B4, whose globals past 32 take rounds of their own."""
    cfg = bench_run.make_cfg(variant)
    _value_obs(cfg, tgv)
    _, fn = _obs_fn(cfg)
    assert fn.tail_shapes["G"] > 32 and fn.route == route
    if route == "B4":
        assert [p.stages for p in _plans(fn, 24)] == [1]
    assert not tp.holds("B5", *(fn.tail_shapes[k] for k in ("HP", "WPC")), 24,
                        *(fn.tail_shapes[k] for k in ("G", "K", "S")), fn.out_w)
    assert tobs.gate_route(False, False, True, False, 24, 33, 121, 3, 48, 128, 0, 512) == "nonfused"
    assert tobs.gate_route(False, False, True, False, 24, 32, 121, 3, 48, 128, 0, 512) == "B5"


def _flagship_cfgs(max_steps):
    """(JAX config, port config) of the flagship arena at test size."""
    out = []
    for builder_mod, rmb in ((jbuilder, JRandomMapBuilder), (tbuilder, RandomMapBuilder)):
        cfg = builder_mod.make_arena(
            A, combat=False, map_builder=rmb.Config(agents=A, width=15, height=15, border_width=1, objects={"wall": 8})
        )
        cfg.game.max_steps = max_steps
        out.append(cfg)
    return out


@pytest.mark.parametrize("case", ["base_10", "value_obs", "flagship_value_obs"])
def test_lockstep_with_jax(case):
    """The general config in base 10 (B5 at 35 rounds), and with 53 global
    lanes (the non-fused path), and the flagship with 53 global lanes (B4,
    its globals past 32 in rounds of their own), stepped in lockstep with
    the JAX engine: 4 envs, 12 steps, max_steps 8, so every env auto-resets
    once."""
    flagship = case == "flagship_value_obs"
    jcfg, tcfg = _flagship_cfgs(8) if flagship else _cfgs("general", max_steps=8)
    for cfg, gv in ((jcfg, jgv), (tcfg, tgv)):
        cfg.game.obs.token_value_base = 10
        if case != "base_10":
            _value_obs(cfg, gv)
    program, init = _build(tengine, tcfg, (3,))
    fn = tobs.make_obs_fn(program, tobs.build_static_bg(program, init, "cpu") if flagship else None, "cpu")
    assert fn.route == {"base_10": "B5", "value_obs": "nonfused", "flagship_value_obs": "B4"}[case]
    if case == "base_10":
        assert {p.rounds for p in _plans(fn, program.num_agents)} == {35}
    if case != "base_10":
        assert fn.tail_shapes["G"] == 53
    seen = _lockstep(jcfg, tcfg, 12, E=4)
    assert seen["resets"] == 4
