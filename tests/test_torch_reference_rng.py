"""The port's reference-RNG step against the JAX engine's, exactly.

Both engines step with ``reference_rng=True`` from one seed and the same
actions, drawn with numpy, with no draws fed in: each env's MT19937 twin
draws the agent order, the events' shuffles and the order_by=random query
picks. Every output and every state field but ``rng`` (whose meaning
differs between the engines) must be equal after every step, ``mt``
included (tolerance: exact; the payloads are integers and the float stats
and rewards are sums of small integers). The cases: a flagship-shaped
arena, the tithe family (events=True, random_query=True of
mettagrid_tpu/parity/arena.py) over two enrich firings, the wall_mood
arena on the v3 observation tail, and a one-map pool with auto-reset.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mettagrid_tpu.engine as jengine
import mettagrid_tpu.engine.obs as jobs
from mettagrid_tpu.maps.map_builder import GameMap as JGameMap
from mettagrid_tpu_torch import engine as tengine
from mettagrid_tpu_torch.maps.map_builder import GameMap
from mettagrid_tpu_torch.maps.random_map import RandomMapBuilder
from mettagrid_tpu_torch.parity.arena import rename_walls
from mettagrid_tpu_torch.tools import bench_run
from tests.test_torch_step import _assert_outputs_equal, _assert_states_equal, _jax_state_numpy
from tests.test_torch_territory import jax_twin


def small_cfg(variant: str, agents: int, size: int, max_steps: int):
    """A bench variant's config on size x size random maps (border 1, 10
    walls) with ``agents`` agents."""
    cfg = bench_run.make_cfg(variant, agents)
    cfg.game.map_builder = RandomMapBuilder.Config(
        agents=agents, width=size, height=size, border_width=1, objects={"wall": 10})
    cfg.game.max_steps = max_steps
    return cfg


def build_both(cfg, seeds):
    """((JAX program, init), (port program, init)) of ``cfg`` on the port's
    maps of ``seeds`` (shrines renamed as bench_run.build_pool does)."""
    program = tengine.compile_program(cfg)
    b = cfg.game.map_builder.create()
    grids = []
    for s in seeds:
        b.config.seed = s
        grid = b.build_for_num_agents(program.num_agents).grid
        if "shrine" in cfg.game.objects:
            grid = rename_walls(grid, ["shrine"] * bench_run.TITHE_SHRINES, reachable=True)
        grids.append(grid)
    jp = jengine.compile_program(jax_twin(cfg))
    ji = jengine.build_env_init(jp, [JGameMap(np.array(g)) for g in grids])
    ti = tengine.build_env_init(program, [GameMap(np.array(g)) for g in grids])
    return (jp, ji), (program, ti)


def lockstep(jax_pair, port_pair, E, n_steps, seed=0, reference_rng=True, auto_reset=False,
             obs_tail="auto", action_mode="auto", perm=False, vibes=False, each=None):
    """Steps both engines from reset(0) and compares them after the reset and
    every step. perm: feed both engines agent orders drawn with numpy
    (external_perm); vibes: random vibe actions as well. each(jax_state,
    port_state) runs after every step. Returns the port's last state."""
    (jp, ji), (tp, ti) = jax_pair, port_pair
    A = tp.num_agents
    jstep = jengine.make_step(jp, ji, auto_reset=auto_reset, donate=False, reference_rng=reference_rng,
                              action_mode=action_mode, external_perm=perm)
    tstep = tengine.make_step(tp, ti, auto_reset=auto_reset, reference_rng=reference_rng, device="cpu",
                              obs_tail=obs_tail, action_mode=action_mode, external_perm=perm)
    jstate, jout = jengine.make_reset(jp, ji, E, reference_rng=reference_rng)(0)
    tstate, tout = tengine.make_reset(tp, ti, E, reference_rng=reference_rng, device="cpu", obs_tail=obs_tail)(0)
    _assert_outputs_equal(jout, tout, where="reset: ")
    _assert_states_equal(_jax_state_numpy(jstate), tstate, where="reset: ")
    n_actions = len(tp.action_names)
    rng = np.random.default_rng(seed)
    jbuf, tbuf = jout.observations, tout.observations
    for i in range(n_steps):
        acts = rng.integers(-1, n_actions + 1, (E, A)).astype(np.int32)
        vib = rng.integers(-1, n_actions + 1, (E, A)).astype(np.int32) if vibes else np.zeros_like(acts)
        p = np.stack([rng.permutation(A) for _ in range(E)]).astype(np.int32) if perm else None
        jstate, jout = jstep(jstate, jnp.asarray(acts), jnp.asarray(vib), None if p is None else jnp.asarray(p), jbuf)
        tstate, tout = tstep(tstate, torch.from_numpy(acts), torch.from_numpy(vib),
                             None if p is None else torch.from_numpy(p), tbuf)
        _assert_outputs_equal(jout, tout, where=f"step {i}: ")
        _assert_states_equal(_jax_state_numpy(jstate), tstate, where=f"step {i}: ")
        if each is not None:
            each(jstate, tstate)
        jbuf, tbuf = jout.observations, tout.observations
    return tstate


def test_flagship_arena():
    """The arena as the reference's Simulation runs it (auto_reset False):
    the twin's agent shuffle every step; the wave phase still serves the
    actions (no action handler draws)."""
    cfg = small_cfg("flagship", 4, 11, 0)
    both = build_both(cfg, [3])
    state = lockstep(*both, E=8, n_steps=12)
    # One seed and only the agent shuffle: every env's twin is at one draw.
    assert int(state.mt[:, 624].min()) > 0 and len(set(state.mt[:, 624].tolist())) == 1


def test_tithe_family_pays():
    """The tithe family over 44 steps, which crosses the enrich firings at
    steps 10 and 35: the sequential action phase (the tithe filter's
    order_by=random query draws in the reference's per-agent order), the
    event's max_targets shuffle and the agent shuffle all draw from the
    twin. The tithe handler pays at least once."""
    cfg = small_cfg("tithe_rrng", 6, 11, 0)
    both = build_both(cfg, [4])
    tp = both[1][0]
    ore = tp.resource_names.index("ore_red")
    heart = tp.resource_names.index("heart")
    step = tengine.make_step(*both[1], auto_reset=False, reference_rng=True, device="cpu")
    assert step.action_phase_kind == "sequential"
    state = lockstep(*both, E=8, n_steps=44, seed=1)
    assert int(state.obj_inv[:, :6, ore].sum()) > 0, "the tithe handler never paid"
    assert int(state.obj_inv[:, 6:, heart].sum()) == 2 * 3 * 8, "enrich did not give 3 hearts twice in every env"
    # The twins drew different numbers of times (the query's draws depend on the envs' bumps).
    assert len(set(state.mt[:, 624].tolist())) > 1, "the twins drew alike in every env"


def test_wall_mood_on_v3_tail():
    """The wall_mood arena on 15x15 maps with obs_tail="v3" (kernel B6b's
    path: a mutable background) under the reference-RNG step; the JAX side
    runs its forced v3 tail in interpret mode. The event's max_targets
    shuffle draws from the twin."""
    cfg = small_cfg("arena_mood_v3", 4, 15, 0)
    both = build_both(cfg, [2])
    tstep = tengine.make_step(*both[1], auto_reset=False, reference_rng=True, device="cpu", obs_tail="v3")
    assert tstep.obs_fn.route == "B6b"
    jobs._FORCE_FUSED_INTERPRET = True
    old = jobs._FORCE_STATIC_TAIL
    jobs._FORCE_STATIC_TAIL = "v3"
    tails = set()
    try:
        state = lockstep(*both, E=8, n_steps=9, obs_tail="v3", each=lambda j, t: tails.add(jobs._LAST_TAIL))
    finally:
        jobs._FORCE_FUSED_INTERPRET = False
        jobs._FORCE_STATIC_TAIL = old
    assert tails == {"dyn_v3"}
    tp = both[1][0]
    walls = state.obj_type == tp.type_names.index("wall")
    assert (state.obj_vibe[walls] != 0).any(), "no wall changed vibe"


def test_one_map_pool_auto_reset():
    """A one-map pool with auto-reset (max_steps 10, 26 steps: two resets of
    every env); the map picks do not depend on the RNG, and the twin runs on
    through the resets."""
    cfg = small_cfg("flagship", 4, 11, 10)
    both = build_both(cfg, [6])
    state = lockstep(*both, E=8, n_steps=26, auto_reset=True)
    assert int(state.step_count.max()) == 6


@pytest.mark.parametrize("variant", ["flagship_v3", "tithe_rrng"])
def test_bench_variant_options(variant):
    """The bench variants of this slice ask for the v3 tail or the
    reference-RNG step."""
    opts = bench_run.variant_options(variant)
    assert opts == {"obs_tail": "v3" if variant.endswith("_v3") else "auto", "reference_rng": variant == "tithe_rrng"}
