"""The port's general and combat bench paths against the JAX engine, exactly.

The port's copies of bench.make_general_cfg and bench.make_combat_cfg must
compile to the same program and EnvInit. Then both engines step in lockstep
from the JAX reset state, on 15x15 maps with 8 agents (as
tests/test_pallas_kernels.py sizes the general config), fed the same
actions, agent orders, reset maps and event target ranks: the port takes the
JAX engine's own map and rank draws (computed from its rng as
mettagrid_tpu/engine/step.py and events.py draw them). Every output and every
state field but ``rng`` must be equal after every step (tolerance: exact;
payloads are integers, float stats and rewards sums of small integers).

The bench's general config gives agents no laser, so DirectAttack deals 0
damage there; the "armed" case adds the combat config's starting inventory
so that attacks lower hearts.
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mettagrid_tpu.engine as jengine
from mettagrid_tpu.maps.random_map import RandomMapBuilder as JRandomMapBuilder
from mettagrid_tpu_torch import engine as tengine
from mettagrid_tpu_torch.engine.interop import state_from_numpy
from mettagrid_tpu_torch.maps.random_map import RandomMapBuilder
from mettagrid_tpu_torch.tools import bench_run
from tests.test_torch_host_compile import _norm
from tests.test_torch_step import _assert_outputs_equal, _assert_states_equal, _jax_state_numpy

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import bench  # noqa: E402  (the reference bench's config builders)

A = 8
E = 8
ARMED = {"laser": 5, "armor": 1, "heart": 9}


def _cfgs(variant, armed=False, width=15, max_steps=None):
    """(JAX config, port config) of a bench variant at test size."""
    out = []
    for make, rmb in (
        (getattr(bench, f"make_{variant}_cfg"), JRandomMapBuilder),
        (getattr(bench_run, f"make_{variant}_cfg"), RandomMapBuilder),
    ):
        cfg = make(A)
        cfg.game.map_builder = rmb.Config(agents=A, width=width, height=15, border_width=1, objects={"wall": 8})
        if armed:
            cfg.game.agent.inventory.initial = dict(ARMED)
        if max_steps is not None:
            cfg.game.max_steps = max_steps
        out.append(cfg)
    return out


def _build(eng, cfg, seeds):
    program = eng.compile_program(cfg)
    b = cfg.game.map_builder.create()
    maps = []
    for s in seeds:
        b.config.seed = s
        maps.append(b.build_for_num_agents(program.num_agents))
    return program, eng.build_env_init(program, maps)


@pytest.mark.parametrize("variant", ["general", "combat"])
def test_bench_configs_compile_like_jax(variant):
    """The port's config copies compile, at bench size (24 agents, a pool of
    three 25x25 maps), to the reference's program and EnvInit."""
    rng = np.random.default_rng(0)
    seeds = [int(rng.integers(0, 2**31 - 1)) for _ in range(3)]
    jcfg = getattr(bench, f"make_{variant}_cfg")(24)
    jp = jengine.compile_program(jcfg)
    b = jcfg.game.map_builder.create()
    jmaps = []
    for s in seeds:
        b.config.seed = s
        jmaps.append(b.build_for_num_agents(24))
    ji = jengine.build_env_init(jp, jmaps)
    tp, ti = bench_run.build_pool(bench_run.make_cfg(variant), 3)
    assert _norm(tp) == _norm(jp)
    for f in ti.__dataclass_fields__:
        got, ref = getattr(ti, f), getattr(ji, f)
        assert got.dtype == ref.dtype, f
        np.testing.assert_array_equal(got, ref, err_msg=f)


def _jax_draws(jstate, P: int, n_rows: int, N: int):
    """The JAX step's own draws for this step: the map of each env if it
    auto-resets (step.py:683-685), and the event target ranks f32[E, n_rows,
    N] (step.py:692, 763-764; events.py:223, 276)."""
    keys = jax.vmap(jax.random.split)(jstate.rng)
    maps = jax.vmap(lambda k: jax.random.randint(k, (), 0, P))(keys[:, 1])
    done = (jstate.terminals | jstate.truncations).any(axis=1)
    rng = jnp.where(done[:, None], keys[:, 0], jstate.rng)
    k_event = jax.vmap(lambda k: jax.random.split(k, 3))(rng)[:, 2]
    sub = jax.vmap(lambda k: jax.random.split(k, n_rows))(k_event)
    ranks = jax.vmap(jax.vmap(lambda k: jax.random.uniform(k, (N,))))(sub)
    return np.array(maps, dtype=np.int32), np.array(ranks)


def _lockstep(jcfg, tcfg, n_steps, seeds=(3, 4, 5), seed=0, check=None, E=E):
    """Steps E envs of both engines in lockstep, comparing after every step,
    and calls check(jax_state, port_state, port_outputs) after each. Returns
    counters of what the run exercised."""
    jp, ji = _build(jengine, jcfg, seeds)
    tp, ti = _build(tengine, tcfg, seeds)
    A = jp.num_agents
    jstate, jout = jengine.make_reset(jp, ji, E)(0)
    jstep = jengine.make_step(jp, ji, auto_reset=True, donate=False, external_perm=True)
    tstep = tengine.make_step(tp, ti, auto_reset=True, external_perm=True, device="cpu")
    tstate = state_from_numpy(_jax_state_numpy(jstate), "cpu")
    jbuf = jout.observations
    tbuf = torch.from_numpy(np.asarray(jout.observations).copy())
    n_actions = len(jp.action_names)
    angry = jp.action_names.index("change_vibe_angry") if "change_vibe_angry" in jp.action_names else 0
    heart = list(jp.resource_names).index("heart")
    R = jp.num_resources
    N = ji.obj_type.shape[1]
    n_rows = len(jp.events)  # no fallbacks in the bench configs
    rng = np.random.default_rng(seed)
    seen = dict(resets=0, hearts_lost=0, melee_applied=0, events=0, wall_hearts=0)
    for i in range(n_steps):
        # Moves mostly, some other and out-of-range indices; vibes often angry.
        acts = np.where(rng.random((E, A)) < 0.8, rng.integers(0, 5, (E, A)), rng.integers(-1, n_actions + 1, (E, A)))
        vibes = np.where(rng.random((E, A)) < 0.3, angry, rng.integers(-1, n_actions + 1, (E, A)))
        acts, vibes = acts.astype(np.int32), vibes.astype(np.int32)
        perm = np.stack([rng.permutation(A) for _ in range(E)]).astype(np.int32)
        maps, ranks = _jax_draws(jstate, len(seeds), max(n_rows, 1), N)
        seen["resets"] += int((np.asarray(jstate.terminals) | np.asarray(jstate.truncations)).any(axis=1).sum())
        jstate, jout = jstep(jstate, jnp.asarray(acts), jnp.asarray(vibes), jnp.asarray(perm), jbuf)
        tstate, tout = tstep(
            tstate, torch.from_numpy(acts), torch.from_numpy(vibes), torch.from_numpy(perm), tbuf,
            reset_maps=torch.from_numpy(maps), event_ranks=torch.from_numpy(ranks) if n_rows else None,
        )
        _assert_outputs_equal(jout, tout, where=f"step {i}: ")
        jnp_state = _jax_state_numpy(jstate)
        _assert_states_equal(jnp_state, tstate, where=f"step {i}: ")
        jbuf, tbuf = jout.observations, tout.observations
        if check is not None:
            check(jstate, tstate, tout)
        seen["hearts_lost"] += int(jnp_state["auto_stats"][..., R + heart].sum() > 0)
        stayed = (jnp_state["obj_r"][:, :A] == jnp_state["agent_prev_r"]) & (
            jnp_state["obj_c"][:, :A] == jnp_state["agent_prev_c"]
        )
        seen["melee_applied"] += int((np.asarray(jout.action_success) & stayed & (acts >= 1) & (acts <= 4)).sum())
        if n_rows:
            seen["events"] += int(jnp_state["game_stats"][:, jp.events[0].stat_id].sum())
        seen["wall_hearts"] = max(seen["wall_hearts"], int(jnp_state["obj_inv"][:, A:, heart].sum()))
    return seen


@pytest.mark.parametrize(
    "variant,armed,seeds",
    [("general", False, (3, 4, 5)), ("general", True, (3, 4, 5)), ("general", True, (3,)), ("combat", False, (3, 4, 5))],
)
def test_lockstep_matches_jax(variant, armed, seeds):
    """45 steps with max_steps=20: every env auto-resets twice (over a pool
    of three maps onto the JAX engine's map draws, or, with one map, through
    the merge that skips fields no phase writes); the event fires at steps 4
    and 20 of each episode; attacks land."""
    seen = _lockstep(*_cfgs(variant, armed, max_steps=20), 45, seeds=seeds)
    assert seen["resets"] == 2 * E
    assert seen["melee_applied"] > 0, "no melee handler applied"
    if variant == "general":
        assert seen["events"] > 0 and seen["wall_hearts"] > 0, "the event never gave a wall a heart"
    if armed or variant == "combat":
        assert seen["hearts_lost"] > 0, "no attack lowered a heart"
