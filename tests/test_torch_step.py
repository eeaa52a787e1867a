"""The PyTorch port's reset and step against the JAX engine, exactly.

Both engines compile the same arena config; the port starts from the JAX
reset state (engine/interop.py) and both step with the same actions and
agent orders, drawn with numpy. Every output and every state field except
``rng`` must be equal after every step (tolerance: exact; the payloads are
integers and the float stats and rewards are sums of small integers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mettagrid_tpu.builder as jbuilder
import mettagrid_tpu.engine as jengine
from mettagrid_tpu.maps.random_map import RandomMapBuilder as JRandomMapBuilder
from mettagrid_tpu_torch import builder as tbuilder
from mettagrid_tpu_torch import engine as tengine
from mettagrid_tpu_torch.engine.interop import state_from_numpy, state_to_numpy
from mettagrid_tpu_torch.maps.random_map import RandomMapBuilder

A = 4
E = 8
OUTPUTS = ("observations", "tokens_attempted", "rewards", "terminals", "truncations", "action_success")


def _arena(eng, builder_mod, rmb, seeds, max_steps, width=11):
    cfg = builder_mod.make_arena(
        A, combat=False,
        map_builder=rmb.Config(agents=A, width=width, height=11, border_width=1, objects={"wall": 6}),
    )
    cfg.game.max_steps = max_steps
    program = eng.compile_program(cfg)
    b = cfg.game.map_builder.create()
    maps = []
    for s in seeds:
        b.config.seed = s
        maps.append(b.build_for_num_agents(A))
    return program, eng.build_env_init(program, maps)


def _both(seeds, max_steps=20):
    jp, ji = _arena(jengine, jbuilder, JRandomMapBuilder, seeds, max_steps)
    tp, ti = _arena(tengine, tbuilder, RandomMapBuilder, seeds, max_steps)
    return (jp, ji), (tp, ti)


def _jax_state_numpy(state) -> dict:
    return {f: np.asarray(getattr(state, f)) for f in state._fields}


def _assert_states_equal(jax_np: dict, port_state, skip=("rng",), where=""):
    port_np = state_to_numpy(port_state)
    assert set(port_np) == set(jax_np)
    for f, ref in jax_np.items():
        if f in skip:
            continue
        got = port_np[f]
        assert got.shape == ref.shape, f"{where}{f}: shape {got.shape} vs {ref.shape}"
        if f != "mt":
            assert got.dtype == ref.dtype, f"{where}{f}: dtype {got.dtype} vs {ref.dtype}"
        np.testing.assert_array_equal(got, ref, err_msg=f"{where}{f}")


def _assert_outputs_equal(jout, tout, where=""):
    for f in OUTPUTS:
        ref = np.asarray(getattr(jout, f))
        got = getattr(tout, f).cpu().numpy()
        assert got.dtype == ref.dtype, f"{where}{f}: dtype {got.dtype} vs {ref.dtype}"
        np.testing.assert_array_equal(got, ref, err_msg=f"{where}{f}")


@pytest.mark.parametrize("seeds", [(3,), (5, 6, 7)])
def test_reset_matches_jax(seeds):
    """Reset state field by field (all but rng), and the reset outputs; the
    three-map pool checks the round-robin map_idx."""
    (jp, ji), (tp, ti) = _both(seeds)
    jstate, jout = jengine.make_reset(jp, ji, E)(0)
    tstate, tout = tengine.make_reset(tp, ti, E, device="cpu")(0)
    if len(seeds) == 3:
        assert tstate.map_idx.tolist() == [0, 1, 2, 0, 1, 2, 0, 1]
    _assert_states_equal(_jax_state_numpy(jstate), tstate)
    _assert_outputs_equal(jout, tout)


def _jax_reset_maps(jstate, P: int) -> np.ndarray:
    """The map each env starts on if the JAX step auto-resets it, drawn from
    its rng as mettagrid_tpu/engine/step.py draws it."""
    k_map = jax.vmap(jax.random.split)(jstate.rng)[:, 1]
    return np.asarray(jax.vmap(lambda k: jax.random.randint(k, (), 0, P))(k_map)).astype(np.int32)


def _run_lockstep(seeds, n_steps, seed=11):
    """Steps both engines in lockstep and compares them after every step.
    With more than one map, the port takes the JAX engine's map draws
    (step's reset_maps); map_idx is compared like every other field.
    Returns (resets, resets onto another map)."""
    (jp, ji), (tp, ti) = _both(seeds)
    jstate, jout = jengine.make_reset(jp, ji, E)(0)
    jstep = jengine.make_step(jp, ji, auto_reset=True, donate=False, external_perm=True)
    tstep = tengine.make_step(tp, ti, auto_reset=True, external_perm=True, device="cpu")
    tstate = state_from_numpy(_jax_state_numpy(jstate), "cpu")
    jbuf = jout.observations
    tbuf = torch.from_numpy(np.asarray(jout.observations).copy())
    n_actions = len(jp.action_names)
    rng = np.random.default_rng(seed)
    resets = moved = 0
    for i in range(n_steps):
        # Out-of-range indices exercise the invalid-action stat.
        acts = rng.integers(-1, n_actions + 1, (E, A)).astype(np.int32)
        vibes = rng.integers(-1, 2, (E, A)).astype(np.int32)
        perm = np.stack([rng.permutation(A) for _ in range(E)]).astype(np.int32)
        done = (np.asarray(jstate.terminals) | np.asarray(jstate.truncations)).any(axis=1)
        maps = _jax_reset_maps(jstate, len(seeds)) if len(seeds) > 1 else None
        resets += int(done.sum())
        if maps is not None:
            moved += int((done & (maps != np.asarray(jstate.map_idx))).sum())
        jstate, jout = jstep(jstate, jnp.asarray(acts), jnp.asarray(vibes), jnp.asarray(perm), jbuf)
        tstate, tout = tstep(
            tstate, torch.from_numpy(acts), torch.from_numpy(vibes), torch.from_numpy(perm), tbuf,
            reset_maps=None if maps is None else torch.from_numpy(maps),
        )
        _assert_outputs_equal(jout, tout, where=f"step {i}: ")
        _assert_states_equal(_jax_state_numpy(jstate), tstate, where=f"step {i}: ")
        jbuf = jout.observations
        tbuf = tout.observations  # carried and rewritten in place by the next step
    return resets, moved


def test_step_matches_jax_across_auto_resets():
    """52 steps of a single-map arena with max_steps=20: every env resets
    twice (the P == 1 merge with the mutfields skip)."""
    resets, _ = _run_lockstep((3,), 52)
    assert resets == 2 * E


def test_multi_map_merge_matches_jax():
    """A pool of three different maps takes the gathered merge (P > 1): 44
    steps with max_steps=20 reset every env twice, onto the map the JAX
    engine draws, and most resets land on another map than the env's last,
    so a gather from the wrong map shows in the state and observations."""
    (jp, ji), _ = _both((4, 5, 6))
    grids = np.asarray(ji.grid)
    assert not (np.array_equal(grids[0], grids[1]) or np.array_equal(grids[1], grids[2])
                or np.array_equal(grids[0], grids[2]))
    resets, moved = _run_lockstep((4, 5, 6), 44, seed=2)
    assert resets == 2 * E
    assert moved >= E


def test_auto_reset_merge_covers_every_field():
    """Every EnvState field is classified by the port's auto-reset merge, in
    the same classes as the reference's: const-reset, pool-derived,
    dead at the merge, or handled specially."""
    import mettagrid_tpu.engine.step as jstep
    import mettagrid_tpu_torch.engine.step as tstep
    from mettagrid_tpu_torch.engine.state import EnvState

    for name in ("_CONST_RESETS", "_POOL_RESET_FIELDS", "_DEAD_AT_RESET_MERGE"):
        assert getattr(tstep, name) == getattr(jstep, name), name
    special = {"rng", "map_idx", "mt", "agent_stats", "auto_stats", "game_stats_touched"}
    covered = set(tstep._CONST_RESETS) | set(tstep._POOL_RESET_FIELDS) | set(tstep._DEAD_AT_RESET_MERGE) | special
    assert set(EnvState._fields) == covered


def lockstep_pair(jax_pair, port_pair, num_envs, n_steps, seed=0, vibes=False):
    """Steps a JAX (program, init) and a port (program, init) of one config in
    lockstep from the JAX reset state, fed the same numpy actions and agent
    orders and, with a pool of several maps, the JAX engine's map draws;
    compares every output and every state field but rng after every step.
    Returns the number of env resets."""
    (jp, ji), (tp, ti) = jax_pair, port_pair
    A, P = jp.num_agents, ji.pool_size
    jstate, jout = jengine.make_reset(jp, ji, num_envs)(0)
    jstep = jengine.make_step(jp, ji, auto_reset=True, donate=False, external_perm=True)
    tstep = tengine.make_step(tp, ti, auto_reset=True, external_perm=True, device="cpu")
    tstate = state_from_numpy(_jax_state_numpy(jstate), "cpu")
    jbuf = jout.observations
    tbuf = torch.from_numpy(np.asarray(jout.observations).copy())
    n_actions = len(jp.action_names)
    rng = np.random.default_rng(seed)
    resets = 0
    for i in range(n_steps):
        acts = rng.integers(0, n_actions, (num_envs, A)).astype(np.int32)
        vib = rng.integers(0, 2, (num_envs, A)).astype(np.int32) if vibes else np.zeros((num_envs, A), np.int32)
        perm = np.stack([rng.permutation(A) for _ in range(num_envs)]).astype(np.int32)
        resets += int((np.asarray(jstate.terminals) | np.asarray(jstate.truncations)).any(axis=1).sum())
        maps = _jax_reset_maps(jstate, P) if P > 1 else None
        jstate, jout = jstep(jstate, jnp.asarray(acts), jnp.asarray(vib), jnp.asarray(perm), jbuf)
        tstate, tout = tstep(
            tstate, torch.from_numpy(acts), torch.from_numpy(vib), torch.from_numpy(perm), tbuf,
            reset_maps=None if maps is None else torch.from_numpy(maps),
        )
        _assert_outputs_equal(jout, tout, where=f"step {i}: ")
        _assert_states_equal(_jax_state_numpy(jstate), tstate, where=f"step {i}: ")
        jbuf = jout.observations
        tbuf = tout.observations
    return resets
