"""The port's arena parity runs (parity/arena.py) against the JAX package,
on the CPU, without the reference oracle.

For each of the seven arena families of tests/test_arena_parity.py, at its
step count and its first (map seed, action seed) pair
(tests/torch_parity_scenarios.ARENA_FAMILIES), on the map that the port's
parity.arena.arena_map draws for that map seed: the port's run_arena_ours
trace equals a JAX Simulation (reference_shuffle=True) of the same config,
driven by the same script and loadouts. Positions, inventories and action
successes every 50 steps and at the end, observation tokens every 100 steps,
and the final summary with the full episode stats are compared exactly, with
the JAX package's own _summary_ours and _obs_tokens; no engagement check
fires. This file holds the five families whose JAX steps are quick; the two
that draw from the MT19937 stream inside handlers are in
tests/test_torch_arena_tithe.py and tests/test_torch_arena_event_filter.py.
The run against the reference C++ engine (run_arena_parity) is marked parity
like the JAX package's and skips without the oracle.
"""

import numpy as np
import pytest
import torch

from mettagrid_tpu_torch.parity import arena
from mettagrid_tpu_torch.parity.reference_oracle import reference_available
from tests.torch_parity_scenarios import ARENA_FAMILIES

AGENTS = 24


def _jax_config(map_data, family):
    """The JAX package's config of a family: the port's our_config dumped and
    validated, with the JAX package's map builder on the family's map."""
    from mettagrid_tpu.config.game_config import MettaGridConfig
    from mettagrid_tpu.test_support import ObjectNameMapBuilder

    d = arena.our_config(map_data, AGENTS, **family).model_dump()
    d["game"]["map_builder"] = ObjectNameMapBuilder.Config(map_data=arena.family_map(map_data, **family))
    return MettaGridConfig.model_validate(d)


def _jax_run(map_data, action_seed, steps, family, checkpoint_every=50, compare_obs_every=100):
    """run_arena_ours' trace, from the JAX package's Simulation."""
    from mettagrid_tpu.parity.cross_engine import _obs_tokens, _summary_ours
    from mettagrid_tpu.simulator import Simulation

    sim = Simulation(_jax_config(map_data, family), seed=action_seed, reference_shuffle=True)
    for i, inv in arena.loadouts(AGENTS, **family).items():
        sim.agent(i).set_inventory(inv)
    actions = arena.script_actions(sim.action_names)
    biased = family.get("combat", False) or family.get("pure_attack", False)
    script = arena.action_script(actions, action_seed, steps, AGENTS, biased)
    checkpoints, obs = [], []
    for t in range(steps):
        for i in range(AGENTS):
            sim.agent(i).set_action(actions[int(script[t, i])])
        sim.step()
        if (t + 1) % checkpoint_every == 0 or t == steps - 1:
            r, c = np.asarray(sim._state.obj_r[0]), np.asarray(sim._state.obj_c[0])
            checkpoints.append({
                "t": t,
                "pos": [(int(r[i]), int(c[i])) for i in range(AGENTS)],
                "inv": [dict(sim.agent(i).inventory) for i in range(AGENTS)],
                "success": [bool(x) for x in np.asarray(sim.last_outputs.action_success[0])],
            })
        if (t + 1) % compare_obs_every == 0:
            tokens = np.asarray(sim.last_outputs.observations[0])
            obs.append({"t": t, "tokens": [_obs_tokens(tokens[i]) for i in range(AGENTS)]})
    return {"actions": actions, "checkpoints": checkpoints, "obs": obs, "final": _summary_ours(sim)}


def check_family(name, steps=None, checkpoint_every=50, compare_obs_every=100):
    """The port's run_arena_ours of family ``name`` (its own step count
    unless ``steps`` says otherwise) equals the JAX package's run."""
    family, family_steps, (map_seed, action_seed) = ARENA_FAMILIES[name]
    steps = steps or family_steps
    map_data = arena.arena_map(AGENTS, map_seed)
    # One env's tensors are small: one thread runs them faster than many,
    # most of all beside other test processes on the same cores.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ours = arena.run_arena_ours(map_data, action_seed, steps, AGENTS, checkpoint_every, compare_obs_every,
                                    device="cpu", **family)
    finally:
        torch.set_num_threads(threads)
    theirs = _jax_run(map_data, action_seed, steps, family, checkpoint_every, compare_obs_every)
    assert ours["actions"] == theirs["actions"]
    assert [c["t"] for c in ours["checkpoints"]] == [c["t"] for c in theirs["checkpoints"]]
    assert len(ours["obs"]) == steps // compare_obs_every > 0
    problems = arena.diff_arena(ours, theirs, AGENTS)
    assert not problems, "\n".join(problems[:20])
    assert ours["checkpoints"] == theirs["checkpoints"]
    assert ours["obs"] == theirs["obs"]
    assert ours["final"] == theirs["final"]


@pytest.mark.parametrize("name", ["plain", "combat", "economy", "events", "direct_attack"])
def test_run_arena_ours_matches_jax(name):
    check_family(name)


@pytest.mark.skipif(not reference_available(), reason="reference oracle not built")
@pytest.mark.parity
@pytest.mark.parametrize(
    "family,steps,seeds",
    [({}, 500, s) for s in [(0, 42), (3, 7), (11, 99991)]]
    + [({"combat": True}, 500, s) for s in [(0, 5), (7, 19), (11, 23)]]
    + [({"economy": True}, 400, s) for s in [(0, 31), (9, 271)]]
    + [({"events": True}, 300, s) for s in [(0, 13), (5, 777)]]
    + [({"events": True, "random_query": True}, 300, s) for s in [(1, 29), (6, 1234)]]
    + [({"pure_attack": True}, 300, s) for s in [(2, 17), (8, 4242)]]
    + [({"events": True, "event_filter_rng": True}, 200, (2, 31))],
)
def test_arena_parity_with_reference(family, steps, seeds):
    problems = arena.run_arena_parity(seeds[0], seeds[1], steps=steps, device="cpu", **family)
    assert not problems, "\n".join(problems[:20])
