"""The port's cross-engine parity runs (parity/cross_engine.py) against the
JAX package's, on the CPU, without the reference oracle.

For each scenario of tests/test_cross_engine_parity.py
(tests/torch_parity_scenarios.py) the port builds the same config, and its
run_ours trace has no diff_traces problem against the JAX package's: every
step's action success, positions and inventories, the observation tokens
where the scenario compares them, the final objects, rewards and episode
stats, exactly. The comparison with the reference C++ engine runs where the
oracle is built and skips otherwise, as the JAX package's own does.
"""

import dataclasses

import pytest

from mettagrid_tpu.parity import cross_engine as jax_cross_engine
from mettagrid_tpu_torch.parity import cross_engine
from mettagrid_tpu_torch.parity.reference_oracle import reference_available
from tests.torch_parity_scenarios import SCENARIOS


def _jax_scenario(sc):
    return jax_cross_engine.Scenario(**{f.name: getattr(sc, f.name) for f in dataclasses.fields(sc)})


def _inv_series(trace, agent, item):
    return [step["inv"][agent].get(item, 0) for step in trace["steps"]]


# What some scenarios must show, so that the comparison is not vacuous
# (the JAX package's tests assert these on the reference's trace).
EXPECTED = {
    "attack_via_move_handler_lands": lambda t: _inv_series(t, 1, "hp") == [20, 17, 14, 14],
    "attack_damage_multiplier_and_armor_absorb": lambda t: _inv_series(t, 1, "hp") == [5, 4, 3, 2],
    "attack_requires_vibe_gate": lambda t: _inv_series(t, 1, "hp") == [20, 20],
    "attack_action_config_is_inert": lambda t: t["steps"][-1]["inv"] == [{"laser": 3}, {"heart": 2, "gold": 4}],
    "inventory_limit_clamp_cross_engine": lambda t: _inv_series(t, 0, "ore_red") == [3, 6, 7, 7],
    "modifier_raises_limit_cross_engine": lambda t: _inv_series(t, 0, "ore_red") == [4, 6, 6],
    "mine_use_inventory_and_reward": lambda t: _inv_series(t, 0, "ore_red")[0] == 1,
    "raycast_spawn_skips_non_blockers_cross_engine": lambda t: sum(
        o["type"] == "crystal" for o in t["final"]["objects"]) == 3,
    "raycast_spawn_blocker_stops_ray_cross_engine": lambda t: sum(
        o["type"] == "crystal" for o in t["final"]["objects"]) == 1,
    "event_update_target_cross_engine": lambda t: [o["inventory"] for o in t["final"]["objects"]
                                                   if o["type"] == "shrine"] == [{"heart": 4}] * 2,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_run_ours_matches_jax(name):
    sc = SCENARIOS[name]
    ours = cross_engine._build_config(cross_engine._Api(ours=True), sc).model_dump(mode="json")
    theirs = jax_cross_engine._build_config(jax_cross_engine._Api(ours=True), _jax_scenario(sc)).model_dump(
        mode="json")
    # The map builder's type names its package's module; all else is equal.
    builder = theirs["game"]["map_builder"]
    builder["type"] = builder["type"].replace("mettagrid_tpu.", "mettagrid_tpu_torch.", 1)
    assert ours == theirs

    port = cross_engine.run_ours(sc, device="cpu")
    jax_trace = jax_cross_engine.run_ours(_jax_scenario(sc))
    problems = cross_engine.diff_traces(port, jax_trace)
    assert not problems, "\n".join(problems)
    assert len(port["steps"]) == len(jax_trace["steps"]) == len(sc.scripts)
    assert ("obs" in port["steps"][0]) == sc.compare_obs
    if name in EXPECTED:
        assert EXPECTED[name](port), port["steps"]


def test_protocol_ids_never_emitted():
    sc = SCENARIOS["protocol_feature_ids_allocated_but_never_emitted"]
    cfg = cross_engine._build_config(cross_engine._Api(ours=True), sc)
    proto_ids = {f.id for f in cfg.game.id_map().features() if f.name.startswith("protocol_")}
    assert proto_ids
    trace = cross_engine.run_ours(sc, device="cpu")
    assert all(fid not in proto_ids for step in trace["steps"] for toks in step["obs"] for _, fid, _ in toks)


@pytest.mark.skipif(not reference_available(), reason="reference oracle not built")
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_run_ours_matches_reference(name):
    sc = SCENARIOS[name]
    problems = cross_engine.diff_traces(cross_engine.run_ours(sc, device="cpu"), cross_engine.run_reference(sc))
    assert not problems, "\n".join(problems)
