"""The port's scripted-agent SDK (mettagrid_tpu_torch/sdk/), on the CPU.

- Twins of tests/test_sdk.py on the port: semantic state building, the
  helper catalog, memory retrieval, token observation decoding and the
  progress snapshot, with ``Simulation(device="cpu")``.
- Lockstep with the JAX package: its ``Simulation`` and the port's under
  the MT19937 twin (``reference_shuffle=True``) from one seed, fed the same
  random actions drawn with numpy, on a four-agent arena until the episode
  ends. After the reset and every step, for every agent: ``build_state``
  compared by ``model_dump()``, ``decode_observation`` field by field, the
  answers of ``StateHelperCatalog`` and of an ``InMemoryMemoryStore`` fed
  the same records, and ``MemoryQuery.from_state``.

Tolerance: exact (every value is an integer, a string or a count; the
memory scores are the same float expressions of equal inputs).
"""

import numpy as np

import mettagrid_tpu.sdk as jsdk
import mettagrid_tpu_torch.sdk as tsdk
from mettagrid_tpu.policy.policy_env_interface import PolicyEnvInterface as JaxPolicyEnvInterface
from mettagrid_tpu.simulator import Simulation as JaxSimulation
from mettagrid_tpu_torch import MettaGridConfig
from mettagrid_tpu_torch.config.game_config import GameConfig, GridObjectConfig, WallConfig
from mettagrid_tpu_torch.config.handler_config import EntityTarget, Handler, ResourceDeltaMutation
from mettagrid_tpu_torch.policy.policy_env_interface import PolicyEnvInterface
from mettagrid_tpu_torch.sdk import (
    GridPosition,
    InMemoryMemoryStore,
    MemoryQuery,
    MemoryRecord,
    MettagridState,
    ObservationEnvelope,
    ProgressSnapshot,
    SelfState,
    StateHelperCatalog,
    TeamSummary,
    build_state,
    decode_observation,
)
from mettagrid_tpu_torch.simulator import Simulation
from mettagrid_tpu_torch.test_support import ObjectNameMapBuilder, use
from tests.test_torch_simulation import arena


def make_sim():
    mine = GridObjectConfig(
        name="mine",
        map_name="mine",
        on_use_handler=Handler(
            name="harvest",
            mutations=[ResourceDeltaMutation(target=EntityTarget.ACTOR, deltas={"ore_red": 3})],
        ),
    )
    cfg = MettaGridConfig(
        game=GameConfig(
            num_agents=2,
            max_steps=50,
            objects={"wall": WallConfig(), "mine": mine},
            map_builder=ObjectNameMapBuilder.Config(
                map_data=[
                    ["wall", "wall", "wall", "wall", "wall"],
                    ["wall", "agent.agent", "mine", "agent.agent", "wall"],
                    ["wall", "wall", "wall", "wall", "wall"],
                ]
            ),
        )
    )
    return Simulation(cfg, device="cpu")


def test_build_state_and_helpers():
    sim = make_sim()
    use(sim, "east")  # agent 0 harvests the mine
    state = build_state(sim, 0)
    assert state.self_state.inventory.get("ore_red") == 3
    helpers = StateHelperCatalog(state)
    assert "mine" in helpers.visible_entity_counts()
    nearest_mine = helpers.nearest_visible_entity(entity_type="mine")
    assert nearest_mine is not None
    assert helpers.distance_to_entity(nearest_mine.entity_id) == 1
    assert helpers.visible_entity_ids(entity_type="wall")
    summary = helpers.render_capability_summary(max_items=3)
    assert summary.count("\n") == 2


def test_helpers_team_objectives():
    state = MettagridState(
        game="test",
        step=4,
        self_state=SelfState(
            entity_id="agent_0",
            entity_type="agent",
            position=GridPosition(x=1, y=1),
            attributes={"agent_id": 7},
        ),
        team_summary=TeamSummary(
            team_id="t0",
            shared_inventory={"ore_red": 5},
            shared_objectives=["seen_resource:gold", "missing_resource:heart", "other"],
        ),
    )
    h = StateHelperCatalog(state)
    assert h.agent_id() == 7
    assert h.shared_inventory() == {"ore_red": 5}
    assert h.seen_resources() == ["gold"]
    assert h.missing_resources() == ["heart"]


def test_memory_store_retrieval():
    mem = InMemoryMemoryStore()
    mem.add(MemoryRecord(record_id="m1", kind="event", summary="saw a mine", tags=["mine"], step=1, importance=0.9))
    mem.add(MemoryRecord(record_id="m2", kind="event", summary="hit a wall", tags=["wall"], step=8))
    hits = mem.retrieve(MemoryQuery(step=10, target_tags=["mine"]), limit=2)
    assert hits[0].record.record_id == "m1"
    assert mem.recent_records(limit=1)[0].record_id == "m2"
    ctx = mem.render_prompt_context(MemoryQuery(target_tags=["wall"]))
    assert "wall" in ctx
    mem.replace_scratchpad("plan A")
    mem.append_scratchpad("step 2")
    assert mem.read_scratchpad() == "plan A\nstep 2"
    mem["key"] = 1
    assert "key" in mem and mem["key"] == 1


def test_decode_observation():
    sim = make_sim()
    use(sim, "east")
    envelope = ObservationEnvelope(
        raw_observation=sim.agent(0).observation,
        policy_env_info=PolicyEnvInterface.from_config(sim.config),
        step=sim.current_step,
    )
    decoded = decode_observation(envelope)
    self_cell = decoded.self_cell
    assert decoded.cells
    assert self_cell.features.get("inv:ore_red") == 3
    assert any("type:wall" in c.tags for c in decoded.cells)
    assert decoded.global_features
    # The tokens the decoder read are host integers copied from the
    # observation tensor, never tensors.
    assert all(type(t.value) is int and type(t.location_byte) is int for t in envelope.raw_observation.tokens)


def test_progress_render():
    snap = ProgressSnapshot(objective="gather", summary="going well", milestones=["found mine"], metrics={"ore": 3})
    text = snap.render()
    assert "objective: gather" in text and "- ore: 3" in text
    assert snap.metric("ore") == 3


def _decoded(sdk, info, sim, a):
    """decode_observation of agent a, as plain values."""
    d = sdk.decode_observation(sdk.ObservationEnvelope(sim.agent(a).observation, info, sim.current_step))
    cells = [(tuple(c.location), tuple(c.center), c.tags, c.features, c.x, c.y) for c in d.cells]
    self_cell = d.self_cell
    return (d.step, d.center_row, d.center_col, cells, d.global_features, tuple(self_cell.location),
            self_cell.features)


def _helpers(sdk, state):
    """Every StateHelperCatalog answer on ``state``."""
    h = sdk.StateHelperCatalog(state)
    dump = lambda e: None if e is None else e.model_dump()  # noqa: E731
    ids = [e.entity_id for e in state.visible_entities]
    return {
        "agent_id": h.agent_id(),
        "shared_inventory": h.shared_inventory(),
        "shared_objectives": h.shared_objectives(),
        "seen": h.seen_resources(),
        "missing": h.missing_resources(),
        "position": h.position(),
        "counts": h.visible_entity_counts(),
        "events": h.recent_event_types(),
        "walls": h.visible_entity_ids(entity_type="wall"),
        "near": h.visible_entity_ids(max_distance=2),
        "labelled": [dump(e) for e in h.visible_entities(label="type:wall")],
        "nearest": dump(h.nearest_visible_entity()),
        "nearest_agent": dump(h.nearest_visible_entity(entity_type="agent")),
        "distances": [h.distance_to_entity(i) for i in ids],
        "by_id": [dump(h.entity_by_id(i)) for i in ids[:3]],
        "summary": h.render_capability_summary(max_items=5),
    }


def _remember(sdk, memory, state, a, step):
    counts = sdk.StateHelperCatalog(state).visible_entity_counts()
    memory.add(sdk.MemoryRecord(
        record_id=f"s{step}a{a}", kind="event", summary=f"saw {' '.join(sorted(counts))}", tags=sorted(counts),
        game=state.game, step=state.step, location=state.self_state.position, importance=len(counts) / 10))
    query = sdk.MemoryQuery.from_state(state, extra_tags=[f"agent_{a}"])
    hits = [r.model_dump() for r in memory.retrieve(query, limit=4)]
    return query.model_dump(), hits, memory.render_prompt_context(query, limit=3)


def test_lockstep_with_jax_sdk():
    j = JaxSimulation(arena(jax=True), seed=5, reference_shuffle=True)
    t = Simulation(arena(), seed=5, reference_shuffle=True, device="cpu")
    jinfo, tinfo = JaxPolicyEnvInterface.from_config(j.config), PolicyEnvInterface.from_config(t.config)
    jmem, tmem = jsdk.InMemoryMemoryStore(), tsdk.InMemoryMemoryStore()
    names = t.action_names
    rng = np.random.default_rng(3)
    step = 0
    seen_types = set()
    while True:
        where = f"step {step}"
        for a in range(t.num_agents):
            js, ts = jsdk.build_state(j, a), tsdk.build_state(t, a)
            assert ts.model_dump() == js.model_dump(), f"{where}, agent {a}: build_state"
            assert _decoded(tsdk, tinfo, t, a) == _decoded(jsdk, jinfo, j, a), f"{where}, agent {a}: decode"
            assert _helpers(tsdk, ts) == _helpers(jsdk, js), f"{where}, agent {a}: helpers"
            assert _remember(tsdk, tmem, ts, a, step) == _remember(jsdk, jmem, js, a, step), f"{where}: memory"
            seen_types.update(e.entity_type for e in ts.visible_entities)
        if t.is_done:
            break
        for a in range(t.num_agents):
            action = names[int(rng.integers(0, len(names)))]
            j.agent(a).set_action(action)
            t.agent(a).set_action(action)
        j.step()
        t.step()
        step += 1
    assert j.is_done and step == t.config.game.max_steps
    assert tmem.recent_records(limit=1)[0].model_dump() == jmem.recent_records(limit=1)[0].model_dump()
    assert {"wall", "agent"} <= seen_types, seen_types
