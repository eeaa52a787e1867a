"""The port's territory and AOE phases against the JAX engine, exactly.

The ``territory`` bench variant (tools/bench_run.make_territory_cfg: agents
of one team, junctions of two teams that control the territory "zone" and
emit an AOE, the AOE mask in the observations) is converted to the JAX
engine's config classes field for field, so both engines compile the same
program. Both then step in lockstep from the JAX reset state, fed the same
actions, agent orders and reset maps (the JAX engine's own draws, as
tests/test_torch_general.py feeds them). Every output and every state field
but ``rng`` (``aoe_inside`` and ``territory_inside`` included) must be
equal after every step (tolerance: exact; payloads are integers, float
stats and rewards sums of small integers).

The reference does not walk territory handlers, nor AOE presence deltas,
when it decides which pool fields a program can write
(mutfields.maybe_written_pool_fields, ROADMAP Queue 3): with a one-map pool
its auto-reset merge then skips ``obj_inv`` and inventories leak across
episodes. The port walks them; it is held to the reference run with
METTAGRID_TPU_NO_MERGE_SKIP=1, and the leak of the reference's own merge is
shown. Its gridless gate walks territory handlers too, and a territory whose
prefix names no tag raises when the phase or the observations are built.

Where no phase writes an object's type, the port's AOE phase runs each spec
over its type's slots as the pool bounds them; that path is held to the one
over every slot (the path where a type may be written), state for state.

The port's observations take a static background where every AOE and
territory write lands on an agent (mutfields.static_background, a
whitelist held here case by case); that route is held to the mutable one,
byte for byte, across auto-resets that swap maps.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mettagrid_tpu.engine as jengine
from mettagrid_tpu.config.game_config import MettaGridConfig as JMettaGridConfig
from mettagrid_tpu.engine.actions_fast import gridless_batch_ok as jax_gridless_batch_ok
from mettagrid_tpu.engine.mutfields import maybe_written_pool_fields as jax_maybe_written_pool_fields
from mettagrid_tpu.maps.random_map import RandomMapBuilder as JRandomMapBuilder
from mettagrid_tpu_torch import engine as tengine
from mettagrid_tpu_torch.config.event_config import EventConfig
from mettagrid_tpu_torch.config.handler_config import (
    AOEConfig,
    EntityTarget,
    Handler,
    ResourceDeltaMutation,
    SharedTagPrefixFilter,
    SpawnObjectMutation,
    SwapMutation,
)
from mettagrid_tpu_torch.config.tag import typeTag
from mettagrid_tpu_torch.config.territory_config import TerritoryConfig, TerritoryControlConfig
from mettagrid_tpu_torch.engine import aoe
from mettagrid_tpu_torch.engine import obs as tobs
from mettagrid_tpu_torch.engine import step as tstep
from mettagrid_tpu_torch.engine.state import EnvState
from mettagrid_tpu_torch.maps.map_builder import GameMap
from mettagrid_tpu_torch.profiling import trace
from mettagrid_tpu_torch.engine.actions_fast import gridless_batch_ok
from mettagrid_tpu_torch.engine.mutfields import maybe_written_pool_fields
from mettagrid_tpu_torch.tools import bench_run
from tests.test_torch_general import E, _build, _lockstep
from tests.test_torch_host_compile import _norm


def jax_twin(cfg):
    """The JAX engine's config equal to the port's ``cfg`` (a random map
    builder is rebuilt from its fields)."""
    d = cfg.model_dump()
    mb = d["game"].pop("map_builder")
    jcfg = JMettaGridConfig.model_validate(d)
    jcfg.game.map_builder = JRandomMapBuilder.Config(**{k: v for k, v in mb.items() if k != "type"})
    return jcfg


def _cfgs(max_steps, agents=24, change=None):
    """(JAX config, port config) of the territory variant, changed in place
    by ``change(cfg)``."""
    cfg = bench_run.make_cfg("territory", agents)
    cfg.game.max_steps = max_steps
    if change is not None:
        change(cfg)
    return jax_twin(cfg), cfg


def _no_aoe(cfg):
    for name in ("junction_cogs", "junction_clips"):
        cfg.game.objects[name].aoes = {}


def _observed(seen, program):
    """A lockstep check that counts AOE mask tokens by value, the agents'
    hearts and armor, agents inside owned territory and inside some AOE."""
    heart = list(program.resource_names).index("heart")
    armor = list(program.resource_names).index("armor")
    fid = program.feature_ids.aoe_mask
    A = program.num_agents

    def check(jstate, tstate, tout):
        obs = tout.observations.numpy()
        vals = obs[..., 2][obs[..., 1] == fid]
        for v in (1, 2):
            seen[f"mask_{v}"] = seen.get(f"mask_{v}", 0) + int((vals == v).sum())
        seen["hearts"] = max(seen.get("hearts", 0), int(tstate.obj_inv[:, :A, heart].sum()))
        seen["armor"] = max(seen.get("armor", 0), int(tstate.obj_inv[:, :A, armor].sum()))
        seen["in_territory"] = seen.get("in_territory", 0) + int((tstate.territory_inside >= 0).sum())
        seen["in_aoe"] = seen.get("in_aoe", 0) + int(tstate.aoe_inside.sum())
        seen["overlap"] = max(seen.get("overlap", 0), int(tstate.aoe_inside.sum(dim=2).max()))

    return check


def test_territory_cfg_compiles_like_jax():
    """At bench size (24 agents, a pool of three 25x25 maps) the variant
    compiles to the reference's program and EnvInit; it takes the non-fused
    observation path, over the static background that the port's gate admits
    and the action phase's gate (the reference's) refuses."""
    rng = np.random.default_rng(0)
    seeds = [int(rng.integers(0, 2**31 - 1)) for _ in range(3)]
    tp, ti = bench_run.build_pool(bench_run.make_cfg("territory"), 3)
    jp, ji = _build(jengine, jax_twin(bench_run.make_cfg("territory")), seeds)
    assert _norm(tp) == _norm(jp)
    for f in ti.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(ti, f), getattr(ji, f), err_msg=f)
    assert len(tp.aoe_specs) == 2 and len(tp.territories) == 1
    gates = tstep.step_gates(tp)
    assert not gates.lazy_grid and gates.static_bg
    assert tobs.make_obs_fn(tp, None, "cpu").route == "nonfused"


def test_lockstep_matches_jax():
    """40 steps with max_steps=24 over a pool of three maps: every env
    auto-resets once onto the JAX engine's map draw; agents enter and leave
    owned territory and AOEs, gain hearts and armor, and see both friendly
    and enemy AOE mask tokens."""
    jcfg, tcfg = _cfgs(24)
    seen = {}
    seen.update(_lockstep(jcfg, tcfg, 40, check=_observed(seen, tengine.compile_program(tcfg))))
    assert seen["resets"] == E
    assert seen["mask_1"] > 0 and seen["mask_2"] > 0, "no friendly or no enemy AOE mask token"
    assert seen["hearts"] > 0 and seen["armor"] > 0, "income or armor never reached an agent"
    assert seen["in_territory"] > 0 and seen["in_aoe"] > 0


@pytest.mark.parametrize("site", ["territory", "aoe_presence"])
def test_written_fields_walk_territory_and_presence_sites(site):
    """Territory handlers and AOE presence deltas write the agents'
    inventories: the port's maybe_written_pool_fields says so; the
    reference's does not (the merge-skip fault)."""

    def change(cfg):
        _no_aoe(cfg)
        if site == "aoe_presence":
            cfg.game.territories = {}
            cfg.game.obs.aoe_mask = False
            for name in ("junction_cogs", "junction_clips"):
                cfg.game.objects[name].territory_controls = []
            buff = AOEConfig(name="buff", radius=2, presence_deltas={"armor": 1})
            cfg.game.objects["junction_cogs"].aoes = {"buff": buff}

    jcfg, tcfg = _cfgs(16, change=change)
    assert "obj_inv" in maybe_written_pool_fields(tengine.compile_program(tcfg))
    assert "obj_inv" not in jax_maybe_written_pool_fields(jengine.compile_program(jcfg))


def test_one_map_pool_matches_jax_without_merge_skip(monkeypatch):
    """Territories without AOE on a one-map pool, 40 steps with
    max_steps=16 (two auto-resets per env): the port's merge, which keeps
    obj_inv, equals the reference without its merge skip; the reference's
    own skip carries the last episode's hearts and armor into the next."""
    monkeypatch.setenv("METTAGRID_TPU_NO_MERGE_SKIP", "1")
    jcfg, tcfg = _cfgs(16, change=_no_aoe)
    seen = {}
    seen.update(_lockstep(jcfg, tcfg, 40, seeds=(3,), check=_observed(seen, tengine.compile_program(tcfg))))
    assert seen["resets"] == 2 * E
    assert seen["hearts"] > 0 and seen["armor"] > 0

    # The reference with and without its skip, on the same moves, across
    # the first auto-reset (step 17).
    jp, ji = _build(jengine, jcfg, (3,))
    fresh = np.asarray(ji.obj_inv[0, : jp.num_agents])
    inv = {}
    for skip in (False, True):
        if skip:
            monkeypatch.delenv("METTAGRID_TPU_NO_MERGE_SKIP")
        state, _ = jengine.make_reset(jp, ji, E)(0)
        step = jengine.make_step(jp, ji, auto_reset=True, donate=False)
        rng = np.random.default_rng(0)
        for _ in range(17):
            acts = jnp.asarray(rng.integers(0, 5, (E, jp.num_agents)), dtype=jnp.int32)
            state, _ = step(state, acts, jnp.zeros_like(acts))
        assert int(state.step_count.max()) == 1
        inv[skip] = np.asarray(state.obj_inv[:, : jp.num_agents])
    # One step into the new episode an agent holds at most a heart and an
    # armor of that step; with the skip it still holds the last episode's.
    assert (inv[False] - fresh).max() <= 2
    assert (inv[True] - fresh).max() > 2


def test_gridless_gate_walks_territory_handlers():
    """A territory handler that moves objects (a swap) makes the wave batch
    unsafe without the grid: the port's gate says so, the reference's does
    not look."""

    def change(cfg):
        _no_aoe(cfg)
        cfg.game.territories["zone"].presence = Handler(name="shove", mutations=[SwapMutation()])

    jcfg, tcfg = _cfgs(16, change=change)
    base_j, base_t = _cfgs(16, change=_no_aoe)
    assert jax_gridless_batch_ok(jengine.compile_program(base_j)) and gridless_batch_ok(tengine.compile_program(base_t))
    assert jax_gridless_batch_ok(jengine.compile_program(jcfg))
    assert not gridless_batch_ok(tengine.compile_program(tcfg))


def test_empty_territory_tag_table_raises():
    """A territory whose prefix names no tag raises ValueError naming it when
    the step or the observation function is built, not while stepping."""

    def change(cfg):
        cfg.game.territories = {"realm": TerritoryConfig(tag_prefix="nation")}
        for name in ("junction_cogs", "junction_clips"):
            cfg.game.objects[name].territory_controls[0].territory = "realm"

    _, tcfg = _cfgs(16, change=change)
    program, init = _build(tengine, tcfg, (3,))
    with pytest.raises(ValueError, match="territory 'realm'"):
        tengine.make_step(program, init, device="cpu")
    with pytest.raises(ValueError, match="territory 'realm'"):
        tobs.make_obs_fn(program, None, "cpu")


def _paying_junctions(cfg):
    """Each junction pays a heart from its own inventory to each agent within
    radius 6, unfiltered: a mutation that runs per (source, agent) pair."""
    for name in ("junction_cogs", "junction_clips"):
        obj = cfg.game.objects[name]
        obj.inventory.initial = {"heart": 6}
        obj.aoes = {"pay": AOEConfig(name="pay", radius=6, mutations=[
            ResourceDeltaMutation(target=EntityTarget.ACTOR, deltas={"heart": -1}),
            ResourceDeltaMutation(target=EntityTarget.TARGET, deltas={"heart": 1}),
        ])}


def test_aoe_general_mutations_match_jax():
    """An AOE whose mutation runs per (source, agent) pair (the junction pays
    a heart from its own inventory for each agent it reaches) over four
    unfiltered junctions of radius 6, so that agents stand in both sources
    of one type at once: 20 steps of 8 agents, pool 3, in lockstep."""

    jcfg, tcfg = _cfgs(12, agents=8, change=_paying_junctions)
    program = tengine.compile_program(tcfg)
    assert any(m.kind == "resource_delta" and m.target_is_actor for s in program.aoe_specs for m in s.mutations)
    seen = {}
    seen.update(_lockstep(jcfg, tcfg, 20, check=_observed(seen, program)))
    assert seen["overlap"] >= 2, "no agent stood in two sources of one AOE at once"
    assert seen["hearts"] > 0


BENCH_SPEC = json.loads((Path(__file__).resolve().parents[1] / "gridbench" / "configs" / "territory.json").read_text())


def _junction_aoes(cfg, *mutations):
    for name in ("junction_cogs", "junction_clips"):
        cfg.game.objects[name].aoes["charge"].mutations.extend(mutations)


GATE_CASES = {
    # case: (change, static background admitted, the mask once per pooled map)
    "territory": (lambda cfg: None, True, True),
    "aoe_writes_source": (lambda cfg: _junction_aoes(cfg, ResourceDeltaMutation(target=EntityTarget.ACTOR,
                                                                                deltas={"heart": -1})), False, False),
    "aoe_general_kind": (lambda cfg: _junction_aoes(cfg, SpawnObjectMutation(object_type="wall")), False, False),
    "territory_writes_actor": (lambda cfg: cfg.game.territories["zone"].on_enter.mutations.append(
        ResourceDeltaMutation(target=EntityTarget.ACTOR, deltas={"armor": 1})), False, False),
    "agent_emits": (lambda cfg: setattr(cfg.game.agent, "territory_controls",
                                        [TerritoryControlConfig(territory="zone", strength=1024, decay=256)]),
                    True, False),
    "event_with_aoe": (lambda cfg: setattr(cfg.game, "events", {"bloom": EventConfig(
        name="bloom", target_query=typeTag("wall"), timesteps=[2],
        mutations=[ResourceDeltaMutation(target=EntityTarget.TARGET, deltas={"heart": 1})])}), False, False),
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_static_observation_gate(case):
    """The observations' static background admits the benchmark's territory
    game (every AOE and territory write lands on an agent) and refuses an
    AOE or territory handler that writes its actor (the source or the
    proxy), a mutation kind outside the whitelist, and an event; where an
    agent type emits territory the mask stays per step. The action phase's
    gate is unchanged: the lazy grid stays off for the territory game."""
    from gridbench.port import config_module

    change, admitted, mask_static = GATE_CASES[case]
    cfg = config_module("territory").port_config(BENCH_SPEC, 100)
    change(cfg)
    program = tengine.compile_program(cfg)
    gates = tstep.step_gates(program)
    assert gates.static_bg == admitted
    assert gates.static_mask == mask_static
    assert not gates.lazy_grid
    if case == "territory":
        one_map = cfg.game.map_builder.model_copy(update={"seed": 0}).create().build_for_num_agents(program.num_agents)
        init = tengine.build_env_init(program, [one_map])
        assert tengine.make_step(program, init, device="cpu").lazy_grid is False


def test_static_route_matches_mutable_route(monkeypatch):
    """The territory variant (8 agents, a pool of three maps, max_steps=4)
    stepped 14 times through the static route (the pooled image and mask)
    and through the mutable one (every object and every cell's winning tag
    each step), in lockstep from one reset, every auto-reset swapping the
    env's map: equal observation bytes, attempted tokens, interleaved images
    (the mask channel included) and states after every step. Stage 1 runs
    over E·A slots on the static route and E·N on the mutable one, and the
    territory's emitters are read once a step, not twice."""
    _, tcfg = _cfgs(4, agents=8)
    tp, ti = _build(tengine, tcfg, (3, 4, 5))
    E, A, N, P = 4, tp.num_agents, ti.obj_type.shape[1], 3
    state, _ = tengine.make_reset(tp, ti, E, device="cpu")(0)
    static_step = tengine.make_step(tp, ti, external_perm=True, device="cpu")
    monkeypatch.setattr(tstep, "step_obs_fn", lambda program, init, device, obs_tail, draws, gates=None:
                        tobs.make_obs_fn(program, None, device, obs_tail, draws))
    mutable_step = tengine.make_step(tp, ti, external_perm=True, device="cpu")
    assert static_step.obs_fn.route == mutable_step.obs_fn.route == "nonfused"
    rng = np.random.default_rng(0)
    zeros = torch.zeros((E, A), dtype=torch.int32)
    sstate, mstate, swaps, masked = state, state, 0, 0
    for _ in range(14):
        acts = torch.from_numpy(rng.integers(0, 5, (E, A)).astype(np.int32))
        perm = torch.from_numpy(np.stack([rng.permutation(A) for _ in range(E)]).astype(np.int32))
        maps = (sstate.map_idx + 1) % P
        before = sstate.map_idx
        sstate, sout = static_step(sstate, acts, zeros, perm, reset_maps=maps)
        mstate, mout = mutable_step(mstate, acts, zeros, perm, reset_maps=maps)
        swaps += int((sstate.map_idx != before).sum())
        assert torch.equal(sout.observations, mout.observations)
        assert torch.equal(sout.tokens_attempted, mout.tokens_attempted)
        simg, mimg = (s.obs_fn.window_inputs(st) for s, st in ((static_step, sstate), (mutable_step, mstate)))
        assert torch.equal(simg["img"], mimg["img"])
        masked += int((simg["img"][..., simg["Ch"] - 1 :: simg["Ch"]] > 0).sum())
        for name, a, b in zip(EnvState._fields, sstate, mstate):
            assert torch.equal(a, b), name
    assert swaps >= 2 * E and masked > 0

    counts = {}
    for name, step in (("static", static_step), ("mutable", mutable_step)):
        trace.reset()
        step(sstate, acts, zeros, perm, reset_maps=maps)
        counts[name] = (trace.counted("obs.stage1_slots"), trace.counted("host_syncs.territory.emitters"))
    trace.reset()
    assert counts == {"static": (E * A, 1), "mutable": (E * N, 2)}


def _agent_aura(effect_self):
    """Agents carry an AOE of radius 2 (mobile sources in the agent prefix):
    a heart a tick to agents of their team, armor while inside."""

    def change(cfg):
        cfg.game.agent.aoes = {"aura": AOEConfig(
            name="aura", radius=2, effect_self=effect_self, filters=[SharedTagPrefixFilter(tag_prefix="team")],
            mutations=[ResourceDeltaMutation(target=EntityTarget.TARGET, deltas={"heart": 1})],
            presence_deltas={"armor": 1})}

    return change


JUNCTIONS = {"wall": 10, "junction_cogs": 2, "junction_clips": 2}
CELLS = {"#": "wall", ".": "empty", "@": "agent.agent", "C": "junction_cogs", "K": "junction_clips"}
# Two maps of 11 objects, slots in row-major order: the second holds one
# junction_cogs fewer, and it is its last slot, N - 1, so the padding of its
# source lists (N, clipped to N - 1 where a row is read) lands on a source.
PADDED = [["@@@@....", "..C.C...", "@@@@..K."],
          ["@@@.....", ".#..K...", "@@@@.@.C"]]
BOUNDED_CASES = {
    # case: (change, agents, each pool map: the objects of a random map, or its rows)
    "junction_slots_differ": (None, 24, [JUNCTIONS] * 3),
    "padded_sources": (None, 8, PADDED),
    "agent_aura": (_agent_aura(False), 8, [JUNCTIONS] * 3),
    "agent_aura_self": (_agent_aura(True), 8, [JUNCTIONS] * 3),
    "general_mutations": (_paying_junctions, 8, [JUNCTIONS] * 3),
}


@pytest.mark.parametrize("case", list(BOUNDED_CASES))
def test_bounded_sources_match_every_slot(case, monkeypatch):
    """Where no phase writes an object's type, each AOE spec runs over its
    type's slots as the pool bounds them; that step equals the one over every
    slot (the path taken where a type may be written, forced here), every
    state field and output after every step of 20 over 8 envs, with
    max_steps=12 and each auto-reset onto a drawn pool map: junctions at other slots in each
    map, maps with fewer sources of a type than the bound (padding), agents
    as sources with and without their own reach, and a mutation per (source,
    agent) pair where agents stand in two sources of one type."""
    change, agents, objects = BOUNDED_CASES[case]
    _, tcfg = _cfgs(12, agents=agents, change=change)
    program = tengine.compile_program(tcfg)
    mb = tcfg.game.map_builder
    maps = [mb.model_copy(update={"seed": 3 + i, "objects": o}).create().build_for_num_agents(program.num_agents)
            if isinstance(o, dict) else GameMap(np.array([[CELLS[ch] for ch in row] for row in o]))
            for i, o in enumerate(objects)]
    init = tengine.build_env_init(program, maps)
    E, A, P = 8, program.num_agents, len(maps)
    written = aoe.maybe_written_pool_fields(program)
    assert "obj_type" not in written
    bounded = tengine.make_step(program, init, auto_reset=True, external_perm=True, device="cpu")
    monkeypatch.setattr(aoe, "maybe_written_pool_fields", lambda p: written | {"obj_type"})
    dense = tengine.make_step(program, init, auto_reset=True, external_perm=True, device="cpu")
    junctions = [program.type_names.index(n) for n in ("junction_cogs", "junction_clips")]
    where = [tuple(np.flatnonzero(np.isin(t, junctions))) for t in init.obj_type]
    counts = {tuple(int((t == j).sum()) for j in junctions) for t in init.obj_type}
    assert len(set(where)) == P and (case != "padded_sources" or len(counts) == P)

    state, _ = tengine.make_reset(program, init, E, device="cpu")(0)
    rng = np.random.default_rng(0)
    zeros = torch.zeros((E, A), dtype=torch.int32)
    bstate, dstate, inside, agents_inside, overlap = state, state, 0, 0, 0
    for i in range(20):
        acts = torch.from_numpy(rng.integers(0, 5, (E, A)).astype(np.int32))
        perm = torch.from_numpy(np.stack([rng.permutation(A) for _ in range(E)]).astype(np.int32))
        maps_drawn = torch.from_numpy(rng.integers(0, P, E).astype(np.int32))
        bstate, bout = bounded(bstate, acts, zeros, perm, reset_maps=maps_drawn)
        dstate, dout = dense(dstate, acts, zeros, perm, reset_maps=maps_drawn)
        for name, a, b in zip(EnvState._fields, bstate, dstate):
            assert a.shape == b.shape and torch.equal(a, b), (i, name)
        for name, a, b in zip(bout._fields, bout, dout):
            assert torch.equal(a, b), (i, name)
        inside += int(bstate.aoe_inside.sum())
        agents_inside += int(bstate.aoe_inside[:, :, :A].sum())
        overlap = max(overlap, int(bstate.aoe_inside.sum(dim=2).max()))
    assert inside > 0
    if case.startswith("agent_aura"):
        assert agents_inside > 0, "no agent stood in another's aura"
    if case == "general_mutations":
        assert overlap >= 2, "no agent stood in two sources of one AOE at once"
