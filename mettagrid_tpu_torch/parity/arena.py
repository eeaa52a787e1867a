"""Arena-scale episode-signature parity vs the reference C++ engine
(twin of the JAX package's parity/arena.py).

Bit-exact signature parity on arena-scale episodes is the correctness target
(reference: scripts/deterministic_episode_signature.py:50-120). This module
runs the make_arena(24) preset in BOTH engines — for run_arena_parity the map
is generated once by the REFERENCE's own MapGen (mapgen RNGs are independent
implementations, so the literal map is pinned; everything else is the preset
as shipped) — drives hundreds of steps of shared random actions under
reproduced MT19937 agent shuffling, and compares per-checkpoint positions,
inventories, action successes, observation tokens, and the full end-state
signature (objects, vibes, inventories, rewards, per-agent stats).

The two halves are separate: ``run_arena_ours`` needs no oracle and returns
this engine's trace (on the CUDA device unless asked for another), and
``run_arena_parity`` runs it beside the reference and diffs the two. Each
family's config is written once, against a namespace of either engine's
config classes (``our_config``, ``ref_config``); the action script and the
loadouts are functions of their seeds (``action_script``, ``loadouts``).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np

ATTACK_HANDLER_NAME = "melee"
# The biased combat script: a primary action (noop, the moves) with this
# probability, else a change to one of these vibes.
COMBAT_VIBES = ("angry", "shield", "clown", "default")
COMBAT_PRIMARY_SHARE = 0.6
COMBAT_HEARTS = 30
# The direct-attack family's config-declared loadout.
PURE_ATTACK_LOADOUT = {"laser": 4, "armor": 1, "heart": 30}


def build_arena_map(num_agents: int, map_seed: int) -> List[List[str]]:
    """Generate the arena map with the reference's MapGen (host-side numpy)."""
    from mettagrid_tpu_torch.parity.reference_oracle import load_reference

    load_reference()
    from mettagrid.builder.envs import make_arena as ref_make_arena

    cfg = ref_make_arena(num_agents)
    mb_cfg = cfg.game.map_builder
    if hasattr(mb_cfg, "seed"):
        mb_cfg = mb_cfg.model_copy(update={"seed": map_seed})
    gm = mb_cfg.create().build_for_num_agents(num_agents)
    return [[str(c) for c in row] for row in np.asarray(gm.grid)]


def arena_map(num_agents: int, map_seed: int) -> List[List[str]]:
    """An arena map for runs without the oracle, from this engine's MapGen
    seeded with ``map_seed``: the make_arena preset's 25x25 room (10 walls,
    the agents at random) inside MapGen's 5-cell border, the layout of the
    reference preset's MapGen map (SURVEY.md: "MapGen 25x25 random"). The
    preset's own map builder here draws a 1-cell border, whose map holds
    only its 10 interior walls: fewer than the economy family's 12 reachable
    ones."""
    from mettagrid_tpu_torch.mapgen import MapGen
    from mettagrid_tpu_torch.mapgen.scenes.random import Random

    mb_cfg = MapGen.Config(width=25, height=25, seed=map_seed,
                           instance=Random.Config(agents=num_agents, objects={"wall": 10}))
    gm = mb_cfg.create().build_for_num_agents(num_agents)
    return [[str(c) for c in row] for row in np.asarray(gm.grid)]


def rename_walls(map_data, names: List[str], reachable: bool = False):
    """Rename the first len(names) interior wall cells (raster order) so a
    scenario gets a small, pinned object set in both engines (registration
    order = map raster order, the same invariant obs parity already relies
    on). reachable=True takes only walls with an orthogonally adjacent
    empty cell (the raster-first walls are the thick border ring, which
    agents can never bump), striding so the picks spread across the map.
    Takes and returns rows of names, or a grid array (as a new array)."""
    if isinstance(map_data, np.ndarray):
        return np.array(rename_walls(map_data.tolist(), names, reachable), dtype=map_data.dtype)
    out = [list(row) for row in map_data]
    H, W = len(out), len(out[0])
    if reachable:
        cands = [
            (r, c)
            for r in range(1, H - 1)
            for c in range(1, W - 1)
            if out[r][c] == "wall"
            and any(
                out[r + dr][c + dc] == "empty"
                for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1))
            )
        ]
        if len(cands) < len(names):
            raise ValueError(f"only {len(cands)} reachable walls for {len(names)} names")
        stride = max(1, len(cands) // len(names))
        for i, name in enumerate(names):
            r, c = cands[i * stride]
            out[r][c] = name
        return out
    done = 0
    for r in range(1, H - 1):
        for c in range(1, W - 1):
            if out[r][c] == "wall" and done < len(names):
                out[r][c] = names[done]
                done += 1
    if done != len(names):
        raise ValueError(f"only {done} interior walls for {len(names)} names")
    return out


def _shrine_map(map_data: List[List[str]], count: int = 8) -> List[List[str]]:
    return rename_walls(map_data, ["shrine"] * count)


def family_map(map_data: List[List[str]], events: bool = False, economy: bool = False,
               random_query: bool = False, **_family) -> List[List[str]]:
    """The family's map: events=True renames 8 walls to shrines (the tithe
    family needs BUMPABLE shrines, since its draws happen on bump-use; the
    plain event family keeps the original raster-first placement, which the
    pinned signatures depend on); economy=True renames 12 reachable walls to
    alternating mines and altars."""
    if events:
        map_data = rename_walls(map_data, ["shrine"] * 8, reachable=True) if random_query else _shrine_map(map_data)
    if economy:
        map_data = rename_walls(map_data, ["mine", "altar"] * 6, reachable=True)
    return map_data


class _FamilyApi:
    """The config symbols the families use, of this engine (ours=True) or of
    the reference (ours=False), so each family is written once."""

    def __init__(self, ours: bool):
        self.ours = ours
        if ours:
            from mettagrid_tpu_torch.builder.envs import make_arena
            from mettagrid_tpu_torch.config import handler_config as H
            from mettagrid_tpu_torch.config.action_config import ChangeVibeActionConfig
            from mettagrid_tpu_torch.config.event_config import EventConfig
            from mettagrid_tpu_torch.config.game_config import GridObjectConfig
            from mettagrid_tpu_torch.config.game_value import QueryInventoryValue
            from mettagrid_tpu_torch.config.query import Query
            from mettagrid_tpu_torch.config.tag import typeTag
            from mettagrid_tpu_torch.test_support import ObjectNameMapBuilder

            F = M = H
            self.DirectAttackMutation = H.DirectAttackMutation
        else:
            from mettagrid_tpu_torch.parity.reference_oracle import load_reference

            load_reference()
            from mettagrid.builder.envs import make_arena
            from mettagrid.config import filter as F
            from mettagrid.config import handler_config as H
            from mettagrid.config import mutation as M
            from mettagrid.config.action_config import ChangeVibeActionConfig
            from mettagrid.config.event_config import EventConfig
            from mettagrid.config.game_value import QueryInventoryValue
            from mettagrid.config.mettagrid_config import GridObjectConfig
            from mettagrid.config.query import Query
            from mettagrid.config.tag import typeTag
            from mettagrid.test_support.map_builders import ObjectNameMapBuilder

        self.make_arena = make_arena
        self.ObjectNameMapBuilder = ObjectNameMapBuilder
        self.ChangeVibeActionConfig = ChangeVibeActionConfig
        self.EventConfig = EventConfig
        self.GridObjectConfig = GridObjectConfig
        self.QueryInventoryValue = QueryInventoryValue
        self.Query = Query
        self.typeTag = typeTag
        self.Handler = H.Handler
        self.EntityTarget = H.EntityTarget
        self.updateTarget = H.updateTarget
        self.GameValueFilter = F.GameValueFilter
        self.HandlerTarget = F.HandlerTarget
        self.ResourceFilter = F.ResourceFilter
        self.VibeFilter = F.VibeFilter
        self.ResourceDeltaMutation = M.ResourceDeltaMutation
        self.ResourceTransferMutation = M.ResourceTransferMutation
        self.SwapMutation = M.SwapMutation

    def random_hearts_filter(self, minimum: int):
        """Hearts summed over two shrines picked by an order_by=random query
        (query_system.cpp:78-87), at least ``minimum``: every evaluation
        draws a std::shuffle from the env's mt19937."""
        query = self.Query(source=self.typeTag("shrine"), order_by="random", max_items=2)
        return self.GameValueFilter(
            target=self.HandlerTarget.ACTOR,
            value=self.QueryInventoryValue(query=query.model_dump() if self.ours else query, item="heart"),
            min=minimum,
        )

    def direct_attack(self) -> list:
        """The melee handler's attack: this engine's DirectAttackMutation; the
        reference's is the bound C++ AttackMutationConfig, attached after
        conversion (_ref_sim), since its converter drops the Python one."""
        if not self.ours:
            return []
        return [self.DirectAttackMutation(weapon_resource="laser", armor_resource="armor", health_resource="heart")]


def _apply_family(
    api: _FamilyApi,
    cfg,
    combat: bool = False,
    events: bool = False,
    economy: bool = False,
    pure_attack: bool = False,
    random_query: bool = False,
    event_filter_rng: bool = False,
):
    """Add a family to an arena config, in place. combat=True adds a
    vibe-gated move handler carrying the C++-executable attack. events=True
    adds shrine objects and a max_targets=3 event firing every 25 steps —
    both engines' event RNG consumption (event.cpp:41-44 std::shuffle) must
    then stay in lockstep (the engine's MT19937 twin, engine/mt19937.py).
    economy=True adds "mine" (on_use: +2 ore_red) and "altar" (on_use gated
    on 2 ore_red: converts them to a heart) — bump-use runs through the
    default TargetIsUsable→UseTarget move handler
    (action_handler_factory.cpp:33-45), exercising on_use chains, resource
    filters, and inventory deltas at scale."""
    if (random_query or event_filter_rng) and not events:
        raise ValueError("random_query/event_filter_rng build on the shrine/event family")
    game = cfg.game
    if events:
        shrine_kw: Dict[str, Any] = {}
        if random_query:
            # "tithe": bump-using a shrine pays the actor 1 ore_red IF two
            # RANDOMLY-chosen shrines hold at least one heart between them.
            # Every evaluation consumes a std::shuffle from the env's mt19937
            # inside an ACTION handler context (HandlerContext::rng): such
            # draws ride the in-state MT twin in the reference's per-agent
            # sequential order (engine/rng_dep.py). The enrich event below
            # keeps shrine heart counts uneven, so WHICH two shrines the
            # shuffle picks changes the filter outcome.
            shrine_kw["on_use_handler"] = api.Handler(
                name="tithe",
                filters=[api.random_hearts_filter(1)],
                mutations=[api.ResourceDeltaMutation(target=api.EntityTarget.ACTOR, deltas={"ore_red": 1})],
            )
        game.objects["shrine"] = api.GridObjectConfig(name="shrine", map_name="shrine", **shrine_kw)
        event_kw: Dict[str, Any] = {}
        if event_filter_rng:
            # A CONSUMING filter on the event handler itself: the query
            # draws one std::shuffle PER VISITED TARGET in application
            # order, and targets past the max_targets cap are never visited
            # (Event::execute breaks — event.cpp:46-55), so both the draw
            # COUNT and position depend on the walk. min=0 keeps outcomes
            # identical to the plain family while the entire downstream MT
            # stream (next step's agent shuffle, later events) shifts with
            # every consumed draw.
            event_kw["filters"] = [api.random_hearts_filter(0)]
        game.events = {
            "enrich": api.EventConfig(
                name="enrich",
                target_query=api.typeTag("shrine"),
                timesteps=list(range(10, 501, 25)),
                max_targets=3,
                mutations=[api.updateTarget({"heart": 1})],
                **event_kw,
            )
        }

    if economy:
        # mine: bump-use pays 2 ore_red; altar: 2 ore_red convert to a heart
        # (the heart feeds the arena preset's existing inventory reward; the
        # resource filter still blocks fresh agents bumping altars first).
        game.objects["mine"] = api.GridObjectConfig(
            name="mine",
            map_name="mine",
            on_use_handler=api.Handler(
                name="mine_use",
                mutations=[api.ResourceDeltaMutation(target=api.EntityTarget.ACTOR, deltas={"ore_red": 2})],
            ),
        )
        game.objects["altar"] = api.GridObjectConfig(
            name="altar",
            map_name="altar",
            on_use_handler=api.Handler(
                name="altar_use",
                filters=[api.ResourceFilter(target=api.HandlerTarget.ACTOR, resources={"ore_red": 2})],
                mutations=[
                    api.ResourceDeltaMutation(target=api.EntityTarget.ACTOR, deltas={"ore_red": -2, "heart": 1})
                ],
            ),
        )
        if api.ours:
            game.obs.full_token_bounds = True  # host-injected starting ore

    if combat:
        # Full combat semantics at scale, in BOTH DSLs:
        #   shield_break — a shielding target consumes armor instead of
        #       taking damage (defense-consumption analogue; vibe interplay)
        #   melee — loot transfer (target -> actor ore) THEN the attack
        #       (the reference's add_attack_mutation appends after the
        #       converted list, so ours lists the attack last too)
        #   bump_swap — clown-vibed actors swap places with the bump target
        #       (agents only; swap_mutation.hpp:16-18 guards)
        game.actions.change_vibe = api.ChangeVibeActionConfig()
        game.actions.move.handlers = [
            api.Handler(
                name="shield_break",
                filters=[
                    api.VibeFilter(target=api.HandlerTarget.ACTOR, vibe="angry"),
                    api.VibeFilter(target=api.HandlerTarget.TARGET, vibe="shield"),
                ],
                mutations=[api.ResourceDeltaMutation(target=api.EntityTarget.TARGET, deltas={"armor": -1})],
            ),
            api.Handler(
                name=ATTACK_HANDLER_NAME,
                filters=[api.VibeFilter(target=api.HandlerTarget.ACTOR, vibe="angry")],
                mutations=[
                    api.ResourceTransferMutation(
                        from_target=api.EntityTarget.TARGET,
                        to_target=api.EntityTarget.ACTOR,
                        resources={"ore_red": 1},
                    )
                ]
                + api.direct_attack(),
            ),
            api.Handler(
                name="bump_swap",
                filters=[api.VibeFilter(target=api.HandlerTarget.ACTOR, vibe="clown")],
                mutations=[api.SwapMutation()],
            ),
        ]
        if api.ours:
            game.obs.full_token_bounds = True  # host-injected loadouts

    if pure_attack:
        # Direct-attack ONLY (no loot/shield/swap): in this engine the
        # static-background obs with the wave-parallel action phase. The
        # loadouts are config-declared (not host-injected) so the obs-caps
        # proof and the OUT_W prefix stay active: the exact production
        # combat path.
        game.actions.change_vibe = api.ChangeVibeActionConfig()
        game.agent.inventory.initial = dict(PURE_ATTACK_LOADOUT)
        game.actions.move.handlers = [
            api.Handler(
                name=ATTACK_HANDLER_NAME,
                filters=[api.VibeFilter(target=api.HandlerTarget.ACTOR, vibe="angry")],
                mutations=api.direct_attack(),
            )
        ]
    return cfg


def apply_family(cfg, **family):
    """This engine's ``cfg`` (an arena config) with a family added, in place."""
    return _apply_family(_FamilyApi(ours=True), cfg, **family)


def _config(ours: bool, map_data: List[List[str]], num_agents: int, **family):
    api = _FamilyApi(ours)
    cfg = api.make_arena(
        num_agents, map_builder=api.ObjectNameMapBuilder.Config(map_data=family_map(map_data, **family))
    )
    return _apply_family(api, cfg, **family)


def our_config(map_data: List[List[str]], num_agents: int, **family):
    """This engine's make_arena(num_agents) on ``map_data`` with a family."""
    return _config(True, map_data, num_agents, **family)


def ref_config(map_data: List[List[str]], num_agents: int, **family):
    """The reference's make_arena(num_agents) on ``map_data`` with a family
    (needs the oracle)."""
    return _config(False, map_data, num_agents, **family)


def _ref_sim(ref_cfg, seed: int, combat: bool):
    """Construct the reference Simulation, attaching the bound C++ attack
    config to the named move handler when combat is on (the
    handler_bindings.hpp:544 path — see parity/cross_engine.run_reference)."""
    import mettagrid.config.mettagrid_c_config as mcc
    from mettagrid.simulator.simulator import Simulator

    if not combat:
        return Simulator().new_simulation(ref_cfg, seed=seed)

    from mettagrid.mettagrid_c import AttackMutationConfig as CppAttackMutationConfig

    orig_convert = mcc.convert_mutations

    def patched(mutations, target_obj, id_maps, context=""):
        orig_convert(mutations, target_obj, id_maps, context)
        if context == f"handler '{ATTACK_HANDLER_NAME}'":
            target_obj.add_attack_mutation(
                CppAttackMutationConfig(
                    weapon_resource=id_maps.resource_name_to_id["laser"],
                    armor_resource=id_maps.resource_name_to_id["armor"],
                    health_resource=id_maps.resource_name_to_id["heart"],
                    damage_multiplier_pct=100,
                )
            )

    mcc.convert_mutations = patched
    try:
        return Simulator().new_simulation(ref_cfg, seed=seed)
    finally:
        mcc.convert_mutations = orig_convert


def combat_loadout(agent: int) -> Dict[str, int]:
    """The full-combat family's loadout of ``agent``."""
    return {"laser": 3 + agent % 3, "armor": agent % 4, "heart": COMBAT_HEARTS, "ore_red": 2 + agent % 2}


def economy_loadout(agent: int) -> Dict[str, int]:
    """The economy family's seed ore, so altar conversions engage early
    (random walks reach altars long before they mine 2 ore)."""
    return {"ore_red": 2 + agent % 3}


def loadouts(num_agents: int, combat: bool = False, economy: bool = False, **_family) -> Dict[int, Dict[str, int]]:
    """The inventories a family sets on the host before its first step."""
    out: Dict[int, Dict[str, int]] = {}
    for i in range(num_agents):
        if combat:
            out[i] = combat_loadout(i)
        if economy:
            out[i] = economy_loadout(i)
    return out


def script_actions(action_names) -> List[str]:
    """The script's vocabulary: the primary actions, then the vibe actions
    sorted by name (the order both engines share)."""
    primary = [n for n in action_names if not n.startswith("change_vibe_")]
    return primary + sorted(n for n in action_names if n.startswith("change_vibe_"))


def action_script(actions: List[str], action_seed: int, steps: int, num_agents: int,
                  biased: bool = False) -> np.ndarray:
    """int[steps, num_agents] indices into ``actions``, from
    np.random.default_rng(action_seed): uniform, or with ``biased`` (the
    combat families) a primary action COMBAT_PRIMARY_SHARE of the time, else
    one of COMBAT_VIBES — uniform over ALL vibes leaves agents angry
    ~1/len(vibes) of the time."""
    rng = np.random.default_rng(action_seed)
    if not biased:
        return rng.integers(0, len(actions), size=(steps, num_agents))
    prim_ids = np.asarray([i for i, n in enumerate(actions) if not n.startswith("change_vibe_")])
    focus = np.asarray([actions.index(f"change_vibe_{v}") for v in COMBAT_VIBES])
    pick_prim = rng.random((steps, num_agents)) < COMBAT_PRIMARY_SHARE
    return np.where(
        pick_prim,
        prim_ids[rng.integers(0, len(prim_ids), size=(steps, num_agents))],
        focus[rng.integers(0, len(focus), size=(steps, num_agents))],
    )


def check_gates(program, pure_attack: bool = False, random_query: bool = False,
                event_filter_rng: bool = False, **_family) -> None:
    """Assert the route each family is there to exercise."""
    from mettagrid_tpu_torch.engine.actions_fast import pure_move_ok
    from mettagrid_tpu_torch.engine.rng_dep import actions_consume_rng, reference_rng_unsupported
    from mettagrid_tpu_torch.engine.step import step_gates

    if event_filter_rng:
        # A consuming EVENT-handler filter must compile (the sequential
        # per-target walk) instead of raising.
        assert not reference_rng_unsupported(program), "event_filter_rng config must be supported"
    if random_query:
        # order_by=random queries inside an ACTION handler context consume
        # HandlerContext::rng: the step must take the sequential MT-threaded
        # action path.
        assert actions_consume_rng(program), "random_query parity config must consume ctx.rng in action handlers"
    if pure_attack:
        # Live DirectAttack combat keeps the static-background obs path
        # while the wave (non-pure) action loop runs.
        assert step_gates(program).static_bg and not pure_move_ok(program), (
            "pure_attack parity config must take the static-bg + wave path"
        )


def engagement_problems(inventories: List[Dict[str, int]], combat: bool = False, economy: bool = False,
                        pure_attack: bool = False, random_query: bool = False, **_family) -> List[str]:
    """What a family that did not engage leaves in the final inventories
    (a zero-engagement run would vacuously "pass")."""
    A = len(inventories)
    problems: List[str] = []
    ores = [inv.get("ore_red", 0) for inv in inventories]
    hearts = sum(inv.get("heart", 0) for inv in inventories)
    if economy:
        # mines add 2 ore/use, altars burn 2 ore into a heart, nothing else
        # touches ore — so mine uses = (final_ore + 2*hearts - initial_ore) / 2.
        initial_ore = sum(economy_loadout(i)["ore_red"] for i in range(A))
        if hearts == 0:
            problems.append("altars never converted: no hearts produced")
        if sum(ores) + 2 * hearts - initial_ore <= 0:
            problems.append("mines never used: no ore was mined")
    if combat:
        # hearts drop on damage, ore moves on loot
        if hearts >= COMBAT_HEARTS * A:
            problems.append("combat never engaged: no heart damage recorded")
        if ores == [combat_loadout(i)["ore_red"] for i in range(A)]:
            problems.append("loot never transferred: ore distribution unchanged")
    if pure_attack and hearts >= PURE_ATTACK_LOADOUT["heart"] * A:
        problems.append("combat never engaged: no heart damage recorded")
    if random_query and sum(ores) == 0:
        # the tithe's ore grant is the only ore source in this family
        problems.append("tithe never fired: no action-context RNG draws exercised")
    return problems


def arena_simulation(map_data: List[List[str]], action_seed: int, num_agents: int = 24, device=None, **family):
    """This engine's Simulation of a family on ``map_data`` under the
    reference's MT19937 agent shuffling, its loadouts set, its gates
    checked."""
    from mettagrid_tpu_torch.simulator import Simulation

    sim = Simulation(our_config(map_data, num_agents, **family), seed=action_seed, reference_shuffle=True,
                     device=device)
    check_gates(sim.program, **family)
    for i, inv in loadouts(num_agents, **family).items():
        sim.agent(i).set_inventory(inv)
    return sim


def family_script(sim, action_seed: int, steps: int, **family) -> List[List[str]]:
    """The family's action names [steps][agent] for ``sim``."""
    actions = script_actions(sim.action_names)
    biased = family.get("combat", False) or family.get("pure_attack", False)
    script = action_script(actions, action_seed, steps, sim.num_agents, biased)
    return [[actions[int(a)] for a in row] for row in script]


def _agent_checkpoint(sim, t: int) -> Dict[str, Any]:
    """Env 0's agent positions, inventories and action successes, read in
    one device-to-host copy (this engine's half of the JAX package's
    _agent_state; _ref_checkpoint is the reference's)."""
    from mettagrid_tpu_torch.simulator.stats import host_rows

    A = sim.num_agents
    state = sim.state
    rows = host_rows(
        {"r": state.obj_r, "c": state.obj_c, "inv": state.obj_inv, "ok": sim.last_outputs.action_success}, [0]
    )
    names = sim.resource_names
    return {
        "t": t,
        "pos": [(int(r), int(c)) for r, c in zip(rows["r"][0, :A], rows["c"][0, :A])],
        "inv": [{names[k]: int(q) for k, q in enumerate(row) if q > 0} for row in rows["inv"][0, :A]],
        "success": [bool(x) for x in rows["ok"][0]],
    }


def run_arena_ours(
    map_data: List[List[str]],
    action_seed: int,
    steps: int = 500,
    num_agents: int = 24,
    checkpoint_every: int = 50,
    compare_obs_every: int = 100,
    device=None,
    **family,
) -> Dict[str, Any]:
    """This engine's half of run_arena_parity on ``map_data``, on ``device``
    (CUDA unless the caller names another; without a card it raises unless
    device="cpu"). Returns the checkpoints (positions, inventories, action
    success every ``checkpoint_every`` steps and at the last), the
    observation tokens every ``compare_obs_every`` steps, the final summary
    (cross_engine._summary_ours), the engagement problems, the episode
    signature, the observation route and the seconds the steps took on the
    host's clock."""
    from mettagrid_tpu_torch.parity.cross_engine import _obs_tokens, _summary_ours
    from mettagrid_tpu_torch.parity.signature import episode_signature

    sim = arena_simulation(map_data, action_seed, num_agents, device, **family)
    script = family_script(sim, action_seed, steps, **family)
    checkpoints: List[Dict[str, Any]] = []
    obs: List[Dict[str, Any]] = []
    t0 = time.perf_counter()
    for t, row in enumerate(script):
        for i, name in enumerate(row):
            sim.agent(i).set_action(name)
        sim.step()
        if (t + 1) % checkpoint_every == 0 or t == steps - 1:
            checkpoints.append(_agent_checkpoint(sim, t))
        if (t + 1) % compare_obs_every == 0:
            tokens = sim.last_outputs.observations[0].cpu().numpy()
            obs.append({"t": t, "tokens": [_obs_tokens(tokens[i]) for i in range(num_agents)]})
    seconds = time.perf_counter() - t0
    return {
        "actions": script_actions(sim.action_names),
        "checkpoints": checkpoints,
        "obs": obs,
        "final": _summary_ours(sim),
        "problems": engagement_problems(checkpoints[-1]["inv"], **family) if checkpoints else [],
        "signature": episode_signature(sim.program, sim.state),
        "route": sim._step_fn.obs_fn.route,
        "seconds": seconds,
    }


def _ref_checkpoint(ref, t: int, num_agents: int) -> Dict[str, Any]:
    gos = ref.grid_objects()
    by_agent = {int(o["agent_id"]): o for o in gos.values() if o.get("agent_id") is not None}
    rnames = list(ref.resource_names)
    return {
        "t": t,
        "pos": [(int(by_agent[i]["r"]), int(by_agent[i]["c"])) for i in range(num_agents)],
        "inv": [
            {
                (rnames[int(k)] if str(k).isdigit() else str(k)): int(v)
                for k, v in (by_agent[i].get("inventory", {}) or {}).items()
                if int(v) != 0
            }
            for i in range(num_agents)
        ],
        "success": [bool(x) for x in np.asarray(ref.action_success)],
    }


def _run_arena_ref(ref, script: List[List[str]], num_agents: int, checkpoint_every: int,
                   compare_obs_every: int) -> Dict[str, Any]:
    """The reference's half, on the same script and checkpoints."""
    from mettagrid_tpu_torch.parity.cross_engine import _obs_tokens

    checkpoints, obs = [], []
    steps = len(script)
    for t, row in enumerate(script):
        for i, name in enumerate(row):
            ref.agent(i).set_action(name)
        ref.step()
        if (t + 1) % checkpoint_every == 0 or t == steps - 1:
            checkpoints.append(_ref_checkpoint(ref, t, num_agents))
        if (t + 1) % compare_obs_every == 0:
            tokens = np.asarray(ref._c_sim.observations())
            obs.append({"t": t, "tokens": [_obs_tokens(tokens[i]) for i in range(num_agents)]})
    return {"checkpoints": checkpoints, "obs": obs}


def _diff_checkpoint(ours: Dict[str, Any], ref: Dict[str, Any], t: int, num_agents: int) -> List[str]:
    (op, oi, os_), (rp, ri, rs) = ((c["pos"], c["inv"], c["success"]) for c in (ours, ref))
    problems = []
    if op != rp:
        bad = [i for i in range(num_agents) if op[i] != rp[i]]
        problems.append(f"t={t} pos mismatch agents {bad}: ours={[op[i] for i in bad]} ref={[rp[i] for i in bad]}")
    if oi != ri:
        problems.append(f"t={t} inventory mismatch: ours={oi} ref={ri}")
    if os_ != rs:
        bad = [i for i in range(num_agents) if os_[i] != rs[i]]
        problems.append(f"t={t} action_success mismatch agents {bad}")
    return problems


def _diff_obs(ours: Dict[str, Any], ref: Dict[str, Any]) -> List[str]:
    problems = []
    for i, (ta, tb) in enumerate(zip(ours["tokens"], ref["tokens"])):
        if ta != tb:
            only_a = [x for x in ta if x not in tb][:6]
            only_b = [x for x in tb if x not in ta][:6]
            problems.append(f"t={ours['t']} agent {i} obs mismatch: only_ours={only_a} only_ref={only_b}")
    return problems


def _diff_final(a: Dict[str, Any], b: Dict[str, Any]) -> List[str]:
    """Full end-state signature: objects + rewards + the COMPLETE episode
    stats payload, exactly as the reference signature script hashes it
    (scripts/deterministic_episode_signature.py:40-47 — the key SET and all
    values, game + per-agent), between two summaries
    (cross_engine._summary_ours, _summary_reference)."""
    problems = []
    for key in ("objects", "episode_rewards"):
        if a[key] != b[key]:
            problems.append(f"final {key} mismatch")
    sa, sb = a["stats"], b["stats"]
    if sa["game"] != sb["game"]:
        oa, ob = dict(sa["game"]), dict(sb["game"])
        bad = [k for k in sorted(set(oa) | set(ob)) if oa.get(k) != ob.get(k)]
        problems.append("game stats: " + "; ".join(f"{k}: ours={oa.get(k)} ref={ob.get(k)}" for k in bad[:12]))
    for i, (pa, pb) in enumerate(zip(sa["agent"], sb["agent"])):
        if pa != pb:
            oa, ob = dict(pa), dict(pb)
            bad = [k for k in sorted(set(oa) | set(ob)) if oa.get(k) != ob.get(k)]
            problems.append(
                f"agent {i} stats: " + "; ".join(f"{k}: ours={oa.get(k)} ref={ob.get(k)}" for k in bad[:12])
            )
    return problems


def diff_arena(ours: Dict[str, Any], ref: Dict[str, Any], num_agents: int) -> List[str]:
    """The first divergence of two arena traces (divergence compounds): the
    checkpoints and observations in step order, then the engagement
    problems and the final summaries."""
    events = [(c["t"], 0, c, r) for c, r in zip(ours["checkpoints"], ref["checkpoints"])]
    events += [(o["t"], 1, o, r) for o, r in zip(ours["obs"], ref["obs"])]
    for t, kind, a, b in sorted(events, key=lambda e: e[:2]):
        problems = _diff_checkpoint(a, b, t, num_agents) if kind == 0 else _diff_obs(a, b)
        if problems:
            return problems
    return list(ours["problems"]) + _diff_final(ours["final"], ref["final"])


def run_arena_parity(
    map_seed: int,
    action_seed: int,
    steps: int = 500,
    num_agents: int = 24,
    checkpoint_every: int = 50,
    compare_obs_every: int = 100,
    combat: bool = False,
    events: bool = False,
    economy: bool = False,
    pure_attack: bool = False,
    random_query: bool = False,
    event_filter_rng: bool = False,
    device=None,
) -> List[str]:
    """Run the arena preset in both engines (this one on ``device``); return
    a list of mismatches (needs the oracle).

    combat=True arms every agent (laser/armor/heart) and adds the vibe-gated
    attack move handler, so the episode exercises the general wave-parallel
    action path with real inventory-changing combat at scale. economy=True
    turns 12 walls into usable mines/altars (on_use chains + resource
    filters + inventory deltas through the default UseTarget move handler),
    disqualifying the gated pure-move/static-background specializations —
    a cross-engine oracle over the UN-specialized engine at scale.
    """
    from mettagrid_tpu_torch.parity.cross_engine import _summary_reference
    from mettagrid_tpu_torch.parity.reference_oracle import load_reference

    load_reference()
    family = dict(combat=combat, events=events, economy=economy, pure_attack=pure_attack,
                  random_query=random_query, event_filter_rng=event_filter_rng)
    map_data = build_arena_map(num_agents, map_seed)
    ours = run_arena_ours(map_data, action_seed, steps, num_agents, checkpoint_every, compare_obs_every,
                          device=device, **family)
    ref = _ref_sim(ref_config(map_data, num_agents, **family), seed=action_seed, combat=combat or pure_attack)
    for i, inv in loadouts(num_agents, **family).items():
        ref.agent(i).set_inventory(inv)

    ref_primary = [n for n in ref.action_names if not n.startswith("change_vibe_")]
    ref_vibe = sorted(
        set(list(ref.vibe_action_names) + [n for n in ref.action_names if n.startswith("change_vibe_")])
    )
    if ours["actions"] != ref_primary + ref_vibe:
        return [f"action name tables differ: ours={ours['actions']} ref={ref_primary + ref_vibe}"]
    actions = ours["actions"]  # shared script vocabulary
    script = action_script(actions, action_seed, steps, num_agents, combat or pure_attack)
    names = [[actions[int(a)] for a in row] for row in script]
    ref_trace = _run_arena_ref(ref, names, num_agents, checkpoint_every, compare_obs_every)
    ref_trace["final"] = _summary_reference(ref)
    return diff_arena(ours, ref_trace, num_agents)
