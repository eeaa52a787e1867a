"""The bench configurations of the reference's bench.py, and the one way each
is stepped and timed on the card (``BenchRun``).

Three variants, as bench.py:29-83 and 96-101 build them:

* ``flagship``: the arena preset with 24 agents and no combat;
* ``combat``: the arena with change_vibe, a vibe-gated DirectAttack move
  handler and agents that start armed (laser 5, armor 1, heart 9); its
  background stays static;
* ``general``: the combat handlers without the starting inventory, plus a
  periodic event that grants hearts to walls, so the background is mutable.

and four that take the observation routes off the v2 fast path:

* ``arena_lp``: the flagship with local-position tokens
  (``global_obs.local_position``, absent on the spawn cell), so the v1 tail
  over the static pool (kernel B4);
* ``arena_values``: the flagship with every resource's amount as a value
  observation in base 10 (``global_obs.obs``: three digit tokens each, absent
  while the amount is too small to need them), 53 global lanes, so B4 with
  its globals past 32 in rounds of their own;
* ``general_lp``: the general config with local-position tokens, so the v1
  tail over a per-env image built from every object (kernel B5);
* ``arena_128``: the flagship on 128x128 maps (border 1, the preset's 10
  walls), whose padded image (144 x 512 words) is too large to stage in
  shared memory, so the v2 tail over a per-env image in device memory
  (kernel B3).

and one that takes the non-fused observation path:

* ``territory``: the flagship on maps with two junctions of each of two
  teams; each junction controls the territory "zone" (whose enter, exit and
  presence handlers change the agents' armor and give hearts) and emits an
  AOE that charges agents of its team, and the observations carry the AOE
  mask, so kernels B7 and B8.

and those of the v3 tails and of the reference-RNG step:

* ``flagship_v3``: the flagship with ``obs_tail="v3"``, so kernel B6a (the
  reference's bench with its v3 tail armed, bench_logs/bench_v3.log);
* ``arena_mood`` and ``arena_mood_v3``: the flagship plus the reference's
  wall_mood event (scripts/verify_tpu_obs.py:57-70: ChangeVibe to angry on
  up to 2 walls every 3 steps), so a mutable background: kernel B2 under
  ``"auto"``, kernel B6b under ``"v3"``;
* ``tithe_rrng``: the reference's "tithe" parity family (parity/arena.py,
  events=True and random_query=True: eight reachable walls become shrines,
  the enrich event gives 3 of them a heart at steps 10, 35, ..., and
  bump-using a shrine pays the actor 1 ore_red when two shrines picked
  by an order_by=random query hold a heart between them) stepped with
  ``reference_rng=True``: the MT19937 twin draws the agent order, the
  event's shuffles and the query's picks, and the action phase is
  sequential.

and the full-combat family:

* ``full_combat``: the reference's own full-combat parity family
  (parity/arena.py, combat=True, its loadouts and script): the combat
  arena with change_vibe and three move handlers, ``shield_break`` (an
  angry actor takes one armor from a shielding target), ``melee`` (an angry
  actor loots one ore_red, then hits with DirectAttack) and ``bump_swap``
  (a clown-vibed actor swaps places with the agent it bumps); agent i
  starts with the loadout {laser: 3 + i % 3, armor: i % 4, heart: 30,
  ore_red: 2 + i % 2}, written into the pooled maps' initial inventories as
  the family writes it on the host, with full_token_bounds on. The
  reachable swap takes the action phase onto the Chebyshev waves; the loot
  makes the background mutable, and full_token_bounds gives 23 token slots
  per cell, so the observations take the non-fused path (kernels B7 and
  B8). Its actions follow the family's script:
  primary actions uniform over noop and the four moves, vibe actions one of
  angry, shield, clown or default four times in ten (else none).

and the one of the query kinds and the position mutations:

* ``network``: the flagship on maps with one hub, six crystals and four
  boxes, assembled from the reference's own tests of these kinds: the
  kick handlers of tests/test_behaviors_extra.py:37-40 as the move handlers
  (moving into a box pushes it and follows it; push_object takes the
  sequential action phase); a materialized tag ``net:hub``, the closure
  from the hub through crystals two cells apart
  (tests/test_behaviors_extra.py:140-176), computed at reset and each tick
  by a game on_tick recompute with prefix ``net``; two per-tick agent
  rewards, the count of crystals tagged ``net:hub`` (a filtered query over
  a query) and the count of objects that rays from the hub meet in four
  directions over a game-value range of 3, walls blocking
  (tests/test_queries.py:207); and the event ``bloom`` every 8 steps,
  which raycast-spawns crystals up to 2 cells from the hub in four
  directions (tests/test_queries.py:107-131). Events and spawns make the
  background mutable, so the observations take B2.

and two on procedural MapGen maps (``mettagrid_tpu_torch.mapgen``):

* ``assembly_lines``: ``make_assembly_lines(24, 1000)``, one agent per 6x6
  perimeter room tiled by MapGen (60x60 maps), two plain mines and two
  plain hubs per room, balanced terrain; a static background, so B1;
* ``bsp_arena``: the flagship game on a 128x128 MapGen BSP dungeon (12
  rooms, 24 agents and 20 walls scattered over it, 138x138 with the
  border): every dungeon wall an object (N 13,635), and an image too large
  to stage, so B3.

Each runs over a pool of maps (random 25x25 maps but for arena_128 and
the MapGen variants) whose seeds come from np.random.default_rng(0).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from mettagrid_tpu_torch.builder import make_arena
from mettagrid_tpu_torch.config.game_value import InventoryValue
from mettagrid_tpu_torch.engine import build_env_init, compile_program, make_reset, make_step
from mettagrid_tpu_torch.maps.random_map import RandomMapBuilder
from mettagrid_tpu_torch.parity.arena import (
    COMBAT_PRIMARY_SHARE,
    COMBAT_VIBES,
    rename_walls,
    apply_family,
    combat_loadout,
)
from mettagrid_tpu_torch.profiling import trace

AGENTS = 24
ENVS = 4096
POOL = 64
WARMUP = 8
VARIANTS = (
    "flagship", "combat", "general", "arena_lp", "arena_values", "general_lp", "arena_128", "territory",
    "flagship_v3", "arena_mood", "arena_mood_v3", "tithe_rrng", "full_combat", "network", "assembly_lines",
    "bsp_arena",
)
# Shrines of the tithe family, renamed from reachable walls of each map.
TITHE_SHRINES = 8


def make_general_cfg(num_agents: int):
    """The combat arena (change_vibe enabled, a vibe-gated DirectAttack move
    handler) plus a periodic event that grants hearts to walls, so neither
    pure_move_ok nor the static background holds (bench.py:29-72)."""
    from mettagrid_tpu_torch.config.action_config import ChangeVibeActionConfig
    from mettagrid_tpu_torch.config.event_config import EventConfig, periodic
    from mettagrid_tpu_torch.config.handler_config import (
        DirectAttackMutation,
        Handler,
        HandlerTarget,
        VibeFilter,
        updateTarget,
    )
    from mettagrid_tpu_torch.config.tag import typeTag

    cfg = make_arena(num_agents, combat=False)
    cfg.game.actions.change_vibe = ChangeVibeActionConfig()
    cfg.game.actions.move.handlers = [
        Handler(
            name="melee",
            filters=[VibeFilter(target=HandlerTarget.ACTOR, vibe="angry")],
            mutations=[DirectAttackMutation(weapon_resource="laser", armor_resource="armor", health_resource="heart")],
        )
    ]
    cfg.game.events = {
        "wall_bloom": EventConfig(
            name="wall_bloom",
            target_query=typeTag("wall"),
            timesteps=periodic(start=4, period=16, end=992),
            max_targets=4,
            mutations=[updateTarget({"heart": 1})],
        )
    }
    return cfg


def make_combat_cfg(num_agents: int):
    """The combat arena without the event, agents armed: DirectAttack keeps
    the static background (mutfields.ACTOR_ONLY) while the moves run the
    handler-chain waves (bench.py:75-83)."""
    cfg = make_general_cfg(num_agents)
    cfg.game.events = {}
    cfg.game.agent.inventory.initial = {"laser": 5, "armor": 1, "heart": 9}
    return cfg


def make_territory_cfg(num_agents: int):
    """The arena with territories and AOE, built from documented options in
    the shape of the reference's territory game (docs/territory.md): agents
    of team cogs on 25x25 maps with two junctions of each of the teams cogs
    and clips. Each junction controls the territory "zone" (default strength
    1024 and decay 256, about four cells) and emits an AOE of radius 2 that
    gives agents of its team a heart each tick and armor while inside.
    Entering owned territory gives armor, leaving takes it back, and each
    tick in territory of the agent's team gives a heart. The observations
    carry the AOE mask."""
    from mettagrid_tpu_torch.config.game_config import GridObjectConfig
    from mettagrid_tpu_torch.config.handler_config import (
        AOEConfig,
        EntityTarget,
        Handler,
        ResourceDeltaMutation,
        SharedTagPrefixFilter,
    )
    from mettagrid_tpu_torch.config.territory_config import TerritoryConfig, TerritoryControlConfig

    def delta(resource, amount):
        return ResourceDeltaMutation(target=EntityTarget.TARGET, deltas={resource: amount})

    same_team = SharedTagPrefixFilter(tag_prefix="team")
    cfg = make_arena(num_agents, combat=False, map_builder=RandomMapBuilder.Config(
        agents=num_agents, width=25, height=25, border_width=1,
        objects={"wall": 10, "junction_cogs": 2, "junction_clips": 2}))
    cfg.game.agent.tags = ["team:cogs"]
    for team in ("cogs", "clips"):
        name = f"junction_{team}"
        cfg.game.objects[name] = GridObjectConfig(
            name=name, map_name=name, tags=[f"team:{team}"],
            territory_controls=[TerritoryControlConfig(territory="zone")],
            aoes={"charge": AOEConfig(name="charge", radius=2, filters=[same_team], mutations=[delta("heart", 1)],
                                      presence_deltas={"armor": 1})},
        )
    cfg.game.territories = {"zone": TerritoryConfig(
        tag_prefix="team",
        on_enter=Handler(name="enter", mutations=[delta("armor", 1)]),
        on_exit=Handler(name="exit", mutations=[delta("armor", -1)]),
        presence=Handler(name="income", filters=[same_team], mutations=[delta("heart", 1)]),
    )}
    cfg.game.obs.aoe_mask = True
    return cfg


def make_mood_cfg(num_agents: int):
    """The flagship plus the wall_mood event (scripts/verify_tpu_obs.py:57-70):
    ChangeVibe to angry on up to 2 walls every 3 steps from step 2."""
    from mettagrid_tpu_torch.config.event_config import EventConfig, periodic
    from mettagrid_tpu_torch.config.handler_config import ChangeVibeMutation
    from mettagrid_tpu_torch.config.tag import typeTag

    cfg = make_arena(num_agents, combat=False)
    cfg.game.events = {
        "wall_mood": EventConfig(
            name="wall_mood",
            target_query=typeTag("wall"),
            timesteps=periodic(start=2, period=3, end=900),
            max_targets=2,
            mutations=[ChangeVibeMutation(vibe_name="angry")],
        )
    }
    return cfg


def make_tithe_cfg(num_agents: int):
    """The tithe family (parity/arena.py with events=True,
    random_query=True) on the flagship arena: shrine objects, whose on_use
    handler pays the actor 1 ore_red when two shrines picked at random
    (order_by=random, max_items=2) hold at least one heart, and the enrich
    event that gives 3 shrines a heart at steps 10, 35, ..., 485. The
    shrines themselves are renamed walls (build_pool)."""
    return apply_family(make_arena(num_agents, combat=False), events=True, random_query=True)


def make_full_combat_cfg(num_agents: int):
    """The full-combat parity family (parity/arena.py with combat=True):
    make_arena with change_vibe and the shield_break, melee and bump_swap
    move handlers, full_token_bounds on because the loadouts are written
    into the maps' initial inventories (full_combat_loadouts) as the family
    sets them on the host."""
    return apply_family(make_arena(num_agents), combat=True)


def make_network_cfg(num_agents: int):
    """The network config (see the module's docstring): hub, crystal and box
    objects on the flagship's 25x25 maps beside its 10 walls."""
    from mettagrid_tpu_torch.config.event_config import EventConfig, periodic
    from mettagrid_tpu_torch.config.game_config import GridObjectConfig
    from mettagrid_tpu_torch.config.game_value import QueryCountValue, val
    from mettagrid_tpu_torch.config.handler_config import (
        Handler,
        HandlerTarget,
        PushObjectMutation,
        RaycastSpawnMutation,
        RecomputeMaterializedQueryMutation,
        RelocateMutation,
        TagFilter,
        TargetLocEmptyFilter,
        isA,
        maxDistance,
    )
    from mettagrid_tpu_torch.config.query import ClosureQuery, Query, RaycastQuery, materializedQuery
    from mettagrid_tpu_torch.config.reward_config import reward
    from mettagrid_tpu_torch.config.tag import typeTag

    four = ["north", "south", "east", "west"]
    cfg = make_arena(num_agents, combat=False, map_builder=RandomMapBuilder.Config(
        agents=num_agents, width=25, height=25, border_width=1,
        objects={"wall": 10, "hub": 1, "crystal": 6, "box": 4}))
    g = cfg.game
    for name in ("hub", "crystal", "box"):
        g.objects[name] = GridObjectConfig(name=name, map_name=name)
    g.actions.move.handlers = [
        Handler(name="kick_box", filters=[isA("box")], mutations=[PushObjectMutation(), RelocateMutation()]),
        Handler(name="move", filters=[TargetLocEmptyFilter()], mutations=[RelocateMutation()]),
    ]
    g.tags = ["net:hub"]
    g.materialize_queries = [materializedQuery("net:hub", ClosureQuery(
        source=typeTag("hub"), candidates=typeTag("crystal"), edge_filters=[maxDistance(2)]))]
    g.on_tick = Handler(name="net", mutations=[RecomputeMaterializedQueryMutation(tag_prefix="net")])
    networked = Query(source=Query(source=typeTag("crystal")).model_dump(),
                      filters=[TagFilter(target=HandlerTarget.TARGET, tag="net:hub")])
    rays = RaycastQuery(source=typeTag("hub"), directions=four, max_range=val(3), blocker=[isA("wall")])
    g.agent.rewards["net"] = reward(QueryCountValue(query=networked.model_dump()), per_tick=True)
    g.agent.rewards["rays"] = reward(QueryCountValue(query=rays.model_dump()), per_tick=True)
    g.events = {"bloom": EventConfig(
        name="bloom", target_query=typeTag("hub"), timesteps=periodic(start=8, period=8, end=g.max_steps),
        mutations=[RaycastSpawnMutation(object_type="crystal", directions=four, max_range=2)])}
    return cfg


def full_combat_loadouts(program, obj_inv: np.ndarray) -> np.ndarray:
    """A copy of the pooled initial inventories int32[P, N, R] in which
    agent i holds the family's loadout (parity/arena.combat_loadout: laser
    3 + i % 3, armor i % 4, heart 30, ore_red 2 + i % 2)."""
    out = np.array(obj_inv, copy=True)
    rid = {n: i for i, n in enumerate(program.resource_names)}
    for i in range(program.num_agents):
        for name, amount in combat_loadout(i).items():
            out[:, i, rid[name]] = amount
    return out


def full_combat_action_ids(program):
    """The full-combat script's primary actions (noop and the four moves) and
    vibe actions (parity/arena.COMBAT_VIBES), as action indices."""
    names = program.action_names
    prim = [i for i, n in enumerate(names) if not n.startswith("change_vibe_")]
    return prim, [names.index(f"change_vibe_{v}") for v in COMBAT_VIBES]


def full_combat_actions(program, generator, shape, device):
    """One step's (primary, vibe) actions of the full-combat script, drawn
    on ``device``: primary uniform over noop and the four moves; vibe one of
    COMBAT_VIBES with probability 1 - COMBAT_PRIMARY_SHARE, else noop (no
    vibe change), as parity/arena.action_script picks them."""
    prim, focus = (torch.tensor(ids, dtype=torch.int32, device=device) for ids in full_combat_action_ids(program))
    acts = prim[torch.randint(0, len(prim), shape, generator=generator, device=device)]
    pick = torch.rand(shape, generator=generator, device=device) < 1 - COMBAT_PRIMARY_SHARE
    vibes = torch.where(pick, focus[torch.randint(0, len(focus), shape, generator=generator, device=device)], 0)
    return acts, vibes


def full_combat_script(program, rng: np.random.Generator, shape):
    """full_combat_actions drawn with numpy (int32 arrays), for runs that
    feed one script to two engines or devices."""
    prim, focus = (np.array(ids) for ids in full_combat_action_ids(program))
    acts = prim[rng.integers(0, len(prim), shape)].astype(np.int32)
    vibes = np.where(rng.random(shape) < 1 - COMBAT_PRIMARY_SHARE, focus[rng.integers(0, len(focus), shape)], 0)
    return acts, vibes.astype(np.int32)


def variant_options(variant: str) -> dict:
    """make_reset's and make_step's options of a variant: its observation
    tail and whether it steps the reference's RNG."""
    return dict(obs_tail="v3" if variant.endswith("_v3") else "auto", reference_rng=variant.endswith("_rrng"))


def make_assembly_lines_cfg(num_agents: int):
    """make_assembly_lines: one agent per 6x6 perimeter room, tiled by MapGen,
    with two plain object kinds, two of each per room, and balanced terrain."""
    from mettagrid_tpu_torch.builder import make_assembly_lines
    from mettagrid_tpu_torch.config.game_config import GridObjectConfig

    objects = {"mine": GridObjectConfig(name="mine"), "hub": GridObjectConfig(name="hub")}
    return make_assembly_lines(num_agents, 1000, objects, {"mine": 2, "hub": 2}, terrain="balanced")


def make_bsp_arena_cfg(num_agents: int):
    """The flagship game on a procedural dungeon: a 128x128 MapGen BSP map of
    12 rooms, the agents and 20 loose walls scattered over it."""
    from mettagrid_tpu_torch.mapgen import ChildrenAction, MapGen
    from mettagrid_tpu_torch.mapgen.scenes import BSP, Random

    cfg = make_arena(num_agents, combat=False)
    cfg.game.map_builder = MapGen.Config(
        width=128, height=128, border_width=5,
        instance=BSP.Config(rooms=12, min_room_size=4, min_room_size_ratio=0.4, max_room_size_ratio=0.8,
                            children=[ChildrenAction(scene=Random.Config(agents=num_agents, objects={"wall": 20}),
                                                     where="full")]))
    return cfg


def make_cfg(variant: str, num_agents: int = AGENTS):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of {VARIANTS}")
    if variant.startswith("arena_mood"):
        return make_mood_cfg(num_agents)
    if variant == "tithe_rrng":
        return make_tithe_cfg(num_agents)
    if variant == "combat":
        return make_combat_cfg(num_agents)
    if variant == "full_combat":
        return make_full_combat_cfg(num_agents)
    if variant == "territory":
        return make_territory_cfg(num_agents)
    if variant == "network":
        return make_network_cfg(num_agents)
    if variant == "assembly_lines":
        return make_assembly_lines_cfg(num_agents)
    if variant == "bsp_arena":
        return make_bsp_arena_cfg(num_agents)
    if variant.startswith("general"):
        cfg = make_general_cfg(num_agents)
    elif variant == "arena_128":
        cfg = make_arena(num_agents, combat=False, map_builder=RandomMapBuilder.Config(
            agents=num_agents, width=128, height=128, border_width=1, objects={"wall": 10}))
    else:
        cfg = make_arena(num_agents, combat=False)
    cfg.game.obs.global_obs.local_position = variant.endswith("_lp")
    if variant == "arena_values":
        cfg.game.obs.global_obs.obs = {f"v_{r}": InventoryValue(item=r) for r in cfg.game.resource_names}
        cfg.game.obs.token_value_base = 10
    return cfg


def build_pool(cfg, pool: int, max_steps: int | None = None, loadouts: bool = False):
    """(program, init) of ``cfg`` with ``pool`` maps from its map builder,
    seeded from np.random.default_rng(0) as bench.py:103-108 seeds them. A
    config with shrine objects gets TITHE_SHRINES of each map's walls
    renamed to shrines (parity/arena.rename_walls); ``loadouts`` writes the
    full-combat loadouts into the maps' initial inventories
    (full_combat_loadouts)."""
    if max_steps is not None:
        cfg.game.max_steps = max_steps
    program = compile_program(cfg)
    builder = cfg.game.map_builder.create()
    rng = np.random.default_rng(0)
    maps = []
    for _ in range(pool):
        builder.config.seed = int(rng.integers(0, 2**31 - 1))
        game_map = builder.build_for_num_agents(program.num_agents)
        if "shrine" in cfg.game.objects:
            game_map.grid = rename_walls(game_map.grid, ["shrine"] * TITHE_SHRINES, reachable=True)
        maps.append(game_map)
    init = build_env_init(program, maps)
    if loadouts:
        init.obj_inv = full_combat_loadouts(program, init.obj_inv)
    return program, init


class BenchRun:
    """One variant's main path: ``envs`` envs (ENVS by default) x AGENTS
    agents, ``pool`` maps (POOL), auto-reset on, the observation buffer
    carried from step to step, on the CUDA device unless ``device`` says
    otherwise. Primary actions are uniform over the action space; for the
    combat and general configs the vibe actions are too (bench.py:190-200),
    for the arena ones they are 0; full_combat follows its family's script
    (full_combat_actions). All draws, the agent orders and the event ranks
    come from one generator on the device seeded with ``seed``; under the
    reference-RNG step (tithe_rrng) the MT19937 twin draws the agent orders,
    the events' shuffles and the query picks instead."""

    def __init__(self, variant: str, seed: int, envs: int = ENVS, device: str = "cuda", pool: int = POOL):
        self.variant, self.envs, self.device = variant, envs, device
        self.program, init = build_pool(make_cfg(variant), pool, loadouts=variant == "full_combat")
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(seed)
        opts = variant_options(variant)
        self.reset = make_reset(self.program, init, envs, device=device, **opts)
        self.step = make_step(self.program, init, auto_reset=True, generator=self.generator, device=device, **opts)
        self._n_actions = len(self.program.action_names)
        self._vibes = variant in ("combat", "general", "general_lp")
        self.last_actions = None
        self.waves = []

    def _draw(self):
        return torch.randint(0, self._n_actions, (self.envs, AGENTS), generator=self.generator, device=self.device,
                             dtype=torch.int32)

    def run(self, state, out, n: int):
        """n steps from (state, out); returns the last (state, out). The last
        step's primary actions are kept in ``last_actions``, and each step's
        wave count (the counter ``actions.waves`` of profiling/trace.py,
        which counts untraced steps after a step's first: 0 for the others)
        is appended to ``waves``."""
        for _ in range(n):
            if self.variant == "full_combat":
                acts, vibes = full_combat_actions(self.program, self.generator, (self.envs, AGENTS), self.device)
            else:
                acts = self._draw()
                vibes = self._draw() if self._vibes else torch.zeros_like(acts)
            waves = trace.counted("actions.waves")
            state, out = self.step(state, acts, vibes, None, out.observations)
            self.waves.append(trace.counted("actions.waves") - waves)
            self.last_actions = acts
        return state, out

    def _sync(self):
        if self.device != "cpu":
            torch.cuda.synchronize()

    def timed(self, state, out, n: int):
        """n steps, timed by the host clock between two device syncs; returns
        (state, out, seconds)."""
        self._sync()
        t0 = time.perf_counter()
        state, out = self.run(state, out, n)
        self._sync()
        return state, out, time.perf_counter() - t0

    def warmed_up(self):
        """(state, out) after a reset and WARMUP steps."""
        state, out = self.reset(0)
        return self.run(state, out, WARMUP)


def main(argv=None) -> dict:
    """Steps a variant after the warm-up and prints one JSON object: the
    host-clock ms per step, env-steps/s and the wave phase's waves per step
    (mean and largest) over the timed steps.

        python -m mettagrid_tpu_torch.tools.bench_run --variant full_combat [--envs E] [--pool P] [--steps N] [--device cpu]
    """
    import argparse
    import json

    ap = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    ap.add_argument("--variant", choices=VARIANTS, default="flagship")
    ap.add_argument("--envs", type=int, default=ENVS)
    ap.add_argument("--pool", type=int, default=POOL)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = BenchRun(args.variant, seed=7, envs=args.envs, device=args.device, pool=args.pool)
    state, out = bench.warmed_up()
    state, out, secs = bench.timed(state, out, args.steps)
    waves = bench.waves[-args.steps:]
    report = {
        "variant": args.variant, "device": args.device, "envs": args.envs, "agents": AGENTS, "pool": args.pool,
        "steps": args.steps, "action_phase": bench.step.action_phase_kind, "obs_route": bench.step.obs_fn.route,
        "step_ms_host_clock": secs / args.steps * 1e3, "env_steps_per_s": args.envs * args.steps / secs,
        "waves_per_step_mean": sum(waves) / len(waves), "waves_per_step_max": max(waves),
    }
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
