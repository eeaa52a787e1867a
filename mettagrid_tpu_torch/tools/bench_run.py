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
* ``tithe_rrng``: the reference's "tithe" parity family
  (mettagrid_tpu/parity/arena.py:111-282: eight reachable walls become
  shrines, the enrich event gives 3 of them a heart at steps 10, 35, ...,
  and bump-using a shrine pays the actor 1 ore_red when two shrines picked
  by an order_by=random query hold a heart between them) stepped with
  ``reference_rng=True``: the MT19937 twin draws the agent order, the
  event's shuffles and the query's picks, and the action phase is
  sequential.

Each runs over a pool of random maps (25x25 but for arena_128) whose seeds
come from np.random.default_rng(0).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from mettagrid_tpu_torch.builder import make_arena
from mettagrid_tpu_torch.config.game_value import InventoryValue
from mettagrid_tpu_torch.engine import build_env_init, compile_program, make_reset, make_step
from mettagrid_tpu_torch.maps.random_map import RandomMapBuilder

AGENTS = 24
ENVS = 4096
POOL = 64
WARMUP = 8
VARIANTS = (
    "flagship", "combat", "general", "arena_lp", "arena_values", "general_lp", "arena_128", "territory",
    "flagship_v3", "arena_mood", "arena_mood_v3", "tithe_rrng",
)
# Shrines of the tithe family, renamed from reachable walls of each map.
TITHE_SHRINES = 8


def make_general_cfg(num_agents: int):
    """The combat arena (change_vibe enabled, a vibe-gated DirectAttack move
    handler) plus a periodic event that grants hearts to walls, so neither
    pure_move_ok nor static_background_ok holds (bench.py:29-72)."""
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
    the static background (obs.background_inert) while the moves run the
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
    """The tithe family (mettagrid_tpu/parity/arena.py:111-282 with
    events=True, random_query=True): shrine objects, whose on_use handler
    pays the actor 1 ore_red when two shrines picked at random
    (order_by=random, max_items=2) hold at least one heart, and the enrich
    event that gives 3 shrines a heart at steps 10, 35, ..., 485. The
    shrines themselves are renamed walls (build_pool)."""
    from mettagrid_tpu_torch.config.event_config import EventConfig
    from mettagrid_tpu_torch.config.game_config import GridObjectConfig
    from mettagrid_tpu_torch.config.game_value import QueryInventoryValue
    from mettagrid_tpu_torch.config.handler_config import (
        EntityTarget,
        GameValueFilter,
        Handler,
        HandlerTarget,
        ResourceDeltaMutation,
        updateTarget,
    )
    from mettagrid_tpu_torch.config.query import Query
    from mettagrid_tpu_torch.config.tag import typeTag

    cfg = make_arena(num_agents, combat=False)
    cfg.game.objects["shrine"] = GridObjectConfig(
        name="shrine", map_name="shrine",
        on_use_handler=Handler(
            name="tithe",
            filters=[GameValueFilter(
                target=HandlerTarget.ACTOR,
                value=QueryInventoryValue(
                    query=Query(source=typeTag("shrine"), order_by="random", max_items=2).model_dump(),
                    item="heart",
                ),
                min=1,
            )],
            mutations=[ResourceDeltaMutation(target=EntityTarget.ACTOR, deltas={"ore_red": 1})],
        ),
    )
    cfg.game.events = {
        "enrich": EventConfig(
            name="enrich", target_query=typeTag("shrine"), timesteps=list(range(10, 501, 25)), max_targets=3,
            mutations=[updateTarget({"heart": 1})],
        )
    }
    return cfg


def rename_walls(grid, names):
    """A copy of map grid ``grid`` whose interior walls with an empty
    orthogonal neighbour (those agents can bump), taken in raster order at a
    stride that spreads them over the map, are renamed to ``names``
    (mettagrid_tpu/parity/arena.py:39-66, reachable=True)."""
    out = np.array(grid, copy=True)
    H, W = out.shape
    cands = [
        (r, c) for r in range(1, H - 1) for c in range(1, W - 1)
        if out[r, c] == "wall" and any(out[r + dr, c + dc] == "empty" for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)))
    ]
    if len(cands) < len(names):
        raise ValueError(f"only {len(cands)} reachable walls for {len(names)} names")
    stride = max(1, len(cands) // len(names))
    for i, name in enumerate(names):
        out[cands[i * stride]] = name
    return out


def variant_options(variant: str) -> dict:
    """make_reset's and make_step's options of a variant: its observation
    tail and whether it steps the reference's RNG."""
    return dict(obs_tail="v3" if variant.endswith("_v3") else "auto", reference_rng=variant.endswith("_rrng"))


def make_cfg(variant: str, num_agents: int = AGENTS):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of {VARIANTS}")
    if variant.startswith("arena_mood"):
        return make_mood_cfg(num_agents)
    if variant == "tithe_rrng":
        return make_tithe_cfg(num_agents)
    if variant == "combat":
        return make_combat_cfg(num_agents)
    if variant == "territory":
        return make_territory_cfg(num_agents)
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


def build_pool(cfg, pool: int, max_steps: int | None = None):
    """(program, init) of ``cfg`` with ``pool`` maps from its map builder,
    seeded from np.random.default_rng(0) as bench.py:103-108 seeds them. A
    config with shrine objects gets TITHE_SHRINES of each map's walls
    renamed to shrines (rename_walls)."""
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
            game_map.grid = rename_walls(game_map.grid, ["shrine"] * TITHE_SHRINES)
        maps.append(game_map)
    return program, build_env_init(program, maps)


class BenchRun:
    """One variant's main path on the CUDA device: ENVS envs x AGENTS agents,
    POOL maps, auto-reset on, the observation buffer carried from step to
    step. Primary actions are uniform over the action space; for the combat
    and general configs the vibe actions are too (bench.py:190-200), for the
    arena ones they are 0. All draws, the agent orders and the event ranks
    come from one CUDA generator seeded with ``seed``; under the
    reference-RNG step (tithe_rrng) the MT19937 twin draws the agent orders,
    the events' shuffles and the query picks instead."""

    def __init__(self, variant: str, seed: int):
        self.variant = variant
        self.program, init = build_pool(make_cfg(variant), POOL)
        self.generator = torch.Generator(device="cuda")
        self.generator.manual_seed(seed)
        opts = variant_options(variant)
        self.reset = make_reset(self.program, init, ENVS, **opts)
        self.step = make_step(self.program, init, auto_reset=True, generator=self.generator, **opts)
        self._n_actions = len(self.program.action_names)
        self._vibes = variant in ("combat", "general", "general_lp")
        self.last_actions = None

    def _draw(self):
        return torch.randint(
            0, self._n_actions, (ENVS, AGENTS), generator=self.generator, device="cuda", dtype=torch.int32
        )

    def run(self, state, out, n: int):
        """n steps from (state, out); returns the last (state, out). The last
        step's primary actions are kept in ``last_actions``."""
        for _ in range(n):
            acts = self._draw()
            vibes = self._draw() if self._vibes else torch.zeros_like(acts)
            state, out = self.step(state, acts, vibes, None, out.observations)
            self.last_actions = acts
        return state, out

    def timed(self, state, out, n: int):
        """n steps, timed by the host clock between two device syncs; returns
        (state, out, seconds)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = self.run(state, out, n)
        torch.cuda.synchronize()
        return state, out, time.perf_counter() - t0

    def warmed_up(self):
        """(state, out) after a reset and WARMUP steps."""
        state, out = self.reset(0)
        return self.run(state, out, WARMUP)
