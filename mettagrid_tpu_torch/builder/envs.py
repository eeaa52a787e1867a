"""Canonical environment presets (reference: python/src/mettagrid/builder/envs.py:28-111).

These are the configs the benchmarks and demos run; they double as living
documentation of the config surface.
"""

from __future__ import annotations

from typing import Optional

from mettagrid_tpu_torch.config.action_config import (
    ActionsConfig,
    AttackActionConfig,
    ChangeVibeActionConfig,
    MoveActionConfig,
    NoopActionConfig,
)
from mettagrid_tpu_torch.config.game_config import (
    AgentConfig,
    GameConfig,
    InventoryConfig,
    MettaGridConfig,
    ResourceLimitsConfig,
    WallConfig,
)
from mettagrid_tpu_torch.config.game_value import InventoryValue
from mettagrid_tpu_torch.config.reward_config import reward
from mettagrid_tpu_torch.maps.map_builder import MapBuilderConfig
from mettagrid_tpu_torch.maps.random_map import RandomMapBuilder


def make_arena(
    num_agents: int,
    combat: bool = True,
    map_builder: Optional[MapBuilderConfig] = None,
) -> MettaGridConfig:
    """The arena preset: walls + heart rewards, optional laser/armor combat
    (reference: builder/envs.py:28-86)."""
    actions = ActionsConfig(
        noop=NoopActionConfig(),
        move=MoveActionConfig(),
        attack=AttackActionConfig(
            consumed_resources={"laser": 1},
            defense_resources={"armor": 1},
        ),
        change_vibe=ChangeVibeActionConfig(enabled=False),
    )
    if not combat:
        actions.attack.consumed_resources = {"laser": 100}

    if map_builder is None:
        map_builder = RandomMapBuilder.Config(
            agents=num_agents,
            width=25,
            height=25,
            border_width=1,
            objects={"wall": 10},
        )

    return MettaGridConfig(
        label="arena" + (".combat" if combat else ""),
        game=GameConfig(
            num_agents=num_agents,
            actions=actions,
            objects={"wall": WallConfig()},
            agent=AgentConfig(
                inventory=InventoryConfig(
                    default_limit=50,
                    limits={"heart": ResourceLimitsConfig(base=255, resources=["heart"])},
                ),
                rewards={"heart": reward(InventoryValue(item="heart"))},
            ),
            map_builder=map_builder,
        ),
    )


def make_navigation(num_agents: int) -> MettaGridConfig:
    """Navigation preset: walls + heart rewards, move/noop only
    (reference: builder/envs.py:89-108)."""
    return MettaGridConfig(
        label="navigation",
        game=GameConfig(
            num_agents=num_agents,
            objects={"wall": WallConfig()},
            resource_names=["heart"],
            actions=ActionsConfig(
                move=MoveActionConfig(enabled=True),
                noop=NoopActionConfig(enabled=True),
                change_vibe=ChangeVibeActionConfig(enabled=False),
            ),
            agent=AgentConfig(
                rewards={"heart": reward(InventoryValue(item="heart"))},
            ),
            map_builder=RandomMapBuilder.Config(agents=num_agents, width=20, height=20, border_width=1),
        ),
    )


def make_assembly_lines(
    num_agents: int,
    max_steps: int,
    game_objects: dict,
    map_builder_objects: dict,
    width: int = 6,
    height: int = 6,
    terrain: str = "no-terrain",
    chain_length: int = 2,
    num_sinks: int = 0,
    dir: Optional[str] = None,
) -> MettaGridConfig:
    """Assembly-lines preset: one agent per perimeter-in-context mini-room,
    tiled via MapGen instances (reference: builder/envs.py:111-161)."""
    from mettagrid_tpu_torch.mapgen.mapgen import MapGen
    from mettagrid_tpu_torch.maps.perimeter_incontext import PerimeterInContextMapBuilder

    objects = dict(game_objects)
    objects.setdefault("wall", WallConfig())
    return MettaGridConfig(
        label="assembly_lines",
        desync_episodes=False,
        game=GameConfig(
            max_steps=max_steps,
            num_agents=num_agents,
            objects=objects,
            map_builder=MapGen.Config(
                instances=num_agents,
                instance=PerimeterInContextMapBuilder.Config(
                    agents=1,
                    width=width,
                    height=height,
                    objects=map_builder_objects,
                    density=terrain,
                    chain_length=chain_length,
                    num_sinks=num_sinks,
                    dir=dir,
                ),
            ),
            actions=ActionsConfig(
                noop=NoopActionConfig(),
                move=MoveActionConfig(),
                change_vibe=ChangeVibeActionConfig(enabled=False),
            ),
            agent=AgentConfig(
                rewards={"heart": reward(InventoryValue(item="heart"))},
                inventory=InventoryConfig(
                    default_limit=1,
                    limits={"heart": ResourceLimitsConfig(base=15, resources=["heart"])},
                ),
            ),
        ),
    )
