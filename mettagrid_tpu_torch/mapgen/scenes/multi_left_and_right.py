"""Grid of left-or-right rooms with asymmetric hub placement
(reference: mapgen/scenes/multi_left_and_right.py).

Agents are split between two teams (half the rooms each); hubs are placed
asymmetrically with a configurable ratio, and which side gets more hubs is
random per episode. Rooms are otherwise identical (shared child seeds).
"""

from __future__ import annotations

from mettagrid_tpu_torch.mapgen.area import AreaWhere
from mettagrid_tpu_torch.mapgen.scene import ChildrenAction, Scene, SceneConfig
from mettagrid_tpu_torch.mapgen.scenes.random import Random
from mettagrid_tpu_torch.mapgen.scenes.room_grid import RoomGrid


class MultiLeftAndRightConfig(SceneConfig):
    rows: int
    columns: int
    hub_ratio: float
    total_hubs: int


class MultiLeftAndRight(Scene[MultiLeftAndRightConfig]):
    def get_children(self) -> list[ChildrenAction]:
        cfg = self.config
        # Pregenerated seeds make all rooms deterministic/identical.
        agent_seed = int(self.rng.integers(0, int(1e9)))
        hub_seed = int(self.rng.integers(0, int(1e9)))

        more_hubs = int(cfg.total_hubs * cfg.hub_ratio)
        less_hubs = cfg.total_hubs - more_hubs
        left_hubs = more_hubs if self.rng.random() < 0.5 else less_hubs
        right_hubs = cfg.total_hubs - left_hubs

        agent_groups = ["team_1", "team_2"]

        per_team_limit = cfg.rows * cfg.columns // len(agent_groups)
        room_children = []
        for group in agent_groups:
            room_scene = RoomGrid.Config(
                border_width=0,
                layout=[
                    ["maybe_hubs_left", "empty", "empty", "agents", "empty", "empty", "maybe_hubs_right"],
                ],
                children=[
                    ChildrenAction(
                        scene=Random.Config(agents={group: 1}, seed=agent_seed),
                        where=AreaWhere(tags=["agents"]),
                    ),
                    ChildrenAction(
                        scene=Random.Config(objects={"hub": left_hubs}, seed=hub_seed),
                        where=AreaWhere(tags=["maybe_hubs_left"]),
                    ),
                    ChildrenAction(
                        scene=Random.Config(objects={"hub": right_hubs}, seed=hub_seed + 1),
                        where=AreaWhere(tags=["maybe_hubs_right"]),
                    ),
                ],
            )
            room_children.append(
                ChildrenAction(scene=room_scene, lock="rooms", limit=per_team_limit)
            )

        return [
            ChildrenAction(
                where="full",
                scene=RoomGrid.Config(
                    rows=cfg.rows,
                    columns=cfg.columns,
                    border_width=6,
                    children=room_children,
                ),
            )
        ]

    def render(self) -> None:
        pass
