"""Place objects/agents on a regular grid of positions with optional jitter
(reference: mapgen/scenes/grid_altars.py — GridHubs)."""

from __future__ import annotations

import numpy as np

from mettagrid_tpu_torch.mapgen.scene import Scene, SceneConfig


class GridHubsConfig(SceneConfig):
    objects: dict[str, int] = {}
    agents: int | dict[str, int] = 0
    grid_rows: int = 3
    grid_cols: int = 3
    margin: int = 5
    min_spacing: int = 9
    randomize_position: int = 0
    place_agent_center: bool = True


class GridHubs(Scene[GridHubsConfig]):
    """Regular grid of node positions across the area; hubs/objects land on
    the nodes (shuffled), optionally jittered; first agent can take the
    center cell."""

    def render(self) -> None:
        cfg = self.config
        if cfg.min_spacing <= 0:
            raise ValueError(f"min_spacing must be greater than 0, got {cfg.min_spacing}")

        symbols = [name for name, count in cfg.objects.items() for _ in range(count)]
        if isinstance(cfg.agents, int):
            agents = ["agent.agent"] * cfg.agents
        else:
            agents = [f"agent.{group}" for group, n in cfg.agents.items() for _ in range(n)]
        if not symbols and not agents:
            return

        usable_w = self.width - 2 * cfg.margin
        usable_h = self.height - 2 * cfg.margin
        cols = min(cfg.grid_cols, max(1, 1 + usable_w // cfg.min_spacing))
        rows = min(cfg.grid_rows, max(1, 1 + usable_h // cfg.min_spacing))
        x_spacing = usable_w / (cols - 1) if cols > 1 else 0
        y_spacing = usable_h / (rows - 1) if rows > 1 else 0

        positions: list[tuple[int, int]] = []
        for row in range(rows):
            for col in range(cols):
                x = cfg.margin + int(col * x_spacing) if cols > 1 else self.width // 2
                y = cfg.margin + int(row * y_spacing) if rows > 1 else self.height // 2
                if cfg.randomize_position > 0:
                    j = cfg.randomize_position
                    x = int(np.clip(x + self.rng.integers(-j, j + 1), 1, self.width - 2))
                    y = int(np.clip(y + self.rng.integers(-j, j + 1), 1, self.height - 2))
                positions.append((x, y))

        if cfg.place_agent_center and agents:
            cx, cy = self.width // 2, self.height // 2
            if self.grid[cy, cx] == "empty":
                self.grid[cy, cx] = agents[0]
                agents = agents[1:]

        self.rng.shuffle(positions)

        if not cfg.place_agent_center:
            for agent in agents:
                if positions:
                    x, y = positions.pop(0)
                    if self.grid[y, x] == "empty":
                        self.grid[y, x] = agent

        for symbol in symbols:
            if positions:
                x, y = positions.pop(0)
                if self.grid[y, x] == "empty":
                    self.grid[y, x] = symbol
