"""Episode stats sink interface (reference: mettagrid_tpu/util/stats_writer.py)."""

from __future__ import annotations

import datetime
import json
import os
import tempfile
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Dict, Optional


class StatsWriter(ABC):
    """Abstract sink for episode statistics; usable by multiple envs."""

    def __init__(self, dir: Path) -> None:
        self.dir = dir

    @abstractmethod
    def record_episode(
        self,
        attributes: Dict[str, str],
        agent_metrics: Dict[int, Dict[str, float]],
        agent_groups: Dict[int, int],
        step_count: int,
        replay_url: Optional[str],
        created_at: datetime.datetime,
    ) -> int: ...

    @abstractmethod
    def close(self) -> None: ...


class NoopStatsWriter(StatsWriter):
    def __init__(self, dir: Optional[Path] = None):
        super().__init__(dir or Path(tempfile.gettempdir()))

    def record_episode(self, attributes, agent_metrics, agent_groups, step_count, replay_url, created_at) -> int:
        return 0

    def close(self) -> None:
        pass


class JsonlStatsWriter(StatsWriter):
    """Appends one JSON line per episode (a simple durable local sink)."""

    def __init__(self, dir: Path):
        super().__init__(Path(dir))
        os.makedirs(self.dir, exist_ok=True)
        self._path = self.dir / "episodes.jsonl"
        self._count = 0

    def record_episode(self, attributes, agent_metrics, agent_groups, step_count, replay_url, created_at) -> int:
        episode_id = self._count
        self._count += 1
        with open(self._path, "a") as f:
            f.write(
                json.dumps(
                    {
                        "episode_id": episode_id,
                        "attributes": attributes,
                        "agent_metrics": {str(k): v for k, v in agent_metrics.items()},
                        "agent_groups": {str(k): v for k, v in agent_groups.items()},
                        "step_count": step_count,
                        "replay_url": replay_url,
                        "created_at": created_at.isoformat(),
                    }
                )
                + "\n"
            )
        return episode_id

    def close(self) -> None:
        pass


class StatsWriterHandler:
    """SimulatorEventHandler bridging episodes to a StatsWriter
    (reference: envs/stats_tracker.py:10-144)."""

    def __init__(self, writer: StatsWriter):
        from mettagrid_tpu_torch.simulator.interface import SimulatorEventHandler

        self._writer = writer
        outer = self

        class _Handler(SimulatorEventHandler):
            def on_episode_end(self) -> None:
                sim = self._simulation
                stats = sim.episode_stats
                groups = sim.state.agent_group[0].tolist()
                outer._writer.record_episode(
                    attributes={"label": sim.config.label},
                    agent_metrics={i: m for i, m in enumerate(stats["agent"])},
                    agent_groups={i: int(g) for i, g in enumerate(groups)},
                    step_count=sim.current_step,
                    replay_url=sim._context.get("replay_url"),
                    created_at=datetime.datetime.now(datetime.timezone.utc),
                )

        self.handler = _Handler()
