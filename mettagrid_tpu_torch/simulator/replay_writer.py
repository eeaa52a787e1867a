"""Episode replay writers — format v4, mettascope-compatible
(reference: mettagrid_tpu/simulator/replay_writer.py). The state is read
through the Simulation, whose reads are explicit device-to-host copies.

Per-object timelines are seq-key merged: a field becomes
[[step, value], ...] with entries only when the value changes.
"""

from __future__ import annotations

import gzip
import json
import uuid
import zlib
from typing import Any, Dict, List, Optional

import numpy as np

from mettagrid_tpu_torch.simulator.interface import SimulatorEventHandler

REPLAY_FORMAT_VERSION = 4
STATIC_OBJECT_TYPES = frozenset({"wall"})


class EpisodeReplay:
    """Replay data for one episode of one env (env 0 of the batch)."""

    def __init__(self, sim):
        self.sim = sim
        self.step = 0
        self.objects: list[dict[str, Any]] = []
        self.total_rewards = np.zeros(sim.num_agents)
        self._object_id_to_index: dict[int, int] = {}
        self.set_compression("zlib")

        id_map = sim.config.game.id_map()
        agent_cfg = sim.config.game.agents[0] if sim.config.game.agents else sim.config.game.agent
        self._capacity_names: List[str] = sorted(agent_cfg.inventory.limits.keys())

        self.replay_data = {
            "version": REPLAY_FORMAT_VERSION,
            "action_names": sim.action_names,
            "animation_names": ["none", "bump"],
            "item_names": sim.resource_names,
            "type_names": sim.object_type_names,
            "capacity_names": self._capacity_names,
            "tags": {name: idx for idx, name in enumerate(id_map.tag_names())},
            "map_size": [sim.map_width, sim.map_height],
            "num_agents": sim.num_agents,
            "max_steps": sim.config.game.max_steps,
            "mg_config": sim.config.model_dump(mode="json"),
            "policy_env_interface": self._policy_env_interface(sim),
            "objects": self.objects,
            "infos": {},
        }

    @staticmethod
    def _policy_env_interface(sim) -> Dict[str, Any]:
        """Replay consumers parse observations with this
        (reference: replay_log_writer.py:112,148)."""
        from mettagrid_tpu_torch.policy.policy_env_interface import PolicyEnvInterface

        return PolicyEnvInterface.from_config(sim.config).model_dump(mode="json")

    def set_compression(self, compression: str) -> None:
        if compression == "zlib":
            self._compress = zlib.compress
        elif compression == "gzip":
            self._compress = gzip.compress
        else:
            raise ValueError(f"unknown compression {compression!r}")

    def log_step(self, current_step: int, actions: np.ndarray, rewards: np.ndarray) -> None:
        self.total_rewards += rewards
        grid_objects = self.sim.grid_objects()
        seen: set[int] = set()

        for obj_id, obj in grid_objects.items():
            idx = self._object_id_to_index.get(obj_id)
            if idx is None:
                idx = len(self.objects)
                self._object_id_to_index[obj_id] = idx
                self.objects.append({} if self.step == 0 else {"alive": [[0, False]]})
            elif self.step > 0 and obj["type_name"] in STATIC_OBJECT_TYPES:
                seen.add(idx)
                continue
            seen.add(idx)

            update = self._format_object(obj, actions, rewards)
            self._seq_key_merge(self.objects[idx], self.step, update)

        if self.step > 0:
            for idx in self._object_id_to_index.values():
                if idx in seen:
                    continue
                obj_data = self.objects[idx]
                alive = obj_data.get("alive")
                if alive and isinstance(alive[-1], (list, tuple)) and alive[-1][1] is not False:
                    obj_data["alive"].append([self.step, False])

        self.step += 1
        if current_step != self.step:
            raise ValueError(
                f"Writing multiple steps at once: step {current_step} != replay step {self.step}."
            )

    def _format_object(self, obj: dict, actions: np.ndarray, rewards: np.ndarray) -> dict:
        # Field names and value shapes mirror the reference formatter
        # (util/grid_object_formatter.py:8-65) so v4 consumers see the same
        # per-object timelines.
        update: dict[str, Any] = {
            "id": obj["id"],
            "alive": True,
            "type_name": obj["type_name"],
            "location": [obj["c"], obj["r"]],  # (x, y) order — the reference emits (col, row)
            "orientation": 0,
            "inventory": sorted(
                (self.sim.resource_names.index(k), v) for k, v in obj["inventory"].items()
            ),
            "inventory_max": obj.get("inventory_max", 0),
            "color": 0,
            "vibe": obj["vibe"],
            "tag_ids": sorted(
                self.replay_data["tags"][t] for t in obj["tags"] if t in self.replay_data["tags"]
            ),
        }
        agent_id = obj.get("agent_id")
        if agent_id is not None:
            update.update(
                {
                    "is_agent": True,
                    "agent_id": agent_id,
                    "vision_size": self.sim.config.game.obs.width,
                    "group_id": obj.get("group", 0),
                    "action_id": int(actions[agent_id]) if len(actions) > agent_id else 0,
                    "action_param": 0,
                    "action_success": bool(self.sim.action_success[agent_id]),
                    "animation_id": 0,
                    "current_reward": float(rewards[agent_id]),
                    "total_reward": float(self.total_rewards[agent_id]),
                    "vibe_id": obj["vibe"],
                    "monologue_append": "",
                    "monologue_reset": False,
                }
            )
        return update

    @staticmethod
    def _default_for(value):
        if isinstance(value, list):
            return []
        if isinstance(value, bool):
            return False
        if isinstance(value, int):
            return 0
        if isinstance(value, float):
            return 0.0
        if isinstance(value, str):
            return ""
        raise ValueError(f"Unknown value type: {type(value)}")

    def _seq_key_merge(self, grid_object: dict, step: int, update: dict) -> None:
        """Append [step, value] entries only when the value changed
        (reference: replay_log_writer.py _seq_key_merge)."""
        for key, value in update.items():
            if key not in grid_object:
                if step == 0:
                    grid_object[key] = [[0, value]]
                else:
                    grid_object[key] = [[0, self._default_for(value)], [step, value]]
            else:
                entries = grid_object[key]
                if entries[-1][1] != value:
                    entries.append([step, value])

    def finalize(self) -> dict:
        """Collapse single-entry timelines to bare values (reference does the
        same compaction on write)."""
        for obj in self.objects:
            for key, entries in list(obj.items()):
                if isinstance(entries, list) and len(entries) == 1 and entries[0][0] == 0:
                    obj[key] = entries[0][1]
        self.replay_data["max_steps"] = self.step
        return self.replay_data

    def write_replay(self, path: str) -> None:
        data = json.dumps(self.finalize()).encode("utf-8")
        with open(path, "wb") as f:
            f.write(self._compress(data))


class InMemoryReplayWriter(SimulatorEventHandler):
    """Keeps completed replays in memory
    (reference: replay_log_writer.py:22-45)."""

    def __init__(self):
        super().__init__()
        self._episode_replay: Optional[EpisodeReplay] = None
        self._completed: list[EpisodeReplay] = []

    def on_episode_start(self) -> None:
        self._episode_replay = EpisodeReplay(self._simulation)

    def on_step(self) -> None:
        sim = self._simulation
        actions = sim.state.agent_last_action[0].cpu().numpy()  # executed actions
        rewards = sim.last_outputs.rewards[0].cpu().numpy()
        self._episode_replay.log_step(sim.current_step, actions, rewards)

    def on_episode_end(self) -> None:
        if self._episode_replay is not None:
            self._completed.append(self._episode_replay)

    def get_completed_replays(self) -> list[EpisodeReplay]:
        return self._completed


class ReplayLogWriter(InMemoryReplayWriter):
    """Writes replay files to a directory
    (reference: replay_log_writer.py:48-92)."""

    def __init__(self, replay_dir: str):
        super().__init__()
        self._replay_dir = replay_dir
        self._episode_id: Optional[str] = None
        self._paths: list[str] = []

    def on_episode_start(self) -> None:
        self._episode_id = str(uuid.uuid4())
        super().on_episode_start()

    def on_episode_end(self) -> None:
        super().on_episode_end()
        path = f"{self._replay_dir}/{self._episode_id}.json.z"
        self._episode_replay.write_replay(path)
        self._paths.append(path)

    def get_written_replay_paths(self) -> List[str]:
        return list(self._paths)
