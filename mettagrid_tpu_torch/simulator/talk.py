"""Agent talk channel (reference: simulator/talk.py:9-120).

Host-side chat overlay: queue -> apply at step end -> expire; messages are
visible only to agents whose observation window covers the speaker."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from mettagrid_tpu_torch.config.game_config import TalkConfig
from mettagrid_tpu_torch.simulator.interface import Location


@dataclass(frozen=True)
class TalkState:
    text: str
    remaining_steps: int


@dataclass(frozen=True)
class VisibleTalk:
    agent_id: int
    text: str
    remaining_steps: int


@dataclass(frozen=True)
class _Active:
    text: str
    expires_after: int
    replace_after: int


class TalkChannel:
    def __init__(self, config: TalkConfig):
        self.config = config
        self._active: Dict[int, _Active] = {}
        self._pending: Dict[int, str] = {}

    def reset(self) -> None:
        self._active.clear()
        self._pending.clear()

    def queue(self, agent_id: int, text: str, *, current_step: int) -> None:
        if not self.config.enabled:
            raise ValueError("talk is not enabled for this game")
        if not text:
            raise ValueError("talk must be non-empty")
        if len(text) > self.config.max_length:
            raise ValueError(f"talk exceeds max_length {self.config.max_length}")
        active = self._active.get(agent_id)
        if active is not None and (current_step + 1) < active.replace_after:
            raise ValueError("talk cooldown has not expired")
        self._pending[agent_id] = text

    def apply_pending(self, *, current_step: int) -> None:
        display = max(1, self.config.cooldown_steps)
        for agent_id, text in self._pending.items():
            self._active[agent_id] = _Active(
                text=text,
                expires_after=current_step + display,
                replace_after=current_step + self.config.cooldown_steps,
            )
        self._pending.clear()

    def expire(self, *, current_step: int) -> None:
        for agent_id in [a for a, t in self._active.items() if current_step >= t.expires_after]:
            del self._active[agent_id]

    def render_states(self, *, current_step: int) -> Dict[int, TalkState]:
        return {
            a: TalkState(text=t.text, remaining_steps=max(0, t.expires_after - current_step))
            for a, t in self._active.items()
        }

    def visible_talk(
        self,
        observer_agent_id: int,
        *,
        current_step: int,
        agent_locations: Dict[int, Location],
        obs_height: int,
        obs_width: int,
    ) -> List[VisibleTalk]:
        """Messages whose speaker is inside the observer's window (elliptical
        visibility matching the reference — talk.py:9-34)."""
        if not self.config.enabled or not self._active:
            return []
        obs_loc = agent_locations.get(observer_agent_id)
        if obs_loc is None:
            return []
        rr, cr = obs_height >> 1, obs_width >> 1
        out: List[VisibleTalk] = []
        for agent_id, talk in self._active.items():
            loc = agent_locations.get(agent_id)
            if loc is None:
                continue
            dr, dc = loc.r - obs_loc.r, loc.c - obs_loc.c
            if not self._within(dr, dc, rr, cr):
                continue
            out.append(
                VisibleTalk(
                    agent_id=agent_id,
                    text=talk.text,
                    remaining_steps=max(0, talk.expires_after - current_step),
                )
            )
        return sorted(out, key=lambda v: v.agent_id)

    @staticmethod
    def _within(dr: int, dc: int, rr: int, cr: int) -> bool:
        if rr == 0 and cr == 0:
            return dr == 0 and dc == 0
        if rr == 0:
            return dr == 0 and abs(dc) <= cr
        if cr == 0:
            return dc == 0 and abs(dr) <= rr
        if rr == cr:
            d2 = dr * dr + dc * dc
            r2 = rr * rr
            return d2 <= r2 or (rr >= 2 and d2 == r2 + 1 and (abs(dr) == rr or abs(dc) == cr))
        return dr * dr * cr * cr + dc * dc * rr * rr <= rr * rr * cr * cr
