"""Shared state for the interactive miniscope TUI
(reference: renderer/miniscope/miniscope_state.py)."""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, Optional, Set


class RenderMode(str, Enum):
    FOLLOW = "follow"          # camera tracks the selected agent
    PAN = "pan"                # free camera movement
    SELECT = "select"          # cursor-based object inspection
    VIBE_PICKER = "vibe_picker"  # modal vibe chooser
    HELP = "help"              # modal help screen


class PlaybackState(Enum):
    STOPPED = "stopped"
    RUNNING = "running"
    PAUSED = "paused"


DEFAULT_SIDEBAR_PANELS = ("agent_info", "object_info", "symbols")


@dataclass
class MiniscopeState:
    playback: PlaybackState = PlaybackState.STOPPED
    fps: float = 4.0
    true_fps: float = 0.0
    step_count: int = 0
    max_steps: Optional[int] = None

    camera_row: int = 0
    camera_col: int = 0
    viewport_height: int = 20
    viewport_width: int = 40

    mode: RenderMode = RenderMode.FOLLOW
    _mode_before_modal: RenderMode = RenderMode.FOLLOW
    selected_agent: Optional[int] = 0
    cursor_row: int = 0
    cursor_col: int = 0

    manual_agents: Set[int] = field(default_factory=set)
    # Pending manual action for the selected agent (action name), consumed by
    # the rollout before the next step.
    user_action: Optional[str] = None
    should_step: bool = False

    map_height: int = 0
    map_width: int = 0
    symbol_map: Dict[str, str] = field(default_factory=dict)
    vibe_names: list[str] = field(default_factory=list)
    show_aoe: bool = True

    sidebar_visibility: Dict[str, bool] = field(default_factory=dict)

    def reset_for_episode(self, num_agents: int, map_height: int, map_width: int) -> None:
        self.step_count = 0
        self.map_height = map_height
        self.map_width = map_width
        self.cursor_row = map_height // 2
        self.cursor_col = map_width // 2
        self.manual_agents.clear()
        self.user_action = None
        self.should_step = False
        if self.selected_agent is not None and self.selected_agent >= num_agents:
            self.selected_agent = 0
        for name in DEFAULT_SIDEBAR_PANELS:
            self.sidebar_visibility.setdefault(name, name != "symbols")

    def is_running(self) -> bool:
        return self.playback in (PlaybackState.RUNNING, PlaybackState.PAUSED)

    def toggle_pause(self) -> None:
        if self.playback == PlaybackState.PAUSED:
            self.playback = PlaybackState.RUNNING
        elif self.playback == PlaybackState.RUNNING:
            self.playback = PlaybackState.PAUSED

    def increase_speed(self) -> None:
        self.fps = min(600.0, self.fps * 1.5)

    def decrease_speed(self) -> None:
        self.fps = max(0.01, self.fps / 1.5)

    def frame_delay(self) -> float:
        return 1.0 / self.fps if self.fps > 0 else 0.25

    def set_mode(self, mode: RenderMode) -> None:
        if mode in (RenderMode.VIBE_PICKER, RenderMode.HELP):
            return
        self.mode = mode
        if mode == RenderMode.SELECT:
            self.sidebar_visibility["object_info"] = True

    def enter_modal(self, mode: RenderMode) -> None:
        if self.mode not in (RenderMode.VIBE_PICKER, RenderMode.HELP):
            self._mode_before_modal = self.mode
        self.mode = mode

    def exit_modal(self) -> None:
        self.mode = self._mode_before_modal

    def select_next_agent(self, num_agents: int) -> None:
        if num_agents == 0:
            return
        self.selected_agent = 0 if self.selected_agent is None else (self.selected_agent + 1) % num_agents

    def select_previous_agent(self, num_agents: int) -> None:
        if num_agents == 0:
            return
        self.selected_agent = (
            num_agents - 1 if self.selected_agent is None else (self.selected_agent - 1) % num_agents
        )

    def toggle_manual_control(self, agent_id: int) -> None:
        if agent_id in self.manual_agents:
            self.manual_agents.discard(agent_id)
        else:
            self.manual_agents.add(agent_id)

    def toggle_sidebar_panel(self, name: str) -> None:
        self.sidebar_visibility[name] = not self.sidebar_visibility.get(name, False)
