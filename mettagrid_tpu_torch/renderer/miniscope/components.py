"""Panel components for the interactive miniscope TUI
(reference: renderer/miniscope/components/)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from mettagrid_tpu_torch.renderer.miniscope.state import MiniscopeState, PlaybackState, RenderMode
from mettagrid_tpu_torch.renderer.miniscope.symbols import symbol_for


class MiniscopeComponent:
    """A panel: update() returns its lines; handle_input() consumes keys."""

    name = "component"

    def __init__(self, sim, state: MiniscopeState):
        self._sim = sim
        self._state = state

    def handle_input(self, ch: str) -> bool:
        return False

    def update(self) -> list[str]:
        return []


class MapComponent(MiniscopeComponent):
    """Scrollable map viewport with follow/pan/select camera modes."""

    name = "map"

    def handle_input(self, ch: str) -> bool:
        st = self._state
        moves = {"h": (0, -1), "l": (0, 1), "k": (-1, 0), "j": (1, 0)}
        if ch == "f":
            st.set_mode(RenderMode.FOLLOW)
            return True
        if ch == "p":
            st.set_mode(RenderMode.PAN)
            return True
        if ch == "v":
            st.set_mode(RenderMode.SELECT)
            return True
        if ch in moves:
            dr, dc = moves[ch]
            if st.mode == RenderMode.SELECT:
                st.cursor_row = int(np.clip(st.cursor_row + dr, 0, st.map_height - 1))
                st.cursor_col = int(np.clip(st.cursor_col + dc, 0, st.map_width - 1))
            else:
                st.set_mode(RenderMode.PAN)
                st.camera_row = int(np.clip(st.camera_row + dr, 0, max(0, st.map_height - st.viewport_height)))
                st.camera_col = int(np.clip(st.camera_col + dc, 0, max(0, st.map_width - st.viewport_width)))
            return True
        return False

    def _camera_origin(self) -> tuple[int, int]:
        st = self._state
        vh, vw = st.viewport_height, st.viewport_width
        if st.mode == RenderMode.FOLLOW and st.selected_agent is not None:
            loc = self._sim.agent(st.selected_agent).location
            row = loc.r - vh // 2
            col = loc.c - vw // 2
        else:
            row, col = st.camera_row, st.camera_col
        row = int(np.clip(row, 0, max(0, st.map_height - vh)))
        col = int(np.clip(col, 0, max(0, st.map_width - vw)))
        return row, col

    def update(self) -> list[str]:
        st = self._state
        sim = self._sim
        H, W = st.map_height, st.map_width
        vh = min(st.viewport_height, H)
        vw = min(st.viewport_width, W)
        r0, c0 = self._camera_origin()

        empty = st.symbol_map.get("empty", "· ")
        grid = [[empty] * vw for _ in range(vh)]
        for obj in sim.grid_objects().values():
            r, c = obj["r"] - r0, obj["c"] - c0
            if 0 <= r < vh and 0 <= c < vw:
                grid[r][c] = symbol_for(st.symbol_map, obj["type_name"], obj.get("agent_id"))
        if st.mode == RenderMode.SELECT:
            r, c = st.cursor_row - r0, st.cursor_col - c0
            if 0 <= r < vh and 0 <= c < vw:
                grid[r][c] = st.symbol_map.get("cursor", "🎯")
        return ["".join(row) for row in grid]


class SimControlComponent(MiniscopeComponent):
    """Playback header: step counter, fps, mode (reference: sim_control.py)."""

    name = "sim_control"

    def handle_input(self, ch: str) -> bool:
        st = self._state
        if ch == " ":
            st.toggle_pause()
            return True
        if ch in ("n", "."):
            st.should_step = True
            return True
        if ch in ("+", "="):
            st.increase_speed()
            return True
        if ch == "-":
            st.decrease_speed()
            return True
        if ch == "q":
            st.playback = PlaybackState.STOPPED
            return True
        if ch == "o":
            st.show_aoe = not st.show_aoe
            return True
        return False

    def update(self) -> list[str]:
        st = self._state
        status = {"running": "▶", "paused": "⏸", "stopped": "■"}[st.playback.value]
        max_steps = f"/{st.max_steps}" if st.max_steps else ""
        return [
            f"{status} step {st.step_count}{max_steps}  fps {st.fps:.1f}"
            f" (true {st.true_fps:.1f})  mode {st.mode.value}"
        ]


class AgentControlComponent(MiniscopeComponent):
    """Footer: agent selection, manual control, movement keys
    (reference: agent_control.py)."""

    name = "agent_control"

    _MOVE_KEYS = {"W": "move_north", "A": "move_west", "S": "move_south", "D": "move_east"}

    def handle_input(self, ch: str) -> bool:
        st = self._state
        if ch == "[":
            st.select_previous_agent(self._sim.num_agents)
            return True
        if ch == "]":
            st.select_next_agent(self._sim.num_agents)
            return True
        if st.selected_agent is None:
            return False
        up = ch.upper()
        if up in self._MOVE_KEYS and self._MOVE_KEYS[up] in self._sim.action_ids:
            st.user_action = self._MOVE_KEYS[up]
            st.should_step = True
            return True
        if up == "R" and "noop" in self._sim.action_ids:
            st.user_action = "noop"
            st.should_step = True
            return True
        if up == "E":
            st.enter_modal(RenderMode.VIBE_PICKER)
            return True
        if up == "M":
            st.toggle_manual_control(st.selected_agent)
            return True
        return False

    def update(self) -> list[str]:
        st = self._state
        if st.selected_agent is not None:
            manual = " (Manual)" if st.selected_agent in st.manual_agents else ""
            agent = f"[Agent {st.selected_agent}]{manual}"
        else:
            agent = "[AI Control]"
        return [f"{agent} []=Agent M=Manual WASD=Move E=Vibe R=Rest ?=Help q=Quit"]


class AgentInfoComponent(MiniscopeComponent):
    """Sidebar: selected agent's inventory/reward/vibe (reference: agent_info.py)."""

    name = "agent_info"

    def update(self) -> list[str]:
        st = self._state
        if st.selected_agent is None:
            return ["─ agent ─", "(none selected)"]
        aid = st.selected_agent
        objects = self._sim.grid_objects()
        entry = objects.get(aid)
        lines = [f"─ agent {aid} ─"]
        rewards = self._sim.episode_rewards
        if aid < len(rewards):
            lines.append(f"reward {rewards[aid]:.2f}")
        if entry:
            lines.append(f"pos ({entry['r']},{entry['c']})")
            vibe_id = entry.get("vibe", 0)
            vibe = st.vibe_names[vibe_id] if vibe_id < len(st.vibe_names) else str(vibe_id)
            lines.append(f"vibe {vibe}")
            inv = entry.get("inventory", {})
            lines.append("inventory:" if inv else "inventory: (empty)")
            for name, qty in sorted(inv.items()):
                lines.append(f"  {name}: {qty}")
        return lines


class ObjectInfoComponent(MiniscopeComponent):
    """Sidebar: object under the SELECT-mode cursor (reference: object_info.py)."""

    name = "object_info"

    def update(self) -> list[str]:
        st = self._state
        lines = ["─ object ─"]
        if st.mode != RenderMode.SELECT:
            lines.append("(press v, then hjkl)")
            return lines
        target: Optional[dict] = None
        for obj in self._sim.grid_objects().values():
            if obj["r"] == st.cursor_row and obj["c"] == st.cursor_col:
                target = obj
                break
        lines.append(f"cursor ({st.cursor_row},{st.cursor_col})")
        if target is None:
            lines.append("(empty cell)")
            return lines
        lines.append(f"type {target['type_name']}")
        if target.get("tags"):
            lines.append("tags " + ",".join(target["tags"][:4]))
        for name, qty in sorted(target.get("inventory", {}).items()):
            lines.append(f"  {name}: {qty}")
        return lines


class SymbolsTableComponent(MiniscopeComponent):
    """Sidebar: legend of type symbols (reference: symbols_table.py)."""

    name = "symbols"

    def update(self) -> list[str]:
        lines = ["─ symbols ─"]
        for type_name in self._sim.object_type_names:
            lines.append(f"{symbol_for(self._state.symbol_map, type_name)} {type_name}")
        return lines[:12]


class VibePickerComponent(MiniscopeComponent):
    """Modal: choose a vibe for the selected agent (reference: vibe_picker.py)."""

    name = "vibe_picker"

    def __init__(self, sim, state):
        super().__init__(sim, state)
        self._index = 0

    def handle_input(self, ch: str) -> bool:
        st = self._state
        names = self._sim.vibe_action_names
        if ch in ("\x1b", "e", "E"):
            st.exit_modal()
            return True
        if ch in ("j", "s"):
            self._index = (self._index + 1) % max(1, len(names))
            return True
        if ch in ("k", "w"):
            self._index = (self._index - 1) % max(1, len(names))
            return True
        if ch in ("\r", "\n") and names:
            st.user_action = names[self._index]
            st.should_step = True
            st.exit_modal()
            return True
        return True  # modal: swallow everything else

    def update(self) -> list[str]:
        names = self._sim.vibe_action_names
        lines = ["─ pick vibe (j/k, enter, esc) ─"]
        for i, name in enumerate(names[:16]):
            marker = "▶" if i == self._index else " "
            lines.append(f"{marker} {name.removeprefix('change_vibe_')}")
        return lines


class HelpPanelComponent(MiniscopeComponent):
    """Modal: keybinding reference (reference: help_panel.py)."""

    name = "help"

    KEYS = [
        ("space", "play/pause"),
        ("n or .", "single step"),
        ("+/-", "speed up/down"),
        ("f/p/v", "follow/pan/select mode"),
        ("hjkl", "pan camera / move cursor"),
        ("[ ]", "previous/next agent"),
        ("M", "toggle manual control"),
        ("WASD", "move selected agent"),
        ("R", "rest (noop)"),
        ("E", "vibe picker"),
        ("1/2/3", "toggle sidebar panels"),
        ("o", "toggle AOE overlay"),
        ("q", "quit"),
    ]

    def handle_input(self, ch: str) -> bool:
        self._state.exit_modal()
        return True

    def update(self) -> list[str]:
        lines = ["─ help (any key to close) ─"]
        lines += [f"{key:>8}  {desc}" for key, desc in self.KEYS]
        return lines
