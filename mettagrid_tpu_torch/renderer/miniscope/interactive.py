"""Interactive miniscope: full terminal UI with panels, playback control, and
manual agent takeover (reference: renderer/miniscope/miniscope.py).

Layout: map viewport on the left, toggleable sidebar panels (agent info,
object info, symbols) on the right, sim-control header and agent-control
footer. Modal vibe picker and help screens capture all input while open.
Falls back to non-blocking frame dumps when stdin is not a TTY (tests, CI).
"""

from __future__ import annotations

import select
import shutil
import sys
import time
from typing import Optional

from mettagrid_tpu_torch.renderer.renderer import Renderer
from mettagrid_tpu_torch.renderer.miniscope.components import (
    AgentControlComponent,
    AgentInfoComponent,
    HelpPanelComponent,
    MapComponent,
    MiniscopeComponent,
    ObjectInfoComponent,
    SimControlComponent,
    SymbolsTableComponent,
    VibePickerComponent,
)
from mettagrid_tpu_torch.renderer.miniscope.state import MiniscopeState, PlaybackState, RenderMode
from mettagrid_tpu_torch.renderer.miniscope.symbols import DEFAULT_SYMBOL_MAP

SIDEBAR_WIDTH = 28


class InteractiveMiniscope(Renderer):
    """Component-based TUI renderer driven from the Rollout loop."""

    def __init__(self, fps: float = 4.0, out=None, start_paused: bool = True):
        super().__init__()
        self._out = out or sys.stdout
        self._start_paused = start_paused
        self.state = MiniscopeState(fps=fps)
        self._components: list[MiniscopeComponent] = []
        self._sidebar_hotkeys = {"1": "agent_info", "2": "object_info", "3": "symbols"}
        self._terminal_fd: Optional[int] = None
        self._old_settings = None
        self._last_frame_time = 0.0
        self._ema_frame_time = 0.0

    # -- lifecycle -----------------------------------------------------------

    def on_episode_start(self) -> None:
        sim = self.sim
        st = self.state
        st.reset_for_episode(sim.num_agents, sim.map_height, sim.map_width)
        st.max_steps = sim.config.game.max_steps
        st.symbol_map = {**DEFAULT_SYMBOL_MAP, **sim.config.game.render.symbols}
        st.vibe_names = list(getattr(sim, "vibe_names", [])) or [
            n.removeprefix("change_vibe_") for n in sim.vibe_action_names
        ]
        term = shutil.get_terminal_size(fallback=(120, 40))
        st.viewport_height = max(4, min(st.map_height, term.lines - 6))
        st.viewport_width = max(4, min(st.map_width, (term.columns - SIDEBAR_WIDTH - 2) // 2))

        self._components = [
            MapComponent(sim, st),
            SimControlComponent(sim, st),
            AgentControlComponent(sim, st),
            AgentInfoComponent(sim, st),
            ObjectInfoComponent(sim, st),
            SymbolsTableComponent(sim, st),
            VibePickerComponent(sim, st),
            HelpPanelComponent(sim, st),
        ]
        self._setup_terminal()
        st.playback = (
            PlaybackState.PAUSED if (self._start_paused and self._terminal_fd is not None) else PlaybackState.RUNNING
        )
        self._last_frame_time = time.time()

    def on_step(self) -> None:
        self.state.step_count = self.sim.current_step

    def on_episode_end(self) -> None:
        self.state.playback = PlaybackState.STOPPED
        self._cleanup_terminal()

    # -- rollout integration -------------------------------------------------

    def render(self) -> None:
        """Block until the next sim step is due (frame pacing, paused
        interaction, or a manual action)."""
        st = self.state
        start = time.time()
        while True:
            if self.sim.is_done or st.playback == PlaybackState.STOPPED:
                return
            ch = self._get_input()
            if ch:
                self._handle_input(ch)
            self._update_fps(time.time())
            self._draw()
            if st.user_action is not None or st.should_step:
                return
            if st.playback == PlaybackState.STOPPED:
                return
            if st.playback == PlaybackState.PAUSED:
                time.sleep(1 / 60)
                continue
            if time.time() - start >= st.frame_delay():
                return
            if self._terminal_fd is None:
                return  # non-interactive: never block on pacing
            time.sleep(1 / 60)

    def consume_user_actions(self) -> dict[int, str]:
        """Manual-action overrides to apply after policy actions."""
        st = self.state
        out: dict[int, str] = {}
        if st.user_action is not None and st.selected_agent is not None:
            out[st.selected_agent] = st.user_action
        elif st.selected_agent in st.manual_agents:
            out[st.selected_agent] = "noop"
        st.user_action = None
        st.should_step = False
        return out

    @property
    def stopped(self) -> bool:
        return self.state.playback == PlaybackState.STOPPED

    # -- input ---------------------------------------------------------------

    def _handle_input(self, ch: str) -> None:
        st = self.state
        if st.mode == RenderMode.VIBE_PICKER:
            self._component("vibe_picker").handle_input(ch)
            return
        if st.mode == RenderMode.HELP:
            self._component("help").handle_input(ch)
            return
        if ch == "?":
            st.enter_modal(RenderMode.HELP)
            return
        if ch in self._sidebar_hotkeys:
            st.toggle_sidebar_panel(self._sidebar_hotkeys[ch])
            return
        for component in self._components:
            if component.handle_input(ch):
                return

    def _component(self, name: str) -> MiniscopeComponent:
        return next(c for c in self._components if c.name == name)

    def _get_input(self) -> Optional[str]:
        if self._terminal_fd is None:
            return None
        if select.select([sys.stdin], [], [], 0)[0]:
            return sys.stdin.read(1)
        return None

    # -- drawing -------------------------------------------------------------

    def compose_frame(self) -> str:
        """Compose the full frame as text (also used by tests)."""
        st = self.state
        header = self._component("sim_control").update()
        footer = self._component("agent_control").update()
        map_lines = self._component("map").update()

        if st.mode == RenderMode.VIBE_PICKER:
            sidebar = self._component("vibe_picker").update()
        elif st.mode == RenderMode.HELP:
            sidebar = self._component("help").update()
        else:
            sidebar = []
            for name in ("agent_info", "object_info", "symbols"):
                if st.sidebar_visibility.get(name):
                    sidebar += self._component(name).update() + [""]

        rows = max(len(map_lines), len(sidebar))
        body = []
        for i in range(rows):
            left = map_lines[i] if i < len(map_lines) else " " * st.viewport_width * 2
            right = sidebar[i] if i < len(sidebar) else ""
            body.append(f"{left} │ {right[:SIDEBAR_WIDTH]}")
        return "\n".join(header + body + footer)

    def _draw(self) -> None:
        frame = self.compose_frame()
        self._out.write("\x1b[2J\x1b[H" + frame + "\n")
        self._out.flush()

    def _update_fps(self, now: float) -> None:
        if self._last_frame_time > 0:
            dt = now - self._last_frame_time
            self._ema_frame_time = dt if self._ema_frame_time == 0 else 0.2 * dt + 0.8 * self._ema_frame_time
            if self._ema_frame_time > 0:
                self.state.true_fps = 1.0 / self._ema_frame_time
        self._last_frame_time = now

    # -- terminal ------------------------------------------------------------

    def _setup_terminal(self) -> None:
        try:
            import termios
            import tty

            if not sys.stdin.isatty():
                raise OSError("stdin is not a tty")
            self._terminal_fd = sys.stdin.fileno()
            self._old_settings = termios.tcgetattr(self._terminal_fd)
            tty.setcbreak(self._terminal_fd)
            self._out.write("\x1b[?25l")  # hide cursor
        except Exception:
            self._terminal_fd = None
            self._old_settings = None

    def _cleanup_terminal(self) -> None:
        if self._terminal_fd is not None and self._old_settings is not None:
            try:
                import termios

                termios.tcsetattr(self._terminal_fd, termios.TCSADRAIN, self._old_settings)
                self._out.write("\x1b[?25h")
            except Exception:
                pass
        self._terminal_fd = None
        self._old_settings = None
