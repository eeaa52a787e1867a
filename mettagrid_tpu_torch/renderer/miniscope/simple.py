"""Miniscope: terminal map renderer with emoji symbols and a status panel
(reference: renderer/miniscope/ — the full reference TUI has interactive
panels/agent control; this implementation covers the rendering core:
map view with per-type symbols, agent/reward status, optional interactive
pacing. ANSI-based, no curses dependency)."""

from __future__ import annotations

import sys
import time
from typing import Optional

import numpy as np

from mettagrid_tpu_torch.renderer.renderer import Renderer

DEFAULT_SYMBOLS = {
    "wall": "⬛",
    "empty": "⬜",
    "agent": "🤖",
    "mine": "⛏️ ",
    "generator": "⚡",
    "altar": "🛐",
    "chest": "📦",
    "hub": "🏠",
}
AGENT_SYMBOLS = ["🤖", "🦾", "🤠", "👽", "🧑", "🧛", "🧟", "🥷"]


class MiniscopeRenderer(Renderer):
    def __init__(self, fps: float = 10.0, out=None, use_emoji: bool = True):
        super().__init__()
        self._fps = fps
        self._out = out or sys.stdout
        self._use_emoji = use_emoji
        self._last_frame = 0.0
        self._symbols = dict(DEFAULT_SYMBOLS)

    def set_symbol(self, type_name: str, symbol: str) -> None:
        self._symbols[type_name] = symbol

    def _symbol_for(self, type_name: str, agent_id: Optional[int]) -> str:
        if agent_id is not None:
            if self._use_emoji:
                return AGENT_SYMBOLS[agent_id % len(AGENT_SYMBOLS)]
            return str(agent_id % 10) + " "
        sym = self._symbols.get(type_name)
        if sym is None:
            sym = self.sim.config.game.render.symbols.get(type_name, "❓")
        if not self._use_emoji:
            return (type_name[0] if type_name else "?") + " "
        return sym

    def render_frame(self, env: int = 0) -> str:
        sim = self.sim
        H, W = sim.map_height, sim.map_width
        grid = [["⬜" if self._use_emoji else ". "] * W for _ in range(H)]
        for obj in sim.grid_objects(env).values():
            grid[obj["r"]][obj["c"]] = self._symbol_for(obj["type_name"], obj.get("agent_id"))
        lines = ["".join(row) for row in grid]
        rewards = sim.state.episode_rewards[env].cpu().numpy()
        lines.append(
            f"step {sim.current_step}/{sim.config.game.max_steps}  "
            f"rewards {np.array2string(rewards, precision=2)}"
        )
        return "\n".join(lines)

    def on_step(self) -> None:
        now = time.time()
        min_dt = 1.0 / self._fps if self._fps > 0 else 0.0
        if now - self._last_frame < min_dt:
            return
        self._last_frame = now
        frame = self.render_frame()
        # Clear screen + home cursor, then draw
        self._out.write("\x1b[2J\x1b[H" + frame + "\n")
        self._out.flush()

    def on_episode_end(self) -> None:
        self._out.write(self.render_frame() + "\n=== episode end ===\n")
        self._out.flush()
