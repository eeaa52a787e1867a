"""Live episode viewer: stream a running Simulation into the HTML viewer.

The reference's live path loads the Nim mettascope GUI in-process and feeds
it per-step replay-delta JSON (renderer/mettascope.py:20-120 — initial
replay header at episode start, then one step payload per tick). This is
the toolchain-free equivalent: `LiveViewer` is a `SimulatorEventHandler`
that serves the standalone HTML viewer (renderer/replay_viewer.py) over
local HTTP and pushes per-step timeline deltas over a WebSocket on the same
port — open `viewer.url` in a browser while the episode runs; late joiners
receive the full history (the in-progress replay-v4 snapshot) and then
follow live. The accumulated episode remains a valid v4 replay
(simulator/replay_writer.EpisodeReplay), so the live view and the written
replay can never diverge.
"""

from __future__ import annotations

import asyncio
import http
import json
import threading
from typing import Any, Dict, List, Optional, Tuple

from mettagrid_tpu_torch.renderer.replay_viewer import _HTML_TEMPLATE
from mettagrid_tpu_torch.simulator.interface import SimulatorEventHandler
from mettagrid_tpu_torch.simulator.replay_writer import EpisodeReplay

_LIVE_PAGE = _HTML_TEMPLATE.replace(
    "if (typeof __LIVE__ === \"undefined\") boot(__REPLAY_DATA__);",
    """// live mode: bootstrap from the WebSocket stream
const __LIVE__ = true;
let api = null;
const ws = new WebSocket(`ws://${location.host}/ws`);
ws.onmessage = (ev) => {
  const msg = JSON.parse(ev.data);
  if (msg.type === "init") api = boot(msg.replay);
  else if (msg.type === "step" && api) api.applyStep(msg.step, msg.new_objects, msg.deltas);
};
ws.onclose = () => { const m = document.getElementById("meta");
  if (m) m.textContent += " · disconnected"; };
""",
)


class LiveViewer(SimulatorEventHandler):
    """Serve a live view of env 0 of the attached Simulation.

    Usage::

        viewer = LiveViewer(port=0)           # 0 = pick a free port
        sim = Simulation(cfg, seed=0, event_handlers=[viewer])
        print(viewer.url)                     # open in a browser
        ... sim.step() ...
        viewer.close()
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        super().__init__()
        self._host = host
        self._port = port
        self._replay: Optional[EpisodeReplay] = None
        self._obj_snapshot_len = 0
        self._clients: set = set()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._server = None
        self._lock = threading.Lock()

    # ---------------- event-handler hooks ----------------

    def on_episode_start(self) -> None:
        self._ensure_server()
        with self._lock:
            self._replay = EpisodeReplay(self._simulation)
            self._obj_snapshot_len = 0
        self._broadcast(self._init_message())

    def on_step(self) -> None:
        sim = self._simulation
        if self._replay is None:
            return
        actions = sim.state.agent_last_action[0].cpu().numpy()
        rewards = sim.last_outputs.rewards[0].cpu().numpy()
        with self._lock:
            prev_objs = self._obj_snapshot_len
            self._replay.log_step(sim.current_step, actions, rewards)
            n = self._replay.step - 1  # the step just merged
            new_objects, deltas = self._collect_deltas(n, prev_objs)
            self._obj_snapshot_len = len(self._replay.objects)
        self._broadcast(
            json.dumps(
                {"type": "step", "step": n, "new_objects": new_objects, "deltas": deltas}
            )
        )

    def on_close(self) -> None:
        self.close()

    # ---------------- protocol ----------------

    def _init_message(self) -> str:
        with self._lock:
            if self._replay is None:
                replay: Dict[str, Any] = {"version": 0, "map_size": [1, 1], "objects": []}
            else:
                replay = dict(self._replay.replay_data)
                replay["max_steps"] = max(self._replay.step, 1)
        return json.dumps({"type": "init", "replay": replay})

    def _collect_deltas(
        self, n: int, prev_objs: int
    ) -> Tuple[List[dict], List[Tuple[int, Dict[str, Any]]]]:
        """Timeline entries _seq_key_merge appended at step n: full dicts for
        newly-seen objects, {field: value} for existing ones."""
        objs = self._replay.objects
        new_objects = objs[prev_objs:]
        deltas: List[Tuple[int, Dict[str, Any]]] = []
        for idx in range(prev_objs):
            fields: Dict[str, Any] = {}
            for key, entries in objs[idx].items():
                if (
                    isinstance(entries, list)
                    and entries
                    and isinstance(entries[-1], (list, tuple))
                    and entries[-1][0] == n
                ):
                    fields[key] = entries[-1][1]
            if fields:
                deltas.append((idx, fields))
        return new_objects, deltas

    # ---------------- server ----------------

    @property
    def url(self) -> str:
        self._ensure_server()
        return f"http://{self._host}:{self._port}/"

    def _ensure_server(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._serve, daemon=True, name="live-viewer")
        self._thread.start()
        if not self._started.wait(timeout=10):
            raise RuntimeError("live viewer server failed to start")

    def _serve(self) -> None:
        import websockets.asyncio.server as ws_server

        async def handler(conn):
            self._clients.add(conn)
            try:
                await conn.send(self._init_message())
                async for _ in conn:  # ignore client messages; hold open
                    pass
            finally:
                self._clients.discard(conn)

        def process_request(conn, request):
            # Serve the viewer page over plain HTTP on the same port;
            # WebSocket upgrades (any path with the upgrade header) pass on.
            if "upgrade" in (request.headers.get("Connection", "")).lower():
                return None
            import websockets.http11 as http11

            page = _LIVE_PAGE.encode()
            return http11.Response(
                http.HTTPStatus.OK, "OK", _html_headers(len(page)), page
            )

        async def main():
            self._loop = asyncio.get_running_loop()
            async with ws_server.serve(
                handler, self._host, self._port, process_request=process_request
            ) as server:
                self._server = server
                self._port = server.sockets[0].getsockname()[1]
                self._started.set()
                await self._stop_future()

        asyncio.run(main())

    async def _stop_future(self):
        self._stop = asyncio.get_running_loop().create_future()
        await self._stop

    def _broadcast(self, message: str) -> None:
        loop = self._loop
        if loop is None or not self._clients:
            return

        def _send():
            for conn in list(self._clients):
                asyncio.ensure_future(_safe_send(conn, message))

        async def _safe_send(conn, msg):
            try:
                await conn.send(msg)
            except Exception:
                self._clients.discard(conn)

        loop.call_soon_threadsafe(_send)

    def close(self) -> None:
        loop, stop = self._loop, getattr(self, "_stop", None)
        if loop is not None and stop is not None and not stop.done():
            loop.call_soon_threadsafe(stop.set_result, None)
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._thread = None
        self._loop = None


def _html_headers(length: int):
    import websockets.datastructures as ds

    return ds.Headers(
        [
            ("Content-Type", "text/html; charset=utf-8"),
            ("Content-Length", str(length)),
            ("Connection", "close"),
        ]
    )
