"""The port's renderers (mettagrid_tpu_torch/renderer/), on the CPU.

- Twins of tests/renderer/: the miniscope and log renderers, the
  interactive miniscope headless (panels, keys, modals, manual override in
  a Rollout), the live viewer (HTML over HTTP, per-step WebSocket deltas, a
  late joiner's history) and the standalone HTML replay viewer.
- Twins of tests/simulator/test_replay_interop.py's validator cases on a
  replay the port wrote: the mettascope loader's checks accept it and
  reject each broken copy.
- Lockstep with the JAX package: its Simulation and the port's under the
  MT19937 twin from one seed, fed the same random actions, each with a
  MiniscopeRenderer (ASCII), an InteractiveMiniscope, a LogRenderer and an
  InMemoryReplayWriter. Every miniscope frame, every composed TUI frame and
  every log line must be equal, string for string; the port's replay must
  equal the JAX package's and pass both packages' ``validate_replay`` with
  no issues.

Tolerance: exact (strings and integers).
"""

import copy
import io
import json
import logging
import re
import urllib.request

import numpy as np
import pytest

from mettagrid_tpu.renderer import InteractiveMiniscope as JaxInteractiveMiniscope
from mettagrid_tpu.renderer import LogRenderer as JaxLogRenderer
from mettagrid_tpu.renderer import MiniscopeRenderer as JaxMiniscopeRenderer
from mettagrid_tpu.renderer.replay_validator import validate_replay as jax_validate_replay
from mettagrid_tpu.simulator import Simulation as JaxSimulation
from mettagrid_tpu.simulator.replay_writer import InMemoryReplayWriter as JaxReplayWriter
from mettagrid_tpu_torch.config.game_config import GameConfig, MettaGridConfig, WallConfig
from mettagrid_tpu_torch.maps.ascii import AsciiMapBuilder
from mettagrid_tpu_torch.policy import NoopMultiAgentPolicy
from mettagrid_tpu_torch.renderer import InteractiveMiniscope, LogRenderer, MiniscopeRenderer
from mettagrid_tpu_torch.renderer.live_viewer import LiveViewer
from mettagrid_tpu_torch.renderer.miniscope.state import PlaybackState, RenderMode
from mettagrid_tpu_torch.renderer.replay_validator import validate_replay
from mettagrid_tpu_torch.renderer.replay_viewer import write_viewer
from mettagrid_tpu_torch.simulator import Simulation
from mettagrid_tpu_torch.simulator.replay_writer import InMemoryReplayWriter, ReplayLogWriter
from mettagrid_tpu_torch.simulator.rollout import Rollout
from mettagrid_tpu_torch.test_support import ObjectNameMapBuilder
from tests.test_torch_simulation import arena


def nav_config(max_steps=3):
    return MettaGridConfig(
        game=GameConfig(
            num_agents=1,
            max_steps=max_steps,
            objects={"wall": WallConfig()},
            map_builder=AsciiMapBuilder.Config(map_data=["#####", "#@..#", "#####"]),
        )
    )


# --- tests/renderer/test_renderers.py ---


def test_miniscope_renders_frames():
    buf = io.StringIO()
    renderer = MiniscopeRenderer(fps=0, out=buf, use_emoji=False)
    sim = Simulation(nav_config(), event_handlers=[renderer], device="cpu")
    sim.agent(0).set_action("move_east")
    sim.step()
    frame = renderer.render_frame()
    assert "step 1/3" in frame
    assert "w " in frame
    assert "0 " in frame


def test_log_renderer_runs(caplog):
    sim = Simulation(nav_config(), event_handlers=[LogRenderer()], device="cpu")
    with caplog.at_level(logging.INFO, logger="mettagrid_tpu_torch.renderer.log_renderer"):
        while not sim.is_done:
            sim.step()
    assert "=== Episode End ===" in caplog.messages and "Total steps: 3" in caplog.messages


# --- tests/renderer/test_interactive_miniscope.py ---


def make_rollout(renderer, max_steps=3):
    cfg = MettaGridConfig.EmptyRoom(num_agents=2)
    cfg.game.max_steps = 10
    return Rollout(cfg, NoopMultiAgentPolicy(), seed=0, max_steps=max_steps, renderer=renderer, device="cpu")


def test_interactive_miniscope_runs_headless():
    out = io.StringIO()
    renderer = InteractiveMiniscope(fps=0, out=out)
    result = make_rollout(renderer).run()
    assert result.steps == 3
    frame = out.getvalue()
    assert "step" in frame and "Agent 0" in frame


def test_compose_frame_panels():
    renderer = InteractiveMiniscope(out=io.StringIO())
    make_rollout(renderer, max_steps=1).step()
    st = renderer.state
    st.sidebar_visibility["agent_info"] = True
    frame = renderer.compose_frame()
    assert "agent 0" in frame and "│" in frame
    st.set_mode(RenderMode.SELECT)
    assert "cursor" in renderer.compose_frame()


def test_key_handling_pause_step_speed():
    renderer = InteractiveMiniscope(out=io.StringIO())
    make_rollout(renderer, max_steps=1).step()
    st = renderer.state
    st.playback = PlaybackState.RUNNING
    renderer._handle_input(" ")
    assert st.playback == PlaybackState.PAUSED
    renderer._handle_input("n")
    assert st.should_step
    fps0 = st.fps
    renderer._handle_input("+")
    assert st.fps > fps0
    renderer._handle_input("q")
    assert renderer.stopped


def test_agent_selection_and_manual_action():
    renderer = InteractiveMiniscope(out=io.StringIO())
    make_rollout(renderer, max_steps=1).step()
    st = renderer.state
    renderer._handle_input("]")
    assert st.selected_agent == 1
    renderer._handle_input("[")
    assert st.selected_agent == 0
    renderer._handle_input("w")
    assert st.user_action == "move_north"
    assert renderer.consume_user_actions() == {0: "move_north"}
    assert st.user_action is None
    renderer._handle_input("m")
    assert 0 in st.manual_agents


def test_vibe_picker_modal():
    renderer = InteractiveMiniscope(out=io.StringIO())
    make_rollout(renderer, max_steps=1).step()
    st = renderer.state
    renderer._handle_input("e")
    assert st.mode == RenderMode.VIBE_PICKER
    assert "pick vibe" in renderer.compose_frame()
    renderer._handle_input("j")
    renderer._handle_input("\r")
    assert st.user_action is not None and st.user_action.startswith("change_vibe_")
    assert st.mode != RenderMode.VIBE_PICKER


def test_help_modal():
    renderer = InteractiveMiniscope(out=io.StringIO())
    make_rollout(renderer, max_steps=1).step()
    st = renderer.state
    renderer._handle_input("?")
    assert st.mode == RenderMode.HELP
    assert "help" in renderer.compose_frame()
    renderer._handle_input("x")
    assert st.mode != RenderMode.HELP


def test_manual_override_applied_in_rollout():
    renderer = InteractiveMiniscope(out=io.StringIO())
    rollout = make_rollout(renderer, max_steps=2)
    sim = rollout.simulation
    pos0 = tuple(sim.agent(0).location)
    renderer.state.selected_agent = 0
    renderer.state.user_action = "move_south"
    rollout.step()
    pos1 = tuple(sim.agent(0).location)
    assert pos1[0] == pos0[0] + 1 or pos1 == pos0


# --- tests/renderer/test_live_viewer.py ---


def _live_cfg():
    return MettaGridConfig(
        game=GameConfig(
            num_agents=1,
            max_steps=50,
            objects={"wall": WallConfig()},
            map_builder=ObjectNameMapBuilder.Config(
                map_data=[["wall"] * 5, ["wall", "agent.agent", "empty", "empty", "wall"], ["wall"] * 5]
            ),
        )
    )


def test_live_viewer_streams_steps():
    from websockets.sync.client import connect

    viewer = LiveViewer(port=0)
    sim = Simulation(_live_cfg(), seed=0, event_handlers=[viewer], device="cpu")
    try:
        html = urllib.request.urlopen(viewer.url, timeout=5).read().decode()
        assert "boot(" in html and "WebSocket" in html
        with connect(viewer.url.replace("http://", "ws://") + "ws", open_timeout=5) as ws:
            init = json.loads(ws.recv(timeout=5))
            assert init["type"] == "init" and init["replay"]["version"] == 4
            assert init["replay"]["map_size"] == [5, 3]
            sim.agent(0).set_action("move_east")
            sim.step()
            msg = json.loads(ws.recv(timeout=10))
            assert msg["type"] == "step" and msg["step"] == 0
            agent_objs = [o for o in msg["new_objects"] if o.get("is_agent") == [[0, True]]]
            assert agent_objs and agent_objs[0]["location"] == [[0, [2, 1]]]
            sim.agent(0).set_action("move_east")
            sim.step()
            msg2 = json.loads(ws.recv(timeout=10))
            assert msg2["type"] == "step" and msg2["step"] == 1
            assert [f.get("location") for _, f in msg2["deltas"] if "location" in f] == [[3, 1]]
    finally:
        sim.close()
        viewer.close()


def test_live_viewer_late_joiner_gets_history():
    from websockets.sync.client import connect

    viewer = LiveViewer(port=0)
    sim = Simulation(_live_cfg(), seed=0, event_handlers=[viewer], device="cpu")
    try:
        for _ in range(3):
            sim.agent(0).set_action("move_east")
            sim.step()
        with connect(viewer.url.replace("http://", "ws://") + "ws", open_timeout=5) as ws:
            replay = json.loads(ws.recv(timeout=5))["replay"]
            assert replay["max_steps"] == 3
            agent = next(o for o in replay["objects"] if o.get("is_agent") == [[0, True]])
            assert [s for s, _ in agent["location"]] == [0, 1]
    finally:
        sim.close()
        viewer.close()


# --- tests/renderer/test_replay_viewer.py ---


def _run_east(writer, max_steps=4):
    sim = Simulation(nav_config(max_steps), event_handlers=[writer], device="cpu")
    while not sim.is_done:
        sim.agent(0).set_action("move_east")
        sim.step()
    return sim


def _embedded(html: str) -> dict:
    m = re.search(r"boot\((\{.*?\})\);\n", html, re.DOTALL)
    assert m, "embedded replay payload not found"
    return json.loads(m.group(1).replace("<\\/", "</"))


def test_viewer_embeds_replay_dict(tmp_path):
    writer = InMemoryReplayWriter()
    _run_east(writer)
    html = write_viewer(writer.get_completed_replays()[0].finalize(), tmp_path / "replay.html").read_text()
    emb = _embedded(html)
    assert emb["version"] == 4 and emb["map_size"] == [5, 3]
    assert any("agent_id" in o for o in emb["objects"])
    assert "src=" not in html.split("<script>")[0]
    assert "http" not in html.split("</style>")[0].split("<style>")[1]


def test_viewer_reads_compressed_replay_file(tmp_path):
    writer = ReplayLogWriter(str(tmp_path))
    _run_east(writer)
    out = write_viewer(writer.get_written_replay_paths()[0], tmp_path / "from_file.html")
    emb = _embedded(out.read_text())
    assert emb["version"] == 4
    agent = next(o for o in emb["objects"] if "agent_id" in o)
    assert isinstance(agent["location"], list) and len(agent["location"]) >= 2


# --- tests/simulator/test_replay_interop.py's validator cases ---


@pytest.fixture(scope="module")
def good_replay():
    writer = InMemoryReplayWriter()
    sim = _run_east(writer, max_steps=5)
    sim.close()
    return json.loads(json.dumps(writer.get_completed_replays()[0].finalize()))


def _first_agent(d):
    return next(o for o in d["objects"] if "agent_id" in o)


MUTATIONS = {
    "missing required key": (lambda d: d.pop("type_names"), "Missing required keys"),
    "wrong version": (lambda d: d.__setitem__("version", 3), "'version' must be 4"),
    "unexpected top-level key": (lambda d: d.__setitem__("bogus", 1), "Unexpected keys"),
    "time series not at step 0": (lambda d: _first_agent(d).__setitem__("action_id", [[1, 0], [2, 1]]),
                                  "must start with step 0"),
    "agent id out of range": (lambda d: _first_agent(d).__setitem__("agent_id", d["num_agents"]), "out of range"),
    "object id 0": (lambda d: d["objects"][0].__setitem__("id", 0), "must be positive"),
    "mixed inventory formats": (lambda d: d["objects"][0].__setitem__("inventory", [[0, [[0, 1]]], [1, 2]]),
                                "mixed time series and static"),
    "agent count": (lambda d: d.__setitem__("num_agents", 2), "Expected 2 agents, found 1"),
}


def test_validator_accepts_port_replay(good_replay):
    assert validate_replay(good_replay) == []
    assert jax_validate_replay(good_replay) == []


@pytest.mark.parametrize("case", list(MUTATIONS))
def test_validator_rejects_broken_replay(good_replay, case):
    mutate, message = MUTATIONS[case]
    d = copy.deepcopy(good_replay)
    mutate(d)
    issues = validate_replay(d)
    assert any(message in i for i in issues), issues
    assert issues == jax_validate_replay(d)


# --- lockstep with the JAX package ---


class _Lines(logging.Handler):
    def __init__(self, name):
        super().__init__(logging.INFO)
        self.lines = []
        self._logger = logging.getLogger(name)

    def __enter__(self):
        self._level = self._logger.level
        self._logger.setLevel(logging.INFO)
        self._logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self._logger.removeHandler(self)
        self._logger.setLevel(self._level)

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_lockstep_frames_logs_and_replays_with_jax():
    jmini, tmini = (JaxMiniscopeRenderer(fps=0, out=io.StringIO(), use_emoji=False),
                    MiniscopeRenderer(fps=0, out=io.StringIO(), use_emoji=False))
    jtui, ttui = JaxInteractiveMiniscope(fps=0, out=io.StringIO()), InteractiveMiniscope(fps=0, out=io.StringIO())
    jrep, trep = JaxReplayWriter(), InMemoryReplayWriter()
    with _Lines("mettagrid_tpu.renderer.log_renderer") as jlog, \
            _Lines("mettagrid_tpu_torch.renderer.log_renderer") as tlog:
        j = JaxSimulation(arena(jax=True), seed=7, reference_shuffle=True,
                          event_handlers=[jmini, jtui, JaxLogRenderer(), jrep])
        t = Simulation(arena(), seed=7, reference_shuffle=True, device="cpu",
                       event_handlers=[tmini, ttui, LogRenderer(), trep])
        for st in (jtui.state, ttui.state):
            st.viewport_height = st.viewport_width = 8  # not the terminal's size
            st.sidebar_visibility.update(agent_info=True, object_info=True, symbols=True)
        names = t.action_names
        rng = np.random.default_rng(7)
        step = 0
        while True:
            assert tmini.render_frame() == jmini.render_frame(), f"step {step}: miniscope frame"
            for st in (jtui.state, ttui.state):
                st.selected_agent = step % t.num_agents
                st.set_mode(RenderMode.SELECT if step % 3 == 2 else RenderMode.FOLLOW)
                st.cursor_row, st.cursor_col = 1 + step % 8, 1 + (3 * step) % 8
            assert ttui.compose_frame() == jtui.compose_frame(), f"step {step}: interactive frame"
            if t.is_done:
                break
            for a in range(t.num_agents):
                action = names[int(rng.integers(0, len(names)))]
                j.agent(a).set_action(action)
                t.agent(a).set_action(action)
            j.step()
            t.step()
            step += 1
        assert j.is_done and step == t.config.game.max_steps
    assert tlog.lines == jlog.lines and "=== Episode End ===" in tlog.lines
    assert tmini._out.getvalue() == jmini._out.getvalue()
    treplay = json.loads(json.dumps(trep.get_completed_replays()[0].finalize()))
    jreplay = json.loads(json.dumps(jrep.get_completed_replays()[0].finalize()))
    # The config names its map builder's class, which each package has.
    builder = "maps.random_map.RandomMapBuilder.Config"
    assert treplay["mg_config"]["game"]["map_builder"]["type"] == f"mettagrid_tpu_torch.{builder}"
    assert jreplay["mg_config"]["game"]["map_builder"]["type"] == f"mettagrid_tpu.{builder}"
    treplay["mg_config"]["game"]["map_builder"]["type"] = f"mettagrid_tpu.{builder}"
    assert treplay == jreplay
    assert validate_replay(treplay) == [] and jax_validate_replay(treplay) == []
