"""The port's import boundary and device rules.

The port imports neither jax, flax, optax nor anything of the JAX package,
and the import-graph scan reaches every subpackage (the learner, the
measuring tools, the demos and the host utilities among them); its entry
points, the demos among them, refuse to run without a CUDA device unless
asked for the CPU; on CPU tensors the
B1, B2, B6a and B6b wrappers take their plain versions and launch nothing;
the reference-RNG step refuses draws fed from outside.
"""

import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "mettagrid_tpu_torch"


FORBIDDEN = ("jax", "flax", "optax", "mettagrid_tpu")
# Subpackages the import-graph scan must reach.
SUBPACKAGES = ("engine", "envs", "simulator", "parity", "policy", "runner", "util", "tools", "parallel", "perf",
               "profiling", "test_support", "demos", "util.tracer", "util.dict_utils", "util.diversity",
               "util.module", "util.uri_resolvers", "parallel.train", "profiling.phase_timing", "mapgen",
               "mapgen.scenes", "sdk", "renderer", "renderer.miniscope", "runner.policy_server", "parity.rng",
               "parallel.mesh", "parallel.dryrun", "parallel.rig", "parity.cross_engine", "parity.arena",
               "parity.reference_oracle")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_import_pulls_in_no_jax():
    code = (
        "import pkgutil, sys\n"
        "import mettagrid_tpu_torch, mettagrid_tpu_torch.engine\n"
        "for m in pkgutil.walk_packages(mettagrid_tpu_torch.__path__, 'mettagrid_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        f"missing = [p for p in {SUBPACKAGES!r} if 'mettagrid_tpu_torch.' + p not in sys.modules]\n"
        "assert not missing, missing\n"
        "print('ok', len([m for m in sys.modules if m.startswith('mettagrid_tpu_torch')]))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def _phase_module(name: str) -> bool:
    module = name.removeprefix("mettagrid_tpu_torch.engine.")
    return module != name and (module in ("aoe", "territory", "obs") or module.startswith(("actions", "step")))


# target: {file scanned: the imported names it must not hold}. The engine's
# arrows point one way: the observations import nothing of the action phase,
# and the write analysis (engine/mutfields.py) no phase module.
SCANS = {
    "package": lambda: {path: _forbidden for path in sorted(PACKAGE.rglob("*.py"))},
    "chip_smoke": lambda: {ROOT / "chip_smoke.py": _forbidden},
    "engine_arrows": lambda: {PACKAGE / "engine" / "obs.py": lambda n: n == "mettagrid_tpu_torch.engine.actions_fast",
                              PACKAGE / "engine" / "mutfields.py": _phase_module},
}


@pytest.mark.parametrize("target", list(SCANS))
def test_no_jax_import_in_source(target):
    files = SCANS[target]()
    assert files
    for path, forbidden in files.items():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] + [f"{node.module}.{a.name}" for a in node.names]
            else:
                continue
            bad = [n for n in names if forbidden(n)]
            assert not bad, f"{path.relative_to(ROOT)}:{node.lineno} imports {bad}"


def test_no_reference_knobs_read():
    """The port reads no METTAGRID_TPU_* switch (the reference's route and
    probe knobs: obs tail generations, dynobj, static tail, v3, ablations);
    the only environment variable it reads is CUDA_HOME, to find nvcc."""
    for path in sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        text = path.read_text()
        assert "METTAGRID_TPU_" not in text, f"{path.relative_to(ROOT)} names a reference knob"
        reads = text.count("os.environ") + text.count("os.getenv")
        allowed = 1 if path.name == "build.py" else 0
        assert reads == allowed, f"{path.relative_to(ROOT)} reads the environment {reads} times"


def _small_arena():
    from mettagrid_tpu_torch.builder import make_arena
    from mettagrid_tpu_torch.engine import build_env_init, compile_program
    from mettagrid_tpu_torch.maps.random_map import RandomMapBuilder

    cfg = make_arena(4, combat=False, map_builder=RandomMapBuilder.Config(agents=4, width=11, height=11, border_width=1, objects={"wall": 6}))
    program = compile_program(cfg)
    b = cfg.game.map_builder.create()
    b.config.seed = 1
    return program, build_env_init(program, [b.build_for_num_agents(4)])


def test_entry_points_need_a_device_or_cpu(monkeypatch):
    from mettagrid_tpu_torch.engine import make_reset, make_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    program, init = _small_arena()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_step(program, init)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_reset(program, init, 8)
    state, out = make_reset(program, init, 8, device="cpu")(0)
    assert state.grid.device.type == "cpu" and out.observations.dtype == torch.uint8


def test_api_entry_points_need_a_device_or_cpu(monkeypatch):
    """The vector env (and the wrappers over it), the Simulation and the
    signature tool raise without CUDA unless asked for the CPU."""
    from mettagrid_tpu_torch.builder import make_navigation
    from mettagrid_tpu_torch.envs import MettaGridPettingZooEnv, MettaGridPufferEnv, MettaGridVectorEnv
    from mettagrid_tpu_torch.simulator import Simulation, Simulator
    from mettagrid_tpu_torch.tools.episode_signature import signature

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = make_navigation(2)
    cfg.game.map_builder.width = cfg.game.map_builder.height = 8
    makers = {
        "vector env": lambda **kw: MettaGridVectorEnv(cfg, num_envs=2, **kw),
        "puffer env": lambda **kw: MettaGridPufferEnv(cfg, num_envs=2, **kw),
        "pettingzoo env": lambda **kw: MettaGridPettingZooEnv(cfg, **kw),
        "simulation": lambda **kw: Simulation(cfg, **kw),
        "simulator": lambda **kw: Simulator().new_simulation(cfg, **kw),
        "signature": lambda **kw: signature(0, 2, **kw),
    }
    for name, make in makers.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
        assert make(device="cpu") is not None, name
    assert len(signature(0, 2, device="cpu")) == 64


def test_policy_entry_points_need_a_device_or_cpu(monkeypatch, tmp_path):
    """The net policies (lstm, puffer, stateless, torch_lstm), Rollout,
    single_episode_rollout, run_multi_episode, run_episode_local and
    run_episode_isolated raise without CUDA unless asked for the CPU; the
    random and noop policies are numpy and take no device."""
    from mettagrid_tpu_torch.builder import make_navigation
    from mettagrid_tpu_torch.policy import (
        NoopMultiAgentPolicy,
        PolicySpec,
        PufferDefaultPolicy,
        RandomMultiAgentPolicy,
        StatelessPolicy,
        TorchMultiAgentPolicy,
    )
    from mettagrid_tpu_torch.policy.torch_compat import TorchCompatLSTMPolicy, TorchRefLSTMNet
    from mettagrid_tpu_torch.runner import EpisodeRequest, run_episode_isolated, run_episode_local
    from mettagrid_tpu_torch.simulator.multi_episode import run_multi_episode
    from mettagrid_tpu_torch.simulator.rollout import Rollout, single_episode_rollout

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = make_navigation(2)
    cfg.game.map_builder.width = cfg.game.map_builder.height = 8
    cfg.game.max_steps = 2
    state_dict = TorchRefLSTMNet(5, 30, 8, device="cpu").state_dict()
    random = RandomMultiAgentPolicy(num_actions=5)
    request = EpisodeRequest(config=cfg, policy_specs=[PolicySpec(class_path="random")])
    makers = {
        "lstm": lambda **kw: TorchMultiAgentPolicy(**kw),
        "puffer": lambda **kw: PufferDefaultPolicy(**kw),
        "stateless": lambda **kw: StatelessPolicy(**kw),
        "torch_lstm": lambda **kw: TorchCompatLSTMPolicy(5, 30, state_dict=state_dict, hidden_size=8, **kw),
        "rollout": lambda **kw: Rollout(cfg, random, **kw),
        "single_episode_rollout": lambda **kw: single_episode_rollout(cfg, random, **kw),
        "run_multi_episode": lambda **kw: run_multi_episode(cfg, [(random, [0, 1])], 1, **kw),
        "run_episode_local": lambda **kw: run_episode_local(request, **kw),
    }
    for name, make in makers.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
        assert make(device="cpu") is not None, name
    with pytest.raises(RuntimeError, match="CUDA"):
        run_episode_isolated(request)
    acts = np.ones(2, np.int32)
    for policy in (random, NoopMultiAgentPolicy()):
        policy.step_batch(np.zeros((2, 4, 3), np.uint8), acts)
        assert 0 <= acts.min() and acts.max() < 5


def test_demos_need_a_device_or_cpu(monkeypatch):
    """The training and PettingZoo demos raise without CUDA unless asked
    for the CPU."""
    from mettagrid_tpu_torch.demos.demo_pettingzoo import run
    from mettagrid_tpu_torch.demos.demo_train import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, demo in (("train", lambda **kw: train(num_envs=2, steps=1, **kw)),
                       ("pettingzoo", lambda **kw: run(episodes=1, **kw))):
        with pytest.raises(RuntimeError, match="CUDA"):
            demo()
        assert len(demo(device="cpu")) == 1, name


def test_host_api_entry_points_need_a_device_or_cpu(monkeypatch):
    """The demo, the SDK's build_state, the policy servers serving the lstm
    policy and the renderers on a Simulation or a Rollout raise without CUDA
    unless asked for the CPU."""
    import io

    from mettagrid_tpu_torch.builder import make_navigation
    from mettagrid_tpu_torch.demo import main as demo
    from mettagrid_tpu_torch.policy import NoopMultiAgentPolicy, TorchMultiAgentPolicy
    from mettagrid_tpu_torch.renderer import InteractiveMiniscope, LogRenderer, MiniscopeRenderer
    from mettagrid_tpu_torch.runner.policy_server import LocalPolicyServer, ProtobufPolicyServer
    from mettagrid_tpu_torch.sdk import build_state
    from mettagrid_tpu_torch.simulator import Simulation
    from mettagrid_tpu_torch.simulator.rollout import Rollout

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = make_navigation(2)
    cfg.game.map_builder.width = cfg.game.map_builder.height = 8
    cfg.game.max_steps = 2
    makers = {
        "demo": lambda **kw: demo(["--steps=2", "--agents=2"] + [f"--device={d}" for d in kw.values()]) == 0,
        "sdk": lambda **kw: build_state(Simulation(cfg, **kw), 0),
        "json server": lambda **kw: LocalPolicyServer(TorchMultiAgentPolicy(**kw)),
        "protobuf server": lambda **kw: ProtobufPolicyServer(TorchMultiAgentPolicy(**kw)),
        "miniscope": lambda **kw: Simulation(cfg, event_handlers=[MiniscopeRenderer(out=io.StringIO()), LogRenderer()],
                                             **kw),
        "interactive miniscope": lambda **kw: Rollout(cfg, NoopMultiAgentPolicy(),
                                                      renderer=InteractiveMiniscope(out=io.StringIO()), **kw).run(),
    }
    for name, make in makers.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
        assert make(device="cpu"), name


def test_parallel_entry_points_need_a_device_or_cpu(monkeypatch):
    """make_mesh and dryrun_multichip raise without CUDA unless asked for the
    CPU, before any rank starts; the rig run as ``python -m`` without
    --device exits non-zero naming CUDA and prints no RIG_OK."""
    import torch.distributed as dist

    from mettagrid_tpu_torch.parallel import make_mesh
    from mettagrid_tpu_torch.parallel.dryrun import dryrun_multichip, free_port

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0)
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()
        assert make_mesh(device="cpu").device_type == "cpu"
    finally:
        dist.destroy_process_group()
    res = subprocess.run([sys.executable, "-m", "mettagrid_tpu_torch.parallel.rig", "0", "1", str(free_port())],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and "CUDA" in res.stderr and "RIG_OK" not in res.stdout, res


def test_parity_entry_points_need_a_device_or_cpu(monkeypatch):
    """The parity runs' halves on this engine (run_ours, run_arena_ours)
    and the signature tool's cross-engine mode raise without CUDA unless
    asked for the CPU."""
    from mettagrid_tpu_torch.parity import arena, cross_engine
    from mettagrid_tpu_torch.parity.reference_oracle import reference_available
    from mettagrid_tpu_torch.tools import episode_signature

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = cross_engine.Scenario(map_data=[["wall"] * 3, ["wall", "agent.agent", "wall"], ["wall"] * 3], num_agents=1,
                               scripts=[["noop"]])
    map_data = arena.arena_map(24, 0)
    makers = {
        "run_ours": lambda **kw: cross_engine.run_ours(sc, **kw),
        "run_arena_ours": lambda **kw: arena.run_arena_ours(map_data, 0, steps=2, **kw),
    }
    for name, make in makers.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
        assert make(device="cpu")["final"]["objects"], name
    with pytest.raises(RuntimeError, match="CUDA"):
        episode_signature.cross_engine([0], 2)
    if not reference_available():
        assert episode_signature.cross_engine([0], 2, device="cpu") == 2


def test_cross_engine_tool_without_oracle():
    """``episode_signature --cross-engine --device=cpu`` exits 2 with an
    error JSON where the reference oracle is not built."""
    from mettagrid_tpu_torch.parity.reference_oracle import reference_available

    if reference_available():
        pytest.skip("reference oracle built: the tool runs the comparison")
    res = subprocess.run([sys.executable, "-m", "mettagrid_tpu_torch.tools.episode_signature", "--cross-engine",
                          "--device=cpu"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 2, res.stderr
    verdict = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(verdict) == {"error"} and "reference oracle not built" in verdict["error"]


def test_host_apis_import_no_transport():
    """Importing the policy servers, the renderers and the SDK pulls in
    neither websockets nor google.protobuf: the servers, the clients and the
    live viewer import them when they first need them."""
    code = (
        "import sys\n"
        "import mettagrid_tpu_torch.runner.policy_server, mettagrid_tpu_torch.renderer, mettagrid_tpu_torch.sdk\n"
        "import mettagrid_tpu_torch.renderer.live_viewer, mettagrid_tpu_torch.demo\n"
        "bad = [m for m in sys.modules if m.split('.')[0] == 'websockets' or m.startswith('google.protobuf')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_api_imports_no_optional_framework():
    """Importing the env and simulator packages pulls in neither gymnasium
    nor pettingzoo (the spaces import gymnasium when first read; the
    PettingZoo and PufferLib adapters are imported when first named)."""
    code = (
        "import sys\n"
        "import mettagrid_tpu_torch.envs, mettagrid_tpu_torch.simulator, mettagrid_tpu_torch.parity\n"
        "from mettagrid_tpu_torch.envs import MettaGridVectorEnv, GridObsWrapper\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('gymnasium', 'pettingzoo', 'pufferlib')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_b1_wrapper_takes_plain_version_on_cpu():
    from mettagrid_tpu_torch.engine import obs
    from mettagrid_tpu_torch.engine.kernels.obs_tail_static_v2 import obs_tail_static_v2, obs_tail_static_v2_ref
    from mettagrid_tpu_torch.engine.step import _fresh_state_from_pool, _device_init

    program, init = _small_arena()
    fn = obs.make_obs_fn(program, obs.build_static_bg(program, init, "cpu"))
    pool = _device_init(program, init, "cpu")
    state = _fresh_state_from_pool(program, pool, torch.zeros(8, dtype=torch.int32), torch.zeros((8, 2), dtype=torch.int64))
    args = fn.tail_inputs(state)
    before = obs_tail_static_v2.launches
    w, a = obs_tail_static_v2(**args, out_w=fn.out_w)
    rw, ra = obs_tail_static_v2_ref(**args, out_w=fn.out_w)
    assert obs_tail_static_v2.launches == before
    np.testing.assert_array_equal(w.numpy(), rw.numpy())
    np.testing.assert_array_equal(a.numpy(), ra.numpy())
    assert (a > 0).all()


def _small_general():
    from mettagrid_tpu_torch.engine import build_env_init, compile_program
    from mettagrid_tpu_torch.maps.random_map import RandomMapBuilder
    from mettagrid_tpu_torch.tools.bench_run import make_general_cfg

    cfg = make_general_cfg(4)
    cfg.game.map_builder = RandomMapBuilder.Config(agents=4, width=11, height=11, border_width=1, objects={"wall": 6})
    program = compile_program(cfg)
    b = cfg.game.map_builder.create()
    b.config.seed = 1
    return program, build_env_init(program, [b.build_for_num_agents(4)])


def test_general_entry_points_need_a_device_or_cpu(monkeypatch):
    from mettagrid_tpu_torch.engine import make_reset, make_step, obs
    from mettagrid_tpu_torch.engine.step import step_gates

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    program, init = _small_general()
    assert not step_gates(program).static_bg
    for make in (lambda: make_step(program, init), lambda: make_reset(program, init, 8),
                 lambda: obs.make_obs_fn(program, None)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    step = make_step(program, init, device="cpu")
    state, out = make_reset(program, init, 8, device="cpu")(0)
    acts = torch.ones((8, 4), dtype=torch.int32)
    state, out = step(state, acts, acts, None, out.observations)
    assert state.grid.device.type == "cpu" and int(state.step_count[0]) == 1


def test_b2_wrapper_takes_plain_version_on_cpu():
    from mettagrid_tpu_torch.engine import obs
    from mettagrid_tpu_torch.engine.kernels.obs_tail_dynobj_v2 import obs_tail_dynobj_v2, obs_tail_dynobj_v2_ref
    from mettagrid_tpu_torch.engine.step import _device_init, _fresh_state_from_pool

    program, init = _small_general()
    fn = obs.make_obs_fn(program, None, "cpu")
    pool = _device_init(program, init, "cpu")
    state = _fresh_state_from_pool(program, pool, torch.zeros(8, dtype=torch.int32), torch.zeros((8, 2), dtype=torch.int64))
    args = fn.tail_inputs(state)
    before = obs_tail_dynobj_v2.launches
    w, a = obs_tail_dynobj_v2(**args, out_w=fn.out_w)
    rw, ra = obs_tail_dynobj_v2_ref(**args, out_w=fn.out_w)
    assert obs_tail_dynobj_v2.launches == before
    np.testing.assert_array_equal(w.numpy(), rw.numpy())
    np.testing.assert_array_equal(a.numpy(), ra.numpy())
    assert (a > 0).all()


def test_unported_constructs_raise():
    """A push_object move handler on the armed combat config, once refused
    when the step was made: it now takes the sequential action phase and
    steps in lockstep with the JAX engine's (tests/test_torch_query_kinds.py),
    and the pushes move objects."""
    from mettagrid_tpu_torch.config.handler_config import (
        Handler,
        HandlerTarget,
        PushObjectMutation,
        RelocateMutation,
        ResourceFilter,
        TargetLocEmptyFilter,
    )
    from mettagrid_tpu_torch.maps.random_map import RandomMapBuilder
    from mettagrid_tpu_torch.tools.bench_run import make_combat_cfg
    from tests.test_torch_query_kinds import lockstep

    cfg = make_combat_cfg(4)
    cfg.game.map_builder = RandomMapBuilder.Config(agents=4, width=11, height=11, border_width=1, objects={"wall": 6})
    cfg.game.actions.move.handlers = [
        Handler(name="push", filters=[ResourceFilter(target=HandlerTarget.ACTOR, resources={"laser": 1})],
                mutations=[PushObjectMutation()]),
        Handler(name="move", filters=[TargetLocEmptyFilter()], mutations=[RelocateMutation()]),
    ]
    walls = []

    def each(i, jstate, tstate, out):
        walls.append(torch.stack([tstate.obj_r[:, 4:], tstate.obj_c[:, 4:]]))

    _, step, _ = lockstep(cfg, n_steps=12, seeds=(1,), each=each)
    assert step.action_phase_kind == "sequential"
    assert any(not torch.equal(a, b) for a, b in zip(walls, walls[1:])), "no push moved a wall"


@pytest.mark.parametrize("background", ["static", "mutable"])
def test_v3_wrappers_take_plain_version_on_cpu(background):
    """On CPU tensors the B6a (static pool) and B6b (per-env image) wrappers
    take their plain versions and count no launch."""
    from mettagrid_tpu_torch.engine import obs
    from mettagrid_tpu_torch.engine.step import _device_init, _fresh_state_from_pool

    program, init = _small_arena()
    bg = obs.build_static_bg(program, init, "cpu") if background == "static" else None
    fn = obs.make_obs_fn(program, bg, "cpu", obs_tail="v3")
    assert fn.route == ("B6a" if background == "static" else "B6b")
    mod = __import__(f"mettagrid_tpu_torch.engine.kernels.{fn.tail.__name__}", fromlist=["_"])
    plain = getattr(mod, f"{fn.tail.__name__}_ref")
    pool = _device_init(program, init, "cpu")
    state = _fresh_state_from_pool(program, pool, torch.zeros(8, dtype=torch.int32), torch.zeros((8, 2), dtype=torch.int64))
    args = fn.tail_inputs(state)
    before = fn.tail.launches
    w, a = fn.tail(**args, out_w=fn.out_w)
    rw, ra = plain(**args, out_w=fn.out_w)
    assert fn.tail.launches == before
    np.testing.assert_array_equal(w.numpy(), rw.numpy())
    np.testing.assert_array_equal(a.numpy(), ra.numpy())
    assert (a > 0).all()


def test_reference_rng_refuses_fed_draws():
    """The reference-RNG step draws the agent order and the events' shuffles
    from the MT19937 twin: it refuses an external agent order when it is made
    and event ranks when it steps; an unknown obs_tail or action_mode
    raises."""
    from mettagrid_tpu_torch.engine import make_reset, make_step, obs
    from mettagrid_tpu_torch.tools.bench_run import make_mood_cfg
    from mettagrid_tpu_torch.engine import build_env_init, compile_program
    from mettagrid_tpu_torch.maps.random_map import RandomMapBuilder

    program, init = _small_arena()
    with pytest.raises(ValueError, match="external_perm"):
        make_step(program, init, reference_rng=True, external_perm=True, device="cpu")
    with pytest.raises(ValueError, match="obs_tail"):
        obs.make_obs_fn(program, None, "cpu", obs_tail="v4")
    with pytest.raises(ValueError, match="action_mode"):
        make_step(program, init, action_mode="parallel", device="cpu")
    cfg = make_mood_cfg(4)
    cfg.game.map_builder = RandomMapBuilder.Config(agents=4, width=11, height=11, border_width=1, objects={"wall": 6})
    program = compile_program(cfg)
    b = cfg.game.map_builder.create()
    b.config.seed = 1
    init = build_env_init(program, [b.build_for_num_agents(4)])
    state, out = make_reset(program, init, 8, reference_rng=True, device="cpu")(0)
    assert tuple(state.mt.shape) == (8, 625) and state.mt.dtype == torch.int64
    step = make_step(program, init, reference_rng=True, device="cpu")
    acts = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="event_ranks"):
        step(state, acts, acts, event_ranks=torch.zeros((8, 1, state.obj_type.shape[1])))
    with pytest.raises(ValueError, match="query_ranks"):
        step(state, acts, acts, query_ranks={1: torch.zeros((8, state.obj_type.shape[1]))})
