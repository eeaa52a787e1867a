"""The port's import boundary and device rules.

The port imports neither jax nor anything of the JAX package; its entry
points refuse to run without a CUDA device unless asked for the CPU; on CPU
tensors the B1, B2, B6a and B6b wrappers take their plain versions and launch
nothing; the reference-RNG step refuses draws fed from outside.
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "mettagrid_tpu_torch"


def _forbidden(name: str) -> bool:
    return name == "jax" or name.startswith("jax.") or name == "mettagrid_tpu" or name.startswith("mettagrid_tpu.")


def test_import_pulls_in_no_jax():
    code = (
        "import pkgutil, sys\n"
        "import mettagrid_tpu_torch, mettagrid_tpu_torch.engine\n"
        "for m in pkgutil.walk_packages(mettagrid_tpu_torch.__path__, 'mettagrid_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'mettagrid_tpu' or m.startswith('mettagrid_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith('mettagrid_tpu_torch')]))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


@pytest.mark.parametrize("target", ["package", "chip_smoke"])
def test_no_jax_import_in_source(target):
    files = sorted(PACKAGE.rglob("*.py")) if target == "package" else [ROOT / "chip_smoke.py"]
    assert files
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
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


def test_b1_wrapper_takes_plain_version_on_cpu():
    from mettagrid_tpu_torch.engine import obs
    from mettagrid_tpu_torch.engine.kernels.obs_tail_static_v2 import obs_tail_static_v2, obs_tail_static_v2_ref
    from mettagrid_tpu_torch.engine.step import _fresh_state_from_pool, _device_init

    program, init = _small_arena()
    fn = obs.make_obs_fn(program, obs.build_static_bg(program, init, "cpu"))
    pool = _device_init(init, "cpu")
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

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    program, init = _small_general()
    assert not obs.static_background_ok(program)
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
    pool = _device_init(init, "cpu")
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
    """Kinds outside this slice raise when the step is made, naming their
    ROADMAP item."""
    from mettagrid_tpu_torch.config.handler_config import Handler, HandlerTarget, PushObjectMutation, ResourceFilter
    from mettagrid_tpu_torch.engine import build_env_init, compile_program, make_step
    from mettagrid_tpu_torch.maps.random_map import RandomMapBuilder
    from mettagrid_tpu_torch.tools.bench_run import make_combat_cfg

    cfg = make_combat_cfg(4)
    cfg.game.map_builder = RandomMapBuilder.Config(agents=4, width=11, height=11, border_width=1, objects={"wall": 6})
    cfg.game.actions.move.handlers = [
        Handler(name="push", filters=[ResourceFilter(target=HandlerTarget.ACTOR, resources={"laser": 1})],
                mutations=[PushObjectMutation()])
    ]
    program = compile_program(cfg)
    b = cfg.game.map_builder.create()
    b.config.seed = 1
    init = build_env_init(program, [b.build_for_num_agents(4)])
    with pytest.raises(NotImplementedError, match=r"mutation kinds \['push_object'\] \(ROADMAP Queue 1 item 3\)"):
        make_step(program, init, device="cpu")


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
    pool = _device_init(init, "cpu")
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
        make_step(program, init, action_mode="fast", device="cpu")
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
