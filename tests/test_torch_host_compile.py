"""The port's copy of the host compiler against the JAX package's.

compile_program, the map builders, build_env_init and the presets must give
the same tables, maps and EnvInit arrays in both packages (exact).
"""

import dataclasses
import enum

import numpy as np
import pytest

import mettagrid_tpu.builder as jbuilder
import mettagrid_tpu.engine.init as jinit
import mettagrid_tpu.engine.program as jprogram
from mettagrid_tpu_torch import builder as tbuilder
from mettagrid_tpu_torch.engine import init as tinit
from mettagrid_tpu_torch.engine import program as tprogram


def _norm(x):
    """A comparable form of compiled tables: dataclasses and named tuples by
    class name and fields, arrays by dtype, shape and values."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: _norm(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return (type(x).__name__, {f: _norm(getattr(x, f)) for f in x._fields})
    if isinstance(x, np.ndarray):
        return ("ndarray", str(x.dtype), x.shape, x.tolist())
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.value)
    if isinstance(x, np.generic):
        return x.item()
    return x


def _build(builder_mod, program_mod, init_mod, preset, pool):
    cfg = getattr(builder_mod, preset)(24, combat=False) if preset == "make_arena" else getattr(builder_mod, preset)(6)
    program = program_mod.compile_program(cfg)
    b = cfg.game.map_builder.create()
    rng = np.random.default_rng(0)
    maps = []
    for _ in range(pool):
        b.config.seed = int(rng.integers(0, 2**31 - 1))
        maps.append(b.build_for_num_agents(program.num_agents))
    return program, maps, init_mod.build_env_init(program, maps)


@pytest.mark.parametrize("preset,pool", [("make_arena", 3), ("make_navigation", 2)])
def test_host_compile_matches_jax(preset, pool):
    jp, jmaps, ji = _build(jbuilder, jprogram, jinit, preset, pool)
    tp, tmaps, ti = _build(tbuilder, tprogram, tinit, preset, pool)
    for jm, tm in zip(jmaps, tmaps):
        np.testing.assert_array_equal(tm.grid, jm.grid)
    assert _norm(tp) == _norm(jp)
    for f in dataclasses.fields(ji):
        got, ref = getattr(ti, f.name), getattr(ji, f.name)
        assert got.dtype == ref.dtype, f.name
        np.testing.assert_array_equal(got, ref, err_msg=f.name)


def _mapgen_cfg(pkg: str, kind: str):
    """make_assembly_lines(4, ...) with per-instance hubs and teams, or the
    flagship game on a small BSP MapGen map, in package ``pkg``."""
    import importlib

    imp = importlib.import_module
    builder, gc = imp(f"{pkg}.builder"), imp(f"{pkg}.config.game_config")
    if kind == "assembly_lines":
        objects = {"mine": gc.GridObjectConfig(name="mine")}
        objects.update({f"hub_{i}": gc.GridObjectConfig(name=f"hub_{i}") for i in range(4)})
        cfg = builder.make_assembly_lines(4, 12, objects, {"mine": 2, "hub": 1}, terrain="balanced")
        cfg.game.agents = [cfg.game.agent.model_copy(update={"name": f"team_{k}", "team_id": k,
                                                             "map_name": f"team_{k}"}) for k in range(4)]
        mb = cfg.game.map_builder
        mb.set_team_by_instance = True
        mb.instance_object_remap = {"hub": "hub_{instance_id}"}
        return cfg, lambda seed: setattr(mb.instance, "seed", seed)
    mapgen, scenes = imp(f"{pkg}.mapgen"), imp(f"{pkg}.mapgen.scenes")
    cfg = builder.make_arena(6, combat=False)
    cfg.game.max_steps = 6
    cfg.game.map_builder = mapgen.MapGen.Config(
        width=24, height=24, border_width=5, instance=scenes.BSP.Config(
            rooms=5, min_room_size=3, children=[mapgen.ChildrenAction(
                scene=scenes.Random.Config(agents=6, objects={"wall": 8}), where="full")]))
    return cfg, lambda seed: setattr(cfg.game.map_builder, "seed", seed)


def _build_mapgen(pkg, program_mod, init_mod, kind, seeds):
    cfg, set_seed = _mapgen_cfg(pkg, kind)
    program = program_mod.compile_program(cfg)
    maps = []
    for s in seeds:
        set_seed(s)
        maps.append(cfg.game.map_builder.create().build_for_num_agents(program.num_agents))
    return program, maps, init_mod.build_env_init(program, maps)


@pytest.mark.parametrize("kind", ["assembly_lines", "bsp_arena"])
def test_host_compile_matches_jax_on_mapgen(kind):
    """compile_program and build_env_init on MapGen maps: per-instance object
    names and teams (assembly lines), a procedural dungeon (BSP)."""
    jp, jmaps, ji = _build_mapgen("mettagrid_tpu", jprogram, jinit, kind, (3, 8))
    tp, tmaps, ti = _build_mapgen("mettagrid_tpu_torch", tprogram, tinit, kind, (3, 8))
    for jm, tm in zip(jmaps, tmaps):
        np.testing.assert_array_equal(tm.grid, jm.grid)
    assert not np.array_equal(tmaps[0].grid, tmaps[1].grid)
    assert _norm(tp) == _norm(jp)
    for f in dataclasses.fields(ji):
        got, ref = getattr(ti, f.name), getattr(ji, f.name)
        assert got.dtype == ref.dtype, f.name
        np.testing.assert_array_equal(got, ref, err_msg=f.name)
    if kind == "assembly_lines":
        assert sorted(np.unique(ti.agent_group[0]).tolist()) == [0, 1, 2, 3]
        assert {f"hub_{i}" for i in range(4)} <= set(np.unique(tmaps[0].grid).tolist())


def test_step_matches_jax_on_mapgen_pool():
    """The port's step against the JAX engine's on a pool of two BSP MapGen
    maps: 14 steps with max_steps=6 reset every env twice, onto the map the
    JAX engine draws (exact)."""
    from tests.test_torch_step import lockstep_pair

    jp, _, ji = _build_mapgen("mettagrid_tpu", jprogram, jinit, "bsp_arena", (3, 8))
    tp, _, ti = _build_mapgen("mettagrid_tpu_torch", tprogram, tinit, "bsp_arena", (3, 8))
    assert lockstep_pair((jp, ji), (tp, ti), num_envs=4, n_steps=14, seed=5) == 8
