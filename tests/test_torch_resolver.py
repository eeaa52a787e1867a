"""The port's dotted-path resolvers refuse the JAX package.

Every resolver of the port (util.module.load_symbol and its callers: the map
builder configs, MapGen's scenes and instances, PolicySpec and policy
discovery) raises ImportError for a path into the JAX package or the JAX
stack before it imports anything: checked in a fresh interpreter, which must
end with neither ``mettagrid_tpu`` nor ``jax`` loaded. The configs the port
serialises, and the pattern YAMLs it ships, name only the port's types.
"""

import json
import pathlib
import subprocess
import sys

import pytest
import yaml

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "mettagrid_tpu_torch"

# Each case is a statement run in the fresh interpreter; it must raise.
CASES = {
    "load_symbol": "load_symbol('mettagrid_tpu.maps.ascii.AsciiMapBuilder.Config')",
    "load_symbol_not_strict": "load_symbol('mettagrid_tpu.maps.ascii.AsciiMapBuilder.Config', strict=False)",
    "load_symbol_jax": "load_symbol('jax.numpy.zeros')",
    "load_symbol_flax": "load_symbol('flax.linen.Dense')",
    "load_symbol_optax": "load_symbol('optax.adam', strict=False)",
    "map_builder": "MapBuilderConfig.model_validate({'type': 'mettagrid_tpu.maps.random_map.RandomMapBuilder.Config'})",
    "map_builder_yaml": "MapBuilderConfig.from_str('type: mettagrid_tpu.maps.maze.MazePrimMapBuilder.Config')",
    "policy_spec": "PolicySpec(class_path='mettagrid_tpu.policy.lstm.LSTMPolicy').resolve_class()",
    "policy_discovery": "discover_and_register_policies('mettagrid_tpu.policy')",
    "scene": "SceneConfig.model_validate({'type': 'mettagrid_tpu.mapgen.scenes.wfc.WFC.Config', 'pattern': '#.'})",
    "mapgen_instance": "MapGenConfig(instance={'type': 'mettagrid_tpu.mapgen.scenes.random.Random.Config'})",
    "mapgen_nested": (
        "MapBuilderConfig.model_validate({'type': 'mettagrid_tpu_torch.mapgen.mapgen.MapGen.Config', 'width': 8, "
        "'height': 8, 'instance': {'type': 'mettagrid_tpu.maps.random_map.RandomMapBuilder.Config'}})"
    ),
    "yaml_scene": "render_yaml_scene(\"type: mettagrid_tpu.mapgen.scenes.maze.Maze.Config\\n\")",
}

PROGRAM = """
import json, sys, tempfile
import numpy as np
from mettagrid_tpu_torch.util.module import load_symbol
from mettagrid_tpu_torch.maps.map_builder import MapBuilderConfig
from mettagrid_tpu_torch.maps.utils import create_grid
from mettagrid_tpu_torch.policy.policy import PolicySpec
from mettagrid_tpu_torch.policy.loader import discover_and_register_policies
from mettagrid_tpu_torch.mapgen import Area, MapGenConfig, SceneConfig
from mettagrid_tpu_torch.mapgen.scenes import YamlScene

def render_yaml_scene(text):
    with tempfile.NamedTemporaryFile('w', suffix='.yaml', delete=False) as f:
        f.write(text)
    grid = create_grid(9, 9)
    YamlScene.Config(file=f.name).create_root(Area.root_area_from_grid(grid), np.random.default_rng(0)).render_with_children()

out = {}
for name, stmt in json.loads(sys.argv[1]).items():
    try:
        eval(stmt)
        out[name] = ['no error', '']
    except BaseException as exc:
        out[name] = [type(exc).__name__, str(exc)]
out['_loaded'] = sorted(m for m in sys.modules if m.split('.')[0] in ('mettagrid_tpu', 'jax', 'flax', 'optax'))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def refusals():
    res = subprocess.run([sys.executable, "-c", PROGRAM, json.dumps(CASES)], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_resolver_refuses_jax_package(refusals, case):
    kind, message = refusals[case]
    assert kind == "ImportError", (kind, message)
    if "mettagrid_tpu." in CASES[case]:
        # The message names the port's counterpart; the path is not translated.
        assert "mettagrid_tpu_torch." in message and "JAX package" in message, message
    assert refusals["_loaded"] == [], refusals["_loaded"]


def test_resolvers_still_resolve_the_port():
    from mettagrid_tpu_torch.mapgen import MapGenConfig, SceneConfig
    from mettagrid_tpu_torch.mapgen.scenes import WFC, Random
    from mettagrid_tpu_torch.maps.map_builder import MapBuilderConfig
    from mettagrid_tpu_torch.policy.policy import PolicySpec
    from mettagrid_tpu_torch.util.module import load_symbol

    assert isinstance(SceneConfig.model_validate({"type": "mettagrid_tpu_torch.mapgen.scenes.wfc.WFC.Config",
                                                  "pattern": "#."}), WFC.Config)
    cfg = MapGenConfig(instance={"type": "mettagrid_tpu_torch.mapgen.scenes.random.Random.Config", "agents": 2})
    assert isinstance(cfg.instance, Random.Config)
    assert isinstance(MapBuilderConfig.model_validate(cfg.model_dump()), MapGenConfig)
    spec = PolicySpec(class_path="mettagrid_tpu_torch.policy.policy.TorchMultiAgentPolicy")
    assert spec.resolve_class() is load_symbol(spec.class_path)
    # A nested attribute path resolves through its longest importable module.
    assert load_symbol("mettagrid_tpu_torch.mapgen.scenes.wfc.WFC.Config") is WFC.Config


def test_round_trip_names_port_types():
    """A MapGen config dumped to YAML and JSON and loaded again keeps the
    port's types at every level."""
    from mettagrid_tpu_torch.builder import make_assembly_lines
    from mettagrid_tpu_torch.config.game_config import GridObjectConfig
    from mettagrid_tpu_torch.mapgen import ChildrenAction, MapGen
    from mettagrid_tpu_torch.mapgen.scenes import BSP, Random
    from mettagrid_tpu_torch.maps.map_builder import MapBuilderConfig

    bsp = MapGen.Config(width=20, height=20, instance=BSP.Config(
        rooms=3, children=[ChildrenAction(scene=Random.Config(agents=2), where="full")]))
    lines = make_assembly_lines(2, 10, {"mine": GridObjectConfig(name="mine")}, {"mine": 1}).game.map_builder
    for cfg in (bsp, lines):
        dumped = cfg.model_dump(mode="json")
        types = []

        def walk(x):
            if isinstance(x, dict):
                if "type" in x:
                    types.append(x["type"])
                for v in x.values():
                    walk(v)
            elif isinstance(x, list):
                for v in x:
                    walk(v)

        walk(dumped)
        assert len(types) >= 2 and all(t.startswith("mettagrid_tpu_torch.") for t in types), types
        for text in (yaml.safe_dump(dumped), json.dumps(dumped)):
            again = MapBuilderConfig.from_str(text)
            assert type(again) is type(cfg) and again.model_dump(mode="json") == dumped


PATTERN_YAMLS = sorted(p.relative_to(PACKAGE).as_posix() for p in PACKAGE.rglob("*.yaml"))


def test_pattern_yamls_are_all_there():
    assert len(PATTERN_YAMLS) == 20
    assert {p.split("/")[-2] for p in PATTERN_YAMLS} == {"wfc", "convchain"}


@pytest.mark.parametrize("rel", PATTERN_YAMLS)
def test_yaml_names_only_port_types(rel):
    from mettagrid_tpu_torch.mapgen import SceneConfig

    data = yaml.safe_load((PACKAGE / rel).read_text())
    assert data["type"].startswith("mettagrid_tpu_torch.mapgen.scenes."), data["type"]
    assert type(SceneConfig.model_validate(data)).__module__.startswith("mettagrid_tpu_torch.")
