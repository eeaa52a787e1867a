"""Map generation CLI (reference: mapgen/tools/gen.py).

Render a map builder config (JSON/YAML file with a dotted "type" key) or a
scene config to ASCII on stdout.

Usage:
  python -m mettagrid_tpu_torch.mapgen.tools.gen --config=path.json [--seed=0]
  python -m mettagrid_tpu_torch.mapgen.tools.gen --scene=path.json --width=20 --height=20
"""

from __future__ import annotations

import json
import sys

import numpy as np

DEFAULT_CHARS = {
    "empty": ".",
    "wall": "#",
    "agent.agent": "@",
}


def grid_to_ascii(grid: np.ndarray) -> str:
    used: dict[str, str] = dict(DEFAULT_CHARS)
    pool = list("abcdefghijklmnopqrstuvwxyz0123456789")
    lines = []
    for row in grid:
        chars = []
        for cell in row:
            name = str(cell)
            if name.startswith("agent"):
                name = "agent.agent"
            if name not in used:
                used[name] = pool.pop(0) if pool else "?"
            chars.append(used[name])
        lines.append("".join(chars))
    legend = "  ".join(f"{ch}={name}" for name, ch in sorted(used.items(), key=lambda kv: kv[1]))
    return "\n".join(lines) + "\n# " + legend


def _load(path: str) -> dict:
    with open(path) as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        try:
            import yaml  # type: ignore

            return yaml.safe_load(text)
        except ImportError as e:  # pragma: no cover
            raise RuntimeError("YAML configs require pyyaml") from e
    return json.loads(text)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    config_path = scene_path = None
    width = height = 20
    seed = 0
    for arg in argv:
        k, _, v = arg.partition("=")
        if k == "--config":
            config_path = v
        elif k == "--scene":
            scene_path = v
        elif k == "--width":
            width = int(v)
        elif k == "--height":
            height = int(v)
        elif k == "--seed":
            seed = int(v)

    if config_path:
        from mettagrid_tpu_torch.maps.map_builder import MapBuilderConfig

        cfg = MapBuilderConfig.model_validate(_load(config_path))
        if hasattr(cfg, "seed"):
            cfg.seed = seed
        gm = cfg.create().build()
        print(grid_to_ascii(gm.grid))
        return 0

    if scene_path:
        from mettagrid_tpu_torch.mapgen.area import Area
        from mettagrid_tpu_torch.mapgen.scene import SceneConfig
        from mettagrid_tpu_torch.maps.utils import create_grid

        scfg = SceneConfig.model_validate(_load(scene_path))
        grid = create_grid(height, width)
        scene = scfg.create_root(Area.root_area_from_grid(grid), rng=np.random.default_rng(seed))
        scene.render_with_children()
        print(grid_to_ascii(grid))
        return 0

    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
