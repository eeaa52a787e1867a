"""The arena configuration as mettagrid_tpu_torch runs it: upstream's
make_arena(24, combat=False) on its MapGen maps, a random room inside
MapGen's border, as ``arena.json`` sizes them."""

from __future__ import annotations


def port_config(spec: dict, max_steps: int):
    from mettagrid_tpu_torch.builder import make_arena
    from mettagrid_tpu_torch.mapgen import MapGen
    from mettagrid_tpu_torch.mapgen.scenes import Random

    m = spec["map"]
    cfg = make_arena(spec["num_agents"], combat=False, map_builder=MapGen.Config(
        width=m["width"], height=m["height"], border_width=m["border_width"],
        instance=Random.Config(agents=m["agents"], objects=dict(m["objects"]))))
    cfg.game.max_steps = max_steps
    return cfg
